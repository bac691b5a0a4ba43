"""optimize_sim3 (`optim/sim3.py` ≙ `Optimizer::OptimizeSim3`,
`Optimizer.cc:4111`): recovers a known Sim3 from a perturbed start and
rejects outlier pairs via the dual chi2 gate."""

import jax
import jax.numpy as jnp
import numpy as np

from orbslam3_jax.ops import cameras as cam
from orbslam3_jax.ops import lie
from orbslam3_jax.optim import sim3 as sim3_mod


def _setup(rng, N=120, n_out=0, noise=0.2):
    params = cam.make_pinhole(400.0, 400.0, 320.0, 240.0)
    X1 = np.stack(
        [rng.uniform(-2, 2, N), rng.uniform(-1.5, 1.5, N), rng.uniform(3, 9, N)], -1
    ).astype(np.float32)
    w = rng.normal(0, 0.2, 3)
    R_gt = np.asarray(lie.exp_so3(jnp.asarray(w, jnp.float32)))
    t_gt = np.asarray([0.3, -0.1, 0.4], np.float32)
    s_gt = 1.35
    X2 = s_gt * (X1 @ R_gt.T) + t_gt
    uv1 = np.array(cam.project(cam.CameraModel.PINHOLE, params, jnp.asarray(X1)))
    uv2 = np.array(cam.project(cam.CameraModel.PINHOLE, params, jnp.asarray(X2)))
    uv1 += rng.normal(0, noise, uv1.shape)
    uv2 += rng.normal(0, noise, uv2.shape)
    if n_out:
        uv2[:n_out] += rng.uniform(30, 80, (n_out, 2)) * rng.choice([-1, 1], (n_out, 2))
    return params, X1, X2, uv1, uv2, R_gt, t_gt, s_gt


def test_recovers_sim3(rng):
    params, X1, X2, uv1, uv2, R_gt, t_gt, s_gt = _setup(rng)
    N = len(X1)
    # Perturbed start (as the RANSAC would hand over).
    R0 = np.asarray(lie.exp_so3(jnp.asarray([0.03, -0.02, 0.04]))) @ R_gt
    res = sim3_mod.optimize_sim3(
        cam.CameraModel.PINHOLE, params,
        jnp.asarray(R0), jnp.asarray(t_gt + 0.1), jnp.asarray(s_gt * 1.1),
        jnp.asarray(X1), jnp.asarray(X2),
        jnp.asarray(uv1, jnp.float32), jnp.asarray(uv2, jnp.float32),
        jnp.ones(N), jnp.ones(N), jnp.ones(N, bool),
    )
    assert int(res.n_inliers) > N * 0.9
    np.testing.assert_allclose(np.asarray(res.R), R_gt, atol=5e-3)
    np.testing.assert_allclose(float(res.s), s_gt, rtol=5e-3)
    np.testing.assert_allclose(np.asarray(res.t), t_gt, atol=2e-2)


def test_outliers_gated(rng):
    params, X1, X2, uv1, uv2, R_gt, t_gt, s_gt = _setup(rng, n_out=25)
    N = len(X1)
    res = sim3_mod.optimize_sim3(
        cam.CameraModel.PINHOLE, params,
        jnp.asarray(R_gt), jnp.asarray(t_gt), jnp.asarray(s_gt),
        jnp.asarray(X1), jnp.asarray(X2),
        jnp.asarray(uv1, jnp.float32), jnp.asarray(uv2, jnp.float32),
        jnp.ones(N), jnp.ones(N), jnp.ones(N, bool),
    )
    inl = np.asarray(res.inlier)
    assert not inl[:25].any()  # corrupted pairs dropped
    assert inl[25:].sum() > (N - 25) * 0.9
    np.testing.assert_allclose(float(res.s), s_gt, rtol=1e-2)


def test_fix_scale(rng):
    params, X1, X2, uv1, uv2, R_gt, t_gt, s_gt = _setup(rng)
    N = len(X1)
    res = sim3_mod.optimize_sim3(
        cam.CameraModel.PINHOLE, params,
        jnp.asarray(R_gt), jnp.asarray(t_gt), jnp.asarray(s_gt),
        jnp.asarray(X1), jnp.asarray(X2),
        jnp.asarray(uv1, jnp.float32), jnp.asarray(uv2, jnp.float32),
        jnp.ones(N), jnp.ones(N), jnp.ones(N, bool), fix_scale=True,
    )
    assert abs(float(res.s) - s_gt) < 1e-6  # scale untouched (f32 cast)
    assert int(res.n_inliers) > N * 0.9
