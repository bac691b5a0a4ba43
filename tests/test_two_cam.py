"""Right-camera (ToBody) projection rows for the stereo-fisheye rig —
`EdgeSE3ProjectXYZOnlyPoseToBody` / `EdgeSE3ProjectXYZToBody` semantics
(`/root/reference/include/OptimizableTypes.h:65,132`): analytic Jacobians
against finite differences, and pose/BA recovery with right rows on."""

import numpy as np
import jax
import jax.numpy as jnp

from orbslam3_jax.ops import cameras as cam
from orbslam3_jax.ops import lie
from orbslam3_jax.optim import ba as ba_mod
from orbslam3_jax.optim import pose_only as po


def _rig(rng):
    params_l = cam.make_pinhole(300.0, 300.0, 160.0, 120.0)
    params_r = cam.make_pinhole(305.0, 298.0, 158.0, 122.0)
    R_rl = np.asarray(lie.exp_so3(jnp.asarray([0.01, -0.02, 0.005], jnp.float32)))
    t_rl = np.asarray([-0.11, 0.002, -0.001], np.float32)  # ~11 cm baseline
    return params_l, params_r, jnp.asarray(R_rl), jnp.asarray(t_rl)


def test_right_row_jacobian_fd(rng):
    """d e / d [rho, phi] of the ToBody row vs central differences."""
    params_l, params_r, R_rl, t_rl = _rig(rng)
    n = 24
    Xw = np.stack(
        [rng.uniform(-2, 2, n), rng.uniform(-1.5, 1.5, n), rng.uniform(3, 8, n)], -1
    ).astype(np.float32)
    R0 = np.asarray(lie.exp_so3(jnp.asarray([0.03, 0.05, -0.02], jnp.float32)))
    t0 = np.asarray([0.2, -0.1, 0.05], np.float32)
    obs_r = po.PoseObs(
        Xw=jnp.asarray(Xw), uv=jnp.zeros((n, 2)), ur=jnp.full(n, -1.0),
        sigma2=jnp.ones(n), valid=jnp.ones(n, bool),
    )

    def res_at(delta):
        dR, dt = lie.exp_se3(jnp.asarray(delta, jnp.float32))
        Rn, tn = lie.se3_compose(dR, dt, jnp.asarray(R0), jnp.asarray(t0))
        e, _, _ = po._residuals_right(
            cam.CameraModel.PINHOLE, params_r, R_rl, t_rl, Rn, tn, obs_r
        )
        return np.asarray(e[:, :2])

    _, J, ok = po._residuals_right(
        cam.CameraModel.PINHOLE, params_r, R_rl, t_rl,
        jnp.asarray(R0), jnp.asarray(t0), obs_r,
    )
    assert bool(ok.all())
    J = np.asarray(J)[:, :2, :]  # (n,2,6)
    eps = 1e-3  # f32 pixel values ~1e2: larger step beats round-off
    for k in range(6):
        d = np.zeros(6, np.float32)
        d[k] = eps
        J_fd = (res_at(d) - res_at(-d)) / (2 * eps)
        np.testing.assert_allclose(J[:, :, k], J_fd, rtol=2e-2, atol=5e-2)


def test_pose_two_cam_recovers(rng):
    """Pose-only with left+right rows converges to the true pose; the
    right rows alone constrain what a mono set leaves loose (scale-ish
    translation along the optical axis is better conditioned)."""
    params_l, params_r, R_rl, t_rl = _rig(rng)
    n = 120
    Xw = np.stack(
        [rng.uniform(-2, 2, n), rng.uniform(-1.5, 1.5, n), rng.uniform(3, 8, n)], -1
    ).astype(np.float32)
    R_true = np.asarray(lie.exp_so3(jnp.asarray([0.05, -0.03, 0.08], jnp.float32)))
    t_true = np.asarray([0.3, -0.2, 0.1], np.float32)
    Xc = (R_true @ Xw.T).T + t_true
    uv_l = np.asarray(cam.project(cam.CameraModel.PINHOLE, params_l, jnp.asarray(Xc)))
    Xc_r = Xc @ np.asarray(R_rl).T + np.asarray(t_rl)
    uv_r = np.asarray(cam.project(cam.CameraModel.PINHOLE, params_r, jnp.asarray(Xc_r)))
    uv_l = uv_l + rng.normal(0, 0.3, uv_l.shape)
    uv_r = uv_r + rng.normal(0, 0.3, uv_r.shape)

    obs = po.PoseObs(
        Xw=jnp.asarray(Xw), uv=jnp.asarray(uv_l.astype(np.float32)),
        ur=jnp.full(n, -1.0), sigma2=jnp.ones(n), valid=jnp.ones(n, bool),
    )
    # Only half the features have a right match (lapping area).
    has_r = np.zeros(n, bool)
    has_r[: n // 2] = True
    obs_r = po.PoseObs(
        Xw=jnp.asarray(Xw), uv=jnp.asarray(uv_r.astype(np.float32)),
        ur=jnp.full(n, -1.0), sigma2=jnp.ones(n), valid=jnp.asarray(has_r),
    )
    res = po.optimize_pose(
        cam.CameraModel.PINHOLE, params_l,
        jnp.eye(3), jnp.zeros(3), obs,
        obs_r=obs_r, params_r=params_r, R_rl=R_rl, t_rl=t_rl,
    )
    assert float(jnp.abs(res.t - t_true).max()) < 5e-3
    assert float(jnp.abs(res.R - R_true).max()) < 1e-3
    assert int(res.n_inliers) > 100


def test_ba_right_rows(rng):
    """BA with obs_right rows: both cameras' observations converge the
    rig; exactness of the dense path holds with cam2 on."""
    params_l, params_r, R_rl, t_rl = _rig(rng)
    C, P = 6, 300
    pts = np.stack(
        [rng.uniform(-3, 3, P), rng.uniform(-2, 2, P), rng.uniform(4, 9, P)], -1
    ).astype(np.float32)
    cam_R = np.tile(np.eye(3, dtype=np.float32), (C, 1, 1))
    cam_t = np.zeros((C, 3), np.float32)
    cam_t[:, 0] = np.linspace(0, 1.0, C)
    obs_cam = np.repeat(np.arange(C, dtype=np.int32), P)
    obs_pt = np.tile(np.arange(P, dtype=np.int32), C)
    Xc = pts[obs_pt] + cam_t[obs_cam]
    uv_l = np.asarray(cam.project(cam.CameraModel.PINHOLE, params_l, jnp.asarray(Xc)))
    Xc_r = Xc @ np.asarray(R_rl).T + np.asarray(t_rl)
    uv_r = np.asarray(cam.project(cam.CameraModel.PINHOLE, params_r, jnp.asarray(Xc_r)))
    # Interleave: every 3rd observation is a right-camera row.
    is_r = (np.arange(len(obs_cam)) % 3) == 0
    uv = np.where(is_r[:, None], uv_r, uv_l) + rng.normal(0, 0.3, uv_l.shape)
    O = len(obs_cam)
    prob = ba_mod.BAProblem(
        cam_R=jnp.asarray(cam_R),
        cam_t=jnp.asarray(cam_t + rng.normal(0, 0.02, cam_t.shape).astype(np.float32)),
        cam_fixed=jnp.asarray(np.arange(C) < 2),
        points=jnp.asarray(pts + rng.normal(0, 0.03, pts.shape).astype(np.float32)),
        point_valid=jnp.ones(P, bool),
        obs_cam=jnp.asarray(obs_cam), obs_point=jnp.asarray(obs_pt),
        obs_uv=jnp.asarray(uv.astype(np.float32)),
        obs_ur=jnp.full(O, -1.0), obs_sigma2=jnp.ones(O),
        obs_valid=jnp.ones(O, bool), obs_right=jnp.asarray(is_r),
    )
    cam2 = (params_r, R_rl, t_rl)
    res = ba_mod.solve_ba(
        cam.CameraModel.PINHOLE, params_l, prob, iters=8, dense_schur=True,
        cam2=cam2,
    )
    terr = float(jnp.abs(res.cam_t - cam_t).max())
    assert int(res.obs_inlier.sum()) == O  # every row consistent incl. right
    # The scene's intrinsic depth uncertainty bounds accuracy (~0.08 with
    # 0.3 px noise at z<=9, f=300); the rig rows must not be WORSE than
    # dropping them for pure-left observations.
    uv_left_only = np.where(is_r[:, None], uv_l, uv)
    prob_l = prob._replace(
        obs_uv=jnp.asarray(uv_left_only.astype(np.float32)), obs_right=None
    )
    res_l = ba_mod.solve_ba(
        cam.CameraModel.PINHOLE, params_l, prob_l, iters=8, dense_schur=True
    )
    terr_l = float(jnp.abs(res_l.cam_t - cam_t).max())
    assert terr < 0.1 and terr <= terr_l * 1.05, (terr, terr_l)
    # PCG path agrees with the dense path with cam2 on.
    res2 = ba_mod.solve_ba(
        cam.CameraModel.PINHOLE, params_l, prob, iters=8, pcg_iters=50, cam2=cam2,
    )
    assert float(jnp.abs(res.cam_t - res2.cam_t).max()) < 1e-3
