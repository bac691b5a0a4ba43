import jax
import jax.numpy as jnp
import numpy as np
import pytest

from orbslam3_jax.ops import cameras as cam
from orbslam3_jax.ops import imu as imu_ops
from orbslam3_jax.ops import lie
from orbslam3_jax.optim import inertial

from tests.test_imu import make_calib


def simulate_kf_chain(rng, n_kf=8, samples_per_kf=25, dt=0.005, bias_g=None, bias_a=None):
    """Body flying a sinusoidal path; returns per-KF ground-truth states
    and preintegrated edges between consecutive KFs."""
    bias_g = np.zeros(3, np.float32) if bias_g is None else bias_g
    bias_a = np.zeros(3, np.float32) if bias_a is None else bias_a
    g = np.array([0.0, 0.0, -imu_ops.GRAVITY_VALUE])
    calib = make_calib()

    R = np.eye(3)
    v = np.array([0.4, -0.2, 0.1])
    p = np.zeros(3)
    kf_R, kf_p, kf_v = [R.copy()], [p.copy()], [v.copy()]
    seg_acc, seg_gyro = [], []
    cur_a, cur_w = [], []
    t = 0.0
    for k in range(n_kf - 1):
        for _ in range(samples_per_kf):
            w_world = np.array([0.5 * np.sin(3 * t), 0.4, 0.3 * np.cos(2 * t)])
            a_world = np.array([0.8 * np.cos(5 * t), 0.7 * np.sin(4 * t), 0.3 * np.sin(3 * t)])
            gyro = R.T @ w_world
            acc = R.T @ (a_world - g)
            cur_a.append(acc + bias_a)
            cur_w.append(gyro + bias_g)
            p = p + v * dt + 0.5 * a_world * dt * dt
            v = v + a_world * dt
            R = R @ np.asarray(lie.exp_so3(jnp.asarray((gyro * dt).astype(np.float32))))
            t += dt
        kf_R.append(R.copy()); kf_p.append(p.copy()); kf_v.append(v.copy())
        seg_acc.append(np.stack(cur_a).astype(np.float32))
        seg_gyro.append(np.stack(cur_w).astype(np.float32))
        cur_a, cur_w = [], []

    dts = np.full(samples_per_kf, dt, np.float32)
    preints = imu_ops.integrate_batch(
        jnp.asarray(np.stack(seg_acc)), jnp.asarray(np.stack(seg_gyro)),
        jnp.asarray(np.tile(dts, (n_kf - 1, 1))),
        jnp.zeros(3), jnp.zeros(3), calib,
    )
    edges = inertial.make_imu_edges(
        jnp.arange(n_kf - 1, dtype=jnp.int32),
        jnp.arange(1, n_kf, dtype=jnp.int32),
        preints,
        jnp.ones(n_kf - 1, bool),
    )
    return (
        np.stack(kf_R).astype(np.float32),
        np.stack(kf_p).astype(np.float32),
        np.stack(kf_v).astype(np.float32),
        edges,
        calib,
    )


def test_inertial_only_recovers_scale_and_gravity(rng):
    """`InertialOptimization` semantics: given poses in a frame that is
    scaled by 1/s and rotated so gravity is not -z, recover s and Rwg."""
    kf_R, kf_p, kf_v, edges, _ = simulate_kf_chain(rng)
    s_true = 2.5
    Rwg_true = np.asarray(lie.exp_so3(jnp.asarray([0.15, -0.1, 0.0], jnp.float32)))
    # Map world: x' = Rwg_true^T x / s  (so the optimizer must find
    # s=s_true and gravity dir Rwg ~ Rwg_true).
    kf_p_obs = (Rwg_true.T @ kf_p.T).T / s_true
    kf_R_obs = np.einsum("ij,kjl->kil", Rwg_true.T, kf_R)

    res = inertial.inertial_only_optimization(
        jnp.asarray(kf_R_obs), jnp.asarray(kf_p_obs),
        jnp.ones(len(kf_R), bool), edges, iters=25,
    )
    assert abs(float(res.scale) - s_true) / s_true < 0.05, float(res.scale)
    g_est = np.asarray(res.Rwg) @ np.array([0, 0, -1.0])
    g_true = Rwg_true.T @ np.array([0, 0, -1.0])
    cos = g_est @ g_true
    assert cos > 0.999, cos
    # Velocities come out METRIC (the residual uses s * p, so v pairs with
    # the scaled positions) — the map rescaling applies them afterwards,
    # as the reference does in `Map::ApplyScaledRotation`.
    v_exp = (Rwg_true.T @ kf_v.T).T
    np.testing.assert_allclose(np.asarray(res.vel), v_exp, atol=0.05)


def test_inertial_only_recovers_gyro_bias(rng):
    bias_g = np.array([0.02, -0.015, 0.01], np.float32)
    kf_R, kf_p, kf_v, edges, _ = simulate_kf_chain(rng, bias_g=bias_g)
    res = inertial.inertial_only_optimization(
        jnp.asarray(kf_R), jnp.asarray(kf_p), jnp.ones(len(kf_R), bool),
        edges, iters=25, fix_scale=True,
    )
    np.testing.assert_allclose(np.asarray(res.bg), bias_g, atol=3e-3)


def _make_vi_problem(rng, kf_R, kf_p, kf_v, edges, n_pts=120):
    """Returns (VIProblem, camera params)."""
    """Visual observations of a point cloud from the body trajectory."""
    params = cam.make_pinhole(450.0, 450.0, 376.0, 240.0)
    # Points in front of the trajectory (bodies face +z in world at start).
    pts = np.stack(
        [rng.uniform(-4, 4, n_pts), rng.uniform(-3, 3, n_pts), rng.uniform(5, 10, n_pts)],
        -1,
    ).astype(np.float32)
    K = len(kf_R)
    obs_cam, obs_pt, obs_uv = [], [], []
    for k in range(K):
        Rbw = kf_R[k].T
        Xb = (Rbw @ (pts - kf_p[k]).T).T  # Tcb = I
        uv = np.asarray(cam.pinhole_project(jnp.asarray(params), jnp.asarray(Xb)))
        vis = (Xb[:, 2] > 0.5) & (np.abs(uv[:, 0] - 376) < 370) & (np.abs(uv[:, 1] - 240) < 235)
        for pi in np.flatnonzero(vis):
            obs_cam.append(k)
            obs_pt.append(pi)
            obs_uv.append(uv[pi] + rng.normal(0, 0.3, 2))
    O = len(obs_cam)
    state = inertial.BodyState(
        R=jnp.asarray(kf_R), p=jnp.asarray(kf_p), v=jnp.asarray(kf_v),
        bg=jnp.zeros((K, 3)), ba=jnp.zeros((K, 3)),
    )
    fixed = np.zeros(K, bool)
    fixed[0] = True
    return inertial.VIProblem(
        state=state, kf_fixed=jnp.asarray(fixed),
        Tcb_R=jnp.eye(3), Tcb_t=jnp.zeros(3),
        points=jnp.asarray(pts), point_valid=jnp.ones(n_pts, bool),
        obs_cam=jnp.asarray(obs_cam, jnp.int32), obs_point=jnp.asarray(obs_pt, jnp.int32),
        obs_uv=jnp.asarray(np.asarray(obs_uv, np.float32)),
        obs_sigma2=jnp.ones(O), obs_valid=jnp.ones(O, bool),
        edges=edges,
    ), params


def test_vi_ba_converges(rng):
    kf_R, kf_p, kf_v, edges, _ = simulate_kf_chain(rng, n_kf=6)
    prob, params = _make_vi_problem(rng, kf_R, kf_p, kf_v, edges)
    prob = prob._replace(edges=edges)
    # Perturb states (except fixed KF0).
    K = len(kf_R)
    state = prob.state
    dR = [np.eye(3, dtype=np.float32)] + [
        np.asarray(lie.exp_so3(jnp.asarray(rng.normal(0, 0.01, 3).astype(np.float32))))
        for _ in range(K - 1)
    ]
    Rp = np.stack([kf_R[k] @ dR[k] for k in range(K)])
    pp = kf_p + np.concatenate([np.zeros((1, 3)), rng.normal(0, 0.03, (K - 1, 3))]).astype(np.float32)
    vp = kf_v + rng.normal(0, 0.05, (K, 3)).astype(np.float32)
    prob = prob._replace(state=state._replace(R=jnp.asarray(Rp), p=jnp.asarray(pp), v=jnp.asarray(vp)))

    res = inertial.solve_vi_ba(cam.CameraModel.PINHOLE, params, prob, iters=8, pcg_iters=40)
    p_err = np.linalg.norm(np.asarray(res.state.p) - kf_p, axis=-1)
    # Monocular scale is only weakly observable from this gentle motion
    # (0.3 px visual noise leaves a few-percent scale wobble in the MAP
    # optimum); demand clear improvement over the ~3-5 cm perturbation.
    assert p_err.max() < 0.02, p_err
    v_err = np.linalg.norm(np.asarray(res.state.v) - kf_v, axis=-1)
    assert v_err.max() < 0.08, v_err
