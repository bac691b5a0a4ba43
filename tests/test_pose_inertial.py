"""Pose-inertial motion-only optimizer: recover a perturbed frame state
from visual matches + one preintegrated IMU edge to a fixed keyframe."""

import jax.numpy as jnp
import numpy as np

from orbslam3_jax.ops import cameras as cam
from orbslam3_jax.ops import imu as imu_ops
from orbslam3_jax.ops import lie
from orbslam3_jax.optim.pose_inertial import optimize_pose_inertial
from orbslam3_jax.optim.pose_only import PoseObs

G = np.array([0.0, 0.0, -9.81], np.float32)


def _simulate(dt_total=0.5, hz=200, omega=(0.1, -0.2, 0.3), a_w=(0.4, 0.1, 0.2)):
    """Truth propagation + IMU samples (zero true bias)."""
    omega = np.asarray(omega, np.float32)
    a_w = np.asarray(a_w, np.float32)
    n = int(dt_total * hz)
    dt = dt_total / n
    R = np.eye(3, dtype=np.float32)
    p = np.zeros(3, np.float32)
    v = np.array([0.3, -0.1, 0.05], np.float32)
    R0, p0, v0 = R.copy(), p.copy(), v.copy()
    gyr, acc, dts = [], [], []
    for _ in range(n):
        gyr.append(omega)
        acc.append(R.T @ (a_w - G))
        dts.append(dt)
        Rmid = R @ np.asarray(lie.exp_so3(jnp.asarray(omega * dt / 2)))
        # (use start-of-interval specific force; consistent with the
        # preintegrator's piecewise-constant sample model)
        R = R @ np.asarray(lie.exp_so3(jnp.asarray(omega * dt)))
        p = p + v * dt + 0.5 * a_w * dt * dt
        v = v + a_w * dt
    return (R0, p0, v0), (R, p, v), (
        np.stack(acc), np.stack(gyr), np.asarray(dts, np.float32))


def test_pose_inertial_recovers_state():
    (R_kf, p_kf, v_kf), (R1, p1, v1), (acc, gyr, dts) = _simulate()
    calib = imu_ops.ImuCalib.create(
        jnp.eye(3), jnp.zeros(3), 1.7e-4, 2e-3, 2e-5, 3e-3, 200.0
    )
    pre = imu_ops.integrate(
        jnp.asarray(acc), jnp.asarray(gyr), jnp.asarray(dts),
        jnp.zeros(3), jnp.zeros(3), calib,
    )
    # Consistency of the simulated edge with truth.
    dP_err = np.asarray(pre.dP) - R_kf.T @ (
        p1 - p_kf - v_kf * float(pre.dT) - 0.5 * G * float(pre.dT) ** 2)
    assert np.linalg.norm(dP_err) < 2e-3, dP_err

    # Visual observations of the TRUE current pose (body == camera).
    rng = np.random.default_rng(0)
    params = cam.make_pinhole(300.0, 300.0, 320.0, 240.0)
    N = 96
    Xw = np.stack([rng.uniform(-2, 2, N), rng.uniform(-1.5, 1.5, N),
                   rng.uniform(3, 6, N)], -1).astype(np.float32)
    Rcw, tcw = R1.T, -R1.T @ p1
    Xc = (Rcw @ Xw.T).T + tcw
    uv = np.asarray(cam.pinhole_project(params, jnp.asarray(Xc))).copy()
    uv += rng.normal(0, 0.3, uv.shape).astype(np.float32)
    # 10% outliers
    out = rng.random(N) < 0.1
    uv[out] += rng.uniform(30, 80, (out.sum(), 2)).astype(np.float32)
    obs = PoseObs(
        Xw=jnp.asarray(Xw), uv=jnp.asarray(uv),
        ur=jnp.full(N, -1.0), sigma2=jnp.ones(N),
        valid=jnp.asarray(Xc[:, 2] > 0.3),
    )

    # Perturbed initial guess.
    dR = np.asarray(lie.exp_so3(jnp.asarray([0.03, -0.02, 0.04])))
    res = optimize_pose_inertial(
        cam.CameraModel.PINHOLE, params, obs,
        jnp.eye(3), jnp.zeros(3),
        jnp.asarray(R_kf), jnp.asarray(p_kf), jnp.asarray(v_kf),
        jnp.zeros(3), jnp.zeros(3),
        pre,
        jnp.asarray(R1 @ dR), jnp.asarray(p1 + [0.05, -0.04, 0.06]),
        jnp.asarray(v1 + [0.3, -0.2, 0.25]),
    )
    assert np.linalg.norm(np.asarray(res.p_wb) - p1) < 1e-2
    ang = np.arccos(np.clip((np.trace(np.asarray(res.R_wb).T @ R1) - 1) / 2, -1, 1))
    assert ang < 5e-3, ang
    assert np.linalg.norm(np.asarray(res.v) - v1) < 5e-2
    assert np.linalg.norm(np.asarray(res.bg)) < 0.02
    assert int(res.n_inliers) >= N * 0.75
    # Outliers rejected.
    inl = np.asarray(res.inlier)
    assert inl[out].sum() <= 2


def _propagate(R, p, v, omega, a_w, dt_total=0.5, hz=200):
    """Propagate truth from (R,p,v) and emit IMU samples."""
    omega = np.asarray(omega, np.float32)
    a_w = np.asarray(a_w, np.float32)
    n = int(dt_total * hz)
    dt = dt_total / n
    R, p, v = R.copy(), p.copy(), v.copy()
    gyr, acc, dts = [], [], []
    for _ in range(n):
        gyr.append(R.T @ (R @ omega))  # body rate (omega given in body here)
        acc.append(R.T @ (a_w - G))
        dts.append(dt)
        R = R @ np.asarray(lie.exp_so3(jnp.asarray(omega * dt)))
        p = p + v * dt + 0.5 * a_w * dt * dt
        v = v + a_w * dt
    return (R, p, v), (np.stack(acc), np.stack(gyr), np.asarray(dts, np.float32))


def _vis_obs(rng, params, R, p, N=96, noise=0.3):
    Xw = np.stack([rng.uniform(-2, 2, N), rng.uniform(-1.5, 1.5, N),
                   rng.uniform(3, 6, N)], -1).astype(np.float32)
    Rcw, tcw = R.T, -R.T @ p
    Xc = (Rcw @ Xw.T).T + tcw
    uv = np.asarray(cam.pinhole_project(params, jnp.asarray(Xc))).copy()
    uv += rng.normal(0, noise, uv.shape).astype(np.float32)
    return PoseObs(
        Xw=jnp.asarray(Xw), uv=jnp.asarray(uv),
        ur=jnp.full(N, -1.0), sigma2=jnp.ones(N),
        valid=jnp.asarray(Xc[:, 2] > 0.3),
    )


def test_pose_inertial_last_frame_chain():
    """KF -> f1 (LastKeyFrame, prior out) -> f2 (LastFrame, prior in):
    the marginalization prior chain recovers both states
    (`PoseInertialOptimizationLastFrame` + `Marginalize`,
    ref `Optimizer.cc:8068,5366`)."""
    from orbslam3_jax.optim.pose_inertial import (
        optimize_pose_inertial_last_frame, psd_clamp)

    calib = imu_ops.ImuCalib.create(
        jnp.eye(3), jnp.zeros(3), 1.7e-4, 2e-3, 2e-5, 3e-3, 200.0
    )
    rng = np.random.default_rng(1)
    params = cam.make_pinhole(300.0, 300.0, 320.0, 240.0)

    R_kf = np.eye(3, dtype=np.float32)
    p_kf = np.zeros(3, np.float32)
    v_kf = np.array([0.3, -0.1, 0.05], np.float32)
    (R1, p1, v1), (acc1, gyr1, dt1) = _propagate(
        R_kf, p_kf, v_kf, (0.1, -0.2, 0.3), (0.4, 0.1, 0.2))
    pre1 = imu_ops.integrate(
        jnp.asarray(acc1), jnp.asarray(gyr1), jnp.asarray(dt1),
        jnp.zeros(3), jnp.zeros(3), calib)
    obs1 = _vis_obs(rng, params, R1, p1)
    res1 = optimize_pose_inertial(
        cam.CameraModel.PINHOLE, params, obs1, jnp.eye(3), jnp.zeros(3),
        jnp.asarray(R_kf), jnp.asarray(p_kf), jnp.asarray(v_kf),
        jnp.zeros(3), jnp.zeros(3), pre1,
        jnp.asarray(R1), jnp.asarray(p1 + [0.03, -0.02, 0.02]),
        jnp.asarray(v1 + [0.1, -0.1, 0.1]),
    )
    assert np.linalg.norm(np.asarray(res1.p_wb) - p1) < 1e-2
    H1 = np.asarray(res1.H)
    # Prior info is symmetric PSD (after clamp) and informative in pose.
    Hc = np.asarray(psd_clamp(jnp.asarray(H1)))
    w = np.linalg.eigvalsh(Hc)
    assert w.min() > -1e-3
    assert Hc[3, 3] > 1.0  # position row carries real information

    (R2, p2, v2), (acc2, gyr2, dt2) = _propagate(
        R1, p1, v1, (-0.2, 0.1, 0.15), (-0.3, 0.2, 0.1))
    pre2 = imu_ops.integrate(
        jnp.asarray(acc2), jnp.asarray(gyr2), jnp.asarray(dt2),
        jnp.zeros(3), jnp.zeros(3), calib)
    obs2 = _vis_obs(rng, params, R2, p2)
    dR = np.asarray(lie.exp_so3(jnp.asarray([0.02, -0.03, 0.02])))
    res2 = optimize_pose_inertial_last_frame(
        cam.CameraModel.PINHOLE, params, obs2, jnp.eye(3), jnp.zeros(3),
        res1.R_wb, res1.p_wb, res1.v, res1.bg, res1.ba, res1.H, pre2,
        jnp.asarray(R2 @ dR), jnp.asarray(p2 + [0.04, -0.03, 0.05]),
        jnp.asarray(v2 + [0.2, -0.15, 0.2]),
    )
    assert np.linalg.norm(np.asarray(res2.p_wb) - p2) < 1e-2
    ang = np.arccos(np.clip(
        (np.trace(np.asarray(res2.R_wb).T @ R2) - 1) / 2, -1, 1))
    assert ang < 5e-3, ang
    assert np.linalg.norm(np.asarray(res2.v) - v2) < 5e-2
    # Marginalized prior for f2 is symmetric and carries information.
    H2 = np.asarray(res2.H)
    assert np.abs(H2 - H2.T).max() < 1e-3 * max(1.0, np.abs(H2).max())
    assert int(res2.n_inliers) >= 70
