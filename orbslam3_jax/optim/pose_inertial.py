"""Pose-inertial motion-only optimization (tracking, after IMU init).

Re-design of `Optimizer::PoseInertialOptimizationLastKeyFrame`
(`/root/reference/src/Optimizer.cc:3752`, the g2o graph of
`G2oTypes.h` EdgeMonoOnlyPose/EdgeStereoOnlyPose + EdgeInertial +
EdgeGyroRW/EdgeAccRW): the current frame's 15-dof body state
[R_wb, p_wb, v, bg, ba] is optimized against

  * visual reprojection residuals of its map-point matches (robust),
  * the IMU preintegration edge to the last keyframe, whose state is
    held FIXED (the reference fixes the KF vertices too),
  * bias random-walk residuals to the keyframe's biases.

The `...LastFrame` variant (`Optimizer.cc:8068`) is implemented here
too: between keyframes, the current frame is optimized jointly with
the LAST FRAME, whose 15-dof state carries a marginalization prior
(`ConstraintPoseImu`/`EdgePriorPoseImu`, `G2oTypes.h:704-786`) produced
by Schur-marginalizing the previous solve's 30x30 Hessian
(`Optimizer::Marginalize`, `Optimizer.cc:5366`). This propagates
inter-frame information along the frame chain instead of discarding it
by always re-anchoring on the keyframe.

Form: no g2o graph — one jitted Gauss-Newton loop. The 15-column
Jacobian of the whitened residual stack comes from `jax.jacfwd` (15
JVPs of a fixed-shape program), the normal system is a single 15x15
solve, and the 4-round chi2 re-gating of `PoseOptimization` is kept
for the visual rows.
"""

from __future__ import annotations

import functools
from typing import NamedTuple

import jax
import jax.numpy as jnp

from orbslam3_jax.ops import cameras as cam
from orbslam3_jax.ops import imu as imu_ops
from orbslam3_jax.ops import lie
from orbslam3_jax.optim import lm
from orbslam3_jax.optim.inertial import imu_residual
from orbslam3_jax.optim.pose_only import PoseObs


class PoseInertialResult(NamedTuple):
    R_wb: jnp.ndarray
    p_wb: jnp.ndarray
    v: jnp.ndarray
    bg: jnp.ndarray
    ba: jnp.ndarray
    Rcw: jnp.ndarray
    tcw: jnp.ndarray
    inlier: jnp.ndarray  # (N,) visual inliers
    n_inliers: jnp.ndarray
    H: jnp.ndarray  # (15,15) information of the frame state at the
    # solution, in the local chart of `_retract` — the marginalization
    # prior for the next frame (`ConstraintPoseImu`, `G2oTypes.h:704`)


def psd_clamp(H: jnp.ndarray) -> jnp.ndarray:
    """Project an information matrix onto the PSD cone (the reference's
    `ConstraintPoseImu` ctor zeroes negative eigenvalues,
    `G2oTypes.h:713-723`)."""
    H = 0.5 * (H + H.T)
    w, V = jnp.linalg.eigh(H)
    w = jnp.maximum(w, 0.0)
    return (V * w[None, :]) @ V.T


def _body_to_cam(R_wb, p_wb, Rbc, tbc):
    Rwc = R_wb @ Rbc
    Rcw = Rwc.T
    tcw = -Rcw @ (p_wb + R_wb @ tbc)
    return Rcw, tcw


def _retract(R, p, v, bg, ba, dx):
    dth, dp, dv, dbg, dba = (
        dx[0:3], dx[3:6], dx[6:9], dx[9:12], dx[12:15]
    )
    Rn = R @ lie.exp_so3(dth)
    return Rn, p + R @ dp, v + dv, bg + dbg, ba + dba


def _vis_e(model, params, bf, Rcw, tcw, obs: PoseObs):
    """Visual residual rows (N,3) — the `e` half of
    `pose_only._residuals` (the Jacobian comes from autodiff here)."""
    Xc = lie.se3_apply(Rcw, tcw, obs.Xw)
    uv_hat = cam.project(model, params, Xc)
    z = Xc[..., 2]
    inv_z = 1.0 / jnp.where(jnp.abs(z) < 1e-9, 1e-9, z)
    is_stereo = obs.ur >= 0.0
    ur_hat = uv_hat[..., 0] - bf * inv_z
    e = jnp.concatenate(
        [uv_hat - obs.uv, jnp.where(is_stereo, ur_hat - obs.ur, 0.0)[..., None]],
        axis=-1,
    )
    ok = obs.valid & (z > 1e-3)
    return e, ok, is_stereo


@functools.partial(
    jax.jit, static_argnames=("model", "rounds", "iters_per_round")
)
def optimize_pose_inertial(
    model: cam.CameraModel,
    params: jnp.ndarray,
    obs: PoseObs,
    Rbc: jnp.ndarray,  # body->cam extrinsics (Tbc as in inertial_support)
    tbc: jnp.ndarray,
    R_kf: jnp.ndarray,  # anchor keyframe body state (FIXED)
    p_kf: jnp.ndarray,
    v_kf: jnp.ndarray,
    bg_kf: jnp.ndarray,
    ba_kf: jnp.ndarray,
    pre: imu_ops.Preintegrated,  # KF -> current frame
    R0_wb: jnp.ndarray,  # current-state initial guess (from PredictStateIMU)
    p0_wb: jnp.ndarray,
    v0: jnp.ndarray,
    bf: float = 0.0,
    rounds: int = 4,
    iters_per_round: int = 5,
) -> PoseInertialResult:
    C9 = pre.C[:9, :9]
    info9 = jnp.linalg.inv(0.5 * (C9 + C9.T) + 1e-10 * jnp.eye(9))
    L_imu = jnp.linalg.cholesky(0.5 * (info9 + info9.T))
    Crw = pre.C[9:, 9:]
    info_rw = jnp.linalg.inv(Crw + 1e-12 * jnp.eye(6))
    L_rw = jnp.linalg.cholesky(0.5 * (info_rw + info_rw.T))
    g = imu_ops.GRAVITY
    inv_sig = jnp.sqrt(1.0 / obs.sigma2)

    def whitened(state, active, w_rob_sqrt):
        """(3N+15,) whitened residual stack as a function of dx=0-centred
        state; robust weights are frozen per iteration (IRLS)."""
        R, p, v, bg, ba = state
        Rcw, tcw = _body_to_cam(R, p, Rbc, tbc)
        e, ok, _ = _vis_e(model, params, bf, Rcw, tcw, obs)
        w = jnp.where(ok & active, inv_sig * w_rob_sqrt, 0.0)
        e_vis = (e * w[:, None]).reshape(-1)
        r_imu = imu_residual(
            R_kf, p_kf, v_kf, bg, ba, R, p, v,
            pre.dR, pre.dV, pre.dP, pre.JRg, pre.JVg, pre.JVa,
            pre.JPg, pre.JPa, pre.bias_gyro, pre.bias_acc, pre.dT, g,
        )
        r_rw = jnp.concatenate([bg - bg_kf, ba - ba_kf])
        return jnp.concatenate([e_vis, L_imu.T @ r_imu, L_rw.T @ r_rw])

    def chi2_vis(state):
        R, p, v, bg, ba = state
        Rcw, tcw = _body_to_cam(R, p, Rbc, tbc)
        e, ok, is_stereo = _vis_e(model, params, bf, Rcw, tcw, obs)
        return jnp.sum(e * e, -1) / obs.sigma2, ok, is_stereo

    def gn_iteration(carry, _):
        state, lamb, active = carry
        c2, ok, is_stereo = chi2_vis(state)
        delta2 = jnp.where(is_stereo, lm.CHI2_STEREO, lm.CHI2_MONO)
        w_rob_sqrt = jnp.sqrt(lm.huber_weight(c2, delta2))

        def r_of_dx(dx):
            return whitened(_retract(*state, dx), active, w_rob_sqrt)

        dx0 = jnp.zeros(15)
        r0 = r_of_dx(dx0)
        J = jax.jacfwd(r_of_dx)(dx0)  # (M,15)
        H = J.T @ J
        b = J.T @ r0
        Hd = H + lamb * jnp.diag(jnp.diag(H)) + 1e-9 * jnp.eye(15)
        dx = -jnp.linalg.solve(Hd, b)
        new_state = _retract(*state, dx)
        new_state = (lie.normalize_rotation(new_state[0]),) + new_state[1:]
        c_old = jnp.sum(r0 * r0)
        r_new = whitened(new_state, active, w_rob_sqrt)
        c_new = jnp.sum(r_new * r_new)
        better = c_new < c_old
        state = jax.tree.map(
            lambda a, b_: jnp.where(better, b_, a), state, new_state
        )
        lamb = jnp.where(better, lamb * 0.5, lamb * 4.0)
        return (state, jnp.clip(lamb, 1e-8, 1e4), active), None

    state = (R0_wb, p0_wb, v0, bg_kf, ba_kf)
    active = obs.valid

    for _ in range(rounds):
        (state, _, active), _ = jax.lax.scan(
            gn_iteration, (state, jnp.float32(1e-3), active),
            None, length=iters_per_round,
        )
        c2, ok, is_stereo = chi2_vis(state)
        gate = jnp.where(is_stereo, lm.CHI2_STEREO, lm.CHI2_MONO)
        active = obs.valid & ok & (c2 <= gate)

    R, p, v, bg, ba = state
    Rcw, tcw = _body_to_cam(R, p, Rbc, tbc)
    # Information of the solved frame in its local chart. The anchor KF
    # is fixed (infinite prior), so the marginalized prior for the next
    # frame is simply H = J^T J of the free 15-dof block
    # (ref `PoseInertialOptimizationLastKeyFrame` tail building
    # `ConstraintPoseImu`, `Optimizer.cc:4030-4070`).
    c2, ok, is_stereo = chi2_vis(state)
    delta2 = jnp.where(is_stereo, lm.CHI2_STEREO, lm.CHI2_MONO)
    w_rob_sqrt = jnp.sqrt(lm.huber_weight(c2, delta2))
    Jf = jax.jacfwd(lambda dx: whitened(_retract(*state, dx), active, w_rob_sqrt))(
        jnp.zeros(15)
    )
    return PoseInertialResult(
        R_wb=R, p_wb=p, v=v, bg=bg, ba=ba, Rcw=Rcw, tcw=tcw,
        inlier=active, n_inliers=jnp.sum(active.astype(jnp.int32)),
        H=Jf.T @ Jf,
    )


@functools.partial(
    jax.jit, static_argnames=("model", "rounds", "iters_per_round")
)
def optimize_pose_inertial_last_frame(
    model: cam.CameraModel,
    params: jnp.ndarray,
    obs: PoseObs,
    Rbc: jnp.ndarray,
    tbc: jnp.ndarray,
    # Last-FRAME anchor state (free, carries the marginalization prior).
    R_lf: jnp.ndarray,
    p_lf: jnp.ndarray,
    v_lf: jnp.ndarray,
    bg_lf: jnp.ndarray,
    ba_lf: jnp.ndarray,
    H_prior: jnp.ndarray,  # (15,15) info of the last frame's state
    pre: imu_ops.Preintegrated,  # last frame -> current frame
    R0_wb: jnp.ndarray,  # current-frame initial guess
    p0_wb: jnp.ndarray,
    v0: jnp.ndarray,
    bf: float = 0.0,
    rounds: int = 4,
    iters_per_round: int = 5,
) -> PoseInertialResult:
    """`PoseInertialOptimizationLastFrame` (`Optimizer.cc:8068`):
    jointly optimize [last frame, current frame] (30 dof). The last
    frame is constrained by its marginalization prior
    (`EdgePriorPoseImu`, `G2oTypes.h:751`), the two frames by the IMU
    preintegration + bias random walk, the current frame by its visual
    matches. On return, `H` is the 15x15 prior for the *current* frame,
    obtained by Schur-marginalizing the last frame out of the 30x30
    system (`Optimizer::Marginalize`, `Optimizer.cc:5366`).

    Form: one jitted 30-dof Gauss-Newton loop; the 30-column
    Jacobian comes from `jax.jacfwd` of the whitened residual stack,
    the marginalization is a single 15x15 Schur complement.
    """
    C9 = pre.C[:9, :9]
    info9 = jnp.linalg.inv(0.5 * (C9 + C9.T) + 1e-10 * jnp.eye(9))
    L_imu = jnp.linalg.cholesky(0.5 * (info9 + info9.T))
    Crw = pre.C[9:, 9:]
    info_rw = jnp.linalg.inv(Crw + 1e-12 * jnp.eye(6))
    L_rw = jnp.linalg.cholesky(0.5 * (info_rw + info_rw.T))
    Hp = psd_clamp(H_prior)
    L_pr = jnp.linalg.cholesky(Hp + 1e-6 * jnp.eye(15))
    g = imu_ops.GRAVITY
    inv_sig = jnp.sqrt(1.0 / obs.sigma2)

    def split(state):
        return state[:5], state[5:]

    def whitened(state, active, w_rob_sqrt):
        (R1, p1, v1, bg1, ba1), (R2, p2, v2, bg2, ba2) = split(state)
        # Prior residual: local-chart offset of frame1 from its anchor
        # (the chart `_retract` uses: dtheta = Log(Ra^T R),
        # dp = Ra^T (p - pa)).
        r_pr = jnp.concatenate([
            lie.log_so3(R_lf.T @ R1),
            R_lf.T @ (p1 - p_lf),
            v1 - v_lf,
            bg1 - bg_lf,
            ba1 - ba_lf,
        ])
        Rcw, tcw = _body_to_cam(R2, p2, Rbc, tbc)
        e, ok, _ = _vis_e(model, params, bf, Rcw, tcw, obs)
        w = jnp.where(ok & active, inv_sig * w_rob_sqrt, 0.0)
        e_vis = (e * w[:, None]).reshape(-1)
        # The preintegration edge reads the LAST frame's bias vertices
        # (ref `PoseInertialOptimizationLastFrame` setVertex(2,VGk)/
        # setVertex(3,VAk), `Optimizer.cc:8319-8321`); the current frame's
        # biases are linked only through the random-walk residual below.
        r_imu = imu_residual(
            R1, p1, v1, bg1, ba1, R2, p2, v2,
            pre.dR, pre.dV, pre.dP, pre.JRg, pre.JVg, pre.JVa,
            pre.JPg, pre.JPa, pre.bias_gyro, pre.bias_acc, pre.dT, g,
        )
        r_rw = jnp.concatenate([bg2 - bg1, ba2 - ba1])
        return jnp.concatenate(
            [e_vis, L_imu.T @ r_imu, L_rw.T @ r_rw, L_pr.T @ r_pr]
        )

    def retract2(state, dx):
        f1, f2 = split(state)
        return _retract(*f1, dx[:15]) + _retract(*f2, dx[15:])

    def chi2_vis(state):
        _, (R2, p2, v2, bg2, ba2) = split(state)
        Rcw, tcw = _body_to_cam(R2, p2, Rbc, tbc)
        e, ok, is_stereo = _vis_e(model, params, bf, Rcw, tcw, obs)
        return jnp.sum(e * e, -1) / obs.sigma2, ok, is_stereo

    def gn_iteration(carry, _):
        state, lamb, active = carry
        c2, ok, is_stereo = chi2_vis(state)
        delta2 = jnp.where(is_stereo, lm.CHI2_STEREO, lm.CHI2_MONO)
        w_rob_sqrt = jnp.sqrt(lm.huber_weight(c2, delta2))

        def r_of_dx(dx):
            return whitened(retract2(state, dx), active, w_rob_sqrt)

        dx0 = jnp.zeros(30)
        r0 = r_of_dx(dx0)
        J = jax.jacfwd(r_of_dx)(dx0)  # (M,30)
        H = J.T @ J
        b = J.T @ r0
        Hd = H + lamb * jnp.diag(jnp.diag(H)) + 1e-9 * jnp.eye(30)
        dx = -jnp.linalg.solve(Hd, b)
        new_state = retract2(state, dx)
        new_state = (
            (lie.normalize_rotation(new_state[0]),) + new_state[1:5]
            + (lie.normalize_rotation(new_state[5]),) + new_state[6:]
        )
        c_old = jnp.sum(r0 * r0)
        r_new = whitened(new_state, active, w_rob_sqrt)
        c_new = jnp.sum(r_new * r_new)
        better = c_new < c_old
        state = jax.tree.map(
            lambda a, b_: jnp.where(better, b_, a), state, new_state
        )
        lamb = jnp.where(better, lamb * 0.5, lamb * 4.0)
        return (state, jnp.clip(lamb, 1e-8, 1e4), active), None

    state = (R_lf, p_lf, v_lf, bg_lf, ba_lf, R0_wb, p0_wb, v0, bg_lf, ba_lf)
    active = obs.valid

    for _ in range(rounds):
        (state, _, active), _ = jax.lax.scan(
            gn_iteration, (state, jnp.float32(1e-3), active),
            None, length=iters_per_round,
        )
        c2, ok, is_stereo = chi2_vis(state)
        gate = jnp.where(is_stereo, lm.CHI2_STEREO, lm.CHI2_MONO)
        active = obs.valid & ok & (c2 <= gate)

    _, (R, p, v, bg, ba) = split(state)
    Rcw, tcw = _body_to_cam(R, p, Rbc, tbc)

    # Marginalize the last frame (block 0:15) out of the converged
    # 30x30 system: H_keep = H22 - H21 H11^{-1} H12
    # (`Optimizer::Marginalize`, `Optimizer.cc:5366-5420`).
    c2, ok, is_stereo = chi2_vis(state)
    delta2 = jnp.where(is_stereo, lm.CHI2_STEREO, lm.CHI2_MONO)
    w_rob_sqrt = jnp.sqrt(lm.huber_weight(c2, delta2))
    Jf = jax.jacfwd(
        lambda dx: whitened(retract2(state, dx), active, w_rob_sqrt)
    )(jnp.zeros(30))
    Hf = Jf.T @ Jf
    H11 = Hf[:15, :15] + 1e-8 * jnp.eye(15)
    H12 = Hf[:15, 15:]
    H22 = Hf[15:, 15:]
    H_marg = H22 - H12.T @ jnp.linalg.solve(H11, H12)
    H_marg = 0.5 * (H_marg + H_marg.T)

    return PoseInertialResult(
        R_wb=R, p_wb=p, v=v, bg=bg, ba=ba, Rcw=Rcw, tcw=tcw,
        inlier=active, n_inliers=jnp.sum(active.astype(jnp.int32)),
        H=H_marg,
    )
