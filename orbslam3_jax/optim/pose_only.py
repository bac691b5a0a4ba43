"""Pose-only optimization (motion-only BA).

Replaces `Optimizer::PoseOptimization` (`/root/reference/src/Optimizer.cc:
907-1180`): 4 outer rounds x 10 LM iterations, re-classifying outliers by
chi-squared between rounds (`Optimizer.cc:1141`), Huber kernel, per-octave
information, mono (2-DoF) and stereo (3-DoF, u/v/u_right) residuals.

State: Tcw = (R, t) world->camera. Updates are LEFT-multiplicative
(g2o `VertexSE3Expmap` convention): Tcw <- Exp([rho, phi]) * Tcw, so the
Jacobian of a camera point Xc w.r.t. [rho, phi] is [I | -hat(Xc)].

Everything is fixed-shape over a padded observation array; the whole
4x10 schedule compiles to one XLA program per (N, camera-model) pair.
"""

from __future__ import annotations

from typing import NamedTuple

import jax
import jax.numpy as jnp

from orbslam3_jax.ops import cameras as cam
from orbslam3_jax.ops import lie
from orbslam3_jax.optim import lm


class PoseObs(NamedTuple):
    """Padded observation set for one frame."""

    Xw: jnp.ndarray  # (N,3) map-point world positions
    uv: jnp.ndarray  # (N,2) measured pixels
    ur: jnp.ndarray  # (N,) right-cam u (stereo); <0 => mono observation
    sigma2: jnp.ndarray  # (N,) per-octave variance (scale^2)
    valid: jnp.ndarray  # (N,) bool


class PoseResult(NamedTuple):
    R: jnp.ndarray
    t: jnp.ndarray
    inlier: jnp.ndarray  # (N,) bool
    n_inliers: jnp.ndarray  # int32
    chi2: jnp.ndarray  # (N,) final per-obs chi2


def _residuals(model, params, bf, R, t, obs: PoseObs):
    """e (N,3), J (N,3,6), with stereo row masked for mono obs."""
    Xc = lie.se3_apply(R, t, obs.Xw)
    uv_hat = cam.project(model, params, Xc)
    z = Xc[..., 2]
    inv_z = 1.0 / jnp.where(jnp.abs(z) < 1e-9, 1e-9, z)
    is_stereo = obs.ur >= 0.0
    ur_hat = uv_hat[..., 0] - bf * inv_z
    e = jnp.concatenate(
        [uv_hat - obs.uv, jnp.where(is_stereo, ur_hat - obs.ur, 0.0)[..., None]],
        axis=-1,
    )
    # d(uv)/dXc (2,3); stereo row: d(ur)/dXc = d(u)/dXc + bf/z^2 * dz/dXc
    Jproj = cam.project_jac(model, params, Xc)  # (N,2,3)
    dz = jnp.zeros_like(Jproj[:, 0, :]).at[:, 2].set(1.0)
    Jur = Jproj[:, 0, :] + (bf * inv_z * inv_z)[:, None] * dz
    Jur = jnp.where(is_stereo[:, None], Jur, 0.0)
    Jc3 = jnp.concatenate([Jproj, Jur[:, None, :]], axis=1)  # (N,3,3)
    # dXc/d[rho,phi] = [I | -hat(Xc)]
    dXc = jnp.concatenate(
        [jnp.broadcast_to(jnp.eye(3, dtype=R.dtype), Xc.shape + (3,)), -lie.hat(Xc)],
        axis=-1,
    )  # (N,3,6)
    J = jnp.einsum("nij,njk->nik", Jc3, dXc)  # (N,3,6)
    # Points behind the camera cannot constrain the pose.
    ok = obs.valid & (z > 1e-3)
    return e, J, ok, is_stereo


def _chi2(e, obs: PoseObs, is_stereo):
    inv_s2 = 1.0 / obs.sigma2
    c2 = jnp.sum(e * e, axis=-1) * inv_s2
    return c2, inv_s2


def _residuals_right(model, params_r, R_rl, t_rl, R, t, obs_r: PoseObs):
    """Right-camera (ToBody) rows for a two-camera rig: the map point is
    projected through Trl * Tcw into the SECOND camera — the reference's
    `EdgeSE3ProjectXYZOnlyPoseToBody` (`OptimizableTypes.h:65`, used for
    the stereo-fisheye frame's right-image features, `Frame.cc:1187`).

    e (M,3; third col 0), J (M,3,6), ok (M,).
    """
    Xc_l = lie.se3_apply(R, t, obs_r.Xw)
    Xc_r = Xc_l @ R_rl.T + t_rl
    uv_hat = cam.project(model, params_r, Xc_r)
    e2 = uv_hat - obs_r.uv  # (M,2)
    Jproj = cam.project_jac(model, params_r, Xc_r)  # (M,2,3) d uv / d Xc_r
    # d Xc_r / d [rho,phi] = R_rl [I | -hat(Xc_l)]
    dXcl = jnp.concatenate(
        [jnp.broadcast_to(jnp.eye(3, dtype=R.dtype), Xc_l.shape + (3,)),
         -lie.hat(Xc_l)],
        axis=-1,
    )  # (M,3,6)
    J2 = jnp.einsum("nij,jk,nkl->nil", Jproj, R_rl, dXcl)  # (M,2,6)
    # Pad to the shared 3-row layout so both sets share the LM machinery.
    e = jnp.concatenate([e2, jnp.zeros_like(e2[:, :1])], axis=-1)
    J = jnp.concatenate([J2, jnp.zeros_like(J2[:, :1])], axis=1)
    ok = obs_r.valid & (Xc_r[..., 2] > 1e-3)
    return e, J, ok


def optimize_pose(
    model: cam.CameraModel,
    params: jnp.ndarray,
    R0: jnp.ndarray,
    t0: jnp.ndarray,
    obs: PoseObs,
    bf: float = 0.0,
    rounds: int = 4,
    iters_per_round: int = 10,
    obs_r: PoseObs | None = None,
    params_r: jnp.ndarray | None = None,
    R_rl: jnp.ndarray | None = None,
    t_rl: jnp.ndarray | None = None,
) -> PoseResult:
    """The 4x10 schedule of `Optimizer.cc:907` with chi2 re-gating.

    `obs_r` (+ `params_r`, `R_rl`, `t_rl`): optional right-camera rows
    for a two-camera (stereo-fisheye) rig — projection through
    Trl * Tcw, the reference's ToBody pose edges. Their inliers gate at
    the 2-DoF chi2 and contribute to H/b alongside the left rows; the
    returned inlier/chi2 arrays stay LEFT-indexed."""

    huber2_mono = lm.CHI2_MONO
    huber2_stereo = lm.CHI2_STEREO
    two_cam = obs_r is not None

    def right_terms(R, t, active_r, hub_mult):
        e, J, ok = _residuals_right(model, params_r, R_rl, t_rl, R, t, obs_r)
        ok = ok & active_r
        inv_s2 = 1.0 / obs_r.sigma2
        c2 = jnp.sum(e * e, axis=-1) * inv_s2
        w = jnp.where(ok, inv_s2 * lm.huber_weight(c2, huber2_mono * hub_mult), 0.0)
        return e, J, ok, c2, w

    def gn_iteration(carry, _):
        R, t, lamb, active, active_r, hub_mult = carry
        e, J, ok, is_stereo = _residuals(model, params, bf, R, t, obs)
        ok = ok & active
        c2, inv_s2 = _chi2(e, obs, is_stereo)
        delta2 = jnp.where(is_stereo, huber2_stereo, huber2_mono) * hub_mult
        w_rob = lm.huber_weight(c2, delta2)
        w = jnp.where(ok, inv_s2 * w_rob, 0.0)
        # H = sum J^T w J (6,6); b = sum J^T w e
        Jw = J * w[:, None, None]
        H = jnp.einsum("nij,nik->jk", Jw, J)
        b = jnp.einsum("nij,ni->j", Jw, e)
        if two_cam:
            e_r, J_r, ok_r, _, w_r = right_terms(R, t, active_r, hub_mult)
            Jw_r = J_r * w_r[:, None, None]
            H = H + jnp.einsum("nij,nik->jk", Jw_r, J_r)
            b = b + jnp.einsum("nij,ni->j", Jw_r, e_r)
        H_damped = H + lamb * jnp.diag(jnp.diag(H)) + 1e-9 * jnp.eye(6)
        delta = -jnp.linalg.solve(H_damped, b)
        R_new_, t_new_ = lie.exp_se3(delta)
        R_new, t_new = lie.se3_compose(R_new_, t_new_, R, t)
        R_new = lie.normalize_rotation(R_new)
        # Accept if robust cost decreases.
        def cost(R_, t_):
            e_, _, ok_, st_ = _residuals(model, params, bf, R_, t_, obs)
            c2_, inv_ = _chi2(e_, obs, st_)
            ok_ = ok_ & active
            # Huber rho(chi2)
            d2 = jnp.where(st_, huber2_stereo, huber2_mono) * hub_mult
            rho = jnp.where(
                c2_ <= d2, c2_, 2.0 * jnp.sqrt(d2 * jnp.maximum(c2_, 1e-12)) - d2
            )
            total = jnp.sum(jnp.where(ok_, rho, 0.0))
            if two_cam:
                _, _, okr, c2r, _ = right_terms(R_, t_, active_r, hub_mult)
                d2r = huber2_mono * hub_mult
                rhor = jnp.where(
                    c2r <= d2r, c2r,
                    2.0 * jnp.sqrt(d2r * jnp.maximum(c2r, 1e-12)) - d2r,
                )
                total = total + jnp.sum(jnp.where(okr, rhor, 0.0))
            return total

        c_old = cost(R, t)
        c_new = cost(R_new, t_new)
        accept = c_new < c_old
        R = jnp.where(accept, R_new, R)
        t = jnp.where(accept, t_new, t)
        lamb = jnp.clip(jnp.where(accept, lamb * 0.5, lamb * 4.0), 1e-9, 1e6)
        return (R, t, lamb, active, active_r, hub_mult), None

    R, t = R0, t0
    active = obs.valid
    active_r = obs_r.valid if two_cam else jnp.zeros(0, bool)
    for rnd in range(rounds):
        # Round 0 widens the Huber quadratic region 10x: a cold start
        # (identity prior) with small image motion otherwise stalls in a
        # spurious stationary point where capped outlier pulls cancel the
        # capped inlier pulls. The reference sidesteps this with warm
        # motion-model priors and by dropping the robust kernel after two
        # rounds (`Optimizer.cc:1120-1140 e->setRobustKernel(0)`).
        hub = 10.0 if rnd == 0 else 1.0
        (R, t, _, active, active_r, _), _ = jax.lax.scan(
            gn_iteration,
            (R, t, jnp.asarray(1e-4, R0.dtype), active, active_r,
             jnp.asarray(hub, R0.dtype)),
            None,
            length=iters_per_round,
        )
        # Re-classify inliers against the *original* valid set, as the
        # reference does each round (Optimizer.cc:1141: outliers can come
        # back if their chi2 drops).
        e, _, ok, is_stereo = _residuals(model, params, bf, R, t, obs)
        c2, _ = _chi2(e, obs, is_stereo)
        gate = jnp.where(is_stereo, lm.CHI2_STEREO, lm.CHI2_MONO)
        active = ok & (c2 <= gate)
        if two_cam:
            _, _, okr, c2r, _ = right_terms(R, t, obs_r.valid, 1.0)
            active_r = okr & (c2r <= lm.CHI2_MONO)

    e, _, ok, is_stereo = _residuals(model, params, bf, R, t, obs)
    c2, _ = _chi2(e, obs, is_stereo)
    gate = jnp.where(is_stereo, lm.CHI2_STEREO, lm.CHI2_MONO)
    inlier = ok & (c2 <= gate)
    return PoseResult(
        R=R, t=t, inlier=inlier, n_inliers=jnp.sum(inlier.astype(jnp.int32)), chi2=c2
    )
