"""Sim3 refinement for loop/merge verification.

Re-design of `Optimizer::OptimizeSim3` (`/root/reference/src/Optimizer.cc:4111`):
the RANSAC Sim3 between two keyframes is polished by Gauss-Newton on the
DUAL reprojection residuals — each matched map-point pair (X1 in KF1's
camera frame, X2 in KF2's) contributes

  e2 = uv2 - proj(S21 . X1)        (ref edge e_12, `Optimizer.cc:4189`)
  e1 = uv1 - proj(S21^-1 . X2)     (ref edge e_21, `:4204`)

with per-octave information weights. The reference runs 5 g2o passes,
dropping pairs whose either edge exceeds chi2 = 10 between passes
(`:4225-4250`); here the whole schedule is ONE jitted program: a
`lax.fori_loop` of GN steps, each re-gating inliers then solving the
7x7 normal system (omega, nu, lambda) built via `jax.jacfwd` — the
problem is tiny (N <= ~1k pairs), so one fused program beats any
host-side loop.
"""

from __future__ import annotations

import functools
from typing import NamedTuple

import jax
import jax.numpy as jnp

from orbslam3_jax.ops import cameras as cam
from orbslam3_jax.ops import lie

CHI2_SIM3 = 9.99  # ref th2 = 10 (`Optimizer.cc:4230`)


class Sim3Result(NamedTuple):
    R: jnp.ndarray  # (3,3) refined R21
    t: jnp.ndarray  # (3,)
    s: jnp.ndarray  # ()
    inlier: jnp.ndarray  # (N,) pair survives both chi2 gates
    n_inliers: jnp.ndarray  # ()


@functools.partial(jax.jit, static_argnames=("model", "iters", "fix_scale"))
def optimize_sim3(
    model: cam.CameraModel,
    params: jnp.ndarray,
    R21: jnp.ndarray,
    t21: jnp.ndarray,
    s21: jnp.ndarray,
    X1: jnp.ndarray,  # (N,3) in KF1 camera frame
    X2: jnp.ndarray,  # (N,3) in KF2 camera frame
    uv1: jnp.ndarray,  # (N,2) observations in KF1
    uv2: jnp.ndarray,  # (N,2) observations in KF2
    sigma2_1: jnp.ndarray,  # (N,)
    sigma2_2: jnp.ndarray,  # (N,)
    valid: jnp.ndarray,  # (N,) bool
    fix_scale: bool = False,
    iters: int = 8,
) -> Sim3Result:
    X1 = X1.astype(jnp.float32)
    X2 = X2.astype(jnp.float32)
    w1 = jnp.where(sigma2_1 > 0, 1.0 / jnp.maximum(sigma2_1, 1e-9), 0.0)
    w2 = jnp.where(sigma2_2 > 0, 1.0 / jnp.maximum(sigma2_2, 1e-9), 0.0)

    def residuals(delta, R, t, s):
        """Stacked weighted residuals at local update delta=(w,v,l)."""
        Rd = lie.exp_so3(delta[:3]) @ R
        td = t + delta[3:6]
        sd = s * jnp.exp(delta[6]) if not fix_scale else s
        Y2 = sd * (X1 @ Rd.T) + td  # S21 . X1
        Y1 = (1.0 / sd) * ((X2 - td) @ Rd)  # S21^-1 . X2
        e2 = uv2 - cam.project(model, params, Y2)
        e1 = uv1 - cam.project(model, params, Y1)
        return e1, e2

    def chi2(e, w):
        return jnp.sum(e * e, axis=-1) * w

    def step(_, carry):
        R, t, s, inl = carry
        z = jnp.zeros(7)
        e1, e2 = residuals(z, R, t, s)
        # Pair-level gate: EITHER edge over chi2 drops the pair
        # (`Optimizer.cc:4230-4242`).
        inl = valid & (chi2(e1, w1) < CHI2_SIM3) & (chi2(e2, w2) < CHI2_SIM3)

        def flat(delta):
            f1, f2 = residuals(delta, R, t, s)
            m = inl.astype(jnp.float32)
            return jnp.concatenate(
                [
                    (f1 * (jnp.sqrt(w1) * m)[:, None]).reshape(-1),
                    (f2 * (jnp.sqrt(w2) * m)[:, None]).reshape(-1),
                ]
            )

        r0 = flat(z)
        J = jax.jacfwd(flat)(z)  # (4N, 7)
        H = J.T @ J + 1e-6 * jnp.eye(7)
        g = J.T @ r0
        delta = -jnp.linalg.solve(H, g)
        ok = jnp.all(jnp.isfinite(delta))
        delta = jnp.where(ok, delta, 0.0)
        R = lie.exp_so3(delta[:3]) @ R
        t = t + delta[3:6]
        s = s * jnp.exp(delta[6]) if not fix_scale else s
        return R, t, s, inl

    R, t, s, inl = jax.lax.fori_loop(
        0, iters, step, (R21, t21, jnp.asarray(s21, jnp.float32), valid)
    )
    e1, e2 = residuals(jnp.zeros(7), R, t, s)
    inl = valid & (chi2(e1, w1) < CHI2_SIM3) & (chi2(e2, w2) < CHI2_SIM3)
    return Sim3Result(R=R, t=t, s=s, inlier=inl, n_inliers=jnp.sum(inl))
