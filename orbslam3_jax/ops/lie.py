"""SO(3) / SE(3) / Sim(3) Lie-group operations, batched and jittable.

Semantics mirror the reference's hand-rolled helpers
(`/root/reference/src/ImuTypes.cc:31-152`: ExpSO3 / LogSO3 /
RightJacobianSO3 / InverseRightJacobianSO3 / NormalizeRotation and
`Thirdparty/g2o/g2o/types/{se3quat.h,sim3.h}`), but are written as pure
vectorized JAX functions: every op broadcasts over arbitrary leading batch
dimensions so whole keyframe / observation arrays are transformed in one
XLA program.

Conventions
-----------
* Rotations are 3x3 matrices, float32 by default.
* `exp` updates are applied on the RIGHT in the body frame,
  ``R <- R @ exp_so3(dtheta)``, matching the reference optimizer's update
  rule (`/root/reference/src/G2oTypes.cc:192-220`).
* Small-angle branches use 2nd-order Taylor expansions selected with
  `jnp.where` so the functions stay branch-free under `jit` and have
  finite gradients at theta = 0.
"""

from __future__ import annotations

import jax
import jax.numpy as jnp

_EPS = 1e-8


def hat(w: jnp.ndarray) -> jnp.ndarray:
    """Skew-symmetric matrix of ``w``: hat(w) @ v == cross(w, v).

    Supports leading batch dims: (..., 3) -> (..., 3, 3).
    """
    wx, wy, wz = w[..., 0], w[..., 1], w[..., 2]
    z = jnp.zeros_like(wx)
    rows = jnp.stack(
        [
            jnp.stack([z, -wz, wy], axis=-1),
            jnp.stack([wz, z, -wx], axis=-1),
            jnp.stack([-wy, wx, z], axis=-1),
        ],
        axis=-2,
    )
    return rows


def vee(W: jnp.ndarray) -> jnp.ndarray:
    """Inverse of :func:`hat`: (..., 3, 3) -> (..., 3)."""
    return jnp.stack([W[..., 2, 1], W[..., 0, 2], W[..., 1, 0]], axis=-1)


def _theta(w: jnp.ndarray):
    """(theta_safe, theta2, small): `theta_safe` equals |w| away from zero
    but is computed as sqrt of a clamped argument so its gradient is
    finite at w = 0 (the standard double-where trick — both branches of a
    `jnp.where` are differentiated, so sqrt(0) would leak NaN into every
    small-angle Taylor branch)."""
    theta2 = jnp.sum(w * w, axis=-1)
    small = theta2 < 1e-8
    theta_safe = jnp.sqrt(jnp.where(small, 1.0, theta2))
    return theta_safe, theta2, small


def exp_so3(w: jnp.ndarray) -> jnp.ndarray:
    """Rodrigues exponential map so(3) -> SO(3), batched.

    Matches `ImuTypes.cc:ExpSO3` (:49) including the small-angle branch
    ``I + W + 0.5 W^2``.
    """
    theta, theta2, small = _theta(w)
    W = hat(w)
    W2 = W @ W
    # sin(t)/t and (1-cos t)/t^2 with Taylor fallbacks.
    safe_t2 = jnp.where(small, 1.0, theta2)
    a = jnp.where(small, 1.0 - theta2 / 6.0, jnp.sin(theta) / theta)
    b = jnp.where(small, 0.5 - theta2 / 24.0, (1.0 - jnp.cos(theta)) / safe_t2)
    eye = jnp.broadcast_to(jnp.eye(3, dtype=w.dtype), W.shape)
    return eye + a[..., None, None] * W + b[..., None, None] * W2


def log_so3(R: jnp.ndarray) -> jnp.ndarray:
    """Logarithm map SO(3) -> so(3), batched; matches `ImuTypes.cc:LogSO3` (:90).

    Uses the trace formula with a quaternion-based fallback near theta = pi
    where the standard formula is ill-conditioned.
    """
    tr = R[..., 0, 0] + R[..., 1, 1] + R[..., 2, 2]
    cos_t = jnp.clip((tr - 1.0) * 0.5, -1.0, 1.0)
    w_skew = vee(R - jnp.swapaxes(R, -1, -2))  # = 2 sin(theta) * axis
    # atan2 formulation: far better conditioned than arccos in float32.
    # The +1e-24 keeps sqrt differentiable at theta = 0 and pi (the chain
    # rule through norm() would otherwise leak NaN into jacfwd even for
    # the branches jnp.where discards).
    sin2 = 0.25 * jnp.sum(w_skew * w_skew, axis=-1)
    sin_t_n = jnp.sqrt(sin2 + 1e-24)
    theta = jnp.arctan2(sin_t_n, cos_t)

    small = theta < 1e-4
    near_pi = theta > jnp.pi - 1e-3

    # Generic branch: w = theta / (2 sin theta) * vee(R - R^T)
    safe_sin = jnp.where(small | near_pi, 1.0, sin_t_n)
    generic = w_skew * (theta / (2.0 * safe_sin))[..., None]

    # Small branch: w ~= 0.5 * vee(R - R^T) * (1 + theta^2/6)
    small_w = 0.5 * w_skew * (1.0 + theta[..., None] ** 2 / 6.0)

    # Near-pi branch: axis from diagonal of (R + I)/2 = axis axis^T near pi.
    B = (R + jnp.broadcast_to(jnp.eye(3, dtype=R.dtype), R.shape)) * 0.5
    diag = jnp.stack([B[..., 0, 0], B[..., 1, 1], B[..., 2, 2]], axis=-1)
    # Dummy-safe sqrt argument for the rows this branch doesn't own.
    diag_safe = jnp.where(near_pi[..., None], jnp.clip(diag, 1e-9, None), 1.0)
    axis = jnp.sqrt(diag_safe)
    # Fix signs from off-diagonals; pick the largest-axis column for stability.
    k = jnp.argmax(diag, axis=-1)
    col = jnp.take_along_axis(B, k[..., None, None].repeat(3, axis=-2), axis=-1)[..., 0]
    sign = jnp.sign(jnp.where(col == 0.0, 1.0, col))
    axis = axis * sign / jnp.linalg.norm(
        axis * sign + _EPS * jnp.ones_like(axis), axis=-1, keepdims=True
    )
    pi_w = axis * theta[..., None]

    out = jnp.where(small[..., None], small_w, generic)
    out = jnp.where(near_pi[..., None], pi_w, out)
    return out


def right_jacobian_so3(w: jnp.ndarray) -> jnp.ndarray:
    """Right Jacobian of SO(3); matches `ImuTypes.cc:RightJacobianSO3` (:107).

    Jr(w) = I - (1-cos t)/t^2 W + (t - sin t)/t^3 W^2.
    """
    theta, theta2, small = _theta(w)
    W = hat(w)
    W2 = W @ W
    safe_t2 = jnp.where(small, 1.0, theta2)
    safe_t3 = safe_t2 * theta
    b = jnp.where(small, 0.5 - theta2 / 24.0, (1.0 - jnp.cos(theta)) / safe_t2)
    c = jnp.where(small, 1.0 / 6.0 - theta2 / 120.0, (theta - jnp.sin(theta)) / safe_t3)
    eye = jnp.broadcast_to(jnp.eye(3, dtype=w.dtype), W.shape)
    return eye - b[..., None, None] * W + c[..., None, None] * W2


def inv_right_jacobian_so3(w: jnp.ndarray) -> jnp.ndarray:
    """Inverse right Jacobian; matches `ImuTypes.cc:InverseRightJacobianSO3` (:130).

    Jr^-1(w) = I + 0.5 W + (1/t^2 - (1+cos t)/(2 t sin t)) W^2.
    """
    theta, theta2, small = _theta(w)
    W = hat(w)
    W2 = W @ W
    safe_t2 = jnp.where(small, 1.0, theta2)
    sin_t = jnp.sin(theta)
    safe_den = jnp.where(small, 1.0, 2.0 * theta * sin_t)
    c = jnp.where(
        small,
        1.0 / 12.0 + theta2 / 720.0,
        1.0 / safe_t2 - (1.0 + jnp.cos(theta)) / safe_den,
    )
    eye = jnp.broadcast_to(jnp.eye(3, dtype=w.dtype), W.shape)
    return eye + 0.5 * W + c[..., None, None] * W2


def normalize_rotation(R: jnp.ndarray) -> jnp.ndarray:
    """Re-orthonormalize a near-rotation matrix (ref `ImuTypes.cc:NormalizeRotation` :31).

    The reference uses an SVD; here we round-trip through a normalized
    quaternion, which is cheap, batched, and differentiable — adequate for
    drift accumulated by float32 chains.
    """
    q = quat_from_mat(R)
    q = q / jnp.linalg.norm(q, axis=-1, keepdims=True)
    return mat_from_quat(q)


# ---------------------------------------------------------------------------
# Quaternions (w, x, y, z)
# ---------------------------------------------------------------------------


def quat_from_mat(R: jnp.ndarray) -> jnp.ndarray:
    """Rotation matrix -> quaternion (w,x,y,z), batched, branch-free.

    Computes all four Shepperd candidates and selects the best-conditioned
    one with `argmax`, so it works under `vmap`/`jit`.
    """
    m00, m01, m02 = R[..., 0, 0], R[..., 0, 1], R[..., 0, 2]
    m10, m11, m12 = R[..., 1, 0], R[..., 1, 1], R[..., 1, 2]
    m20, m21, m22 = R[..., 2, 0], R[..., 2, 1], R[..., 2, 2]

    tw = 1.0 + m00 + m11 + m22
    tx = 1.0 + m00 - m11 - m22
    ty = 1.0 - m00 + m11 - m22
    tz = 1.0 - m00 - m11 + m22
    traces = jnp.stack([tw, tx, ty, tz], axis=-1)

    def cand_w():
        s = jnp.sqrt(jnp.maximum(tw, _EPS)) * 2.0
        return jnp.stack([0.25 * s, (m21 - m12) / s, (m02 - m20) / s, (m10 - m01) / s], axis=-1)

    def cand_x():
        s = jnp.sqrt(jnp.maximum(tx, _EPS)) * 2.0
        return jnp.stack([(m21 - m12) / s, 0.25 * s, (m01 + m10) / s, (m02 + m20) / s], axis=-1)

    def cand_y():
        s = jnp.sqrt(jnp.maximum(ty, _EPS)) * 2.0
        return jnp.stack([(m02 - m20) / s, (m01 + m10) / s, 0.25 * s, (m12 + m21) / s], axis=-1)

    def cand_z():
        s = jnp.sqrt(jnp.maximum(tz, _EPS)) * 2.0
        return jnp.stack([(m10 - m01) / s, (m02 + m20) / s, (m12 + m21) / s, 0.25 * s], axis=-1)

    cands = jnp.stack([cand_w(), cand_x(), cand_y(), cand_z()], axis=-2)  # (...,4,4)
    best = jnp.argmax(traces, axis=-1)
    q = jnp.take_along_axis(cands, best[..., None, None].repeat(4, axis=-1), axis=-2)[..., 0, :]
    # Canonical sign: w >= 0.
    q = q * jnp.where(q[..., :1] < 0, -1.0, 1.0)
    return q / jnp.linalg.norm(q, axis=-1, keepdims=True)


def mat_from_quat(q: jnp.ndarray) -> jnp.ndarray:
    """Quaternion (w,x,y,z) -> rotation matrix, batched."""
    w, x, y, z = q[..., 0], q[..., 1], q[..., 2], q[..., 3]
    r00 = 1 - 2 * (y * y + z * z)
    r01 = 2 * (x * y - w * z)
    r02 = 2 * (x * z + w * y)
    r10 = 2 * (x * y + w * z)
    r11 = 1 - 2 * (x * x + z * z)
    r12 = 2 * (y * z - w * x)
    r20 = 2 * (x * z - w * y)
    r21 = 2 * (y * z + w * x)
    r22 = 1 - 2 * (x * x + y * y)
    return jnp.stack(
        [
            jnp.stack([r00, r01, r02], axis=-1),
            jnp.stack([r10, r11, r12], axis=-1),
            jnp.stack([r20, r21, r22], axis=-1),
        ],
        axis=-2,
    )


# ---------------------------------------------------------------------------
# SE(3): represented as (R: (...,3,3), t: (...,3))
# ---------------------------------------------------------------------------


def se3_apply(R: jnp.ndarray, t: jnp.ndarray, p: jnp.ndarray) -> jnp.ndarray:
    """Apply transform: R @ p + t, broadcasting over batch dims."""
    return jnp.einsum("...ij,...j->...i", R, p) + t


def se3_inv(R: jnp.ndarray, t: jnp.ndarray):
    """Inverse transform: (R^T, -R^T t)."""
    Rt = jnp.swapaxes(R, -1, -2)
    return Rt, -jnp.einsum("...ij,...j->...i", Rt, t)


def se3_compose(Ra, ta, Rb, tb):
    """(Ra,ta) * (Rb,tb): first apply b, then a."""
    return Ra @ Rb, jnp.einsum("...ij,...j->...i", Ra, tb) + ta


def exp_se3(xi: jnp.ndarray):
    """se(3) -> SE(3). ``xi = [rho (3), phi (3)]`` (translation first).

    Returns (R, t) with t = V(phi) @ rho.
    """
    rho, phi = xi[..., :3], xi[..., 3:]
    R = exp_so3(phi)
    theta, theta2, small = _theta(phi)
    W = hat(phi)
    W2 = W @ W
    safe_t2 = jnp.where(small, 1.0, theta2)
    safe_t3 = safe_t2 * theta
    b = jnp.where(small, 0.5 - theta2 / 24.0, (1.0 - jnp.cos(theta)) / safe_t2)
    c = jnp.where(small, 1.0 / 6.0 - theta2 / 120.0, (theta - jnp.sin(theta)) / safe_t3)
    eye = jnp.broadcast_to(jnp.eye(3, dtype=xi.dtype), W.shape)
    V = eye + b[..., None, None] * W + c[..., None, None] * W2
    t = jnp.einsum("...ij,...j->...i", V, rho)
    return R, t


def log_se3(R: jnp.ndarray, t: jnp.ndarray) -> jnp.ndarray:
    """SE(3) -> se(3): returns [rho, phi]."""
    phi = log_so3(R)
    theta, theta2, small = _theta(phi)
    W = hat(phi)
    W2 = W @ W
    safe_t2 = jnp.where(small, 1.0, theta2)
    sin_t, cos_t = jnp.sin(theta), jnp.cos(theta)
    safe_den = jnp.where(small, 1.0, 2.0 * safe_t2 * sin_t)
    c = jnp.where(
        small,
        1.0 / 12.0 + theta2 / 720.0,
        (2.0 * sin_t - theta * (1.0 + cos_t)) / safe_den,
    )
    eye = jnp.broadcast_to(jnp.eye(3, dtype=R.dtype), W.shape)
    Vinv = eye - 0.5 * W + c[..., None, None] * W2
    rho = jnp.einsum("...ij,...j->...i", Vinv, t)
    return jnp.concatenate([rho, phi], axis=-1)


# ---------------------------------------------------------------------------
# Sim(3): (R, t, s) — used by loop closing / map merging
# (reference `Thirdparty/g2o/g2o/types/sim3.h`, `src/Sim3Solver.cc`)
# ---------------------------------------------------------------------------


def sim3_apply(R, t, s, p):
    """s * R @ p + t."""
    return s[..., None] * jnp.einsum("...ij,...j->...i", R, p) + t


def sim3_inv(R, t, s):
    Rt = jnp.swapaxes(R, -1, -2)
    s_inv = 1.0 / s
    return Rt, -s_inv[..., None] * jnp.einsum("...ij,...j->...i", Rt, t), s_inv


def sim3_compose(Ra, ta, sa, Rb, tb, sb):
    """(Ra,ta,sa) * (Rb,tb,sb)."""
    return (
        Ra @ Rb,
        sa[..., None] * jnp.einsum("...ij,...j->...i", Ra, tb) + ta,
        sa * sb,
    )


def _sim3_V(phi: jnp.ndarray, sigma: jnp.ndarray) -> jnp.ndarray:
    """V(phi, sigma) = integral_0^1 exp(sigma*tau) * exp_so3(phi*tau) dtau.

    Evaluated by 32-point midpoint quadrature: exact to <1e-7 for the step
    sizes an optimizer produces (|phi|,|sigma| < pi), branch-free, and
    batched. The closed form (Strasdat's thesis) has three nested
    small-value branches; the quadrature is simpler, and cheap at our tiny
    batch sizes.
    """
    n_steps = 32
    dt = 1.0 / n_steps
    eye = jnp.zeros(phi.shape[:-1] + (3, 3), dtype=phi.dtype)

    def body(i, V):
        tau = (i + 0.5) * dt
        return V + dt * jnp.exp(sigma * tau)[..., None, None] * exp_so3(phi * tau)

    return jax.lax.fori_loop(0, n_steps, body, eye)


def exp_sim3(xi: jnp.ndarray):
    """sim(3) -> Sim(3). ``xi = [rho (3), phi (3), sigma (1)]``."""
    rho, phi, sigma = xi[..., :3], xi[..., 3:6], xi[..., 6]
    s = jnp.exp(sigma)
    R = exp_so3(phi)
    V = _sim3_V(phi, sigma)
    t = jnp.einsum("...ij,...j->...i", V, rho)
    return R, t, s


def log_sim3(R, t, s):
    """Sim(3) -> sim(3) by inverting V on the translation part."""
    phi = log_so3(R)
    sigma = jnp.log(s)
    V = _sim3_V(phi, sigma)
    rho = jnp.linalg.solve(V, t[..., None])[..., 0]
    return jnp.concatenate([rho, phi, sigma[..., None]], axis=-1)
