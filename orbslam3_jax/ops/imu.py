"""On-manifold IMU preintegration (Forster-style), as a `lax.scan`.

Re-designs the reference's `IMU::Preintegrated`
(`/root/reference/src/ImuTypes.cc:185-498`): instead of a mutable object
fed one sample at a time under a mutex, a whole measurement window is a
fixed-capacity padded array and preintegration is a single scan — one XLA
program per frame, vmappable over many windows (e.g. every KF pair during
IMU re-integration, `ImuTypes.cc:Reintegrate:251`).

State per window (a NamedTuple pytree):
  dR (3,3), dV (3,), dP (3,)   — preintegrated deltas
  JRg, JVg, JVa, JPg, JPa      — bias Jacobians (`ImuTypes.cc:283-322`)
  C (15,15)                    — covariance: [phi, v, p, bg, ba]
  dT                           — total time

Padding convention: measurements with dt == 0 are exact no-ops of the
update equations, so windows of varying length are padded with zeros and
need no masks.
"""

from __future__ import annotations

from typing import NamedTuple

import jax
import jax.numpy as jnp

from orbslam3_jax.ops import lie

GRAVITY_VALUE = 9.81  # ref `ImuTypes.h:GRAVITY_VALUE`
GRAVITY = jnp.asarray([0.0, 0.0, -GRAVITY_VALUE], dtype=jnp.float32)


class ImuCalib(NamedTuple):
    """Ref `IMU::Calib` (`ImuTypes.h:87`): body<-camera extrinsics + noise."""

    Rbc: jnp.ndarray  # (3,3)
    tbc: jnp.ndarray  # (3,)
    cov: jnp.ndarray  # (6,6) diag [gyro^2*freq x3, acc^2*freq x3]
    cov_walk: jnp.ndarray  # (6,6) diag random-walk

    @staticmethod
    def create(Rbc, tbc, noise_gyro, noise_acc, walk_gyro, walk_acc, freq):
        """Noise densities are continuous-time; scale by sqrt(freq) as the
        reference does (`Tracking.cc:280-292`)."""
        sf = jnp.sqrt(jnp.asarray(freq, jnp.float32))
        ng, na = noise_gyro * sf, noise_acc * sf
        wg, wa = walk_gyro / sf, walk_acc / sf
        cov = jnp.diag(jnp.asarray([ng**2] * 3 + [na**2] * 3, jnp.float32))
        cov_walk = jnp.diag(jnp.asarray([wg**2] * 3 + [wa**2] * 3, jnp.float32))
        return ImuCalib(
            jnp.asarray(Rbc, jnp.float32), jnp.asarray(tbc, jnp.float32), cov, cov_walk
        )


class Preintegrated(NamedTuple):
    dR: jnp.ndarray
    dV: jnp.ndarray
    dP: jnp.ndarray
    JRg: jnp.ndarray
    JVg: jnp.ndarray
    JVa: jnp.ndarray
    JPg: jnp.ndarray
    JPa: jnp.ndarray
    C: jnp.ndarray  # (15,15)
    dT: jnp.ndarray  # scalar
    bias_gyro: jnp.ndarray  # (3,) bias used during integration
    bias_acc: jnp.ndarray  # (3,)


def init_preintegrated(bias_gyro=None, bias_acc=None, dtype=jnp.float32) -> Preintegrated:
    z3 = jnp.zeros(3, dtype)
    return Preintegrated(
        dR=jnp.eye(3, dtype=dtype),
        dV=z3,
        dP=z3,
        JRg=jnp.zeros((3, 3), dtype),
        JVg=jnp.zeros((3, 3), dtype),
        JVa=jnp.zeros((3, 3), dtype),
        JPg=jnp.zeros((3, 3), dtype),
        JPa=jnp.zeros((3, 3), dtype),
        C=jnp.zeros((15, 15), dtype),
        dT=jnp.zeros((), dtype),
        bias_gyro=bias_gyro if bias_gyro is not None else z3,
        bias_acc=bias_acc if bias_acc is not None else z3,
    )


@jax.jit
def integrate(
    acc: jnp.ndarray,  # (N,3) accelerometer samples (already midpoint-averaged)
    gyro: jnp.ndarray,  # (N,3)
    dt: jnp.ndarray,  # (N,) step sizes; 0 = padding
    bias_gyro: jnp.ndarray,  # (3,)
    bias_acc: jnp.ndarray,  # (3,)
    calib: ImuCalib,
) -> Preintegrated:
    """Integrate one window. Mirrors `IntegrateNewMeasurement`
    (`ImuTypes.cc:266-336`): position/velocity update with the *old* dR,
    covariance propagation via the (A, B) system (Forster eq. 62-63), bias
    Jacobian recursion, then rotation update with normalization.

    Jitted: called eagerly, `lax.scan` would re-trace `step` (a fresh
    closure) and recompile on every call."""

    state0 = init_preintegrated(bias_gyro, bias_acc)

    def step(s: Preintegrated, inp):
        a_raw, w_raw, h = inp
        a = a_raw - s.bias_acc
        w = w_raw - s.bias_gyro
        h2 = h * h

        # Position & velocity with previous dR (ImuTypes.cc:276-281).
        dP = s.dP + s.dV * h + 0.5 * h2 * (s.dR @ a)
        dV = s.dV + h * (s.dR @ a)

        # A/B blocks for covariance propagation (ImuTypes.cc:283-301).
        Wa = lie.hat(a)
        dRWa = s.dR @ Wa
        A = jnp.eye(9, dtype=a.dtype)
        A = A.at[3:6, 0:3].set(-h * dRWa)
        A = A.at[6:9, 0:3].set(-0.5 * h2 * dRWa)
        A = A.at[6:9, 3:6].set(h * jnp.eye(3, dtype=a.dtype))
        B = jnp.zeros((9, 6), dtype=a.dtype)
        B = B.at[3:6, 3:6].set(h * s.dR)
        B = B.at[6:9, 3:6].set(0.5 * h2 * s.dR)

        # Bias Jacobians (ImuTypes.cc:303-309).
        JPa = s.JPa + s.JVa * h - 0.5 * h2 * s.dR
        JPg = s.JPg + s.JVg * h - 0.5 * h2 * dRWa @ s.JRg
        JVa = s.JVa - h * s.dR
        JVg = s.JVg - h * dRWa @ s.JRg

        # Rotation update (ImuTypes.cc:311-322).
        dRi = lie.exp_so3(w * h)
        Jr = lie.right_jacobian_so3(w * h)
        A = A.at[0:3, 0:3].set(dRi.T)
        B = B.at[0:3, 0:3].set(h * Jr)

        C99 = A @ s.C[:9, :9] @ A.T + B @ calib.cov @ B.T
        C = s.C.at[:9, :9].set(C99)
        C = C.at[9:, 9:].set(s.C[9:, 9:] + calib.cov_walk)
        # h == 0 (padding) must leave covariance untouched.
        C = jnp.where(h > 0, C, s.C)

        JRg = dRi.T @ s.JRg - h * Jr
        dR = lie.normalize_rotation(s.dR @ dRi)

        new = Preintegrated(
            dR=dR, dV=dV, dP=dP, JRg=JRg, JVg=JVg, JVa=JVa, JPg=JPg, JPa=JPa,
            C=C, dT=s.dT + h, bias_gyro=s.bias_gyro, bias_acc=s.bias_acc,
        )
        return new, None

    out, _ = jax.lax.scan(step, state0, (acc, gyro, dt))
    return out


# Batched integration over many windows at once.
integrate_batch = jax.vmap(integrate, in_axes=(0, 0, 0, None, None, None))


def delta_rotation(p: Preintegrated, bias_gyro: jnp.ndarray) -> jnp.ndarray:
    """First-order bias-corrected dR (`ImuTypes.cc:GetDeltaRotation:373`)."""
    dbg = bias_gyro - p.bias_gyro
    return lie.normalize_rotation(p.dR @ lie.exp_so3(p.JRg @ dbg))


def delta_velocity(p: Preintegrated, bias_gyro, bias_acc) -> jnp.ndarray:
    """`GetDeltaVelocity` (`ImuTypes.cc:381`)."""
    dbg = bias_gyro - p.bias_gyro
    dba = bias_acc - p.bias_acc
    return p.dV + p.JVg @ dbg + p.JVa @ dba


def delta_position(p: Preintegrated, bias_gyro, bias_acc) -> jnp.ndarray:
    """`GetDeltaPosition` (`ImuTypes.cc:389`)."""
    dbg = bias_gyro - p.bias_gyro
    dba = bias_acc - p.bias_acc
    return p.dP + p.JPg @ dbg + p.JPa @ dba


def merge(p1: Preintegrated, p2: Preintegrated, calib: ImuCalib) -> Preintegrated:
    """Concatenate two consecutive preintegrations (ref `MergePrevious`
    `ImuTypes.cc:328` re-integrates; here we compose in closed form using
    the standard preintegration composition rules, under p1's bias)."""
    dR = lie.normalize_rotation(p1.dR @ p2.dR)
    dV = p1.dV + p1.dR @ p2.dV
    dP = p1.dP + p1.dV * p2.dT + p1.dR @ p2.dP
    JRg = p2.dR.T @ p1.JRg + p2.JRg
    JVg = p1.JVg + p1.dR @ p2.JVg - p1.dR @ lie.hat(p2.dV) @ p1.JRg
    JVa = p1.JVa + p1.dR @ p2.JVa
    JPg = p1.JPg + p1.JVg * p2.dT + p1.dR @ p2.JPg - p1.dR @ lie.hat(p2.dP) @ p1.JRg
    JPa = p1.JPa + p1.JVa * p2.dT + p1.dR @ p2.JPa
    # Covariance: rotate p1's 9x9 through p2's frame transition (approximate
    # first-order composition; exact propagation would re-run the scan).
    F = jnp.eye(9, dtype=p1.C.dtype)
    F = F.at[0:3, 0:3].set(p2.dR.T)
    F = F.at[3:6, 0:3].set(-p1.dR @ lie.hat(p2.dV))
    F = F.at[6:9, 0:3].set(-p1.dR @ lie.hat(p2.dP))
    F = F.at[6:9, 3:6].set(p2.dT * jnp.eye(3, dtype=p1.C.dtype))
    C99 = F @ p1.C[:9, :9] @ F.T + p2.C[:9, :9]
    C = p1.C.at[:9, :9].set(C99)
    C = C.at[9:, 9:].set(p1.C[9:, 9:] + p2.C[9:, 9:])
    return Preintegrated(
        dR=dR, dV=dV, dP=dP, JRg=JRg, JVg=JVg, JVa=JVa, JPg=JPg, JPa=JPa,
        C=C, dT=p1.dT + p2.dT, bias_gyro=p1.bias_gyro, bias_acc=p1.bias_acc,
    )


def information_matrix(p: Preintegrated) -> jnp.ndarray:
    """(9,9) information of [phi, v, p] (`GetInformationMatrix`
    `ImuTypes.cc:450`). Symmetrized inverse of the covariance block."""
    C = p.C[:9, :9]
    C = 0.5 * (C + C.T) + 1e-12 * jnp.eye(9, dtype=C.dtype)
    info = jnp.linalg.inv(C)
    return 0.5 * (info + info.T)


def midpoint_samples(acc, gyro, ts, t_start, t_end):
    """Host-side helper turning raw samples covering [t_start, t_end] into
    midpoint-averaged (acc, gyro, dt) arrays, reproducing the interpolation
    at window borders of `Tracking::PreintegrateIMU`
    (`/root/reference/src/Tracking.cc:719-757`). Pure NumPy (runs in the
    input pipeline, not on device)."""
    import numpy as np

    acc = np.asarray(acc, np.float32)
    gyro = np.asarray(gyro, np.float32)
    ts = np.asarray(ts, np.float64)
    n = len(ts)
    a_out, g_out, dt_out = [], [], []
    for i in range(n - 1):
        t0, t1 = ts[i], ts[i + 1]
        if t1 <= t_start or t0 >= t_end:
            continue
        tini = max(t0, t_start)
        tend_ = min(t1, t_end)
        # Linear interpolation of the two samples to the clipped interval
        # midpointing, as in Tracking.cc:719-757.
        if t1 == t0:
            continue
        a0, a1 = acc[i], acc[i + 1]
        w0, w1 = gyro[i], gyro[i + 1]
        f0 = (tini - t0) / (t1 - t0)
        f1 = (tend_ - t0) / (t1 - t0)
        ai = a0 + f0 * (a1 - a0)
        ae = a0 + f1 * (a1 - a0)
        wi = w0 + f0 * (w1 - w0)
        we = w0 + f1 * (w1 - w0)
        a_out.append(0.5 * (ai + ae))
        g_out.append(0.5 * (wi + we))
        dt_out.append(tend_ - tini)
    # Boundary hold: integrate [last_sample, t_end] (and [t_start,
    # first_sample] if the queue starts late) with the nearest sample held
    # constant — the reference does the same when the image timestamp
    # falls beyond the last delivered IMU sample (`Tracking.cc:750-757`,
    # the `tstep = tend - t` tail path). Without this every window loses
    # the tail up to one IMU period, which biases dT by ~5% at 200/20 Hz
    # and wrecks gravity/scale initialization.
    if n >= 1:
        if ts[0] > t_start and ts[0] < t_end:
            a_out.insert(0, acc[0])
            g_out.insert(0, gyro[0])
            dt_out.insert(0, float(ts[0] - t_start))
        if ts[-1] < t_end and ts[-1] > t_start:
            a_out.append(acc[-1])
            g_out.append(gyro[-1])
            dt_out.append(float(t_end - max(ts[-1], t_start)))
    if not a_out:
        return (
            np.zeros((0, 3), np.float32),
            np.zeros((0, 3), np.float32),
            np.zeros((0,), np.float32),
        )
    return (
        np.stack(a_out).astype(np.float32),
        np.stack(g_out).astype(np.float32),
        np.asarray(dt_out, np.float32),
    )
