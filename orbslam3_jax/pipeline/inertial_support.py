"""Inertial support for the tracking/mapping pipelines.

Covers the reference's IMU plumbing outside the optimizers:

* IMU measurement queue + per-frame preintegration
  (`Tracking::GrabImuData` `Tracking.cc:621`, `PreintegrateIMU` `:639`)
* state prediction from the last keyframe (`PredictStateIMU` `:787`)
* camera<->body pose conversion (the reference hides this inside
  `Frame::SetImuPoseVelocity` and `ImuCamPose`)
* gravity/scale map alignment (`Map::ApplyScaledRotation` `Map.cc:121`)
* the IMU initialization staging driven by local mapping
  (`LocalMapping::InitializeIMU` `LocalMapping.cc:1448`).
"""

from __future__ import annotations

import os
from dataclasses import dataclass, field
from typing import List, Optional, Tuple

import jax
import jax.numpy as jnp
import numpy as np

from orbslam3_jax.atlas import store as st
from orbslam3_jax.ops import imu as imu_ops
from orbslam3_jax.ops import lie
from orbslam3_jax.optim import inertial as vi

PREINT_CAP = 64  # max IMU samples per frame gap (200 Hz IMU / 20 Hz cam ~ 10)


@dataclass
class ImuQueue:
    """Host-side measurement buffer (ref mlQueueImuData)."""

    ts: List[float] = field(default_factory=list)
    acc: List[np.ndarray] = field(default_factory=list)
    gyro: List[np.ndarray] = field(default_factory=list)

    def push(self, t: float, acc, gyro):
        self.ts.append(float(t))
        self.acc.append(np.asarray(acc, np.float32))
        self.gyro.append(np.asarray(gyro, np.float32))

    def window(self, t0: float, t1: float):
        """Samples covering [t0, t1] (with one sample of margin each side
        for border interpolation), dropping all-older entries."""
        ts = np.asarray(self.ts)
        keep_from = max(0, int(np.searchsorted(ts, t0)) - 1)
        # Trim consumed history (keep margin for the next window).
        if keep_from > 0:
            self.ts = self.ts[keep_from:]
            self.acc = self.acc[keep_from:]
            self.gyro = self.gyro[keep_from:]
        ts = np.asarray(self.ts)
        hi = int(np.searchsorted(ts, t1)) + 1
        return (
            np.asarray(self.acc[:hi], np.float32).reshape(-1, 3),
            np.asarray(self.gyro[:hi], np.float32).reshape(-1, 3),
            ts[:hi],
        )


def preintegrate_window(
    queue: ImuQueue,
    t0: float,
    t1: float,
    bias_g: np.ndarray,
    bias_a: np.ndarray,
    calib: imu_ops.ImuCalib,
) -> Optional[imu_ops.Preintegrated]:
    """`Tracking::PreintegrateIMU` for one frame gap: midpoint-interpolated
    samples padded to PREINT_CAP, integrated on device."""
    acc, gyro, ts = queue.window(t0, t1)
    if len(ts) < 2:
        return None
    a, g, dt = imu_ops.midpoint_samples(acc, gyro, ts, t0, t1)
    if len(dt) == 0:
        return None
    n = min(len(dt), PREINT_CAP)
    a_p = np.zeros((PREINT_CAP, 3), np.float32)
    g_p = np.zeros((PREINT_CAP, 3), np.float32)
    d_p = np.zeros(PREINT_CAP, np.float32)
    a_p[:n] = a[:n]
    g_p[:n] = g[:n]
    d_p[:n] = dt[:n]
    return imu_ops.integrate(
        jnp.asarray(a_p), jnp.asarray(g_p), jnp.asarray(d_p),
        jnp.asarray(bias_g), jnp.asarray(bias_a), calib,
    )


# ---------------------------------------------------------------------------
# Camera <-> body pose conversion. Tbc: body <- camera (YAML `Tbc`).
# ---------------------------------------------------------------------------


def cam_to_body(Rcw: np.ndarray, tcw: np.ndarray, Rbc: np.ndarray, tbc: np.ndarray):
    """Tcw -> (R_wb, p_wb)."""
    # T_wb = T_wc * T_cb;  T_cb = Tbc^-1 = [Rbc^T | -Rbc^T tbc]
    Rwc = Rcw.T
    twc = -Rwc @ tcw
    R_wb = Rwc @ Rbc.T
    p_wb = twc + Rwc @ (-Rbc.T @ tbc)
    return R_wb, p_wb


def body_to_cam(R_wb: np.ndarray, p_wb: np.ndarray, Rbc: np.ndarray, tbc: np.ndarray):
    """(R_wb, p_wb) -> Tcw."""
    # T_wc = T_wb * T_bc
    Rwc = R_wb @ Rbc
    twc = p_wb + R_wb @ tbc
    Rcw = Rwc.T
    tcw = -Rcw @ twc
    return Rcw, tcw


def predict_state(
    R_wb, p_wb, v_w, bias_g, bias_a, pre: imu_ops.Preintegrated
) -> Tuple[np.ndarray, np.ndarray, np.ndarray]:
    """`Tracking::PredictStateIMU` (`Tracking.cc:787`): forward-propagate
    the last state through a preintegrated window."""
    dT = float(pre.dT)
    g = np.asarray(imu_ops.GRAVITY)
    dR = np.asarray(imu_ops.delta_rotation(pre, jnp.asarray(bias_g)))
    dV = np.asarray(imu_ops.delta_velocity(pre, jnp.asarray(bias_g), jnp.asarray(bias_a)))
    dP = np.asarray(imu_ops.delta_position(pre, jnp.asarray(bias_g), jnp.asarray(bias_a)))
    R1 = R_wb @ dR
    v1 = v_w + g * dT + R_wb @ dV
    p1 = p_wb + v_w * dT + 0.5 * g * dT * dT + R_wb @ dP
    return R1, v1, p1


# ---------------------------------------------------------------------------
# Gravity/scale alignment of a whole map
# ---------------------------------------------------------------------------


def apply_scaled_rotation(state: st.MapState, Rwg: jnp.ndarray, scale: float) -> st.MapState:
    """`Map::ApplyScaledRotation`: re-express the map so gravity is -z and
    the scale is metric. World transform: x' = s * Rwg^T x; poses:
    Rcw' = Rcw Rwg, tcw' = s * tcw; velocities v' = s * Rwg^T v.
    Projections are invariant (depths scale uniformly)."""
    Rgw = Rwg.T
    return state._replace(
        kf_R=state.kf_R @ Rwg[None],
        kf_t=state.kf_t * scale,
        kf_vel=scale * jnp.einsum("ij,kj->ki", Rgw, state.kf_vel),
        mp_pos=scale * jnp.einsum("ij,pj->pi", Rgw, state.mp_pos),
        # The reference re-derives these via `UpdateNormalAndDepth()` after
        # the transform (`Map.cc` ApplyScaledRotation callers): the
        # scale-invariance distance band is metric, so it scales with the
        # map; viewing normals rotate. Leaving them stale makes every
        # distance-compatibility gate in the local-map search fail after a
        # non-unit rescale.
        mp_normal=jnp.einsum("ij,pj->pi", Rgw, state.mp_normal),
        mp_min_dist=state.mp_min_dist * scale,
        mp_max_dist=state.mp_max_dist * scale,
    )


# ---------------------------------------------------------------------------
# IMU initialization staging (LocalMapping::InitializeIMU)
# ---------------------------------------------------------------------------


class ImuInitializer:
    """Runs the reference's staged inertial initialization:

    * first call (mTinit ~ 2s of KFs): inertial-only MAP with strong
      priors -> gravity + scale + biases; rescale/rotate the map; flag
      IMU_BA1 (`LocalMapping.cc:1448-1590`)
    * VIBA1 at >5s, VIBA2 at >15s (`:232-258`): full VI-BA with
      decreasing bias priors.
    """

    def __init__(self, calib: imu_ops.ImuCalib, mono: bool = True):
        self.calib = calib
        self.mono = mono
        self.initialized = False
        self.viba1_done = False
        self.viba2_done = False
        self.first_ts: Optional[float] = None
        # (Rwg, scale) of the most recent apply_scaled_rotation, for the
        # caller to forward to Tracker.apply_map_transform.
        self.applied_transform: Optional[Tuple[np.ndarray, float]] = None

    def kf_chain_edges(self, store: st.MapStore, preints: dict):
        """Build ImuEdge batch from consecutive-KF preintegrations
        (preints: dict kf_slot -> Preintegrated from its prev KF)."""
        s = store.state
        prev = np.asarray(s.kf_prev)[: store.n_kf]
        pairs = [(int(prev[k]), k) for k in range(store.n_kf) if prev[k] >= 0 and k in preints]
        if not pairs:
            return None
        pre_list = [preints[j] for _, j in pairs]
        batch = jax.tree_util.tree_map(lambda *xs: jnp.stack(xs), *pre_list)
        return vi.make_imu_edges(
            jnp.asarray([i for i, _ in pairs], jnp.int32),
            jnp.asarray([j for _, j in pairs], jnp.int32),
            batch,
            jnp.ones(len(pairs), bool),
        )

    def try_initialize(
        self, store: st.MapStore, preints: dict, Rbc: np.ndarray, tbc: np.ndarray,
        min_kfs: int = 10, min_time: float = 2.0,
    ) -> bool:
        """Inertial-only init + map alignment. Returns True on success.

        Gates mirror the reference: enough keyframes AND >=`min_time`
        seconds of baseline (`LocalMapping.cc:1459-1470`, mTinit check) —
        scale is unobservable from a short, gentle window."""
        if store.n_kf < min_kfs:
            return False
        span = store.kf_ts[store.n_kf - 1] - store.kf_ts[0]
        if span < min_time:
            return False
        edges = self.kf_chain_edges(store, preints)
        if edges is None or edges.i.shape[0] < min_kfs - 1:
            return False
        s = store.state
        # Body poses of all KFs (single device->host transfer).
        K = store.n_kf
        kf_R_np = np.asarray(s.kf_R)
        kf_t_np = np.asarray(s.kf_t)
        R_wb = np.zeros((K, 3, 3), np.float32)
        p_wb = np.zeros((K, 3), np.float32)
        for k in range(K):
            R_wb[k], p_wb[k] = cam_to_body(kf_R_np[k], kf_t_np[k], Rbc, tbc)
        pad = s.Kmax
        Rp = np.tile(np.eye(3, dtype=np.float32), (pad, 1, 1))
        pp = np.zeros((pad, 3), np.float32)
        Rp[:K] = R_wb
        pp[:K] = p_wb
        valid = np.zeros(pad, bool)
        valid[:K] = np.asarray(s.kf_valid)[:K]

        if os.environ.get("DEBUG_INIT_DUMP"):
            np.savez(
                os.environ["DEBUG_INIT_DUMP"],
                R_wb=R_wb, p_wb=p_wb, K=K,
                ei=np.asarray(edges.i), ej=np.asarray(edges.j),
                dR=np.asarray(edges.dR), dV=np.asarray(edges.dV),
                dP=np.asarray(edges.dP), dT=np.asarray(edges.dT),
                info=np.asarray(edges.info), valid=np.asarray(edges.valid),
                kf_ts=np.asarray(store.kf_ts[: store.n_kf]),
            )
        res = vi.inertial_only_optimization(
            jnp.asarray(Rp), jnp.asarray(pp), jnp.asarray(valid), edges,
            fix_scale=not self.mono, iters=30,
        )
        scale = float(res.scale)
        if os.environ.get("DEBUG_INIT"):
            gdir = np.asarray(res.Rwg) @ np.array([0.0, 0.0, -1.0])
            print(f"  [init] scale={scale:.4f} gdir={gdir.round(3)} "
                  f"bg={np.asarray(res.bg).round(4)} ba={np.asarray(res.ba).round(3)}",
                  flush=True)
        if scale < 0.1 or not np.isfinite(scale):  # sanity (`LocalMapping.cc:1549`)
            return False
        # Align: x' = s * Rwg^T x  (gravity to -z, metric scale).
        store.state = apply_scaled_rotation(store.state, jnp.asarray(res.Rwg), scale)
        # Callers must propagate this to the tracker (last frame, motion
        # model, relative trajectory) — `Tracking::UpdateFrameIMU`.
        self.applied_transform = (np.asarray(res.Rwg), scale)
        # Write velocities + biases for existing KFs.
        vel = scale * (np.asarray(res.Rwg).T @ np.asarray(res.vel)[:K].T).T
        bg = np.asarray(res.bg)
        ba = np.asarray(res.ba)
        ss = store.state
        ss = ss._replace(
            kf_vel=ss.kf_vel.at[:K].set(jnp.asarray(vel)),
            kf_bias_g=ss.kf_bias_g.at[:K].set(jnp.asarray(np.tile(bg, (K, 1)))),
            kf_bias_a=ss.kf_bias_a.at[:K].set(jnp.asarray(np.tile(ba, (K, 1)))),
        )
        store.state = ss
        store.bump()
        self.initialized = True
        return True

    def refine_scale(
        self, store: st.MapStore, preints: dict, Rbc: np.ndarray, tbc: np.ndarray,
        tol: float = 0.01,
    ) -> bool:
        """`LocalMapping::ScaleRefinement` (`LocalMapping.cc:1631`): re-run
        the inertial-only MAP on the (already metric) map; apply the
        correction if the residual scale drifted by > tol."""
        if not self.initialized:
            return False
        was_init = self.initialized
        self.initialized = False  # reuse the init path sans gates
        ok = self.try_initialize(store, preints, Rbc, tbc, min_kfs=3, min_time=0.0)
        self.initialized = was_init or ok
        return ok
