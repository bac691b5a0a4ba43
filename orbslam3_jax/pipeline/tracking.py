"""Tracking pipeline: the per-frame frontend state machine.

Re-design of `/root/reference/src/Tracking.cc` (4,010 LoC). The state
machine (NO_IMAGES_YET -> NOT_INITIALIZED -> OK <-> RECENTLY_LOST -> LOST,
`Tracking.h:101-109`) stays host-side Python; every arrow's heavy work is
a jitted device program:

* `GrabImageMonocular` (`Tracking.cc:507`)  -> `ops.features.extract`
* `MonocularInitialization` (`:1724`)       -> windowed match + batched
  H/F RANSAC (`ops.ransac.reconstruct_two_views`)
* `TrackWithMotionModel` (`:2331`)          -> projection-masked Hamming
  matmul + `optim.pose_only`
* `TrackReferenceKeyFrame` (`:2171`)        -> full Hamming matmul (BoW
  node pruning dropped by design, see ops/bow.py) + `optim.pose_only`
* `TrackLocalMap` (`:2436`)                 -> frustum/scale kernels over
  the whole point array + projection match + `optim.pose_only`
* `NeedNewKeyFrame`/`CreateNewKeyFrame` (`:2577,2716`) -> host policy +
  SoA insert

The map is `atlas.store.MapState`; local-mapping runs synchronously after
KF insertion in round 1 (async executor later).
"""

from __future__ import annotations

import enum
import functools
import os
from typing import Optional, Tuple

import jax
import jax.numpy as jnp
import numpy as np

from orbslam3_jax.atlas import store as st
from orbslam3_jax.ops import cameras as cam
from orbslam3_jax.ops import features as feat
from orbslam3_jax.ops import lie, matching, ransac
from orbslam3_jax.optim import pose_only
from orbslam3_jax.pipeline import frame as fr
from orbslam3_jax.utils import timing
from orbslam3_jax.utils.fetch import fetch


class TrackState(enum.Enum):
    NO_IMAGES_YET = 0
    NOT_INITIALIZED = 1
    OK = 2
    RECENTLY_LOST = 3
    LOST = 4


# ---------------------------------------------------------------------------
# Jitted steps
# ---------------------------------------------------------------------------


@functools.partial(jax.jit, static_argnames=())
def _match_for_initialization(f_ref: feat.Features, f_cur: feat.Features):
    """`ORBmatcher::SearchForInitialization` (`ORBmatcher.cc:838`):
    window radius 100px, ratio 0.9, rotation consistency."""
    mask = matching.window_mask(f_ref.uv, f_cur.uv, 100.0)
    m = matching.match_nn(
        f_ref.desc, f_cur.desc, f_ref.valid, f_cur.valid,
        max_dist=matching.TH_LOW, ratio=0.9, cross_check=True, extra_mask=mask,
    )
    return matching.rotation_consistency(f_ref.angle, f_cur.angle, m)


@functools.partial(jax.jit, static_argnames=("model",))
def _track_last_frame(
    model: cam.CameraModel,
    params: jnp.ndarray,
    R_pred: jnp.ndarray,
    t_pred: jnp.ndarray,
    last_uv: jnp.ndarray,  # unused (kept for octave-aware radius later)
    last_mp: jnp.ndarray,  # (Nf,) mp ids of last frame
    mp_pos: jnp.ndarray,
    mp_valid: jnp.ndarray,
    mp_desc: jnp.ndarray,
    f_cur: feat.Features,
    radius_px: float,
    scale_factors: jnp.ndarray,  # (L,)
    last_octave: jnp.ndarray,  # (Nf,)
):
    """`TrackWithMotionModel` match step (`ORBmatcher::SearchByProjection`
    last-frame overload, `ORBmatcher.cc:2244`): project last frame's map
    points with the predicted pose; octave-gated window search."""
    ok = last_mp >= 0
    ids = jnp.clip(last_mp, 0)
    Xw = mp_pos[ids]
    valid_q = ok & mp_valid[ids]
    Xc = lie.se3_apply(R_pred, t_pred, Xw)
    uv = cam.project(model, params, Xc)
    valid_q &= Xc[..., 2] > 0.1
    r = radius_px * scale_factors[jnp.clip(last_octave, 0, scale_factors.shape[0] - 1)]
    m = matching.search_by_projection(
        mp_desc[ids], uv, valid_q, f_cur.desc, f_cur.uv, f_cur.valid,
        radius=r,
        octave_kp=f_cur.octave,
        octave_lo=jnp.maximum(last_octave - 1, 0),
        octave_hi=last_octave + 1,
        max_dist=matching.TH_HIGH, ratio=0.9,
    )
    m = matching.assign_unique(m, f_cur.desc.shape[0])
    # Feature f of current frame -> map point id (scatter query->kp).
    assoc = jnp.full((f_cur.desc.shape[0],), -1, jnp.int32)
    q_ids = jnp.where(m.valid, ids, 0)
    assoc = assoc.at[jnp.clip(m.idx, 0)].set(
        jnp.where(m.valid, q_ids, assoc[jnp.clip(m.idx, 0)])
    )
    return assoc, jnp.sum(m.valid.astype(jnp.int32))


@functools.partial(jax.jit, static_argnames=())
def _track_reference_kf(
    kf_desc: jnp.ndarray,  # (Nf,32)
    kf_feat_valid: jnp.ndarray,
    kf_mp: jnp.ndarray,  # (Nf,)
    mp_valid: jnp.ndarray,
    f_cur: feat.Features,
):
    """`TrackReferenceKeyFrame` match (`Tracking.cc:2171` ->
    `ORBmatcher::SearchByBoW` `ORBmatcher.cc:323`): full Hamming matrix
    with ratio 0.7 (the reference's mfNNratio for this matcher)."""
    has_mp = (kf_mp >= 0) & kf_feat_valid & mp_valid[jnp.clip(kf_mp, 0)]
    m = matching.match_nn(
        kf_desc, f_cur.desc, has_mp, f_cur.valid,
        max_dist=matching.TH_LOW, ratio=0.7, cross_check=True,
    )
    m = matching.assign_unique(m, f_cur.desc.shape[0])
    assoc = jnp.full((f_cur.desc.shape[0],), -1, jnp.int32)
    src = jnp.where(m.valid, jnp.clip(kf_mp, 0), 0)
    assoc = assoc.at[jnp.clip(m.idx, 0)].set(
        jnp.where(m.valid, src, assoc[jnp.clip(m.idx, 0)])
    )
    return assoc, jnp.sum(m.valid.astype(jnp.int32))


@functools.partial(jax.jit, static_argnames=("model", "n_levels"))
def _track_local_map_match(
    model: cam.CameraModel,
    params: jnp.ndarray,
    R: jnp.ndarray,
    t: jnp.ndarray,
    state: st.MapState,
    local_mask: jnp.ndarray,  # (P,) bool — local map points
    f_cur: feat.Features,
    cur_assoc: jnp.ndarray,  # (Nf,) current associations (kept fixed)
    img_wh: jnp.ndarray,
    n_levels: int = 8,
):
    """`SearchLocalPoints` + projection match (`Tracking.cc:2848`,
    `ORBmatcher.cc:59`): frustum-test every local point, match the
    not-yet-associated ones into free keypoints."""
    uv, visible, lvl, vcos = fr.frustum_and_scale(
        model, params, R, t,
        state.mp_pos, state.mp_valid & local_mask, state.mp_normal,
        state.mp_min_dist, state.mp_max_dist, img_wh, n_levels=n_levels,
    )
    # Skip points already matched in this frame.
    already = jnp.zeros((state.Pmax,), bool).at[jnp.clip(cur_assoc, 0)].set(cur_assoc >= 0)
    query_valid = visible & ~already
    r = fr.search_radius(vcos, lvl)
    kp_free = f_cur.valid & (cur_assoc < 0)
    m = matching.search_by_projection(
        state.mp_desc, uv, query_valid, f_cur.desc, f_cur.uv, kp_free,
        radius=r, octave_kp=f_cur.octave,
        octave_lo=jnp.maximum(lvl - 1, 0), octave_hi=lvl + 1,
        max_dist=matching.TH_HIGH, ratio=0.8,
    )
    m = matching.assign_unique(m, f_cur.desc.shape[0])
    assoc = cur_assoc
    src = jnp.where(m.valid, jnp.arange(state.Pmax, dtype=jnp.int32), 0)
    assoc = assoc.at[jnp.clip(m.idx, 0)].set(
        jnp.where(m.valid, src, assoc[jnp.clip(m.idx, 0)])
    )
    return assoc, visible


@functools.partial(jax.jit, static_argnames=("model", "base_radius", "max_dist", "n_levels"))
def _projection_rescue_match(
    model: cam.CameraModel,
    params: jnp.ndarray,
    R: jnp.ndarray,
    t: jnp.ndarray,
    state: st.MapState,
    point_mask: jnp.ndarray,  # (P,) bool — candidate KF's map points
    f_cur: feat.Features,
    cur_assoc: jnp.ndarray,  # (Nf,) associations already found (kept)
    img_wh: jnp.ndarray,
    base_radius: float,
    max_dist: float,
    n_levels: int = 8,
):
    """Guided-projection second chance of relocalization
    (`Tracking.cc:3376-3424`, `ORBmatcher::SearchByProjection(Frame,
    KeyFrame*, set, th, ORBdist)` `ORBmatcher.cc:2520`): project the
    candidate keyframe's map points at the coarse pose, match into the
    frame's still-free keypoints inside a th*scale window with a plain
    Hamming budget (no ratio test), and merge into the associations."""
    uv, visible, lvl, vcos = fr.frustum_and_scale(
        model, params, R, t,
        state.mp_pos, state.mp_valid & point_mask, state.mp_normal,
        state.mp_min_dist, state.mp_max_dist, img_wh, n_levels=n_levels,
    )
    already = jnp.zeros((state.Pmax,), bool).at[jnp.clip(cur_assoc, 0)].set(
        cur_assoc >= 0
    )
    query_valid = visible & ~already
    r = base_radius * jnp.asarray(1.2) ** lvl.astype(jnp.float32)
    kp_free = f_cur.valid & (cur_assoc < 0)
    m = matching.search_by_projection(
        state.mp_desc, uv, query_valid, f_cur.desc, f_cur.uv, kp_free,
        radius=r, octave_kp=f_cur.octave,
        octave_lo=jnp.maximum(lvl - 1, 0), octave_hi=lvl + 1,
        max_dist=max_dist, ratio=1.0,
    )
    m = matching.assign_unique(m, f_cur.desc.shape[0])
    assoc = cur_assoc
    src = jnp.where(m.valid, jnp.arange(state.Pmax, dtype=jnp.int32), 0)
    assoc = assoc.at[jnp.clip(m.idx, 0)].set(
        jnp.where(m.valid, src, assoc[jnp.clip(m.idx, 0)])
    )
    return assoc


@functools.partial(jax.jit, static_argnames=())
def _local_point_mask(state: st.MapState, kf_ids: jnp.ndarray) -> jnp.ndarray:
    """(P,) bool — points observed by any KF in kf_ids (padded with -1)."""
    ok_kf = kf_ids >= 0
    mp = state.kf_mp[jnp.clip(kf_ids, 0)]  # (W,Nf)
    ok = (mp >= 0) & ok_kf[:, None]
    mask = jnp.zeros((state.Pmax,), bool).at[jnp.clip(mp, 0)].max(ok)
    return mask & state.mp_valid


@functools.partial(jax.jit, static_argnames=("model",))
def _pose_opt_from_assoc(
    model, params, R0, t0, assoc, f_cur: feat.Features, mp_pos, mp_valid, sigma2_table, ur=None, bf=0.0,
    rig=None,
):
    ok = (assoc >= 0) & f_cur.valid & mp_valid[jnp.clip(assoc, 0)]
    Xw = mp_pos[jnp.clip(assoc, 0)]
    s2 = sigma2_table[jnp.clip(f_cur.octave, 0, sigma2_table.shape[0] - 1)]
    obs = pose_only.PoseObs(
        Xw=Xw,
        uv=f_cur.uv,
        ur=ur if ur is not None else jnp.full(assoc.shape, -1.0),
        sigma2=s2,
        valid=ok,
    )
    if rig is None:
        return pose_only.optimize_pose(model, params, R0, t0, obs, bf=bf)
    # Two-camera rig: add right-camera (ToBody) rows for features whose
    # lapping-area stereo match exists (ref `EdgeSE3ProjectXYZOnlyPose-
    # ToBody`, built from the fisheye frame's right matches).
    params_r, R_rl, t_rl, uv_r, sig2_r, has_r = rig
    obs_r = pose_only.PoseObs(
        Xw=Xw, uv=uv_r, ur=jnp.full(assoc.shape, -1.0),
        sigma2=sig2_r, valid=ok & has_r,
    )
    return pose_only.optimize_pose(
        model, params, R0, t0, obs, bf=bf,
        obs_r=obs_r, params_r=params_r, R_rl=R_rl, t_rl=t_rl,
    )


@functools.partial(jax.jit, static_argnames=("model",))
def _pose_inertial_from_assoc(
    model, params, assoc, f_cur: feat.Features, mp_pos, mp_valid,
    sigma2_table, Rbc, tbc, kf_R, kf_t, kf_vel, kf_bg, kf_ba, pre,
    R0, t0, v0, ur=None, bf=0.0,
):
    """Visual-inertial refinement of the frame state
    (`PoseInertialOptimizationLastKeyFrame`, `Optimizer.cc:3752`): same
    observation set as `_pose_opt_from_assoc` plus the preintegration
    edge to the last keyframe (anchor fixed)."""
    from orbslam3_jax.optim import pose_inertial

    ok = (assoc >= 0) & f_cur.valid & mp_valid[jnp.clip(assoc, 0)]
    s2 = sigma2_table[jnp.clip(f_cur.octave, 0, sigma2_table.shape[0] - 1)]
    obs = pose_only.PoseObs(
        Xw=mp_pos[jnp.clip(assoc, 0)],
        uv=f_cur.uv,
        ur=ur if ur is not None else jnp.full(assoc.shape, -1.0),
        sigma2=s2,
        valid=ok,
    )
    # Anchor KF camera pose -> body frame (Twb = Twc * Tcb).
    Rwc = jnp.swapaxes(kf_R, -1, -2)
    R_kf = Rwc @ jnp.swapaxes(Rbc, -1, -2)
    p_kf = -Rwc @ kf_t + Rwc @ (-jnp.swapaxes(Rbc, -1, -2) @ tbc)
    # Current visual pose -> body-frame initial guess.
    Rwc0 = jnp.swapaxes(R0, -1, -2)
    R0b = Rwc0 @ jnp.swapaxes(Rbc, -1, -2)
    p0b = -Rwc0 @ t0 + Rwc0 @ (-jnp.swapaxes(Rbc, -1, -2) @ tbc)
    return pose_inertial.optimize_pose_inertial(
        model, params, obs, Rbc, tbc,
        R_kf, p_kf, kf_vel, kf_bg, kf_ba, pre, R0b, p0b, v0, bf=bf,
    )


@jax.jit
def compute_obs_count(state: st.MapState) -> jnp.ndarray:
    """(Pmax,) int32 — observation count per map point over all valid
    keyframes (the quantity behind `KeyFrame::TrackedMapPoints` /
    `MapPoint::Observations`). One (Kmax*Nf)-row scatter: recompute only
    when the map version changes, not per frame."""
    all_mp = state.kf_mp
    obs_ok = (all_mp >= 0) & state.kf_feat_valid & state.kf_valid[:, None]
    return jnp.zeros((state.Pmax,), jnp.int32).at[
        jnp.clip(all_mp, 0)
    ].add(obs_ok.astype(jnp.int32))


@functools.partial(jax.jit, static_argnames=("model", "n_levels"))
def _track_step(
    model: cam.CameraModel,
    params: jnp.ndarray,
    state: st.MapState,
    f_cur: feat.Features,
    R_pred, t_pred, have_pred,          # stage 1a inputs (bool device)
    last_mp, last_octave,               # last frame's associations
    ref_kf,                             # stage 1b anchor (int device)
    R_last, t_last,                     # fallback initial pose
    scale_table, sigma2_table, img_wh,
    min_obs,                            # NeedNewKeyFrame nMinObs (device)
    ur=None, bf=0.0, n_levels: int = 8,
    rig=None,  # (params_r, R_rl, t_rl, uv_r, sig2_r, has_r) two-cam rows
    obs_count=None,  # (Pmax,) cached per-point observation counts
):
    """The whole two-stage visual tracking of one frame as ONE device
    program (`Tracking::Track` stages `Tracking.cc:2331,2171,2436`):
    motion-model match + pose solve, reference-KF fallback, device-side
    local-keyframe selection (`UpdateLocalKeyFrames` `:3042`), local-map
    match + final pose solve, found/visible bookkeeping.

    Host round-trips stall the pipeline (every sync waits for the device
    to drain), so all accept/reject
    gates are computed here and returned in one small bundle; the host
    makes its state-machine decision after a single fetch.

    `obs_count`: per-point observation counts, recomputed by the caller
    only when the map changed (`Tracker._obs_count_cached` keyed on
    `store.change_index`) — the (Kmax*Nf)-row scatter it needs costs more
    than the rest of the frame when recomputed per frame. The reference
    reads live observation counts the same way: they only move when
    LocalMapping runs (`KeyFrame::TrackedMapPoints`, `Tracking.cc:2612`).
    """
    ur_arr = ur if ur is not None else jnp.full(f_cur.uv.shape[0], -1.0)

    # --- Stage 1a: motion model -----------------------------------------
    assoc_a, n_a = _track_last_frame(
        model, params, R_pred, t_pred, None, last_mp,
        state.mp_pos, state.mp_valid, state.mp_desc, f_cur,
        15.0, scale_table, last_octave,
    )
    res_a = _pose_opt_from_assoc(
        model, params, R_pred, t_pred, assoc_a, f_cur,
        state.mp_pos, state.mp_valid, sigma2_table, ur=ur_arr, bf=bf, rig=rig,
    )
    ok_a = have_pred & (n_a >= 20) & (res_a.n_inliers >= 10)

    # --- Stage 1b: reference keyframe fallback --------------------------
    # lax.cond, not speculative execution: when the motion model already
    # succeeded (the common case), the fallback's BoW-free match + third
    # pose solve must not burn frame budget — the reference only calls
    # TrackReferenceKeyFrame when TrackWithMotionModel failed
    # (`Tracking.cc:1295-1305`).
    rk = jnp.clip(ref_kf, 0)
    Nf_cur = f_cur.uv.shape[0]

    def _run_ref_fallback():
        assoc_b, n_b = _track_reference_kf(
            state.kf_desc[rk], state.kf_feat_valid[rk],
            state.kf_mp[rk], state.mp_valid, f_cur,
        )
        res_b = _pose_opt_from_assoc(
            model, params, R_last, t_last, assoc_b, f_cur,
            state.mp_pos, state.mp_valid, sigma2_table, ur=ur_arr, bf=bf,
            rig=rig,
        )
        ok_b = (ref_kf >= 0) & (n_b >= 15) & (res_b.n_inliers >= 10)
        return assoc_b, n_b, res_b.R, res_b.t, res_b.inlier, ok_b

    def _skip_ref_fallback():
        return (
            jnp.full(Nf_cur, -1, jnp.int32), jnp.asarray(0, jnp.int32),
            R_last, t_last, jnp.zeros(Nf_cur, bool), jnp.asarray(False),
        )

    assoc_b, n_b, R_b, t_b, inl_b, ok_b = jax.lax.cond(
        ok_a, _skip_ref_fallback, _run_ref_fallback
    )

    use_a = ok_a
    R1 = jnp.where(use_a, res_a.R, R_b)
    t1 = jnp.where(use_a, res_a.t, t_b)
    assoc1 = jnp.where(
        use_a,
        jnp.where(res_a.inlier, assoc_a, -1),
        jnp.where(inl_b, assoc_b, -1),
    )
    ok1 = ok_a | ok_b

    # --- Local keyframe selection (device top-k) ------------------------
    ptset = jnp.zeros((state.Pmax,), bool).at[jnp.clip(assoc1, 0)].set(assoc1 >= 0)
    shares = (
        jnp.sum(ptset[jnp.clip(state.kf_mp, 0)] & (state.kf_mp >= 0), axis=1)
        * state.kf_valid
    )
    top_shares, top_kfs = jax.lax.top_k(shares, 16)
    top_kfs = jnp.where(top_shares > 0, top_kfs, -1).astype(jnp.int32)
    local_pad = jnp.where(
        jnp.any(top_kfs >= 0), top_kfs,
        jnp.full_like(top_kfs, -1).at[0].set(jnp.clip(ref_kf, 0)),
    )

    # --- Stage 2: local map ---------------------------------------------
    local_mask = _local_point_mask(state, local_pad)
    assoc2, visible = _track_local_map_match(
        model, params, R1, t1, state, local_mask, f_cur, assoc1, img_wh,
        n_levels=n_levels,
    )
    res2 = _pose_opt_from_assoc(
        model, params, R1, t1, assoc2, f_cur,
        state.mp_pos, state.mp_valid, sigma2_table, ur=ur_arr, bf=bf, rig=rig,
    )
    assoc_final = jnp.where(res2.inlier, assoc2, -1)

    # --- found/visible stats (stay on device) ---------------------------
    mp_found, mp_visible = st.bump_found_visible_arrays(
        state, visible, assoc_final
    )

    # Reference-KF tracked count for NeedNewKeyFrame: the reference
    # counts only map points with >= nMinObs observations
    # (`KeyFrame::TrackedMapPoints`, called at `Tracking.cc:2612`).
    new_ref = jnp.where(local_pad[0] >= 0, local_pad[0], jnp.clip(ref_kf, 0))
    if obs_count is None:
        obs_count = compute_obs_count(state)
    row = state.kf_mp[new_ref]
    row_ok = (row >= 0) & state.kf_feat_valid[new_ref]
    ref_matches = jnp.sum(row_ok & (obs_count[jnp.clip(row, 0)] >= min_obs))

    bundle = dict(
        ok1=ok1, used_a=use_a, n_a=n_a, n_b=n_b,
        R=res2.R, t=res2.t, assoc=assoc_final,
        n_inl=res2.n_inliers, top_kfs=top_kfs, ref_matches=ref_matches,
    )
    return bundle, (mp_found, mp_visible)


@functools.partial(jax.jit, static_argnames=("model",))
def _pose_inertial_lf_from_assoc(
    model, params, assoc, f_cur: feat.Features, mp_pos, mp_valid,
    sigma2_table, Rbc, tbc, R_lf, p_lf, v_lf, bg_lf, ba_lf, H_prior,
    pre, R0, t0, v0, ur=None, bf=0.0,
):
    """`PoseInertialOptimizationLastFrame` (`Optimizer.cc:8068`): the
    anchor is the previous FRAME's body state with its marginalization
    prior; both frames are free (30 dof) and the last frame is
    marginalized out afterwards to produce the next prior."""
    from orbslam3_jax.optim import pose_inertial

    ok = (assoc >= 0) & f_cur.valid & mp_valid[jnp.clip(assoc, 0)]
    s2 = sigma2_table[jnp.clip(f_cur.octave, 0, sigma2_table.shape[0] - 1)]
    obs = pose_only.PoseObs(
        Xw=mp_pos[jnp.clip(assoc, 0)],
        uv=f_cur.uv,
        ur=ur if ur is not None else jnp.full(assoc.shape, -1.0),
        sigma2=s2,
        valid=ok,
    )
    Rwc0 = jnp.swapaxes(R0, -1, -2)
    R0b = Rwc0 @ jnp.swapaxes(Rbc, -1, -2)
    p0b = -Rwc0 @ t0 + Rwc0 @ (-jnp.swapaxes(Rbc, -1, -2) @ tbc)
    return pose_inertial.optimize_pose_inertial_last_frame(
        model, params, obs, Rbc, tbc,
        R_lf, p_lf, v_lf, bg_lf, ba_lf, H_prior, pre, R0b, p0b, v0, bf=bf,
    )


# ---------------------------------------------------------------------------
# Host tracker
# ---------------------------------------------------------------------------


class Tracker:
    """Host driver of the tracking state machine (mono; stereo/RGB-D/IMU
    wired in system.py as they come online)."""

    def __init__(
        self,
        model: cam.CameraModel,
        params: jnp.ndarray,
        img_wh: Tuple[int, int],
        store: st.MapStore,
        orb_params: feat.OrbParams = feat.OrbParams(),
        bf: float = 0.0,
        imu_calib=None,  # ops.imu.ImuCalib for inertial modes
        camera2=None,  # (params2, T_lr 4x4, lapping1, lapping2) stereo-fisheye
        fps: float = 20.0,  # camera rate (ref Camera.fps -> mMaxFrames)
    ):
        self.model = model
        self.params = params
        # Two-camera rig (ref `Frame.cc:1187` two-camera ctor): right
        # camera intrinsics + right<-left extrinsics from Tlr.
        self.camera2 = None
        if camera2 is not None:
            params2, T_lr, lap1, lap2 = camera2
            T_lr = np.asarray(T_lr, np.float64)
            R_rl = T_lr[:3, :3].T
            t_rl = -R_rl @ T_lr[:3, 3]
            W = float(img_wh[0])
            self.camera2 = dict(
                params=jnp.asarray(params2, jnp.float32),
                R_rl=jnp.asarray(R_rl, jnp.float32),
                t_rl=jnp.asarray(t_rl, jnp.float32),
                lap1=tuple(lap1) if lap1 else (0.0, W - 1.0),
                lap2=tuple(lap2) if lap2 else (0.0, W - 1.0),
                baseline=float(np.linalg.norm(T_lr[:3, 3])),
            )
        self.img_wh = np.asarray(img_wh, np.float32)
        self.store = store
        self.orb = orb_params
        self.bf = bf
        self.th_depth = 35.0  # ref ThDepth (close/far stereo gate)
        self.state = TrackState.NO_IMAGES_YET
        self.sigma2_table = jnp.asarray(feat.sigma2(orb_params))
        self.scale_table = jnp.asarray(feat.scale_factors(orb_params))

        self.last_frame: Optional[fr.FrameData] = None
        self.init_frame: Optional[fr.FrameData] = None
        self.ref_kf: int = -1  # covisibility reference (ref mpReferenceKF)
        self.last_kf_id: int = -1  # temporal chain anchor (ref mpLastKeyFrame)
        # Marginalization prior of the last frame's 15-dof body state
        # (ref Frame::mpcpi, `ConstraintPoseImu`): (R,p,v,bg,ba,H15).
        # Valid only while the map is unchanged since it was built
        # (ref mbMapUpdated switches back to the LastKeyFrame variant).
        self.frame_prior = None
        self.prior_map_version: int = -1
        self.prior_ts: float = -1.0  # timestamp of the frame the prior belongs to
        self.velocity: Optional[Tuple[np.ndarray, np.ndarray]] = None  # (R, t) of Tcl
        self._ref_matches_cache: Optional[int] = None  # from _track_step bundle
        # Localization-only mode (ref `System::ActivateLocalizationMode`,
        # `System.h:106-108` -> `Tracking::InformOnlyTracking`): track
        # against the frozen map, never insert keyframes.
        self.only_tracking = False
        # Timestamp-anomaly hook set by System (ref `Tracking::Track`
        # `Tracking.cc:987-1031`): called with "reorder" | "gap_uninit" |
        # "gap_init" BEFORE the frame is tracked.
        self.anomaly_cb = None
        self.frames_since_kf = 0
        self.frame_id = 0
        self.lost_count = 0
        self.trajectory = []  # (ts, Rwc, twc)
        self.new_kf_callback = None  # set by System: runs local mapping
        self.match_inliers = 0
        # --- NeedNewKeyFrame policy state (ref `Tracking.cc:2577-2715`) --
        self.max_frames = max(1, int(round(fps)))  # ref mMaxFrames = fps
        self.min_frames = 0  # ref mMinFrames
        self.time_recently_lost = 5.0  # ref time_recently_lost (Tracking.cc:62)
        self.time_lost: Optional[float] = None  # ref mTimeStampLost
        self.last_reloc_frame_id = -(10**9)  # ref mnLastRelocFrameId
        self.last_kf_frame_id = -(10**9)  # ref mnLastKeyFrameId
        self.is_stereo_like = False  # stereo/RGB-D (set by System/entry)
        # Mapper-idle signal for c1b and the insert-vs-interrupt decision
        # (ref `LocalMapping::AcceptKeyFrames` / `InterruptBA`). The sync
        # mapper is always idle; the async executor wires these.
        self.mapper_idle_query = None  # callable -> bool
        self.mapping_interrupt = None  # callable (InterruptBA analog)
        self.mapping_queue_len = None  # callable -> int (KeyframesInQueue)

        # --- inertial plumbing (ref Tracking.cc:621-850) ---------------
        self.imu_calib = imu_calib
        if imu_calib is not None:
            from orbslam3_jax.pipeline import inertial_support as isup

            self.imu_queue = isup.ImuQueue()
            self.Rbc = np.asarray(imu_calib.Rbc)
            self.tbc = np.asarray(imu_calib.tbc)
        self.imu_ready = False  # set by local mapping after IMU init
        self.pre_from_kf = None  # accumulated Preintegrated since last KF
        self.pre_frame = None  # Preintegrated over the last frame gap
        self.body_vel = np.zeros(3, np.float32)
        self.bias_g = np.zeros(3, np.float32)
        self.bias_a = np.zeros(3, np.float32)

    def grab_imu(self, t: float, acc, gyro):
        """`Tracking::GrabImuData`."""
        self.imu_queue.push(t, acc, gyro)

    def reset_map_state(self, full: bool = False):
        """Clear every per-map tracker field (ref `Tracking::ResetActiveMap`
        `Tracking.cc:3521`; `full` adds the cross-map state that
        `Tracking::Reset` `:3456` also clears). Call BEFORE swapping in the
        fresh MapStore — the trajectory filter drops entries rooted in the
        store that is being discarded (still `self.store` here)."""
        self.state = TrackState.NO_IMAGES_YET if full else TrackState.NOT_INITIALIZED
        self.last_frame = None
        self.init_frame = None
        self.ref_kf = -1
        self.last_kf_id = -1
        self.velocity = None
        self.frame_prior = None
        self.prior_map_version = -1
        self._ref_matches_cache = None
        self.frames_since_kf = 0
        self.lost_count = 0
        self.match_inliers = 0
        self.time_lost = None
        self.last_reloc_frame_id = -(10**9)
        self.last_kf_frame_id = -(10**9)
        self.imu_ready = False
        self.pre_from_kf = None
        self.pre_frame = None
        self.body_vel = np.zeros(3, np.float32)
        self.bias_g = np.zeros(3, np.float32)
        self.bias_a = np.zeros(3, np.float32)
        if full:
            self.trajectory = []
            self.frame_id = 0
            if self.imu_calib is not None:
                from orbslam3_jax.pipeline import inertial_support as isup

                self.imu_queue = isup.ImuQueue()
        else:
            # Drop trajectory entries rooted in the reset map; entries of
            # stored Atlas maps survive (ref `Tracking::ResetActiveMap`
            # erases only the frames of `pMap`, `Tracking.cc:3560-3582`).
            self.trajectory = [
                e for e in self.trajectory if e[1] is not self.store
            ]

    # -- helpers --------------------------------------------------------
    def _extract(self, img: np.ndarray) -> feat.Features:
        with timing.span("tracking/extract"):
            f = feat.extract(jnp.asarray(img, jnp.float32), self.orb)
            jax.block_until_ready(f.desc)
        return f

    def apply_map_transform(self, Rwg: np.ndarray, s: float):
        """Keep tracker state consistent after the map was re-expressed by
        `apply_scaled_rotation` (IMU init / scale refinement): world
        x' = s * Rwg^T x, so frame poses become Rcw' = Rcw Rwg,
        tcw' = s * tcw. The reference does this inside
        `Map::ApplyScaledRotation` by transforming mLastFrame and the
        relative-pose lists (`Tracking::UpdateFrameIMU`,
        `Tracking.cc:3161-3224`); missing it strands the tracker's last
        frame in the old scale and the next IMU prediction projects the
        (rescaled) map from a wrong pose."""
        Rwg = np.asarray(Rwg, np.float32)
        s = float(s)
        # The marginalization prior is expressed in the OLD world frame;
        # drop it rather than transform (one frame of LastKeyFrame
        # anchoring, as the reference does after UpdateFrameIMU).
        self.frame_prior = None
        if self.last_frame is not None:
            self.last_frame.R = np.asarray(self.last_frame.R) @ Rwg
            self.last_frame.t = s * np.asarray(self.last_frame.t)
        if self.velocity is not None:
            Rv, tv = self.velocity  # relative cam motion: R unchanged, t scales
            self.velocity = (Rv, s * tv)
        # Relative trajectory entries rooted in THIS map: R_cr invariant,
        # t_cr scales (T_cr' = T_cw' T_rw'^-1).
        self.trajectory = [
            (ts, store_e, ref, R_cr, s * t_cr) if store_e is self.store else
            (ts, store_e, ref, R_cr, t_cr)
            for (ts, store_e, ref, R_cr, t_cr) in self.trajectory
        ]

    def _record_pose(self, ts, R, t):
        """Log the frame pose RELATIVE to its reference keyframe (ref
        `Tracking.cc:1589-1606` mlRelativeFramePoses): trajectory export
        then chains through the CURRENT keyframe poses, so later BA/loop
        corrections propagate to the frame trajectory
        (`System::SaveTrajectoryEuRoC`, `System.cc:599`)."""
        R = np.asarray(R)
        t = np.asarray(t)
        if self.ref_kf >= 0:
            rk = jnp.asarray(self.ref_kf)
            R_r = np.asarray(self.store.state.kf_R[rk])
            t_r = np.asarray(self.store.state.kf_t[rk])
            # T_cr = T_cw * T_rw^-1
            R_cr = R @ R_r.T
            t_cr = t - R_cr @ t_r
            self.trajectory.append((ts, self.store, self.ref_kf, R_cr, t_cr))
        else:
            self.trajectory.append((ts, self.store, -1, R, t))

    def on_kf_culled(self, store, slot: int, new_ref: int):
        """Re-root trajectory entries referencing a culled KF slot onto a
        live KF, using both poses at cull time. The reference handles
        this lazily at export: `SaveTrajectoryEuRoC` walks
        `while(pKF->isBad()) { Trw = Trw*pKF->mTcp; pKF = pKF->GetParent(); }`
        (`System.cc:630-645`); we apply the hop eagerly because culled
        slots are RECYCLED in the SoA store — a stale ref would chain the
        frame pose through the slot's next tenant."""
        s = store.state
        slot_j = jnp.asarray(int(slot))
        ref_j = jnp.asarray(int(new_ref))
        R_r = np.asarray(s.kf_R[slot_j])
        t_r = np.asarray(s.kf_t[slot_j])
        R_p = np.asarray(s.kf_R[ref_j])
        t_p = np.asarray(s.kf_t[ref_j])
        # T_rp = T_rw * T_pw^-1 (old-ref pose relative to the new ref)
        R_rp = R_r @ R_p.T
        t_rp = t_r - R_rp @ t_p
        self.trajectory = [
            (ts, st_e, int(new_ref), R_cr @ R_rp, R_cr @ t_rp + t_cr)
            if (st_e is store and ref == slot)
            else (ts, st_e, ref, R_cr, t_cr)
            for (ts, st_e, ref, R_cr, t_cr) in self.trajectory
        ]
        if store is self.store:
            if self.ref_kf == slot:
                self.ref_kf = int(new_ref)
            if self.last_kf_id == slot:
                self.last_kf_id = int(new_ref)

    def _obs_count_cached(self):
        """Per-point observation counts, recomputed only when the map
        version moved (KF insertion / mapping pass / loop correction) —
        see `compute_obs_count`."""
        ver = (id(self.store), self.store.change_index)
        cache = getattr(self, "_obs_cache", None)
        if cache is None or cache[0] != ver:
            self._obs_cache = (ver, compute_obs_count(self.store.state))
        return self._obs_cache[1]

    def reconstructed_trajectory(self):
        """(ts, Rwc, twc) per frame, chained through each entry's OWN
        map's current KF poses (multi-map entries resolve into whichever
        map they were tracked in; merged maps' entries are re-rooted by
        the merge)."""
        cache = {}
        out = []
        for ts, store, ref, R_cr, t_cr in self.trajectory:
            if id(store) not in cache:
                cache[id(store)] = (
                    np.asarray(store.state.kf_R), np.asarray(store.state.kf_t)
                )
            kf_R, kf_t = cache[id(store)]
            if ref >= 0:
                R_cw = R_cr @ kf_R[ref]
                t_cw = R_cr @ kf_t[ref] + t_cr
            else:
                R_cw, t_cw = R_cr, t_cr
            Rwc = R_cw.T
            out.append((ts, Rwc, -Rwc @ t_cw))
        return out

    # -- main entry -----------------------------------------------------
    def process_stereo_frame(
        self, img_left: np.ndarray, img_right: np.ndarray, timestamp: float
    ) -> fr.FrameData:
        """Stereo entry (`GrabImageStereo` `Tracking.cc:375`): extract both
        images, scanline-match for per-feature depth, then track with
        3-dof (u, v, u_right) residuals. Initialization is single-frame
        (`StereoInitialization` `Tracking.cc:1614`)."""
        from orbslam3_jax.ops import stereo as stereo_ops

        f = self._extract(img_left)
        f_r = self._extract(img_right)
        sm = stereo_ops.match_stereo_rectified(
            f, f_r, jnp.asarray(img_left, jnp.float32),
            jnp.asarray(img_right, jnp.float32), self.bf, self.scale_table,
        )
        # Keep ALL positive depths (+ their virtual-right residual rows):
        # the reference's ThDepth close/far distinction is applied where
        # points are CREATED (sorted close-first with a min-100 floor,
        # `Tracking.cc:2760-2830`) and in the keyframe-need census — NOT as
        # a frame-build filter. Round 3 blanket-dropped far depths here,
        # which left at-scale scenes (walls beyond ThDepth*baseline) unable
        # to even initialize.
        return self._process_with_features(
            f, timestamp, ur=np.asarray(sm.ur), depth=np.asarray(sm.depth)
        )

    def process_rgbd_frame(
        self, img: np.ndarray, depth_map: np.ndarray, timestamp: float
    ) -> fr.FrameData:
        """RGB-D entry (`GrabImageRGBD` `Tracking.cc:447`)."""
        from orbslam3_jax.ops import stereo as stereo_ops

        f = self._extract(img)
        sm = stereo_ops.depth_to_ur(
            f.uv, f.valid, jnp.asarray(depth_map, jnp.float32), self.bf
        )
        return self._process_with_features(
            f, timestamp, ur=np.asarray(sm.ur), depth=np.asarray(sm.depth)
        )

    def process_stereo_fisheye_frame(
        self, img_left: np.ndarray, img_right: np.ndarray, timestamp: float
    ) -> fr.FrameData:
        """Stereo-fisheye (KB8 two-camera) entry — ref `Frame.cc:1187`
        (two-camera ctor + lapping areas) and `ComputeStereoFishEyeMatches`
        (`Frame.cc:1281` -> `KannalaBrandt8::TriangulateMatches`,
        `KannalaBrandt8.cpp:334`): extract both fisheye images, BF-match
        descriptors inside the lapping areas, triangulate each match with
        the rig extrinsics -> metric per-feature depth on the LEFT camera.
        Tracking then runs on the left camera with mono residuals at
        metric scale: depth enters through single-frame initialization and
        mapping's point creation, which is where the reference's stereo
        observability lives. (Right-camera projection factors
        (`EdgeSE3ProjectXYZToBody`, `OptimizableTypes.h:132`) DO exist in
        the BA solver — `optim/ba.py` `obs_right` rows, exercised by
        `tests/test_two_cam.py`; the per-frame pose-only track here uses
        left-camera residuals only, matching the reference's fisheye
        frame which also carries no rectified `ur` — `mvuRight` stays
        -1, `Frame.cc:1300`.)"""
        from orbslam3_jax.ops import stereo as stereo_ops

        c2 = self.camera2
        assert c2 is not None, "construct the Tracker with camera2=..."
        f = self._extract(img_left)
        f_r = self._extract(img_right)
        fs = stereo_ops.match_stereo_fisheye(
            self.model, self.params, c2["params"], f, f_r,
            c2["R_rl"], c2["t_rl"], self.sigma2_table,
            lap_l=c2["lap1"], lap_r=c2["lap2"],
        )
        depth = np.asarray(fs.depth)
        # All positive depths kept; the ThDepth close/far rule applies at
        # point creation + the KF census (same as rectified stereo).
        ur = np.full(f.uv.shape[0], -1.0, np.float32)  # no rectified ur for KB8
        # Right-camera rows for pose optimization (ToBody edges): pixel
        # and octave variance of each left feature's right match.
        ridx = np.asarray(fs.right_idx)
        has_r = np.asarray(fs.valid) & (ridx >= 0)
        uv_r_all = np.asarray(f_r.uv)
        s2t = np.asarray(self.sigma2_table)
        oct_r = np.asarray(f_r.octave)[np.clip(ridx, 0, None)]
        return self._process_with_features(
            f, timestamp, ur=ur, depth=depth,
            uv_r=uv_r_all[np.clip(ridx, 0, None)].astype(np.float32),
            sig2_r=s2t[np.clip(oct_r, 0, len(s2t) - 1)].astype(np.float32),
            has_r=has_r,
        )

    def process_frame(self, img: np.ndarray, timestamp: float) -> fr.FrameData:
        f = self._extract(img)
        return self._process_with_features(f, timestamp)

    def _process_with_features(
        self,
        f: feat.Features,
        timestamp: float,
        ur: Optional[np.ndarray] = None,
        depth: Optional[np.ndarray] = None,
        uv_r: Optional[np.ndarray] = None,
        sig2_r: Optional[np.ndarray] = None,
        has_r: Optional[np.ndarray] = None,
    ) -> fr.FrameData:
        # Timestamp anomalies (ref `Tracking::Track` `Tracking.cc:987-1031`):
        # a reordered frame resets the active map; a >1 s gap in inertial
        # mode starts a fresh map (IMU initialized) or resets (not yet).
        if self.anomaly_cb is not None and self.last_frame is not None:
            dt = timestamp - self.last_frame.timestamp
            if dt < 0:
                self.anomaly_cb("reorder")
            elif dt > 1.0 and self.imu_calib is not None:
                self.anomaly_cb("gap_init" if self.imu_ready else "gap_uninit")
        cur = fr.FrameData(
            features=f,
            timestamp=timestamp,
            frame_id=self.frame_id,
            R=np.eye(3, dtype=np.float32),
            t=np.zeros(3, np.float32),
            mp_assoc=np.full(f.n, -1, np.int32),
            ur=ur,
            depth=depth,
            uv_r=uv_r, sig2_r=sig2_r, has_r=has_r,
        )
        self.frame_id += 1

        # IMU preintegration over the frame gap (`PreintegrateIMU`).
        if self.imu_calib is not None and self.last_frame is not None:
            from orbslam3_jax.ops import imu as imu_ops
            from orbslam3_jax.pipeline import inertial_support as isup

            self.pre_frame = isup.preintegrate_window(
                self.imu_queue, self.last_frame.timestamp, timestamp,
                self.bias_g, self.bias_a, self.imu_calib,
            )
            if self.pre_frame is not None:
                self.pre_from_kf = (
                    self.pre_frame
                    if self.pre_from_kf is None
                    else imu_ops.merge(self.pre_from_kf, self.pre_frame, self.imu_calib)
                )

        publish_anyway = False
        if self.state in (TrackState.NO_IMAGES_YET, TrackState.NOT_INITIALIZED):
            if cur.ur is not None:
                self._initialize_stereo(cur)
            else:
                self._initialize_mono(cur)
        else:
            ok, publish_anyway = self._track_state_machine(cur)
            if ok:
                self.state = TrackState.OK
                self.lost_count = 0
            else:
                self.lost_count += 1
        if self.state == TrackState.OK or publish_anyway:
            self._record_pose(cur.timestamp, cur.R, cur.t)
        self.last_frame = cur
        return cur

    def _track_state_machine(self, cur: fr.FrameData):
        """One tracked frame through the reference's state machine
        (`Tracking::Track` `Tracking.cc:1100-1290,1370-1400`). Returns
        (ok, publish_anyway): `publish_anyway` marks an IMU dead-reckoned
        pose that goes to the trajectory even though tracking failed
        (ref keeps publishing `mCurrentFrame.mTcw` while RECENTLY_LOST)."""
        inertial = self.imu_calib is not None
        if self.state == TrackState.OK:
            if self._track(cur):
                return True, False
            # Failure out of OK (`Tracking.cc:1177-1196`): grace period
            # only for a usable map.
            if self.store.n_kf > 10 and (not inertial or self.imu_ready):
                self.state = TrackState.RECENTLY_LOST
                self.time_lost = cur.timestamp
            else:
                self.state = TrackState.LOST
            return False, False

        if self.state == TrackState.RECENTLY_LOST:
            if inertial and self.imu_ready:
                # IMU dead-reckoning (`Track:1210-1225`): predict with the
                # preintegrated gap, keep publishing poses, and try to
                # re-attach to the map through the normal two-stage track
                # each frame.
                published = False
                if self.pre_frame is not None and self.last_frame is not None:
                    from orbslam3_jax.pipeline import inertial_support as isup

                    last = self.last_frame
                    R_wb, p_wb = isup.cam_to_body(
                        last.R, last.t, self.Rbc, self.tbc
                    )
                    R1, v1, p1 = isup.predict_state(
                        R_wb, p_wb, self.body_vel, self.bias_g, self.bias_a,
                        self.pre_frame,
                    )
                    Rp, tp = isup.body_to_cam(R1, p1, self.Rbc, self.tbc)
                    cur.R = np.asarray(Rp, np.float32)
                    cur.t = np.asarray(tp, np.float32)
                    self.body_vel = np.asarray(v1, np.float32)
                    published = True
                if self._track(cur, have_pose=published):
                    return True, False
                if (
                    self.time_lost is not None
                    and cur.timestamp - self.time_lost > self.time_recently_lost
                ):
                    self.state = TrackState.LOST  # `Track:1221` 5 s cap
                    return False, False
                return False, published
            # Visual (or IMU not yet initialized): relocalize each frame;
            # LOST once the grace window expires. (The reference V0.2
            # drops to LOST on the FIRST reloc miss, `Track:1230-1238`;
            # we keep its own 5 s constant as the window — strictly more
            # forgiving, matching upstream V1.0 behavior.)
            if self._relocalize(cur):
                self.velocity = None
                self.last_reloc_frame_id = cur.frame_id
                if self._track(cur, have_pose=True):
                    return True, False
            if (
                self.time_lost is None
                or cur.timestamp - self.time_lost > self.time_recently_lost
            ):
                self.state = TrackState.LOST
            return False, False

        # LOST: System/multimap will reset or start a fresh map
        # (`Track:1239-1257`); still attempt relocalization meanwhile.
        if self._relocalize(cur):
            self.velocity = None
            self.last_reloc_frame_id = cur.frame_id
            if self._track(cur, have_pose=True):
                return True, False
        return False, False

    # -- initialization --------------------------------------------------
    def _initialize_stereo(self, cur: fr.FrameData, min_features: int = 300):
        """`StereoInitialization` (`Tracking.cc:1614`): seed the map from
        ONE frame — every feature with valid depth becomes a map point at
        its back-projected position (metric scale from the baseline)."""
        if cur.n_features < min_features or cur.depth is None:
            return
        depth = cur.depth
        kp_ok = np.asarray(cur.features.valid) & (depth > 0)
        n_new = int(kp_ok.sum())
        if n_new < 100:
            return
        rays = np.asarray(cam.unproject(self.model, self.params, cur.features.uv))
        Xc = rays * depth[:, None]
        sel = np.flatnonzero(kp_ok)
        slots = self.store.alloc_mps(n_new)
        pos = Xc[sel]  # identity first pose: camera frame == world
        dist = np.linalg.norm(pos, axis=-1)
        normal = pos / np.maximum(dist[:, None], 1e-9)
        octs = np.asarray(cur.features.octave)[sel]
        sf = np.asarray(self.scale_table)
        max_d = dist * sf[np.clip(octs, 0, len(sf) - 1)]
        min_d = max_d / sf[-1]
        k0 = self.store.alloc_kf()
        Nf = cur.features.n
        assoc = np.full(Nf, -1, np.int32)
        assoc[sel] = slots
        s = st.add_keyframe(
            self.store.state, jnp.asarray(k0), jnp.eye(3), jnp.zeros(3),
            cur.features.uv, jnp.asarray(cur.ur), cur.features.octave,
            cur.features.angle, cur.features.desc, cur.features.valid,
            jnp.asarray(assoc), prev_kf=-1,
        )
        s = st.add_points(
            s, jnp.asarray(slots), jnp.asarray(pos, jnp.float32),
            cur.features.desc[jnp.asarray(sel)],
            jnp.asarray(normal, jnp.float32), jnp.asarray(min_d, jnp.float32),
            jnp.asarray(max_d, jnp.float32), jnp.full(n_new, k0, jnp.int32),
            jnp.ones(n_new, bool),
        )
        self.store.state = s
        self.store.kf_ts[k0] = cur.timestamp
        self.store.bump()
        cur.mp_assoc = assoc
        self.ref_kf = k0
        self.last_kf_id = k0
        self.velocity = None
        self.state = TrackState.OK
        self.frames_since_kf = 0
        self.last_kf_frame_id = cur.frame_id
        # (pose recorded by the caller's state==OK path; recording here
        # too duplicated the init frame's trajectory entry)
        self.init_frame = None

    def _initialize_mono(self, cur: fr.FrameData):
        """`MonocularInitialization` (`Tracking.cc:1724`)."""
        if cur.n_features < 100:
            self.init_frame = None
            self.state = TrackState.NOT_INITIALIZED
            return
        if self.init_frame is None:
            self.init_frame = cur
            self.pre_from_kf = None  # preintegration restarts at the ref
            self.state = TrackState.NOT_INITIALIZED
            return
        ref = self.init_frame
        m = _match_for_initialization(ref.features, cur.features)
        n_matches = int(np.asarray(m.valid).sum())
        if n_matches < 100:
            self.init_frame = cur  # ref replaced, as in Tracking.cc:1760
            self.pre_from_kf = None
            return
        # Normalized coordinates for both frames.
        rays_ref = cam.unproject(self.model, self.params, ref.features.uv)[:, :2]
        rays_cur_all = cam.unproject(self.model, self.params, cur.features.uv)[:, :2]
        idx = jnp.clip(m.idx, 0)
        rays_cur = rays_cur_all[idx]
        f_equiv = float(self.params[0])
        res = ransac.reconstruct_two_views(
            rays_ref, rays_cur, m.valid, jax.random.PRNGKey(0),
            sigma_norm=1.0 / f_equiv,
        )
        if not bool(res.success):
            return
        self._create_initial_map(ref, cur, m, res)

    def _create_initial_map(self, ref, cur, m, res):
        """`CreateInitialMapMonocular` (`Tracking.cc:1900`): two KFs, map
        points from triangulation, scale normalization by median depth."""
        good = np.asarray(res.is_good)
        X = np.asarray(res.points)
        med_depth = float(np.median(X[good][:, 2])) if good.any() else 1.0
        inv_med = 1.0 / max(med_depth, 1e-6)
        X = X * inv_med
        R21 = np.asarray(res.R)
        t21 = np.asarray(res.t) * inv_med

        n_new = int(good.sum())
        slots = self.store.alloc_mps(n_new)
        sel = np.flatnonzero(good)
        idx_ref = sel  # feature index in ref frame
        idx_cur = np.asarray(m.idx)[sel]

        # Descriptors/normals from the ref frame.
        desc = np.asarray(ref.features.desc)[idx_ref]
        pos = X[sel]
        normals = pos / np.maximum(np.linalg.norm(pos, axis=-1, keepdims=True), 1e-9)
        dist = np.linalg.norm(pos, axis=-1)
        octs = np.asarray(ref.features.octave)[idx_ref]
        sf = np.asarray(self.scale_table)
        max_dist = dist * sf[np.clip(octs, 0, len(sf) - 1)]
        min_dist = max_dist / sf[-1]

        # KF slots.
        k0 = self.store.alloc_kf()
        k1 = self.store.alloc_kf()
        Nf = ref.features.n
        assoc0 = np.full(Nf, -1, np.int32)
        assoc0[idx_ref] = slots
        assoc1 = np.full(Nf, -1, np.int32)
        assoc1[idx_cur] = slots

        s = self.store.state
        s = st.add_keyframe(
            s, jnp.asarray(k0), jnp.eye(3), jnp.zeros(3),
            ref.features.uv, jnp.full(Nf, -1.0), ref.features.octave,
            ref.features.angle, ref.features.desc, ref.features.valid,
            jnp.asarray(assoc0), prev_kf=-1,
        )
        s = st.add_keyframe(
            s, jnp.asarray(k1), jnp.asarray(R21), jnp.asarray(t21),
            cur.features.uv, jnp.full(Nf, -1.0), cur.features.octave,
            cur.features.angle, cur.features.desc, cur.features.valid,
            jnp.asarray(assoc1), prev_kf=k0,
        )
        s = st.add_points(
            s, jnp.asarray(slots), jnp.asarray(pos, jnp.float32), jnp.asarray(desc),
            jnp.asarray(normals, jnp.float32), jnp.asarray(min_dist, jnp.float32),
            jnp.asarray(max_dist, jnp.float32),
            jnp.full(n_new, k0, jnp.int32), jnp.ones(n_new, bool),
        )
        self.store.state = s
        self.store.kf_ts[k0] = ref.timestamp
        self.store.kf_ts[k1] = cur.timestamp
        self.store.bump()

        # Global BA on the initial map (ref: GlobalBundleAdjustemnt(20)).
        if self.new_kf_callback is not None:
            self.new_kf_callback(k1, initial=True, preint=self.pre_from_kf)
        self.pre_from_kf = None

        cur.R = np.asarray(self.store.state.kf_R[jnp.asarray(k1)])
        cur.t = np.asarray(self.store.state.kf_t[jnp.asarray(k1)])
        cur.mp_assoc = assoc1
        self.ref_kf = k1
        self.last_kf_id = k1
        self.velocity = None
        self.state = TrackState.OK
        self.frames_since_kf = 0
        self.last_kf_frame_id = cur.frame_id
        self._record_pose(ref.timestamp, np.eye(3), np.zeros(3))
        self.init_frame = None

    # -- tracking --------------------------------------------------------
    def _track(self, cur: fr.FrameData, have_pose: bool = False) -> bool:
        """Two-stage tracking (`Tracking::Track` `Tracking.cc:958`).
        `have_pose=True` (after relocalization) skips stage 1."""
        s = self.store.state
        last = self.last_frame
        ok = have_pose

        # Stage 1a: motion model — IMU prediction when initialized
        # (`PredictStateIMU` Tracking.cc:787), else constant velocity.
        R_pred = t_pred = None
        if have_pose:
            pass
        elif self.imu_ready and self.pre_frame is not None and last is not None:
            from orbslam3_jax.pipeline import inertial_support as isup

            R_wb, p_wb = isup.cam_to_body(last.R, last.t, self.Rbc, self.tbc)
            R1, v1, p1 = isup.predict_state(
                R_wb, p_wb, self.body_vel, self.bias_g, self.bias_a, self.pre_frame
            )
            R_pred, t_pred = isup.body_to_cam(R1, p1, self.Rbc, self.tbc)
            self.body_vel = v1.astype(np.float32)
        elif self.velocity is not None and last is not None:
            Rv, tv = self.velocity
            R_pred = Rv @ last.R
            t_pred = Rv @ last.t + tv

        dbg = os.environ.get("DEBUG_TRACK")
        with timing.span("tracking/step"):
            have_pred = R_pred is not None and last is not None
            if not have_pred:
                R_pred = np.eye(3, dtype=np.float32)
                t_pred = np.zeros(3, np.float32)
            if have_pose:
                R_last, t_last = cur.R, cur.t  # relocalized pose
            elif last is not None:
                R_last, t_last = last.R, last.t
            else:
                R_last, t_last = np.eye(3, dtype=np.float32), np.zeros(3, np.float32)
            Nf = cur.features.uv.shape[0]
            last_mp = last.mp_assoc if last is not None else np.full(Nf, -1, np.int32)
            last_oct = (
                last.features.octave if last is not None
                else jnp.zeros(Nf, jnp.int32)
            )
            bundle, (fnd, vis) = _track_step(
                self.model, self.params, s, cur.features,
                jnp.asarray(R_pred), jnp.asarray(t_pred),
                jnp.asarray(bool(have_pred)),
                jnp.asarray(last_mp), last_oct,
                jnp.asarray(self.ref_kf),
                jnp.asarray(R_last), jnp.asarray(t_last),
                self.scale_table, self.sigma2_table, jnp.asarray(self.img_wh),
                jnp.asarray(3 if self.store.n_kf > 2 else 2, jnp.int32),
                obs_count=self._obs_count_cached(),
                ur=jnp.asarray(cur.ur) if cur.ur is not None else None,
                bf=self.bf, n_levels=self.orb.n_levels,
                rig=(
                    (
                        self.camera2["params"], self.camera2["R_rl"],
                        self.camera2["t_rl"], jnp.asarray(cur.uv_r),
                        jnp.asarray(cur.sig2_r), jnp.asarray(cur.has_r),
                    )
                    if self.camera2 is not None and cur.uv_r is not None
                    else None
                ),
            )
            # ONE host round-trip for every gate/decision of this frame;
            # the found/visible stat arrays stay on device.
            b = fetch(bundle)
        if dbg:
            print(
                f"  [trk] step used_a={bool(b['used_a'])} n_a={int(b['n_a'])} "
                f"n_b={int(b['n_b'])} n_inl={int(b['n_inl'])}", flush=True,
            )
        if not bool(b["ok1"]):
            return False
        n_inl = int(b["n_inl"])
        self.match_inliers = n_inl
        if n_inl < 15:  # ref threshold 30 normal / 15 after reloc (:2541-2574)
            return False
        cur.R = np.asarray(b["R"])
        cur.t = np.asarray(b["t"])
        cur.mp_assoc = np.asarray(b["assoc"]).copy()
        if int(b["top_kfs"][0]) >= 0:
            self.ref_kf = int(b["top_kfs"][0])
        self._ref_matches_cache = int(b["ref_matches"])
        self.store.state = s._replace(mp_found=fnd, mp_visible=vis)
        s = self.store.state

        # After IMU init the reference replaces the visual-only pose
        # optimizer with the pose-inertial one (`Tracking::TrackLocalMap`,
        # `Tracking.cc:2470-2490`): refine [pose, velocity, biases] with
        # the preintegration edge to the last keyframe.
        if (
            self.imu_ready
            and self.imu_calib is not None
            and self.pre_from_kf is not None
            and self.last_kf_id >= 0
            and not os.environ.get("NO_PI")
        ):
            s_now = self.store.state
            kf_j = jnp.asarray(self.last_kf_id)
            assoc_gated = jnp.asarray(cur.mp_assoc)
            # LastFrame variant (`Optimizer.cc:8068`) when the previous
            # frame carries a valid marginalization prior and the map is
            # unchanged since (ref `mbMapUpdated`, Tracking.cc:2470-2490);
            # LastKeyFrame variant (`Optimizer.cc:3752`) otherwise.
            use_lf = (
                self.frame_prior is not None
                and self.pre_frame is not None
                and last is not None
                and self.prior_ts == last.timestamp
                and self.prior_map_version == self.store.change_index
                and not os.environ.get("NO_MARG_PRIOR")
            )
            if use_lf:
                R_a, p_a, v_a, bg_a, ba_a, H_a = self.frame_prior
                res_vi = _pose_inertial_lf_from_assoc(
                    self.model, self.params, assoc_gated, cur.features,
                    s_now.mp_pos, s_now.mp_valid, self.sigma2_table,
                    jnp.asarray(self.imu_calib.Rbc), jnp.asarray(self.imu_calib.tbc),
                    jnp.asarray(R_a), jnp.asarray(p_a), jnp.asarray(v_a),
                    jnp.asarray(bg_a), jnp.asarray(ba_a), jnp.asarray(H_a),
                    self.pre_frame,
                    jnp.asarray(cur.R), jnp.asarray(cur.t),
                    jnp.asarray(self.body_vel),
                    ur=jnp.asarray(cur.ur) if cur.ur is not None else None,
                    bf=self.bf,
                )
            else:
                res_vi = _pose_inertial_from_assoc(
                    self.model, self.params, assoc_gated, cur.features,
                    s_now.mp_pos, s_now.mp_valid, self.sigma2_table,
                    jnp.asarray(self.imu_calib.Rbc), jnp.asarray(self.imu_calib.tbc),
                    s_now.kf_R[kf_j], s_now.kf_t[kf_j], s_now.kf_vel[kf_j],
                    s_now.kf_bias_g[kf_j], s_now.kf_bias_a[kf_j],
                    self.pre_from_kf,
                    jnp.asarray(cur.R), jnp.asarray(cur.t),
                    jnp.asarray(self.body_vel),
                    ur=jnp.asarray(cur.ur) if cur.ur is not None else None,
                    bf=self.bf,
                )
            rv = fetch(res_vi)  # one round-trip for the whole result
            n_vi = int(rv.n_inliers)
            if os.environ.get("DEBUG_PI"):
                twc_vis = -cur.R.T @ cur.t
                twc_vi = -rv.Rcw.T @ rv.tcw
                print(
                    f"  [PI] n_vis={n_inl} n_vi={n_vi} |dpos|="
                    f"{np.linalg.norm(twc_vis - twc_vi):.4f} "
                    f"v={rv.v.round(3)} "
                    f"bg={rv.bg.round(4)} "
                    f"ba={rv.ba.round(3)} dT={float(self.pre_from_kf.dT):.3f}",
                    flush=True,
                )
            if n_vi >= 15:
                n_inl = n_vi
                self.match_inliers = n_vi
                cur.R = rv.Rcw
                cur.t = rv.tcw
                cur.mp_assoc = np.where(rv.inlier, np.asarray(assoc_gated), -1)
                self.body_vel = rv.v
                self.bias_g = rv.bg
                self.bias_a = rv.ba
                # Stash the marginalized prior for the next frame
                # (ref: mCurrentFrame.mpcpi set at the end of both
                # PoseInertialOptimization variants).
                self.frame_prior = (rv.R_wb, rv.p_wb, rv.v, rv.bg, rv.ba, rv.H)
                self.prior_map_version = self.store.change_index
                self.prior_ts = cur.timestamp
            else:
                self.frame_prior = None

        # (found/visible bookkeeping now happens inside `_track_step`.)

        # Motion model update (Tcl = Tcw_cur * Twc_last).
        if last is not None:
            Rl, tl = last.R, last.t
            Rwc, twc = Rl.T, -Rl.T @ tl
            self.velocity = (cur.R @ Rwc, cur.R @ twc + cur.t)

        # Keyframe policy (suppressed in localization-only mode, ref
        # `Tracking::Track` `bOK && !mbOnlyTracking` gate).
        self.frames_since_kf += 1
        if not self.only_tracking and self._need_new_keyframe(cur, n_inl):
            self._create_keyframe(cur)
        return True

    def _relocalize(self, cur: fr.FrameData) -> bool:
        """`Tracking::Relocalization` (`Tracking.cc:3248`): KFDB candidates
        -> descriptor match -> PnP RANSAC -> pose refinement. Requires a
        keyframe database (set by System when a vocabulary is provided)."""
        kfdb = getattr(self, "kfdb", None)
        if kfdb is None:
            return False
        s = self.store.state
        covis = jnp.asarray(self.store.covisibility_np())
        cand_ids, _ = kfdb.query_frame(cur.features.desc, cur.features.valid, covis)
        rays = cam.unproject(self.model, self.params, cur.features.uv)[:, :2]
        for c in np.asarray(cand_ids):
            if c < 0:
                continue
            cj = jnp.asarray(int(c))
            assoc, n = _track_reference_kf(
                s.kf_desc[cj], s.kf_feat_valid[cj], s.kf_mp[cj], s.mp_valid, cur.features,
            )
            if int(n) < 15:
                continue
            assoc_np = np.asarray(assoc)
            ok_mask = jnp.asarray(assoc_np >= 0) & cur.features.valid
            Xw = s.mp_pos[jnp.clip(jnp.asarray(assoc_np), 0)]
            ok, R, t, inl = ransac.pnp_ransac(
                Xw, rays, ok_mask, jax.random.PRNGKey(cur.frame_id),
                sigma_norm=1.0 / float(self.params[0]),
            )
            if not bool(ok):
                continue
            res = _pose_opt_from_assoc(
                self.model, self.params, R, t, jnp.asarray(assoc_np),
                cur.features, s.mp_pos, s.mp_valid, self.sigma2_table,
            )
            assoc_j = jnp.asarray(assoc_np)
            n_good = int(res.n_inliers)
            # Accept threshold: the reference's nGood>=50 (`Tracking.cc:
            # 3430`) scaled to our feature budget, floored at 15.
            thr = max(15, int(round(50 * self.orb.n_features / 1000.0)))
            if n_good < thr:
                # Guided-projection second chance (`Tracking.cc:3376-3398`):
                # wide 10px window, loose Hamming budget, re-optimize.
                kf_mask = _local_point_mask(s, cj[None])
                assoc_j = jnp.where(res.inlier, assoc_j, -1)
                assoc_j = _projection_rescue_match(
                    self.model, self.params, res.R, res.t, s, kf_mask,
                    cur.features, assoc_j, self.img_wh,
                    base_radius=10.0, max_dist=float(matching.TH_HIGH),
                    n_levels=self.orb.n_levels,
                )
                res = _pose_opt_from_assoc(
                    self.model, self.params, res.R, res.t, assoc_j,
                    cur.features, s.mp_pos, s.mp_valid, self.sigma2_table,
                )
                n_good = int(res.n_inliers)
                if thr * 0.6 <= n_good < thr:
                    # Narrow second pass (`Tracking.cc:3400-3424`): 3px
                    # window, tight Hamming budget, final re-optimize.
                    assoc_j = jnp.where(res.inlier, assoc_j, -1)
                    assoc_j = _projection_rescue_match(
                        self.model, self.params, res.R, res.t, s, kf_mask,
                        cur.features, assoc_j, self.img_wh,
                        base_radius=3.0, max_dist=float(matching.TH_LOW),
                        n_levels=self.orb.n_levels,
                    )
                    res = _pose_opt_from_assoc(
                        self.model, self.params, res.R, res.t, assoc_j,
                        cur.features, s.mp_pos, s.mp_valid, self.sigma2_table,
                    )
                    n_good = int(res.n_inliers)
            if n_good >= thr:
                cur.R = np.asarray(res.R)
                cur.t = np.asarray(res.t)
                cur.mp_assoc = np.where(
                    np.asarray(res.inlier), np.asarray(assoc_j), -1
                )
                self.ref_kf = int(c)
                return True
        return False

    def _local_keyframes(self, cur: fr.FrameData) -> np.ndarray:
        """K1 covisible KFs of the current matches (`UpdateLocalKeyFrames`
        `Tracking.cc:3042`): KFs sharing map points with the frame, by
        share count."""
        s = self.store.state
        assoc = cur.mp_assoc
        pts = assoc[assoc >= 0]
        if len(pts) == 0:
            return np.asarray([self.ref_kf], np.int32)
        # NOTE: transfer the full fixed-shape arrays then slice on host —
        # `s.kf_mp[:n_kf]` is a device slice whose shape changes with
        # every keyframe, forcing an XLA recompile per KF count.
        kf_mp = self.store.kf_mp_np()[: self.store.n_kf]
        valid = np.asarray(s.kf_valid)[: self.store.n_kf]
        ptset = np.zeros(s.Pmax + 1, bool)
        ptset[pts] = True
        shares = ptset[np.clip(kf_mp, 0, s.Pmax)].sum(axis=1) * valid
        order = np.argsort(-shares)
        top = order[shares[order] > 0][:10]
        if len(top) == 0:
            top = np.asarray([self.ref_kf])
        self.ref_kf = int(top[0])
        return top.astype(np.int32)

    def _need_new_keyframe(self, cur: fr.FrameData, n_inl: int) -> bool:
        """Full `NeedNewKeyFrame` policy (`Tracking.cc:2577-2715`):
        pre-IMU-init 4 Hz cadence, reloc gate, c1a/b/c frame gates,
        close-point rule for stereo/RGB-D, ratio rule with per-sensor
        thresholds, inertial 0.5 s cadence cap (c3), weak-tracking c4,
        and the mapper-idle insert-vs-interrupt decision."""
        if self.ref_kf < 0:
            return False
        inertial = self.imu_calib is not None
        # Before IMU init: fixed 4 Hz cadence feeds the initializer
        # (`Tracking.cc:2579-2588`).
        if inertial and not self.imu_ready:
            if self.last_kf_id < 0:
                return False
            return (
                cur.timestamp - float(self.store.kf_ts[self.last_kf_id])
            ) >= 0.25

        idle = (
            True
            if self.mapper_idle_query is None
            else bool(self.mapper_idle_query())
        )
        nkf = self.store.n_kf - len(getattr(self.store, "free_kf_slots", []))
        # Not long enough since the last relocalization (`:2604-2607`).
        if (
            cur.frame_id < self.last_reloc_frame_id + self.max_frames
            and nkf > self.max_frames
        ):
            return False

        ref_matches = getattr(self, "_ref_matches_cache", None)
        if ref_matches is None:  # legacy path (reloc etc.): one fetch
            s = self.store.state
            rk = jnp.asarray(self.ref_kf)
            ref_matches = int(
                np.asarray(((s.kf_mp[rk] >= 0) & s.kf_feat_valid[rk]).sum())
            )

        # Close-point census for stereo/RGB-D (`:2620-2641`): close means
        # depth < ThDepth*baseline (`Tracking.cc:2624`).
        need_close = False
        mono_like = not self.is_stereo_like
        if not mono_like and cur.depth is not None:
            close = (cur.depth > 0) & (cur.depth < self._close_depth_cutoff())
            tracked_close = int(np.sum(close & (cur.mp_assoc >= 0)))
            untracked_close = int(np.sum(close & (cur.mp_assoc < 0)))
            need_close = (tracked_close < 100) and (untracked_close > 70)

        # Per-sensor reference ratio (`:2643-2658`).
        if mono_like and not inertial:
            th_ratio = 0.9
        else:
            th_ratio = 0.75
        if nkf < 2:
            th_ratio = 0.4
        if self.camera2 is not None:
            th_ratio = 0.75
        if inertial and mono_like:
            th_ratio = 0.75 if n_inl > 350 else 0.9

        c1a = cur.frame_id >= self.last_kf_frame_id + self.max_frames
        c1b = (cur.frame_id >= self.last_kf_frame_id + self.min_frames) and idle
        c1c = (not mono_like and not inertial) and (
            n_inl < ref_matches * 0.25 or need_close
        )
        c2 = ((n_inl < ref_matches * th_ratio) or need_close) and n_inl > 15
        # Inertial temporal cap: a KF at least every 0.5 s (`:2670-2683`).
        c3 = False
        if inertial and self.imu_ready and self.last_kf_id >= 0:
            c3 = (
                cur.timestamp - float(self.store.kf_ts[self.last_kf_id])
            ) >= 0.5
        # Weak mono-inertial tracking / recovery from RECENTLY_LOST
        # (`:2685-2689`).
        c4 = (
            inertial
            and mono_like
            and ((15 < n_inl < 75) or self.state == TrackState.RECENTLY_LOST)
        )

        if not (((c1a or c1b or c1c) and c2) or c3 or c4):
            return False
        if idle:
            return True
        # Mapper busy: interrupt its BA; only stereo-like sensors queue
        # (`:2694-2713`).
        if self.mapping_interrupt is not None:
            self.mapping_interrupt()
        if not mono_like:
            q = 0 if self.mapping_queue_len is None else int(self.mapping_queue_len())
            return q < 3
        return False

    def _close_depth_cutoff(self) -> float:
        """ThDepth * baseline (`Tracking.cc:1616,2624`)."""
        if self.camera2 is not None:
            return self.th_depth * float(self.camera2["baseline"])
        return self.th_depth * (self.bf / float(self.params[0]))

    def _create_keyframe(self, cur: fr.FrameData):
        """`CreateNewKeyFrame` (`Tracking.cc:2716`)."""
        with timing.span("tracking/create_kf"):
            self._create_keyframe_impl(cur)

    def _create_depth_points(self, cur: fr.FrameData, slot: int):
        """Stereo/RGB-D point creation at every new keyframe
        (`Tracking.cc:2756-2830`): walk features with measured depth and
        no map point, sorted near-to-far; create every CLOSE point
        (depth < ThDepth*baseline) and keep creating past the cutoff
        until at least 100 points exist — far depths are noisy but 100
        anchors beat none. This is what keeps stereo maps dense and
        metrically pinned between triangulation passes."""
        depth = cur.depth
        fvalid = np.asarray(cur.features.valid)
        cand = np.flatnonzero(fvalid & (depth > 0) & (cur.mp_assoc < 0))
        if len(cand) == 0:
            return
        order = cand[np.argsort(depth[cand])]
        cutoff = self._close_depth_cutoff()
        n_close = int(np.searchsorted(depth[order], cutoff))
        n_take = max(n_close, min(100, len(order)))
        sel = order[:n_take]
        free = int(np.asarray(~self.store.state.mp_valid).sum()) - 1  # dump slot
        if free < len(sel):  # capacity guard: nearest first
            sel = sel[: max(free, 0)]
        if len(sel) == 0:
            return
        z = depth[sel]
        rays = np.asarray(
            cam.unproject(self.model, self.params, cur.features.uv[jnp.asarray(sel)])
        )
        Xc = rays * z[:, None]
        # World position through the CURRENT frame pose (X_w = R^T(Xc - t)).
        Xw = (Xc - cur.t) @ cur.R
        cam_center = -cur.R.T @ cur.t
        dist = np.linalg.norm(Xw - cam_center, axis=-1)
        normal = (Xw - cam_center) / np.maximum(dist[:, None], 1e-9)
        octs = np.asarray(cur.features.octave)[sel]
        sf = np.asarray(self.scale_table)
        max_d = dist * sf[np.clip(octs, 0, len(sf) - 1)]
        min_d = max_d / sf[-1]
        slots = self.store.alloc_mps(len(sel))
        s = st.add_points(
            self.store.state, jnp.asarray(slots), jnp.asarray(Xw, jnp.float32),
            cur.features.desc[jnp.asarray(sel)],
            jnp.asarray(normal, jnp.float32), jnp.asarray(min_d, jnp.float32),
            jnp.asarray(max_d, jnp.float32),
            jnp.full(len(sel), slot, jnp.int32), jnp.ones(len(sel), bool),
        )
        # Associate into the keyframe row AND the live frame.
        self.store.state = s._replace(
            kf_mp=s.kf_mp.at[jnp.asarray(slot), jnp.asarray(sel)].set(
                jnp.asarray(slots, jnp.int32)
            )
        )
        cur.mp_assoc = cur.mp_assoc.copy()
        cur.mp_assoc[sel] = slots

    def _create_keyframe_impl(self, cur: fr.FrameData):
        slot = self.store.alloc_kf()
        s = st.add_keyframe(
            self.store.state, jnp.asarray(slot), jnp.asarray(cur.R), jnp.asarray(cur.t),
            cur.features.uv,
            jnp.asarray(cur.ur) if cur.ur is not None else jnp.full(cur.features.n, -1.0),
            cur.features.octave, cur.features.angle, cur.features.desc,
            cur.features.valid, jnp.asarray(cur.mp_assoc),
            vel=jnp.asarray(self.body_vel),
            bias_g=jnp.asarray(self.bias_g),
            bias_a=jnp.asarray(self.bias_a),
            prev_kf=self.last_kf_id,  # TEMPORAL chain, not the covis ref
        )
        self.store.state = s
        self.store.kf_ts[slot] = cur.timestamp
        self.store.kf_frame_id[slot] = cur.frame_id
        if self.is_stereo_like and cur.depth is not None:
            # Stereo/RGB-D: seed measured-depth points at every keyframe
            # (close-first, min-100; `Tracking.cc:2756-2830`).
            self._create_depth_points(cur, slot)
        self.store.bump()
        self.ref_kf = slot
        self.last_kf_id = slot
        self.frames_since_kf = 0
        self.last_kf_frame_id = cur.frame_id
        preint = self.pre_from_kf
        self.pre_from_kf = None
        store_before = self.store
        if self.new_kf_callback is not None:
            self.new_kf_callback(slot, initial=False, preint=preint)
        # The callback may have MERGED the active map into another one
        # (multimap `_do_merge`): the new keyframe then lives in a
        # DIFFERENT slot of a different store, and the whole map —
        # including this keyframe — was re-expressed by the merge Sim3.
        # `last_kf_id` tracks the migration; refresh the frame's pose
        # from the transformed keyframe so the trajectory entry recorded
        # after this method chains in the NEW frame (one stale-frame
        # entry is enough to poison the replay's least-squares trajectory
        # alignment by half a meter). Scoped to the migration case: on
        # the normal path the tracked pose stays authoritative for the
        # frame (feeding the LBA-refined KF pose back into the motion
        # model changes reloc-regime behavior, observed in
        # drive_relocalization).
        slot_j = jnp.asarray(self.last_kf_id)
        if self.store is not store_before or self.last_kf_id != slot:
            cur.R = np.asarray(self.store.state.kf_R[slot_j])
            cur.t = np.asarray(self.store.state.kf_t[slot_j])
        # Refresh associations after mapping (fusion may replace points).
        cur.mp_assoc = np.asarray(self.store.state.kf_mp[slot_j])
        # Mapping may have (re-)initialized the IMU: sync bias/vel.
        if self.imu_calib is not None and self.imu_ready:
            self.bias_g = np.asarray(self.store.state.kf_bias_g[slot_j])
            self.bias_a = np.asarray(self.store.state.kf_bias_a[slot_j])
            self.body_vel = np.asarray(self.store.state.kf_vel[slot_j])
