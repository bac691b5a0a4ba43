"""Structure-of-arrays map store — the device-resident Frame/KeyFrame/MapPoint/Map.

Replaces the reference's pointer-graph data model
(`/root/reference/src/{Frame.cc,KeyFrame.cc,MapPoint.cc,Map.cc}`) with
fixed-capacity device arrays + validity masks (SURVEY.md §7 design
stance). Key translations:

* `MapPoint::mObservations` (KF -> feature index map, `MapPoint.h:141`)
  is inverted: each keyframe stores `kf_mp[k, f]` = map-point id per
  feature slot (-1 = none). An observation IS a (keyframe, feature) pair
  with `kf_mp >= 0`; BA problem assembly is pure gathering.
* The covisibility graph (`KeyFrame::UpdateConnections`,
  `KeyFrame.cc:469`) is not stored — it is *recomputed on demand* as one
  int8 matmul over observation indicator matrices (counts of shared map
  points), one dense product instead of maintained adjacency lists.
* Keyframe/map-point culling (`LocalMapping.cc:435,1170`) just clears
  validity bits; slots are recycled by the host-side allocator.
* All mutation goes through pure jitted functions (old state in, new
  state out) — the host owns ordering, replacing the reference's
  `Map::mMutexMapUpdate` (`Map.h:145`) cross-thread lock.

Host-side bookkeeping (slot allocation, timestamps as float64) lives in
the lightweight `MapStore` wrapper class.
"""

from __future__ import annotations

from typing import NamedTuple, Optional

import jax
import jax.numpy as jnp
import numpy as np


class MapState(NamedTuple):
    """Device-resident SLAM map (one Atlas map)."""

    # --- keyframes -------------------------------------------------------
    kf_R: jnp.ndarray  # (K,3,3) Tcw
    kf_t: jnp.ndarray  # (K,3)
    kf_valid: jnp.ndarray  # (K,) bool
    # per-feature data (capacity Nf per KF)
    kf_uv: jnp.ndarray  # (K,Nf,2) level-0 pixels
    kf_ur: jnp.ndarray  # (K,Nf) stereo right-u; <0 mono
    kf_octave: jnp.ndarray  # (K,Nf) int32
    kf_angle: jnp.ndarray  # (K,Nf) float32
    kf_desc: jnp.ndarray  # (K,Nf,32) uint8
    kf_feat_valid: jnp.ndarray  # (K,Nf) bool
    kf_mp: jnp.ndarray  # (K,Nf) int32 map-point id, -1 = none
    # inertial state per KF (ref KeyFrame mVw/mImuBias/mPrevKF)
    kf_vel: jnp.ndarray  # (K,3)
    kf_bias_g: jnp.ndarray  # (K,3)
    kf_bias_a: jnp.ndarray  # (K,3)
    kf_prev: jnp.ndarray  # (K,) int32 temporal chain (-1 none)
    # --- map points ------------------------------------------------------
    mp_pos: jnp.ndarray  # (P,3)
    mp_valid: jnp.ndarray  # (P,) bool
    mp_desc: jnp.ndarray  # (P,32) distinctive descriptor
    mp_normal: jnp.ndarray  # (P,3) mean viewing direction
    mp_min_dist: jnp.ndarray  # (P,) scale-invariance band (ref MapPoint.h:172)
    mp_max_dist: jnp.ndarray  # (P,)
    mp_first_kf: jnp.ndarray  # (P,) int32 creating KF
    mp_found: jnp.ndarray  # (P,) int32 tracking "found" counter
    mp_visible: jnp.ndarray  # (P,) int32 tracking "visible" counter

    @property
    def Kmax(self):
        return self.kf_R.shape[0]

    @property
    def Pmax(self):
        return self.mp_pos.shape[0]

    @property
    def Nf(self):
        return self.kf_uv.shape[1]


def empty_map(Kmax: int = 256, Pmax: int = 16384, Nf: int = 1024) -> MapState:
    f = jnp.float32
    return MapState(
        kf_R=jnp.tile(jnp.eye(3, dtype=f)[None], (Kmax, 1, 1)),
        kf_t=jnp.zeros((Kmax, 3), f),
        kf_valid=jnp.zeros(Kmax, bool),
        kf_uv=jnp.zeros((Kmax, Nf, 2), f),
        kf_ur=jnp.full((Kmax, Nf), -1.0, f),
        kf_octave=jnp.zeros((Kmax, Nf), jnp.int32),
        kf_angle=jnp.zeros((Kmax, Nf), f),
        kf_desc=jnp.zeros((Kmax, Nf, 32), jnp.uint8),
        kf_feat_valid=jnp.zeros((Kmax, Nf), bool),
        kf_mp=jnp.full((Kmax, Nf), -1, jnp.int32),
        kf_vel=jnp.zeros((Kmax, 3), f),
        kf_bias_g=jnp.zeros((Kmax, 3), f),
        kf_bias_a=jnp.zeros((Kmax, 3), f),
        kf_prev=jnp.full((Kmax,), -1, jnp.int32),
        mp_pos=jnp.zeros((Pmax, 3), f),
        mp_valid=jnp.zeros(Pmax, bool),
        mp_desc=jnp.zeros((Pmax, 32), jnp.uint8),
        mp_normal=jnp.zeros((Pmax, 3), f),
        mp_min_dist=jnp.zeros(Pmax, f),
        mp_max_dist=jnp.full(Pmax, 1e9, f),
        mp_first_kf=jnp.full(Pmax, -1, jnp.int32),
        mp_found=jnp.zeros(Pmax, jnp.int32),
        mp_visible=jnp.zeros(Pmax, jnp.int32),
    )


# ---------------------------------------------------------------------------
# Derived structures
# ---------------------------------------------------------------------------


def obs_indicator(state: MapState) -> jnp.ndarray:
    """(K, P) float indicator: KF k observes point p."""
    K, Nf = state.kf_mp.shape
    P = state.Pmax
    ok = (state.kf_mp >= 0) & state.kf_feat_valid & state.kf_valid[:, None]
    mp = jnp.clip(state.kf_mp, 0)
    ind = jnp.zeros((K, P), jnp.bfloat16)
    rows = jnp.broadcast_to(jnp.arange(K)[:, None], (K, Nf))
    ind = ind.at[rows, mp].max(ok.astype(jnp.bfloat16))
    return ind


@jax.jit
def covisibility(state: MapState) -> jnp.ndarray:
    """(K, K) int32 covisibility weights = #shared map points
    (ref `KeyFrame::UpdateConnections`, threshold applied by callers).
    One matmul over the observation indicator."""
    ind = obs_indicator(state)
    W = jnp.dot(ind, ind.T, preferred_element_type=jnp.float32)
    W = W * (1.0 - jnp.eye(W.shape[0]))
    return W.astype(jnp.int32)


@jax.jit
def point_observers(state: MapState) -> jnp.ndarray:
    """(P,) int32 — number of keyframes observing each point."""
    ind = obs_indicator(state)
    return jnp.sum(ind.astype(jnp.float32), axis=0).astype(jnp.int32)


@jax.jit
def bump_found_visible(
    state: MapState, visible: jnp.ndarray, assoc: jnp.ndarray
) -> MapState:
    """Tracking statistics (`MapPoint::IncreaseVisible/IncreaseFound`,
    ref `MapPoint.cc:319-331`): `visible` (P,) bool — points that passed
    the frustum test this frame; `assoc` (Nf,) — map-point id per feature
    after pose-optimization inlier gating (-1 = unmatched). The
    found/visible ratio feeds `MapPointCulling`."""
    vis, fnd = bump_found_visible_arrays(state, visible, assoc)[::-1]
    return state._replace(mp_visible=vis, mp_found=fnd)


def bump_found_visible_arrays(
    state: MapState, visible: jnp.ndarray, assoc: jnp.ndarray
):
    """(mp_found, mp_visible) arrays of `bump_found_visible`, for callers
    that fold the update into a larger jitted program."""
    vis = state.mp_visible + visible.astype(jnp.int32)
    fnd = state.mp_found.at[jnp.clip(assoc, 0)].add((assoc >= 0).astype(jnp.int32))
    return fnd, vis


# ---------------------------------------------------------------------------
# Mutation (pure, jitted by callers)
# ---------------------------------------------------------------------------


def add_keyframe(
    state: MapState,
    slot: jnp.ndarray,
    R: jnp.ndarray,
    t: jnp.ndarray,
    uv: jnp.ndarray,
    ur: jnp.ndarray,
    octave: jnp.ndarray,
    angle: jnp.ndarray,
    desc: jnp.ndarray,
    feat_valid: jnp.ndarray,
    mp_assoc: jnp.ndarray,
    vel: Optional[jnp.ndarray] = None,
    bias_g: Optional[jnp.ndarray] = None,
    bias_a: Optional[jnp.ndarray] = None,
    prev_kf: int = -1,
) -> MapState:
    """Insert a keyframe into `slot` (host-allocated)."""
    z3 = jnp.zeros(3, state.kf_t.dtype)
    return state._replace(
        kf_R=state.kf_R.at[slot].set(R),
        kf_t=state.kf_t.at[slot].set(t),
        kf_valid=state.kf_valid.at[slot].set(True),
        kf_uv=state.kf_uv.at[slot].set(uv),
        kf_ur=state.kf_ur.at[slot].set(ur),
        kf_octave=state.kf_octave.at[slot].set(octave),
        kf_angle=state.kf_angle.at[slot].set(angle),
        kf_desc=state.kf_desc.at[slot].set(desc),
        kf_feat_valid=state.kf_feat_valid.at[slot].set(feat_valid),
        kf_mp=state.kf_mp.at[slot].set(mp_assoc),
        kf_vel=state.kf_vel.at[slot].set(vel if vel is not None else z3),
        kf_bias_g=state.kf_bias_g.at[slot].set(bias_g if bias_g is not None else z3),
        kf_bias_a=state.kf_bias_a.at[slot].set(bias_a if bias_a is not None else z3),
        kf_prev=state.kf_prev.at[slot].set(prev_kf),
    )


def add_points(
    state: MapState,
    slots: jnp.ndarray,  # (M,) point slots
    pos: jnp.ndarray,  # (M,3)
    desc: jnp.ndarray,  # (M,32)
    normal: jnp.ndarray,  # (M,3)
    min_dist: jnp.ndarray,
    max_dist: jnp.ndarray,
    first_kf: jnp.ndarray,
    valid: jnp.ndarray,  # (M,) which of the M rows are real
) -> MapState:
    """Batch-insert map points into `slots` (invalid rows write to a dump
    slot Pmax-1... no: they keep the slot but stay invalid)."""
    return state._replace(
        mp_pos=state.mp_pos.at[slots].set(pos),
        mp_valid=state.mp_valid.at[slots].set(valid),
        mp_desc=state.mp_desc.at[slots].set(desc),
        mp_normal=state.mp_normal.at[slots].set(normal),
        mp_min_dist=state.mp_min_dist.at[slots].set(min_dist),
        mp_max_dist=state.mp_max_dist.at[slots].set(max_dist),
        mp_first_kf=state.mp_first_kf.at[slots].set(first_kf),
        mp_found=state.mp_found.at[slots].set(jnp.ones_like(first_kf)),
        mp_visible=state.mp_visible.at[slots].set(jnp.ones_like(first_kf)),
    )


def set_associations(state: MapState, kf_slot, feat_idx, mp_ids) -> MapState:
    """Write kf_mp[kf_slot, feat_idx] = mp_ids for a batch of features."""
    return state._replace(kf_mp=state.kf_mp.at[kf_slot, feat_idx].set(mp_ids))


def erase_points(state: MapState, mp_ids: jnp.ndarray, mask: jnp.ndarray) -> MapState:
    """Invalidate map points + all references to them (ref
    `MapPoint::SetBadFlag`). mp_ids (M,), mask (M,) selects rows to erase."""
    ids = jnp.where(mask, mp_ids, state.Pmax)  # out-of-range = no-op via clip trick
    valid = state.mp_valid.at[jnp.clip(ids, 0, state.Pmax - 1)].set(
        jnp.where(mask, False, state.mp_valid[jnp.clip(ids, 0, state.Pmax - 1)])
    )
    # Clear KF associations pointing at erased points.
    erased = jnp.zeros(state.Pmax + 1, bool).at[jnp.clip(ids, 0, state.Pmax)].set(mask)
    ref = jnp.clip(state.kf_mp, 0, state.Pmax)
    hit = jnp.where(state.kf_mp >= 0, erased[ref], False)
    return state._replace(mp_valid=valid, kf_mp=jnp.where(hit, -1, state.kf_mp))


@jax.jit
def replace_points(
    state: MapState, src_ids: jnp.ndarray, dst_ids: jnp.ndarray, mask: jnp.ndarray
) -> MapState:
    """Batched `MapPoint::Replace` (ref `MapPoint.cc` via
    `ORBmatcher::Fuse` `ORBmatcher.cc:1630`): every observation of
    `src_ids[i]` is rewired to `dst_ids[i]` (where `mask[i]`), except in
    keyframes that already observe the destination point — there the
    source observation is erased (the reference's `Replace` does exactly
    this: move obs if the KF doesn't see the replacement, else erase).
    Found/visible statistics are accumulated onto the destination and the
    source points are invalidated.
    """
    P = state.Pmax
    src = jnp.clip(src_ids, 0, P - 1)
    dst = jnp.clip(dst_ids, 0, P - 1)
    live = mask & (src_ids >= 0) & (dst_ids >= 0) & (src_ids != dst_ids)

    lut = jnp.arange(P, dtype=jnp.int32)
    lut = lut.at[src].set(jnp.where(live, dst, lut[src]))

    kf_mp = state.kf_mp  # (K, Nf)
    mapped = jnp.where(kf_mp >= 0, lut[jnp.clip(kf_mp, 0)], kf_mp)
    rewired = (mapped != kf_mp) & (kf_mp >= 0)
    # Row-wise dedupe: after the LUT a row may hold the same id twice —
    # (a) the row already observed the destination (reference erases the
    # rewired source obs, keeping the incumbent), or (b) two different
    # sources landed on one destination. One claimant survives per
    # (row, id): scatter-min a priority key (incumbents outrank rewired,
    # ties by feature index) and keep only the winning feature.
    K, Nf = kf_mp.shape
    rows = jnp.broadcast_to(jnp.arange(K)[:, None], kf_mp.shape)
    cols = jnp.broadcast_to(jnp.arange(Nf, dtype=jnp.int32)[None, :], kf_mp.shape)
    key = jnp.where(rewired, cols + Nf, cols)
    BIG = 2 * Nf + 1
    winner = jnp.full((K, P), BIG, jnp.int32).at[rows, jnp.clip(mapped, 0)].min(
        jnp.where(mapped >= 0, key, BIG)
    )
    keep = (mapped >= 0) & (winner[rows, jnp.clip(mapped, 0)] == key)
    new_kf_mp = jnp.where(keep, mapped, jnp.where(mapped >= 0, -1, mapped))

    # Stats transfer + invalidate sources.
    add_found = jnp.where(live, state.mp_found[src], 0)
    add_vis = jnp.where(live, state.mp_visible[src], 0)
    mp_found = state.mp_found.at[dst].add(add_found)
    mp_visible = state.mp_visible.at[dst].add(add_vis)
    mp_valid = state.mp_valid.at[src].set(
        jnp.where(live, False, state.mp_valid[src])
    )
    return state._replace(
        kf_mp=new_kf_mp, mp_valid=mp_valid, mp_found=mp_found, mp_visible=mp_visible
    )


MAXOBS = 16  # observer cap for descriptor/normal refresh


@jax.jit
def observer_table(state: MapState):
    """Device-built inverse observation index: (P, MAXOBS) observing-KF
    ids and feature indices per map point (`MapPoint::mObservations`,
    ref `MapPoint.h:141`), capped at MAXOBS in keyframe order.

    Sort-based: flatten kf_mp, stable-argsort by point id, rank within
    each point's run via searchsorted, scatter the first MAXOBS
    (kf, feat) pairs per point. Replaces a host gather that needed the
    full kf_mp + kf_feat_valid mirrors on the host."""
    K, Nf = state.kf_mp.shape
    P = state.Pmax
    ok = (state.kf_mp >= 0) & state.kf_feat_valid & state.kf_valid[:, None]
    flat_p = jnp.where(ok, state.kf_mp, P).reshape(-1)
    order = jnp.argsort(flat_p, stable=True)
    sp = flat_p[order]
    first = jnp.searchsorted(sp, jnp.arange(P + 1))
    idx = jnp.arange(sp.shape[0])
    rank = idx - first[jnp.clip(sp, 0, P)]
    valid = (sp < P) & (rank < MAXOBS)
    row = jnp.where(valid, sp, P)  # invalids land on a dummy row
    col = jnp.clip(rank, 0, MAXOBS - 1)
    kk = (order // Nf).astype(jnp.int32)
    ff = (order % Nf).astype(jnp.int32)
    tab_kf = (
        jnp.full((P + 1, MAXOBS), -1, jnp.int32)
        .at[row, col].set(jnp.where(valid, kk, -1))
    )
    tab_ff = (
        jnp.zeros((P + 1, MAXOBS), jnp.int32)
        .at[row, col].set(jnp.where(valid, ff, 0))
    )
    return tab_kf[:P], tab_ff[:P]


def gather_observers(store: "MapStore", cand_ids: np.ndarray):
    """Host-side inverted-index build: for each candidate point, up to
    MAXOBS observing (keyframe, feature) pairs. The SoA stores the
    forward map `kf_mp`; maintenance ops need the inverse
    (`MapPoint::mObservations`, ref `MapPoint.h:141`) only for small
    candidate batches at KF rate, so a host gather beats persisting a
    second index on device."""
    s = store.state
    kf_mp = store.kf_mp_np()
    okobs = (
        (kf_mp >= 0)
        & np.asarray(s.kf_feat_valid)
        & np.asarray(s.kf_valid)[:, None]
    )
    M = len(cand_ids)
    lut = np.full(s.Pmax, -1, np.int64)
    lut[cand_ids] = np.arange(M)
    cidx = np.where(okobs, lut[np.clip(kf_mp, 0, s.Pmax - 1)], -1)
    kk, ff = np.nonzero(cidx >= 0)
    ci = cidx[kk, ff]
    order = np.argsort(ci, kind="stable")
    ci, kk, ff = ci[order], kk[order], ff[order]
    first = np.searchsorted(ci, np.arange(M), "left")
    pos = np.arange(len(ci)) - first[ci]
    sel = pos < MAXOBS
    obs_kf = np.full((M, MAXOBS), -1, np.int32)
    obs_feat = np.zeros((M, MAXOBS), np.int32)
    obs_kf[ci[sel], pos[sel]] = kk[sel]
    obs_feat[ci[sel], pos[sel]] = ff[sel]
    return obs_kf, obs_feat


@jax.jit
def _refresh_kernel(
    state: MapState,
    cand_ids: jnp.ndarray,  # (M,)
    obs_kf: jnp.ndarray,  # (M, MAXOBS)
    obs_feat: jnp.ndarray,  # (M, MAXOBS)
    scale_table: jnp.ndarray,  # (L,)
) -> MapState:
    ok = obs_kf >= 0
    kfc = jnp.clip(obs_kf, 0)
    cid = jnp.clip(cand_ids, 0)
    descs = state.kf_desc[kfc, obs_feat]  # (M, O, 32)

    # Distinctive descriptor (`MapPoint::ComputeDistinctiveDescriptors`,
    # ref `MapPoint.cc`): the observation descriptor with least median
    # Hamming distance to all the others.
    x = jnp.bitwise_xor(descs[:, :, None, :], descs[:, None, :, :])
    d = jnp.sum(jax.lax.population_count(x), axis=-1).astype(jnp.int32)  # (M,O,O)
    BIG = jnp.int32(10000)
    pairok = ok[:, :, None] & ok[:, None, :]
    d = jnp.where(pairok, d, BIG)
    ds = jnp.sort(d, axis=-1)  # invalid distances sort to the end
    nv = jnp.sum(ok.astype(jnp.int32), axis=-1)  # (M,)
    med_idx = jnp.clip((nv - 1) // 2, 0, MAXOBS - 1)
    med = jnp.take_along_axis(ds, med_idx[:, None, None].repeat(MAXOBS, 1), axis=-1)[
        ..., 0
    ]  # (M, O)
    med = jnp.where(ok, med, BIG)
    best = jnp.argmin(med, axis=-1)
    aM = jnp.arange(cand_ids.shape[0])
    new_desc = descs[aM, best]

    # Normal + scale band (`MapPoint::UpdateNormalAndDepth`): normal is
    # the mean unit ray from observing camera centres; the distance band
    # comes from the first observer's feature octave.
    Rk = state.kf_R[kfc]  # (M, O, 3, 3)
    tk = state.kf_t[kfc]
    Ow = -jnp.einsum("moji,moj->moi", Rk, tk)
    X = state.mp_pos[cid]
    v = X[:, None] - Ow
    vn = v / (jnp.linalg.norm(v, axis=-1, keepdims=True) + 1e-12)
    nsum = jnp.sum(jnp.where(ok[..., None], vn, 0.0), axis=1)
    normal = nsum / (jnp.linalg.norm(nsum, axis=-1, keepdims=True) + 1e-12)

    ref_o = jnp.argmax(ok, axis=-1)
    dist = jnp.linalg.norm(X - Ow[aM, ref_o], axis=-1)
    oct_ref = state.kf_octave[kfc[aM, ref_o], obs_feat[aM, ref_o]]
    sf = scale_table[jnp.clip(oct_ref, 0, scale_table.shape[0] - 1)]
    max_d = dist * sf
    min_d = max_d / scale_table[-1]

    upd = (nv > 0) & state.mp_valid[cid] & (cand_ids >= 0)
    w = lambda new, old: jnp.where(upd.reshape(upd.shape + (1,) * (new.ndim - 1)), new, old)
    return state._replace(
        mp_desc=state.mp_desc.at[cid].set(w(new_desc, state.mp_desc[cid])),
        mp_normal=state.mp_normal.at[cid].set(w(normal, state.mp_normal[cid])),
        mp_min_dist=state.mp_min_dist.at[cid].set(w(min_d, state.mp_min_dist[cid])),
        mp_max_dist=state.mp_max_dist.at[cid].set(w(max_d, state.mp_max_dist[cid])),
    )


def refresh_points(store: "MapStore", cand_ids: np.ndarray, scale_table, cap: int = 1024):
    """Recompute distinctive descriptors + normals/scale bands for the
    candidate map points (ref `ComputeDistinctiveDescriptors` +
    `UpdateNormalAndDepth`, called after new observations/fusion). Pads
    to fixed-size chunks so the kernel compiles once per `cap`."""
    dump = store.dump_slot  # never a live point: safe pad target
    cand_ids = np.unique(np.asarray(cand_ids))
    cand_ids = cand_ids[(cand_ids >= 0) & (cand_ids < dump)]
    if len(cand_ids) == 0:
        return
    tab_kf, tab_ff = observer_table(store.state)  # device, no D2H
    for start in range(0, len(cand_ids), cap):
        chunk = cand_ids[start : start + cap]
        pad = cap - len(chunk)
        ids = np.concatenate([chunk, np.full(pad, dump, np.int64)]).astype(np.int32)
        ids_j = jnp.asarray(ids)
        lane_ok = jnp.asarray(
            np.concatenate([np.ones(len(chunk), bool), np.zeros(pad, bool)])
        )
        store.state = _refresh_kernel(
            store.state, ids_j,
            jnp.where(lane_ok[:, None], tab_kf[ids_j], -1),
            tab_ff[ids_j], jnp.asarray(scale_table, jnp.float32),
        )


def erase_keyframe(state: MapState, kf_slot) -> MapState:
    """Invalidate a keyframe and its observations (ref
    `KeyFrame::SetBadFlag`, `KeyFrame.cc:705`; spanning-tree child
    reassignment is host-side in local_mapping)."""
    return state._replace(
        kf_valid=state.kf_valid.at[kf_slot].set(False),
        kf_mp=state.kf_mp.at[kf_slot].set(jnp.full((state.Nf,), -1, jnp.int32)),
        kf_feat_valid=state.kf_feat_valid.at[kf_slot].set(jnp.zeros(state.Nf, bool)),
    )


def update_poses_points(
    state: MapState,
    kf_ids: jnp.ndarray,
    kf_R: jnp.ndarray,
    kf_t: jnp.ndarray,
    kf_mask: jnp.ndarray,
    mp_ids: jnp.ndarray,
    mp_pos: jnp.ndarray,
    mp_mask: jnp.ndarray,
) -> MapState:
    """Write back BA results (poses for kf_ids where kf_mask, positions for
    mp_ids where mp_mask)."""
    R_cur = state.kf_R[kf_ids]
    t_cur = state.kf_t[kf_ids]
    newR = jnp.where(kf_mask[:, None, None], kf_R, R_cur)
    newt = jnp.where(kf_mask[:, None], kf_t, t_cur)
    p_cur = state.mp_pos[mp_ids]
    newp = jnp.where(mp_mask[:, None], mp_pos, p_cur)
    return state._replace(
        kf_R=state.kf_R.at[kf_ids].set(newR),
        kf_t=state.kf_t.at[kf_ids].set(newt),
        mp_pos=state.mp_pos.at[mp_ids].set(newp),
    )


# ---------------------------------------------------------------------------
# Host wrapper: slot allocation & bookkeeping
# ---------------------------------------------------------------------------


class MapStore:
    """Host-side owner of one map: allocates slots, tracks timestamps.

    Mutation ordering is single-threaded host code — the replacement
    for the reference's mutex web (SURVEY.md §2.3)."""

    def __init__(self, Kmax=256, Pmax=16384, Nf=1024):
        self.state = empty_map(Kmax, Pmax, Nf)
        self.n_kf = 0
        self.n_mp = 0
        self.kf_ts = np.zeros(Kmax, np.float64)
        self.kf_frame_id = np.zeros(Kmax, np.int64)  # source frame index
        self.free_mp_slots: list[int] = []
        self.free_kf_slots: list[int] = []
        self.change_index = 0  # ref Map::GetMapChangeIndex (Tracking.cc:1081)
        self._covis_cache = (-1, None)  # (change_index, np (K,K) weights)

    def covisibility_np(self) -> np.ndarray:
        """Host copy of the covisibility weights, cached per change_index.
        The (K,P)@(P,K) recompute would otherwise run up to ~6x per
        keyframe insertion (covisible windows, fuse, culling, loop
        query); one cache per map version removes all but the first (ref keeps mConnectedKeyFrameWeights
        incrementally per KF, `KeyFrame::UpdateConnections`)."""
        from orbslam3_jax.utils.fetch import fetch

        ver, W = self._covis_cache
        if ver != self.change_index or W is None:
            W = fetch(covisibility(self.state))
            self._covis_cache = (self.change_index, W)
        return W

    def point_observers_np(self) -> np.ndarray:
        """Host copy of per-point observer counts, cached per
        change_index (same rationale as `covisibility_np`)."""
        from orbslam3_jax.utils.fetch import fetch

        ver, n = getattr(self, "_obs_cache", (-1, None))
        if ver != self.change_index or n is None:
            n = fetch(point_observers(self.state))
            self._obs_cache = (self.change_index, n)
        return n

    def kf_mp_np(self) -> np.ndarray:
        """Host mirror of the (K,Nf) feature->map-point table, cached per
        change_index (2.5 MB at Kmax=512; a cache hit costs nothing)."""
        from orbslam3_jax.utils.fetch import fetch

        ver, M = getattr(self, "_kfmp_cache", (-1, None))
        if ver != self.change_index or M is None:
            M = fetch(self.state.kf_mp)
            self._kfmp_cache = (self.change_index, M)
        return M

    # -- allocation -----------------------------------------------------
    def alloc_kf(self) -> int:
        if self.free_kf_slots:
            return self.free_kf_slots.pop()
        slot = self.n_kf
        if slot >= self.state.Kmax:
            raise RuntimeError("keyframe capacity exhausted; raise Kmax")
        self.n_kf += 1
        return slot

    def alloc_mps(self, n: int) -> np.ndarray:
        slots = []
        while self.free_mp_slots and len(slots) < n:
            slots.append(self.free_mp_slots.pop())
        remaining = n - len(slots)
        # Last slot is reserved as the scatter dump for padded inserts
        # (fixed-shape updates write their padding there).
        if self.n_mp + remaining > self.state.Pmax - 1:
            raise RuntimeError("map-point capacity exhausted; raise Pmax")
        slots.extend(range(self.n_mp, self.n_mp + remaining))
        self.n_mp += remaining
        return np.asarray(slots, np.int32)

    @property
    def dump_slot(self) -> int:
        return self.state.Pmax - 1

    def bump(self):
        self.change_index += 1
