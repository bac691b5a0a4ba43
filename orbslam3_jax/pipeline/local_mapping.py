"""Local mapping: map growth + refinement after each keyframe.

Re-design of `/root/reference/src/LocalMapping.cc` (Run loop `:96`,
pipeline order `:117-280`). The reference is a consumer thread; here
`process_keyframe` runs as a host-sequenced set of jitted programs:

* `CreateNewMapPoints` (`:501`): per covisible-KF-pair epipolar-masked
  Hamming matching + batched DLT triangulation with the reference's
  gates (cheirality, parallax, reprojection chi2, scale consistency).
* `SearchInNeighbors` fuse (`:913`): projection-masked matching of KF
  points into neighbor frames, duplicate replacement.
* Local BA (`Optimizer::LocalBundleAdjustment` `Optimizer.cc:1811`):
  covisibility window + fixed frontier assembled by pure gathers into
  `optim.ba.BAProblem` (points array stays the full SoA pool; windowing
  is a mask).
* `MapPointCulling` (`:435`): masked reduction on observer counts.
* `KeyFrameCulling` (`:1170`): 90%-redundancy rule on observation
  counts per scale band.
"""

from __future__ import annotations

import functools
from typing import Optional

import jax
import jax.numpy as jnp
import numpy as np

from orbslam3_jax.atlas import store as st
from orbslam3_jax.ops import cameras as cam
from orbslam3_jax.ops import features as feat
from orbslam3_jax.ops import lie, matching
from orbslam3_jax.optim import ba as ba_mod
from orbslam3_jax.optim import lm
from orbslam3_jax.utils import timing
from orbslam3_jax.utils.fetch import fetch

# Window shapes are static pads (one compile each); the dense-Schur LBA
# (optim/ba.py) makes C = WINDOW+FIXED cheap — S is (6C)^2, solved once
# per LM iteration. The reference optimizes ALL covisibles of the new KF
# and fixes every other observer up to maxFixKF=200 (`Optimizer.cc:1811,
# 4852`). Round-3 ran 24/48; the 48/128 caps below cover the covisible
# counts synthetic at-scale replays actually reach (the 1600-frame
# config-1 run self-limits at ~77 KFs via culling, so 48 optimizable +
# 128 fixed IS effectively the reference's all-covisibles setting there)
# at ~2.4x the 24/48 per-iter cost (`bench.py` records both buckets).
# Caps are clamped to the store's Kmax so small test maps compile small
# programs; ORBSLAM3_LBA_WINDOW/FIXED env overrides support A/B runs.
import os as _os

WINDOW = int(_os.environ.get("ORBSLAM3_LBA_WINDOW", 48))
FIXED = int(_os.environ.get("ORBSLAM3_LBA_FIXED", 128))
# Per-camera observation slots after validity compaction (see local_ba):
# every (O)-sized solver kernel runs at obs_cap/Nf of the raw row count.
OBS_CAP = int(_os.environ.get("ORBSLAM3_LBA_OBS_CAP", 768))
# Chi2-driven LM early stop (relative cost decrease); 0 disables.
LBA_TOL = float(_os.environ.get("ORBSLAM3_LBA_TOL", 1e-3)) or None


def lba_caps(Kmax: int):
    """(window, fixed) clamped to the store capacity."""
    return min(WINDOW, int(Kmax)), min(FIXED, int(Kmax))


# ---------------------------------------------------------------------------
# Triangulation of new map points
# ---------------------------------------------------------------------------


@functools.partial(jax.jit, static_argnames=("model",))
def triangulate_pair(
    model: cam.CameraModel,
    params: jnp.ndarray,
    R1, t1, R2, t2,  # Tcw of the two KFs
    uv1, oct1, desc1, free1,  # current KF features (free = no map point yet)
    uv2, oct2, desc2, free2,  # neighbor KF features
    sigma2_table: jnp.ndarray,
    scale_table: jnp.ndarray,
    focal: float,
):
    """One KF-pair triangulation pass (`SearchForTriangulation`
    `ORBmatcher.cc:1138` + `CreateNewMapPoints` gates
    `LocalMapping.cc:501-910`).

    Returns (Xw (N,3), good (N,), match_idx2 (N,)) indexed by KF1 feature.
    """
    rays1 = cam.unproject(model, params, uv1)  # (N,3) z=1
    rays2 = cam.unproject(model, params, uv2)
    # Relative pose 2<-1: T21 = T2 * T1^-1.
    R1i, t1i = lie.se3_inv(R1, t1)
    R21, t21 = lie.se3_compose(R2, t2, R1i, t1i)
    E21 = lie.hat(t21) @ R21

    # Epipolar constraint mask: Sampson-ish line distance in normalized
    # coords, threshold 3.84 sigma^2 scaled to the unit plane
    # (`epipolarConstrain`, `ORBmatcher.cc:CheckDistEpipolarLine`).
    l2 = rays1 @ E21.T  # (N1,3) epipolar line in image 2 per left ray
    num = jnp.einsum("mj,nj->nm", rays2, l2) ** 2  # (N1,N2)
    den = (l2[:, None, 0] ** 2 + l2[:, None, 1] ** 2) + 1e-12
    d2 = num / den
    s2_kp2 = sigma2_table[jnp.clip(oct2, 0, sigma2_table.shape[0] - 1)]
    epi_ok = d2 < (3.84 / (focal * focal)) * s2_kp2[None, :]

    m = matching.match_nn(
        desc1, desc2, free1, free2,
        max_dist=matching.TH_LOW, ratio=0.8, cross_check=True, extra_mask=epi_ok,
    )
    idx2 = jnp.clip(m.idx, 0)

    # Triangulate in the WORLD frame with full DLT rows from both cameras.
    P1 = jnp.concatenate([R1, t1[:, None]], axis=1)  # (3,4)
    P2 = jnp.concatenate([R2, t2[:, None]], axis=1)
    p1n = rays1[:, :2]
    p2n = rays2[idx2][:, :2]

    def rows(P, p):
        return jnp.stack([p[..., 0:1] * P[2] - P[0], p[..., 1:2] * P[2] - P[1]], axis=-2)

    A = jnp.concatenate([rows(P1, p1n), rows(P2, p2n)], axis=-2)  # (N,4,4)
    # Inhomogeneous DLT: fix w=1 and solve the 4x3 least squares
    # A[:, :3] X = -A[:, 3] via closed-form 3x3 normal equations. The
    # reference SVDs the homogeneous 4x4 (`TwoViewReconstruction.cc:
    # 818`); batched small-matrix SVD is an iterative Jacobi solve,
    # while this is three fused einsums. Near-infinity points where the normal matrix degenerates
    # produce garbage positions that the parallax/chi2/cheirality gates
    # below reject, exactly as they reject the SVD solution's.
    if _os.environ.get("ORBSLAM3_TRI_SVD") == "1":  # A/B fallback
        _, _, vt = jnp.linalg.svd(A)
        Xh = vt[..., -1, :]
        wh = Xh[..., 3:4]
        Xw = Xh[..., :3] / jnp.where(jnp.abs(wh) < 1e-12, 1e-12, wh)
    else:
        A3 = A[..., :3]
        a4 = A[..., 3]
        N3 = jnp.einsum("nki,nkj->nij", A3, A3,
                        precision=jax.lax.Precision.HIGHEST)
        brhs = -jnp.einsum("nki,nk->ni", A3, a4,
                           precision=jax.lax.Precision.HIGHEST)
        Xw = jnp.einsum("nij,nj->ni", lm.inv3x3(N3), brhs)

    # Gates.
    Xc1 = lie.se3_apply(R1, t1, Xw)
    Xc2 = lie.se3_apply(R2, t2, Xw)
    z1, z2 = Xc1[..., 2], Xc2[..., 2]
    # Parallax between viewing rays (LocalMapping.cc:600-660).
    O1 = -jnp.swapaxes(R1, -1, -2) @ t1
    O2 = -jnp.swapaxes(R2, -1, -2) @ t2
    r1w = Xw - O1[None]
    r2w = Xw - O2[None]
    cosp = jnp.sum(r1w * r2w, -1) / (
        jnp.linalg.norm(r1w, axis=-1) * jnp.linalg.norm(r2w, axis=-1) + 1e-12
    )
    # Reprojection chi2 in pixels.
    uv1_hat = cam.project(model, params, Xc1)
    uv2_hat = cam.project(model, params, Xc2)
    s2_1 = sigma2_table[jnp.clip(oct1, 0, sigma2_table.shape[0] - 1)]
    e1 = jnp.sum((uv1_hat - uv1) ** 2, -1) / s2_1
    e2 = jnp.sum((uv2_hat - uv2[idx2]) ** 2, -1) / s2_kp2[idx2]
    # Scale consistency (ratioFactor = 1.5 * scaleFactor, LocalMapping.cc:860).
    d1 = jnp.linalg.norm(r1w, axis=-1)
    d2_ = jnp.linalg.norm(r2w, axis=-1)
    ratio_dist = d2_ / jnp.maximum(d1, 1e-9)
    ratio_oct = (
        scale_table[jnp.clip(oct1, 0, scale_table.shape[0] - 1)]
        / scale_table[jnp.clip(oct2[idx2], 0, scale_table.shape[0] - 1)]
    )
    rf = 1.5 * 1.2
    scale_ok = (ratio_dist * rf > ratio_oct) & (ratio_dist < ratio_oct * rf)

    good = (
        m.valid
        & (z1 > 1e-3)
        & (z2 > 1e-3)
        & (cosp < 0.9998)
        & (cosp > 0)
        & (e1 < lm.CHI2_MONO)
        & (e2 < lm.CHI2_MONO)
        & scale_ok
        & jnp.all(jnp.isfinite(Xw), axis=-1)
    )
    return Xw, good, m.idx


@functools.partial(jax.jit, static_argnames=("model",))
def triangulate_batch(
    model: cam.CameraModel,
    params: jnp.ndarray,
    R1, t1, uv1, oct1, desc1, free1,  # current KF (shared)
    R2s, t2s, uv2s, oct2s, desc2s, free2s,  # (B, ...) stacked neighbors
    sigma2_table: jnp.ndarray,
    scale_table: jnp.ndarray,
    focal: float,
):
    """All neighbor pairs of `CreateNewMapPoints` in ONE program: vmap of
    `triangulate_pair` over the (padded, fixed-size) neighbor axis.
    The sequential per-neighbor loop cost ~10 dispatches + 10 host syncs
    per keyframe (~2.5 s measured); this is one dispatch."""
    return jax.vmap(
        lambda R2, t2, uv2, oct2, desc2, free2: triangulate_pair(
            model, params, R1, t1, R2, t2, uv1, oct1, desc1, free1,
            uv2, oct2, desc2, free2, sigma2_table, scale_table, focal,
        )
    )(R2s, t2s, uv2s, oct2s, desc2s, free2s)


# ---------------------------------------------------------------------------
# Fuse (SearchInNeighbors)
# ---------------------------------------------------------------------------


@functools.partial(jax.jit, static_argnames=("model", "n_levels"))
def fuse_into_kf(
    model: cam.CameraModel,
    params: jnp.ndarray,
    state: st.MapState,
    kf_id: jnp.ndarray,
    cand_ids: jnp.ndarray,  # (M,) map points to fuse into this KF
    cand_valid: jnp.ndarray,
    img_wh: jnp.ndarray,
    sigma2_table: jnp.ndarray,
    n_levels: int = 8,
):
    """Project candidate points into KF `kf_id`; where the matched
    keypoint is free, add the association; where it already holds a
    *different* point, report the (candidate, incumbent) conflict so the
    caller can run `MapPoint::Replace` keeping the most-observed point
    (ref `ORBmatcher::Fuse` `ORBmatcher.cc:1630`). Returns
    (new kf_mp row, n added, conflict incumbents (M,), conflict mask (M,))."""
    from orbslam3_jax.pipeline import frame as fr

    R = state.kf_R[kf_id]
    t = state.kf_t[kf_id]
    ids = jnp.clip(cand_ids, 0)
    # Skip candidates this KF already observes (ref Fuse checks
    # `pMP->IsInKeyFrame(pKF)`, `ORBmatcher.cc:1666`) — matching them to a
    # second keypoint would duplicate the association in the row.
    row0 = state.kf_mp[kf_id]
    present = (
        jnp.zeros(state.Pmax, bool).at[jnp.clip(row0, 0)].set(row0 >= 0)
    )
    cand_valid = cand_valid & ~present[ids]
    uv, visible, lvl, vcos = fr.frustum_and_scale(
        model, params, R, t,
        state.mp_pos[ids], cand_valid & state.mp_valid[ids], state.mp_normal[ids],
        state.mp_min_dist[ids], state.mp_max_dist[ids], img_wh, n_levels=n_levels,
    )
    r = 3.0 * 1.2 ** lvl.astype(jnp.float32)
    kp_valid = state.kf_feat_valid[kf_id]
    m = matching.search_by_projection(
        state.mp_desc[ids], uv, visible, state.kf_desc[kf_id],
        state.kf_uv[kf_id], kp_valid,
        radius=r, octave_kp=state.kf_octave[kf_id],
        octave_lo=jnp.maximum(lvl - 1, 0), octave_hi=lvl,  # ref: [lvl-1, lvl]
        max_dist=matching.TH_LOW, ratio=1.0,
    )
    m = matching.assign_unique(m, state.Nf)
    row = state.kf_mp[kf_id]
    tgt = jnp.clip(m.idx, 0)
    # Per-keypoint chi2 gate (ref `ORBmatcher.cc:1703`): the projection
    # must land within 5.99*sigma2 of the matched keypoint at the
    # KEYPOINT's octave — tighter than the predicted-level radius for
    # low-octave keypoints, and the main defence against merging distinct
    # points with look-alike descriptors.
    kp_oct = state.kf_octave[kf_id][tgt]
    s2_kp = sigma2_table[jnp.clip(kp_oct, 0, sigma2_table.shape[0] - 1)]
    e2 = jnp.sum((uv - state.kf_uv[kf_id][tgt]) ** 2, axis=-1)
    m_ok = m.valid & (e2 <= 5.99 * s2_kp)
    incumbent = row[tgt]
    write = m_ok & (incumbent < 0)
    new_row = row.at[tgt].set(jnp.where(write, ids, incumbent))
    conflict = m_ok & (incumbent >= 0) & (incumbent != ids)
    conflict &= state.mp_valid[jnp.clip(incumbent, 0)]
    return new_row, jnp.sum(write.astype(jnp.int32)), incumbent, conflict


@functools.partial(jax.jit, static_argnames=("model", "n_levels"))
def _fuse_batch(
    model, params, state, nb_ids, cand_ids, cand_valid, img_wh,
    sigma2_table, n_levels: int = 8,
):
    """vmap of `fuse_into_kf` over the neighbor axis (SearchInNeighbors
    direction 1 in one dispatch)."""
    return jax.vmap(
        lambda nb: fuse_into_kf(
            model, params, state, nb, cand_ids, cand_valid, img_wh,
            sigma2_table, n_levels=n_levels,
        )
    )(nb_ids)


# ---------------------------------------------------------------------------
# Local BA assembly
# ---------------------------------------------------------------------------


@functools.partial(
    jax.jit, static_argnames=("model", "iters", "pcg_iters", "obs_cap"))
def local_ba(
    model: cam.CameraModel,
    params: jnp.ndarray,
    state: st.MapState,
    window_ids: jnp.ndarray,  # (W,) -1 padded — optimizable KFs
    fixed_ids: jnp.ndarray,  # (F,) -1 padded — fixed frontier KFs
    sigma2_table: jnp.ndarray,
    bf: float = 0.0,
    iters: int = 8,
    pcg_iters: int = 40,
    obs_cap: int | None = None,
):
    """Assemble + solve the local BA problem (`Optimizer::
    LocalBundleAdjustment` `Optimizer.cc:1811`). Returns updated state
    and stats. The first two entries of window_ids are expected to be the
    oldest KFs if map anchoring is needed (caller decides fixing)."""
    all_ids = jnp.concatenate([window_ids, fixed_ids])  # (W+F,)
    C = all_ids.shape[0]
    ok_kf = all_ids >= 0
    ids = jnp.clip(all_ids, 0)
    cam_R = state.kf_R[ids]
    cam_t = state.kf_t[ids]
    cam_fixed = jnp.arange(C) >= window_ids.shape[0]
    cam_fixed = cam_fixed | ~ok_kf

    # Window point mask: points seen from the window.
    win_mp = state.kf_mp[jnp.clip(window_ids, 0)]
    wok = (win_mp >= 0) & (window_ids >= 0)[:, None]
    win_mask = jnp.zeros((state.Pmax,), bool).at[jnp.clip(win_mp, 0)].max(wok)
    win_mask &= state.mp_valid

    # Observations: all features of all participating KFs, masked to
    # window points — then COMPACTED per camera to OBS_CAP slots (valid
    # obs first via a per-row stable argsort), so every (O)-sized kernel
    # in the solver runs at ~0.75x the raw Nf row count and observations
    # stay camera-major with a FIXED per-camera count (which lets the
    # solver do Hcc/bc as one batched matmul instead of a one-hot —
    # `optim/ba.py` `obs_per_cam`). KFs carrying more than OBS_CAP valid
    # window observations drop the overflow (slot-order tail); at the
    # production Nf=1024 / ~600-feature replays this is empty.
    Nf = state.Nf
    # Sensor-dependent compaction (round-5 A/B on the 600-frame stereo
    # replay): dropping the valid-obs tail costs mono nothing (config-1
    # ATE unchanged at 2.6 cm) but stereo 2x ATE (7.4 -> 3.7 cm at full
    # Nf) — stereo rows carry the metric constraints, so stereo-like
    # callers pass obs_cap=Nf and mono keeps the throughput cap.
    obs_cap = min(OBS_CAP, Nf) if obs_cap is None else min(obs_cap, Nf)
    kf_mp_w = state.kf_mp[ids]  # (C,Nf)
    feat_ok_w = state.kf_feat_valid[ids]
    valid_w = (
        (kf_mp_w >= 0) & feat_ok_w & ok_kf[:, None]
        & win_mask[jnp.clip(kf_mp_w, 0)]
    )
    order = jnp.argsort(~valid_w, axis=1, stable=True)[:, :obs_cap]  # (C,cap)
    crow = jnp.arange(C)[:, None]
    obs_mp = kf_mp_w[crow, order].reshape(-1)
    obs_cam = jnp.repeat(jnp.arange(C, dtype=jnp.int32), obs_cap)
    obs_uv = state.kf_uv[ids][crow, order].reshape(-1, 2)
    obs_ur = state.kf_ur[ids][crow, order].reshape(-1)
    obs_oct = state.kf_octave[ids][crow, order].reshape(-1)
    obs_pt = jnp.clip(obs_mp, 0)
    obs_valid = valid_w[crow, order].reshape(-1)
    obs_s2 = sigma2_table[jnp.clip(obs_oct, 0, sigma2_table.shape[0] - 1)]

    # Compact the point axis to the window's points (fixed cap): the
    # dense-Schur coupling blocks are O(P_compact * C * 18) — without
    # this the scatter + contraction would scale with the WHOLE
    # Pmax pool (65k in at-scale replays) instead of the ~2-6k points a
    # window actually sees.
    Pmax = state.Pmax
    CAP = min(8192, Pmax)  # small stores (tests) keep small buffers
    sel = jnp.nonzero(win_mask, size=CAP, fill_value=Pmax)[0]  # (CAP,)
    sel_ok = sel < Pmax
    sel_c = jnp.clip(sel, 0, Pmax - 1)
    # inv[orig] = compact slot; CAP = "not selected" sentinel (also where
    # padding rows of `sel` landed their arange writes, at index Pmax).
    inv = jnp.full((Pmax + 1,), CAP, jnp.int32).at[
        jnp.where(sel_ok, sel_c, Pmax)
    ].set(jnp.arange(CAP, dtype=jnp.int32))
    inv = inv.at[Pmax].set(CAP)
    sel_of = inv[obs_pt]
    obs_valid = obs_valid & (sel_of < CAP)
    obs_pt_c = jnp.clip(sel_of, 0, CAP - 1)

    prob = ba_mod.BAProblem(
        cam_R=cam_R, cam_t=cam_t, cam_fixed=cam_fixed,
        points=state.mp_pos[sel_c], point_valid=sel_ok,
        obs_cam=obs_cam, obs_point=obs_pt_c, obs_uv=obs_uv, obs_ur=obs_ur,
        obs_sigma2=obs_s2, obs_valid=obs_valid,
    )
    # Explicit reduced camera system restricted to the WINDOW prefix
    # (fixed-frontier cameras have zero camera-Jacobians, so S and the
    # coupling gather only span the `Wn` optimizable columns); Hcc via
    # the camera-major batched matmul; chi2-driven early stop mirrors the
    # reference's abortable 5+10 LM schedule (`Optimizer.cc:1811`).
    res = ba_mod.solve_ba(model, params, prob, bf=bf, iters=iters,
                          dense_schur=True,
                          n_opt_prefix=window_ids.shape[0],
                          obs_per_cam=obs_cap,
                          early_stop_tol=LBA_TOL)

    # Write back: window poses + compacted window points.
    Wn = window_ids.shape[0]
    new_state = st.update_poses_points(
        state,
        jnp.clip(window_ids, 0), res.cam_R[:Wn], res.cam_t[:Wn],
        (window_ids >= 0),
        sel_c, res.points, sel_ok,
    )
    # Remove outlier observations (ref: Optimizer.cc:2060-2090 erase).
    bad_obs = obs_valid & ~res.obs_inlier
    kf_row = jnp.repeat(ids, obs_cap)
    feat_idx = order.reshape(-1).astype(jnp.int32)
    cur = new_state.kf_mp[kf_row, feat_idx]
    new_kf_mp = new_state.kf_mp.at[kf_row, feat_idx].set(jnp.where(bad_obs, -1, cur))
    new_state = new_state._replace(kf_mp=new_kf_mp)
    return new_state, res.cost, jnp.sum(bad_obs.astype(jnp.int32))


# ---------------------------------------------------------------------------
# Host-side LocalMapper
# ---------------------------------------------------------------------------


def resolve_and_replace(store, conflicts_src, conflicts_dst, anchor_kf: int):
    """Resolve fuse conflicts by `MapPoint::Replace` semantics: keep the
    most-observed point of each (candidate, incumbent) pair
    (`ORBmatcher::Fuse` `ORBmatcher.cc:1630`, `MapPoint::Replace`).
    Shared by local mapping's SearchInNeighbors and loop closing's
    SearchAndFuse. Returns the list of freed (replaced) slots; the caller
    must purge them from any slot-keyed bookkeeping before reuse.

    3D sanity gate: only merge points whose current positions agree to
    ~the depth uncertainty of a duplicate (along-ray triangulation
    error), not points from different structures. (Addition to
    ref Fuse: our batched matcher lacks the grid-walk ordering that
    implicitly limits ref merges.)
    """
    import os as _os

    a = np.concatenate(conflicts_src).astype(np.int64)
    b = np.concatenate(conflicts_dst).astype(np.int64)
    pos = np.asarray(store.state.mp_pos)
    Rk = np.asarray(store.state.kf_R[jnp.asarray(anchor_kf)])
    tk = np.asarray(store.state.kf_t[jnp.asarray(anchor_kf)])
    Ow = -Rk.T @ tk
    depth = np.linalg.norm(pos[b] - Ow, axis=1)
    gap = np.linalg.norm(pos[a] - pos[b], axis=1)
    sane = gap <= 0.2 * np.maximum(depth, 1e-6)
    a, b = a[sane], b[sane]
    obs = store.point_observers_np()
    keep_b = obs[b] >= obs[a]
    src0 = np.where(keep_b, a, b)
    dst0 = np.where(keep_b, b, a)
    # Dedupe sources (a point replaced once is gone), then resolve
    # replacement CHAINS: if (a -> b) and (c -> a) are both in the
    # batch, c must land on b — the device LUT is applied once, so
    # an unresolved chain would leave c's observations pointing at
    # the invalidated a. Cycles are dropped.
    src0, uniq = np.unique(src0, return_index=True)
    mapping = dict(zip(src0.tolist(), dst0[uniq].tolist()))
    pairs = []
    for s_, d_ in mapping.items():
        seen = {s_}
        while d_ in mapping and d_ not in seen:
            seen.add(d_)
            d_ = mapping[d_]
        if d_ in seen:  # cycle — leave these points alone
            continue
        pairs.append((s_, d_))
    if not pairs:
        return []
    src = np.asarray([p[0] for p in pairs], np.int64)
    dst = np.asarray([p[1] for p in pairs], np.int64)
    if _os.environ.get("DEBUG_FUSE") and len(src):
        gap = np.linalg.norm(pos[src] - pos[dst], axis=1)
        print(
            f"  [fuse] kf={anchor_kf} merges={len(src)} "
            f"gap mean={gap.mean():.3f} max={gap.max():.3f} "
            f"obs_src={obs[src].mean():.1f} obs_dst={obs[dst].mean():.1f}",
            flush=True,
        )
    CAP = 1024
    for start in range(0, len(src), CAP):
        cs = src[start : start + CAP]
        cd = dst[start : start + CAP]
        pad = CAP - len(cs)
        store.state = st.replace_points(
            store.state,
            jnp.asarray(np.concatenate([cs, np.full(pad, -1)]), jnp.int32),
            jnp.asarray(np.concatenate([cd, np.full(pad, -1)]), jnp.int32),
            jnp.asarray(
                np.concatenate([np.ones(len(cs), bool), np.zeros(pad, bool)])
            ),
        )
    freed = [int(x) for x in src]
    if not _os.environ.get("NO_FREE"):
        store.free_mp_slots.extend(freed)
    store.bump()  # invalidate change_index-keyed host mirrors
    return freed


class LocalMapper:
    """Synchronous local mapping (one call per keyframe insertion)."""

    def __init__(self, model, params, img_wh, store: st.MapStore,
                 orb_params: feat.OrbParams = feat.OrbParams(), bf: float = 0.0,
                 imu_calib=None, mono: bool = True):
        self.model = model
        self.params = params
        self.img_wh = np.asarray(img_wh, np.float32)
        self.store = store
        self.bf = bf
        self.stereo_like = bf > 0  # refined by System (covers rgbd/rig)
        self.sigma2_table = jnp.asarray(feat.sigma2(orb_params))
        self.scale_table = jnp.asarray(feat.scale_factors(orb_params))
        self.focal = float(params[0])
        self.recent_mp: list[tuple[int, np.ndarray]] = []  # (birth_kf, slots)
        # IMU: per-KF preintegration from its prev KF + init staging.
        self.imu_calib = imu_calib
        self.preints: dict[int, object] = {}
        self.imu_init = None
        self.bad_imu = False  # watchdog flag (ref mbBadImu, LocalMapping.cc:192)
        self.tracker = None  # backref set by System (imu_ready flag sync)
        if imu_calib is not None:
            from orbslam3_jax.pipeline.inertial_support import ImuInitializer

            self.imu_init = ImuInitializer(imu_calib, mono=mono)

    @property
    def imu_initialized(self) -> bool:
        return self.imu_init is not None and self.imu_init.initialized

    def process_keyframe(self, kf_id: int, initial: bool = False, preint=None):
        """One full mapping pass, host-sequenced (the synchronous path).
        The same pass runs sliced across frames by `async_mapping.
        AsyncMapper`, which calls the `stage_*` methods below one per
        frame tick — the sliced form of the reference's LocalMapping
        thread (`LocalMapping::Run`, `LocalMapping.cc:96`)."""
        if preint is not None:
            self.preints[kf_id] = preint
        if initial:
            # Initial map: full BA over the two first KFs
            # (`GlobalBundleAdjustemnt(20)`, Tracking.cc:1948).
            self._global_ba_small(kf_id)
            return
        for stage in self.STAGES:
            stage(self, kf_id)

    # -- mapping pass stages (order = `LocalMapping::Run` `:117-280`) ----
    def stage_prepare(self, kf_id: int):
        # Covisibility snapshot for this keyframe's whole mapping pass
        # (the reference computes UpdateConnections once per KF in
        # ProcessNewKeyFrame, `LocalMapping.cc:357`, and the later stages
        # read the cached weights instead of recomputing and refetching
        # them after every stage's bump).
        self._covis_pin = (kf_id, self.store.covisibility_np())
        with timing.span("mapping/cull_points"):
            self._cull_points(kf_id)

    def stage_triangulate(self, kf_id: int):
        with timing.span("mapping/triangulate"):
            self._create_new_points(kf_id)

    def stage_fuse(self, kf_id: int):
        with timing.span("mapping/fuse"):
            self._fuse_neighbors(kf_id)

    def stage_ba(self, kf_id: int):
        if getattr(self, "interrupt_ba", False):
            # `LocalMapping::InterruptBA` (`LocalMapping.h:64`): tracking
            # wants a keyframe in NOW — skip this pass's local BA.
            return
        with timing.span("mapping/local_ba"):
            if self.imu_initialized:
                self._local_inertial_ba(kf_id)
            else:
                self._local_ba(kf_id)

    def stage_maintain(self, kf_id: int):
        with timing.span("mapping/cull_keyframes"):
            self._cull_keyframes(kf_id)
        if self.imu_init is not None and not self.imu_init.initialized:
            self._try_imu_init(kf_id)
            if not self.imu_init.initialized:
                self._imu_watchdog(kf_id)
        elif self.imu_init is not None:
            self._viba_staging(kf_id)

    STAGES = (stage_prepare, stage_triangulate, stage_fuse, stage_ba,
              stage_maintain)

    # ------------------------------------------------------------------
    def _covisible(self, kf_id: int, n: int) -> np.ndarray:
        pin = getattr(self, "_covis_pin", None)
        W = pin[1] if pin and pin[0] == kf_id else self.store.covisibility_np()
        weights = W[kf_id][: self.store.n_kf]
        order = np.argsort(-weights)
        top = order[weights[order] >= 15][:n]  # ref th=15 (KeyFrame.cc:469)
        if len(top) == 0:
            top = order[weights[order] > 0][:n]
        return top.astype(np.int32)

    NB_BATCH = 10  # fixed neighbor batch -> one compiled shape

    def _create_new_points(self, kf_id: int):
        """`CreateNewMapPoints` (`LocalMapping.cc:501`): triangulate with
        the 10 best covisible KFs — all pairs in ONE vmapped device
        program, then a single fixed-shape point insert + association
        scatter (the sequential per-neighbor version cost ~2.5 s/KF in
        dispatches and host syncs)."""
        s = self.store.state
        neighbors = self._covisible(kf_id, self.NB_BATCH)
        if len(neighbors) == 0 and self.store.n_kf >= 2:
            neighbors = np.asarray([kf_id - 1], np.int32)
        if len(neighbors) == 0:
            self.store.bump()
            return
        B = self.NB_BATCH
        nb = np.full(B, neighbors[0], np.int32)
        nb[: min(len(neighbors), B)] = neighbors[:B]
        nb_mask = np.zeros(B, bool)
        nb_mask[: min(len(neighbors), B)] = True
        kf_j = jnp.asarray(kf_id)
        nb_j = jnp.asarray(nb)
        free_cur = (s.kf_mp[kf_j] < 0) & s.kf_feat_valid[kf_j]
        free_nbs = (
            (s.kf_mp[nb_j] < 0)
            & s.kf_feat_valid[nb_j]
            & jnp.asarray(nb_mask)[:, None]
        )
        Xw_b, good_b, idx2_b = triangulate_batch(
            self.model, self.params,
            s.kf_R[kf_j], s.kf_t[kf_j], s.kf_uv[kf_j], s.kf_octave[kf_j],
            s.kf_desc[kf_j], free_cur,
            s.kf_R[nb_j], s.kf_t[nb_j], s.kf_uv[nb_j], s.kf_octave[nb_j],
            s.kf_desc[nb_j], free_nbs,
            self.sigma2_table, self.scale_table, self.focal,
        )
        # One concurrent round-trip for the whole triangulation result +
        # the current-KF rows used below (see utils/fetch.py).
        good_b, Xw_b, idx2_b, desc_row, R_row, t_row, oct_row = fetch(
            good_b, Xw_b, idx2_b,
            s.kf_desc[kf_j], s.kf_R[kf_j], s.kf_t[kf_j], s.kf_octave[kf_j],
        )

        # Claim resolution in covisibility order: each current-KF feature
        # triangulates with its best-connected neighbor only (the
        # sequential loop's `claimed` semantics).
        claimed = np.zeros(s.Nf, bool)
        picks = []
        for b in range(B):
            if not nb_mask[b]:
                continue
            sel = np.flatnonzero(good_b[b] & ~claimed)
            if len(sel) == 0:
                continue
            claimed[sel] = True
            picks.append((b, sel))
        if not picks:
            self.store.bump()
            return
        sel_all = np.concatenate([sel for _, sel in picks])
        b_all = np.concatenate(
            [np.full(len(sel), b, np.int64) for b, sel in picks]
        )
        total = len(sel_all)
        slots = self.store.alloc_mps(total)

        # FIXED-SHAPE insert: pad to Nf rows targeting the dump slot so
        # every call reuses one compiled executable.
        CAP = s.Nf
        pad = CAP - total
        slots_p = np.concatenate([slots, np.full(pad, self.store.dump_slot, np.int32)])
        valid_p = np.concatenate([np.ones(total, bool), np.zeros(pad, bool)])
        sel_p = np.concatenate([sel_all, np.zeros(pad, np.int64)])
        Xw_np = Xw_b[np.concatenate([b_all, np.zeros(pad, np.int64)]), sel_p]
        desc = desc_row[sel_p]
        # Normal & scale band from the current KF.
        Rwc = R_row.T
        Ow = -Rwc @ t_row
        vec = Xw_np - Ow
        dist = np.linalg.norm(vec, axis=-1)
        normal = vec / np.maximum(dist[:, None], 1e-9)
        octs = oct_row[sel_p]
        sf = np.asarray(self.scale_table)
        max_d = dist * sf[np.clip(octs, 0, len(sf) - 1)]
        min_d = max_d / sf[-1]
        new_state = st.add_points(
            s, jnp.asarray(slots_p), jnp.asarray(Xw_np, jnp.float32),
            jnp.asarray(desc), jnp.asarray(normal, jnp.float32),
            jnp.asarray(min_d, jnp.float32), jnp.asarray(max_d, jnp.float32),
            jnp.full(CAP, kf_id, jnp.int32), jnp.asarray(valid_p),
        )

        # Associations: current-KF row + all neighbor rows in one scatter.
        row1, base = fetch(new_state.kf_mp[kf_j], new_state.kf_mp[nb_j])
        row1 = row1.copy()
        row1[sel_all] = slots
        base = base.copy()  # (B, Nf)
        final = {}
        off = 0
        for b, sel in picks:
            r = final.get(int(nb[b]), base[b]).copy()
            r[idx2_b[b, sel]] = slots[off : off + len(sel)]
            final[int(nb[b])] = r
            off += len(sel)
        # Padded duplicates must carry identical content for their slot.
        rows2 = np.stack([final.get(int(nb[b]), base[b]) for b in range(B)])
        new_state = new_state._replace(
            kf_mp=new_state.kf_mp.at[kf_j].set(jnp.asarray(row1))
            .at[nb_j].set(jnp.asarray(rows2))
        )
        self.store.state = new_state
        self.recent_mp.append((kf_id, slots))
        self.store.bump()

    def purge_freed(self, freed):
        """Freed slots will be REALLOCATED to brand-new points; purge them
        from pending culling batches or the new tenants would be judged by
        the old point's birth age and culled at birth. Called after any
        point replacement — including by the loop closer's SearchAndFuse."""
        if not freed:
            return
        freed = list(freed)
        self.recent_mp = [
            (b, s[~np.isin(s, freed)]) for b, s in self.recent_mp
        ]

    def _fuse_neighbors(self, kf_id: int):
        """`SearchInNeighbors` (`LocalMapping.cc:913`), both directions:
        (1) project current-KF points into each 1-hop neighbor; (2) pool
        the points of the 1-hop + 2-hop neighborhood and project them into
        the current KF. Conflicting associations are resolved by
        `MapPoint::Replace` semantics — the point with more observers
        wins globally (`ORBmatcher::Fuse` `ORBmatcher.cc:1630`). Finally
        the touched points get fresh distinctive descriptors and normals
        (ref `LocalMapping.cc:1090-1110`)."""
        s = self.store.state
        neighbors = self._covisible(kf_id, 10)
        # 2-hop expansion: 5 best covisibles of each neighbor (ref :930).
        pin = getattr(self, "_covis_pin", None)
        Wmat = pin[1] if pin and pin[0] == kf_id else self.store.covisibility_np()
        nkf = self.store.n_kf
        hood = set(int(n) for n in neighbors)
        for nb in list(hood):
            w = Wmat[nb][:nkf]
            second = np.argsort(-w)[:5]
            hood.update(int(x) for x in second[w[second] >= 15]
                        if int(x) != kf_id)
        hood.discard(kf_id)

        conflicts_src: list[np.ndarray] = []
        conflicts_dst: list[np.ndarray] = []

        def _collect(cand_np, inc, conf):
            conf = np.asarray(conf)
            if conf.any():
                conflicts_src.append(cand_np[conf])
                conflicts_dst.append(np.asarray(inc)[conf])

        # Direction 1: current KF's points into 1-hop neighbors — all
        # neighbors in one vmapped program + one row scatter (each
        # neighbor's fuse touches only its own row, so the batched form
        # is exact; padding lanes duplicate lane 0 and produce identical
        # rows, and their conflicts are dropped below).
        cand = self.store.kf_mp_np()[kf_id]
        cand_ids = jnp.asarray(np.where(cand >= 0, cand, 0))
        cand_valid = jnp.asarray(cand >= 0)
        if len(neighbors):
            B = LocalMapper.NB_BATCH
            nb_p = np.full(B, neighbors[0], np.int32)
            nb_p[: min(len(neighbors), B)] = neighbors[:B]
            rows_b, _n_b, inc_b, conf_b = _fuse_batch(
                self.model, self.params, self.store.state,
                jnp.asarray(nb_p), cand_ids, cand_valid,
                jnp.asarray(self.img_wh), self.sigma2_table,
            )
            self.store.state = self.store.state._replace(
                kf_mp=self.store.state.kf_mp.at[jnp.asarray(nb_p)].set(rows_b)
            )
            inc_b, conf_b = fetch(inc_b, conf_b)
            cand_pos = np.where(cand >= 0, cand, 0)
            for b in range(min(len(neighbors), B)):
                _collect(cand_pos, inc_b[b], conf_b[b])

        # Direction 2: neighborhood points into the current KF.
        import os as _os
        if _os.environ.get("NO_FUSE2"):
            hood = set()
        if hood:
            kf_mp_np = self.store.kf_mp_np()
            pool = np.unique(kf_mp_np[sorted(hood)].reshape(-1))
            pool = pool[pool >= 0]
            CAP = 4096
            kf_j = jnp.asarray(kf_id)
            pending = []  # device results; fetched in one round below
            for start in range(0, len(pool), CAP):
                chunk = pool[start : start + CAP]
                pad = CAP - len(chunk)
                ids = np.concatenate([chunk, np.zeros(pad, chunk.dtype)])
                valid = np.concatenate([np.ones(len(chunk), bool), np.zeros(pad, bool)])
                new_row, n_fused, inc, conf = fuse_into_kf(
                    self.model, self.params, self.store.state, kf_j,
                    jnp.asarray(ids, jnp.int32), jnp.asarray(valid),
                    jnp.asarray(self.img_wh), self.sigma2_table,
                )
                self.store.state = self.store.state._replace(
                    kf_mp=self.store.state.kf_mp.at[kf_j].set(new_row)
                )
                pending.append((ids.astype(np.int64), inc, conf))
            if pending:
                fetched = fetch([(p[1], p[2]) for p in pending])
                for (ids64, _, _), (inc_np, conf_np) in zip(pending, fetched):
                    _collect(ids64, inc_np, conf_np)

        # Resolve conflicts: keep the most-observed point.
        if _os.environ.get("NO_REPLACE"):
            conflicts_src = []
        if conflicts_src:
            freed = resolve_and_replace(
                self.store, conflicts_src, conflicts_dst, kf_id
            )
            self.purge_freed(freed)

        if _os.environ.get("DEBUG_FUSE"):
            km = np.asarray(self.store.state.kf_mp)
            ndup = 0
            for k in range(self.store.n_kf):
                r_ = km[k][km[k] >= 0]
                ndup += len(r_) - len(np.unique(r_))
            print(f"  [fuse] kf={kf_id} row_dups={ndup}", flush=True)
        # Refresh descriptors/normals of every point now tied to this KF.
        # bump() first: the fuse row writes above mutated kf_mp without a
        # version bump, and refresh_points reads via the change_index-keyed
        # host mirrors (stale otherwise).
        self.store.bump()
        if not _os.environ.get("NO_REFRESH"):
            row = self.store.kf_mp_np()[kf_id]
            st.refresh_points(self.store, row[row >= 0], self.scale_table)

    def _local_ba(self, kf_id: int):
        s = self.store.state
        WIN, FIX = lba_caps(s.Kmax)
        cov = self._covisible(kf_id, WIN - 1)
        window = np.concatenate([[kf_id], cov]).astype(np.int32)[:WIN]
        # Fixed frontier: KFs sharing points with the window, not in it.
        pin = getattr(self, "_covis_pin", None)
        Wmat = pin[1] if pin and pin[0] == kf_id else self.store.covisibility_np()
        nkf = self.store.n_kf
        shares = Wmat[window][:, :nkf].sum(0)
        cand = np.argsort(-shares)
        fixed = [c for c in cand if shares[c] > 0 and c not in set(window.tolist())][:FIX]
        # Anchor: if fewer than 1 fixed, fix the oldest window KF
        # (ref guarantees >=2 fixed KFs, Optimizer.cc:1903-1944).
        if len(fixed) == 0 and len(window) > 1:
            oldest = int(window.min())
            window = np.asarray([k for k in window if k != oldest], np.int32)
            fixed = [oldest]
        win_pad = np.full(WIN, -1, np.int32)
        win_pad[: len(window)] = window
        # Bucket the fixed-frontier pad so the solver compiles at the
        # SMALLEST static camera count covering this call: the live maps
        # at-scale replays reach (~80 KFs after culling) leave ~30
        # frontier KFs, and padding them to FIX=128 would make every
        # O-sized kernel stream 2.2x the rows it needs. One extra
        # compile per bucket, served by the persistent compile cache.
        fix_bucket = next(b for b in (FIX // 4, FIX // 2, FIX)
                          if len(fixed) <= b)
        fix_pad = np.full(fix_bucket, -1, np.int32)
        fix_pad[: len(fixed)] = fixed
        # Always keep KF 0 fixed to anchor the gauge.
        if 0 in window.tolist():
            win_pad = np.asarray([k if k != 0 else -1 for k in win_pad], np.int32)
            if 0 not in fixed:
                for i in range(len(fix_pad)):
                    if fix_pad[i] < 0:
                        fix_pad[i] = 0
                        break
                else:  # bucket full — grow to the next one for KF0
                    fix_pad = np.concatenate(
                        [fix_pad, np.full(len(fix_pad), -1, np.int32)])
                    fix_pad[len(fix_pad) // 2] = 0
        new_state, cost, n_out = local_ba(
            self.model, self.params, self.store.state,
            jnp.asarray(win_pad), jnp.asarray(fix_pad), self.sigma2_table,
            bf=self.bf,
            obs_cap=self.store.state.Nf if self.stereo_like else None,
        )
        self.store.state = new_state
        self.store.bump()

    def _cull_keyframes(self, kf_id: int, keep_recent: int = 3):
        """`KeyFrameCulling` (`LocalMapping.cc:1170`): erase covisible KFs
        whose map points are >=90% redundant — a point counts as
        redundant only if >=3 OTHER keyframes observe it at the same or
        finer scale (scaleLevel_i <= scaleLevel+1, `LocalMapping.cc:
        1198-1209`), so far-scale coverage is not thinned by close-up
        observers. Never culls KF0, the `keep_recent` newest KFs, or
        (inertial mode) the temporal window the IMU chain needs (Nd=21
        guard, `LocalMapping.cc:1176-1198`)."""
        s = self.store.state
        nkf = self.store.n_kf
        protected = {0, kf_id}
        protected.update(range(max(0, nkf - keep_recent), nkf))
        if self.imu_calib is not None:
            protected.update(range(max(0, nkf - 21), nkf))
        candidates = [c for c in self._covisible(kf_id, 10) if int(c) not in protected]
        if not candidates:
            return
        kf_mp = self.store.kf_mp_np()
        valid = np.asarray(s.kf_valid)
        # Per-(point, octave) observation histogram, cumulative over
        # octaves: cum[p, o] = observations of p at octave <= o.
        kf_oct, feat_ok = fetch(s.kf_octave, s.kf_feat_valid)
        L = int(self.sigma2_table.shape[0])
        m = (kf_mp >= 0) & feat_ok & valid[:, None]
        pids = kf_mp[m]
        octs = np.clip(kf_oct[m], 0, L - 1)
        cnt = np.zeros((s.Pmax, L), np.int32)
        np.add.at(cnt, (pids, octs), 1)
        cum = np.cumsum(cnt, axis=1)
        for c in candidates:
            c = int(c)
            if not valid[c]:
                continue
            row = kf_mp[c]
            sel_f = row >= 0
            pts = row[sel_f]
            if len(pts) < 20:
                continue
            # Scale condition: other observers at octave <= this KF's
            # octave + 1 (same-or-finer scale); subtract self.
            oct_c = np.clip(kf_oct[c][sel_f], 0, L - 1)
            fine = cum[pts, np.minimum(oct_c + 1, L - 1)] - 1
            redundant = (fine >= 3).sum()
            if redundant >= 0.9 * len(pts):
                # Re-root tracker trajectory entries anchored on this slot
                # BEFORE erasing: slots are recycled, and the reference's
                # lazy bad-KF walk (`System.cc:630-645`) has no analog in
                # a SoA store. Anchor on the temporal predecessor.
                if self.tracker is not None:
                    prev_np = np.asarray(self.store.state.kf_prev)
                    valid_np = np.asarray(self.store.state.kf_valid)
                    anchor = int(prev_np[c])
                    if anchor < 0 or not valid_np[anchor]:
                        anchor = kf_id
                    self.tracker.on_kf_culled(self.store, c, anchor)
                self.store.state = st.erase_keyframe(self.store.state, jnp.asarray(c))
                self.store.free_kf_slots.append(c)
                # Keep the temporal chain linked past the hole.
                prev = np.asarray(self.store.state.kf_prev)
                heirs = np.flatnonzero(prev[: self.store.n_kf] == c)
                for h in heirs:
                    h = int(h)
                    self.store.state = self.store.state._replace(
                        kf_prev=self.store.state.kf_prev.at[jnp.asarray(h)].set(
                            int(prev[c])
                        )
                    )
                    # Keep the IMU chain integral: the heir's window must
                    # absorb the culled KF's (ref merges preintegrations
                    # on culling via mpImuPreintegrated->MergePrevious).
                    if c in self.preints and h in self.preints:
                        from orbslam3_jax.ops import imu as imu_ops

                        self.preints[h] = imu_ops.merge(
                            self.preints[c], self.preints[h], self.imu_calib
                        )
                self.preints.pop(c, None)
        self.store.bump()

    def _cull_points(self, kf_id: int):
        """`MapPointCulling` (`LocalMapping.cc:435`): recently created
        points must gain >=3 observers within 2 KFs of birth, AND must be
        found by tracking in >=25% of the frames that predicted them
        visible (`MapPoint::GetFoundRatio() < 0.25f` test)."""
        if not self.recent_mp:
            return
        s = self.store.state
        observers = self.store.point_observers_np()
        found, visible, mp_valid = fetch(s.mp_found, s.mp_visible, s.mp_valid)
        ratio = found / np.maximum(visible, 1)
        keep = []
        erase_slots = []
        for birth_kf, slots in self.recent_mp:
            # Points already replaced/erased (fuse) must not be re-freed.
            slots = slots[mp_valid[slots]]
            age = kf_id - birth_kf
            if age >= 2:
                import os as _os
                if _os.environ.get("NO_RATIO"):
                    bad = slots[observers[slots] <= 2]
                else:
                    bad = slots[(observers[slots] <= 2) | (ratio[slots] < 0.25)]
                erase_slots.append(bad)
                # survivors graduate (no more checks)
            else:
                keep.append((birth_kf, slots))
        self.recent_mp = keep
        if erase_slots:
            bad = np.concatenate(erase_slots)
            if len(bad):
                CAP = 1024
                for start in range(0, len(bad), CAP):
                    chunk = bad[start : start + CAP]
                    pad = CAP - len(chunk)
                    ids = np.concatenate([chunk, np.zeros(pad, chunk.dtype)])
                    mask = np.concatenate(
                        [np.ones(len(chunk), bool), np.zeros(pad, bool)]
                    )
                    self.store.state = st.erase_points(
                        self.store.state, jnp.asarray(ids, jnp.int32), jnp.asarray(mask)
                    )
                self.store.free_mp_slots.extend(int(b) for b in bad)

    # ------------------------------------------------------------------
    # Inertial staging
    # ------------------------------------------------------------------
    def _imu_watchdog(self, kf_id: int):
        """Bad-IMU watchdog (`LocalMapping.cc:183-192`): in an inertial run
        whose map is still visual-only, near-zero camera motion across the
        last three keyframes means the accelerometer is unexcited and IMU
        init can never succeed — the reference flags `mbBadImu` and the
        tracking side resets the active map to try again."""
        valid = np.asarray(self.store.state.kf_valid)
        ids = np.flatnonzero(valid[: self.store.n_kf])
        if len(ids) < 3:
            return
        ts = self.store.kf_ts
        order = ids[np.argsort(ts[ids])]
        if ts[order[-1]] - ts[order[0]] >= 10.0:
            return  # ref: watchdog only while mTinit < 10 s
        if ts[order[-1]] - ts[order[-3]] < 0.45:
            # The reference's KF cadence pre-init is ~2-5 Hz, so its
            # 3-KF distance integrates ~0.5-1 s of motion. Ours can
            # insert KFs on consecutive 20 Hz frames early in a map —
            # 2 cm over 0.1 s would false-flag healthy sequences.
            return
        last3 = jnp.asarray(order[-3:].astype(np.int32))
        R3, t3 = fetch(self.store.state.kf_R[last3], self.store.state.kf_t[last3])
        centers = np.einsum("kji,kj->ki", R3, -t3)  # Ow = -R^T t
        dist = float(
            np.linalg.norm(centers[1] - centers[0])
            + np.linalg.norm(centers[2] - centers[1])
        )
        if dist < 0.02:
            self.bad_imu = True

    def _try_imu_init(self, kf_id: int):
        """`LocalMapping::InitializeIMU` (`LocalMapping.cc:1448`)."""
        from orbslam3_jax.pipeline import inertial_support as isup

        ok = self.imu_init.try_initialize(
            self.store, self.preints,
            np.asarray(self.imu_calib.Rbc), np.asarray(self.imu_calib.tbc),
        )
        if ok:
            # The init-time FullInertialBA (`LocalMapping.cc:1585-1587`,
            # priorG=1e2/priorA=1e6): joint visual-inertial BA right after
            # alignment — the reprojection terms let poses bend to the
            # IMU, sharpening scale/gravity well beyond the pose-fixed
            # initializer. VIBA1/VIBA2 follow at 5 s / 15 s via
            # `_viba_staging`.
            import os as _os
            if not _os.environ.get("NO_VIBA1"):
                self._full_inertial_ba(kf_id, prior_gyro=1e2, prior_acc=1e6)
        if ok and self.tracker is not None:
            if self.imu_init.applied_transform is not None:
                self.tracker.apply_map_transform(*self.imu_init.applied_transform)
                self.imu_init.applied_transform = None
            self.tracker.imu_ready = True
            s = self.store.state
            kf_j = jnp.asarray(kf_id)
            self.tracker.bias_g = np.asarray(s.kf_bias_g[kf_j])
            self.tracker.bias_a = np.asarray(s.kf_bias_a[kf_j])
            self.tracker.body_vel = np.asarray(s.kf_vel[kf_j])
            import os as _os
            if _os.environ.get("DEBUG_INIT"):
                vels = np.asarray(s.kf_vel)[: self.store.n_kf]
                print(
                    f"  [init/post] kf={kf_id} vel={np.asarray(s.kf_vel[kf_j]).round(3)} "
                    f"|v| mean={np.linalg.norm(vels, axis=1).mean():.3f} "
                    f"bg={self.tracker.bias_g.round(4)} ba={self.tracker.bias_a.round(3)}",
                    flush=True,
                )

    def _viba_staging(self, kf_id: int):
        """Post-init inertial refinement staging (`LocalMapping.cc:232-273`):

        * VIBA1 at mTinit > 5 s — full-map VI-BA with priorG=1, priorA=1e5
          (`InitializeIMU(1.f, 1e5, true)` -> `FullInertialBA`,
          `Optimizer.cc:473`),
        * VIBA2 at mTinit > 15 s — priors released (priorG=priorA=0),
        * mono: `ScaleRefinement` every ~10 s while 25 s < mTinit < 75 s
          (`LocalMapping.cc:261-273`).
        """
        ini = self.imu_init
        valid = np.asarray(self.store.state.kf_valid)[: self.store.n_kf]
        ids = np.flatnonzero(valid)
        if len(ids) < 3:
            return
        now = float(self.store.kf_ts[kf_id])
        tinit = now - float(self.store.kf_ts[ids].min())
        if not ini.viba1_done and tinit > 5.0:
            self._full_inertial_ba(kf_id, prior_gyro=1.0, prior_acc=1e5)
            ini.viba1_done = True
        elif ini.viba1_done and not ini.viba2_done and tinit > 15.0:
            self._full_inertial_ba(kf_id, prior_gyro=0.0, prior_acc=0.0)
            ini.viba2_done = True
        elif (
            ini.mono
            and ini.viba2_done
            and 25.0 < tinit < 75.0
            and now - getattr(self, "_last_scale_ref_ts", -1e18) >= 10.0
        ):
            self._last_scale_ref_ts = now
            ini.applied_transform = None
            ini.refine_scale(
                self.store, self.preints,
                np.asarray(self.imu_calib.Rbc), np.asarray(self.imu_calib.tbc),
            )
            if self.tracker is not None:
                if ini.applied_transform is not None:
                    self.tracker.apply_map_transform(*ini.applied_transform)
                s = self.store.state
                kf_j = jnp.asarray(kf_id)
                self.tracker.body_vel = np.asarray(s.kf_vel[kf_j])
                self.tracker.bias_g = np.asarray(s.kf_bias_g[kf_j])
                self.tracker.bias_a = np.asarray(s.kf_bias_a[kf_j])

    def _full_inertial_ba(self, kf_id: int, prior_gyro: float, prior_acc: float):
        """Whole-map VI-BA (`Optimizer::FullInertialBA`, `Optimizer.cc:473`):
        the temporal chain from the current KF back to the map origin,
        bucketed to a multiple of 16 so the handful of staging calls share
        compiled executables."""
        n_live = self.store.n_kf - len(self.store.free_kf_slots)
        window = max(16 * ((n_live + 15) // 16), 16)
        self._local_inertial_ba(
            kf_id, window=window, prior_gyro=prior_gyro, prior_acc=prior_acc,
            iters=10,
        )

    def _local_inertial_ba(self, kf_id: int, window: int = 10,
                           prior_gyro: float = 1e2, prior_acc: float = 1e6,
                           iters: int = 6):
        """`Optimizer::LocalInertialBA` (`Optimizer.cc:4753`): temporal
        sliding window of the last Nd KFs + one fixed anchor; visual obs of
        window points + IMU chain + bias RW."""
        from orbslam3_jax.optim import inertial as vi
        from orbslam3_jax.pipeline import inertial_support as isup

        s = self.store.state
        nkf = self.store.n_kf
        # Temporal chain backwards from kf_id.
        chain = [kf_id]
        prev = np.asarray(s.kf_prev)
        while len(chain) < window + 1 and prev[chain[-1]] >= 0:
            chain.append(int(prev[chain[-1]]))
        chain = chain[::-1]  # oldest first; chain[0] = anchor (pose-fixed)
        K_real = len(chain)
        if K_real < 3:
            return self._local_ba(kf_id)
        # Pad to a fixed window size with copies of the anchor (fixed, no
        # obs, no edges) so the VI-BA program compiles once.
        K = window + 1
        chain = chain + [chain[0]] * (K - K_real)

        Rbc = np.asarray(self.imu_calib.Rbc)
        tbc = np.asarray(self.imu_calib.tbc)
        kf_R_np = np.asarray(s.kf_R)
        kf_t_np = np.asarray(s.kf_t)
        R_wb = np.zeros((K, 3, 3), np.float32)
        p_wb = np.zeros((K, 3), np.float32)
        for n_, k in enumerate(chain):
            R_wb[n_], p_wb[n_] = isup.cam_to_body(kf_R_np[k], kf_t_np[k], Rbc, tbc)
        state = vi.BodyState(
            R=jnp.asarray(R_wb), p=jnp.asarray(p_wb),
            v=s.kf_vel[jnp.asarray(chain)],
            bg=s.kf_bias_g[jnp.asarray(chain)],
            ba=s.kf_bias_a[jnp.asarray(chain)],
        )
        fixed = np.zeros(K, bool)
        fixed[0] = True
        fixed[K_real:] = True  # padding entries

        # Edges between consecutive REAL chain members with stored
        # preints, padded to K-1 with invalid self-edges (0->0).
        ei, ej, pres, ev = [], [], [], []
        for n_ in range(1, K_real):
            if chain[n_] in self.preints:
                ei.append(n_ - 1)
                ej.append(n_)
                pres.append(self.preints[chain[n_]])
                ev.append(True)
        if len(pres) < 2:
            return self._local_ba(kf_id)
        n_edges = len(pres)
        while len(pres) < K - 1:
            ei.append(0)
            ej.append(0)
            pres.append(pres[0])
            ev.append(False)
        batch = jax.tree_util.tree_map(lambda *xs: jnp.stack(xs), *pres)
        edges = vi.make_imu_edges(
            jnp.asarray(ei, jnp.int32), jnp.asarray(ej, jnp.int32),
            batch, jnp.asarray(ev),
        )

        # Visual observations: window KFs' features on window points.
        win_mp = s.kf_mp[jnp.asarray(chain)]
        wok = win_mp >= 0
        win_mask = jnp.zeros((s.Pmax,), bool).at[jnp.clip(win_mp, 0)].max(wok)
        win_mask &= s.mp_valid
        Nf = s.Nf
        obs_mp = win_mp.reshape(-1)
        obs_cam = jnp.repeat(jnp.arange(K, dtype=jnp.int32), Nf)
        real_row = (jnp.arange(K) < K_real)[:, None].repeat(Nf, 1).reshape(-1)
        obs_valid = (
            (obs_mp >= 0) & s.kf_feat_valid[jnp.asarray(chain)].reshape(-1) & real_row
        )
        obs_oct = s.kf_octave[jnp.asarray(chain)].reshape(-1)
        # Tcb (camera <- body) from Tbc (body <- camera).
        Tcb_R = Rbc.T
        Tcb_t = -Rbc.T @ tbc
        prob = vi.VIProblem(
            state=state, kf_fixed=jnp.asarray(fixed),
            Tcb_R=jnp.asarray(Tcb_R), Tcb_t=jnp.asarray(Tcb_t),
            points=s.mp_pos, point_valid=win_mask,
            obs_cam=obs_cam, obs_point=jnp.clip(obs_mp.reshape(-1), 0),
            obs_uv=s.kf_uv[jnp.asarray(chain)].reshape(-1, 2),
            obs_sigma2=self.sigma2_table[jnp.clip(obs_oct, 0, self.sigma2_table.shape[0] - 1)],
            obs_valid=obs_valid,
            edges=edges,
        )

        res = vi.solve_vi_ba_jit(
            self.model, self.params, prob, iters=iters, pcg_iters=40,
            prior_gyro=prior_gyro, prior_acc=prior_acc,
        )

        # Write back: body -> camera poses, velocities, biases, points.
        newR = np.asarray(res.state.R)
        newp = np.asarray(res.state.p)
        import os as _os
        if _os.environ.get("DEBUG_INIT"):
            dpos = np.linalg.norm(newp[:K_real] - np.asarray(state.p)[:K_real], axis=1)
            print(
                f"  [viba] K={K_real} cost={float(res.cost):.1f} "
                f"inl={int(np.asarray(res.obs_inlier).sum())}/{int(np.asarray(obs_valid).sum())} "
                f"max|dp|={dpos.max():.3f} mean|dp|={dpos.mean():.3f}",
                flush=True,
            )
        ss = self.store.state
        upd_ids, upd_R, upd_t = [], [], []
        for n_, k in enumerate(chain[:K_real]):
            if fixed[n_]:
                continue
            Rcw, tcw = isup.body_to_cam(newR[n_], newp[n_], Rbc, tbc)
            upd_ids.append(k)
            upd_R.append(Rcw)
            upd_t.append(tcw)
        if upd_ids:
            idx = jnp.asarray(upd_ids, jnp.int32)
            ss = ss._replace(
                kf_R=ss.kf_R.at[idx].set(jnp.asarray(np.stack(upd_R), jnp.float32)),
                kf_t=ss.kf_t.at[idx].set(jnp.asarray(np.stack(upd_t), jnp.float32)),
            )
        real = jnp.asarray(chain[:K_real])
        ss = ss._replace(
            kf_vel=ss.kf_vel.at[real].set(res.state.v[:K_real]),
            kf_bias_g=ss.kf_bias_g.at[real].set(res.state.bg[:K_real]),
            kf_bias_a=ss.kf_bias_a.at[real].set(res.state.ba[:K_real]),
            mp_pos=jnp.where(win_mask[:, None], res.points, ss.mp_pos),
        )
        self.store.state = ss
        self.store.bump()

    def _global_ba_small(self, kf_id: int):
        """Initial-map BA: optimize both initial KFs (first fixed)."""
        WIN, FIX = lba_caps(self.store.state.Kmax)
        win = np.full(WIN, -1, np.int32)
        win[0] = kf_id
        fix = np.full(max(FIX // 4, 1), -1, np.int32)
        fix[0] = 0
        new_state, cost, _ = local_ba(
            self.model, self.params, self.store.state,
            jnp.asarray(win), jnp.asarray(fix), self.sigma2_table,
            bf=self.bf, iters=12,
            obs_cap=self.store.state.Nf if self.stereo_like else None,
        )
        self.store.state = new_state

        # Median-depth normalization (`CreateInitialMapMonocular`
        # Tracking.cc:1971-1984): rescale so median depth of KF0 == 1.
        s = self.store.state
        mp_mask = np.asarray(s.mp_valid)
        pos = np.asarray(s.mp_pos)[mp_mask]
        if len(pos):
            z = (np.asarray(s.kf_R[0]) @ pos.T).T + np.asarray(s.kf_t[0])
            med = np.median(z[:, 2])
            if med > 1e-6:
                inv = 1.0 / med
                self.store.state = s._replace(
                    mp_pos=s.mp_pos * inv,
                    kf_t=s.kf_t * inv,
                )
        self.store.bump()
