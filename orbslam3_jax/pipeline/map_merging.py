"""Multi-map merging — the Atlas welding path.

Re-design of `LoopClosing::MergeLocal` (`/root/reference/src/
LoopClosing.cc:1332`): when place recognition matches a keyframe of the
ACTIVE map against a keyframe of a STORED map, the active map is
transformed by the measured Sim3 into the stored map's frame and its
keyframes/points are copied over (slot remap); a weld bundle adjustment
then fuses the seam. The reference's 15-KF welding window becomes a
global BA here (our maps are small enough; windowed weld is an
optimization for later).

Also hosts `transform_map` (Sim3 on a whole map) used by merging and by
gravity alignment checks.
"""

from __future__ import annotations

from typing import Dict, Tuple

import jax.numpy as jnp
import numpy as np

from orbslam3_jax.atlas import store as st
from orbslam3_jax.ops import lie


def transform_map(state: st.MapState, R: jnp.ndarray, t: jnp.ndarray, s: float) -> st.MapState:
    """Apply the world Sim3 x' = s R x + t to every pose/point.

    Camera poses: center c' = S(c), orientation Rwc' = R Rwc =>
    Rcw' = Rcw R^T, tcw' = s tcw - Rcw R^T t. Velocities rotate+scale.
    """
    Rt = R.T
    new_Rcw = state.kf_R @ Rt[None]
    new_tcw = s * state.kf_t - jnp.einsum("kij,j->ki", state.kf_R @ Rt[None], t)
    return state._replace(
        kf_R=new_Rcw,
        kf_t=new_tcw,
        kf_vel=s * jnp.einsum("ij,kj->ki", R, state.kf_vel),
        mp_pos=s * jnp.einsum("ij,pj->pi", R, state.mp_pos) + t[None],
        mp_normal=jnp.einsum("ij,pj->pi", R, state.mp_normal),
        mp_min_dist=state.mp_min_dist * s,
        mp_max_dist=state.mp_max_dist * s,
    )


def merge_maps(
    target: st.MapStore, source: st.MapStore,
    R: np.ndarray, t: np.ndarray, s: float,
) -> Tuple[Dict[int, int], Dict[int, int]]:
    """Copy `source` (transformed by Sim3 into target's frame) into
    `target`. Returns (kf_remap, mp_remap): source slot -> target slot.

    Mirrors `MergeLocal`'s map-content migration
    (`LoopClosing.cc:1550-1800`); the caller runs the weld BA after.
    """
    src = transform_map(source.state, jnp.asarray(R, jnp.float32), jnp.asarray(t, jnp.float32), float(s))
    tgt = target.state

    src_kf = [k for k in range(source.n_kf) if bool(src.kf_valid[k])]
    src_mp = np.flatnonzero(np.asarray(src.mp_valid))
    kf_remap = {k: target.alloc_kf() for k in src_kf}
    mp_slots = target.alloc_mps(len(src_mp))
    mp_remap = {int(p): int(slot) for p, slot in zip(src_mp, mp_slots)}

    # Remap kf_mp references.
    remap_arr = np.full(src.Pmax + 1, -1, np.int32)
    for p, slot in mp_remap.items():
        remap_arr[p] = slot
    src_kf_mp = np.asarray(src.kf_mp)
    prev_np = np.asarray(src.kf_prev)

    for k_src, k_tgt in kf_remap.items():
        row = src_kf_mp[k_src]
        new_row = np.where(row >= 0, remap_arr[np.clip(row, 0, src.Pmax)], -1)
        prev_src = int(prev_np[k_src])
        prev_tgt = kf_remap.get(prev_src, -1)
        tgt = st.add_keyframe(
            tgt, k_tgt, src.kf_R[k_src], src.kf_t[k_src],
            src.kf_uv[k_src], src.kf_ur[k_src], src.kf_octave[k_src],
            src.kf_angle[k_src], src.kf_desc[k_src], src.kf_feat_valid[k_src],
            jnp.asarray(new_row),
            vel=src.kf_vel[k_src], bias_g=src.kf_bias_g[k_src],
            bias_a=src.kf_bias_a[k_src], prev_kf=prev_tgt,
        )
        target.kf_ts[k_tgt] = source.kf_ts[k_src]
        target.kf_frame_id[k_tgt] = source.kf_frame_id[k_src]

    if len(src_mp):
        ids = jnp.asarray(src_mp)
        tgt = st.add_points(
            tgt, jnp.asarray(mp_slots),
            src.mp_pos[ids], src.mp_desc[ids], src.mp_normal[ids],
            src.mp_min_dist[ids], src.mp_max_dist[ids],
            jnp.asarray(
                [kf_remap.get(int(f), -1) for f in np.asarray(src.mp_first_kf)[src_mp]],
                jnp.int32,
            ),
            jnp.ones(len(src_mp), bool),
        )
    target.state = tgt
    target.bump()
    return kf_remap, mp_remap
