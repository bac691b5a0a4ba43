"""Sharded keyframe-database query over a device mesh.

The Atlas-wide place-recognition query (SURVEY.md §5.8: "sharded
KF-database scoring — each host scores its KF shard, top-k gathered"):
the (K, n_words) BoW matrix is sharded along K; each device computes
shared-word counts + L1 scores for its shard and the per-shard top-k is
all-gathered. Unlike the loop-closing query (which needs covisibility
grouping and runs fine on one chip), this path scales to Atlas sizes
where the BoW matrix itself is sharded storage.
"""

from __future__ import annotations

import functools

import jax
import jax.numpy as jnp
import numpy as np
from jax.sharding import Mesh, PartitionSpec as P

from orbslam3_jax.ops import bow as bow_ops

AXIS = "kf"


def make_mesh(devices=None, axis: str = AXIS) -> Mesh:
    devices = devices if devices is not None else jax.devices()
    return Mesh(np.asarray(devices), (axis,))


def sharded_query(
    q_vec: jnp.ndarray,  # (W,) replicated query BoW vector
    q_words: jnp.ndarray,  # (Nf,) replicated query word ids
    db_vecs: jnp.ndarray,  # (K, W) — shard along K
    db_valid: jnp.ndarray,  # (K,)
    mesh: Mesh,
    n_best: int = 5,
):
    """Top-N (score, kf_id) over the sharded database.

    Per shard: mask by shared-word count filter, L1 score, local top-k;
    then one all_gather of (n_best,) candidates and a final replicated
    top-k. Communication: O(devices * n_best) floats.
    """
    axis = mesh.axis_names[0]
    n_dev = mesh.devices.size
    K = db_vecs.shape[0]
    pad = (-K) % n_dev
    if pad:
        db_vecs = jnp.concatenate([db_vecs, jnp.zeros((pad, db_vecs.shape[1]), db_vecs.dtype)])
        db_valid = jnp.concatenate([db_valid, jnp.zeros(pad, bool)])
    Kp = db_vecs.shape[0]

    @functools.partial(
        jax.shard_map,
        mesh=mesh,
        in_specs=(P(), P(), P(axis), P(axis)),
        out_specs=(P(), P()),
        check_vma=False,
    )
    def _run(qv, qw, vecs, valid):
        shard = vecs.shape[0]
        my = jax.lax.axis_index(axis)
        word_mask = vecs > 0
        shared = bow_ops.shared_words(qw, word_mask)
        # Global 0.8*max-common filter needs the global max: one pmax.
        local_max = jnp.max(jnp.where(valid, shared, 0))
        global_max = jax.lax.pmax(local_max, axis)
        eligible = valid & (shared >= jnp.maximum((0.8 * global_max).astype(shared.dtype), 1))
        scores = jnp.where(eligible, bow_ops.score_l1(qv, vecs), -1.0)
        k_local = min(n_best, shard)  # small shards can't yield n_best each
        top_s, top_i = jax.lax.top_k(scores, k_local)
        top_ids = top_i + my * shard
        # Gather all shards' candidates.
        all_s = jax.lax.all_gather(top_s, axis).reshape(-1)
        all_i = jax.lax.all_gather(top_ids, axis).reshape(-1)
        best_s, sel = jax.lax.top_k(all_s, min(n_best, all_s.shape[0]))
        pad_n = n_best - best_s.shape[0]
        if pad_n > 0:
            best_s = jnp.concatenate([best_s, jnp.full(pad_n, -1.0)])
            sel = jnp.concatenate([sel, jnp.zeros(pad_n, sel.dtype)])
        return all_i[sel], best_s

    ids, scores = jax.jit(_run)(q_vec, q_words, db_vecs, db_valid)
    ids = jnp.where(scores > 0, ids, -1)
    return ids, scores
