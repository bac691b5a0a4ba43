"""Keyframe database: place-recognition index over the Atlas.

Re-design of `/root/reference/src/KeyFrameDatabase.cc`: the reference
keeps an inverted file word -> list<KF> and walks it per query (`:614`).
Here every KF's BoW vector is one row of a dense (Kmax, n_words) matrix;
a query is:

1. shared-word counts  — one masked matmul (`:640-668`),
2. 0.8 * max-common filter (`:668`),
3. L1 similarity scores — one broadcast reduction (`:677`),
4. covisibility-group accumulation (`:695-720`) — a masked matmul with
   the covisibility indicator,
5. top-N selection (`:742`).

All five steps are one jitted program; sharding the K axis across devices
turns step 1-4 into per-shard work + a top-k gather (see parallel/).
"""

from __future__ import annotations

import functools
from typing import Optional

import jax
import jax.numpy as jnp
import numpy as np

from orbslam3_jax.ops import bow as bow_ops


@functools.partial(jax.jit, static_argnames=("n_best",))
def detect_candidates(
    q_vec: jnp.ndarray,  # (W,) query BoW
    q_words: jnp.ndarray,  # (Nf,) query word ids (-1 invalid)
    db_vecs: jnp.ndarray,  # (K, W) keyframe BoW matrix
    db_valid: jnp.ndarray,  # (K,)
    exclude: jnp.ndarray,  # (K,) bool — connected KFs + self (ref :634)
    covis: jnp.ndarray,  # (K, K) covisibility weights (for grouping)
    n_best: int = 3,
):
    """`DetectNBestCandidates` (`KeyFrameDatabase.cc:614`). Returns
    (cand_ids (n_best,), cand_scores (n_best,)); ids are -1 where no
    candidate passed the filters."""
    K = db_vecs.shape[0]
    word_mask = db_vecs > 0
    shared = bow_ops.shared_words(q_words, word_mask)  # (K,)
    eligible = db_valid & ~exclude & (shared > 0)
    max_common = jnp.max(jnp.where(eligible, shared, 0))
    min_common = (0.8 * max_common).astype(shared.dtype)
    eligible &= shared >= jnp.maximum(min_common, 1)

    scores = bow_ops.score_l1(q_vec, db_vecs)  # (K,)
    scores = jnp.where(eligible, scores, 0.0)

    # Covisibility-group accumulation: group score of k = sum of scores of
    # k's 10-best covisible neighbours (+ itself); candidate = the best
    # scoring member of the group.
    top_w = jax.lax.top_k(covis, 10)[0][:, -1:]  # weight of 10th neighbour
    neigh = (covis >= jnp.maximum(top_w, 1)) & (covis > 0)
    neigh = neigh | jnp.eye(K, dtype=bool)
    acc = jnp.dot(neigh.astype(jnp.float32), scores[:, None])[:, 0]
    acc = jnp.where(eligible, acc, 0.0)
    # Best member per group (row): argmax over members' individual scores.
    member_scores = jnp.where(neigh, scores[None, :], -1.0)
    best_member = jnp.argmax(member_scores, axis=1)

    # Top-N groups, dedup by best member.
    top_acc, top_rows = jax.lax.top_k(acc, n_best * 3)
    cands = best_member[top_rows]
    cand_scores = scores[cands]
    ok = top_acc > 0
    # Dedup: keep first occurrence.
    def dedup(i, carry):
        out_ids, out_sc, n = carry
        c = cands[i]
        sc = cand_scores[i]
        is_dup = jnp.any(out_ids[:n_best] == c)
        take = ok[i] & ~is_dup & (n < n_best)
        out_ids = jnp.where(take, out_ids.at[n].set(c), out_ids)
        out_sc = jnp.where(take, out_sc.at[n].set(sc), out_sc)
        return (out_ids, out_sc, n + take.astype(jnp.int32))

    init = (jnp.full(n_best, -1, jnp.int32), jnp.zeros(n_best), jnp.asarray(0, jnp.int32))
    out_ids, out_sc, _ = jax.lax.fori_loop(0, n_best * 3, dedup, init)
    return out_ids, out_sc


class KeyFrameDB:
    """Host wrapper owning the dense BoW matrix (one per Atlas)."""

    def __init__(self, voc: bow_ops.Vocabulary, Kmax: int = 256):
        self.voc = voc
        self.vecs = jnp.zeros((Kmax, voc.n_words), jnp.float32)
        self.valid = jnp.zeros(Kmax, bool)
        self.words = jnp.full((Kmax, 1), -1, jnp.int32)  # resized on first add
        self._Nf = None

    def add(self, kf_id: int, desc: jnp.ndarray, feat_valid: jnp.ndarray):
        """`KeyFrameDatabase::add` (`KeyFrameDatabase.cc:41`)."""
        words = bow_ops.transform(self.voc, desc, feat_valid)
        vec = bow_ops.bow_vector(self.voc, words)
        if self._Nf is None:
            self._Nf = desc.shape[0]
            self.words = jnp.full((self.vecs.shape[0], self._Nf), -1, jnp.int32)
        kf_j = jnp.asarray(kf_id)
        self.vecs = self.vecs.at[kf_j].set(vec)
        self.words = self.words.at[kf_j].set(words)
        self.valid = self.valid.at[kf_j].set(True)
        return words, vec

    def erase(self, kf_id: int):
        self.valid = self.valid.at[jnp.asarray(kf_id)].set(False)

    def query(self, kf_id: int, covis: jnp.ndarray, n_best: int = 3, min_covis: int = 15):
        """Loop/merge candidates for keyframe `kf_id`, excluding its
        covisible neighbourhood (ref `LoopClosing.cc:513`)."""
        kf_j = jnp.asarray(kf_id)
        exclude = covis[kf_j] >= min_covis
        exclude = exclude.at[kf_j].set(True)
        return detect_candidates(
            self.vecs[kf_j], self.words[kf_j], self.vecs, self.valid, exclude, covis, n_best
        )

    def query_frame(self, desc, feat_valid, covis: jnp.ndarray, n_best: int = 5):
        """Relocalization candidates for a (non-keyframe) frame
        (`DetectRelocalizationCandidates`, `KeyFrameDatabase.cc:785`)."""
        words = bow_ops.transform(self.voc, desc, feat_valid)
        vec = bow_ops.bow_vector(self.voc, words)
        K = self.vecs.shape[0]
        return detect_candidates(
            vec, words, self.vecs, self.valid, jnp.zeros(K, bool), covis, n_best
        )

    def query_frame_sharded(self, desc, feat_valid, dist, n_best: int = 5):
        """Same query scored over a device mesh: the (K, n_words) BoW
        matrix is sharded along K and each shard's top-k is all-gathered
        (SURVEY §5.8 "each host scores its KF shard"). Used by the Atlas
        merge path when a DistributedContext is enabled — at Atlas scale
        the stored maps' BoW matrices are the state worth sharding.
        Covisibility-group accumulation is skipped (candidates are Sim3-
        verified individually downstream)."""
        words = bow_ops.transform(self.voc, desc, feat_valid)
        vec = bow_ops.bow_vector(self.voc, words)
        return dist.kfdb_query(vec, words, self.vecs, self.valid, n_best=n_best)
