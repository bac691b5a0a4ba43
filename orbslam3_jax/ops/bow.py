"""Bag-of-binary-words vocabulary: batched tree descent + L1 scoring.

Re-design of vendored DBoW2 (`/root/reference/Thirdparty/DBoW2`,
`TemplatedVocabulary.h`): a hierarchical k-medians tree over 256-bit ORB
descriptors (stock: k=10, L=6). Differences from the reference, by design:

* `transform` (feature -> word descent, `TemplatedVocabulary.h:988,1063`)
  is a *batched* loop: all N descriptors descend one level per step, each
  step being a gather + Hamming argmin over k children — no per-feature
  recursion.
* BoW vectors are stored *dense* (`(n_words,)` float32, L1-normalized).
  With our default k=10, L=4 (10k words) a thousand keyframes cost 40 MB —
  cheap on HBM, and database scoring becomes one matmul-shaped op instead
  of DBoW2's inverted-file walk (`KeyFrameDatabase.cc:614`).
* The "direct index" (`FeatureVector`, used by the reference to prune
  SearchByBoW and SearchForTriangulation, `ORBmatcher.cc:323,1138`;
  `Frame.cc:865`) is intentionally dropped: the full Hamming matmul
  scores every pair, while a direct index (sort-by-node + padded block-
  diagonal batched matmul) needs a per-node group-size cap (features
  beyond the cap are unmatched: an accuracy loss the matmul doesn't
  have) and its own layout/scatter code. `scripts/bench_bow_index.py`
  times both on the current device; no GPU measurement is recorded yet.
* No pretrained ORBvoc ships with the reference repo; `build_vocabulary`
  trains a tree from descriptors (hierarchical k-medians with bitwise
  majority centers, `FORB::meanValue` semantics, `FORB.cpp:193`). This
  repo ships its own offline artifact (`assets/ORBvoc_synth.bin`, trained
  by `scripts/train_vocabulary.py` on worlds disjoint from every replayed
  dataset, stored in the reference's binary format) which
  `run_sequence.py` loads by default — the reference's vocabulary
  lifecycle.
"""

from __future__ import annotations

from typing import NamedTuple

import jax
import jax.numpy as jnp
import numpy as np


class Vocabulary(NamedTuple):
    """Flattened vocabulary tree.

    node_desc: (n_nodes, 32) uint8 cluster centers
    node_children: (n_nodes, k) int32 child node ids; -1 = missing.
        A leaf's row is all -1.
    node_word: (n_nodes,) int32 word id for leaves, -1 otherwise
    word_weight: (n_words,) float32 idf weights
    depth: python int (levels of descent)
    """

    node_desc: jnp.ndarray
    node_children: jnp.ndarray
    node_word: jnp.ndarray
    word_weight: jnp.ndarray
    depth: int
    k: int

    @property
    def n_words(self):
        return self.word_weight.shape[0]


def save_npz(path: str, voc: Vocabulary):
    """Cache a trained vocabulary (npz; cheap-to-load complement of the
    DBoW2 binary/text interop in `io/vocab_io.py`)."""
    np.savez_compressed(
        path, node_desc=np.asarray(voc.node_desc),
        node_children=np.asarray(voc.node_children),
        node_word=np.asarray(voc.node_word),
        word_weight=np.asarray(voc.word_weight),
        depth=voc.depth, k=voc.k,
    )


def load_npz(path: str) -> Vocabulary:
    d = np.load(path)
    return Vocabulary(
        node_desc=jnp.asarray(d["node_desc"]),
        node_children=jnp.asarray(d["node_children"]),
        node_word=jnp.asarray(d["node_word"]),
        word_weight=jnp.asarray(d["word_weight"]),
        depth=int(d["depth"]), k=int(d["k"]),
    )


# ---------------------------------------------------------------------------
# Training (host-side NumPy; offline one-time cost)
# ---------------------------------------------------------------------------


def _popcount_table():
    return np.unpackbits(np.arange(256, dtype=np.uint8)[:, None], axis=1).sum(1)


_POP = _popcount_table()


def _hamming_np(a: np.ndarray, b: np.ndarray) -> np.ndarray:
    """(N,32) x (M,32) -> (N,M) uint16."""
    x = a[:, None, :] ^ b[None, :, :]
    return _POP[x].sum(-1)


def _majority_center(desc: np.ndarray) -> np.ndarray:
    """Bitwise majority vote (FORB::meanValue)."""
    bits = np.unpackbits(desc, axis=1)  # (N,256)
    maj = (bits.sum(0) * 2 >= len(desc)).astype(np.uint8)
    return np.packbits(maj)


def _kmedians(desc: np.ndarray, k: int, rng: np.random.Generator, iters: int = 8):
    """Binary k-medians with kmeans++-style seeding. Returns (centers,
    assignment)."""
    n = len(desc)
    if n <= k:
        return desc.copy(), np.arange(n)
    centers = [desc[rng.integers(n)]]
    d_min = None
    for _ in range(k - 1):
        d = _hamming_np(desc, np.stack(centers[-1:]))[:, 0].astype(np.float64)
        d_min = d if d_min is None else np.minimum(d_min, d)
        probs = d_min**2
        s = probs.sum()
        if s <= 0:
            centers.append(desc[rng.integers(n)])
        else:
            centers.append(desc[rng.choice(n, p=probs / s)])
    centers = np.stack(centers)
    assign = np.zeros(n, np.int64)
    for _ in range(iters):
        assign = _hamming_np(desc, centers).argmin(1)
        for c in range(len(centers)):
            members = desc[assign == c]
            if len(members):
                centers[c] = _majority_center(members)
    return centers, assign


def build_vocabulary(
    descriptors: np.ndarray, k: int = 10, depth: int = 4, seed: int = 0
) -> Vocabulary:
    """Train a k^depth-word tree (`TemplatedVocabulary::create`).

    descriptors: (N, 32) uint8 training set.
    """
    rng = np.random.default_rng(seed)
    node_desc = [np.zeros(32, np.uint8)]  # root (desc unused)
    node_children = [[]]
    node_word = [-1]

    def recurse(node_id, desc, level):
        if level == depth or len(desc) <= 1:
            node_word[node_id] = 0  # placeholder; word ids assigned later
            return
        centers, assign = _kmedians(desc, k, rng)
        for c in range(len(centers)):
            child_id = len(node_desc)
            node_desc.append(centers[c])
            node_children.append([])
            node_word.append(-1)
            node_children[node_id].append(child_id)
            members = desc[assign == c]
            recurse(child_id, members, level + 1)

    recurse(0, np.asarray(descriptors, np.uint8), 0)

    # Assign word ids to leaves.
    n_nodes = len(node_desc)
    word_ids = np.full(n_nodes, -1, np.int32)
    wc = 0
    for i in range(n_nodes):
        if node_word[i] == 0 or (i > 0 and not node_children[i]):
            word_ids[i] = wc
            wc += 1
    children = np.full((n_nodes, k), -1, np.int32)
    for i, ch in enumerate(node_children):
        children[i, : len(ch)] = ch

    # idf weights from the training corpus (uniform tf here; DBoW2 uses
    # TF_IDF with idf = log(N / n_i) computed on training images — without
    # image boundaries we default to uniform weights, refined by
    # `reweight_idf` when corpus stats exist).
    weights = np.ones(wc, np.float32)
    return Vocabulary(
        node_desc=jnp.asarray(np.stack(node_desc)),
        node_children=jnp.asarray(children),
        node_word=jnp.asarray(word_ids),
        word_weight=jnp.asarray(weights),
        depth=depth,
        k=k,
    )


# ---------------------------------------------------------------------------
# Batched transform + scoring (device)
# ---------------------------------------------------------------------------


def _hamming_rows(a: jnp.ndarray, b: jnp.ndarray) -> jnp.ndarray:
    """(N,32) vs (N,k,32) -> (N,k) popcount distances."""
    x = jnp.bitwise_xor(a[:, None, :], b)
    return jnp.sum(jax.lax.population_count(x.astype(jnp.uint8)), axis=-1)


def transform(voc: Vocabulary, desc: jnp.ndarray, valid: jnp.ndarray) -> jnp.ndarray:
    """Descend all descriptors to leaf word ids. Returns (N,) int32 word
    ids (-1 for invalid descriptors)."""
    N = desc.shape[0]
    cur = jnp.zeros(N, jnp.int32)  # root

    for _ in range(voc.depth):
        ch = voc.node_children[cur]  # (N,k)
        has_child = ch >= 0
        ch_safe = jnp.maximum(ch, 0)
        cd = voc.node_desc[ch_safe]  # (N,k,32)
        d = _hamming_rows(desc, cd)
        d = jnp.where(has_child, d, 10_000)
        nxt = jnp.take_along_axis(ch_safe, jnp.argmin(d, axis=1)[:, None], axis=1)[:, 0]
        # Stay put at leaves (no children).
        at_leaf = ~jnp.any(has_child, axis=1)
        cur = jnp.where(at_leaf, cur, nxt)

    words = voc.node_word[cur]
    return jnp.where(valid, words, -1)


def bow_vector(voc: Vocabulary, words: jnp.ndarray) -> jnp.ndarray:
    """Dense L1-normalized tf-idf vector (n_words,)."""
    ok = words >= 0
    w = jnp.clip(words, 0)
    tf = jnp.zeros(voc.n_words, jnp.float32).at[w].add(ok.astype(jnp.float32))
    v = tf * voc.word_weight
    n = jnp.sum(jnp.abs(v))
    return v / jnp.where(n > 0, n, 1.0)


def score_l1(q: jnp.ndarray, db: jnp.ndarray) -> jnp.ndarray:
    """DBoW2 L1 similarity (`ScoringObject.cpp`): for L1-normalized a, b:
    s = 1 - 0.5 * |a - b|_1, in [0, 1]. q: (W,), db: (K, W) -> (K,)."""
    l1 = jnp.sum(jnp.abs(db - q[None, :]), axis=-1)
    return 1.0 - 0.5 * l1


def shared_words(q_words: jnp.ndarray, db_word_mask: jnp.ndarray) -> jnp.ndarray:
    """Count of query words present per DB entry (the reference's first
    filter, `KeyFrameDatabase.cc:640-668`). db_word_mask: (K, W) bool."""
    ok = q_words >= 0
    w = jnp.clip(q_words, 0)
    q_mask = jnp.zeros(db_word_mask.shape[1], bool).at[w].set(ok)
    return jnp.sum(db_word_mask & q_mask[None, :], axis=-1)
