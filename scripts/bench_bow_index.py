"""DECISION MEASUREMENT: BoW direct-index (FeatureVector) match pruning
vs the full Hamming matmul.

The reference prunes `SearchByBoW`/`SearchForTriangulation` candidate
pairs with the vocabulary's direct index: features are grouped by their
node at level L-levelsup (levelsup=4) and only same-node pairs are scored
(`/root/reference/src/ORBmatcher.cc:323,1138`; `Frame.cc:865`
`TemplatedVocabulary::transform` returning a FeatureVector). This repo
replaced that with the full (N,M) bit-matmul (`ops/bow.py`,
`ops/matching.py::hamming_matrix`) — defensible at 1k features, but the
round-3 verdict asked for the MEASUREMENT at the 5k-feature init budget
and at Atlas-scale batched KF pairs before keeping it.

The direct-index variant measured here: sort both feature sets
by node id, pad each node's group to a fixed size G, then ONE batched
(n_nodes, G, G) block-diagonal matmul — the gather/sort is part of its
cost, exactly as it would be in production.

Prints one JSON line with ms per variant per shape on JAX's default
device; only a run on the accelerator gives numbers worth keeping.
"""

import json
import os
import sys
import time

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, REPO)
os.environ.setdefault("TF_CPP_MIN_LOG_LEVEL", "3")

import jax

from orbslam3_jax.utils import enable_compile_cache

enable_compile_cache()

import numpy as np
import jax.numpy as jnp

from orbslam3_jax.ops import matching


def full_matmul_match(da, db):
    d = matching.hamming_matrix(da, db)
    best = jnp.argmin(d, axis=1)
    return best, jnp.min(d, axis=1)


def node_grouped_match(da, db, nodes_a, nodes_b, n_nodes: int, G: int):
    """Direct-index pruned match: only same-node pairs are scored.

    Layout cost included: one argsort per side + scatter into (n_nodes, G)
    padded groups, then a batched (n_nodes, G, G) Hamming via vmap.
    Features beyond a node's G-slot budget are DROPPED — the direct
    index's accuracy/size tradeoff (the reference's std::map grouping has
    no cap but is a scalar walk)."""
    def group(desc, nodes):
        order = jnp.argsort(nodes)
        nodes_s = nodes[order]
        # rank within the node's run
        idx_in = jnp.arange(nodes.shape[0]) - jnp.searchsorted(
            nodes_s, nodes_s, side="left"
        )
        slot = nodes_s * G + jnp.minimum(idx_in, G - 1)
        gd = jnp.zeros((n_nodes * G, 32), jnp.uint8).at[slot].set(desc[order])
        gsrc = jnp.full((n_nodes * G,), -1, jnp.int32).at[slot].set(
            order.astype(jnp.int32)
        )
        return gd.reshape(n_nodes, G, 32), gsrc.reshape(n_nodes, G)

    ga, src_a = group(da, nodes_a)
    gb, src_b = group(db, nodes_b)
    d = jax.vmap(matching.hamming_matrix)(ga, gb)  # (n_nodes, G, G)
    d = jnp.where((src_a[..., None] >= 0) & (src_b[:, None, :] >= 0), d, 1e9)
    best_col = jnp.argmin(d, axis=2)  # (n_nodes, G)
    best_d = jnp.min(d, axis=2)
    # Scatter back to per-feature-of-A results.
    N = da.shape[0]
    out_idx = jnp.full(N, -1, jnp.int32)
    out_d = jnp.full(N, 1e9)
    flat_a = src_a.reshape(-1)
    flat_best = jnp.take_along_axis(
        src_b, best_col, axis=1
    ).reshape(-1)
    flat_d = best_d.reshape(-1)
    ok = flat_a >= 0
    out_idx = out_idx.at[jnp.where(ok, flat_a, N - 1)].set(
        jnp.where(ok, flat_best, -1)
    )
    out_d = out_d.at[jnp.where(ok, flat_a, N - 1)].set(jnp.where(ok, flat_d, 1e9))
    return out_idx, out_d


def bench(fn, args, reps=20):
    f = jax.jit(fn)
    out = f(*args)
    jax.block_until_ready(out)
    best = float("inf")
    for _ in range(reps):
        t0 = time.perf_counter()
        out = f(*args)
        jax.block_until_ready(out)
        best = min(best, time.perf_counter() - t0)
    return best * 1e3


def main():
    rng = np.random.default_rng(0)
    n_nodes = 100  # k=10 depth=4 vocab grouped at level 2 (ref levelsup=4)
    results = {"device": jax.devices()[0].platform}
    for (tag, N, M, G) in (
        ("track_1k", 1024, 1024, 32),
        ("init_5k", 5120, 5120, 128),
    ):
        da = jnp.asarray(rng.integers(0, 256, (N, 32), dtype=np.uint8))
        db = jnp.asarray(rng.integers(0, 256, (M, 32), dtype=np.uint8))
        na = jnp.asarray(rng.integers(0, n_nodes, N).astype(np.int32))
        nb = jnp.asarray(rng.integers(0, n_nodes, M).astype(np.int32))
        t_full = bench(full_matmul_match, (da, db))
        t_node = bench(
            lambda a, b, x, y: node_grouped_match(a, b, x, y, n_nodes, G),
            (da, db, na, nb),
        )
        results[tag] = {"full_matmul_ms": round(t_full, 3),
                        "node_grouped_ms": round(t_node, 3)}

    # Atlas-scale batched KF-pair matching (SearchByBoW over B pairs).
    B, N = 32, 1024
    da = jnp.asarray(rng.integers(0, 256, (B, N, 32), dtype=np.uint8))
    db = jnp.asarray(rng.integers(0, 256, (B, N, 32), dtype=np.uint8))
    t_full_b = bench(
        lambda a, b: jax.vmap(full_matmul_match)(a, b), (da, db)
    )
    results["atlas_32x1k_pairs"] = {"full_matmul_ms": round(t_full_b, 3)}
    print(json.dumps(results))


if __name__ == "__main__":
    main()
