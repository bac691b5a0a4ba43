"""Vocabulary persistence: DBoW2-compatible binary + text formats.

The binary format matches the reference fork's loader exactly
(`/root/reference/Thirdparty/DBoW2/DBoW2/TemplatedVocabulary.h:1442,1514`)
so vocabularies produced by either side interoperate. Parsing runs in the
native C++ runtime when available (`native/slamio.cpp`), with a NumPy
fallback.
"""

from __future__ import annotations

import numpy as np
import jax.numpy as jnp

from orbslam3_jax.ops.bow import Vocabulary
from orbslam3_jax.io import native as native_mod

_HEADER_BYTES = 24
_RECORD = 41  # i32 parent + 32B desc + f32 weight + u8 leaf


def _read_binary_numpy(path: str):
    raw = np.fromfile(path, dtype=np.uint8)
    header = raw[:_HEADER_BYTES]
    nb_nodes = header[:4].view(np.uint32)[0]
    k, L = header[8:12].view(np.int32)[0], header[12:16].view(np.int32)[0]
    n = int(nb_nodes) - 1
    body = raw[_HEADER_BYTES : _HEADER_BYTES + n * _RECORD].reshape(n, _RECORD)
    parent = body[:, 0:4].copy().view(np.int32)[:, 0]
    desc = body[:, 4:36].copy()
    weight = body[:, 36:40].copy().view(np.float32)[:, 0]
    is_leaf = body[:, 40] != 0
    return int(k), int(L), parent, desc, weight, is_leaf


def _read_binary_native(path: str):
    lib = native_mod.get_lib()
    if lib is None:
        return None
    import ctypes

    hdr = native_mod.VocabHeader()
    if lib.vocab_read_header(path.encode(), ctypes.byref(hdr)) != 0:
        raise IOError(f"bad vocabulary header: {path}")
    n = int(hdr.nb_nodes) - 1
    parent = np.zeros(n, np.int32)
    desc = np.zeros((n, 32), np.uint8)
    weight = np.zeros(n, np.float32)
    leaf = np.zeros(n, np.uint8)
    rc = lib.vocab_read_nodes(
        path.encode(),
        parent.ctypes.data_as(ctypes.POINTER(ctypes.c_int32)),
        desc.ctypes.data_as(ctypes.POINTER(ctypes.c_uint8)),
        weight.ctypes.data_as(ctypes.POINTER(ctypes.c_float)),
        leaf.ctypes.data_as(ctypes.POINTER(ctypes.c_uint8)),
        n,
    )
    if rc != 0:
        raise IOError(f"vocab_read_nodes failed ({rc}): {path}")
    return int(hdr.k), int(hdr.L), parent, desc, weight, leaf != 0


def load_binary_vocabulary(path: str) -> Vocabulary:
    """Load a DBoW2 binary vocabulary into the flattened tree layout of
    `ops.bow.Vocabulary` (children tables for batched descent)."""
    out = _read_binary_native(path)
    if out is None:
        out = _read_binary_numpy(path)
    return _assemble_vocabulary(*out)


def load_text_vocabulary(path: str) -> Vocabulary:
    """Load a DBoW2 TEXT vocabulary (the stock `ORBvoc.txt` distribution
    format; ref `TemplatedVocabulary::loadFromTextFile`): header
    `k L scoring weighting`, then one node per line:
    `parent is_leaf d0..d31 weight`."""
    with open(path) as f:
        header = f.readline().split()
        k, L = int(header[0]), int(header[1])
        data = np.fromstring(f.read(), sep=" ")
    rec = 2 + 32 + 1
    n = len(data) // rec
    data = data[: n * rec].reshape(n, rec)
    parent = data[:, 0].astype(np.int32)
    is_leaf = data[:, 1] != 0
    desc = data[:, 2:34].astype(np.uint8)
    weight = data[:, 34].astype(np.float32)
    return _assemble_vocabulary(k, L, parent, desc, weight, is_leaf)


def _assemble_vocabulary(k, L, parent, desc, weight, is_leaf) -> Vocabulary:
    """Flatten a parent-array tree into the batched-descent tables of
    `ops.bow.Vocabulary`. Node ids in file order start at 1 (0 = root).
    Children are assigned in file order per parent, vectorized (a Python
    loop costs ~2 s on the stock 1M-node ORBvoc)."""
    n = len(parent)
    n_nodes = n + 1
    children = np.full((n_nodes, k), -1, np.int32)
    # Stable sort by parent keeps file order within each parent group;
    # rank-within-group = position - first-position-of-group.
    order = np.argsort(parent, kind="stable").astype(np.int64)
    ps = parent[order]
    first = np.zeros(n, np.int64)
    if n:
        new_grp = np.flatnonzero(np.r_[True, ps[1:] != ps[:-1]])
        first[new_grp] = new_grp
        first = np.maximum.accumulate(first)
    rank = np.arange(n, dtype=np.int64) - first
    ok = rank < k
    children[ps[ok], rank[ok]] = (order[ok] + 1).astype(np.int32)
    node_desc = np.zeros((n_nodes, 32), np.uint8)
    node_desc[1:] = desc
    node_word = np.full(n_nodes, -1, np.int32)
    word_ids = np.flatnonzero(is_leaf)
    node_word[word_ids + 1] = np.arange(len(word_ids), dtype=np.int32)
    return Vocabulary(
        node_desc=jnp.asarray(node_desc),
        node_children=jnp.asarray(children),
        node_word=jnp.asarray(node_word),
        word_weight=jnp.asarray(weight[word_ids].astype(np.float32)),
        depth=int(L),
        k=int(k),
    )


def save_binary_vocabulary(path: str, voc: Vocabulary):
    """Write our vocabulary in the fork's binary format (parents derived
    from the children table; node order preserved)."""
    children = np.asarray(voc.node_children)
    node_desc = np.asarray(voc.node_desc)
    node_word = np.asarray(voc.node_word)
    word_weight = np.asarray(voc.word_weight)
    n_nodes = len(node_desc)
    parent = np.zeros(n_nodes, np.int32)
    for p in range(n_nodes):
        for c in children[p]:
            if c >= 0:
                parent[c] = p
    is_leaf = node_word >= 0
    weight = np.zeros(n_nodes, np.float32)
    weight[is_leaf] = word_weight[node_word[is_leaf]]

    n = n_nodes - 1
    lib = native_mod.get_lib()
    par = parent[1:].astype(np.int32)
    dsc = node_desc[1:].astype(np.uint8)
    wgt = weight[1:].astype(np.float32)
    lf = is_leaf[1:].astype(np.uint8)
    if lib is not None:
        import ctypes

        rc = lib.vocab_write(
            path.encode(), np.uint32(n_nodes), voc.k, voc.depth, 0, 0,
            par.ctypes.data_as(ctypes.POINTER(ctypes.c_int32)),
            np.ascontiguousarray(dsc).ctypes.data_as(ctypes.POINTER(ctypes.c_uint8)),
            wgt.ctypes.data_as(ctypes.POINTER(ctypes.c_float)),
            lf.ctypes.data_as(ctypes.POINTER(ctypes.c_uint8)),
        )
        if rc != 0:
            raise IOError(f"vocab_write failed ({rc})")
        return
    # NumPy fallback.
    with open(path, "wb") as f:
        f.write(np.asarray([n_nodes, _RECORD], np.uint32).tobytes())
        f.write(np.asarray([voc.k, voc.depth, 0, 0], np.int32).tobytes())
        rec = np.zeros((n, _RECORD), np.uint8)
        rec[:, 0:4] = par.view(np.uint8).reshape(n, 4)
        rec[:, 4:36] = dsc
        rec[:, 36:40] = wgt.view(np.uint8).reshape(n, 4)
        rec[:, 40] = lf
        f.write(rec.tobytes())
