"""Fused Hamming top-2 kernel (Pallas, Triton route) vs the plain
references, run in the Pallas interpreter on the CPU — bit-exact
(distances are small integers; both paths are lossless). The kernel's
compiled form is checked on the GPU by `chip_smoke.py`."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest

from orbslam3_jax.ops import matching
from orbslam3_jax.ops import pallas_match as pm

# Kernel settings under test: production, and small blocks that force
# several query blocks and key tiles at test sizes.
BLOCKS = {"prod": {}, "small": dict(block_q=16, block_k=32, num_warps=4,
                                     num_stages=1)}


def _rand_desc(rng, n):
    return jnp.asarray(rng.integers(0, 256, (n, 32), dtype=np.uint8))


def _reference_top2(da, db, vb, mask=None):
    """XOR+popcount distances, masked, then `best_two` (top_k)."""
    D = matching._mask_matrix(matching.hamming_matrix_xor(da, db), None, vb)
    if mask is not None:
        D = jnp.where(mask, D, matching.INF)
    return [np.asarray(x) for x in matching.best_two(D)]


def _kernel_top2(da, db, vb, window=None, **kw):
    if window is None:  # every key admissible
        n, m = da.shape[0], db.shape[0]
        window = pm.search_window(n, m, jnp.zeros((n, 2)), jnp.zeros((m, 2)),
                                  1.0, None, None, None)
    out = pm.hamming_top2(da, db, vb, window, interpret=True, **kw)
    return [np.asarray(x) for x in out]


def _random_window(rng, n, m, img=640.0, rad=(30, 120)):
    return pm.MatchWindow(
        uv_q=jnp.asarray(rng.uniform(0, img, (n, 2)), jnp.float32),
        uv_k=jnp.asarray(rng.uniform(0, img, (m, 2)), jnp.float32),
        radius_q=jnp.asarray(rng.uniform(*rad, (n,)), jnp.float32),
        octave_k=jnp.asarray(rng.integers(0, 8, (m,)), jnp.int32),
        octave_lo=jnp.asarray(rng.integers(0, 4, (n,)), jnp.int32),
        octave_hi=jnp.asarray(rng.integers(4, 8, (n,)), jnp.int32),
    )


def _window_mask(w):
    return matching.window_mask(w.uv_q, w.uv_k, w.radius_q, w.octave_k,
                                w.octave_lo, w.octave_hi)


@pytest.mark.parametrize("n,m", [(64, 256), (100, 777), (300, 1500)])
def test_top2_matches_xla(n, m):
    rng = np.random.default_rng(n + m)
    da, db = _rand_desc(rng, n), _rand_desc(rng, m)
    vb = jnp.asarray(rng.random(m) > 0.2)
    ref = _reference_top2(da, db, vb)
    for blocks in BLOCKS.values():
        got = _kernel_top2(da, db, vb, **blocks)
        for g, r in zip(got, ref):
            np.testing.assert_array_equal(g, r)


@pytest.mark.parametrize("blocks", BLOCKS)
@pytest.mark.parametrize("n,m", [(1, 2), (7, 129), (65, 3), (130, 513)])
def test_top2_ragged_windowed(blocks, n, m):
    """Sizes that are not block multiples, on both axes, with the window
    and octave gates."""
    rng = np.random.default_rng(10 * n + m)
    da, db = _rand_desc(rng, n), _rand_desc(rng, m)
    vb = jnp.asarray(rng.random(m) > 0.1)
    w = _random_window(rng, n, m, img=200.0)
    ref = _reference_top2(da, db, vb, _window_mask(w))
    got = _kernel_top2(da, db, vb, w, **BLOCKS[blocks])
    for g, r in zip(got, ref):
        np.testing.assert_array_equal(g, r)


@pytest.mark.parametrize("blocks", BLOCKS)
def test_top2_all_keys_invalid(blocks):
    rng = np.random.default_rng(5)
    da, db = _rand_desc(rng, 40), _rand_desc(rng, 90)
    vb = jnp.zeros(90, bool)
    got = _kernel_top2(da, db, vb, **BLOCKS[blocks])
    np.testing.assert_array_equal(got[0], np.full(40, pm.INF, np.float32))
    np.testing.assert_array_equal(got[1], np.full(40, pm.INF, np.float32))
    for g, r in zip(got, _reference_top2(da, db, vb)):
        np.testing.assert_array_equal(g, r)


@pytest.mark.parametrize("blocks", BLOCKS)
def test_top2_empty_windows(blocks):
    """Rows whose window holds no key (off-image or negative radius) get
    INF distances, as in the masked matrix; other rows are unaffected."""
    rng = np.random.default_rng(6)
    n, m = 50, 200
    da, db = _rand_desc(rng, n), _rand_desc(rng, m)
    vb = jnp.ones(m, bool)
    w = _random_window(rng, n, m)
    uv_q = np.asarray(w.uv_q).copy()
    uv_q[::3] = -1e4
    rad = np.asarray(w.radius_q).copy()
    rad[1::3] = -1.0
    w = w._replace(uv_q=jnp.asarray(uv_q), radius_q=jnp.asarray(rad))
    ref = _reference_top2(da, db, vb, _window_mask(w))
    got = _kernel_top2(da, db, vb, w, **BLOCKS[blocks])
    assert np.all(got[0][::3] == pm.INF) and np.all(got[0][1::3] == pm.INF)
    assert np.all(got[0][2::3] < pm.INF)
    for g, r in zip(got, ref):
        np.testing.assert_array_equal(g, r)


def _sbp_case(rng, n=90, m=600):
    da, db = _rand_desc(rng, n), _rand_desc(rng, m)
    va = jnp.asarray(rng.random(n) > 0.1)
    vb = jnp.asarray(rng.random(m) > 0.1)
    w = _random_window(rng, n, m)
    args = (da, w.uv_q, va, db, w.uv_k, vb, w.radius_q)
    kw = dict(octave_kp=w.octave_k, octave_lo=w.octave_lo,
              octave_hi=w.octave_hi, max_dist=80.0, ratio=0.85)
    return args, kw


def _interpreted(monkeypatch, blocks=None):
    """Route `search_by_projection`'s kernel call through the interpreter
    and record the calls."""
    calls = []
    kernel = pm.hamming_top2

    def fake(*a, **k):
        calls.append(a[0].shape)
        return kernel(*a, interpret=True, **(blocks or {}), **k)

    monkeypatch.setattr(pm, "hamming_top2", fake)
    return calls


def test_windowed_matches_search_by_projection(monkeypatch):
    """`search_by_projection` gives identical Matches on the fused path
    (kernel interpreted) and on the matrix path."""
    args, kw = _sbp_case(np.random.default_rng(7))
    ref = matching.search_by_projection(*args, **kw)
    for blocks in BLOCKS.values():
        with monkeypatch.context() as mp:
            calls = _interpreted(mp, blocks)
            matching.use_fused_projection(True)
            try:
                got = matching.search_by_projection(*args, **kw)
            finally:
                matching.use_fused_projection(None)
        assert calls
        for g, r in zip(got, ref):
            np.testing.assert_array_equal(np.asarray(g), np.asarray(r))


def test_search_by_projection_no_octave_gate(monkeypatch):
    """Without octave arguments the fused path applies the pixel window
    alone, as `window_mask` does."""
    args, kw = _sbp_case(np.random.default_rng(8), n=70, m=300)
    kw = dict(max_dist=90.0, ratio=0.9)
    ref = matching.search_by_projection(*args, **kw)
    calls = _interpreted(monkeypatch)
    matching.use_fused_projection(True)
    try:
        got = matching.search_by_projection(*args, **kw)
    finally:
        matching.use_fused_projection(None)
    assert calls
    for g, r in zip(got, ref):
        np.testing.assert_array_equal(np.asarray(g), np.asarray(r))


@pytest.mark.parametrize(
    "backend,n,expect_kernel",
    [("gpu", 8192, True), ("gpu", 64, False), ("cpu", 8192, False)],
)
def test_dispatch_by_backend(monkeypatch, backend, n, expect_kernel):
    """The kernel is chosen on the `gpu` backend for problems of at least
    FUSED_MIN_PAIRS pairs; any other backend, or a small problem, takes
    the matrix path."""
    rng = np.random.default_rng(9)
    args, kw = _sbp_case(rng, n=n, m=512)
    calls = []

    def stub(desc_q, *a, **k):
        calls.append(desc_q.shape)
        full = jnp.full((desc_q.shape[0],), pm.INF, jnp.float32)
        return full, full, jnp.zeros((desc_q.shape[0],), jnp.int32)

    monkeypatch.setattr(pm, "hamming_top2", stub)
    monkeypatch.setattr(jax, "default_backend", lambda: backend)
    assert matching._fused_enabled(n * 512) == expect_kernel
    matching.search_by_projection(*args, **kw)
    assert calls == ([(n, 32)] if expect_kernel else [])
