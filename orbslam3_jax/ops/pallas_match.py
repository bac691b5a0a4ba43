"""Fused Hamming distance + top-2 for the projection search: a Pallas
kernel for NVIDIA GPUs, compiled through Triton.

The plain path of `matching.search_by_projection` builds the (N, M)
distance matrix in device memory and reads it back in `top_k`; at the
local-map size (65536 map points x ~1000 keypoints) that is ~260 MB
written and read per call. Here one program owns a block of query rows.
It loops over key tiles, evaluates the pixel window and octave gates in
registers (the mask of `matching.window_mask`), and keeps a running
(best, second-best) per row, so neither the matrix nor the mask is ever
stored.

Each candidate is packed into one int32 sort key, `distance << 16 |
column`. The smallest key is the best distance with the lowest column on
ties, which is what `lax.top_k` returns, and the second-smallest key
carries the second-best distance. Gated-out candidates get distance 257,
above any Hamming distance of 256-bit descriptors, so a row with an empty
window yields (INF, INF, column 0) exactly as the plain path does. The
results are bit-exact with the plain path.

Distances are XOR + population count over the eight 32-bit words of each
descriptor, so 32 bytes move per descriptor. A bf16 bit-product form on
the tensor cores (`pl.dot` over 256 {0,1} planes) ran no faster inside
the tracking program on the H100 and was dropped (PERF.md).
"""

from __future__ import annotations

import functools
from typing import NamedTuple, Optional, Tuple

import jax
import jax.numpy as jnp
from jax.experimental import pallas as pl
from jax.experimental.pallas import triton as pl_triton

INF = 1e9  # distance reported for a row with no admissible candidate

# Production setting: query rows per program (the grid runs over query
# blocks), keys per step of the in-kernel loop, and the Triton launch
# parameters. Chosen by `scripts/bench_match.py --sweep` on the H100
# (PERF.md).
CONFIG = dict(block_q=32, block_k=128, num_warps=8, num_stages=2)

_GATED = 257  # distance of a gated-out candidate (> any Hamming distance)
_COL_BITS = 16
_EMPTY = (_GATED + 1) << _COL_BITS  # initial running minimum
_MAX_KEYS = 1 << _COL_BITS
_OCT_OPEN = 1 << 20  # octave bound standing for "no gate"


class MatchWindow(NamedTuple):
    """Per-query / per-key attributes of the projection search window
    (`Frame::GetFeaturesInArea`, ref `Frame.cc:755`)."""

    uv_q: jnp.ndarray  # (N, 2) predicted pixel positions of the queries
    uv_k: jnp.ndarray  # (M, 2) keypoint pixel positions
    radius_q: jnp.ndarray  # (N,) search radius per query (pixels)
    octave_k: jnp.ndarray  # (M,) keypoint octave
    octave_lo: jnp.ndarray  # (N,) inclusive lower octave gate
    octave_hi: jnp.ndarray  # (N,) inclusive upper octave gate


def _kernel(q_ref, uq_ref, vq_ref, rq_ref, loq_ref, hiq_ref,
            k_ref, uk_ref, vk_ref, ok_ref, kval_ref, best_ref, second_ref, *,
            block_k: int, n_tiles: int):
    bq = best_ref.shape[0]
    uq = uq_ref[...][:, None]
    vq = vq_ref[...][:, None]
    rq = rq_ref[...][:, None]
    loq = loq_ref[...][:, None]
    hiq = hiq_ref[...][:, None]
    qw = [q_ref[w, :][:, None] for w in range(8)]  # 8 x (BQ, 1) int32

    def body(t, carry):
        r1, r2 = carry
        start = pl.multiple_of(t * block_k, block_k)
        ks = pl.ds(start, block_k)
        d = jnp.zeros((bq, block_k), jnp.int32)
        for w in range(8):
            d += jax.lax.population_count(qw[w] ^ k_ref[w, ks][None, :])
        octk = ok_ref[ks][None, :]
        ok = (
            (jnp.abs(uq - uk_ref[ks][None, :]) <= rq)
            & (jnp.abs(vq - vk_ref[ks][None, :]) <= rq)
            & (octk >= loq)
            & (octk <= hiq)
            & (kval_ref[ks][None, :] != 0)
        )
        col = start + jnp.arange(block_k, dtype=jnp.int32)[None, :]
        key = (jnp.where(ok, d, _GATED) << _COL_BITS) | col
        k1 = jnp.min(key, axis=1)
        k2 = jnp.min(jnp.where(key == k1[:, None], _EMPTY, key), axis=1)
        return (jnp.minimum(r1, k1),
                jnp.minimum(jnp.maximum(r1, k1), jnp.minimum(r2, k2)))

    init = jnp.full((bq,), _EMPTY, jnp.int32)
    r1, r2 = jax.lax.fori_loop(0, n_tiles, body, (init, init))
    best_ref[...] = r1
    second_ref[...] = r2


def _pad(x: jnp.ndarray, n: int, fill, axis: int = 0) -> jnp.ndarray:
    if x.shape[axis] == n:
        return x
    pad = [(0, 0)] * x.ndim
    pad[axis] = (0, n - x.shape[axis])
    return jnp.pad(x, pad, constant_values=fill)


def _words(desc: jnp.ndarray) -> jnp.ndarray:
    """(N, 32) uint8 -> (8, N) int32 descriptor words."""
    w = jax.lax.bitcast_convert_type(desc.reshape(-1, 8, 4), jnp.int32)
    return w.T


@functools.partial(
    jax.jit,
    static_argnames=("block_q", "block_k", "num_warps", "num_stages",
                     "interpret"),
)
def _top2_keys(desc_q, uv_q, radius_q, lo_q, hi_q,
               desc_k, uv_k, octave_k, valid_k, *,
               block_q, block_k, num_warps, num_stages, interpret):
    n, m = desc_q.shape[0], desc_k.shape[0]
    if m > _MAX_KEYS:
        raise ValueError(f"{m} keys exceed the kernel's {_MAX_KEYS}")
    npad = pl.cdiv(n, block_q) * block_q
    mpad = pl.cdiv(m, block_k) * block_k

    # Padded query rows have radius -1 (no key is in their window);
    # padded keys are invalid.
    q_attrs = [
        _pad(uv_q[:, 0].astype(jnp.float32), npad, 0.0),
        _pad(uv_q[:, 1].astype(jnp.float32), npad, 0.0),
        _pad(radius_q.astype(jnp.float32), npad, -1.0),
        _pad(lo_q.astype(jnp.int32), npad, 0),
        _pad(hi_q.astype(jnp.int32), npad, 0),
    ]
    k_attrs = [
        _pad(uv_k[:, 0].astype(jnp.float32), mpad, 0.0),
        _pad(uv_k[:, 1].astype(jnp.float32), mpad, 0.0),
        _pad(octave_k.astype(jnp.int32), mpad, 0),
        _pad(valid_k.astype(jnp.int32), mpad, 0),
    ]
    q_row = pl.BlockSpec((block_q,), lambda i: (i,))
    k_all = pl.BlockSpec((mpad,), lambda i: (0,))
    kernel = functools.partial(_kernel, block_k=block_k,
                               n_tiles=mpad // block_k)
    best, second = pl.pallas_call(
        kernel,
        grid=(npad // block_q,),
        in_specs=([pl.BlockSpec((8, block_q), lambda i: (0, i))]
                  + [q_row] * 5
                  + [pl.BlockSpec((8, mpad), lambda i: (0, 0))]
                  + [k_all] * 4),
        out_specs=[q_row, q_row],
        out_shape=[jax.ShapeDtypeStruct((npad,), jnp.int32)] * 2,
        compiler_params=pl_triton.CompilerParams(
            num_warps=num_warps, num_stages=num_stages
        ),
        backend="triton",
        interpret=interpret,
        name="hamming_top2",
    )(_pad(_words(desc_q), npad, 0, axis=1), *q_attrs,
      _pad(_words(desc_k), mpad, 0, axis=1), *k_attrs)
    return best[:n], second[:n]


def _distance(key: jnp.ndarray) -> jnp.ndarray:
    d = key >> _COL_BITS
    return jnp.where(d >= _GATED, INF, d.astype(jnp.float32))


def hamming_top2(
    desc_q: jnp.ndarray,  # (N, 32) uint8
    desc_k: jnp.ndarray,  # (M, 32) uint8
    valid_k: jnp.ndarray,  # (M,) bool
    window: MatchWindow,
    *,
    interpret: bool = False,
    **config,
) -> Tuple[jnp.ndarray, jnp.ndarray, jnp.ndarray]:
    """Fused equivalent of `best_two` over the masked Hamming matrix
    (`window_mask` gates and key validity), without materializing it.
    Returns (best, second, argbest); f32 distances, INF where nothing is
    admissible. Query-row validity is the caller's to apply, as on the
    plain path. `config` overrides entries of CONFIG; `interpret=True`
    runs the kernel in the Pallas interpreter (CPU tests)."""
    best, second = _top2_keys(
        desc_q, window.uv_q, window.radius_q, window.octave_lo,
        window.octave_hi, desc_k, window.uv_k, window.octave_k, valid_k,
        interpret=interpret, **{**CONFIG, **config},
    )
    j = best & (_MAX_KEYS - 1)
    return _distance(best), _distance(second), j


def search_window(
    n: int,
    m: int,
    uv_q: jnp.ndarray,
    uv_k: jnp.ndarray,
    radius,
    octave_k: Optional[jnp.ndarray],
    octave_lo: Optional[jnp.ndarray],
    octave_hi: Optional[jnp.ndarray],
) -> MatchWindow:
    """`MatchWindow` from `search_by_projection`'s arguments; an absent
    octave gate becomes an open bound."""
    if octave_k is None:
        octave_k = jnp.zeros((m,), jnp.int32)
        octave_lo = octave_hi = None
    lo = (jnp.full((n,), -_OCT_OPEN, jnp.int32) if octave_lo is None
          else octave_lo)
    hi = (jnp.full((n,), _OCT_OPEN, jnp.int32) if octave_hi is None
          else octave_hi)
    r = jnp.broadcast_to(jnp.asarray(radius, jnp.float32), (n,))
    return MatchWindow(uv_q, uv_k, r, octave_k, lo, hi)
