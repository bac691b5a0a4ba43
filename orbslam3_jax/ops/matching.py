"""Binary descriptor matching.

Re-design of the reference matcher (`ORBmatcher.cc`). The reference
computes Hamming distance with a scalar popcount loop
(`ORBmatcher.cc:DescriptorDistance:2700`) inside grid-bucketed candidate
loops (`Frame::GetFeaturesInArea`); the 64x48 grid exists only to avoid
O(N*M) work on a CPU. Here the O(N*M) distance matrix is computed in one
product: unpack descriptors to 256 bit-planes and use

    hamming(a, b) = popcnt(a) + popcnt(b) - 2 * <bits(a), bits(b)>

Geometric windows (projection radius, octave gates, epipolar bands)
become masks on the distance matrix, so every SearchBy* variant of the
reference is the same computation with a different mask. On a GPU the
large windowed searches run the fused kernel of `ops/pallas_match.py`
instead, which never stores the matrix.

All functions take validity masks; invalid rows/cols get distance INF.
"""

from __future__ import annotations

from typing import NamedTuple, Optional, Tuple

import jax
import jax.numpy as jnp
import numpy as np

TH_LOW = 50  # ref ORBmatcher.h: TH_LOW
TH_HIGH = 100  # ref ORBmatcher.h: TH_HIGH
HISTO_LENGTH = 30  # rotation-consistency histogram bins
INF = jnp.float32(1e9)

_BIT_WEIGHTS = (2 ** np.arange(8)).astype(np.uint8)

# Projection-search backend: None = automatic (the fused kernel on a GPU
# for problems of at least FUSED_MIN_PAIRS candidate pairs, the matrix
# path otherwise); True/False force it (benchmarks). 4096 x 1000 is the
# smallest size timed on the H100, where the kernel took half the matrix
# path's time (PERF.md); smaller calls keep the matrix path.
_FUSED: Optional[bool] = None
FUSED_MIN_PAIRS = 4096 * 1000


def use_fused_projection(enable: Optional[bool]) -> None:
    global _FUSED
    _FUSED = enable


def _fused_enabled(n_pairs: int) -> bool:
    if _FUSED is not None:
        return _FUSED
    return jax.default_backend() == "gpu" and n_pairs >= FUSED_MIN_PAIRS


def unpack_bits(desc: jnp.ndarray) -> jnp.ndarray:
    """(..., 32) uint8 -> (..., 256) bits as bfloat16 {0,1} (matmul operand)."""
    bits = (desc[..., :, None] >> np.arange(8, dtype=np.uint8)) & 1
    return bits.reshape(*desc.shape[:-1], 256).astype(jnp.bfloat16)


def hamming_matrix(desc_a: jnp.ndarray, desc_b: jnp.ndarray) -> jnp.ndarray:
    """(N,32)x(M,32) uint8 -> (N,M) float32 Hamming distances as one matmul.

    Exact: bits are {0,1}, the dot is <=256, bf16 represents all integers
    up to 256 exactly and f32 accumulation is lossless here.
    """
    a = unpack_bits(desc_a)
    b = unpack_bits(desc_b)
    dots = jnp.dot(a, b.T, preferred_element_type=jnp.float32)
    pa = jnp.sum(a.astype(jnp.float32), axis=-1)
    pb = jnp.sum(b.astype(jnp.float32), axis=-1)
    return pa[:, None] + pb[None, :] - 2.0 * dots


def hamming_matrix_xor(desc_a: jnp.ndarray, desc_b: jnp.ndarray) -> jnp.ndarray:
    """Reference implementation via XOR+popcount (used by tests to
    validate the matmul path and the fused kernel; mirrors
    `ORBmatcher.cc:2700`)."""
    a = desc_a.view(jnp.uint8).astype(jnp.uint32)
    b = desc_b.view(jnp.uint8).astype(jnp.uint32)
    x = jnp.bitwise_xor(a[:, None, :], b[None, :, :])
    return jnp.sum(jax.lax.population_count(x), axis=-1).astype(jnp.float32)


class Matches(NamedTuple):
    idx: jnp.ndarray  # (N,) int32 — best column per row (-1 invalid)
    dist: jnp.ndarray  # (N,) float32
    valid: jnp.ndarray  # (N,) bool


def _mask_matrix(
    D: jnp.ndarray, valid_a: Optional[jnp.ndarray], valid_b: Optional[jnp.ndarray]
) -> jnp.ndarray:
    if valid_a is not None:
        D = jnp.where(valid_a[:, None], D, INF)
    if valid_b is not None:
        D = jnp.where(valid_b[None, :], D, INF)
    return D


def best_two(D: jnp.ndarray) -> Tuple[jnp.ndarray, jnp.ndarray, jnp.ndarray]:
    """Best + second-best distance along axis 1, plus argmin."""
    neg, idx = jax.lax.top_k(-D, 2)
    return -neg[:, 0], -neg[:, 1], idx[:, 0]


def match_nn(
    desc_a: jnp.ndarray,
    desc_b: jnp.ndarray,
    valid_a: Optional[jnp.ndarray] = None,
    valid_b: Optional[jnp.ndarray] = None,
    max_dist: float = TH_LOW,
    ratio: float = 0.9,
    cross_check: bool = True,
    extra_mask: Optional[jnp.ndarray] = None,
) -> Matches:
    """Mutual nearest-neighbour matching with Lowe ratio test.

    Replaces `ORBmatcher::SearchByBoW` brute force (the FeatureVector
    node alignment of `ORBmatcher.cc:323` is a CPU pruning device; the
    full matrix is cheaper here). `extra_mask` (N,M) True=allowed adds the
    geometric window of the SearchByProjection variants.
    """
    D = hamming_matrix(desc_a, desc_b)
    D = _mask_matrix(D, valid_a, valid_b)
    if extra_mask is not None:
        D = jnp.where(extra_mask, D, INF)
    d1, d2, j = best_two(D)
    ok = (d1 <= max_dist) & (d1 <= ratio * d2)
    if cross_check:
        back = jnp.argmin(D, axis=0)  # best row for each column
        ok &= back[j] == jnp.arange(D.shape[0])
    return Matches(idx=jnp.where(ok, j, -1), dist=d1, valid=ok)


def rotation_consistency(
    angle_a: jnp.ndarray,
    angle_b: jnp.ndarray,
    matches: Matches,
    keep_bins: int = 3,
) -> Matches:
    """Keep only matches whose angle difference falls in the `keep_bins`
    most popular histogram bins (ref `ORBmatcher.cc` rotHist pattern,
    HISTO_LENGTH=30, `ComputeThreeMaxima`)."""
    d_ang = angle_a - angle_b[jnp.clip(matches.idx, 0)]
    d_deg = jnp.rad2deg(d_ang) % 360.0
    bins = jnp.clip((d_deg * HISTO_LENGTH / 360.0).astype(jnp.int32), 0, HISTO_LENGTH - 1)
    hist = jnp.zeros(HISTO_LENGTH, jnp.int32).at[bins].add(matches.valid.astype(jnp.int32))
    top = jax.lax.top_k(hist, keep_bins)[1]
    in_top = jnp.any(bins[:, None] == top[None, :], axis=1)
    ok = matches.valid & in_top
    return Matches(idx=jnp.where(ok, matches.idx, -1), dist=matches.dist, valid=ok)


def window_mask(
    uv_query: jnp.ndarray,  # (N,2) predicted pixel positions
    uv_kp: jnp.ndarray,  # (M,2) keypoint positions
    radius: jnp.ndarray,  # (N,) or scalar search radii (pixels, level-0)
    octave_kp: Optional[jnp.ndarray] = None,  # (M,)
    octave_lo: Optional[jnp.ndarray] = None,  # (N,) inclusive
    octave_hi: Optional[jnp.ndarray] = None,  # (N,) inclusive
) -> jnp.ndarray:
    """(N,M) bool mask: keypoint within the search window of the query.

    This replaces `Frame::GetFeaturesInArea` (`Frame.cc:755-850`):
    instead of grid buckets, an O(N*M) comparison fused into the distance
    computation.
    """
    du = jnp.abs(uv_query[:, 0:1] - uv_kp[None, :, 0])
    dv = jnp.abs(uv_query[:, 1:2] - uv_kp[None, :, 1])
    r = jnp.broadcast_to(jnp.asarray(radius, jnp.float32), (uv_query.shape[0],))[:, None]
    m = (du <= r) & (dv <= r)
    if octave_kp is not None:
        if octave_lo is not None:
            m &= octave_kp[None, :] >= octave_lo[:, None]
        if octave_hi is not None:
            m &= octave_kp[None, :] <= octave_hi[:, None]
    return m


def search_by_projection(
    desc_query: jnp.ndarray,  # (N,32) map-point descriptors
    uv_query: jnp.ndarray,  # (N,2) projections
    valid_query: jnp.ndarray,  # (N,)
    desc_kp: jnp.ndarray,  # (M,32) frame keypoints
    uv_kp: jnp.ndarray,  # (M,2)
    valid_kp: jnp.ndarray,  # (M,)
    radius: jnp.ndarray,
    octave_kp: Optional[jnp.ndarray] = None,
    octave_lo: Optional[jnp.ndarray] = None,
    octave_hi: Optional[jnp.ndarray] = None,
    max_dist: float = TH_HIGH,
    ratio: float = 0.9,
) -> Matches:
    """Project-and-match (ref `ORBmatcher::SearchByProjection` overloads,
    `ORBmatcher.cc:59,2244,2520`): window + octave gates as a mask on the
    Hamming matrix, ratio test within the window.

    On a GPU, problems of at least FUSED_MIN_PAIRS candidate pairs run
    the fused kernel of `ops/pallas_match.py`, bit-identical to the
    matrix path below (tests/test_pallas_match.py).
    """
    n, m = desc_query.shape[0], desc_kp.shape[0]
    if _fused_enabled(n * m):
        from orbslam3_jax.ops import pallas_match as pm

        window = pm.search_window(n, m, uv_query, uv_kp, radius, octave_kp,
                                  octave_lo, octave_hi)
        d1, d2, j = pm.hamming_top2(desc_query, desc_kp, valid_kp, window)
        d1 = jnp.where(valid_query, d1, INF)
        ok = valid_query & (d1 <= max_dist) & (d1 <= ratio * d2)
        return Matches(idx=jnp.where(ok, j, -1), dist=d1, valid=ok)
    mask = window_mask(uv_query, uv_kp, radius, octave_kp, octave_lo, octave_hi)
    return match_nn(
        desc_query,
        desc_kp,
        valid_query,
        valid_kp,
        max_dist=max_dist,
        ratio=ratio,
        cross_check=False,
        extra_mask=mask,
    )


def assign_unique(matches: Matches, n_cols: int) -> Matches:
    """Resolve duplicate column assignments: keep the lowest-distance row
    per column (the reference erases the previous match when a better one
    arrives, e.g. `ORBmatcher.cc:SearchByProjection` reloc variant)."""
    # Scatter-min distances per column.
    col = jnp.clip(matches.idx, 0)
    best = jnp.full((n_cols,), jnp.inf, matches.dist.dtype).at[col].min(
        jnp.where(matches.valid, matches.dist, jnp.inf)
    )
    is_best = matches.valid & (matches.dist <= best[col])
    # Tie-break double winners by row index: first row with the best dist wins.
    rows = jnp.arange(matches.idx.shape[0], dtype=jnp.int32)
    first = jnp.full((n_cols,), jnp.iinfo(jnp.int32).max, jnp.int32).at[col].min(
        jnp.where(is_best, rows, jnp.iinfo(jnp.int32).max)
    )
    ok = is_best & (first[col] == rows)
    return Matches(idx=jnp.where(ok, matches.idx, -1), dist=matches.dist, valid=ok)
