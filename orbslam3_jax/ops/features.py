"""ORB feature extraction as batched XLA programs.

Re-design of the reference extractor (`/root/reference/src/ORBextractor.cc`):

* 8-level image pyramid, scale 1.2 (`ORBextractor.cc:ComputePyramid:1158`)
  via `jax.image.resize`.
* FAST-9/16 corners (`ComputeKeyPointsOctTree:763`) — instead of a per-cell
  scalar loop, the segment test runs densely over the whole level using
  16 shifted copies of the image and a bitmask contiguous-arc reduction;
  scores are the standard vectorized sum-over-arc margin.
* Quadtree balancing (`DistributeOctTree:537`) — re-expressed as per-cell
  top-k + *rank interleaving*: every cell contributes its best corner
  before any cell contributes its second, which reproduces the quadtree's
  spatial uniformity with pure top_k/sort ops (SURVEY.md §7 step 2).
  The dual FAST threshold (`iniThFAST`/`minThFAST` fallback per cell,
  `ORBextractor.cc:763-860`) becomes a score bonus for corners passing the
  high threshold.
* Orientation = intensity centroid on a radius-15 circular patch
  (`IC_Angle:75`), computed for all keypoints at once with a single gather.
* Descriptors: 256-pair binary tests on the Gaussian-blurred level image,
  steered by the keypoint angle (`computeOrbDescriptor`). The point-pair
  pattern is *generated* (isotropic Gaussian, BRIEF-style, fixed seed) —
  descriptors are internal to this framework, so we do not reuse the
  reference's learned table.

Everything is fixed-shape: each pyramid level has a static keypoint budget
(geometric series as in `ORBextractor.cc:408`), padded with invalid slots.
"""

from __future__ import annotations

import functools
import math
from typing import NamedTuple, Sequence, Tuple

import jax
import jax.numpy as jnp
import numpy as np

EDGE_THRESHOLD = 19  # ref ORBextractor.cc: border where no keypoints live
PATCH_RADIUS = 15  # IC-angle patch (HALF_PATCH_SIZE in reference)
CELL = 32  # selection cell size (reference seeds FAST on 35px windows)


class OrbParams(NamedTuple):
    n_features: int = 1000
    n_levels: int = 8
    scale_factor: float = 1.2
    ini_th: float = 20.0  # ORBextractor.iniThFAST
    min_th: float = 7.0  # ORBextractor.minThFAST


class Features(NamedTuple):
    """Fixed-capacity keypoint set for one image (all arrays length N).

    Replaces the reference's `std::vector<cv::KeyPoint>` + `cv::Mat`
    descriptors per Frame (`src/Frame.cc:349`)."""

    uv: jnp.ndarray  # (N,2) float32 — level-0 pixel coords
    response: jnp.ndarray  # (N,) float32
    octave: jnp.ndarray  # (N,) int32
    angle: jnp.ndarray  # (N,) float32 radians
    desc: jnp.ndarray  # (N,32) uint8 packed descriptor
    valid: jnp.ndarray  # (N,) bool

    @property
    def n(self):
        return self.uv.shape[0]


# ---------------------------------------------------------------------------
# Static tables
# ---------------------------------------------------------------------------

# FAST circle of radius 3 (Bresenham 16 offsets, standard ordering).
_FAST_OFFSETS = np.array(
    [
        (0, 3), (1, 3), (2, 2), (3, 1), (3, 0), (3, -1), (2, -2), (1, -3),
        (0, -3), (-1, -3), (-2, -2), (-3, -1), (-3, 0), (-3, 1), (-2, 2), (-1, 3),
    ],
    dtype=np.int32,
)  # (dx, dy)


def _ic_angle_offsets() -> Tuple[np.ndarray, np.ndarray, np.ndarray]:
    """Integer offsets + weights of the radius-15 circular patch."""
    r = PATCH_RADIUS
    ys, xs = np.mgrid[-r : r + 1, -r : r + 1]
    mask = xs * xs + ys * ys <= r * r
    return xs[mask].astype(np.int32), ys[mask].astype(np.int32), mask


_IC_XS, _IC_YS, _ = _ic_angle_offsets()


def _brief_pattern(seed: int = 42, n_pairs: int = 256, sigma: float = 31.0 / 5.0):
    """BRIEF-style Gaussian point-pair pattern, clipped to radius 13 so the
    steered pattern stays inside a 45x45 patch. Fixed seed => deterministic
    descriptors across runs/hosts."""
    rng = np.random.default_rng(seed)
    pts = rng.normal(0.0, sigma, size=(n_pairs, 2, 2))
    pts = np.clip(np.round(pts), -13, 13).astype(np.float32)
    # Avoid degenerate identical pairs.
    same = np.all(pts[:, 0] == pts[:, 1], axis=-1)
    pts[same, 1, 0] += 1.0
    return pts  # (256, 2, 2) — (pair, endpoint, xy)


_PATTERN = _brief_pattern()
_BIT_WEIGHTS = (2 ** np.arange(8)).astype(np.uint8)


# ---------------------------------------------------------------------------
# FAST corner response (dense, whole level at once)
# ---------------------------------------------------------------------------


def _shift2d(img: jnp.ndarray, dx: int, dy: int) -> jnp.ndarray:
    """img shifted so that out[y, x] = img[y + dy, x + dx] (zero-ish pad via roll;
    borders are masked out by the caller)."""
    return jnp.roll(img, shift=(-dy, -dx), axis=(0, 1))


def fast_score(img: jnp.ndarray, min_th: float, ini_th: float):
    """Dense FAST-9/16 segment test + margin score.

    Returns (score, pass_ini) maps. score > 0 only at corners w.r.t.
    ``min_th``; ``pass_ini`` marks corners w.r.t. ``ini_th`` (the
    reference's per-cell threshold fallback, `ORBextractor.cc:782-795`).
    """
    center = img
    ring = jnp.stack(
        [_shift2d(img, int(dx), int(dy)) for dx, dy in _FAST_OFFSETS], axis=0
    )  # (16, H, W)

    def corner_mask_and_score(th):
        brighter = ring > center[None] + th  # (16,H,W)
        darker = ring < center[None] - th

        def arc9(m):
            # Contiguous run of >= 9 over the 16-cycle: AND of 9 shifted copies.
            bits = jnp.zeros(img.shape, jnp.uint32)
            for i in range(16):
                bits = bits | (m[i].astype(jnp.uint32) << i)
            wrapped = bits | (bits << 16)
            acc = wrapped
            for j in range(1, 9):
                acc = acc & (wrapped >> j)
            return (acc & jnp.uint32(0xFFFF)) != 0

        is_corner = arc9(brighter) | arc9(darker)
        # Margin score: sum over circle of excess beyond threshold (standard
        # vectorized FAST score; monotone in corner strength).
        sb = jnp.sum(jnp.maximum(ring - center[None] - th, 0.0), axis=0)
        sd = jnp.sum(jnp.maximum(center[None] - ring - th, 0.0), axis=0)
        return is_corner, jnp.where(is_corner, jnp.maximum(sb, sd), 0.0)

    is_min, score = corner_mask_and_score(min_th)
    is_ini, _ = corner_mask_and_score(ini_th)
    return score, is_ini & is_min


def _nms3(score: jnp.ndarray) -> jnp.ndarray:
    """3x3 non-max suppression."""
    neigh = jax.lax.reduce_window(
        score, -jnp.inf, jax.lax.max, (3, 3), (1, 1), "SAME"
    )
    return jnp.where(score >= neigh, score, 0.0)


def _select_level(
    score: jnp.ndarray, pass_ini: jnp.ndarray, budget: int, k_cell: int = 12
):
    """Spatially balanced top-`budget` selection (quadtree replacement).

    Per CELLxCELL cell take the k_cell best, then order all candidates by
    (in-cell rank, -score) and keep the first `budget`.
    """
    H, W = score.shape
    # High-threshold corners win within a cell (dual-threshold fallback).
    s = jnp.where(score > 0, score + jnp.where(pass_ini, 1e6, 0.0), 0.0)
    pad_h = (-H) % CELL
    pad_w = (-W) % CELL
    s = jnp.pad(s, ((0, pad_h), (0, pad_w)))
    Hc, Wc = s.shape
    ncy, ncx = Hc // CELL, Wc // CELL
    cells = s.reshape(ncy, CELL, ncx, CELL).transpose(0, 2, 1, 3).reshape(-1, CELL * CELL)
    vals, idx = jax.lax.top_k(cells, k_cell)  # (C, k)
    C = cells.shape[0]
    cy = jnp.arange(C, dtype=jnp.int32) // ncx
    cx = jnp.arange(C, dtype=jnp.int32) % ncx
    y = cy[:, None] * CELL + idx // CELL
    x = cx[:, None] * CELL + idx % CELL
    rank = jnp.broadcast_to(jnp.arange(k_cell, dtype=jnp.float32)[None], vals.shape)
    valid = vals > 0
    # Lexicographic key: small rank first, then large score. Invalid last.
    key = jnp.where(valid, rank * 1e8 - jnp.minimum(vals, 1e7), jnp.inf)
    flat_key = key.reshape(-1)
    order = jnp.argsort(flat_key)[:budget]
    sel_y = y.reshape(-1)[order]
    sel_x = x.reshape(-1)[order]
    sel_v = vals.reshape(-1)[order]
    sel_valid = jnp.isfinite(flat_key[order])
    # Strip the ini bonus back off the reported response.
    resp = jnp.where(sel_v > 5e5, sel_v - 1e6, sel_v)
    return sel_x.astype(jnp.float32), sel_y.astype(jnp.float32), resp, sel_valid


# ---------------------------------------------------------------------------
# Orientation + descriptor (batched gathers)
# ---------------------------------------------------------------------------


def _gather(img: jnp.ndarray, xs: jnp.ndarray, ys: jnp.ndarray) -> jnp.ndarray:
    H, W = img.shape
    xs = jnp.clip(xs, 0, W - 1)
    ys = jnp.clip(ys, 0, H - 1)
    return img[ys, xs]


def ic_angle(img: jnp.ndarray, x: jnp.ndarray, y: jnp.ndarray) -> jnp.ndarray:
    """Intensity-centroid orientation for all keypoints at once
    (ref `ORBextractor.cc:IC_Angle:75`). x, y: (N,) level coords."""
    xi = x.astype(jnp.int32)[:, None] + _IC_XS[None, :]
    yi = y.astype(jnp.int32)[:, None] + _IC_YS[None, :]
    vals = _gather(img, xi, yi)  # (N, P)
    m10 = jnp.sum(vals * _IC_XS[None, :], axis=1)
    m01 = jnp.sum(vals * _IC_YS[None, :], axis=1)
    return jnp.arctan2(m01, m10)


def brief_descriptor(
    img_blur: jnp.ndarray, x: jnp.ndarray, y: jnp.ndarray, angle: jnp.ndarray
) -> jnp.ndarray:
    """Steered 256-bit descriptors, packed to (N, 32) uint8.

    Nearest-pixel sampling of the rotated pattern, like the reference's
    `computeOrbDescriptor` (which rounds rotated offsets to ints)."""
    ca, sa = jnp.cos(angle), jnp.sin(angle)  # (N,)
    px = _PATTERN[:, :, 0]  # (256, 2)
    py = _PATTERN[:, :, 1]
    # Rotate pattern per keypoint: (N, 256, 2)
    rx = ca[:, None, None] * px[None] - sa[:, None, None] * py[None]
    ry = sa[:, None, None] * px[None] + ca[:, None, None] * py[None]
    xi = jnp.round(x[:, None, None] + rx).astype(jnp.int32)
    yi = jnp.round(y[:, None, None] + ry).astype(jnp.int32)
    vals = _gather(img_blur, xi, yi)  # (N, 256, 2)
    bits = (vals[:, :, 0] < vals[:, :, 1]).astype(jnp.uint8)  # (N, 256)
    return (bits.reshape(-1, 32, 8) * _BIT_WEIGHTS[None, None, :]).sum(-1).astype(jnp.uint8)


def gaussian_blur7(img: jnp.ndarray, sigma: float = 2.0) -> jnp.ndarray:
    """Separable 7x7 Gaussian (ref blurs with 7x7 sigma=2 before BRIEF,
    `ORBextractor.cc:1105`)."""
    r = 3
    xs = np.arange(-r, r + 1)
    k = np.exp(-(xs**2) / (2 * sigma**2))
    k = (k / k.sum()).astype(np.float32)
    kj = jnp.asarray(k)
    img4 = img[None, None]  # NCHW
    kh = kj.reshape(1, 1, 1, 7)
    kv = kj.reshape(1, 1, 7, 1)
    out = jax.lax.conv_general_dilated(img4, kh, (1, 1), [(0, 0), (r, r)])
    out = jax.lax.conv_general_dilated(out, kv, (1, 1), [(r, r), (0, 0)])
    return out[0, 0]


# ---------------------------------------------------------------------------
# Full extractor
# ---------------------------------------------------------------------------


def level_budgets(params: OrbParams) -> Sequence[int]:
    """Geometric per-level feature budgets summing to n_features
    (ref `ORBextractor.cc:408-436`)."""
    f = 1.0 / params.scale_factor
    n0 = params.n_features * (1 - f) / (1 - f**params.n_levels)
    budgets = [int(round(n0 * f**l)) for l in range(params.n_levels)]
    budgets[-1] = max(params.n_features - sum(budgets[:-1]), 8)
    return budgets


# ---------------------------------------------------------------------------
# Atlas layout: all pyramid levels stacked vertically into ONE image so the
# dense stages (FAST, NMS) and the per-keypoint stages (patch gather, blur,
# angle, BRIEF) each run ONCE instead of once per level. Levels are placed at
# CELL-aligned row offsets with >= GAP zero rows between them; GAP exceeds the
# blur + FAST + NMS reach, so per-level values are bit-identical to computing
# each level standalone with zero padding.
# ---------------------------------------------------------------------------

_ATLAS_GAP = 8  # >= blur reach (3) + FAST ring (3) + NMS (1)
_PATCH = 46  # raw patch: BRIEF reach (19) + blur reach (3) = 22 each side
_PCTR = 22  # patch center index
_BLUR_CTR = _PCTR - 3  # center index inside the blurred (valid-region) patch


def _atlas_layout(H: int, W: int, params: OrbParams):
    """Static (offsets, sizes, atlas_H, atlas_W) of the stacked pyramid."""
    offs, sizes = [], []
    off = 0
    for lvl in range(params.n_levels):
        scale = params.scale_factor**lvl
        h = H if lvl == 0 else int(round(H / scale))
        w = W if lvl == 0 else int(round(W / scale))
        offs.append(off)
        sizes.append((h, w))
        off = ((off + h + _ATLAS_GAP) + CELL - 1) // CELL * CELL
    atlas_h = ((offs[-1] + sizes[-1][0]) + CELL - 1) // CELL * CELL
    atlas_w = (W + CELL - 1) // CELL * CELL
    return offs, sizes, atlas_h, atlas_w


def _extract_patches(atlas: jnp.ndarray, xi: jnp.ndarray, yi: jnp.ndarray,
                     psize: int, center: int) -> jnp.ndarray:
    """(N, psize, psize) patches around integer centers, via two one-hot
    matmuls (row selection, then column selection). Atlas values are integers <= 255, exact in bfloat16. Out-of-range rows
    and columns read as 0."""
    HA, WA = atlas.shape
    a16 = atlas.astype(jnp.bfloat16)
    ri = yi[:, None] + (jnp.arange(psize, dtype=jnp.int32) - center)[None, :]
    oy = (ri[:, :, None] == jnp.arange(HA, dtype=jnp.int32)[None, None, :])
    rows = jnp.einsum(
        "nph,hw->npw", oy.astype(jnp.bfloat16), a16,
        preferred_element_type=jnp.float32,
    )  # (N, psize, WA)
    ci = xi[:, None] + (jnp.arange(psize, dtype=jnp.int32) - center)[None, :]
    ox = (ci[:, :, None] == jnp.arange(WA, dtype=jnp.int32)[None, None, :])
    patch = jnp.einsum(
        "nqw,npw->npq", ox.astype(jnp.bfloat16), rows.astype(jnp.bfloat16),
        preferred_element_type=jnp.float32,
    )  # (N, psize_y, psize_x): patch[n, p, q] = atlas[yi+p-c, xi+q-c]
    return patch


def _ic_weights(psize: int, center: int):
    """Static (psize, psize) x/y moment masks of the radius-15 IC patch."""
    wx = np.zeros((psize, psize), np.float32)
    wy = np.zeros((psize, psize), np.float32)
    r = PATCH_RADIUS
    ys, xs = np.mgrid[-r : r + 1, -r : r + 1]
    mask = xs * xs + ys * ys <= r * r
    wx[center - r : center + r + 1, center - r : center + r + 1] = xs * mask
    wy[center - r : center + r + 1, center - r : center + r + 1] = ys * mask
    return wx, wy


def _blur_patches(patch: jnp.ndarray, sigma: float = 2.0) -> jnp.ndarray:
    """Separable 7-tap Gaussian over the patch interior: (N, P, P) ->
    (N, P-6, P-6) valid-region blur (matches whole-image zero-padded blur
    for keypoints >= EDGE_THRESHOLD inside a level, since the atlas gap
    rows are zero)."""
    r = 3
    xs = np.arange(-r, r + 1)
    k = np.exp(-(xs**2) / (2 * sigma**2))
    k = (k / k.sum()).astype(np.float32)
    P = patch.shape[-1]
    t = sum(float(k[i]) * patch[:, :, i : i + P - 2 * r] for i in range(2 * r + 1))
    return sum(float(k[i]) * t[:, i : i + P - 2 * r, :] for i in range(2 * r + 1))


def _brief_from_patches(pblur: jnp.ndarray, angle: jnp.ndarray) -> jnp.ndarray:
    """Steered BRIEF on blurred patches: rotated integer offsets (the
    reference rounds the rotated pattern, `computeOrbDescriptor`) sampled
    with a factored one-hot contraction — row pick is a batched matmul,
    column pick an elementwise reduce."""
    N, PB, _ = pblur.shape
    ca, sa = jnp.cos(angle), jnp.sin(angle)
    px = _PATTERN[:, :, 0].reshape(-1)  # (512,)
    py = _PATTERN[:, :, 1].reshape(-1)
    rx = ca[:, None] * px[None] - sa[:, None] * py[None]  # (N, 512)
    ry = sa[:, None] * px[None] + ca[:, None] * py[None]
    xi = jnp.round(rx).astype(jnp.int32) + _BLUR_CTR
    yi = jnp.round(ry).astype(jnp.int32) + _BLUR_CTR
    oy = (yi[:, :, None] == jnp.arange(PB, dtype=jnp.int32)[None, None, :])
    t1 = jnp.einsum(
        "nsr,nrc->nsc", oy.astype(jnp.bfloat16), pblur.astype(jnp.bfloat16),
        preferred_element_type=jnp.float32,
    )  # (N, 512, PB) — row-picked
    ox = (xi[:, :, None] == jnp.arange(PB, dtype=jnp.int32)[None, None, :])
    vals = jnp.sum(t1 * ox, axis=-1).reshape(N, 256, 2)
    bits = (vals[:, :, 0] < vals[:, :, 1]).astype(jnp.uint8)
    return (bits.reshape(-1, 32, 8) * _BIT_WEIGHTS[None, None, :]).sum(-1).astype(jnp.uint8)


@functools.partial(jax.jit, static_argnames=("params",))
def extract(image: jnp.ndarray, params: OrbParams = OrbParams()) -> Features:
    """Extract ORB features from a grayscale float32 image [H, W] (0..255).

    One XLA program, organised around a stacked-level atlas:
    pyramid (integer-rounded levels, like the reference's uint8 pyramid,
    `ORBextractor.cc:ComputePyramid:1158`) -> ONE dense FAST + NMS over
    the atlas -> per-level balanced top-k -> one (N,46,46) patch gather
    via one-hot matmuls -> IC angle, in-patch Gaussian blur, steered
    BRIEF. No per-keypoint scalar gathers anywhere.
    """
    H, W = image.shape
    budgets = level_budgets(params)
    offs, sizes, HA, WA = _atlas_layout(H, W, params)

    # --- build the atlas ---------------------------------------------------
    atlas = jnp.zeros((HA, WA), jnp.float32)
    for lvl in range(params.n_levels):
        h, w = sizes[lvl]
        lvl_img = image if lvl == 0 else jax.image.resize(
            image, (h, w), method="bilinear"
        )
        lvl_img = jnp.round(lvl_img)  # reference pyramid is uint8
        atlas = jax.lax.dynamic_update_slice(atlas, lvl_img, (offs[lvl], 0))

    # --- dense FAST + NMS, once --------------------------------------------
    score, pass_ini = fast_score(atlas, params.min_th, params.ini_th)
    score = _nms3(score)

    # Static border mask: FAST ring + descriptor reach inside each level.
    b = EDGE_THRESHOLD
    inside_np = np.zeros((HA, WA), bool)
    for lvl in range(params.n_levels):
        h, w = sizes[lvl]
        o = offs[lvl]
        inside_np[o + b : o + h - b, b : w - b] = True
    score = jnp.where(jnp.asarray(inside_np), score, 0.0)

    # --- per-level spatially balanced selection ----------------------------
    xs_l, ys_l, resp_l, valid_l, oct_l = [], [], [], [], []
    for lvl in range(params.n_levels):
        h, w = sizes[lvl]
        o = offs[lvl]
        hs = (h + CELL - 1) // CELL * CELL  # gap rows are zero-score
        sl = jax.lax.dynamic_slice(score, (o, 0), (hs, WA))
        pl_ = jax.lax.dynamic_slice(pass_ini, (o, 0), (hs, WA))
        x, y, resp, valid = _select_level(sl, pl_, budgets[lvl])
        xs_l.append(x)
        ys_l.append(y + float(o))  # atlas coords
        resp_l.append(resp)
        valid_l.append(valid)
        oct_l.append(jnp.full(x.shape, lvl, jnp.int32))
    xa = jnp.concatenate(xs_l)
    ya = jnp.concatenate(ys_l)
    resp = jnp.concatenate(resp_l)
    valid = jnp.concatenate(valid_l)
    octave = jnp.concatenate(oct_l)

    # --- one patch gather serves angle + blur + descriptor -----------------
    xi = xa.astype(jnp.int32)
    yi = ya.astype(jnp.int32)
    patch = _extract_patches(atlas, xi, yi, _PATCH, _PCTR)
    wx, wy = _IC_WX_WY
    m10 = jnp.einsum("npq,pq->n", patch, wx)
    m01 = jnp.einsum("npq,pq->n", patch, wy)
    ang = jnp.arctan2(m01, m10)
    pblur = _blur_patches(patch)
    desc = _brief_from_patches(pblur, ang)

    # --- atlas coords -> level-0 pixel coords ------------------------------
    off_per_slot = jnp.concatenate(
        [jnp.full((len(x),), float(offs[l]), jnp.float32)
         for l, x in enumerate(xs_l)]
    )
    scale_per_slot = jnp.concatenate(
        [jnp.full((len(x),), float(params.scale_factor**l), jnp.float32)
         for l, x in enumerate(xs_l)]
    )
    uv0 = jnp.stack([xa, ya - off_per_slot], axis=-1) * scale_per_slot[:, None]
    return Features(
        uv=uv0, response=resp, octave=octave, angle=ang, desc=desc, valid=valid
    )


_IC_WX_WY = tuple(jnp.asarray(a) for a in _ic_weights(_PATCH, _PCTR))


def _extract_reference_loop(image: jnp.ndarray, params: OrbParams) -> Features:
    """Per-level loop formulation kept for differential testing
    (slow path; `tests/test_features.py` exercises `extract`)."""
    H, W = image.shape
    budgets = level_budgets(params)
    outs = []
    lvl_img = image
    for lvl in range(params.n_levels):
        scale = params.scale_factor**lvl
        if lvl > 0:
            h = int(round(H / scale))
            w = int(round(W / scale))
            lvl_img = jax.image.resize(image, (h, w), method="bilinear")
        h, w = lvl_img.shape
        score, pass_ini = fast_score(lvl_img, params.min_th, params.ini_th)
        score = _nms3(score)
        # Border mask: FAST ring + descriptor reach.
        b = EDGE_THRESHOLD
        ys = jnp.arange(h)[:, None]
        xs = jnp.arange(w)[None, :]
        inside = (ys >= b) & (ys < h - b) & (xs >= b) & (xs < w - b)
        score = jnp.where(inside, score, 0.0)

        x, y, resp, valid = _select_level(score, pass_ini, budgets[lvl])

        ang = ic_angle(lvl_img, x, y)
        blurred = gaussian_blur7(lvl_img)
        desc = brief_descriptor(blurred, x, y, ang)

        uv0 = jnp.stack([x, y], axis=-1) * scale
        outs.append(
            Features(
                uv=uv0,
                response=resp,
                octave=jnp.full(x.shape, lvl, jnp.int32),
                angle=ang,
                desc=desc,
                valid=valid,
            )
        )
    return Features(
        uv=jnp.concatenate([o.uv for o in outs]),
        response=jnp.concatenate([o.response for o in outs]),
        octave=jnp.concatenate([o.octave for o in outs]),
        angle=jnp.concatenate([o.angle for o in outs]),
        desc=jnp.concatenate([o.desc for o in outs]),
        valid=jnp.concatenate([o.valid for o in outs]),
    )


# vmapped stereo pair extraction — replaces the reference's per-frame
# left/right std::thread pair (`src/Frame.cc:111-112`): the batch dimension
# of 2 rides the same kernels.
extract_pair = jax.jit(
    jax.vmap(lambda im, p: extract(im, p), in_axes=(0, None)), static_argnames=("p",)
)


def scale_factors(params: OrbParams) -> np.ndarray:
    return params.scale_factor ** np.arange(params.n_levels, dtype=np.float32)


def sigma2(params: OrbParams) -> np.ndarray:
    """Per-octave measurement variance (ref `mvLevelSigma2`)."""
    return scale_factors(params) ** 2
