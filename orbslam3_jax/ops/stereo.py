"""Stereo correspondence: rectified scanline search + subpixel refinement,
RGB-D depth injection, and fisheye two-camera triangulation.

Re-design of the reference's per-frame stereo pipeline:

* `Frame::ComputeStereoMatches` (`/root/reference/src/Frame.cc:955-1135`):
  row-bucketed Hamming search + SAD parabola subpixel + median outlier
  cut. Here the row bucketing is a mask on the full Hamming matrix (one
  matmul); the SAD refinement is a batched gather over candidate
  shifts; the median cut is one quantile reduction.
* `Frame::ComputeStereoFromRGBD` (`Frame.cc:1136`): fake right-u from a
  depth map.
* `Frame::ComputeStereoFishEyeMatches` (`Frame.cc:1281`) +
  `KannalaBrandt8::TriangulateMatches` (`KannalaBrandt8.cpp:334`):
  brute-force match of lapping-area descriptors + two-view midpoint/DLT
  triangulation with the right-to-left extrinsics.
"""

from __future__ import annotations

import functools
from typing import NamedTuple, Tuple

import jax
import jax.numpy as jnp
import numpy as np

from orbslam3_jax.ops import cameras as cam
from orbslam3_jax.ops import features as feat
from orbslam3_jax.ops import lie, matching


class StereoMatches(NamedTuple):
    ur: jnp.ndarray  # (N,) refined right-image u per left feature; <0 = none
    depth: jnp.ndarray  # (N,) bf / disparity; <0 = none
    valid: jnp.ndarray  # (N,)


@functools.partial(jax.jit, static_argnames=())
def match_stereo_rectified(
    fl: feat.Features,
    fr_: feat.Features,
    img_left: jnp.ndarray,
    img_right: jnp.ndarray,
    bf: float,
    scale_factors: jnp.ndarray,  # (L,)
    min_z: float = 0.1,
) -> StereoMatches:
    """Rectified stereo matching for all left keypoints at once.

    Row gate: |v_l - v_r| <= 2 * scale(oct_r) (the reference buckets rows
    by `2*sigma` of the right keypoint's octave, `Frame.cc:975-1000`);
    disparity gate [0.01, bf/min_z]; octave gate +-1; then best Hamming;
    then SAD parabola subpixel on an 11x11 window over +-5 px.
    """
    max_d = bf / min_z
    du = fl.uv[:, 0:1] - fr_.uv[None, :, 0]  # candidate disparity
    dv = jnp.abs(fl.uv[:, 1:2] - fr_.uv[None, :, 1])
    r_tol = 2.0 * scale_factors[jnp.clip(fr_.octave, 0, scale_factors.shape[0] - 1)]
    row_ok = dv <= r_tol[None, :]
    disp_ok = (du >= 0.01) & (du <= max_d)
    oct_ok = jnp.abs(fl.octave[:, None] - fr_.octave[None, :]) <= 1
    mask = row_ok & disp_ok & oct_ok
    # thOrbDist = (TH_HIGH + TH_LOW) / 2 (`Frame.cc:967`): the scanline
    # accepts only comfortably-good descriptor matches; borderline ones
    # are exactly the wrong-corner aliases that poison depth.
    m = matching.match_nn(
        fl.desc, fr_.desc, fl.valid, fr_.valid,
        max_dist=(matching.TH_HIGH + matching.TH_LOW) // 2,
        ratio=1.0, cross_check=False, extra_mask=mask,
    )

    # --- SAD subpixel refinement (Frame.cc:1045-1105) -------------------
    # 11x11 window around the left kp; slide over the right image +-5 px
    # around the matched right kp's u (at level-0 resolution for
    # simplicity; the reference works at the kp's octave).
    W = 5
    L = 5  # half window
    ys = jnp.arange(-L, L + 1)
    xs = jnp.arange(-L, L + 1)
    yy, xx = jnp.meshgrid(ys, xs, indexing="ij")  # (11,11)

    xl = jnp.round(fl.uv[:, 0]).astype(jnp.int32)
    yl = jnp.round(fl.uv[:, 1]).astype(jnp.int32)
    ur0 = fr_.uv[jnp.clip(m.idx, 0), 0]
    xr0 = jnp.round(ur0).astype(jnp.int32)

    def gather(img, cx, cy):
        H, Wd = img.shape
        gx = jnp.clip(cx[:, None, None] + xx[None], 0, Wd - 1)
        gy = jnp.clip(cy[:, None, None] + yy[None], 0, H - 1)
        return img[gy, gx]  # (N,11,11)

    patch_l = gather(img_left, xl, yl)
    patch_l = patch_l - patch_l[:, L : L + 1, L : L + 1]  # center-normalized
    shifts = jnp.arange(-W, W + 1)  # (11,)

    def sad_at(shift):
        p = gather(img_right, xr0 + shift, yl)
        p = p - p[:, L : L + 1, L : L + 1]
        return jnp.sum(jnp.abs(p - patch_l), axis=(1, 2))  # (N,)

    sads = jax.vmap(sad_at, out_axes=1)(shifts)  # (N, 11)
    best = jnp.argmin(sads, axis=1)
    # A minimum at the search-window edge means the true correlation
    # minimum wasn't bracketed — REJECT, don't clamp (`Frame.cc:1080-1082`
    # `if(bestincR==-L || bestincR==L) continue;`).
    bracketed = (best > 0) & (best < 2 * W)
    best_c = jnp.clip(best, 1, 2 * W - 1)
    s_m1 = jnp.take_along_axis(sads, (best_c - 1)[:, None], 1)[:, 0]
    s_0 = jnp.take_along_axis(sads, best_c[:, None], 1)[:, 0]
    s_p1 = jnp.take_along_axis(sads, (best_c + 1)[:, None], 1)[:, 0]
    denom = s_m1 + s_p1 - 2 * s_0
    delta = jnp.where(jnp.abs(denom) > 1e-6, 0.5 * (s_m1 - s_p1) / denom, 0.0)
    # |delta| > 1 = parabola vertex outside the 3-sample bracket — REJECT
    # (`Frame.cc:1091-1093`), the quadratic model didn't fit.
    delta_ok = jnp.abs(delta) <= 1.0
    delta = jnp.clip(delta, -1.0, 1.0)
    ur = xr0.astype(jnp.float32) + (best_c - W).astype(jnp.float32) + delta

    disparity = fl.uv[:, 0] - ur
    ok = m.valid & bracketed & delta_ok & (disparity > 0.01) & (disparity < max_d)
    # Median SAD outlier cut (1.5 * 1.4 * median, Frame.cc:1115-1130).
    best_sad = s_0
    med = jnp.median(jnp.where(ok, best_sad, jnp.nan))
    med = jnp.where(jnp.isnan(med), jnp.inf, med)
    ok &= best_sad <= 2.1 * med
    depth = jnp.where(ok, bf / jnp.maximum(disparity, 1e-6), -1.0)
    return StereoMatches(ur=jnp.where(ok, ur, -1.0), depth=depth, valid=ok)


@jax.jit
def depth_to_ur(
    uv: jnp.ndarray,  # (N,2) keypoints
    valid: jnp.ndarray,
    depth_map: jnp.ndarray,  # (H,W) metric depth
    bf: float,
) -> StereoMatches:
    """RGB-D: `ComputeStereoFromRGBD` (`Frame.cc:1136`) — virtual right
    coordinate ur = u - bf/d at each keypoint."""
    H, W = depth_map.shape
    x = jnp.clip(jnp.round(uv[:, 0]).astype(jnp.int32), 0, W - 1)
    y = jnp.clip(jnp.round(uv[:, 1]).astype(jnp.int32), 0, H - 1)
    d = depth_map[y, x]
    ok = valid & (d > 0)
    ur = jnp.where(ok, uv[:, 0] - bf / jnp.maximum(d, 1e-6), -1.0)
    return StereoMatches(ur=ur, depth=jnp.where(ok, d, -1.0), valid=ok)


class FisheyeStereo(NamedTuple):
    Xl: jnp.ndarray  # (N,3) triangulated points in LEFT camera frame
    depth: jnp.ndarray  # (N,) z in left frame
    right_idx: jnp.ndarray  # (N,) matched right feature (-1 none)
    valid: jnp.ndarray


@functools.partial(jax.jit, static_argnames=("model",))
def match_stereo_fisheye(
    model: cam.CameraModel,
    params_l: jnp.ndarray,
    params_r: jnp.ndarray,
    fl: feat.Features,
    fr_: feat.Features,
    R_rl: jnp.ndarray,  # (3,3) right <- left extrinsics
    t_rl: jnp.ndarray,  # (3,)
    sigma2_table: jnp.ndarray,
    lap_l: Tuple[float, float] = (0.0, 511.0),  # left lapping area u-range
    lap_r: Tuple[float, float] = (0.0, 511.0),
) -> FisheyeStereo:
    """`ComputeStereoFishEyeMatches` (`Frame.cc:1281`): BF-match
    descriptors restricted to the lapping areas, triangulate each match
    with the known extrinsics, gate by parallax + reprojection."""
    in_lap_l = (fl.uv[:, 0] >= lap_l[0]) & (fl.uv[:, 0] <= lap_l[1])
    in_lap_r = (fr_.uv[:, 0] >= lap_r[0]) & (fr_.uv[:, 0] <= lap_r[1])
    m = matching.match_nn(
        fl.desc, fr_.desc, fl.valid & in_lap_l, fr_.valid & in_lap_r,
        max_dist=matching.TH_LOW, ratio=0.8, cross_check=True,
    )
    idx = jnp.clip(m.idx, 0)
    rays_l = cam.unproject(model, params_l, fl.uv)  # z=1
    rays_r = cam.unproject(model, params_r, fr_.uv[idx])
    # Triangulate in left frame: cameras [I|0] and [R_rl|t_rl].
    from orbslam3_jax.ops.ransac import triangulate_linear

    Xl = triangulate_linear(R_rl, t_rl, rays_l[:, :2], rays_r[:, :2])
    zl = Xl[:, 2]
    Xr = (R_rl @ Xl.T).T + t_rl
    zr = Xr[:, 2]
    # Reprojection gates (TriangulateMatches, KannalaBrandt8.cpp:388-420).
    uvl_hat = cam.project(model, params_l, Xl)
    uvr_hat = cam.project(model, params_r, Xr)
    s2l = sigma2_table[jnp.clip(fl.octave, 0, sigma2_table.shape[0] - 1)]
    s2r = sigma2_table[jnp.clip(fr_.octave[idx], 0, sigma2_table.shape[0] - 1)]
    e_l = jnp.sum((uvl_hat - fl.uv) ** 2, -1) / s2l
    e_r = jnp.sum((uvr_hat - fr_.uv[idx]) ** 2, -1) / s2r
    # Parallax gate (cosParallax < 0.9998).
    r2_in_l = (R_rl.T @ (rays_r - 0.0).T).T  # direction only
    cosp = jnp.sum(rays_l * r2_in_l, -1) / (
        jnp.linalg.norm(rays_l, axis=-1) * jnp.linalg.norm(r2_in_l, axis=-1) + 1e-12
    )
    ok = (
        m.valid & (zl > 0.05) & (zr > 0.05) & (e_l < 5.991) & (e_r < 5.991)
        & (cosp < 0.9998) & jnp.all(jnp.isfinite(Xl), axis=-1)
    )
    return FisheyeStereo(
        Xl=Xl, depth=jnp.where(ok, zl, -1.0), right_idx=jnp.where(ok, m.idx, -1), valid=ok
    )
