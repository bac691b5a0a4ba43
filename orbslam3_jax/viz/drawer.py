"""Headless visualization: frame overlays + map renders as numpy images.

Replaces the reference's Pangolin GUI thread (`/root/reference/src/
{Viewer.cc,FrameDrawer.cc,MapDrawer.cc}`) with offline renderers — this
framework targets headless accelerator hosts, so "the viewer" is a function from
state to image (write out with cv2.imwrite / stream from a notebook).
"""

from __future__ import annotations

from typing import Optional

import numpy as np


def _to_bgr(gray: np.ndarray) -> np.ndarray:
    g = np.clip(gray, 0, 255).astype(np.uint8)
    return np.stack([g, g, g], axis=-1)


def draw_frame(
    img: np.ndarray,
    uv: np.ndarray,
    tracked: np.ndarray,
    state_text: str = "",
) -> np.ndarray:
    """`FrameDrawer::DrawFrame` (`FrameDrawer.cc`): keypoints as squares —
    green = tracked (has map point), blue = detected only."""
    import cv2

    out = _to_bgr(img)
    for (u, v), ok in zip(uv, tracked):
        c = (0, 255, 0) if ok else (255, 128, 0)
        cv2.rectangle(out, (int(u) - 3, int(v) - 3), (int(u) + 3, int(v) + 3), c, 1)
    if state_text:
        cv2.putText(out, state_text, (10, 20), cv2.FONT_HERSHEY_SIMPLEX, 0.5, (0, 255, 255), 1)
    return out


def draw_map_topdown(
    mp_pos: np.ndarray,
    mp_valid: np.ndarray,
    kf_centers: np.ndarray,
    kf_valid: np.ndarray,
    traj: Optional[np.ndarray] = None,
    size: int = 640,
    axes=(0, 2),
) -> np.ndarray:
    """`MapDrawer::DrawMapPoints/DrawKeyFrames` equivalent: orthographic
    top-down (x-z by default) scatter of points (white), keyframes (green)
    and the frame trajectory (red)."""
    import cv2

    img = np.zeros((size, size, 3), np.uint8)
    pts = mp_pos[mp_valid]
    all_xy = [pts[:, list(axes)]] if len(pts) else []
    kfs = kf_centers[kf_valid]
    if len(kfs):
        all_xy.append(kfs[:, list(axes)])
    if traj is not None and len(traj):
        all_xy.append(traj[:, list(axes)])
    if not all_xy:
        return img
    allp = np.concatenate(all_xy)
    lo = np.percentile(allp, 2, axis=0)
    hi = np.percentile(allp, 98, axis=0)
    span = np.maximum(hi - lo, 1e-6)
    scale = (size * 0.9) / span.max()
    off = (size - scale * (hi - lo)) / 2

    def to_px(xy):
        p = (xy - lo) * scale + off
        return np.clip(p, 0, size - 1).astype(np.int32)

    if len(pts):
        for x, y in to_px(pts[:, list(axes)]):
            img[y, x] = (200, 200, 200)
    if traj is not None and len(traj):
        px = to_px(traj[:, list(axes)])
        for a, b in zip(px[:-1], px[1:]):
            cv2.line(img, tuple(a), tuple(b), (0, 0, 255), 1)
    if len(kfs):
        for x, y in to_px(kfs[:, list(axes)]):
            cv2.drawMarker(img, (x, y), (0, 255, 0), cv2.MARKER_TILTED_CROSS, 6)
    return img


def render_system(system, out_path: Optional[str] = None) -> np.ndarray:
    """Render the current map of a `System` (top-down)."""
    s = system.store.state
    mp = np.asarray(s.mp_pos)
    mv = np.asarray(s.mp_valid)
    kf_R = np.asarray(s.kf_R)
    kf_t = np.asarray(s.kf_t)
    kv = np.asarray(s.kf_valid)
    centers = np.einsum("kij->kji", kf_R) @ (-kf_t[..., None])
    centers = centers[..., 0]
    ts, traj = system.get_trajectory()
    img = draw_map_topdown(mp, mv, centers, kv, traj if len(ts) else None)
    if out_path:
        import cv2

        cv2.imwrite(out_path, img)
    return img
