"""Stereo rectification (`ops/rectify.py`): the LEFT./RIGHT. K/D/R/P
ingestion path of `/root/reference/src/Tracking.cc:299-323` + the ROS
node's per-frame remap, re-expressed as one device gather program.
"""

import numpy as np
import jax.numpy as jnp
import pytest

from orbslam3_jax.config import RectifyConfig
from orbslam3_jax.ops.rectify import StereoRectifier, build_rectify_map, remap_bilinear

FX = FY = 300.0
CX, CY = 160.0, 120.0
W, H = 320, 240
DIST = (-0.28, 0.07, 2e-4, 1.8e-5)


def _distort_project(K, D, X):
    """Forward radtan projection (the model the map must invert)."""
    x = X[:, 0] / X[:, 2]
    y = X[:, 1] / X[:, 2]
    k1, k2, p1, p2 = D
    r2 = x * x + y * y
    rad = 1 + k1 * r2 + k2 * r2 * r2
    xd = x * rad + 2 * p1 * x * y + p2 * (r2 + 2 * x * x)
    yd = y * rad + p1 * (r2 + 2 * y * y) + 2 * p2 * x * y
    return np.stack([K[0, 0] * xd + K[0, 2], K[1, 1] * yd + K[1, 2]], -1)


def _rect_cfg(R):
    K = np.array([[FX, 0, CX], [0, FY, CY], [0, 0, 1.0]])
    P = np.array([[FX, 0, CX, 0], [0, FY, CY, 0], [0, 0, 1.0, 0]])
    return RectifyConfig(K=K, D=np.asarray(DIST), R=R, P=P, width=W, height=H)


def test_remap_rectifies_distorted_points(rng):
    """Bright dots rendered through the DISTORTED raw camera land at their
    ideal pinhole positions after the remap — including a nontrivial
    rectifying rotation (2-degree pitch, like a real calibration)."""
    c, s = np.cos(np.radians(2.0)), np.sin(np.radians(2.0))
    R = np.array([[1, 0, 0], [0, c, -s], [0, s, c]])
    cfg = _rect_cfg(R)

    # Points defined in the RECTIFIED camera frame, visible and central.
    X_rect = np.stack(
        [rng.uniform(-1.2, 1.2, 24), rng.uniform(-0.9, 0.9, 24),
         rng.uniform(3.0, 6.0, 24)], -1,
    )
    u_exp = np.stack(
        [FX * X_rect[:, 0] / X_rect[:, 2] + CX,
         FY * X_rect[:, 1] / X_rect[:, 2] + CY], -1,
    )
    # Same points in the RAW camera frame (X_rect = R X_raw).
    X_raw = X_rect @ R  # rows = R^T @ X_rect
    u_raw = _distort_project(cfg.K, cfg.D, X_raw)

    img_raw = np.zeros((H, W), np.float32)
    for (u, v) in u_raw:
        ui, vi = int(round(u)), int(round(v))
        if 2 <= ui < W - 2 and 2 <= vi < H - 2:
            img_raw[vi - 1 : vi + 2, ui - 1 : ui + 2] = 255.0

    mx, my = build_rectify_map(cfg.K, cfg.D, cfg.R, cfg.P, (W, H))
    out = np.asarray(remap_bilinear(jnp.asarray(img_raw), jnp.asarray(mx),
                                    jnp.asarray(my)))
    n_checked = 0
    for (ue, ve), (ur, vr) in zip(u_exp, u_raw):
        if not (4 <= ur < W - 4 and 4 <= vr < H - 4):
            continue
        if not (4 <= ue < W - 4 and 4 <= ve < H - 4):
            continue
        ui, vi = int(round(ue)), int(round(ve))
        win = out[vi - 3 : vi + 4, ui - 3 : ui + 4]
        assert win.max() > 100.0, "dot vanished in remap"
        # Intensity centroid (the dot was stamped at the ROUNDED raw pixel,
        # so expect up to ~0.5 px quantization + bilinear spread).
        gy, gx = np.mgrid[-3:4, -3:4]
        wsum = win.sum()
        peak = np.array([ui + (win * gx).sum() / wsum,
                         vi + (win * gy).sum() / wsum])
        err = np.linalg.norm(peak - np.array([ue, ve]))
        assert err <= 1.2, (err, (ue, ve))
        n_checked += 1
    assert n_checked >= 10


def test_identity_map_is_noop(rng):
    """Zero distortion + identity R + P = K: the remap must reproduce the
    input (bilinear at integer coordinates)."""
    K = np.array([[FX, 0, CX], [0, FY, CY], [0, 0, 1.0]])
    mx, my = build_rectify_map(K, np.zeros(4), np.eye(3), K, (W, H))
    img = rng.uniform(0, 255, (H, W)).astype(np.float32)
    out = np.asarray(remap_bilinear(jnp.asarray(img), jnp.asarray(mx), jnp.asarray(my)))
    np.testing.assert_allclose(out, img, atol=1e-2)


def test_yaml_rect_block_roundtrip(tmp_path):
    """A reference-format YAML carrying LEFT./RIGHT. blocks parses into
    RectifyConfig and builds a StereoRectifier."""
    import sys, os
    sys.path.insert(0, os.path.join(os.path.dirname(os.path.dirname(
        os.path.abspath(__file__))), "scripts"))
    import make_synth_euroc as gen

    from orbslam3_jax import config as cfg

    p = tmp_path / "raw.yaml"
    p.write_text(gen.raw_stereo_yaml())
    st = cfg.load_settings(str(p))
    assert st.rect_left is not None and st.rect_right is not None
    assert st.rect_left.K[0, 0] == pytest.approx(gen.FX)
    assert st.rect_right.P[0, 3] == pytest.approx(-gen.FX * gen.BASELINE_M)
    rec = StereoRectifier(st.rect_left, st.rect_right)
    img = np.zeros((st.rect_left.height, st.rect_left.width), np.float32)
    l, r = rec(img, img)
    assert l.shape == img.shape and r.shape == img.shape
