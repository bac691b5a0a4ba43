import jax.numpy as jnp
import numpy as np
import pytest

from orbslam3_jax.ops import cameras as cam
from orbslam3_jax.ops import features as feat
from orbslam3_jax.ops import lie, stereo

from tests.test_features import synthetic_corners

SMALL = feat.OrbParams(n_features=300, n_levels=3)


def test_rectified_stereo_depth(rng):
    """Right image = left shifted by a constant disparity -> depth = bf/d."""
    img_l, _ = synthetic_corners(rng, H=240, W=320, n=35)
    disparity = 12
    img_r = np.roll(img_l, -disparity, axis=1)
    fl = feat.extract(jnp.asarray(img_l), SMALL)
    fr_ = feat.extract(jnp.asarray(img_r), SMALL)
    bf = 40.0
    sm = stereo.match_stereo_rectified(
        fl, fr_, jnp.asarray(img_l), jnp.asarray(img_r), bf,
        jnp.asarray(feat.scale_factors(SMALL)),
    )
    ok = np.asarray(sm.valid)
    assert ok.sum() > 20
    d = np.asarray(sm.depth)[ok]
    np.testing.assert_allclose(np.median(d), bf / disparity, rtol=0.05)
    # Subpixel: disparity error under half a pixel for most matches.
    disp = np.asarray(fl.uv)[ok, 0] - np.asarray(sm.ur)[ok]
    assert np.median(np.abs(disp - disparity)) < 0.5


def test_rectified_stereo_fractional_disparity(rng):
    """Fractional-disparity pair on a DISTINCTIVE scene: the SAD refine
    must either bracket its minimum inside the +-5 px window and fit
    |delta|<=1, or reject the match (`Frame.cc:1080-1093` rejects edge
    minima and out-of-bracket parabola vertices instead of clamping).
    Survivors must carry subpixel-accurate disparity."""
    H, W, SS = 240, 320, 3
    z, B, focal = 5.0, 0.12, 260.0
    disparity = focal * B / z  # 6.24 px, deliberately fractional
    n = 60
    cx = rng.uniform(20, W - 20, n)
    cy = rng.uniform(20, H - 20, n)
    shade = rng.uniform(60, 250, (n, 2, 2)).astype(np.float32)

    def render(eye_x):
        img = np.full((H * SS, W * SS), 35.0, np.float32)
        for i in range(n):
            # Constant-depth wall: horizontal shift = focal * eye_x / z.
            u = int(round((cx[i] - focal * eye_x / z) * SS))
            v = int(round(cy[i] * SS))
            h = 7 * SS
            for qy in (0, 1):
                for qx in (0, 1):
                    y0, y1 = (v - h, v) if qy == 0 else (v, v + h)
                    x0, x1 = (u - h, u) if qx == 0 else (u, u + h)
                    img[max(y0, 0) : max(min(y1, H * SS), 0),
                        max(x0, 0) : max(min(x1, W * SS), 0)] = shade[i, qy, qx]
        return img.reshape(H, SS, W, SS).mean(axis=(1, 3))

    img_l = render(0.0)
    img_r = render(B)
    fl = feat.extract(jnp.asarray(img_l), SMALL)
    fr_ = feat.extract(jnp.asarray(img_r), SMALL)
    bf = focal * B
    sm = stereo.match_stereo_rectified(
        fl, fr_, jnp.asarray(img_l), jnp.asarray(img_r), bf,
        jnp.asarray(feat.scale_factors(SMALL)),
    )
    ok = np.asarray(sm.valid)
    assert ok.sum() > 30
    disp = np.asarray(fl.uv)[ok, 0] - np.asarray(sm.ur)[ok]
    err = np.abs(disp - disparity)
    assert np.median(err) < 0.5
    # The rejection gates bound the tail: without them wrong window-edge
    # minima admit multi-pixel disparity errors (>40% depth error).
    assert np.percentile(err, 90) < 1.5


def test_rgbd_ur(rng):
    uv = jnp.asarray([[100.0, 50.0], [10.0, 10.0]])
    depth_map = jnp.full((240, 320), 2.0)
    depth_map = depth_map.at[10, 10].set(0.0)  # invalid depth
    sm = stereo.depth_to_ur(uv, jnp.asarray([True, True]), depth_map, bf=40.0)
    assert np.asarray(sm.valid).tolist() == [True, False]
    np.testing.assert_allclose(float(sm.ur[0]), 100.0 - 20.0, atol=1e-5)


def test_fisheye_stereo_triangulation(rng):
    """Synthetic two-camera fisheye rig: triangulated points must match the
    ground-truth 3D points."""
    params = cam.make_kb8(
        190.978477, 190.973307, 254.931706, 256.897442,
        0.003482389402, 0.000715034845, -0.002053236141, 0.000202936736,
    )
    n = 256
    pts = np.stack(
        [rng.uniform(-1, 1, n), rng.uniform(-1, 1, n), rng.uniform(1.0, 4.0, n)], -1
    ).astype(np.float32)
    R_rl = np.asarray(lie.exp_so3(jnp.asarray([0.0, 0.05, 0.0], jnp.float32)))
    t_rl = np.array([-0.1, 0.0, 0.0], np.float32)
    uv_l = np.asarray(cam.kb8_project(params, jnp.asarray(pts)))
    pts_r = (R_rl @ pts.T).T + t_rl
    uv_r = np.asarray(cam.kb8_project(params, jnp.asarray(pts_r)))

    # Build fake Features with random-but-consistent descriptors.
    desc = rng.integers(0, 256, (n, 32), dtype=np.uint8)
    mk = lambda uv: feat.Features(
        uv=jnp.asarray(uv, jnp.float32),
        response=jnp.ones(n),
        octave=jnp.zeros(n, jnp.int32),
        angle=jnp.zeros(n),
        desc=jnp.asarray(desc),
        valid=jnp.ones(n, bool),
    )
    fs = stereo.match_stereo_fisheye(
        cam.CameraModel.KB8, params, params, mk(uv_l), mk(uv_r),
        jnp.asarray(R_rl), jnp.asarray(t_rl), jnp.ones(8),
        lap_l=(0.0, 512.0), lap_r=(0.0, 512.0),
    )
    ok = np.asarray(fs.valid)
    assert ok.sum() > n * 0.8
    X = np.asarray(fs.Xl)[ok]
    np.testing.assert_allclose(X, pts[ok], atol=0.02)
