"""End-to-end monocular SLAM on a rendered synthetic scene (SURVEY.md §4c:
dataset replay scored by ATE — here with a synthetic sequence since no
dataset ships in CI)."""

import numpy as np
import jax.numpy as jnp
import pytest

from orbslam3_jax.ops import cameras as cam
from orbslam3_jax.ops import features as feat
from orbslam3_jax.ops import lie
from orbslam3_jax.system import System, Sensor
from orbslam3_jax.pipeline.tracking import TrackState
from orbslam3_jax.eval.ate import ate_rmse

H, W = 240, 320
FOCAL = 260.0


def make_world(rng, n=130):
    """Textured wall of squares at varying depth."""
    pts = np.stack(
        [rng.uniform(-3.0, 3.0, n), rng.uniform(-2.2, 2.2, n), rng.uniform(3.0, 6.0, n)],
        axis=-1,
    ).astype(np.float32)
    shades = rng.uniform(120, 250, n).astype(np.float32)
    return pts, shades


def render(params, R, t, pts, shades):
    img = np.full((H, W), 35.0, np.float32)
    Xc = (R @ pts.T).T + t
    uv = np.asarray(cam.pinhole_project(params, jnp.asarray(Xc)))
    order = np.argsort(-Xc[:, 2])  # far first
    for i in order:
        if Xc[i, 2] < 0.5:
            continue
        u, v = uv[i]
        half = max(2, int(round(12.0 / Xc[i, 2] * 2)))
        ui, vi = int(round(u)), int(round(v))
        if 1 <= ui < W - 1 and 1 <= vi < H - 1:
            u0, u1 = max(ui - half, 0), min(ui + half, W)
            v0, v1 = max(vi - half, 0), min(vi + half, H)
            img[v0:v1, u0:u1] = shades[i]
    return img


def camera_path(n_frames):
    """Slow lateral arc with slight yaw, keeping the wall in view."""
    poses = []
    for k in range(n_frames):
        s = k / max(n_frames - 1, 1)
        yaw = 0.04 * np.sin(2 * np.pi * s)
        Rcw = np.asarray(lie.exp_so3(jnp.asarray([0.0, yaw, 0.0], jnp.float32)))
        center = np.array([1.6 * s, 0.15 * np.sin(4 * s), 0.5 * s], np.float32)
        tcw = -Rcw @ center
        poses.append((Rcw.astype(np.float32), tcw.astype(np.float32)))
    return poses


@pytest.mark.slow
def test_e2e_mono_synthetic(rng):
    params = cam.make_pinhole(FOCAL, FOCAL, W / 2, H / 2)
    pts, shades = make_world(rng)
    n_frames = 12
    poses = camera_path(n_frames)
    orb = feat.OrbParams(n_features=400, n_levels=3)
    slam = System(
        Sensor.MONOCULAR, cam.CameraModel.PINHOLE, params, (W, H),
        orb_params=orb, Kmax=32, Pmax=4096,
    )
    for k, (R, t) in enumerate(poses):
        img = render(params, R, t, pts, shades)
        slam.track_monocular(img, k * 0.1)

    assert slam.tracking_state == TrackState.OK
    assert slam.n_keyframes >= 2
    assert slam.n_map_points > 50

    ts_est, pos_est = slam.get_trajectory()
    assert len(ts_est) >= n_frames - 3  # init consumes the first frames
    gt_ts = np.arange(n_frames) * 0.1
    gt_pos = np.stack([-R.T @ t for R, t in poses])
    err = ate_rmse(ts_est, pos_est, gt_ts, gt_pos, with_scale=True, max_dt=0.01)
    # Trajectory length ~0.9m; demand cm-level ATE after Sim3 alignment.
    assert err < 0.05, f"ATE {err:.4f} m"
