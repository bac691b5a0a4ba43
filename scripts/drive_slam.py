"""Drive the FULL SLAM pipeline end-to-end on a rendered synthetic scene.

Runs the real System (tracking -> keyframes -> triangulation -> local BA)
over a synthetic camera sweep and reports keyframes, map points, and ATE
vs ground truth. Evidence line: `DRIVE OK` + printed stats.
"""

import os
import sys

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))
os.environ.setdefault("TF_CPP_MIN_LOG_LEVEL", "3")
from orbslam3_jax.utils import enable_compile_cache

enable_compile_cache()

import numpy as np
import jax.numpy as jnp

from orbslam3_jax.ops import cameras as cam
from orbslam3_jax.ops import features as feat
from orbslam3_jax.ops import lie
from orbslam3_jax.system import System, Sensor
from orbslam3_jax.pipeline.tracking import TrackState
from orbslam3_jax.eval.ate import ate_rmse

H, W = 240, 320
FOCAL = 260.0
rng = np.random.default_rng(3)
params = cam.make_pinhole(FOCAL, FOCAL, W / 2, H / 2)

n_pts = 130
pts = np.stack(
    [rng.uniform(-3.0, 3.0, n_pts), rng.uniform(-2.2, 2.2, n_pts), rng.uniform(3.0, 6.0, n_pts)],
    axis=-1,
).astype(np.float32)
shades = rng.uniform(120, 250, n_pts).astype(np.float32)


def render(R, t):
    img = np.full((H, W), 35.0, np.float32)
    Xc = (R @ pts.T).T + t
    uv = np.asarray(cam.pinhole_project(params, jnp.asarray(Xc)))
    for i in np.argsort(-Xc[:, 2]):
        if Xc[i, 2] < 0.5:
            continue
        u, v = uv[i]
        half = max(2, int(round(12.0 / Xc[i, 2] * 2)))
        ui, vi = int(round(u)), int(round(v))
        if 1 <= ui < W - 1 and 1 <= vi < H - 1:
            img[max(vi - half, 0) : vi + half, max(ui - half, 0) : ui + half] = shades[i]
    return img


n_frames = 12
poses = []
for k in range(n_frames):
    s = k / (n_frames - 1)
    yaw = 0.04 * np.sin(2 * np.pi * s)
    Rcw = np.asarray(lie.exp_so3(jnp.asarray([0.0, yaw, 0.0], jnp.float32)))
    center = np.array([1.6 * s, 0.15 * np.sin(4 * s), 0.5 * s], np.float32)
    poses.append((Rcw.astype(np.float32), (-Rcw @ center).astype(np.float32)))

orb = feat.OrbParams(n_features=400, n_levels=3)
slam = System(Sensor.MONOCULAR, cam.CameraModel.PINHOLE, params, (W, H), orb_params=orb, Kmax=32, Pmax=4096)

for k, (R, t) in enumerate(poses):
    img = render(R, t)
    slam.track_monocular(img, k * 0.1)
    print(f"frame {k}: state={slam.tracking_state.name} kfs={slam.n_keyframes} mps={slam.n_map_points} inliers={slam.tracker.match_inliers}")

assert slam.tracking_state == TrackState.OK, slam.tracking_state
ts_est, pos_est = slam.get_trajectory()
gt_ts = np.arange(n_frames) * 0.1
gt_pos = np.stack([-R.T @ t for R, t in poses])
err = ate_rmse(ts_est, pos_est, gt_ts, gt_pos, with_scale=True, max_dt=0.01)
print(f"ATE RMSE (Sim3-aligned): {err:.4f} m over {len(ts_est)} tracked frames")

# Keyframe trajectory after a final global BA (exercises pipeline/gba.py).
from orbslam3_jax.pipeline.gba import global_ba
from orbslam3_jax.ops.features import sigma2 as sigma2_fn

cost = global_ba(slam.store, cam.CameraModel.PINHOLE, params, sigma2_fn(orb))
s = slam.store.state
kv = np.asarray(s.kf_valid)[: slam.store.n_kf]
kf_ids = np.flatnonzero(kv)
kf_pos = np.stack(
    [-np.asarray(s.kf_R[i]).T @ np.asarray(s.kf_t[i]) for i in kf_ids]
)
kf_ts = slam.store.kf_ts[kf_ids]
kf_err = ate_rmse(kf_ts, kf_pos, gt_ts, gt_pos, with_scale=True, max_dt=0.01)
print(f"KF ATE after global BA: {kf_err:.4f} m over {len(kf_ids)} keyframes (cost {cost:.1f})")
assert err < 0.12, err
assert kf_err < 0.05, kf_err
print("DRIVE OK")
