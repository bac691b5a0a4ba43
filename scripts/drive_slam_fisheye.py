"""Drive the monocular pipeline with the Kannala-Brandt FISHEYE camera
model end-to-end (the reference's TUM-VI configuration path): rendering,
two-view init, tracking, mapping and BA all run through KB8
project/unproject — no pinhole anywhere.
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

H, W = 256, 256
# TUM-VI-style equidistant fisheye scaled to 256x256.
params = cam.make_kb8(95.5, 95.5, 128.0, 128.0, 0.0035, 0.0007, -0.002, 0.0002)
rng = np.random.default_rng(9)

n_pts = 150
pts = np.stack(
    [rng.uniform(-4.0, 4.0, n_pts), rng.uniform(-3.0, 3.0, n_pts), rng.uniform(2.5, 6.0, n_pts)],
    axis=-1,
).astype(np.float32)
quad_shades = rng.uniform(50, 250, (n_pts, 2, 2)).astype(np.float32)


def render(Rcw, tcw):
    img = np.full((H, W), 35.0, np.float32)
    Xc = (Rcw @ pts.T).T + tcw
    uv = np.asarray(cam.kb8_project(params, jnp.asarray(Xc)))
    for i in np.argsort(-Xc[:, 2]):
        if Xc[i, 2] < 0.4:
            continue
        u, v = uv[i]
        half = max(3, int(round(10.0 / Xc[i, 2] * 2)))
        ui, vi = int(round(u)), int(round(v))
        if 1 <= ui < W - 1 and 1 <= vi < H - 1:
            for qy in (0, 1):
                for qx in (0, 1):
                    y0, y1 = (vi - half, vi) if qy == 0 else (vi, vi + half)
                    x0, x1 = (ui - half, ui) if qx == 0 else (ui, ui + half)
                    img[max(y0, 0) : min(y1, H), max(x0, 0) : min(x1, W)] = quad_shades[i, qy, qx]
    return img


n_frames = 12
poses = []
for k in range(n_frames):
    s = k / (n_frames - 1)
    yaw = -0.05 * s
    Rcw = np.asarray(lie.exp_so3(jnp.asarray([0.0, yaw, 0.0], jnp.float32)))
    center = np.array([1.4 * s, 0.12 * np.sin(4 * s), 0.4 * s], np.float32)
    poses.append((Rcw.astype(np.float32), (-Rcw @ center).astype(np.float32)))

orb = feat.OrbParams(n_features=400, n_levels=3)
slam = System(
    Sensor.MONOCULAR, cam.CameraModel.KB8, params, (W, H),
    orb_params=orb, Kmax=32, Pmax=4096,
)

for k, (R, t) in enumerate(poses):
    img = render(R, t)
    slam.track_monocular(img, k * 0.1)
    print(
        f"frame {k}: state={slam.tracking_state.name} kfs={slam.n_keyframes} "
        f"mps={slam.n_map_points} inliers={slam.tracker.match_inliers}", flush=True,
    )

assert slam.tracking_state == TrackState.OK
ts_est, pos_est = slam.get_trajectory()
gt_ts = np.arange(n_frames) * 0.1
gt_pos = np.stack([-R.T @ t for R, t in poses])
err = ate_rmse(ts_est, pos_est, gt_ts, gt_pos, with_scale=True, max_dt=0.01)
print(f"KB8 fisheye ATE RMSE (Sim3): {err:.4f} m over {len(ts_est)} frames")
# Loose gate: at f~95px the synthetic's per-frame image motion is only a
# few pixels against ~1px rendering quantization noise, so absolute
# accuracy is render-limited; the point of this drive is that the entire
# pipeline runs through KB8 project/unproject end-to-end.
assert err < 0.30, err
print("DRIVE OK")
