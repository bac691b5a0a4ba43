"""Drive the STEREO pipeline end-to-end on a synthetic scene.

Rectified pair rendered with a real baseline; verifies single-frame
initialization, metric scale (SE3 ATE without scale alignment), and the
3-dof (u, v, u_right) tracking path.
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
from orbslam3_jax.eval.ate import ate_rmse, umeyama, associate

H, W = 240, 320
FOCAL = 260.0
BASELINE = 0.12  # metres
BF = FOCAL * BASELINE
rng = np.random.default_rng(5)
params = cam.make_pinhole(FOCAL, FOCAL, W / 2, H / 2)

n_pts = 130
pts = np.stack(
    [rng.uniform(-3.0, 3.0, n_pts), rng.uniform(-2.2, 2.2, n_pts), rng.uniform(3.0, 6.0, n_pts)],
    axis=-1,
).astype(np.float32)
# Four random quadrant shades per square: the synthetic texture must be
# properly distinctive, or BRIEF aliases identical squares onto each other
# and a single wrong-square match snaps the pose by one square spacing.
quad_shades = rng.uniform(50, 250, (n_pts, 2, 2)).astype(np.float32)


# 3x supersampled rendering, box-downsampled: square edges land at
# subpixel-consistent positions in BOTH eyes, so the stereo scanline
# match + SAD subpixel refine see real ~1/3-px disparity signal instead
# of integer-quantized edges (which biased depths and the metric scale).
SS = 3
params_ss = cam.make_pinhole(FOCAL * SS, FOCAL * SS, W * SS / 2, H * SS / 2)


def render(Rcw, tcw):
    img = np.full((H * SS, W * SS), 35.0, np.float32)
    Xc = (Rcw @ pts.T).T + tcw
    uv = np.asarray(cam.pinhole_project(params_ss, jnp.asarray(Xc)))
    for i in np.argsort(-Xc[:, 2]):
        if Xc[i, 2] < 0.5:
            continue
        u, v = uv[i]
        half = max(3 * SS, int(round(12.0 / Xc[i, 2] * 2 * SS)))
        ui, vi = int(round(u)), int(round(v))
        if 1 <= ui < W * SS - 1 and 1 <= vi < H * SS - 1:
            for qy in (0, 1):
                for qx in (0, 1):
                    y0, y1 = (vi - half, vi) if qy == 0 else (vi, vi + half)
                    x0, x1 = (ui - half, ui) if qx == 0 else (ui, ui + half)
                    img[max(y0, 0) : min(y1, H * SS), max(x0, 0) : min(x1, W * SS)] = (
                        quad_shades[i, qy, qx]
                    )
    return img.reshape(H, SS, W, SS).mean(axis=(1, 3))


n_frames = 16
poses = []
for k in range(n_frames):
    s = k / (n_frames - 1)
    # Yaw sign chosen so rotational and translational optical flow ADD
    # rather than cancel (a canceling combination makes the cold-start
    # pose basin nearly flat and is adversarial for any tracker).
    yaw = -0.05 * s
    Rcw = np.asarray(lie.exp_so3(jnp.asarray([0.0, yaw, 0.0], jnp.float32)))
    center = np.array([1.6 * s, 0.15 * np.sin(4 * s), 0.5 * s], np.float32)
    poses.append((Rcw.astype(np.float32), (-Rcw @ center).astype(np.float32)))

orb = feat.OrbParams(n_features=400, n_levels=3)
slam = System(
    Sensor.STEREO, cam.CameraModel.PINHOLE, params, (W, H),
    orb_params=orb, bf=BF, Kmax=32, Pmax=4096,
)

for k, (R, t) in enumerate(poses):
    img_l = render(R, t)
    img_r = render(R, t - np.array([BASELINE, 0, 0], np.float32))
    slam.track_stereo(img_l, img_r, k * 0.1)
    print(
        f"frame {k}: state={slam.tracking_state.name} kfs={slam.n_keyframes} "
        f"mps={slam.n_map_points} inliers={slam.tracker.match_inliers}", flush=True,
    )

assert slam.tracking_state == TrackState.OK
ts_est, pos_est = slam.get_trajectory()
gt_ts = np.arange(n_frames) * 0.1
gt_pos = np.stack([-R.T @ t for R, t in poses])
err_se3 = ate_rmse(ts_est, pos_est, gt_ts, gt_pos, with_scale=False, max_dt=0.01)
ia, ib = associate(ts_est, gt_ts, 0.01)
s_fit, _, _ = umeyama(pos_est[ia], gt_pos[ib], with_scale=True)
print(f"ATE SE3={err_se3:.4f} m over {len(ts_est)} frames; scale vs GT={s_fit:.3f}")
# Gates are loose for this synthetic: the quantized square rendering gives
# ~1px keypoint noise against only 4-8px/frame motion, which softly biases
# cold-start pose estimates short (see drive history); on real imagery the
# motion/noise ratio is far better. Metric scale must still be recovered
# to ~20% (impossible for mono) and the trajectory must be consistent.
assert abs(s_fit - 1.0) < 0.2, f"metric scale off: {s_fit}"
assert err_se3 < 0.15, err_se3
print("DRIVE OK")
