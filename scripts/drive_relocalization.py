"""Drive RELOCALIZATION end-to-end: a monocular camera orbits inside a
textured cylinder, loses tracking mid-orbit when the frontier outruns the
map, and must RELOCALIZE (KFDB query -> PnP RANSAC -> pose refinement)
when it revisits the mapped region, then resume mapping.

(When tracking survives the full orbit this also exercises loop closure —
the LoopCloser runs on every keyframe here.)
"""

import os
import sys

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))
os.environ.setdefault("TF_CPP_MIN_LOG_LEVEL", "3")
from orbslam3_jax.utils import enable_compile_cache

enable_compile_cache()

import numpy as np
import jax.numpy as jnp

from orbslam3_jax.ops import bow
from orbslam3_jax.ops import cameras as cam
from orbslam3_jax.ops import features as feat
from orbslam3_jax.ops import lie
from orbslam3_jax.system import System, Sensor
from orbslam3_jax.pipeline.tracking import TrackState
from orbslam3_jax.eval.ate import ate_rmse

H, W = 240, 320
FOCAL = 180.0
rng = np.random.default_rng(21)
params = cam.make_pinhole(FOCAL, FOCAL, W / 2, H / 2)

# World: points on a cylinder wall (radius 8) around the origin.
n_pts = 420
ang = rng.uniform(0, 2 * np.pi, n_pts)
pts = np.stack(
    [8.0 * np.sin(ang), rng.uniform(-2.5, 2.5, n_pts), 8.0 * np.cos(ang)], axis=-1
).astype(np.float32)
quad_shades = rng.uniform(50, 250, (n_pts, 2, 2)).astype(np.float32)


def render(Rcw, tcw):
    img = np.full((H, W), 35.0, np.float32)
    Xc = (Rcw @ pts.T).T + tcw
    uv = np.asarray(cam.pinhole_project(params, jnp.asarray(Xc)))
    for i in np.argsort(-Xc[:, 2]):
        if Xc[i, 2] < 0.5:
            continue
        u, v = uv[i]
        half = max(3, int(round(16.0 / Xc[i, 2] * 2)))
        ui, vi = int(round(u)), int(round(v))
        if 1 <= ui < W - 1 and 1 <= vi < H - 1:
            for qy in (0, 1):
                for qx in (0, 1):
                    y0, y1 = (vi - half, vi) if qy == 0 else (vi, vi + half)
                    x0, x1 = (ui - half, ui) if qx == 0 else (ui, ui + half)
                    img[max(y0, 0) : min(y1, H), max(x0, 0) : min(x1, W)] = quad_shades[i, qy, qx]
    return img


# Camera path: circle of radius 2 inside the cylinder, looking outward
# along the motion tangent... looking radially outward.
n_frames = 112


def pose(k):
    th = 2 * np.pi * (k / (n_frames - 14))  # revisit start before the end
    center = np.array([2.0 * np.sin(th), 0.0, 2.0 * np.cos(th)])
    # Look outward: camera z axis along +radial direction.
    Rwc = np.asarray(lie.exp_so3(jnp.asarray([0.0, th, 0.0], jnp.float32)))
    Rcw = Rwc.T
    return Rcw.astype(np.float32), (-Rcw @ center).astype(np.float32)


poses = [pose(k) for k in range(n_frames)]
orb = feat.OrbParams(n_features=400, n_levels=3)
slam = System(
    Sensor.MONOCULAR, cam.CameraModel.PINHOLE, params, (W, H),
    orb_params=orb, Kmax=128, Pmax=16384,
)

# Vocabulary trained on descriptors from a few rendered views.
train_desc = []
for k in range(0, n_frames, 12):
    img = render(*poses[k])
    f = feat.extract(jnp.asarray(img), orb)
    train_desc.append(np.asarray(f.desc)[np.asarray(f.valid)])
voc = bow.build_vocabulary(np.concatenate(train_desc), k=8, depth=3, seed=0)
print(f"vocabulary: {voc.n_words} words")
slam.enable_place_recognition(voc, run_gba=True, min_bow_matches=15, min_sim3_inliers=12)

gt = []
for k in range(n_frames):
    R, t = poses[k]
    gt.append(-R.T @ t)
    img = render(R, t)
    slam.track_monocular(img, k * 0.1)
    lc = slam.loop_closer.n_loops_closed
    print(
        f"frame {k}: state={slam.tracking_state.name} kfs={slam.n_keyframes} "
        f"mps={slam.n_map_points} loops={lc}", flush=True,
    )

# Tracking must have been lost at some point and RECOVERED by
# relocalization (state OK at the end with the map still growing).
assert slam.tracking_state == TrackState.OK, slam.tracking_state
ts_est, pos_est = slam.get_trajectory()
n_tracked = len(ts_est)
print(
    f"tracked {n_tracked}/{n_frames} frames; loops={slam.loop_closer.n_loops_closed}; "
    f"final kfs={slam.n_keyframes}"
)
assert n_tracked < n_frames, "never lost: scenario did not exercise recovery"
# Frames after re-entry must be tracked again.
assert ts_est[-1] > (n_frames - 4) * 0.1 - 1e-6, "did not relocalize at revisit"
print("DRIVE OK")
