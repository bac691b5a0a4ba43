"""Drive the STEREO-FISHEYE (two-camera KB8) pipeline end-to-end — the
reference's TUM-VI stereo configuration (BASELINE config 4): two fisheye
images per frame, lapping-area BF matching + rig triangulation
(`Frame.cc:1187,1281`, `KannalaBrandt8::TriangulateMatches`), single-frame
metric initialization, tracking/mapping on the left camera.

The scene is a textured box room RAY-CAST through the KB8 model (rays
from `cam.unproject` of the pixel grid), so both views are
perspective-correct and geometrically consistent — a requirement for a
metric gate (image-space sprite painting is view-inconsistent under
fisheye distortion and biases triangulated depth).

Gate: SE3 ATE at METRIC scale (no Sim3 scale alignment) — stereo fixes
the scale, so the estimate must be metric out of the box.
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

H, W = 384, 384
params_l = cam.make_kb8(160.0, 160.0, 192.0, 192.0, 0.0035, 0.0007, -0.002, 0.0002)
params_r = cam.make_kb8(160.8, 160.8, 191.5, 192.4, 0.0031, 0.0009, -0.0018, 0.0001)
BASELINE = 0.2  # meters (wide rig keeps disparity well above the 1px grid)
Tlr = np.eye(4, dtype=np.float64)  # right camera pose in LEFT frame
Tlr[0, 3] = BASELINE

# Box room [-3,3]x[-2.2,2.2] x z in [0,4]; camera looks down +z from z~0.5.
BOX_LO = np.array([-3.0, -2.2, 0.0], np.float32)
BOX_HI = np.array([3.0, 2.2, 4.0], np.float32)
FACES = [(0, 0), (0, 1), (1, 0), (1, 1), (2, 0), (2, 1)]
TEX_N = 1024

rng = np.random.default_rng(11)


def make_textures():
    tex = []
    for _ in range(6):
        t = np.full((TEX_N, TEX_N), 128.0, np.float32)
        for size, count in ((120, 40), (60, 160), (28, 500)):
            ys = rng.integers(0, TEX_N - size, count)
            xs = rng.integers(0, TEX_N - size, count)
            vals = rng.uniform(30, 235, count).astype(np.float32)
            for y, x, v in zip(ys, xs, vals):
                t[y : y + size, x : x + size] = v
        tex.append(np.clip(t, 0, 255))
    return np.stack(tex)


TEX = make_textures()


def _kb8_rays(params):
    """Unproject the full pixel grid once: (H, W, 3) unit-z rays."""
    u, v = np.meshgrid(np.arange(W, dtype=np.float32),
                       np.arange(H, dtype=np.float32))
    uv = jnp.asarray(np.stack([u.ravel(), v.ravel()], -1))
    rays = np.asarray(cam.unproject(cam.CameraModel.KB8, jnp.asarray(params), uv))
    return rays.reshape(H, W, 3)


RAYS_L = _kb8_rays(params_l)
RAYS_R = _kb8_rays(params_r)


def render(R_cw, t_cw, rays):
    """Ray-cast the textured box through precomputed camera rays."""
    R_wc = R_cw.T
    o = (-R_wc @ t_cw).astype(np.float32)
    d_w = rays @ R_wc.T  # (H, W, 3)
    best_t = np.full((H, W), np.inf, np.float32)
    best_face = np.full((H, W), -1, np.int8)
    for f, (ax, hi) in enumerate(FACES):
        bound = (BOX_HI if hi else BOX_LO)[ax]
        denom = d_w[..., ax]
        with np.errstate(divide="ignore", invalid="ignore"):
            t = (bound - o[ax]) / denom
        ok = (t > 1e-3) & np.isfinite(t) & (t < best_t)
        best_t = np.where(ok, t, best_t)
        best_face = np.where(ok, np.int8(f), best_face)
    img = np.zeros((H, W), np.float32)
    hit = o[None, None] + best_t[..., None] * d_w
    for f, (ax, hi) in enumerate(FACES):
        m = best_face == f
        if not m.any():
            continue
        axes = [a for a in range(3) if a != ax]
        su = (hit[..., axes[0]][m] - BOX_LO[axes[0]]) / (BOX_HI[axes[0]] - BOX_LO[axes[0]])
        sv = (hit[..., axes[1]][m] - BOX_LO[axes[1]]) / (BOX_HI[axes[1]] - BOX_LO[axes[1]])
        x = np.clip(su * (TEX_N - 1), 0, TEX_N - 1.001)
        y = np.clip(sv * (TEX_N - 1), 0, TEX_N - 1.001)
        x0, y0 = x.astype(np.int32), y.astype(np.int32)
        fx_, fy_ = x - x0, y - y0
        T = TEX[f]
        img[m] = (T[y0, x0] * (1 - fx_) * (1 - fy_) + T[y0, x0 + 1] * fx_ * (1 - fy_)
                  + T[y0 + 1, x0] * (1 - fx_) * fy_ + T[y0 + 1, x0 + 1] * fx_ * fy_)
    return img


def render_pair(Rcw, tcw):
    # Right camera: T_rw = T_rl * T_lw with T_rl = Tlr^-1.
    R_rl = Tlr[:3, :3].T
    t_rl = -R_rl @ Tlr[:3, 3]
    R_r = (R_rl @ Rcw).astype(np.float32)
    t_r = (R_rl @ tcw + t_rl).astype(np.float32)
    return render(Rcw, tcw, RAYS_L), render(R_r, t_r, RAYS_R)


n_frames = 14
poses = []
for k in range(n_frames):
    s = k / (n_frames - 1)
    yaw = -0.06 * s
    Rcw = np.asarray(lie.exp_so3(jnp.asarray([0.0, yaw, 0.0], jnp.float32)))
    center = np.array([-1.2 + 0.9 * s, 0.08 * np.sin(4 * s), 0.5 + 0.25 * s],
                      np.float32)
    poses.append((Rcw.astype(np.float32), (-Rcw @ center).astype(np.float32)))

orb = feat.OrbParams(n_features=500, n_levels=3)
slam = System(
    Sensor.STEREO, cam.CameraModel.KB8, params_l, (W, H),
    orb_params=orb, Kmax=32, Pmax=4096,
    camera2=(params_r, Tlr, (0.0, W - 1.0), (0.0, W - 1.0)),
)

for k, (R, t) in enumerate(poses):
    img_l, img_r = render_pair(R, t)
    slam.track_stereo(img_l, img_r, k * 0.1)
    print(
        f"frame {k}: state={slam.tracking_state.name} kfs={slam.n_keyframes} "
        f"mps={slam.n_map_points} inliers={slam.tracker.match_inliers}",
        flush=True,
    )

assert slam.tracking_state == TrackState.OK, slam.tracking_state
ts, pos = slam.get_trajectory()
gt = np.stack([-R.T @ t for R, t in poses])[-len(ts):]
err_se3 = ate_rmse(ts, pos, ts, gt, with_scale=False)
# Scale audit vs ground truth path length.
est_len = np.linalg.norm(np.diff(pos, axis=0), axis=1).sum()
gt_len = np.linalg.norm(np.diff(gt, axis=0), axis=1).sum()
print(f"stereo-fisheye ATE SE3={err_se3:.4f} m over {len(ts)} frames; "
      f"scale vs GT={est_len / max(gt_len, 1e-9):.3f}")
assert err_se3 < 0.1, f"metric ATE too high: {err_se3}"
assert 0.85 < est_len / gt_len < 1.18, "metric scale off"
print("DRIVE OK")
