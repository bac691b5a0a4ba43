"""Drive the public API end-to-end on a synthetic scene (verification harness).

Simulates a camera viewing a random 3D point cloud from two poses, renders
corner-rich images, then runs the real pipeline: extract -> match ->
pose-only optimization, and reports reprojection statistics.
"""

import os
import sys

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))
os.environ.setdefault("TF_CPP_MIN_LOG_LEVEL", "3")
from orbslam3_jax.utils import enable_compile_cache
enable_compile_cache()

import numpy as np
import jax.numpy as jnp

from orbslam3_jax.ops import features as feat
from orbslam3_jax.ops import matching, lie
from orbslam3_jax.ops import cameras as cam
from orbslam3_jax.optim import pose_only

rng = np.random.default_rng(7)
H, W = 480, 640
K = cam.make_pinhole(450.0, 450.0, W / 2, H / 2)

# 3D points in front of the camera
n_pts = 150
Xw = np.stack(
    [rng.uniform(-2, 2, n_pts), rng.uniform(-1.5, 1.5, n_pts), rng.uniform(4, 10, n_pts)],
    axis=-1,
).astype(np.float32)


def render(R, t):
    """Render squares at projected point locations."""
    uv = np.asarray(cam.pinhole_project(K, lie.se3_apply(jnp.asarray(R), jnp.asarray(t), jnp.asarray(Xw))))
    img = np.full((H, W), 40.0, np.float32)
    for (u, v) in uv:
        ui, vi = int(round(u)), int(round(v))
        if 25 <= ui < W - 25 and 25 <= vi < H - 25:
            img[vi - 4 : vi + 4, ui - 4 : ui + 4] = 230.0
    return img, uv


R1, t1 = np.eye(3, dtype=np.float32), np.zeros(3, np.float32)
w2 = np.array([0.02, -0.03, 0.01], np.float32)
R2 = np.asarray(lie.exp_so3(jnp.asarray(w2)))
t2 = np.array([0.15, -0.05, 0.1], np.float32)

img1, uv1_true = render(R1, t1)
img2, uv2_true = render(R2, t2)

P = feat.OrbParams(n_features=500, n_levels=4)
f1 = feat.extract(jnp.asarray(img1), P)
f2 = feat.extract(jnp.asarray(img2), P)
print(f"frame1: {int(np.sum(np.asarray(f1.valid)))} keypoints; frame2: {int(np.sum(np.asarray(f2.valid)))}")

m = matching.match_nn(f1.desc, f2.desc, f1.valid, f2.valid, max_dist=50, ratio=0.85)
print(f"matches: {int(np.sum(np.asarray(m.valid)))}")

# Associate frame-2 keypoints with 3D points via ground-truth projections,
# then run pose-only optimization from a perturbed initial pose.
kp2 = np.asarray(f2.uv)
valid2 = np.asarray(f2.valid)
d = np.linalg.norm(kp2[:, None, :] - uv2_true[None, :, :], axis=-1)
nearest = d.argmin(axis=1)
ok = (d.min(axis=1) < 6.0) & valid2
N = 512
Xw_obs = np.zeros((N, 3), np.float32)
uv_obs = np.zeros((N, 2), np.float32)
val = np.zeros(N, bool)
n_use = min(ok.sum(), N)
sel = np.flatnonzero(ok)[:n_use]
Xw_obs[:n_use] = Xw[nearest[sel]]
uv_obs[:n_use] = kp2[sel]
val[:n_use] = True
print(f"pose obs: {n_use}")

obs = pose_only.PoseObs(
    Xw=jnp.asarray(Xw_obs),
    uv=jnp.asarray(uv_obs),
    ur=jnp.full(N, -1.0),
    sigma2=jnp.ones(N),
    valid=jnp.asarray(val),
)
# Perturb the true pose.
R0 = np.asarray(lie.exp_so3(jnp.asarray([0.05, -0.04, 0.03]))) @ R2
t0 = t2 + np.array([0.2, -0.1, 0.15], np.float32)
res = pose_only.optimize_pose(cam.CameraModel.PINHOLE, K, jnp.asarray(R0), jnp.asarray(t0), obs)
R_err = np.asarray(lie.log_so3(jnp.asarray(R2.T) @ res.R))
t_err = np.asarray(res.t) - t2
print(f"inliers: {int(res.n_inliers)}/{n_use}")
print(f"rot err (rad): {np.linalg.norm(R_err):.5f}  trans err (m): {np.linalg.norm(t_err):.5f}")
assert np.linalg.norm(R_err) < 5e-3 and np.linalg.norm(t_err) < 2e-2, "pose optimization did not converge"
print("DRIVE OK")
