"""Shared synthetic-scene generators for module tests (SURVEY.md §4:
module tests on synthetic scenes — known poses/points => residuals ~ 0)."""

import numpy as np
import jax.numpy as jnp

from orbslam3_jax.ops import cameras as cam
from orbslam3_jax.ops import lie


def make_scene(
    rng,
    n_cams=8,
    n_pts=200,
    model=cam.CameraModel.PINHOLE,
    params=None,
    img_wh=(640, 480),
    noise_px=0.0,
    radius=5.0,
):
    """Cameras on an arc looking at a point cloud; returns ground truth and
    dense visibility. Poses are Tcw (world->camera)."""
    if params is None:
        params = cam.make_pinhole(450.0, 450.0, img_wh[0] / 2, img_wh[1] / 2)
    pts = np.stack(
        [
            rng.uniform(-3, 3, n_pts),
            rng.uniform(-2, 2, n_pts),
            rng.uniform(-1.5, 1.5, n_pts),
        ],
        axis=-1,
    ).astype(np.float32)

    Rs, ts = [], []
    for i in range(n_cams):
        ang = 0.15 * (i - n_cams / 2)
        # Camera centers on an arc of `radius` behind the cloud, looking at origin.
        center = np.array([radius * np.sin(ang), 0.3 * np.sin(2 * ang), -radius * np.cos(ang)])
        z_axis = -center / np.linalg.norm(center)  # look at origin
        x_axis = np.cross(np.array([0.0, 1.0, 0.0]), z_axis)
        x_axis /= np.linalg.norm(x_axis)
        y_axis = np.cross(z_axis, x_axis)
        Rwc = np.stack([x_axis, y_axis, z_axis], axis=-1)  # world<-cam cols
        Rcw = Rwc.T
        tcw = -Rcw @ center
        Rs.append(Rcw.astype(np.float32))
        ts.append(tcw.astype(np.float32))
    Rs = np.stack(Rs)
    ts = np.stack(ts)

    # Observations: every camera sees every point that projects inside.
    obs_cam, obs_pt, obs_uv = [], [], []
    W, H = img_wh
    for c in range(n_cams):
        Xc = (Rs[c] @ pts.T).T + ts[c]
        uv = np.asarray(cam.project(model, params, jnp.asarray(Xc)))
        vis = (Xc[:, 2] > 0.3) & (uv[:, 0] > 5) & (uv[:, 0] < W - 5) & (uv[:, 1] > 5) & (uv[:, 1] < H - 5)
        for p in np.flatnonzero(vis):
            obs_cam.append(c)
            obs_pt.append(p)
            obs_uv.append(uv[p] + rng.normal(0, noise_px, 2))
    return dict(
        params=params,
        model=model,
        points=pts,
        cam_R=Rs,
        cam_t=ts,
        obs_cam=np.asarray(obs_cam, np.int32),
        obs_point=np.asarray(obs_pt, np.int32),
        obs_uv=np.asarray(obs_uv, np.float32),
    )


def perturb_poses(rng, Rs, ts, rot_sigma=0.02, t_sigma=0.05, keep_first=2):
    Rs2, ts2 = Rs.copy(), ts.copy()
    for i in range(keep_first, len(Rs)):
        dw = rng.normal(0, rot_sigma, 3).astype(np.float32)
        Rs2[i] = np.asarray(lie.exp_so3(jnp.asarray(dw))) @ Rs[i]
        ts2[i] = ts[i] + rng.normal(0, t_sigma, 3).astype(np.float32)
    return Rs2, ts2
