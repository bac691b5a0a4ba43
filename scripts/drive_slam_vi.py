"""Drive the monocular-INERTIAL pipeline end-to-end on a synthetic scene.

A body flies a smooth trajectory; IMU samples (200 Hz) are synthesized by
finite differences of the analytic path (with gravity), frames are
rendered at 10 Hz. Verifies: IMU initialization fires (gravity + scale
recovered), tracking switches to IMU prediction, and the METRIC keyframe
trajectory matches ground truth without scale alignment (mono-only could
never do that).
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
from orbslam3_jax.ops import imu as imu_ops
from orbslam3_jax.ops import lie
from orbslam3_jax.system import System, Sensor
from orbslam3_jax.pipeline.tracking import TrackState
from orbslam3_jax.eval.ate import ate_rmse, umeyama

H, W = 240, 320
FOCAL = 260.0
rng = np.random.default_rng(11)
params = cam.make_pinhole(FOCAL, FOCAL, W / 2, H / 2)

# World: wall of textured squares in front (z in 3..6), gravity -z_world...
# NOTE: camera optical axis is +z (towards the wall); gravity acts along
# world -y here so the wall stays vertical: g_world = (0, -9.81, 0)?
# Our preintegration hardcodes gravity -z_world (imu_ops.GRAVITY). So set
# the BODY frame = camera frame and fly the path in a world whose -z is
# "down"; the wall lives in the x-y plane at z 3..6 — i.e. the camera
# looks "down" at a floor. Geometry is the same; only names differ.
n_pts = 130
pts = np.stack(
    [rng.uniform(-3.0, 3.0, n_pts), rng.uniform(-2.2, 2.2, n_pts), rng.uniform(3.0, 6.0, n_pts)],
    axis=-1,
).astype(np.float32)
shades = rng.uniform(120, 250, n_pts).astype(np.float32)


def render(Rcw, tcw):
    img = np.full((H, W), 35.0, np.float32)
    Xc = (Rcw @ pts.T).T + tcw
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


# Analytic body (== camera) trajectory: needs real acceleration for scale
# observability.
def body_pose(t):
    p = np.array(
        [0.9 * np.sin(1.6 * t), 0.3 * np.sin(2.6 * t), 0.4 * (1 - np.cos(1.9 * t))]
    )
    w = np.array([0.0, 0.10 * np.sin(0.8 * t), 0.05 * np.sin(0.5 * t)])
    R = np.asarray(lie.exp_so3(jnp.asarray(w, jnp.float32)))  # R_wb
    return R.astype(np.float64), p


IMU_HZ = 200.0
CAM_HZ = 10.0
T_TOTAL = 6.0
g_world = np.array([0.0, 0.0, -imu_ops.GRAVITY_VALUE])

# Finite-difference IMU synthesis on a fine grid.
fine_dt = 1.0 / 2000.0
ts_fine = np.arange(0.0, T_TOTAL + 2 * fine_dt, fine_dt)
Rs = []
ps = []
for t in ts_fine:
    R, p = body_pose(t)
    Rs.append(R)
    ps.append(p)
Rs = np.stack(Rs)
ps = np.stack(ps)
acc_w = (ps[2:] - 2 * ps[1:-1] + ps[:-2]) / fine_dt**2  # at ts_fine[1:-1]
gyro_b = np.stack(
    [
        np.asarray(lie.log_so3(jnp.asarray((Rs[i].T @ Rs[i + 1]).astype(np.float32))))
        / fine_dt
        for i in range(len(ts_fine) - 1)
    ]
)  # body rates at ts_fine[:-1]

imu_stride = int(round(2000 / IMU_HZ))
imu_idx = np.arange(1, len(ts_fine) - 1, imu_stride)
imu_ts = ts_fine[imu_idx]
imu_acc = np.stack([Rs[i].T @ (acc_w[i - 1] - g_world) for i in imu_idx])
imu_gyro = gyro_b[imu_idx]

calib = imu_ops.ImuCalib.create(
    Rbc=np.eye(3), tbc=np.zeros(3),
    noise_gyro=1.7e-4, noise_acc=2e-3, walk_gyro=1.9e-5, walk_acc=3e-3, freq=IMU_HZ,
)

orb = feat.OrbParams(n_features=400, n_levels=3)
slam = System(
    Sensor.IMU_MONOCULAR, cam.CameraModel.PINHOLE, params, (W, H),
    orb_params=orb, imu_calib=calib, Kmax=64, Pmax=8192,
)

frame_ts = np.arange(0.0, T_TOTAL, 1.0 / CAM_HZ)
imu_cursor = 0
gt = []
for k, t in enumerate(frame_ts):
    R_wb, p_wb = body_pose(t)
    Rcw = R_wb.T.astype(np.float32)  # camera == body
    tcw = (-R_wb.T @ p_wb).astype(np.float32)
    gt.append(p_wb)
    img = render(Rcw, tcw)
    batch = []
    while imu_cursor < len(imu_ts) and imu_ts[imu_cursor] <= t:
        batch.append((imu_ts[imu_cursor], imu_acc[imu_cursor], imu_gyro[imu_cursor]))
        imu_cursor += 1
    import time as _time

    _tic = _time.perf_counter()
    slam.track_monocular(img, t, imu_measurements=batch)
    print(
        f"frame {k}: state={slam.tracking_state.name} kfs={slam.n_keyframes} "
        f"mps={slam.n_map_points} imu_init={slam.mapper.imu_initialized} "
        f"dt={_time.perf_counter() - _tic:.1f}s rss={int(open('/proc/self/status').read().split('VmRSS:')[1].split()[0])//1024}MB", flush=True,
    )

assert slam.tracking_state == TrackState.OK
assert slam.mapper.imu_initialized, "IMU initialization did not fire"

# Metric check: KF positions vs ground truth with SE3 (no scale) alignment.
s = slam.store.state
nkf = slam.store.n_kf
kv = np.asarray(s.kf_valid)[:nkf]
ids = np.flatnonzero(kv)
kf_pos = np.stack([-np.asarray(s.kf_R[i]).T @ np.asarray(s.kf_t[i]) for i in ids])
kf_ts = slam.store.kf_ts[ids]
gt = np.stack(gt)
err_se3 = ate_rmse(kf_ts, kf_pos, frame_ts, gt, with_scale=False, max_dt=0.02)
err_sim3 = ate_rmse(kf_ts, kf_pos, frame_ts, gt, with_scale=True, max_dt=0.02)
# Recovered scale vs ground truth.
from orbslam3_jax.eval.ate import associate

ia, ib = associate(kf_ts, frame_ts, 0.02)
s_fit, _, _ = umeyama(kf_pos[ia], gt[ib], with_scale=True)
print(f"KF ATE SE3={err_se3:.4f} m, Sim3={err_sim3:.4f} m, scale vs GT={s_fit:.3f}")
assert abs(s_fit - 1.0) < 0.08, f"metric scale off: {s_fit}"
assert err_se3 < 0.05, err_se3
print("DRIVE OK")
