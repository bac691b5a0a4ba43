import os

import numpy as np
import pytest

from orbslam3_jax import config as cfg
from orbslam3_jax.io import trajectory as tio
from orbslam3_jax.eval.ate import ate_rmse, umeyama
from orbslam3_jax.ops import cameras as cam


REFERENCE_YAML = "/root/reference/Examples/Monocular/EuRoC.yaml"
REFERENCE_FISHEYE = "/root/reference/Examples/Monocular/TUM_512.yaml"
REFERENCE_IMU_YAML = "/root/reference/Examples/Monocular-Inertial/EuRoC.yaml"


@pytest.mark.skipif(not os.path.exists(REFERENCE_YAML), reason="reference not mounted")
def test_load_reference_euroc_yaml():
    s = cfg.load_settings(REFERENCE_YAML)
    assert s.camera.model == cam.CameraModel.PINHOLE
    np.testing.assert_allclose(s.camera.params[0], 458.654, rtol=1e-6)
    assert s.orb.n_features in (1000, 1200)
    assert s.camera.fps == 20.0


@pytest.mark.skipif(not os.path.exists(REFERENCE_FISHEYE), reason="reference not mounted")
def test_load_reference_fisheye_yaml():
    s = cfg.load_settings(REFERENCE_FISHEYE)
    assert s.camera.model == cam.CameraModel.KB8
    assert abs(s.camera.params[0] - 190.978477) < 1e-3


@pytest.mark.skipif(not os.path.exists(REFERENCE_IMU_YAML), reason="reference not mounted")
def test_load_reference_imu_yaml():
    s = cfg.load_settings(REFERENCE_IMU_YAML)
    assert s.imu is not None
    assert s.imu.freq == 200.0
    assert s.imu.Tbc.shape == (4, 4)


def test_trajectory_roundtrip(tmp_path, rng):
    from orbslam3_jax.ops import lie
    import jax.numpy as jnp

    n = 20
    ts = np.arange(n) * 0.05
    Rs = [np.asarray(lie.exp_so3(jnp.asarray(rng.normal(0, 0.3, 3), jnp.float32))) for _ in range(n)]
    tsl = [rng.normal(0, 1.0, 3) for _ in range(n)]
    path = str(tmp_path / "traj.txt")
    tio.save_tum(path, ts, Rs, tsl)
    ts2, pos, quat = tio.load_tum(path)
    np.testing.assert_allclose(ts2, ts, atol=1e-9)
    np.testing.assert_allclose(pos, np.stack(tsl), atol=1e-6)


def test_umeyama_alignment(rng):
    src = rng.normal(size=(50, 3))
    from scipy.spatial.transform import Rotation

    R_true = Rotation.from_rotvec([0.3, -0.2, 0.5]).as_matrix()
    s_true, t_true = 2.5, np.array([1.0, -2.0, 0.5])
    dst = s_true * (R_true @ src.T).T + t_true
    s, R, t = umeyama(src, dst)
    assert abs(s - s_true) < 1e-9
    np.testing.assert_allclose(R, R_true, atol=1e-9)
    np.testing.assert_allclose(t, t_true, atol=1e-9)


def test_ate_rmse_known_error(rng):
    ts = np.arange(100) * 0.1
    gt = np.cumsum(rng.normal(0, 0.05, (100, 3)), axis=0)
    est = gt + rng.normal(0, 0.01, (100, 3))
    err = ate_rmse(ts, est, ts, gt, with_scale=False)
    assert 0.005 < err < 0.03


def test_save_trajectory_euroc(tmp_path, rng):
    """`System.save_trajectory_euroc` semantics vs `System.cc:599-712`:
    largest-map selection, first-KF re-rooting, EuRoC row format."""
    import jax.numpy as jnp
    from orbslam3_jax.ops import features as feat
    from orbslam3_jax.system import System, Sensor

    params = cam.make_pinhole(100.0, 100.0, 64.0, 48.0)
    slam = System(
        Sensor.MONOCULAR, cam.CameraModel.PINHOLE, params, (128, 96),
        orb_params=feat.OrbParams(n_features=64, n_levels=2),
        Kmax=8, Pmax=256,
    )
    st = slam.store
    # Two keyframes; the FIRST is deliberately NOT at the origin.
    R0 = np.asarray(
        [[0.0, -1.0, 0.0], [1.0, 0.0, 0.0], [0.0, 0.0, 1.0]], np.float32)
    t0 = np.asarray([1.0, 2.0, 3.0], np.float32)
    R1 = np.eye(3, dtype=np.float32)
    t1 = np.asarray([0.5, 0.0, 0.0], np.float32)
    st.state = st.state._replace(
        kf_R=st.state.kf_R.at[0].set(jnp.asarray(R0)).at[1].set(jnp.asarray(R1)),
        kf_t=st.state.kf_t.at[0].set(jnp.asarray(t0)).at[1].set(jnp.asarray(t1)),
        kf_valid=st.state.kf_valid.at[0].set(True).at[1].set(True),
    )
    st.n_kf = 2
    # Frame entries: one per KF (identity relative pose), plus one entry
    # from a DIFFERENT (smaller) store that must be skipped.
    I, z = np.eye(3, dtype=np.float32), np.zeros(3, np.float32)
    slam.tracker.trajectory = [
        (0.0, st, 0, I, z),
        (0.1, st, 1, I, z),
        (0.2, object(), 0, I, z),  # foreign map stand-in
    ]
    out = tmp_path / "euroc.txt"
    slam.save_trajectory_euroc(str(out))
    rows = [l.split() for l in out.read_text().splitlines()]
    assert len(rows) == 2 and all(len(r) == 8 for r in rows)
    # First exported pose is the new origin (first-KF re-rooting).
    v0 = np.asarray([float(x) for x in rows[0]])
    np.testing.assert_allclose(v0[1:4], 0.0, atol=1e-6)
    np.testing.assert_allclose(v0[4:7], 0.0, atol=1e-6)  # identity quat
    np.testing.assert_allclose(abs(v0[7]), 1.0, atol=1e-6)
    # Second pose: relative transform kf1 vs kf0 expressed in kf0 frame.
    T0 = np.eye(4); T0[:3, :3] = R0; T0[:3, 3] = t0
    T1 = np.eye(4); T1[:3, :3] = R1; T1[:3, 3] = t1
    Trel = np.linalg.inv(T1 @ np.linalg.inv(T0))  # Twc of frame1 re-rooted
    v1 = np.asarray([float(x) for x in rows[1]])
    np.testing.assert_allclose(v1[1:4], Trel[:3, 3], atol=1e-5)
    slam.shutdown()
