"""System control surface: localization-only mode, Reset/ResetActiveMap,
timestamp-anomaly handling, bad-IMU watchdog (ref `System.h:102-178`,
`Tracking.cc:987-1031,3456-3582`, `LocalMapping.cc:183-192`)."""

import numpy as np
import jax.numpy as jnp
import pytest

from orbslam3_jax.ops import cameras as cam
from orbslam3_jax.ops import features as feat
from orbslam3_jax.system import System, Sensor
from orbslam3_jax.pipeline.tracking import TrackState

from test_e2e_mono import H, W, FOCAL, make_world, render, camera_path


def _build_slam():
    params = cam.make_pinhole(FOCAL, FOCAL, W / 2, H / 2)
    orb = feat.OrbParams(n_features=400, n_levels=3)
    slam = System(
        Sensor.MONOCULAR, cam.CameraModel.PINHOLE, params, (W, H),
        orb_params=orb, Kmax=32, Pmax=4096,
    )
    return slam, params


@pytest.mark.slow
def test_localization_only_then_reset(rng):
    slam, params = _build_slam()
    pts, shades = make_world(rng)
    poses = camera_path(12)
    for k, (R, t) in enumerate(poses):
        slam.track_monocular(render(params, R, t, pts, shades), k * 0.1)
    assert slam.tracking_state == TrackState.OK
    n_kf = slam.n_keyframes
    assert n_kf >= 2

    # Localization-only: tracking stays OK, the map is frozen.
    slam.activate_localization_mode()
    for k, (R, t) in enumerate(poses[-4:]):
        slam.track_monocular(render(params, R, t, pts, shades), 1.2 + 0.1 * k)
    assert slam.tracking_state == TrackState.OK
    assert slam.n_keyframes == n_kf, "localization mode must not insert KFs"
    slam.deactivate_localization_mode()

    # ResetActiveMap: map content gone, system re-initializes cleanly.
    slam.reset_active_map()
    assert slam.tracking_state == TrackState.NOT_INITIALIZED
    assert slam.n_keyframes == 0 and slam.n_map_points == 0
    for k, (R, t) in enumerate(poses):
        slam.track_monocular(render(params, R, t, pts, shades), 2.0 + k * 0.1)
    assert slam.tracking_state == TrackState.OK
    assert slam.n_keyframes >= 2

    # Full Reset additionally clears the trajectory.
    slam.reset()
    assert slam.tracking_state == TrackState.NO_IMAGES_YET
    assert len(slam.tracker.trajectory) == 0
    slam.shutdown()


@pytest.mark.slow
def test_timestamp_reorder_resets_active_map(rng):
    slam, params = _build_slam()
    pts, shades = make_world(rng)
    poses = camera_path(12)
    for k, (R, t) in enumerate(poses):
        slam.track_monocular(render(params, R, t, pts, shades), k * 0.1)
    assert slam.n_keyframes >= 2
    # A frame whose timestamp moves backwards resets the active map
    # (`Tracking.cc:987-996`); the offending frame then re-initializes.
    R, t = poses[5]
    slam.track_monocular(render(params, R, t, pts, shades), 0.35)
    assert slam.n_keyframes <= 1  # old map gone (frame may seed a new one)


def test_imu_watchdog_fires_on_stationary_kfs():
    """Unit-level: three near-stationary keyframes inside the first 10 s
    -> bad_imu; real motion -> no trigger."""
    from orbslam3_jax.atlas.store import MapStore
    from orbslam3_jax.pipeline.local_mapping import LocalMapper
    from orbslam3_jax.ops import imu as imu_ops

    params = cam.make_pinhole(FOCAL, FOCAL, W / 2, H / 2)
    calib = imu_ops.ImuCalib.create(
        Rbc=np.eye(3), tbc=np.zeros(3), noise_gyro=1e-3, noise_acc=1e-2,
        walk_gyro=1e-5, walk_acc=1e-4, freq=200.0,
    )
    for motion, expect in ((0.001, True), (0.1, False)):
        store = MapStore(Kmax=8, Pmax=64, Nf=16)
        mapper = LocalMapper(
            cam.CameraModel.PINHOLE, params, (W, H), store, imu_calib=calib,
        )
        s = store.state
        for i in range(3):
            slot = store.alloc_kf()
            t = np.zeros(3, np.float32)
            t[0] = -motion * i  # tcw = -Rcw @ center, Rcw = I
            s = s._replace(
                kf_valid=s.kf_valid.at[slot].set(True),
                kf_t=s.kf_t.at[slot].set(jnp.asarray(t)),
            )
            store.kf_ts[slot] = 0.5 * i
        store.state = s
        mapper._imu_watchdog(2)
        assert mapper.bad_imu == expect, f"motion={motion}"


def test_lost_recovery_fallback_resets_small_map():
    """Hard-LOST policy without a multi-map manager (`Tracking::Track`
    `Tracking.cc:1239-1243`): a thin map (<= 10 KFs) is discarded after a
    short LOST streak and initialization restarts; localization-only mode
    never mutates the map."""
    slam, _ = _build_slam()
    tr = slam.tracker
    old_store = slam.store
    tr.state = TrackState.LOST
    slam.store.alloc_kf()  # 1-KF map: thin

    # Localization mode: 10 lost frames, nothing resets.
    tr.only_tracking = True
    for _ in range(10):
        slam._post_frame(np.zeros((H, W), np.float32))
    assert slam.store is old_store
    assert tr.state == TrackState.LOST

    # SLAM mode: 5-frame streak triggers the reset.
    tr.only_tracking = False
    for _ in range(5):
        slam._post_frame(np.zeros((H, W), np.float32))
    assert slam.store is not old_store
    assert tr.state == TrackState.NO_IMAGES_YET or tr.state == TrackState.NOT_INITIALIZED
