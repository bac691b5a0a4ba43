import numpy as np
import jax.numpy as jnp
import pytest

from orbslam3_jax.atlas import store as st
from orbslam3_jax.atlas.atlas import Atlas


def small_store():
    return st.MapStore(Kmax=8, Pmax=64, Nf=16)


def _add_kf(store, slot, mp_row):
    Nf = store.state.Nf
    store.state = st.add_keyframe(
        store.state, slot, jnp.eye(3), jnp.zeros(3),
        jnp.zeros((Nf, 2)), jnp.full(Nf, -1.0), jnp.zeros(Nf, jnp.int32),
        jnp.zeros(Nf), jnp.zeros((Nf, 32), jnp.uint8), jnp.ones(Nf, bool),
        jnp.asarray(mp_row, jnp.int32),
    )


def test_covisibility_counts(rng):
    store = small_store()
    # KF0 sees points 0..7; KF1 sees 4..11 -> 4 shared; KF2 sees 20..27 -> 0.
    r0 = np.concatenate([np.arange(8), np.full(8, -1)])
    r1 = np.concatenate([np.arange(4, 12), np.full(8, -1)])
    r2 = np.concatenate([np.arange(20, 28), np.full(8, -1)])
    for slot, row in [(0, r0), (1, r1), (2, r2)]:
        store.alloc_kf()
        _add_kf(store, slot, row)
    store.state = store.state._replace(mp_valid=jnp.ones(64, bool))
    W = np.asarray(st.covisibility(store.state))
    assert W[0, 1] == 4 and W[1, 0] == 4
    assert W[0, 2] == 0
    assert W[0, 0] == 0  # diagonal zeroed


def test_point_observers_and_erase(rng):
    store = small_store()
    r0 = np.concatenate([np.arange(8), np.full(8, -1)])
    r1 = np.concatenate([np.arange(4, 12), np.full(8, -1)])
    for slot, row in [(0, r0), (1, r1)]:
        store.alloc_kf()
        _add_kf(store, slot, row)
    store.state = store.state._replace(mp_valid=jnp.ones(64, bool))
    obs = np.asarray(st.point_observers(store.state))
    assert obs[5] == 2 and obs[0] == 1 and obs[30] == 0
    # Erase points 4,5: all references must vanish.
    store.state = st.erase_points(
        store.state, jnp.asarray([4, 5], jnp.int32), jnp.asarray([True, True])
    )
    kf_mp = np.asarray(store.state.kf_mp)
    assert not np.any(kf_mp == 4)
    assert not np.any(kf_mp == 5)
    assert not bool(store.state.mp_valid[4])


def test_erase_keyframe():
    store = small_store()
    r0 = np.concatenate([np.arange(8), np.full(8, -1)])
    store.alloc_kf()
    _add_kf(store, 0, r0)
    store.state = st.erase_keyframe(store.state, 0)
    assert not bool(store.state.kf_valid[0])
    assert (np.asarray(store.state.kf_mp[0]) == -1).all()


def test_atlas_multi_map_and_checkpoint(tmp_path):
    atlas = Atlas(Kmax=8, Pmax=64, Nf=16)
    r0 = np.concatenate([np.arange(8), np.full(8, -1)])
    atlas.active.alloc_kf()
    _add_kf(atlas.active, 0, r0)
    atlas.active.kf_ts[0] = 12.5
    m2 = atlas.create_new_map()
    assert atlas.n_maps == 2 and atlas.active is m2
    m2.alloc_kf()
    _add_kf(m2, 0, r0)

    path = str(tmp_path / "ckpt")
    atlas.save(path)
    atlas2 = Atlas.load(path)
    assert atlas2.n_maps == 2
    assert atlas2.active_idx == 1
    assert atlas2.maps[0].kf_ts[0] == 12.5
    np.testing.assert_array_equal(
        np.asarray(atlas2.maps[0].state.kf_mp), np.asarray(atlas.maps[0].state.kf_mp)
    )


@pytest.mark.slow
def test_system_save_load_relocalize(rng, tmp_path):
    """System-level checkpoint/resume (ref `System::SaveAtlas/LoadAtlas`,
    `System.h:163-165` — dormant there, functional here): map a scene,
    save, load into a FRESH System, and verify per-frame relocalization
    re-attaches tracking to the loaded map with a consistent trajectory."""
    from orbslam3_jax.ops import bow
    from orbslam3_jax.ops import cameras as cam
    from orbslam3_jax.ops import features as feat
    from orbslam3_jax.system import System, Sensor
    from orbslam3_jax.pipeline.tracking import TrackState
    from orbslam3_jax.eval.ate import ate_rmse
    from tests.test_e2e_mono import (
        H, W, FOCAL, make_world, render, camera_path,
    )

    params = cam.make_pinhole(FOCAL, FOCAL, W / 2, H / 2)
    pts, shades = make_world(rng)
    poses = camera_path(12)
    orb = feat.OrbParams(n_features=400, n_levels=3)

    train = [
        np.asarray(f.desc)[np.asarray(f.valid)]
        for f in (
            feat.extract(jnp.asarray(render(params, R, t, pts, shades)), orb)
            for R, t in poses[::4]
        )
    ]
    voc = bow.build_vocabulary(np.concatenate(train), k=8, depth=3, seed=0)

    def fresh():
        s = System(
            Sensor.MONOCULAR, cam.CameraModel.PINHOLE, params, (W, H),
            orb_params=orb, Kmax=32, Pmax=4096,
        )
        s.enable_place_recognition(voc, consecutive=1)
        return s

    slam = fresh()
    for k, (R, t) in enumerate(poses):
        slam.track_monocular(render(params, R, t, pts, shades), k * 0.1)
    assert slam.tracking_state == TrackState.OK
    n_kf_saved = slam.n_keyframes
    ckpt = str(tmp_path / "atlas_ckpt")
    slam.save_atlas(ckpt)

    slam2 = fresh()
    slam2.load_atlas(ckpt)
    assert slam2.n_keyframes == n_kf_saved
    assert slam2.tracking_state == TrackState.LOST
    # Replay a mid-sequence stretch: relocalization must re-attach.
    est = []
    for k, (R, t) in list(enumerate(poses))[4:]:
        slam2.track_monocular(render(params, R, t, pts, shades), 100.0 + k * 0.1)
        if slam2.tracking_state == TrackState.OK:
            est.append((100.0 + k * 0.1, k))
    assert slam2.tracking_state == TrackState.OK, "never relocalized"
    assert len(est) >= 4
    ts_est, pos_est = slam2.get_trajectory()
    keep = ts_est >= 100.0
    gt = np.stack([-poses[k][0].T @ poses[k][1] for _, k in est])
    err = ate_rmse(
        ts_est[keep], pos_est[keep], np.asarray([t for t, _ in est]), gt,
        with_scale=True, max_dt=0.01,
    )
    assert err < 0.08, f"post-load ATE {err:.4f} m"
