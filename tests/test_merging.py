import numpy as np
import jax.numpy as jnp
import pytest

from orbslam3_jax.atlas import store as st
from orbslam3_jax.ops import cameras as cam
from orbslam3_jax.ops import lie
from orbslam3_jax.pipeline.map_merging import merge_maps, transform_map


def make_store(rng, n_kf=4, n_mp=50, offset=0.0):
    store = st.MapStore(Kmax=16, Pmax=256, Nf=32)
    pts = np.stack(
        [rng.uniform(-2, 2, n_mp), rng.uniform(-2, 2, n_mp), rng.uniform(3, 6, n_mp) + offset],
        -1,
    ).astype(np.float32)
    slots = store.alloc_mps(n_mp)
    store.state = st.add_points(
        store.state, jnp.asarray(slots), jnp.asarray(pts),
        jnp.zeros((n_mp, 32), jnp.uint8), jnp.zeros((n_mp, 3)),
        jnp.zeros(n_mp), jnp.full(n_mp, 100.0),
        jnp.zeros(n_mp, jnp.int32), jnp.ones(n_mp, bool),
    )
    prev = -1
    for k in range(n_kf):
        slot = store.alloc_kf()
        assoc = np.full(32, -1, np.int32)
        assoc[: min(16, n_mp)] = slots[: min(16, n_mp)]
        store.state = st.add_keyframe(
            store.state, slot,
            jnp.eye(3), jnp.asarray([0.1 * k, 0.0, 0.0]),
            jnp.zeros((32, 2)), jnp.full(32, -1.0), jnp.zeros(32, jnp.int32),
            jnp.zeros(32), jnp.zeros((32, 32), jnp.uint8), jnp.ones(32, bool),
            jnp.asarray(assoc), prev_kf=prev,
        )
        store.kf_ts[slot] = float(k)
        prev = slot
    return store, pts


def test_transform_map_consistency(rng):
    """Projections must be invariant under a whole-map Sim3."""
    store, pts = make_store(rng)
    params = cam.make_pinhole(300.0, 300.0, 160.0, 120.0)
    s0 = store.state
    uv_before = cam.project(
        cam.CameraModel.PINHOLE, params,
        lie.se3_apply(s0.kf_R[1], s0.kf_t[1], s0.mp_pos[:50]),
    )
    R = np.asarray(lie.exp_so3(jnp.asarray([0.2, -0.1, 0.3], jnp.float32)))
    t = np.array([1.0, -2.0, 0.5], np.float32)
    s1 = transform_map(s0, jnp.asarray(R), jnp.asarray(t), 2.0)
    uv_after = cam.project(
        cam.CameraModel.PINHOLE, params,
        lie.se3_apply(s1.kf_R[1], s1.kf_t[1], s1.mp_pos[:50]),
    )
    np.testing.assert_allclose(np.asarray(uv_after), np.asarray(uv_before), atol=1e-2)


def test_merge_maps(rng):
    target, _ = make_store(rng, n_kf=3, n_mp=40)
    source, src_pts = make_store(rng, n_kf=4, n_mp=30, offset=5.0)
    R = np.asarray(lie.exp_so3(jnp.asarray([0.0, 0.3, 0.0], jnp.float32)))
    t = np.array([2.0, 0.0, 1.0], np.float32)
    s = 1.5
    kf_remap, mp_remap = merge_maps(target, source, R, t, s)
    assert target.n_kf == 7
    assert len(mp_remap) == 30
    tgt = target.state
    # Transformed positions present.
    p_src0 = src_pts[0]
    expected = s * R @ p_src0 + t
    got = np.asarray(tgt.mp_pos[mp_remap[0]])
    np.testing.assert_allclose(got, expected, atol=1e-4)
    # Remapped associations point at valid points.
    for k_src, k_tgt in kf_remap.items():
        row = np.asarray(tgt.kf_mp[k_tgt])
        refs = row[row >= 0]
        assert np.asarray(tgt.mp_valid)[refs].all()
    # Temporal chain remapped.
    k1 = kf_remap[1]
    assert int(tgt.kf_prev[k1]) == kf_remap[0]
    # Covisibility spans the merged content.
    W = np.asarray(st.covisibility(tgt))
    assert W[kf_remap[0], kf_remap[1]] > 0


def test_inertial_merge_gates():
    """`gate_inertial_sim3`: scale gate 0.9-1.1 + yaw-only rotation for
    gravity-calibrated maps (`LoopClosing.cc:107,120-127`)."""
    from orbslam3_jax.pipeline.multimap import gate_inertial_sim3

    Rfull = np.asarray(
        lie.exp_so3(jnp.asarray([0.05, -0.08, 0.6], jnp.float32))
    )
    # Visual map: anything goes, rotation untouched.
    ok, R = gate_inertial_sim3(Rfull, 1.7, imu_metric=False)
    assert ok and np.allclose(R, Rfull)
    # Metric map: scale outside 0.9-1.1 rejected.
    ok, _ = gate_inertial_sim3(Rfull, 1.2, imu_metric=True)
    assert not ok
    ok, _ = gate_inertial_sim3(Rfull, 0.85, imu_metric=True)
    assert not ok
    # Metric map, sane scale: rotation restricted to yaw.
    ok, Ry = gate_inertial_sim3(Rfull, 1.02, imu_metric=True)
    assert ok
    phi = np.asarray(lie.log_so3(jnp.asarray(Ry, jnp.float32)))
    assert abs(phi[0]) < 1e-6 and abs(phi[1]) < 1e-6
    assert abs(phi[2] - 0.6) < 0.05  # yaw preserved
    # Gravity direction (world z) invariant under the gated rotation.
    z = np.array([0.0, 0.0, 1.0], np.float32)
    np.testing.assert_allclose(Ry @ z, z, atol=1e-5)
