"""MapPoint maintenance: Replace, distinctive descriptors, normal/depth.

Reference behaviors: `MapPoint::Replace` (via `ORBmatcher::Fuse`,
`ORBmatcher.cc:1630`), `MapPoint::ComputeDistinctiveDescriptors` and
`MapPoint::UpdateNormalAndDepth` (`MapPoint.h:163-167`).
"""

import jax.numpy as jnp
import numpy as np

from orbslam3_jax.atlas import store as st


def _small_store(Kmax=8, Pmax=64, Nf=16):
    s = st.MapStore(Kmax=Kmax, Pmax=Pmax, Nf=Nf)
    return s


def _add_kf(store, mp_row, R=None, t=None, desc=None):
    slot = store.alloc_kf()
    Nf = store.state.Nf
    if desc is None:
        desc = np.random.default_rng(slot).integers(0, 256, (Nf, 32), np.uint8)
    store.state = st.add_keyframe(
        store.state, jnp.asarray(slot),
        jnp.asarray(R if R is not None else np.eye(3, dtype=np.float32)),
        jnp.asarray(t if t is not None else np.zeros(3, np.float32)),
        jnp.zeros((Nf, 2), jnp.float32), jnp.full((Nf,), -1.0),
        jnp.zeros((Nf,), jnp.int32), jnp.zeros((Nf,), jnp.float32),
        jnp.asarray(desc), jnp.ones((Nf,), bool),
        jnp.asarray(mp_row, jnp.int32),
    )
    return slot


def test_replace_points_rewires_and_erases():
    store = _small_store()
    Nf = store.state.Nf
    # Points 0,1,2 exist; KF0 sees {0 at f0, 1 at f1}; KF1 sees {1 at f0, 2 at f1}.
    slots = store.alloc_mps(3)
    store.state = st.add_points(
        store.state, jnp.asarray(slots), jnp.zeros((3, 3)),
        jnp.zeros((3, 32), jnp.uint8), jnp.zeros((3, 3)),
        jnp.zeros(3), jnp.ones(3), jnp.zeros(3, jnp.int32), jnp.ones(3, bool),
    )
    row0 = np.full(Nf, -1); row0[0] = 0; row0[1] = 1
    row1 = np.full(Nf, -1); row1[0] = 1; row1[1] = 2
    _add_kf(store, row0)
    _add_kf(store, row1)
    # found/visible stats
    store.state = store.state._replace(
        mp_found=jnp.asarray([5, 3, 1] + [0] * 61),
        mp_visible=jnp.asarray([9, 4, 2] + [0] * 61),
    )

    # Replace point 0 -> point 1. KF0 already sees 1 -> its obs of 0 is
    # erased; KF1 doesn't see 0, nothing changes there.
    new = st.replace_points(
        store.state, jnp.asarray([0], jnp.int32), jnp.asarray([1], jnp.int32),
        jnp.asarray([True]),
    )
    kf_mp = np.asarray(new.kf_mp)
    assert kf_mp[0, 0] == -1  # erased, not duplicated
    assert kf_mp[0, 1] == 1
    assert not bool(new.mp_valid[0])
    assert bool(new.mp_valid[1])
    assert int(new.mp_found[1]) == 3 + 5
    assert int(new.mp_visible[1]) == 4 + 9

    # Replace point 2 -> point 0 is live=False via mask: no-op.
    new2 = st.replace_points(
        store.state, jnp.asarray([2], jnp.int32), jnp.asarray([0], jnp.int32),
        jnp.asarray([False]),
    )
    assert bool(new2.mp_valid[2])
    assert np.array_equal(np.asarray(new2.kf_mp), np.asarray(store.state.kf_mp))


def test_replace_points_moves_obs_when_dst_absent():
    store = _small_store()
    Nf = store.state.Nf
    slots = store.alloc_mps(2)
    store.state = st.add_points(
        store.state, jnp.asarray(slots), jnp.zeros((2, 3)),
        jnp.zeros((2, 32), jnp.uint8), jnp.zeros((2, 3)),
        jnp.zeros(2), jnp.ones(2), jnp.zeros(2, jnp.int32), jnp.ones(2, bool),
    )
    row0 = np.full(Nf, -1); row0[3] = 0  # KF0 sees only point 0
    _add_kf(store, row0)
    new = st.replace_points(
        store.state, jnp.asarray([0], jnp.int32), jnp.asarray([1], jnp.int32),
        jnp.asarray([True]),
    )
    assert int(np.asarray(new.kf_mp)[0, 3]) == 1  # moved to the dst id


def test_distinctive_descriptor_is_min_median():
    store = _small_store()
    Nf = store.state.Nf
    slots = store.alloc_mps(1)
    store.state = st.add_points(
        store.state, jnp.asarray(slots), jnp.asarray([[0.0, 0.0, 5.0]]),
        jnp.zeros((1, 32), jnp.uint8), jnp.asarray([[0.0, 0.0, 1.0]]),
        jnp.asarray([1.0]), jnp.asarray([10.0]), jnp.zeros(1, jnp.int32),
        jnp.ones(1, bool),
    )
    # Three observers with descriptors: two identical, one far away.
    # The distinctive descriptor must be one of the identical pair.
    d_same = np.zeros(32, np.uint8)
    d_far = np.full(32, 255, np.uint8)
    for k, d in enumerate([d_same, d_same, d_far]):
        desc = np.zeros((Nf, 32), np.uint8)
        desc[0] = d
        row = np.full(Nf, -1); row[0] = 0
        t = np.asarray([k * 0.5, 0, 0], np.float32)
        _add_kf(store, row, t=t, desc=desc)
    st.refresh_points(store, np.asarray([0]), np.asarray([1.2 ** i for i in range(8)]), cap=4)
    out = np.asarray(store.state.mp_desc[0])
    assert np.array_equal(out, d_same)

    # Normal: mean unit vector from the three camera centres to the point.
    Ow = np.asarray([[0, 0, 0], [-0.5, 0, 0], [-1.0, 0, 0]], np.float64)
    X = np.asarray([0, 0, 5.0])
    v = X - Ow
    v /= np.linalg.norm(v, axis=1, keepdims=True)
    n = v.sum(0); n /= np.linalg.norm(n)
    got = np.asarray(store.state.mp_normal[0])
    assert np.allclose(got, n, atol=1e-5)
    # Depth band from first observer: dist=5, octave 0 -> max_d = 5.
    assert abs(float(store.state.mp_max_dist[0]) - 5.0) < 1e-4


def test_refresh_skips_orphan_points():
    store = _small_store()
    slots = store.alloc_mps(1)
    store.state = st.add_points(
        store.state, jnp.asarray(slots), jnp.ones((1, 3)),
        jnp.full((1, 32), 7, jnp.uint8), jnp.asarray([[1.0, 0, 0]]),
        jnp.asarray([1.0]), jnp.asarray([2.0]), jnp.zeros(1, jnp.int32),
        jnp.ones(1, bool),
    )
    before = np.asarray(store.state.mp_desc[0])
    st.refresh_points(store, np.asarray([0]), np.full(8, 1.2), cap=4)
    after = np.asarray(store.state.mp_desc[0])
    assert np.array_equal(before, after)  # no observers -> untouched
