"""Interruptible background GBA (`AsyncGBA`): chunked solve, abort, and
spanning-tree-style propagation to keyframes/points created mid-solve
(ref `LoopClosing.cc:1099-1118,1323,2513-2680`)."""

import numpy as np
import jax.numpy as jnp

from orbslam3_jax.atlas import store as st
from orbslam3_jax.ops import cameras as cam
from orbslam3_jax.ops import features as feat
from orbslam3_jax.pipeline.gba import AsyncGBA

NF = 32
PARAMS = cam.make_pinhole(300.0, 300.0, 160.0, 120.0)


def _build_store(rng, n_kf=5, n_mp=30, noise=0.02):
    """Keyframes on a line observing a cloud; uv from CLEAN geometry,
    then poses/points perturbed — BA must pull them back."""
    store = st.MapStore(Kmax=16, Pmax=256, Nf=NF)
    pts = np.stack(
        [rng.uniform(-2, 2, n_mp), rng.uniform(-1.5, 1.5, n_mp),
         rng.uniform(4, 7, n_mp)], -1,
    ).astype(np.float32)
    slots = store.alloc_mps(n_mp)
    store.state = st.add_points(
        store.state, jnp.asarray(slots), jnp.asarray(pts),
        jnp.zeros((n_mp, 32), jnp.uint8), jnp.zeros((n_mp, 3)),
        jnp.zeros(n_mp), jnp.full(n_mp, 100.0),
        jnp.zeros(n_mp, jnp.int32), jnp.ones(n_mp, bool),
    )
    clean = []
    prev = -1
    for k in range(n_kf):
        slot = store.alloc_kf()
        R = np.eye(3, dtype=np.float32)
        t = np.array([-0.3 * k, 0.0, 0.0], np.float32)
        clean.append((R, t))
        Xc = (R @ pts.T).T + t
        uv = np.asarray(cam.project(cam.CameraModel.PINHOLE, jnp.asarray(PARAMS), jnp.asarray(Xc)))
        uv_pad = np.zeros((NF, 2), np.float32)
        uv_pad[:n_mp] = uv
        assoc = np.full(NF, -1, np.int32)
        assoc[:n_mp] = slots
        fv = np.zeros(NF, bool)
        fv[:n_mp] = True
        # Perturbed pose goes into the state (not KF0: it is the gauge).
        tp = t if k == 0 else t + rng.normal(0, noise, 3).astype(np.float32)
        store.state = st.add_keyframe(
            store.state, slot,
            jnp.asarray(R), jnp.asarray(tp),
            jnp.asarray(uv_pad), jnp.full(NF, -1.0), jnp.zeros(NF, jnp.int32),
            jnp.zeros(NF), jnp.zeros((NF, 32), jnp.uint8), jnp.asarray(fv),
            jnp.asarray(assoc), prev_kf=prev,
        )
        store.kf_ts[slot] = float(k)
        prev = slot
    # Perturb the points too.
    store.state = store.state._replace(
        mp_pos=store.state.mp_pos.at[jnp.asarray(slots)].add(
            jnp.asarray(rng.normal(0, noise, (n_mp, 3)).astype(np.float32))
        )
    )
    return store, pts, slots, clean


def _reproj_rmse(store, slots):
    s = store.state
    kf_R, kf_t, mp, kf_mp, uv, fv, kv = map(
        np.asarray, (s.kf_R, s.kf_t, s.mp_pos, s.kf_mp, s.kf_uv,
                     s.kf_feat_valid, s.kf_valid),
    )
    errs = []
    for k in np.flatnonzero(kv):
        ok = (kf_mp[k] >= 0) & fv[k]
        X = mp[kf_mp[k][ok]]
        Xc = (kf_R[k] @ X.T).T + kf_t[k]
        proj = np.asarray(
            cam.project(cam.CameraModel.PINHOLE, jnp.asarray(PARAMS), jnp.asarray(Xc))
        )
        errs.append(np.linalg.norm(proj - uv[k][ok], axis=-1))
    return float(np.sqrt(np.mean(np.concatenate(errs) ** 2)))


def _make_gba(**kw):
    s2 = jnp.asarray(feat.sigma2(feat.OrbParams(n_levels=3)))
    return AsyncGBA(cam.CameraModel.PINHOLE, PARAMS, s2, **kw)


def test_async_gba_converges(rng):
    store, pts, slots, _ = _build_store(rng)
    before = _reproj_rmse(store, slots)
    gba = _make_gba(iters=10, chunk=3)
    gba.start(store)
    n_ticks = 0
    while gba.running:
        gba.tick(store)
        n_ticks += 1
    assert n_ticks == 4  # ceil(10/3) chunks
    after = _reproj_rmse(store, slots)
    assert after < before * 0.2, (before, after)
    assert gba.n_finished == 1


def test_async_gba_abort_leaves_map_untouched(rng):
    store, pts, slots, _ = _build_store(rng)
    R_before = np.asarray(store.state.kf_R).copy()
    p_before = np.asarray(store.state.mp_pos).copy()
    gba = _make_gba(iters=10, chunk=2)
    gba.start(store)
    gba.tick(store)
    gba.abort()
    assert not gba.running and gba.n_aborted == 1
    np.testing.assert_array_equal(np.asarray(store.state.kf_R), R_before)
    np.testing.assert_array_equal(np.asarray(store.state.mp_pos), p_before)


def test_async_gba_propagates_midflight_keyframe(rng):
    """A keyframe inserted while GBA runs keeps its RELATIVE pose to the
    temporally previous snapshot KF (ref `LoopClosing.cc:2608-2630`)."""
    store, pts, slots, clean = _build_store(rng)
    gba = _make_gba(iters=10, chunk=2)
    gba.start(store)
    gba.tick(store)
    # Mid-flight KF: anchored at the last snapshot KF with a known offset.
    s = store.state
    anchor = 4
    Ra = np.asarray(s.kf_R[anchor])
    ta = np.asarray(s.kf_t[anchor])
    off = np.array([-0.15, 0.02, 0.01], np.float32)
    slot = store.alloc_kf()
    store.state = st.add_keyframe(
        store.state, slot, jnp.asarray(Ra), jnp.asarray(ta + off),
        jnp.zeros((NF, 2)), jnp.full(NF, -1.0), jnp.zeros(NF, jnp.int32),
        jnp.zeros(NF), jnp.zeros((NF, 32), jnp.uint8), jnp.zeros(NF, bool),
        jnp.full(NF, -1, jnp.int32), prev_kf=anchor,
    )
    store.kf_ts[slot] = 5.0
    rel_before = (np.asarray(s.kf_R[anchor]), off.copy())
    while gba.running:
        gba.tick(store)
    s = store.state
    # Relative transform new<-anchor preserved after propagation.
    Rn, tn = np.asarray(s.kf_R[slot]), np.asarray(s.kf_t[slot])
    Ra2, ta2 = np.asarray(s.kf_R[anchor]), np.asarray(s.kf_t[anchor])
    R_rel = Rn @ Ra2.T
    t_rel = tn - R_rel @ ta2
    np.testing.assert_allclose(R_rel, np.eye(3), atol=1e-5)
    np.testing.assert_allclose(t_rel, off, atol=1e-5)
