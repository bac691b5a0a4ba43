"""The distributed layer AS CALLED BY THE LIVE PIPELINE (round-4 wiring):
`AsyncGBA`/`global_ba` dispatching the point-partitioned solve through a
`DistributedContext`, and the Atlas merge path's sharded KFDB query —
exactness vs the single-device paths on the virtual 8-device CPU mesh.

Ref semantics being preserved: `LoopClosing::RunGlobalBundleAdjustment`
(`/root/reference/src/LoopClosing.cc:2513`) must produce the same map no
matter where the linear algebra runs.
"""

import numpy as np
import jax
import jax.numpy as jnp

from orbslam3_jax.ops import cameras as cam
from orbslam3_jax.ops import features as feat
from orbslam3_jax.parallel.context import DistributedContext
from orbslam3_jax.parallel import ba_sharded
from orbslam3_jax.pipeline.gba import AsyncGBA, global_ba

from test_gba_async import NF, PARAMS, _build_store, _reproj_rmse


def _ctx(n_dev=8):
    return DistributedContext(ba_sharded.make_mesh(jax.devices()[:n_dev], axis="pt"))


def _s2():
    return jnp.asarray(feat.sigma2(feat.OrbParams(n_levels=3)))


def test_global_ba_dist_matches_single_device():
    a = _build_store(np.random.default_rng(3))[0]
    b = _build_store(np.random.default_rng(3))[0]
    kw = dict(iters=8, pcg_iters=40)
    global_ba(a, cam.CameraModel.PINHOLE, PARAMS, _s2(), **kw)
    global_ba(b, cam.CameraModel.PINHOLE, PARAMS, _s2(), dist=_ctx(), **kw)
    np.testing.assert_allclose(
        np.asarray(a.state.kf_t), np.asarray(b.state.kf_t), atol=2e-3
    )
    np.testing.assert_allclose(
        np.asarray(a.state.mp_pos), np.asarray(b.state.mp_pos), atol=2e-3
    )


def test_async_gba_dist_chunks_match_plain():
    """The chunked interruptible GBA over the mesh lands on the same map
    as the plain chunked GBA (same LM trajectory, summation order aside)."""
    a = _build_store(np.random.default_rng(7))[0]
    b = _build_store(np.random.default_rng(7))[0]
    g1 = AsyncGBA(cam.CameraModel.PINHOLE, PARAMS, _s2(), iters=9, chunk=3)
    g2 = AsyncGBA(cam.CameraModel.PINHOLE, PARAMS, _s2(), iters=9, chunk=3,
                  dist=_ctx())
    g1.start(a)
    g2.start(b)
    while g1.running:
        g1.tick(a)
    while g2.running:
        g2.tick(b)
    assert g2.n_dist_solves == 3  # every chunk ran over the mesh
    np.testing.assert_allclose(
        np.asarray(a.state.kf_t), np.asarray(b.state.kf_t), atol=2e-3
    )
    np.testing.assert_allclose(
        np.asarray(a.state.mp_pos), np.asarray(b.state.mp_pos), atol=2e-3
    )


def test_async_gba_dist_converges(rng):
    store, pts, slots, _ = _build_store(rng)
    before = _reproj_rmse(store, slots)
    gba = AsyncGBA(cam.CameraModel.PINHOLE, PARAMS, _s2(), iters=10, chunk=4,
                   dist=_ctx())
    gba.start(store)
    while gba.running:
        gba.tick(store)
    after = _reproj_rmse(store, slots)
    assert after < before * 0.2, (before, after)


def test_kfdb_sharded_query_matches_dense_top1():
    """The mesh-sharded Atlas query surfaces the same best keyframe as the
    dense single-device scoring (covisibility grouping aside — scores of
    individual KFs are identical L1 similarities)."""
    from orbslam3_jax.atlas.kfdb import KeyFrameDB
    from orbslam3_jax.ops import bow as bow_ops

    rng = np.random.default_rng(11)
    voc = bow_ops.build_vocabulary(
        rng.integers(0, 256, (400, 32), dtype=np.uint8), k=4, depth=3, seed=0
    )
    db = KeyFrameDB(voc, Kmax=16)
    descs = []
    for k in range(10):
        d = rng.integers(0, 256, (NF, 32), dtype=np.uint8)
        descs.append(d)
        db.add(k, jnp.asarray(d), jnp.ones(NF, bool))
    # Query with a noisy copy of KF6's descriptors (flip a few bits).
    q = descs[6].copy()
    q[: NF // 4] ^= rng.integers(0, 256, (NF // 4, 32), dtype=np.uint8).astype(np.uint8) & 3
    ids, scores = db.query_frame_sharded(
        jnp.asarray(q), jnp.ones(NF, bool), _ctx(), n_best=3
    )
    ids = np.asarray(ids)
    assert ids[0] == 6, (ids, np.asarray(scores))
