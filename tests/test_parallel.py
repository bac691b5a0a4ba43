"""Sharded BA == single-device BA (SURVEY.md §4d: multi-host tests
emulated with xla_force_host_platform_device_count=8)."""

import numpy as np
import jax
import jax.numpy as jnp
import pytest

from orbslam3_jax.ops import cameras as cam
from orbslam3_jax.optim import ba
from orbslam3_jax.parallel import ba_sharded

from tests.synthetic import make_scene, perturb_poses
from tests.test_optim import _ba_problem_from_scene


def test_sharded_ba_matches_single_device(rng):
    assert len(jax.devices()) >= 8, "conftest must provide 8 virtual devices"
    scene = make_scene(rng, n_cams=5, n_pts=80, noise_px=0.3)
    Rs2, ts2 = perturb_poses(rng, scene["cam_R"], scene["cam_t"], keep_first=2)
    prob = _ba_problem_from_scene(scene)._replace(
        cam_R=jnp.asarray(Rs2), cam_t=jnp.asarray(ts2)
    )
    res_single = ba.solve_ba(scene["model"], scene["params"], prob, iters=5, pcg_iters=30)
    mesh = ba_sharded.make_mesh(jax.devices()[:8])
    res_sharded = ba_sharded.solve_ba_sharded(
        scene["model"], scene["params"], prob, mesh, iters=5, pcg_iters=30
    )
    np.testing.assert_allclose(
        np.asarray(res_sharded.cam_t), np.asarray(res_single.cam_t), atol=2e-3
    )
    np.testing.assert_allclose(
        np.asarray(res_sharded.cam_R), np.asarray(res_single.cam_R), atol=2e-3
    )
    assert abs(float(res_sharded.cost) - float(res_single.cost)) < max(
        0.05 * float(res_single.cost), 1.0
    )


def test_point_sharded_ba_matches_single_device(rng):
    """Distributed BA v2: point-axis block partitioning (state sharded,
    not replicated) must be exact vs the single-device solver."""
    assert len(jax.devices()) >= 8, "conftest must provide 8 virtual devices"
    scene = make_scene(rng, n_cams=5, n_pts=83, noise_px=0.3)  # non-multiple of 8
    Rs2, ts2 = perturb_poses(rng, scene["cam_R"], scene["cam_t"], keep_first=2)
    prob = _ba_problem_from_scene(scene)._replace(
        cam_R=jnp.asarray(Rs2), cam_t=jnp.asarray(ts2)
    )
    res_single = ba.solve_ba(scene["model"], scene["params"], prob, iters=5, pcg_iters=30)
    mesh = ba_sharded.make_mesh(jax.devices()[:8])
    res = ba_sharded.solve_ba_point_sharded(
        scene["model"], scene["params"], prob, mesh, iters=5, pcg_iters=30
    )
    np.testing.assert_allclose(
        np.asarray(res.cam_t), np.asarray(res_single.cam_t), atol=2e-3
    )
    np.testing.assert_allclose(
        np.asarray(res.cam_R), np.asarray(res_single.cam_R), atol=2e-3
    )
    valid = np.asarray(prob.point_valid)
    np.testing.assert_allclose(
        np.asarray(res.points)[valid], np.asarray(res_single.points)[valid], atol=5e-3
    )
    assert np.array_equal(
        np.asarray(res.obs_inlier), np.asarray(res_single.obs_inlier)
    ) or np.mean(
        np.asarray(res.obs_inlier) != np.asarray(res_single.obs_inlier)
    ) < 0.02  # borderline chi2 may flip under reordered summation


def test_dryrun_multichip():
    import __graft_entry__ as ge

    ge.dryrun_multichip(8)


def test_sharded_kfdb_query(rng):
    """Sharded database query == single-device detect ranking."""
    from orbslam3_jax.ops import bow
    from orbslam3_jax.parallel import kfdb_sharded

    protos = rng.integers(0, 256, size=(30, 32), dtype=np.uint8)
    descs = []
    for p in protos:
        for _ in range(30):
            d = p.copy()
            d[rng.integers(0, 32, 4)] ^= rng.integers(1, 255, 4).astype(np.uint8)
            descs.append(d)
    voc = bow.build_vocabulary(np.stack(descs), k=5, depth=3, seed=0)

    def make_vec(idx_protos):
        d = []
        for i in idx_protos:
            x = protos[i].copy()
            x[rng.integers(0, 32)] ^= 1
            d.append(x)
        d = jnp.asarray(np.stack(d))
        w = bow.transform(voc, d, jnp.ones(len(idx_protos), bool))
        return w, bow.bow_vector(voc, w)

    K = 24
    vecs, words = [], []
    for k in range(K):
        w, v = make_vec(rng.integers(0, 30, size=12))
        vecs.append(v)
        words.append(w)
    db = jnp.stack(vecs)
    valid = jnp.ones(K, bool)

    qw, qv = make_vec(rng.integers(0, 30, size=12))
    mesh = kfdb_sharded.make_mesh(jax.devices()[:8])
    ids, scores = kfdb_sharded.sharded_query(qv, qw, db, valid, mesh, n_best=5)
    # Reference ranking: plain L1 scores with the same shared-word filter.
    shared = np.asarray(bow.shared_words(qw, db > 0))
    elig = shared >= max(int(0.8 * shared.max()), 1)
    ref_scores = np.asarray(bow.score_l1(qv, db)).copy()
    ref_scores[~elig] = -1
    ref_top = np.argsort(-ref_scores)[:5]
    got = np.asarray(ids)
    assert got[0] == ref_top[0]
    assert set(got[got >= 0][:3]) <= set(ref_top.tolist() + [-1])
