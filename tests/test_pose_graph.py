import jax
import jax.numpy as jnp
import numpy as np
import pytest

from orbslam3_jax.ops import lie
from orbslam3_jax.optim import pose_graph as pg


def drifted_loop(rng, K=20, drift_rot=0.002, drift_t=0.01, drift_s=1.004):
    """Ground truth: poses on a circle (loop). Estimates: accumulate the
    TRUE relative transforms corrupted by per-step drift, so the last KF
    disagrees with the first — exactly the situation after loop detection.
    Returns (true poses, drifted poses, relative measurements)."""
    R_true, t_true = [], []
    for k in range(K):
        ang = 2 * np.pi * k / K
        Rwc = np.asarray(
            lie.exp_so3(jnp.asarray([0.0, ang, 0.0], jnp.float32))
        )
        center = np.array([np.sin(ang) * 3, 0.0, 3 - np.cos(ang) * 3], np.float32)
        Rcw = Rwc.T
        R_true.append(Rcw)
        t_true.append(-Rcw @ center)

    # Drifted estimates: chain of noisy relative poses.
    R_est = [R_true[0]]
    t_est = [t_true[0]]
    s_drift = 1.0
    for k in range(1, K):
        R_rel = R_true[k] @ R_true[k - 1].T
        t_rel = t_true[k] - R_rel @ t_true[k - 1]
        dR = np.asarray(lie.exp_so3(jnp.asarray(rng.normal(0, drift_rot, 3), jnp.float32)))
        s_drift *= drift_s
        R_new = dR @ R_rel @ R_est[k - 1]
        t_new = dR @ (s_drift * t_rel + R_rel @ t_est[k - 1]) + rng.normal(0, drift_t, 3)
        R_est.append(R_new.astype(np.float32))
        t_est.append(t_new.astype(np.float32))
    return (
        np.stack(R_true), np.stack(t_true),
        np.stack(R_est), np.stack(t_est),
    )


def test_pose_graph_closes_loop(rng):
    K = 20
    R_true, t_true, R_est, t_est = drifted_loop(rng, K)
    # Edges: consecutive (measurements from DRIFTED estimates = the odometry
    # the system believes) + one loop edge with the TRUE relative Sim3
    # between KF K-1 and KF 0 (what place recognition measures).
    ei, ej, eR, et, es, ew = [], [], [], [], [], []
    for k in range(1, K):
        Rba = R_est[k] @ R_est[k - 1].T
        tba = t_est[k] - Rba @ t_est[k - 1]
        ei.append(k - 1); ej.append(k)
        eR.append(Rba); et.append(tba); es.append(1.0); ew.append(1.0)
    # Loop edge K-1 -> 0 with true relative transform.
    Rba = R_true[0] @ R_true[K - 1].T
    tba = t_true[0] - Rba @ t_true[K - 1]
    ei.append(K - 1); ej.append(0)
    eR.append(Rba); et.append(tba); es.append(1.0); ew.append(5.0)

    g = pg.PoseGraph(
        R=jnp.asarray(R_est), t=jnp.asarray(t_est), s=jnp.ones(K),
        fixed=jnp.asarray(np.arange(K) == 0),
        edge_i=jnp.asarray(ei, jnp.int32), edge_j=jnp.asarray(ej, jnp.int32),
        edge_R=jnp.asarray(np.stack(eR), jnp.float32),
        edge_t=jnp.asarray(np.stack(et), jnp.float32),
        edge_s=jnp.asarray(es, jnp.float32),
        edge_valid=jnp.ones(len(ei), bool),
        edge_weight=jnp.asarray(ew, jnp.float32),
    )
    R_out, t_out, s_out = pg.solve_pose_graph(g, iters=25)

    # End-of-loop error before vs after.
    def end_err(Rs, ts):
        c_est = -np.asarray(Rs[K - 1]).T @ np.asarray(ts[K - 1])
        c_true = -R_true[K - 1].T @ t_true[K - 1]
        return np.linalg.norm(c_est - c_true)

    before = end_err(R_est, t_est)
    after = end_err(np.asarray(R_out), np.asarray(t_out))
    assert before > 0.1, f"test setup: drift too small ({before})"
    assert after < before * 0.35, (before, after)
    # Scales should stay near 1 (loop edge has s=1).
    assert np.abs(np.asarray(s_out) - 1.0).max() < 0.1


def test_correct_points_consistency(rng):
    """Points re-expressed through their reference KF must keep their
    camera-frame coordinates if the KF correction is consistent."""
    w = rng.normal(0, 0.5, 3).astype(np.float32)
    R_old = np.asarray(lie.exp_so3(jnp.asarray(w)))
    t_old = rng.normal(0, 1, 3).astype(np.float32)
    # New pose = Sim3-corrected.
    dR = np.asarray(lie.exp_so3(jnp.asarray([0.05, -0.02, 0.1], jnp.float32)))
    R_new = dR @ R_old
    t_new = (t_old + np.array([0.3, -0.1, 0.2])).astype(np.float32)
    s_new = np.float32(1.2)
    pts = rng.normal(0, 2, (50, 3)).astype(np.float32)
    out = pg.correct_points(
        jnp.asarray(pts),
        jnp.asarray(R_old), jnp.asarray(t_old), jnp.asarray(1.0),
        jnp.asarray(R_new), jnp.asarray(t_new), jnp.asarray(s_new),
    )
    # Camera coords preserved: s_new R_new x' + t_new == R_old x + t_old
    lhs = (s_new * (R_new @ np.asarray(out).T)).T + t_new
    rhs = (R_old @ pts.T).T + t_old
    np.testing.assert_allclose(lhs, rhs, atol=1e-4)


@pytest.mark.slow
def test_pose_graph_at_atlas_scale(rng):
    """512-KF essential graph (Atlas-scale): consecutive + 2-hop
    'covisibility' edges + one loop edge — the dense (7K,7K) formulation
    must stay tractable and still close the loop. Guards the design claim
    in pose_graph.py's docstring (single dense solve up to K~1024; the
    reference's g2o solves the same graph sparsely, `Optimizer.cc:2526`)."""
    import time

    K = 512
    R_true, t_true, R_est, t_est = drifted_loop(rng, K, drift_rot=5e-4,
                                                drift_t=2e-3, drift_s=1.0005)
    ei, ej, eR, et, es, ew = [], [], [], [], [], []
    for hop in (1, 2):
        for k in range(hop, K):
            Rba = R_est[k] @ R_est[k - hop].T
            tba = t_est[k] - Rba @ t_est[k - hop]
            ei.append(k - hop); ej.append(k)
            eR.append(Rba); et.append(tba); es.append(1.0); ew.append(1.0)
    Rba = R_true[0] @ R_true[K - 1].T
    tba = t_true[0] - Rba @ t_true[K - 1]
    ei.append(K - 1); ej.append(0)
    eR.append(Rba); et.append(tba); es.append(1.0); ew.append(5.0)

    g = pg.PoseGraph(
        R=jnp.asarray(R_est), t=jnp.asarray(t_est), s=jnp.ones(K),
        fixed=jnp.asarray(np.arange(K) == 0),
        edge_i=jnp.asarray(ei, jnp.int32), edge_j=jnp.asarray(ej, jnp.int32),
        edge_R=jnp.asarray(np.stack(eR), jnp.float32),
        edge_t=jnp.asarray(np.stack(et), jnp.float32),
        edge_s=jnp.asarray(es, jnp.float32),
        edge_valid=jnp.ones(len(ei), bool),
        edge_weight=jnp.asarray(ew, jnp.float32),
    )
    R_out, t_out, s_out = pg.solve_pose_graph(g, iters=8)
    R_out = np.asarray(jax.block_until_ready(R_out))
    t0 = time.perf_counter()
    R2, t2, s2 = pg.solve_pose_graph(g, iters=8)
    jax.block_until_ready(t2)
    dt = time.perf_counter() - t0
    print(f"512-KF pose graph, {len(ei)} edges, 8 GN iters: {dt:.2f}s")

    def end_err(Rs, ts):
        c_est = -np.asarray(Rs[K - 1]).T @ np.asarray(ts[K - 1])
        c_true = -R_true[K - 1].T @ t_true[K - 1]
        return np.linalg.norm(c_est - c_true)

    before = end_err(R_est, t_est)
    after = end_err(R_out, np.asarray(t_out))
    assert before > 0.05, f"test setup: drift too small ({before})"
    assert after < before * 0.35, (before, after)
    assert np.abs(np.asarray(s_out) - 1.0).max() < 0.1
