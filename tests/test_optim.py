import jax.numpy as jnp
import numpy as np
import pytest

from orbslam3_jax.ops import cameras as cam
from orbslam3_jax.ops import lie
from orbslam3_jax.optim import ba, pose_only

from tests.synthetic import make_scene, perturb_poses


def _pose_obs_from_scene(scene, cam_idx, n_cap=512, noise=0.0, rng=None):
    sel = scene["obs_cam"] == cam_idx
    pts = scene["points"][scene["obs_point"][sel]]
    uv = scene["obs_uv"][sel]
    n = min(len(uv), n_cap)
    Xw = np.zeros((n_cap, 3), np.float32)
    uv_a = np.zeros((n_cap, 2), np.float32)
    val = np.zeros(n_cap, bool)
    Xw[:n] = pts[:n]
    uv_a[:n] = uv[:n]
    val[:n] = True
    return pose_only.PoseObs(
        Xw=jnp.asarray(Xw),
        uv=jnp.asarray(uv_a),
        ur=jnp.full(n_cap, -1.0),
        sigma2=jnp.ones(n_cap),
        valid=jnp.asarray(val),
    )


def test_pose_optimization_converges(rng):
    scene = make_scene(rng)
    obs = _pose_obs_from_scene(scene, 3)
    R_true, t_true = scene["cam_R"][3], scene["cam_t"][3]
    dw = np.array([0.05, -0.03, 0.04], np.float32)
    R0 = np.asarray(lie.exp_so3(jnp.asarray(dw))) @ R_true
    t0 = t_true + np.array([0.1, -0.08, 0.12], np.float32)
    res = pose_only.optimize_pose(
        scene["model"], scene["params"], jnp.asarray(R0), jnp.asarray(t0), obs
    )
    rot_err = np.linalg.norm(np.asarray(lie.log_so3(jnp.asarray(R_true.T) @ res.R)))
    t_err = np.linalg.norm(np.asarray(res.t) - t_true)
    assert rot_err < 1e-3, rot_err
    assert t_err < 5e-3, t_err
    assert int(res.n_inliers) > 50


def test_pose_optimization_rejects_outliers(rng):
    scene = make_scene(rng)
    obs = _pose_obs_from_scene(scene, 3)
    # Corrupt 20% of observations with gross errors.
    uv = np.asarray(obs.uv).copy()
    val = np.asarray(obs.valid)
    n_valid = val.sum()
    bad = rng.choice(np.flatnonzero(val), size=n_valid // 5, replace=False)
    uv[bad] += rng.uniform(30, 80, size=(len(bad), 2)) * np.sign(rng.normal(size=(len(bad), 2)))
    obs = obs._replace(uv=jnp.asarray(uv))
    R_true, t_true = scene["cam_R"][3], scene["cam_t"][3]
    R0 = np.asarray(lie.exp_so3(jnp.asarray([0.03, 0.02, -0.02]))) @ R_true
    t0 = t_true + np.array([0.08, 0.05, -0.06], np.float32)
    res = pose_only.optimize_pose(
        scene["model"], scene["params"], jnp.asarray(R0), jnp.asarray(t0), obs
    )
    rot_err = np.linalg.norm(np.asarray(lie.log_so3(jnp.asarray(R_true.T) @ res.R)))
    t_err = np.linalg.norm(np.asarray(res.t) - t_true)
    assert rot_err < 2e-3, rot_err
    assert t_err < 1e-2, t_err
    # Outliers must be flagged.
    inl = np.asarray(res.inlier)
    assert inl[bad].sum() <= len(bad) * 0.1


def _ba_problem_from_scene(scene, fixed=(0, 1)):
    C = len(scene["cam_R"])
    P = len(scene["points"])
    fixed_mask = np.zeros(C, bool)
    fixed_mask[list(fixed)] = True
    return ba.BAProblem(
        cam_R=jnp.asarray(scene["cam_R"]),
        cam_t=jnp.asarray(scene["cam_t"]),
        cam_fixed=jnp.asarray(fixed_mask),
        points=jnp.asarray(scene["points"]),
        point_valid=jnp.ones(P, bool),
        obs_cam=jnp.asarray(scene["obs_cam"]),
        obs_point=jnp.asarray(scene["obs_point"]),
        obs_uv=jnp.asarray(scene["obs_uv"]),
        obs_ur=jnp.full(len(scene["obs_cam"]), -1.0),
        obs_sigma2=jnp.ones(len(scene["obs_cam"])),
        obs_valid=jnp.ones(len(scene["obs_cam"]), bool),
    )


def test_ba_zero_residual_stays(rng):
    scene = make_scene(rng, n_cams=5, n_pts=100)
    prob = _ba_problem_from_scene(scene)
    res = ba.solve_ba(scene["model"], scene["params"], prob, iters=3, pcg_iters=20)
    np.testing.assert_allclose(np.asarray(res.cam_t), scene["cam_t"], atol=1e-3)
    assert float(res.cost) < 1e-2


def test_ba_recovers_perturbation(rng):
    scene = make_scene(rng, n_cams=6, n_pts=150, noise_px=0.3)
    Rs2, ts2 = perturb_poses(rng, scene["cam_R"], scene["cam_t"], keep_first=2)
    pts2 = scene["points"] + rng.normal(0, 0.05, scene["points"].shape).astype(np.float32)
    prob = _ba_problem_from_scene(scene)._replace(
        cam_R=jnp.asarray(Rs2), cam_t=jnp.asarray(ts2), points=jnp.asarray(pts2)
    )
    res = ba.solve_ba(scene["model"], scene["params"], prob, iters=12, pcg_iters=40)
    # Fixed cams untouched.
    np.testing.assert_allclose(np.asarray(res.cam_R)[:2], scene["cam_R"][:2], atol=1e-7)
    # Free cams recovered close to ground truth.
    for c in range(2, 6):
        t_err = np.linalg.norm(np.asarray(res.cam_t)[c] - scene["cam_t"][c])
        assert t_err < 2e-2, (c, t_err)
        rot_err = np.linalg.norm(
            np.asarray(lie.log_so3(jnp.asarray(scene["cam_R"][c].T) @ res.cam_R[c]))
        )
        assert rot_err < 5e-3, (c, rot_err)
    # Points recovered.
    pt_err = np.linalg.norm(np.asarray(res.points) - scene["points"], axis=-1)
    assert np.median(pt_err) < 2e-2


def test_ba_stereo_observations(rng):
    scene = make_scene(rng, n_cams=4, n_pts=80)
    # Stereo constrains scale, so a single fixed camera suffices (and
    # perturb_poses(keep_first=1) below perturbs every other one).
    prob = _ba_problem_from_scene(scene, fixed=(0,))
    # Make all obs stereo with consistent disparity for baseline*f = 40.
    bf = 40.0
    Xc_z = []
    Rs, ts = scene["cam_R"], scene["cam_t"]
    for o in range(len(scene["obs_cam"])):
        c, p = scene["obs_cam"][o], scene["obs_point"][o]
        z = (Rs[c] @ scene["points"][p] + ts[c])[2]
        Xc_z.append(z)
    ur = scene["obs_uv"][:, 0] - bf / np.asarray(Xc_z)
    prob = prob._replace(obs_ur=jnp.asarray(ur.astype(np.float32)))
    Rs2, ts2 = perturb_poses(rng, Rs, ts, keep_first=1)
    prob2 = prob._replace(cam_R=jnp.asarray(Rs2), cam_t=jnp.asarray(ts2))
    res = ba.solve_ba(scene["model"], scene["params"], prob2, bf=bf, iters=10, pcg_iters=40)
    for c in range(1, 4):
        assert np.linalg.norm(np.asarray(res.cam_t)[c] - ts[c]) < 2e-2


def test_ba_dense_schur_matches_pcg(rng):
    """The explicit-reduced-camera-system path (auto-dispatched for
    loop/GBA sizes by `ba.auto_dense_schur`) and the matrix-free PCG path
    are the same math — from the same perturbed start both must converge
    to the same poses/points."""
    scene = make_scene(rng, n_cams=6, n_pts=120)
    prob = _ba_problem_from_scene(scene)
    prob = prob._replace(
        cam_t=prob.cam_t + jnp.asarray(
            rng.normal(0, 0.02, prob.cam_t.shape).astype(np.float32)
            * (~np.asarray(prob.cam_fixed))[:, None]
        ),
        points=prob.points + jnp.asarray(
            rng.normal(0, 0.03, prob.points.shape).astype(np.float32)
        ),
    )
    r_pcg = ba.solve_ba(scene["model"], scene["params"], prob,
                        iters=12, pcg_iters=60)
    r_dense = ba.solve_ba(scene["model"], scene["params"], prob,
                          iters=12, dense_schur=True)
    assert float(r_pcg.cost) < 1e-1 and float(r_dense.cost) < 1e-1
    np.testing.assert_allclose(
        np.asarray(r_dense.cam_t), np.asarray(r_pcg.cam_t), atol=2e-3
    )
    np.testing.assert_allclose(
        np.asarray(r_dense.points), np.asarray(r_pcg.points), atol=5e-3
    )
    # Dispatch cutoff sanity: GBA bench size is dense, Atlas capacity not.
    assert ba.auto_dense_schur(128, 16384)
    assert not ba.auto_dense_schur(512, 65536)
