"""Batched RANSAC solvers: two-view H/F reconstruction, Sim3 (Horn), P3P-style
pose hypotheses.

Re-design of `/root/reference/src/TwoViewReconstruction.cc` (monocular
initialization) and `src/Sim3Solver.cc`. The reference runs 200 RANSAC
iterations in two host threads (H model ∥ F model,
`TwoViewReconstruction.cc:Reconstruct`); here every hypothesis of both
models is one row of a vmapped batch — 200×2 model fits + scoring run as
a single XLA program (SURVEY.md §2.3: "both models as one batched
RANSAC").

All geometry is done in *normalized camera coordinates* (rays unprojected
with the camera model, z=1 plane): this makes the same code serve pinhole
and Kannala-Brandt fisheye (the reference reaches the same effect by
passing unprojected points with K=I, `KannalaBrandt8.cpp:
ReconstructWithTwoViews`).
"""

from __future__ import annotations

import functools
from typing import NamedTuple

import jax
import jax.numpy as jnp

from orbslam3_jax.ops import lie

# Reference thresholds (TwoViewReconstruction.cc:CheckHomography/Fundamental)
# in pixels with sigma=1; we scale by 1/f to use normalized coordinates.
TH_H_PX = 5.991
TH_F_PX = 3.841
TH_SCORE_PX = 5.991
N_HYPOTHESES = 200  # ref mMaxIterations
SAMPLE = 8


class TwoViewResult(NamedTuple):
    success: jnp.ndarray  # () bool
    R: jnp.ndarray  # (3,3) R21 (cam2 <- cam1 == world frame of cam1)
    t: jnp.ndarray  # (3,) unit norm
    points: jnp.ndarray  # (N,3) triangulated in cam1 frame
    is_good: jnp.ndarray  # (N,) bool — triangulated with parallax + cheirality
    used_homography: jnp.ndarray  # () bool


def _dlt_homography(p1: jnp.ndarray, p2: jnp.ndarray, weights=None) -> jnp.ndarray:
    """H21 from >=4 correspondences via DLT (`ComputeH21`,
    TwoViewReconstruction.cc:304)."""
    x1, y1 = p1[:, 0], p1[:, 1]
    x2, y2 = p2[:, 0], p2[:, 1]
    z = jnp.zeros_like(x1)
    o = jnp.ones_like(x1)
    r1 = jnp.stack([z, z, z, -x1, -y1, -o, y2 * x1, y2 * y1, y2], axis=-1)
    r2 = jnp.stack([x1, y1, o, z, z, z, -x2 * x1, -x2 * y1, -x2], axis=-1)
    if weights is not None:
        r1 = r1 * weights[:, None]
        r2 = r2 * weights[:, None]
    A = jnp.concatenate([r1, r2], axis=0)  # (2n,9)
    _, _, vt = jnp.linalg.svd(A, full_matrices=True)
    return vt[-1].reshape(3, 3)


def _eight_point_F(p1: jnp.ndarray, p2: jnp.ndarray, weights=None) -> jnp.ndarray:
    """F21 via the 8-point algorithm + rank-2 projection (`ComputeF21`,
    TwoViewReconstruction.cc:346). With `weights`, a weighted refit over
    an arbitrary number of correspondences (inlier refinement)."""
    x1, y1 = p1[:, 0], p1[:, 1]
    x2, y2 = p2[:, 0], p2[:, 1]
    o = jnp.ones_like(x1)
    A = jnp.stack(
        [x2 * x1, x2 * y1, x2, y2 * x1, y2 * y1, y2, x1, y1, o], axis=-1
    )  # (n,9)
    if weights is not None:
        A = A * weights[:, None]
    _, _, vt = jnp.linalg.svd(A, full_matrices=True)
    F = vt[-1].reshape(3, 3)
    u, s, vt2 = jnp.linalg.svd(F)
    s = s.at[2].set(0.0)
    return u @ jnp.diag(s) @ vt2


def _score_homography(H21, p1, p2, valid, th, th_score):
    """Symmetric transfer chi2 score (`CheckHomography`,
    TwoViewReconstruction.cc:383). Returns (score, inlier_mask)."""
    H12 = jnp.linalg.inv(H21)

    def transfer(H, a, b):
        ah = jnp.concatenate([a, jnp.ones_like(a[..., :1])], axis=-1)
        bh = ah @ H.T
        w = bh[..., 2:3]
        proj = bh[..., :2] / jnp.where(jnp.abs(w) < 1e-12, 1e-12, w)
        return jnp.sum((proj - b) ** 2, axis=-1)

    chi21 = transfer(H21, p1, p2)
    chi12 = transfer(H12, p2, p1)
    ok = valid & (chi21 < th) & (chi12 < th)
    score = jnp.sum(
        jnp.where(valid & (chi21 < th), th_score - chi21, 0.0)
        + jnp.where(valid & (chi12 < th), th_score - chi12, 0.0)
    )
    return score, ok


def _score_fundamental(F21, p1, p2, valid, th, th_score):
    """Epipolar line distance chi2 (`CheckFundamental`,
    TwoViewReconstruction.cc:470)."""
    p1h = jnp.concatenate([p1, jnp.ones_like(p1[..., :1])], axis=-1)
    p2h = jnp.concatenate([p2, jnp.ones_like(p2[..., :1])], axis=-1)
    l2 = p1h @ F21.T  # epipolar line in image 2
    l1 = p2h @ F21  # in image 1
    d2 = (jnp.sum(l2 * p2h, axis=-1) ** 2) / (l2[..., 0] ** 2 + l2[..., 1] ** 2 + 1e-12)
    d1 = (jnp.sum(l1 * p1h, axis=-1) ** 2) / (l1[..., 0] ** 2 + l1[..., 1] ** 2 + 1e-12)
    ok = valid & (d1 < th) & (d2 < th)
    score = jnp.sum(
        jnp.where(valid & (d2 < th), th_score - d2, 0.0)
        + jnp.where(valid & (d1 < th), th_score - d1, 0.0)
    )
    return score, ok


def triangulate_linear(R, t, p1, p2):
    """Batched DLT triangulation (`Triangulate`,
    TwoViewReconstruction.cc:818): cam1 = [I|0], cam2 = [R|t] in
    normalized coords. p1,p2: (N,2) -> (N,3) in cam1 frame."""
    P1 = jnp.concatenate([jnp.eye(3), jnp.zeros((3, 1))], axis=1)
    P2 = jnp.concatenate([R, t[:, None]], axis=1)

    def rows(P, p):
        return jnp.stack(
            [p[..., 0:1] * P[2] - P[0], p[..., 1:2] * P[2] - P[1]], axis=-2
        )  # (N,2,4)

    A = jnp.concatenate([rows(P1, p1), rows(P2, p2)], axis=-2)  # (N,4,4)
    _, _, vt = jnp.linalg.svd(A)
    X = vt[..., -1, :]
    w = X[..., 3:4]
    return X[..., :3] / jnp.where(jnp.abs(w) < 1e-12, 1e-12, w)


def _check_rt(R, t, p1, p2, valid, th, min_parallax_cos=0.99998):
    """Cheirality + reprojection + parallax check of one motion hypothesis
    (`CheckRT`, TwoViewReconstruction.cc:882). Returns (n_good, good_mask,
    parallax_ok, points)."""
    X = triangulate_linear(R, t, p1, p2)
    z1 = X[..., 2]
    X2 = (R @ X[..., None])[..., 0] + t
    z2 = X2[..., 2]
    # Parallax between rays.
    O2 = -R.T @ t  # cam2 center in cam1 frame
    r1 = X
    r2 = X - O2
    cosp = jnp.sum(r1 * r2, axis=-1) / (
        jnp.linalg.norm(r1, axis=-1) * jnp.linalg.norm(r2, axis=-1) + 1e-12
    )
    # Reprojection errors (normalized plane).
    e1 = jnp.sum((X[..., :2] / jnp.maximum(z1[..., None], 1e-9) - p1) ** 2, axis=-1)
    e2 = jnp.sum((X2[..., :2] / jnp.maximum(z2[..., None], 1e-9) - p2) ** 2, axis=-1)
    finite = jnp.all(jnp.isfinite(X), axis=-1)
    good = valid & finite & (z1 > 0) & (z2 > 0) & (e1 < th) & (e2 < th) & (cosp < min_parallax_cos)
    # Parallax of the 50th-best point (ref takes 50th smallest) — use median
    # of good points as the gate signal.
    n_good = jnp.sum(good.astype(jnp.int32))
    return n_good, good, X


def _decompose_E(E):
    """4 motion hypotheses from an essential matrix (`DecomposeE`,
    TwoViewReconstruction.cc:993)."""
    u, _, vt = jnp.linalg.svd(E)
    # Ensure proper rotations.
    Wm = jnp.asarray([[0.0, -1.0, 0.0], [1.0, 0.0, 0.0], [0.0, 0.0, 1.0]])
    R1 = u @ Wm @ vt
    R1 = R1 * jnp.sign(jnp.linalg.det(R1))
    R2 = u @ Wm.T @ vt
    R2 = R2 * jnp.sign(jnp.linalg.det(R2))
    t = u[:, 2]
    t = t / (jnp.linalg.norm(t) + 1e-12)
    return jnp.stack([R1, R1, R2, R2]), jnp.stack([t, -t, t, -t])


def _decompose_H(H):
    """8 motion hypotheses from a homography (Faugeras SVD method,
    `ReconstructH`, TwoViewReconstruction.cc:657)."""
    U, w, Vt = jnp.linalg.svd(H)
    s = jnp.linalg.det(U) * jnp.linalg.det(Vt)
    d1, d2, d3 = w[0], w[1], w[2]

    aux1 = jnp.sqrt(jnp.maximum((d1 * d1 - d2 * d2) / jnp.maximum(d1 * d1 - d3 * d3, 1e-12), 0.0))
    aux3 = jnp.sqrt(jnp.maximum((d2 * d2 - d3 * d3) / jnp.maximum(d1 * d1 - d3 * d3, 1e-12), 0.0))
    x1s = jnp.asarray([1.0, 1.0, -1.0, -1.0]) * aux1
    x3s = jnp.asarray([1.0, -1.0, 1.0, -1.0]) * aux3

    Rs, ts = [], []
    # d' = d2 case
    aux_s = jnp.sqrt(
        jnp.maximum((d1 * d1 - d2 * d2) * (d2 * d2 - d3 * d3), 0.0)
    ) / jnp.maximum((d1 + d3) * d2, 1e-12)
    st = aux_s
    ct = (d2 * d2 + d1 * d3) / jnp.maximum((d1 + d3) * d2, 1e-12)
    for i in range(4):
        sgn = 1.0 if i in (0, 3) else -1.0  # sign(x1*x3) per combination
        stheta = st * sgn
        Rp = jnp.asarray([[1.0, 0.0, 0.0], [0.0, 1.0, 0.0], [0.0, 0.0, 1.0]])
        Rp = Rp.at[0, 0].set(ct).at[0, 2].set(-stheta).at[2, 0].set(stheta).at[2, 2].set(ct)
        R = s * U @ Rp @ Vt
        tp = jnp.stack([x1s[i], 0.0, -x3s[i]]) * (d1 - d3)
        t = U @ tp
        Rs.append(R)
        ts.append(t / (jnp.linalg.norm(t) + 1e-12))
    # d' = -d2 case
    aux_sphi = jnp.sqrt(
        jnp.maximum((d1 * d1 - d2 * d2) * (d2 * d2 - d3 * d3), 0.0)
    ) / jnp.maximum((d1 - d3) * d2, 1e-12)
    cphi = (d1 * d3 - d2 * d2) / jnp.maximum((d1 - d3) * d2, 1e-12)
    for i in range(4):
        sgn = 1.0 if (i in (0, 3)) else -1.0
        sphi = aux_sphi * sgn
        Rp = jnp.asarray([[1.0, 0.0, 0.0], [0.0, -1.0, 0.0], [0.0, 0.0, -1.0]])
        Rp = Rp.at[0, 0].set(cphi).at[0, 2].set(sphi).at[2, 0].set(sphi).at[2, 2].set(-cphi)
        R = s * U @ Rp @ Vt
        tp = jnp.stack([x1s[i], 0.0, x3s[i]]) * (d1 + d3)
        t = U @ tp
        Rs.append(R)
        ts.append(t / (jnp.linalg.norm(t) + 1e-12))
    return jnp.stack(Rs), jnp.stack(ts)


# ---------------------------------------------------------------------------
# PnP RANSAC — relocalization
# ---------------------------------------------------------------------------


def _dlt_pnp(Xw: jnp.ndarray, rays: jnp.ndarray):
    """Camera pose from >=6 2D-3D pairs via projection-matrix DLT +
    rotation orthogonalization. Xw (n,3) world points, rays (n,2)
    normalized image coords. Returns (R, t) with x ~ K [R|t] X.

    Replaces the reference's MLPnP minimal solver
    (`/root/reference/src/MLPnPsolver.cpp:computePose`): the DLT is less
    statistically efficient per sample but we take 256 samples in one
    batch and refine with the LM pose optimizer afterwards, which
    dominates accuracy anyway.
    """
    n = Xw.shape[0]
    Xh = jnp.concatenate([Xw, jnp.ones((n, 1), Xw.dtype)], axis=1)  # (n,4)
    z = jnp.zeros((n, 4), Xw.dtype)
    r1 = jnp.concatenate([Xh, z, -rays[:, 0:1] * Xh], axis=1)  # (n,12)
    r2 = jnp.concatenate([z, Xh, -rays[:, 1:2] * Xh], axis=1)
    A = jnp.concatenate([r1, r2], axis=0)  # (2n,12)
    _, _, vt = jnp.linalg.svd(A, full_matrices=True)
    P = vt[-1].reshape(3, 4)
    return _pose_from_P(P, Xh)


def _pose_from_P(P: jnp.ndarray, Xh: jnp.ndarray):
    """Decompose a DLT projection matrix into (R, t): fix the global sign
    of P so projective depths are positive (cheirality), then polar-
    decompose M = s R."""
    w = Xh @ P[2]  # projective depths
    sgn = jnp.where(jnp.sum(jnp.sign(w)) < 0, -1.0, 1.0)
    P = P * sgn
    M = P[:, :3]
    U, S, Vt = jnp.linalg.svd(M)
    det = jnp.linalg.det(U @ Vt)
    R = U @ jnp.diag(jnp.asarray([1.0, 1.0, det])) @ Vt
    scale = jnp.mean(S) * det
    t = P[:, 3] / jnp.where(jnp.abs(scale) < 1e-12, 1e-12, scale)
    return R, t


def pnp_ransac(
    Xw: jnp.ndarray,  # (N,3) matched map points
    rays: jnp.ndarray,  # (N,2) normalized coords of keypoints
    valid: jnp.ndarray,  # (N,)
    key: jnp.ndarray,
    sigma_norm: float,
    n_hyp: int = 256,
    sample: int = 6,
    min_inliers: int = 15,
):
    """RANSAC pose from 2D-3D matches (`Tracking::Relocalization`'s MLPnP
    loop, `Tracking.cc:3307-3344`). Returns (ok, R, t, inlier_mask)."""
    w = valid.astype(jnp.float32)
    logits = jnp.log(w + 1e-9)
    samples = jax.random.categorical(key, logits[None, None, :], shape=(n_hyp, sample))
    Rs, ts = jax.vmap(lambda idx: _dlt_pnp(Xw[idx], rays[idx]))(samples)

    th = 5.991 * sigma_norm * sigma_norm

    def count(R, t, factor=1.0):
        Xc = Xw @ R.T + t
        zok = Xc[:, 2] > 1e-3
        proj = Xc[:, :2] / jnp.maximum(Xc[:, 2:3], 1e-9)
        e = jnp.sum((proj - rays) ** 2, axis=-1)
        inl = valid & zok & (e < th * factor)
        return jnp.sum(inl.astype(jnp.int32)), inl

    # Minimal-sample DLT poses are noisy: select with a LOOSE gate (the
    # reference follows its RANSAC with pose-only LM, Tracking.cc:3330),
    # then refit twice on shrinking inlier sets before the strict count.
    counts, inls = jax.vmap(lambda R, t: count(R, t, 16.0))(Rs, ts)
    best = jnp.argmax(counts)
    mask = inls[best]

    n = Xw.shape[0]
    Xh = jnp.concatenate([Xw, jnp.ones((n, 1), Xw.dtype)], axis=1)
    z = jnp.zeros((n, 4), Xw.dtype)

    def refit(mask):
        wm = mask.astype(Xw.dtype)
        r1 = jnp.concatenate([Xh, z, -rays[:, 0:1] * Xh], axis=1) * wm[:, None]
        r2 = jnp.concatenate([z, Xh, -rays[:, 1:2] * Xh], axis=1) * wm[:, None]
        A = jnp.concatenate([r1, r2], axis=0)
        _, _, vt = jnp.linalg.svd(A, full_matrices=True)
        P = vt[-1].reshape(3, 4)
        w_depth = (Xh @ P[2]) * wm
        P = P * jnp.where(jnp.sum(jnp.sign(w_depth)) < 0, -1.0, 1.0)
        M = P[:, :3]
        U, S, Vt = jnp.linalg.svd(M)
        det = jnp.linalg.det(U @ Vt)
        R = U @ jnp.diag(jnp.asarray([1.0, 1.0, det])) @ Vt
        scale = jnp.mean(S) * det
        t = P[:, 3] / jnp.where(jnp.abs(scale) < 1e-12, 1e-12, scale)
        return R, t

    R, t = refit(mask)
    _, mask2 = count(R, t, 4.0)
    R, t = refit(mask2)
    # MLPnP's maximum-likelihood stage (`/root/reference/src/
    # MLPnPsolver.cpp:139-160`): Gauss-Newton on the bearing-vector
    # nullspace residual over the loose-gate inliers. The DLT minimizes an
    # algebraic cost; this minimizes the geometric one the reference's
    # refineGaussNewton does, which matters under high keypoint noise.
    _, mask3 = count(R, t, 4.0)
    R, t = mlpnp_refine(R, t, Xw, rays, mask3)
    n_final, inl_final = count(R, t, 1.0)
    ok = n_final >= min_inliers
    return ok, R, t, inl_final


def _bearing_nullspace(b: jnp.ndarray):
    """Orthonormal (r, s) spanning the tangent plane of unit bearings
    b (n,3) — the reference's per-point nullspace(f) in
    `MLPnPsolver.cpp:computePose` (it uses the SVD of f; a cross-product
    basis spans the same plane and is branch-free)."""
    # Axis least aligned with b, one-hot per row (no data-dependent branch).
    pick = jnp.argmin(jnp.abs(b), axis=-1)  # (n,)
    e = jax.nn.one_hot(pick, 3, dtype=b.dtype)  # (n,3)
    r = jnp.cross(b, e)
    r = r / jnp.maximum(jnp.linalg.norm(r, axis=-1, keepdims=True), 1e-12)
    s = jnp.cross(b, r)
    return r, s


def mlpnp_refine(
    R: jnp.ndarray,
    t: jnp.ndarray,
    Xw: jnp.ndarray,
    rays: jnp.ndarray,
    mask: jnp.ndarray,
    iters: int = 5,
):
    """Maximum-likelihood PnP polish (`MLPnPsolver.cpp:139-160`
    refineGaussNewton): minimize the projections of the predicted bearing
    v_i = normalize(R X_i + t) onto the observed bearing's 2-D nullspace,
    Gauss-Newton over a left-multiplied se(3) twist. Fixed iteration
    count, one 6x6 solve per iter — everything else is batched matmuls."""
    from . import lie

    b = jnp.concatenate([rays, jnp.ones_like(rays[:, :1])], axis=-1)
    b = b / jnp.linalg.norm(b, axis=-1, keepdims=True)  # (n,3) observed
    nr, ns = _bearing_nullspace(b)
    w = mask.astype(Xw.dtype)

    def residuals(dR_t, R, t):
        Rc = lie.exp_so3(dR_t[:3]) @ R
        tc = t + dR_t[3:]
        v = Xw @ Rc.T + tc
        v = v / jnp.maximum(jnp.linalg.norm(v, axis=-1, keepdims=True), 1e-9)
        return jnp.stack([jnp.sum(nr * v, -1), jnp.sum(ns * v, -1)], -1) * w[:, None]

    def step(_, Rt):
        R, t = Rt
        zero = jnp.zeros(6, Xw.dtype)
        e = residuals(zero, R, t).reshape(-1)
        J = jax.jacfwd(lambda d: residuals(d, R, t).reshape(-1))(zero)
        H = J.T @ J + 1e-9 * jnp.eye(6, dtype=Xw.dtype)
        d = -jnp.linalg.solve(H, J.T @ e)
        return lie.exp_so3(d[:3]) @ R, t + d[3:]

    return jax.lax.fori_loop(0, iters, step, (R, t))


# ---------------------------------------------------------------------------
# Sim3 RANSAC (Horn closed form) — loop closing / map merging
# ---------------------------------------------------------------------------


def horn_sim3(P1: jnp.ndarray, P2: jnp.ndarray, fix_scale: bool = False):
    """Closed-form similarity P2 ~= s R P1 + t from >=3 point pairs
    (Horn's quaternion method, ref `Sim3Solver::ComputeSim3`
    `Sim3Solver.cc:316`). P1, P2: (n, 3)."""
    c1 = jnp.mean(P1, axis=0)
    c2 = jnp.mean(P2, axis=0)
    X = P1 - c1
    Y = P2 - c2
    M = Y.T @ X  # cross-covariance (note: maps 1 -> 2)
    Sxx, Sxy, Sxz = M[0, 0], M[0, 1], M[0, 2]
    Syx, Syy, Syz = M[1, 0], M[1, 1], M[1, 2]
    Szx, Szy, Szz = M[2, 0], M[2, 1], M[2, 2]
    N = jnp.asarray(
        [
            [Sxx + Syy + Szz, Szy - Syz, Sxz - Szx, Syx - Sxy],
            [Szy - Syz, Sxx - Syy - Szz, Sxy + Syx, Szx + Sxz],
            [Sxz - Szx, Sxy + Syx, -Sxx + Syy - Szz, Syz + Szy],
            [Syx - Sxy, Szx + Sxz, Syz + Szy, -Sxx - Syy + Szz],
        ]
    )
    _, vecs = jnp.linalg.eigh(N)
    q = vecs[:, -1]  # (w,x,y,z) of the rotation 1 -> 2
    R = lie.mat_from_quat(q)
    if fix_scale:
        s = jnp.asarray(1.0, P1.dtype)
    else:
        s = jnp.sum(Y * (X @ R.T)) / jnp.maximum(jnp.sum(X * X), 1e-12)
    t = c2 - s * R @ c1
    return R, t, s


def sim3_ransac(
    X1: jnp.ndarray,  # (N,3) points in KF1 camera frame
    X2: jnp.ndarray,  # (N,3) matched points in KF2 camera frame
    valid: jnp.ndarray,  # (N,)
    key: jnp.ndarray,
    err_px1: jnp.ndarray,  # (N,) max sq pixel error gates (9.21 * sigma2)
    err_px2: jnp.ndarray,
    project1,  # callable (N,3)->(N,2) projection into KF1 image
    project2,
    uv1: jnp.ndarray,  # (N,2) observed pixels in KF1
    uv2: jnp.ndarray,
    fix_scale: bool = False,
    n_hyp: int = 128,
    min_inliers: int = 20,
):
    """Batched Sim3 RANSAC (ref `Sim3Solver::iterate` `Sim3Solver.cc:221`):
    n_hyp Horn fits on 3-point samples, dual-reprojection inlier check
    (`CheckInliers` `Sim3Solver.cc:430`). Returns (ok, R12, t12, s12,
    inlier_mask) with the convention X1 ~= s12 R12 X2 + t12? No:
    returns T21-style (maps frame-1 points into frame 2), matching Horn
    above: X2 ~= s R X1 + t."""
    w = valid.astype(jnp.float32)
    logits = jnp.log(w + 1e-9)
    samples = jax.random.categorical(key, logits[None, None, :], shape=(n_hyp, 3))
    s1 = X1[samples]  # (B,3,3)
    s2 = X2[samples]
    Rs, ts, ss = jax.vmap(lambda a, b: horn_sim3(a, b, fix_scale))(s1, s2)

    def count_inliers(R, t, s):
        # 1 -> 2: project transformed X1 into image 2.
        X1in2 = s * (X1 @ R.T) + t
        e2 = jnp.sum((project2(X1in2) - uv2) ** 2, axis=-1)
        # 2 -> 1 with the inverse.
        Rinv = R.T
        X2in1 = (X2 - t) @ R / jnp.maximum(s, 1e-12)
        e1 = jnp.sum((project1(X2in1) - uv1) ** 2, axis=-1)
        inl = valid & (e1 < err_px1) & (e2 < err_px2)
        return jnp.sum(inl.astype(jnp.int32)), inl

    counts, inls = jax.vmap(count_inliers)(Rs, ts, ss)
    best = jnp.argmax(counts)
    n_best = counts[best]
    # Refit on the winning inliers (weighted Horn via masked centroids).
    mask = inls[best]
    wm = mask.astype(X1.dtype)[:, None]
    nm = jnp.maximum(jnp.sum(wm), 3.0)
    c1 = jnp.sum(X1 * wm, 0) / nm
    c2 = jnp.sum(X2 * wm, 0) / nm
    Xc = (X1 - c1) * wm
    Yc = (X2 - c2) * wm
    M = Yc.T @ Xc
    N4 = jnp.asarray(
        [
            [M[0, 0] + M[1, 1] + M[2, 2], M[2, 1] - M[1, 2], M[0, 2] - M[2, 0], M[1, 0] - M[0, 1]],
            [M[2, 1] - M[1, 2], M[0, 0] - M[1, 1] - M[2, 2], M[0, 1] + M[1, 0], M[2, 0] + M[0, 2]],
            [M[0, 2] - M[2, 0], M[0, 1] + M[1, 0], -M[0, 0] + M[1, 1] - M[2, 2], M[1, 2] + M[2, 1]],
            [M[1, 0] - M[0, 1], M[2, 0] + M[0, 2], M[1, 2] + M[2, 1], -M[0, 0] - M[1, 1] + M[2, 2]],
        ]
    )
    _, vecs = jnp.linalg.eigh(N4)
    Rr = lie.mat_from_quat(vecs[:, -1])
    if fix_scale:
        sr = jnp.asarray(1.0, X1.dtype)
    else:
        sr = jnp.sum(Yc * (Xc @ Rr.T)) / jnp.maximum(jnp.sum(Xc * Xc), 1e-12)
    tr = c2 - sr * Rr @ c1
    n_refit, inl_refit = count_inliers(Rr, tr, sr)
    ok = n_refit >= min_inliers
    return ok, Rr, tr, sr, inl_refit


@functools.partial(jax.jit, static_argnames=("min_triangulated",))
def reconstruct_two_views(
    p1: jnp.ndarray,  # (N,2) normalized coords frame 1
    p2: jnp.ndarray,  # (N,2) matched normalized coords frame 2
    valid: jnp.ndarray,  # (N,) bool
    key: jnp.ndarray,  # PRNG key for hypothesis sampling
    sigma_norm: float = 1.0 / 450.0,  # 1px at f=450 in normalized units
    min_triangulated: int = 50,
) -> TwoViewResult:
    """Full monocular initialization (`Reconstruct`,
    TwoViewReconstruction.cc:51): batched H&F hypotheses, model selection
    by score ratio RH>0.5 -> H, motion recovery with cheirality voting.
    """
    N = p1.shape[0]
    inv_s2 = 1.0 / (sigma_norm * sigma_norm)
    th_h = TH_H_PX / inv_s2
    th_f = TH_F_PX / inv_s2
    th_sc = TH_SCORE_PX / inv_s2

    # --- hypothesis sampling (valid-biased: invalid matches get weight 0).
    w = valid.astype(jnp.float32)
    logits = jnp.log(w + 1e-9)
    samples = jax.random.categorical(
        key, logits[None, None, :], shape=(N_HYPOTHESES, SAMPLE)
    )  # (200,8)
    sp1 = p1[samples]  # (200,8,2)
    sp2 = p2[samples]

    H_all = jax.vmap(_dlt_homography)(sp1, sp2)
    F_all = jax.vmap(_eight_point_F)(sp1, sp2)

    score_H, _ = jax.vmap(lambda H: _score_homography(H, p1, p2, valid, th_h, th_sc))(H_all)
    score_F, _ = jax.vmap(lambda F: _score_fundamental(F, p1, p2, valid, th_f, th_sc))(F_all)

    best_h = jnp.argmax(score_H)
    best_f = jnp.argmax(score_F)
    SH, SF = score_H[best_h], score_F[best_f]
    H = H_all[best_h]
    F = F_all[best_f]
    _, inl_H = _score_homography(H, p1, p2, valid, th_h, th_sc)
    _, inl_F = _score_fundamental(F, p1, p2, valid, th_f, th_sc)
    # Inlier refit: re-estimate each winning model on all of its inliers
    # (weighted DLT). A minimal-sample model is too noisy for the strict
    # cheirality/reprojection gates below.
    H = _dlt_homography(p1, p2, weights=inl_H.astype(p1.dtype))
    F = _eight_point_F(p1, p2, weights=inl_F.astype(p1.dtype))
    _, inl_H = _score_homography(H, p1, p2, valid, th_h, th_sc)
    _, inl_F = _score_fundamental(F, p1, p2, valid, th_f, th_sc)
    RH = SH / jnp.maximum(SH + SF, 1e-12)
    # Biased toward H (original ORB-SLAM rule RH>0.40): on a planar scene
    # both models saturate their scores (F is degenerate but consistent),
    # so RH ~= 0.5 — the bias breaks the tie toward the well-posed model.
    use_H = RH > 0.40

    # --- motion hypotheses: 8 from H, 4 from E; evaluate all 12, masked.
    Rs_h, ts_h = _decompose_H(H)
    E = F  # normalized coords => E = F
    Rs_e, ts_e = _decompose_E(E)
    Rs = jnp.concatenate([Rs_h, Rs_e])  # (12,3,3)
    ts = jnp.concatenate([ts_h, ts_e])
    from_H = jnp.arange(12) < 8
    hyp_valid = jnp.where(use_H, from_H, ~from_H)
    inl = jnp.where(use_H, inl_H[None, :], inl_F[None, :])  # (1,N)

    th_rt = 4.0 * (sigma_norm * sigma_norm)  # ref th2 = 4 sigma^2

    n_good, good, X = jax.vmap(
        lambda R, t: _check_rt(R, t, p1, p2, inl[0], th_rt)
    )(Rs, ts)
    n_good = jnp.where(hyp_valid, n_good, -1)
    best = jnp.argmax(n_good)
    n_best = n_good[best]
    # Clear-winner rule (ref: second best < 0.75 * best, ReconstructF:600).
    n_sorted = jnp.sort(n_good)[::-1]
    second = n_sorted[1]
    n_inliers = jnp.sum(inl[0].astype(jnp.int32))
    success = (
        (n_best >= min_triangulated)
        & (n_best > 0.9 * n_inliers * 0.5)
        & (second < 0.75 * n_best)
    )
    return TwoViewResult(
        success=success,
        R=Rs[best],
        t=ts[best],
        points=X[best],
        is_good=good[best],
        used_homography=use_H,
    )
