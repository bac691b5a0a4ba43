"""Bundle adjustment with implicit Schur complement — the core g2o
replacement.

Re-designs `Optimizer::BundleAdjustment` / `LocalBundleAdjustment`
(`/root/reference/src/Optimizer.cc:78,1811`) and g2o's
`BlockSolver`+Schur machinery (`Thirdparty/g2o/g2o/core/block_solver.hpp`)
as fixed-shape array programs:

* The problem is a fixed-shape batch: cameras ``[C]``, points ``[P]``,
  observations ``[O]`` with validity masks — no graphs, no pointers.
* ``Hcc`` is block-diagonal (each observation touches one camera), so the
  reduced camera system ``S = Hcc - W Hpp^-1 W^T`` is applied
  *matrix-free*: one PCG matvec is two gathers + two segment-sums + tiny
  batched matmuls — exactly the shape XLA tiles well, and the layout that
  distributes over a device mesh with a single ``psum`` (see
  ``parallel/ba_sharded.py``).
* Landmarks are eliminated with closed-form batched 3x3 inverses; robust
  Huber weights and per-octave information are folded in by whitening.
* LM damping with accept/reject runs as fixed-shape `lax` control flow.

Fixed cameras (the reference's frontier KFs, `Optimizer.cc:1903-1944`)
simply get their Jacobian columns zeroed and an identity row in `Hcc`.
"""

from __future__ import annotations

from typing import NamedTuple, Tuple

import jax
import jax.numpy as jnp

from orbslam3_jax.ops import cameras as cam
from orbslam3_jax.ops import lie
from orbslam3_jax.optim import lm

HIGHEST = jax.lax.Precision.HIGHEST


class BAProblem(NamedTuple):
    cam_R: jnp.ndarray  # (C,3,3) Tcw rotations
    cam_t: jnp.ndarray  # (C,3)
    cam_fixed: jnp.ndarray  # (C,) bool
    points: jnp.ndarray  # (P,3) world positions
    point_valid: jnp.ndarray  # (P,) bool
    obs_cam: jnp.ndarray  # (O,) int32
    obs_point: jnp.ndarray  # (O,) int32
    obs_uv: jnp.ndarray  # (O,2)
    obs_ur: jnp.ndarray  # (O,) right-u; <0 => mono
    obs_sigma2: jnp.ndarray  # (O,)
    obs_valid: jnp.ndarray  # (O,) bool
    # Optional second-camera flag for two-camera rigs (stereo-fisheye):
    # rows with obs_right=True project through Trl * Tcw into the RIGHT
    # camera (ref `EdgeSE3ProjectXYZToBody`, `OptimizableTypes.h:132`).
    obs_right: jnp.ndarray | None = None  # (O,) bool


class BAResult(NamedTuple):
    cam_R: jnp.ndarray
    cam_t: jnp.ndarray
    points: jnp.ndarray
    obs_inlier: jnp.ndarray  # (O,) bool — chi2-gated at the final state
    cost: jnp.ndarray


def _linearize(model, params, bf, cam_R, cam_t, points, prob: BAProblem, active,
               cam2=None):
    """Whitened residuals and Jacobians for every observation.

    `cam2 = (params2, R_rl, t_rl)`: rows flagged in `prob.obs_right`
    project through the rig extrinsics into the second camera
    (`EdgeSE3ProjectXYZToBody` semantics) — the chain rule just inserts
    R_rl between the projection Jacobian and the pose/point blocks.

    Returns e_w (O,3), Jc_w (O,3,6), Jp_w (O,3,3), chi2 (O,), ok (O,).
    """
    Rc = cam_R[prob.obs_cam]  # (O,3,3)
    tc = cam_t[prob.obs_cam]
    Xw = points[prob.obs_point]
    Xc = lie.se3_apply(Rc, tc, Xw)
    if cam2 is not None and prob.obs_right is not None:
        params2, R_rl, t_rl = cam2
        is_r = prob.obs_right
        Xc2 = Xc @ R_rl.T + t_rl
        z = jnp.where(is_r, Xc2[..., 2], Xc[..., 2])
        uv_hat = jnp.where(
            is_r[:, None],
            cam.project(model, params2, Xc2),
            cam.project(model, params, Xc),
        )
        Jp_l = cam.project_jac(model, params, Xc)
        Jp_r = jnp.einsum("oij,jk->oik", cam.project_jac(model, params2, Xc2), R_rl)
        Jproj = jnp.where(is_r[:, None, None], Jp_r, Jp_l)
        is_stereo = (prob.obs_ur >= 0.0) & ~is_r
    else:
        z = Xc[..., 2]
        uv_hat = cam.project(model, params, Xc)
        Jproj = cam.project_jac(model, params, Xc)  # (O,2,3)
        is_stereo = prob.obs_ur >= 0.0
    inv_z = 1.0 / jnp.where(jnp.abs(z) < 1e-9, 1e-9, z)
    ur_hat = uv_hat[..., 0] - bf * inv_z
    e = jnp.concatenate(
        [uv_hat - prob.obs_uv, jnp.where(is_stereo, ur_hat - prob.obs_ur, 0.0)[..., None]],
        axis=-1,
    )

    dz = jnp.zeros_like(Jproj[:, 0, :]).at[:, 2].set(1.0)
    Jur = Jproj[:, 0, :] + (bf * inv_z * inv_z)[:, None] * dz
    Jur = jnp.where(is_stereo[:, None], Jur, 0.0)
    JXc = jnp.concatenate([Jproj, Jur[:, None, :]], axis=1)  # (O,3,3) d e / d Xc

    # Camera: left-mult update on Tcw -> dXc/d[rho,phi] = [I | -hat(Xc)]
    dXc_dcam = jnp.concatenate(
        [jnp.broadcast_to(jnp.eye(3, dtype=Xc.dtype), Xc.shape + (3,)), -lie.hat(Xc)],
        axis=-1,
    )  # (O,3,6)
    Jc = jnp.einsum("oij,ojk->oik", JXc, dXc_dcam)
    # Point: dXc/dXw = Rc
    Jp = jnp.einsum("oij,ojk->oik", JXc, Rc)

    # NaN safety, kept OFF the hot elementwise path (round-5 profile:
    # full-tensor isfinite().all() masks over Jc/Jp cost ~4 ms per
    # linearize at production shape — ~45% of a whole LM iteration — by
    # breaking XLA's elementwise fusion with three multi-axis
    # reductions). A NaN/overflowed CANDIDATE state only needs to be
    # impossible to ACCEPT, not scrubbed row-by-row:
    #  * the row mask takes finiteness from chi2 alone (already a
    #    per-row reduction of e), so poisoned rows leave `ok`;
    #  * `_robust_cost` charges every structurally-valid row outside
    #    `ok` a large constant, so an all-NaN candidate scores worst,
    #    not 0 — the LM accept test rejects it;
    #  * the dense solver zeroes a non-finite Newton step (self-healing
    #    below), so a poisoned reduced system yields a no-op candidate
    #    rather than NaN poses.
    # Under that accept-gate invariant every state the LM loop ever
    # keeps is finite, and w=0 (not a where-select) suffices for the
    # weighted tensors: J rows are finite whenever e is — both overflow
    # together, and z in (0, 1e-3] gives huge-but-finite fx/z.
    inv_s2 = 1.0 / prob.obs_sigma2
    chi2 = jnp.sum(e * e, axis=-1) * inv_s2
    ok = (active & prob.obs_valid & (z > 1e-3)
          & prob.point_valid[prob.obs_point] & jnp.isfinite(chi2))
    delta2 = jnp.where(is_stereo, lm.CHI2_STEREO, lm.CHI2_MONO)
    w = jnp.where(ok, inv_s2 * lm.huber_weight(chi2, delta2), 0.0)
    # Fixed cameras contribute to points but not to camera updates.
    cam_free = ~prob.cam_fixed[prob.obs_cam]
    sw = jnp.sqrt(w)[:, None, None]
    Jc_w = Jc * sw * cam_free[:, None, None]
    Jp_w = Jp * sw
    # e_w is (O,3) — an elementwise isfinite select here is ~free and
    # keeps the gradient side clean even for 0*inf rows.
    e_hw = e * jnp.sqrt(w)[:, None]
    e_w = jnp.where(jnp.isfinite(e_hw), e_hw, 0.0)
    return e_w, Jc_w, Jp_w, chi2, ok, is_stereo


def _robust_cost(chi2, ok, is_stereo, n_struct=None):
    """Huber-robust total cost. `n_struct`: count of structurally valid
    observations (valid obs row + valid point) — rows that are
    structural but NOT in `ok` were invalidated by the CURRENT state
    (behind-camera, overflowed projection) and must contribute a LARGE
    constant, not zero: otherwise a candidate bad enough to invalidate
    every observation scores cost 0 and wins the LM accept test
    (observed: a non-PD Schur solve emitted NaN poses, every chi2 went
    NaN -> ok all-False -> cost 0.0 -> accepted -> NaN written into the
    live map)."""
    d2 = jnp.where(is_stereo, lm.CHI2_STEREO, lm.CHI2_MONO)
    rho = jnp.where(chi2 <= d2, chi2, 2.0 * jnp.sqrt(d2 * jnp.maximum(chi2, 1e-12)) - d2)
    cost = jnp.sum(jnp.where(ok, rho, 0.0))
    if n_struct is not None:
        # ok is a subset of the structural rows, so |struct & ~ok| =
        # n_struct - |ok|; n_struct is state-independent and hoisted out
        # of the LM loop by the callers (a per-iteration gather of
        # point_valid over O rows measurably dragged the solve).
        cost = cost + 1e3 * (n_struct - jnp.sum(ok.astype(jnp.float32)))
    return cost


def auto_dense_schur(C: int, P: int, hbm_budget_bytes: int = 4 << 30) -> bool:
    """Pick the explicit-reduced-camera-system path when its PEAK HBM fits
    the budget; otherwise the matrix-free PCG path wins on memory.

    Peak accounting: the round-5 dense path materializes ONE (P, n_opt,
    3, 6) coupling tensor B (the L-whitened Schur factor) per
    linearization, with a gather scratch copy alive during the symmetric
    dot_general — ~3 tensors of C*P*18 f32 at peak (the LM carry holds
    (O)-sized Jacobians, not (P,C) tensors, since back-substitution runs
    at observation level). Budgeted conservatively at the full C here
    because GBA calls with n_opt=C.

    The win past the cutoff: one exact 6Cx6C solve replaces ~50 PCG matvec
    dispatches (fewer, larger device programs per LM iteration). Nf/O
    terms are
    ignored: observation-sized buffers are shared by both paths and don't
    differentiate them."""
    peak_bytes = 3 * C * P * 18 * 4
    return peak_bytes <= hbm_budget_bytes


def solve_ba(
    model: cam.CameraModel,
    params: jnp.ndarray,
    prob: BAProblem,
    bf: float = 0.0,
    iters: int = 10,
    pcg_iters: int = 50,
    point_damping: float = 1e-6,
    axis_name: str | None = None,
    point_axis_local: bool = False,
    dense_schur: bool = False,
    cam2=None,  # (params2, R_rl, t_rl) two-camera rig extrinsics
    n_opt_prefix: int | None = None,
    obs_per_cam: int | None = None,
    early_stop_tol: float | None = None,
) -> BAResult:
    """LM bundle adjustment. `iters` ~ the reference's budgets
    (5+10 local `Optimizer.cc:1990-2012`, 10 global, 20 at init).

    `axis_name`: when called inside `shard_map` with the observation axis
    sharded across a device mesh (cameras/points replicated), pass the
    mesh axis name — every observation reduction becomes a local
    segment-sum + one `psum` across the mesh, which is the entire distributed-BA
    communication pattern (SURVEY.md §5.8).

    `point_axis_local`: the point axis is SHARDED, not replicated — this
    shard owns `prob.points` and every observation of those points
    (`prob.obs_point` holds shard-local indices). Point-block reductions
    (Hpp, bp, both PCG matvec segment-sums into points) then need NO
    collective at all; only the reduced camera system is `psum`'d. This
    is the state-scaling layout of `parallel/ba_sharded.py::
    solve_ba_point_sharded` (SURVEY §7 step 9: keyframe/map-point block
    partitioning).

    `dense_schur`: assemble the reduced camera system S = Hcc - W Hpp^-1
    W^T EXPLICITLY (one segment-sum into (P,C) coupling blocks + one
    large contraction) and solve the tiny dense 6Cx6C system, instead
    of running `pcg_iters` matrix-free matvecs. Two wins: (a) on one chip
    the whole Schur solve is ~3 device ops instead of ~10*pcg_iters tiny
    gather/scatter ops inside a fori_loop — the LM iteration stops being
    dispatch-bound; (b) distributed (`point_axis_local`), the ONLY
    collective per LM iteration is one psum of (S, b_red) — 36C^2+6C
    floats — where the matrix-free path psums every matvec
    (g2o's sparse-Cholesky-on-host role, re-laid-out as one dense solve).
    Memory is O(P*C*18) for the coupling blocks — use for C up to ~128."""
    if dense_schur:
        return _solve_ba_dense(
            model, params, prob, bf, iters, point_damping, axis_name,
            point_axis_local, cam2=cam2, n_opt_prefix=n_opt_prefix,
            obs_per_cam=obs_per_cam, early_stop_tol=early_stop_tol,
        )

    C = prob.cam_R.shape[0]
    P = prob.points.shape[0]

    def _allreduce(x):
        return jax.lax.psum(x, axis_name) if axis_name is not None else x

    def seg_cam(vals):  # (O_local,...) -> (C,...) replicated
        return _allreduce(jax.ops.segment_sum(vals, prob.obs_cam, num_segments=C))

    def seg_point(vals):  # (O_local,...) -> (P,...); local when points are sharded
        s = jax.ops.segment_sum(vals, prob.obs_point, num_segments=P)
        return s if point_axis_local else _allreduce(s)

    eye6 = jnp.eye(6, dtype=prob.cam_R.dtype)
    eye3 = jnp.eye(3, dtype=prob.cam_R.dtype)

    def gn_step(state, lamb):
        cam_R, cam_t, points = state
        e_w, Jc_w, Jp_w, chi2, ok, is_st = _linearize(
            model, params, bf, cam_R, cam_t, points, prob,
            jnp.ones_like(prob.obs_valid), cam2=cam2,
        )
        # Point-block Hessians (local-complete when the point axis is
        # sharded, so the damped inverse below is exact per shard).
        Hpp = seg_point(jnp.einsum("oij,oik->ojk", Jp_w, Jp_w))  # (P,3,3)
        bp = -seg_point(jnp.einsum("oij,oi->oj", Jp_w, e_w))  # (P,3)
        Hpp = Hpp + (lamb * jnp.abs(Hpp) * jnp.eye(3)[None] + point_damping * eye3[None])
        Hpp_inv = lm.inv3x3(Hpp)
        y0 = jnp.einsum("pij,pj->pi", Hpp_inv, bp)  # (P,3)
        v0 = jnp.einsum("oij,oj->oi", Jp_w, y0[prob.obs_point])  # (O,3)

        def _damp_cc(Hcc_raw):
            H = Hcc_raw + (lamb * jnp.abs(Hcc_raw) * jnp.eye(6)[None] + 1e-8 * eye6[None])
            return jnp.where(prob.cam_fixed[:, None, None], eye6[None], H)

        Hcc = _damp_cc(seg_cam(jnp.einsum("oij,oik->ojk", Jc_w, Jc_w)))
        bc = -seg_cam(jnp.einsum("oij,oi->oj", Jc_w, e_w))  # (C,6)
        Hcc_inv = jnp.linalg.inv(Hcc)  # block-Jacobi preconditioner

        # Reduced RHS: b_red = bc - W Hpp^-1 bp.
        b_red = bc - seg_cam(jnp.einsum("oij,oi->oj", Jc_w, v0))

        def matvec(x):  # x: (C,6)
            u = jnp.einsum("oij,oj->oi", Jc_w, x[prob.obs_cam])  # (O,3)
            tp = seg_point(jnp.einsum("oij,oi->oj", Jp_w, u))  # (P,3)
            y = jnp.einsum("pij,pj->pi", Hpp_inv, tp)
            v = jnp.einsum("oij,oj->oi", Jp_w, y[prob.obs_point])  # (O,3)
            z = seg_cam(jnp.einsum("oij,oi->oj", Jc_w, v))
            Hx = jnp.einsum("cij,cj->ci", Hcc, x)
            return Hx - z

        def precond(r):
            return jnp.einsum("cij,cj->ci", Hcc_inv, r)

        dc = lm.pcg(matvec, b_red, precond, iters=pcg_iters).x  # (C,6)
        dc = jnp.where(prob.cam_fixed[:, None], 0.0, dc)

        # Back-substitute points: dp = Hpp^-1 (bp - W^T dc).
        u = jnp.einsum("oij,oj->oi", Jc_w, dc[prob.obs_cam])
        tp = seg_point(jnp.einsum("oij,oi->oj", Jp_w, u))
        dp = jnp.einsum("pij,pj->pi", Hpp_inv, bp - tp)
        dp = jnp.where(prob.point_valid[:, None], dp, 0.0)

        dR, dt = lie.exp_se3(dc)
        R_new, t_new = lie.se3_compose(dR, dt, cam_R, cam_t)
        R_new = lie.normalize_rotation(R_new)
        R_new = jnp.where(prob.cam_fixed[:, None, None], cam_R, R_new)
        t_new = jnp.where(prob.cam_fixed[:, None], cam_t, t_new)
        return (R_new, t_new, points + dp)

    n_struct = jnp.sum(
        (prob.obs_valid & prob.point_valid[prob.obs_point])
        .astype(jnp.float32))

    def cost_fn(state):
        cam_R, cam_t, points = state
        _, _, _, chi2, ok, is_st = _linearize(
            model, params, bf, cam_R, cam_t, points, prob,
            jnp.ones_like(prob.obs_valid), cam2=cam2,
        )
        return _allreduce(_robust_cost(chi2, ok, is_st, n_struct=n_struct))

    state, cost = lm.lm_loop(
        (prob.cam_R, prob.cam_t, prob.points), cost_fn, gn_step, iters
    )
    cam_R, cam_t, points = state
    _, _, _, chi2, ok, is_st = _linearize(
        model, params, bf, cam_R, cam_t, points, prob,
        jnp.ones_like(prob.obs_valid), cam2=cam2,
    )
    gate = jnp.where(is_st, lm.CHI2_STEREO, lm.CHI2_MONO)
    inlier = ok & (chi2 <= gate)
    return BAResult(cam_R=cam_R, cam_t=cam_t, points=points, obs_inlier=inlier, cost=cost)


def _chol3x3(A: jnp.ndarray) -> jnp.ndarray:
    """Closed-form batched lower Cholesky of SPD (…,3,3)."""
    a11 = jnp.sqrt(jnp.maximum(A[..., 0, 0], 1e-20))
    l21 = A[..., 1, 0] / a11
    l31 = A[..., 2, 0] / a11
    a22 = jnp.sqrt(jnp.maximum(A[..., 1, 1] - l21 * l21, 1e-20))
    l32 = (A[..., 2, 1] - l31 * l21) / a22
    a33 = jnp.sqrt(jnp.maximum(A[..., 2, 2] - l31 * l31 - l32 * l32, 1e-20))
    z = jnp.zeros_like(a11)
    return jnp.stack(
        [
            jnp.stack([a11, z, z], -1),
            jnp.stack([l21, a22, z], -1),
            jnp.stack([l31, l32, a33], -1),
        ],
        -2,
    )


def _solve_ba_dense(
    model, params, prob: BAProblem, bf, iters, point_damping,
    axis_name, point_axis_local, cam2=None, n_opt_prefix=None,
    obs_per_cam=None, early_stop_tol=None,
) -> BAResult:
    """Explicit-reduced-camera-system LM (the `dense_schur=True` path).

    Per iteration: ONE linearization at the current candidate, whose
    robust cost doubles as the accept/reject test for the PREVIOUS step
    (deferred-accept LM — the classic evaluate-f-and-J-together
    formulation), and ONE collective: a psum of the packed
    (S, b_red, Hcc, cost). A rejected step re-damps the STORED base
    linearization (S is tiny), exactly like g2o's LM re-try with raised
    lambda (`optimization_algorithm_levenberg.cpp`). The point blocks
    carry a fixed (lambda-independent) damping so S depends on lambda
    only through its camera diagonal.

    Layout:

    * `n_opt_prefix` (static): the optimizable cameras are the FIRST
      `n_opt` rows of the camera axis (the local-BA window; the fixed
      frontier follows). Fixed cameras have zero camera-Jacobians, so the
      Schur coupling tensor and the reduced system only need the window
      columns — S is (6*n_opt)^2, and the (P, n_opt) coupling gather is
      ~C/n_opt-fold smaller than the full (P, C) one.
    * The Schur cross term is ONE symmetric `dot_general`: with
      Hpp_d^-1 = L L^T (closed-form 3x3 Cholesky), per-obs
      G_o = L_p^T (Jp_o^T Jc_o) gathered into (P, n_opt, 3, 6) and
      contracted over (p, 3) — S_cross = B^T B with no transposed copies
      and no separate Hpp^-1 W tensor.
    * `obs_per_cam` (static): when observations are camera-major with a
      fixed per-camera count (the local-BA assembly), Hcc/bc come from
      ONE batched augmented matmul (C, 3*opc, 7)^T-contract instead of a
      one-hot matmul (no (O, C) materialization).
    * Hpp|bp are ONE fused (O,12) segment scatter (one pass over the
      observation rows instead of two).
    * Back-substitution runs at observation level (tp via one (O,3)
      segment-sum), so the LM carry holds (O)-sized Jacobians + the
      (P, n_opt) B tensor instead of two (P, C) coupling tensors.
    * `early_stop_tol` (static): if set, the LM loop is a while_loop that
      stops after an ACCEPTED step improves relative cost by less than
      the tolerance — the analog of the reference's chi2-driven early
      abort (`Optimizer.cc:1811` 5+10 schedule with `mbAbortBA`).
    """
    C = prob.cam_R.shape[0]
    P = prob.points.shape[0]
    O = prob.obs_cam.shape[0]
    n_opt = C if n_opt_prefix is None else int(n_opt_prefix)
    dtype = prob.cam_R.dtype
    eye6 = jnp.eye(6, dtype=dtype)
    diag_idx = jnp.arange(n_opt)
    fixed = prob.cam_fixed
    fixed_w = fixed[:n_opt]  # dynamic-fixed inside the window prefix
    obs_shared = axis_name is not None and not point_axis_local
    # State-independent: computed once, reused by every LM iteration's
    # accept cost (see _robust_cost).
    n_struct = jnp.sum(
        (prob.obs_valid & prob.point_valid[prob.obs_point])
        .astype(jnp.float32))

    # A (point, camera) pair holds AT MOST ONE observation (a map point
    # occupies one feature slot per keyframe — add_keyframe/fuse Replace
    # semantics dedupe), so the coupling blocks are a PLACEMENT, not a
    # sum: build the (P*n_opt -> obs row) index map once per solve and
    # turn every per-iteration build into a gather instead of a
    # scatter-add. Invalid rows and fixed-camera rows are redirected to
    # a dump slot.
    in_win = prob.obs_cam < n_opt
    pk = prob.obs_point * n_opt + jnp.where(in_win, prob.obs_cam, 0)
    pk_safe = jnp.where(prob.obs_valid & in_win, pk, P * n_opt)
    inv_idx = (
        jnp.full(P * n_opt + 1, O, jnp.int32)
        .at[pk_safe]
        .set(jnp.arange(O, dtype=jnp.int32), unique_indices=True)
    )[: P * n_opt]

    def _cam_reduce(Jc_w, e_w):
        """(Hcc (C,6,6), bc (C,6)) via batched matmul when camera-major,
        else one-hot matmul."""
        if obs_per_cam is not None:
            opc = int(obs_per_cam)
            A = jnp.concatenate([Jc_w, e_w[:, :, None]], axis=-1)  # (O,3,7)
            A = A.reshape(C, opc * 3, 7)
            H7 = jnp.einsum("cki,ckj->cij", A, A,
                            precision=HIGHEST)  # (C,7,7)
            return H7[:, :6, :6], -H7[:, :6, 6]
        cam_1h = jax.nn.one_hot(prob.obs_cam, C, dtype=dtype)  # (O, C)
        Hcc = jnp.matmul(
            cam_1h.T, jnp.einsum("oij,oik->ojk", Jc_w, Jc_w).reshape(O, 36),
            precision=HIGHEST).reshape(C, 6, 6)
        bc = -jnp.matmul(cam_1h.T, jnp.einsum("oij,oi->oj", Jc_w, e_w),
                         precision=HIGHEST)
        return Hcc, bc

    def linearize_pack(cam_R, cam_t, points):
        """Returns (S_und (n,6,n,6), b_red (n,6), Hcc_w (n,6,6),
        bp (P,3), Hpp_inv (P,3,3), B (P,n,3,6), Jc_w, Jp_w, e_w, cost) —
        everything a damped re-solve needs, reduced across shards in ONE
        psum."""
        e_w, Jc_w, Jp_w, chi2, ok, is_st = _linearize(
            model, params, bf, cam_R, cam_t, points, prob,
            jnp.ones_like(prob.obs_valid), cam2=cam2,
        )
        cost_l = _robust_cost(chi2, ok, is_st, n_struct=n_struct)
        gate = jnp.where(is_st, lm.CHI2_STEREO, lm.CHI2_MONO)
        inlier_l = ok & (chi2 <= gate)
        Hcc_l, bc_l = _cam_reduce(Jc_w, e_w)
        # Fused point-side scatter: [Jp^T Jp | -Jp^T e] as one (O,12) row.
        pp = jnp.einsum("oij,oik->ojk", Jp_w, Jp_w).reshape(O, 9)
        pe = -jnp.einsum("oij,oi->oj", Jp_w, e_w)  # (O,3)
        ppe = jax.ops.segment_sum(
            jnp.concatenate([pp, pe], axis=-1), prob.obs_point,
            num_segments=P,
        )  # (P,12)
        if obs_shared:
            # Observations sharded, points replicated: the point-side
            # partial sums must be global BEFORE Hpp^-1 — one (heavier)
            # psum; everything after is computed redundantly per shard.
            ppe, Hcc_g, bc_g, cost = jax.lax.psum(
                (ppe, Hcc_l, bc_l, cost_l), axis_name
            )
        else:
            Hcc_g, bc_g, cost = Hcc_l, bc_l, cost_l
        Hpp_g = ppe[:, :9].reshape(P, 3, 3)
        bp = ppe[:, 9:]
        # Lambda-INDEPENDENT point damping: absolute floor + small
        # relative Tikhonov, so a rejected step can re-damp S without
        # rebuilding the Schur term.
        Hpp_d = Hpp_g + (point_damping + 1e-4 * jnp.abs(Hpp_g)) * jnp.eye(
            3, dtype=dtype)[None]
        Hpp_inv = lm.inv3x3(Hpp_d)
        L = _chol3x3(Hpp_inv)  # Hpp_d^-1 = L L^T
        # G_o = L_p^T (Jp_o^T Jc_o): fold the point elimination into the
        # per-obs blocks BEFORE the dense gather, so the Schur cross term
        # is a single symmetric contraction of one tensor.
        JpL = jnp.einsum("oij,ojk->oik", Jp_w, L[prob.obs_point])  # Jp L
        G = jnp.einsum("oia,oib->oab", JpL, Jc_w).reshape(O, 18)  # L^T Jp^T Jc
        G = jnp.concatenate([G, jnp.zeros((1, 18), dtype)], 0)
        B_l = G[inv_idx].reshape(P, n_opt, 3, 6)
        if obs_shared:
            # Cross-shard obs of the same point break the symmetric-
            # contraction factorization — reduce B first.
            B = jax.lax.psum(B_l, axis_name)
        else:
            B = B_l
        # S_cross = B^T-contract-(p,i)-B: one dot_general, no copies.
        # Precision HIGHEST (full f32, not a reduced-mantissa default
        # such as the GPU's TF32): the reduced system is the DIFFERENCE
        # of two large similar terms, and mantissa loss here made S
        # indefinite on ill-conditioned low-texture windows — the
        # Cholesky then returned NaN poses into the live map. The camera
        # blocks (Hcc, bc, W^T y0) are summed over many observations and
        # take the same precision.
        S_cross = jax.lax.dot_general(
            B, B, (((0, 2), (0, 2)), ((), ())), precision=HIGHEST,
        )  # (n,6,n,6)
        y0 = jnp.einsum("pij,pj->pi", Hpp_inv, bp)
        # b_red = bc - W^T y0 at observation level (no dense W).
        v = jnp.einsum("oij,oj->oi", Jp_w, y0[prob.obs_point])  # (O,3)
        if obs_per_cam is not None:
            wy = jnp.einsum("oij,oi->oj", Jc_w, v).reshape(
                C, int(obs_per_cam), 6).sum(axis=1)
        else:
            cam_1h = jax.nn.one_hot(prob.obs_cam, C, dtype=dtype)
            wy = jnp.matmul(cam_1h.T, jnp.einsum("oij,oi->oj", Jc_w, v),
                            precision=HIGHEST)
        b_red_l = (bc_g - (jax.lax.psum(wy, axis_name)
                           if obs_shared else wy))[:n_opt]
        S_l = -S_cross
        S_l = S_l.at[diag_idx, :, diag_idx, :].add(Hcc_g[:n_opt])
        if obs_shared or axis_name is None:
            S_und, b_red, Hcc_w = S_l, b_red_l, Hcc_g[:n_opt]
        else:
            # Point-sharded layout: THE one collective per LM iteration.
            pack = jnp.concatenate([
                S_l.reshape(-1), b_red_l.reshape(-1),
                Hcc_g[:n_opt].reshape(-1), cost[None],
            ])
            pack = jax.lax.psum(pack, axis_name)
            n_s = n_opt * 6 * n_opt * 6
            n_b = n_opt * 6
            S_und = pack[:n_s].reshape(n_opt, 6, n_opt, 6)
            b_red = pack[n_s : n_s + n_b].reshape(n_opt, 6)
            Hcc_w = pack[n_s + n_b : n_s + n_b + n_opt * 36].reshape(
                n_opt, 6, 6)
            cost = pack[-1]
        return (S_und, b_red, Hcc_w, bp, Hpp_inv, Jc_w, Jp_w, inlier_l, cost)

    def damped_step(lin, state, lamb):
        S_und, b_red, Hcc_w, bp, Hpp_inv, Jc_w, Jp_w, _, _ = lin
        cam_R, cam_t, points = state
        damp = lamb * jnp.abs(Hcc_w) * eye6[None] + 1e-8 * eye6[None]
        S_g = S_und.at[diag_idx, :, diag_idx, :].add(damp)
        keep = (~fixed_w).astype(dtype)
        S_g = S_g * keep[:, None, None, None] * keep[None, None, :, None]
        S_g = S_g.at[diag_idx, :, diag_idx, :].add(
            jnp.where(fixed_w, 1.0, 0.0)[:, None, None] * eye6[None]
        )
        S = S_g.reshape(n_opt * 6, n_opt * 6)
        S = 0.5 * (S + S.T)
        rhs = jnp.where(fixed_w[:, None], 0.0, b_red)
        # S is SPD after damping + identity rows: Cholesky, not LU.
        chol = jax.scipy.linalg.cho_factor(
            S + 1e-7 * jnp.eye(n_opt * 6, dtype=dtype), lower=True)
        dc_w = jax.scipy.linalg.cho_solve(chol, rhs.reshape(-1)).reshape(
            n_opt, 6)
        # Self-healing on a failed factorization (S not PD despite
        # damping — starved windows in low-texture regimes): a zero step
        # is a candidate that cannot be accepted, so the LM loop raises
        # lambda and re-damps instead of writing NaN poses into the map.
        dc_w = jnp.where(jnp.isfinite(dc_w).all(), dc_w, 0.0)
        dc_w = jnp.where(fixed_w[:, None], 0.0, dc_w)
        dc = jnp.zeros((C, 6), dtype).at[:n_opt].set(dc_w)
        # Back-substitute points at observation level:
        # dp = Hpp_inv (bp - sum_o Jp^T (Jc dc)).
        u = jnp.einsum("oij,oj->oi", Jc_w, dc[prob.obs_cam])  # (O,3)
        tp_l = jax.ops.segment_sum(
            jnp.einsum("oij,oi->oj", Jp_w, u), prob.obs_point,
            num_segments=P)
        tp = jax.lax.psum(tp_l, axis_name) if obs_shared else tp_l
        dp = jnp.einsum("pij,pj->pi", Hpp_inv, bp - tp)
        dp = jnp.where(prob.point_valid[:, None], dp, 0.0)
        dR, dt = lie.exp_se3(dc)
        R_new, t_new = lie.se3_compose(dR, dt, cam_R, cam_t)
        R_new = lie.normalize_rotation(R_new)
        R_new = jnp.where(fixed[:, None, None], cam_R, R_new)
        t_new = jnp.where(fixed[:, None], cam_t, t_new)
        return (R_new, t_new, points + dp)

    base = (prob.cam_R, prob.cam_t, prob.points)
    lin0 = linearize_pack(*base)
    lam0 = jnp.asarray(1e-4, jnp.float32)
    cand0 = damped_step(lin0, base, lam0)

    def body(carry):
        i, done, base, lin, lam, cand = carry
        lin_c = linearize_pack(*cand)
        accept = lin_c[-1] < lin[-1]
        if early_stop_tol is not None:
            rel = (lin[-1] - lin_c[-1]) / jnp.maximum(lin[-1], 1e-12)
            done = accept & (rel < early_stop_tol)
        # lax.cond (not elementwise where): selects whole buffers — the
        # carried linearization includes the (O)-sized Jacobians, which a
        # where-blend would stream through memory twice per iter.
        base, lin = jax.lax.cond(
            accept, lambda: (cand, lin_c), lambda: (base, lin)
        )
        lam = jnp.clip(jnp.where(accept, lam * 0.5, lam * 4.0), 1e-9, 1e6)
        cand = damped_step(lin, base, lam)
        return (i + 1, done, base, lin, lam, cand)

    init = (jnp.asarray(0), jnp.asarray(False), base, lin0, lam0, cand0)
    if early_stop_tol is None:
        carry = init
        carry = jax.lax.fori_loop(0, iters, lambda _, c: body(c), carry)
    else:
        carry = jax.lax.while_loop(
            lambda c: (c[0] < iters) & ~c[1], body, init)
    _, _, base, lin, _, _ = carry
    cam_R, cam_t, points = base
    cost = lin[-1]
    # The inlier mask at the ACCEPTED base state rides in the LM carry
    # (computed by the same linearization whose cost accepted the step) —
    # re-linearizing here would duplicate a full residual/Jacobian pass.
    inlier = lin[-2]
    return BAResult(cam_R=cam_R, cam_t=cam_t, points=points,
                    obs_inlier=inlier, cost=cost)


solve_ba_jit = jax.jit(
    solve_ba,
    static_argnames=(
        "model", "iters", "pcg_iters", "axis_name", "point_axis_local",
        "dense_schur", "n_opt_prefix", "obs_per_cam", "early_stop_tol",
    ),
)
