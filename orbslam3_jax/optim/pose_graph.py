"""Sim(3) pose-graph ("essential graph") optimization.

Re-design of `Optimizer::OptimizeEssentialGraph`
(`/root/reference/src/Optimizer.cc:2526` loop variant, `:3291` merge
variant) — the loop-closure correction that spreads a Sim3 drift estimate
over the keyframe graph instead of running full BA.

Formulation: vertices are batched Sim3 (R, t, s) arrays; every edge's
7-dof residual r = log_sim3(M_ji^-1 * S_jw * S_iw^-1) is linearized by
*forward-mode autodiff at zero perturbation* (vmapped over all edges at
once), and the normal equations are assembled dense — a K-keyframe graph
gives a (7K, 7K) SPD system, which for K <= 1024 is a single Cholesky
solve (cheaper than sparse bookkeeping).

The reference's edge set (spanning tree + covisibility >= 100 + loop
edges, `Optimizer.cc:2600-2700`) is built by the caller (loop_closing);
this module only solves.
"""

from __future__ import annotations

import functools
from typing import NamedTuple

import jax
import jax.numpy as jnp

from orbslam3_jax.ops import lie


class PoseGraph(NamedTuple):
    # Vertices: S_iw (world -> KF i)
    R: jnp.ndarray  # (K,3,3)
    t: jnp.ndarray  # (K,3)
    s: jnp.ndarray  # (K,)
    fixed: jnp.ndarray  # (K,) bool
    # Edges i -> j with measurement M_ji = S_jw * S_iw^-1
    edge_i: jnp.ndarray  # (E,) int32
    edge_j: jnp.ndarray  # (E,) int32
    edge_R: jnp.ndarray  # (E,3,3)
    edge_t: jnp.ndarray  # (E,3)
    edge_s: jnp.ndarray  # (E,)
    edge_valid: jnp.ndarray  # (E,) bool
    edge_weight: jnp.ndarray  # (E,) information scale (loop edges ~ higher)


def _residual(Ri, ti, si, Rj, tj, sj, Rm, tm, sm, xi_i, xi_j):
    """r = log_sim3(M^-1 * (exp(xi_j) Sj) * (exp(xi_i) Si)^-1)."""
    dRi, dti, dsi = lie.exp_sim3(xi_i)
    dRj, dtj, dsj = lie.exp_sim3(xi_j)
    Ri2, ti2, si2 = lie.sim3_compose(dRi, dti, dsi, Ri, ti, si)
    Rj2, tj2, sj2 = lie.sim3_compose(dRj, dtj, dsj, Rj, tj, sj)
    Rii, tii, sii = lie.sim3_inv(Ri2, ti2, si2)
    Rji, tji, sji = lie.sim3_compose(Rj2, tj2, sj2, Rii, tii, sii)
    Rmi, tmi, smi = lie.sim3_inv(Rm, tm, sm)
    Re, te, se = lie.sim3_compose(Rmi, tmi, smi, Rji, tji, sji)
    return lie.log_sim3(Re, te, se)


def _edge_res_and_jac(Ri, ti, si, Rj, tj, sj, Rm, tm, sm):
    z = jnp.zeros(7, Ri.dtype)
    r = _residual(Ri, ti, si, Rj, tj, sj, Rm, tm, sm, z, z)
    Ji = jax.jacfwd(lambda x: _residual(Ri, ti, si, Rj, tj, sj, Rm, tm, sm, x, z))(z)
    Jj = jax.jacfwd(lambda x: _residual(Ri, ti, si, Rj, tj, sj, Rm, tm, sm, z, x))(z)
    return r, Ji, Jj


@functools.partial(jax.jit, static_argnames=("iters", "dof4"))
def solve_pose_graph(g: PoseGraph, iters: int = 20, lam: float = 1e-6,
                     dof4: bool = False):
    """Gauss-Newton with tiny fixed damping (the problem is well-posed
    once >=1 vertex is fixed). Returns corrected (R, t, s).

    Budget mirrors the reference's 20 iterations
    (`Optimizer.cc:2812: optimizer.optimize(20)`).

    `dof4=True` restricts updates to translation + yaw with unit scale —
    the inertial essential graph (`Optimizer::OptimizeEssentialGraph4DoF`
    `Optimizer.cc:8604`): gravity pins roll/pitch and the IMU pins scale,
    so only 4 DoF may drift.
    """
    K = g.R.shape[0]
    dim = 7 * K
    # Free tangent dims per vertex: [rho(3), phi(3), sigma].
    if dof4:
        free_dims = jnp.asarray([1.0, 1.0, 1.0, 0.0, 0.0, 1.0, 0.0])
    else:
        free_dims = jnp.ones(7)

    def body(_, state):
        R, t, s = state
        Ri, ti, si = R[g.edge_i], t[g.edge_i], s[g.edge_i]
        Rj, tj, sj = R[g.edge_j], t[g.edge_j], s[g.edge_j]
        r, Ji, Jj = jax.vmap(_edge_res_and_jac)(
            Ri, ti, si, Rj, tj, sj, g.edge_R, g.edge_t, g.edge_s
        )  # (E,7), (E,7,7), (E,7,7)
        w = jnp.where(g.edge_valid, g.edge_weight, 0.0)
        # Zero out columns of fixed vertices and frozen DoF.
        Ji = Ji * (~g.fixed[g.edge_i])[:, None, None] * free_dims[None, None, :]
        Jj = Jj * (~g.fixed[g.edge_j])[:, None, None] * free_dims[None, None, :]
        rw = r * w[:, None]

        # Dense normal equations via scatter-add of 7x7 blocks.
        H = jnp.zeros((K, 7, K, 7), R.dtype)
        b = jnp.zeros((K, 7), R.dtype)
        JiTJi = jnp.einsum("eai,eaj,e->eij", Ji, Ji, w)
        JjTJj = jnp.einsum("eai,eaj,e->eij", Jj, Jj, w)
        JiTJj = jnp.einsum("eai,eaj,e->eij", Ji, Jj, w)
        H = H.at[g.edge_i, :, g.edge_i, :].add(JiTJi)
        H = H.at[g.edge_j, :, g.edge_j, :].add(JjTJj)
        H = H.at[g.edge_i, :, g.edge_j, :].add(JiTJj)
        H = H.at[g.edge_j, :, g.edge_i, :].add(jnp.swapaxes(JiTJj, -1, -2))
        b = b.at[g.edge_i].add(jnp.einsum("eai,ea->ei", Ji, rw))
        b = b.at[g.edge_j].add(jnp.einsum("eai,ea->ei", Jj, rw))

        Hf = H.reshape(dim, dim)
        # Fixed vertices: identity rows.
        fixed_rows = jnp.repeat(g.fixed, 7)
        Hf = jnp.where(fixed_rows[:, None] | fixed_rows[None, :], 0.0, Hf)
        Hf = Hf + jnp.diag(jnp.where(fixed_rows, 1.0, lam))
        bf = jnp.where(fixed_rows, 0.0, -b.reshape(-1))
        delta = jnp.linalg.solve(Hf, bf).reshape(K, 7)
        dR, dt, ds = lie.exp_sim3(delta)
        R2, t2, s2 = lie.sim3_compose(dR, dt, ds, R, t, s)
        R2 = lie.normalize_rotation(R2)
        return (R2, t2, s2)

    R, t, s = jax.lax.fori_loop(0, iters, body, (g.R, g.t, g.s))
    return R, t, s


def se3_to_sim3(R, t):
    """Lift SE3 poses to Sim3 with s=1 (for graph init)."""
    return R, t, jnp.ones(R.shape[:-2], R.dtype)


def correct_points(mp_pos, ref_R_old, ref_t_old, ref_s_old, ref_R_new, ref_t_new, ref_s_new):
    """Re-express points through their reference KF's correction:
    X' = S_new^-1(S_old(X)) (ref `CorrectLoop` map-point update,
    `LoopClosing.cc:1175-1204`)."""
    Xc = lie.sim3_apply(ref_R_old, ref_t_old, ref_s_old, mp_pos)
    Rn, tn, sn = lie.sim3_inv(ref_R_new, ref_t_new, ref_s_new)
    return lie.sim3_apply(Rn, tn, sn, Xc)
