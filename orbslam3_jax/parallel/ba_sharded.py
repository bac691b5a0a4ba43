"""Distributed bundle adjustment over a device mesh.

The decomposition (SURVEY.md §5.8 / §7 step 9): the *observation* axis is
sharded across devices; camera and point state is replicated. Every
reduction in the BA inner loop (block Hessians, Schur RHS, the PCG
matvec's two segment-sums) becomes local-segment-sum + `psum`.
The reduced camera system and its tiny Cholesky/PCG iterations are
computed redundantly on every device — they are O(C) work against O(O)
linearization work, so replication costs ~nothing and saves a broadcast.

This is the communication pattern of distributed block-Schur BA: one
all-reduce of the reduced system per matvec, nothing else.
"""

from __future__ import annotations

import functools
from typing import Optional

import jax
import jax.numpy as jnp
import numpy as np
from jax.sharding import Mesh, NamedSharding, PartitionSpec as P

from orbslam3_jax.optim import ba as ba_mod

AXIS = "obs"


def make_mesh(devices=None, axis: str = AXIS) -> Mesh:
    devices = devices if devices is not None else jax.devices()
    return Mesh(np.asarray(devices), (axis,))


def pad_obs(prob: ba_mod.BAProblem, n_shards: int) -> ba_mod.BAProblem:
    """Pad the observation axis to a multiple of the mesh size (padding
    rows are obs_valid=False)."""
    O = prob.obs_cam.shape[0]
    pad = (-O) % n_shards
    if pad == 0:
        return prob
    f = jnp.zeros(pad)
    return prob._replace(
        obs_cam=jnp.concatenate([prob.obs_cam, jnp.zeros(pad, jnp.int32)]),
        obs_point=jnp.concatenate([prob.obs_point, jnp.zeros(pad, jnp.int32)]),
        obs_uv=jnp.concatenate([prob.obs_uv, jnp.zeros((pad, 2))]),
        obs_ur=jnp.concatenate([prob.obs_ur, jnp.full(pad, -1.0)]),
        obs_sigma2=jnp.concatenate([prob.obs_sigma2, jnp.ones(pad)]),
        obs_valid=jnp.concatenate([prob.obs_valid, jnp.zeros(pad, bool)]),
    )


def solve_ba_sharded(
    model,
    params: jnp.ndarray,
    prob: ba_mod.BAProblem,
    mesh: Mesh,
    bf: float = 0.0,
    iters: int = 10,
    pcg_iters: int = 50,
) -> ba_mod.BAResult:
    """Run `optim.ba.solve_ba` with observations sharded over `mesh`.

    Returns the same result as the single-device solver (reductions are
    exact sums; only summation order differs)."""
    n = mesh.devices.size
    prob = pad_obs(prob, n)
    fn = _obs_sharded_program(model, mesh, bf, iters, pcg_iters)
    return fn(jnp.asarray(params), prob)


@functools.lru_cache(maxsize=32)
def _obs_sharded_program(model, mesh: Mesh, bf: float, iters: int, pcg_iters: int):
    axis = mesh.axis_names[0]
    obs_spec = ba_mod.BAProblem(
        cam_R=P(), cam_t=P(), cam_fixed=P(),
        points=P(), point_valid=P(),
        obs_cam=P(axis), obs_point=P(axis), obs_uv=P(axis), obs_ur=P(axis),
        obs_sigma2=P(axis), obs_valid=P(axis),
    )

    def _run(params, p):
        return ba_mod.solve_ba(
            model, params, p, bf=bf, iters=iters, pcg_iters=pcg_iters, axis_name=axis
        )

    return jax.jit(jax.shard_map(
        _run, mesh=mesh, in_specs=(P(), obs_spec),
        out_specs=ba_mod.BAResult(
            cam_R=P(), cam_t=P(), points=P(), obs_inlier=P(axis), cost=P()
        ),
        check_vma=False,
    ))


def solve_ba_point_sharded(
    model,
    params: jnp.ndarray,
    prob: ba_mod.BAProblem,
    mesh: Mesh,
    bf: float = 0.0,
    iters: int = 10,
    pcg_iters: int = 50,
    dense_schur: bool = True,
) -> ba_mod.BAResult:
    """Distributed BA v2: the MAP-POINT axis is block-partitioned across
    the mesh (SURVEY §7 step 9). Each device owns P/n point states, their
    Hpp blocks, AND every observation of its points — so all point-block
    reductions (Hpp, bp, both point segment-sums of the PCG matvec) are
    shard-local with NO collective; with `dense_schur` (default) the only
    communication is ONE `psum` of the explicit reduced camera system
    (S, b_red) per LM iteration — not one per PCG matvec. Unlike
    `solve_ba_sharded` (observations sharded, state replicated) this
    scales map-point MEMORY with devices, which is what a 2-host Atlas
    needs; camera state stays replicated (it is tiny: 9+3 floats/KF).

    Exact vs the single-device solver up to summation order.
    """
    n = mesh.devices.size
    prob_s, dst, fill, Pn = prep_point_sharded(prob, n)
    res = run_point_sharded(
        model, params, prob_s, mesh, bf=bf, iters=iters, pcg_iters=pcg_iters,
        dense_schur=dense_schur,
    )
    # Back to caller order: points are block-partitioned in order; the
    # observation inlier mask is scattered through the bucket permutation.
    inl = np.zeros(prob.obs_point.shape[0], bool)
    inl[dst[fill]] = np.asarray(res.obs_inlier)[fill]
    return res._replace(points=res.points[:Pn], obs_inlier=jnp.asarray(inl))


def prep_point_sharded(prob: ba_mod.BAProblem, n: int):
    """Host-side layout for the point-partitioned solve: pad the point
    axis to a multiple of `n`, bucket every observation into its owning
    shard's equal-size block (local point indices), order preserved
    within shards. Pure numpy so multi-process (multi-host) drivers can run it
    identically on every host. Returns (prob_s, dst, fill, P_orig)."""
    Pn = prob.points.shape[0]
    pad_p = (-Pn) % n
    if pad_p:
        prob = prob._replace(
            points=jnp.concatenate([prob.points, jnp.zeros((pad_p, 3))]),
            point_valid=jnp.concatenate([prob.point_valid, jnp.zeros(pad_p, bool)]),
        )
    ss = (Pn + pad_p) // n  # points per shard (block partition, order kept)

    obs_pt = np.asarray(prob.obs_point)
    owner = obs_pt // ss
    counts = np.bincount(owner, minlength=n)
    maxO = max(int(counts.max()), 1)
    perm = np.argsort(owner, kind="stable")
    starts = np.zeros(n, np.int64)
    starts[1:] = np.cumsum(counts)[:-1]
    dst = np.zeros(n * maxO, np.int64)  # source obs index per slot (pad: 0)
    fill = np.zeros(n * maxO, bool)
    for sh in range(n):
        src = perm[starts[sh] : starts[sh] + counts[sh]]
        dst[sh * maxO : sh * maxO + len(src)] = src
        fill[sh * maxO : sh * maxO + len(src)] = True

    take = jnp.asarray(dst)
    fill_j = jnp.asarray(fill)
    local_pt = jnp.asarray((obs_pt[dst] - owner[dst] * ss) * fill)
    prob_s = prob._replace(
        obs_cam=jnp.where(fill_j, prob.obs_cam[take], 0),
        obs_point=jnp.where(fill_j, local_pt, 0).astype(jnp.int32),
        obs_uv=prob.obs_uv[take],
        obs_ur=jnp.where(fill_j, prob.obs_ur[take], -1.0),
        obs_sigma2=jnp.where(fill_j, prob.obs_sigma2[take], 1.0),
        obs_valid=fill_j & prob.obs_valid[take],
        obs_right=None if prob.obs_right is None
        else fill_j & prob.obs_right[take],
    )
    return prob_s, dst, fill, Pn


def point_sharded_specs(axis: str):
    """(in_spec, out_spec) PartitionSpecs of the point-partitioned solve."""
    in_spec = ba_mod.BAProblem(
        cam_R=P(), cam_t=P(), cam_fixed=P(),
        points=P(axis), point_valid=P(axis),
        obs_cam=P(axis), obs_point=P(axis), obs_uv=P(axis), obs_ur=P(axis),
        obs_sigma2=P(axis), obs_valid=P(axis),
    )
    out_spec = ba_mod.BAResult(
        cam_R=P(), cam_t=P(), points=P(axis), obs_inlier=P(axis), cost=P()
    )
    return in_spec, out_spec


@functools.lru_cache(maxsize=32)
def _point_sharded_program(model, mesh: Mesh, bf: float, iters: int,
                           pcg_iters: int, dense_schur: bool):
    """Build + cache the jitted point-sharded program PER CONFIG — a fresh
    closure every call would defeat jit's trace cache and recompile each
    invocation (params rides as a traced argument)."""
    axis = mesh.axis_names[0]
    in_spec, out_spec = point_sharded_specs(axis)

    def _run(params, p):
        return ba_mod.solve_ba(
            model, params, p, bf=bf, iters=iters, pcg_iters=pcg_iters,
            axis_name=axis, point_axis_local=True, dense_schur=dense_schur,
        )

    return jax.jit(jax.shard_map(
        _run, mesh=mesh, in_specs=(P(), in_spec), out_specs=out_spec,
        check_vma=False,
    ))


def run_point_sharded(
    model, params, prob_s: ba_mod.BAProblem, mesh: Mesh,
    bf: float = 0.0, iters: int = 10, pcg_iters: int = 50,
    dense_schur: bool = True,
) -> ba_mod.BAResult:
    """The device program of the point-partitioned solve (inputs already
    laid out by `prep_point_sharded`; works with global arrays in
    multi-process meshes — the multi-host case — since all host prep is done)."""
    fn = _point_sharded_program(model, mesh, bf, iters, pcg_iters, dense_schur)
    return fn(jnp.asarray(params), prob_s)
