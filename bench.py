"""Benchmark: tracked frames/s per GPU on the FULL per-frame hot path,
plus BA ms/iter (local + global buckets).

Prints the card's name and power limit, then ONE JSON line:
{"metric", "value", "unit", "vs_baseline", "device", "extras"}. Exits
non-zero without a GPU.

Baseline provenance (see BASELINE.md "Reference-build attempt"): the
reference cannot be built on this host (CMake requires OpenCV 3, host has
4.6; Eigen3/Pangolin/Boost absent; package installs prohibited). Fallback
is the ORB-SLAM3 paper's measured i7 tracking-thread times on EuRoC
(arXiv:2007.11898 §VII): ≈21-29 ms/frame monocular → **33 fps** CPU
baseline — not the 20 Hz real-time floor.
"""

import json
import os
import sys
import time

sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))

import numpy as np
os.environ.setdefault("TF_CPP_MIN_LOG_LEVEL", "3")
import jax
import jax.numpy as jnp

from orbslam3_jax.utils import enable_compile_cache
from orbslam3_jax.utils import device

enable_compile_cache()

BASELINE_FPS = 33.0  # paper-measured i7 mono tracking (~30 ms/frame)


def bench_tracking():
    """Times the per-frame hot path EXACTLY as the Tracker dispatches it:
    extraction, last-frame projection match, pose solve #1, local-map
    match (16k-point map, 8k-point local window), pose solve #2 — five
    jitted calls per frame (the production pipeline keeps extraction as
    its own dispatch: XLA fuses the descriptor gathers into downstream
    consumers when everything is one program, recomputing extraction per
    consumer tile)."""
    from __graft_entry__ import entry, staged_pipeline

    _, args = entry()
    run = staged_pipeline()
    jax.block_until_ready(run(*args))  # compile all stages

    n_iters = 50
    t0 = time.perf_counter()
    for _ in range(n_iters):
        out = run(*args)
    jax.block_until_ready(out)
    dt = time.perf_counter() - t0
    return n_iters / dt


def bench_amortized(kf_every: int = 14):
    """MEASURED keyframe-inserting replay on the device (replaces the
    round-3 analytic `frame_ms + 5*LBA_ms/KF_EVERY` model): every frame
    dispatches the full tracking hot path, and every `kf_every`-th frame
    additionally dispatches one complete local-mapping pass at production
    shape (triangulate-batch + neighborhood fuse + 24/48 dense-Schur LBA,
    `__graft_entry__.mapping_pass`). All dispatches are async, one fetch at
    the end — on a single chip the device work serializes, so this is the
    honest single-chip amortized throughput with mapping in the loop
    (`kf_every`=14 is the keyframe cadence of the 1600-frame config-1
    replay: 115 KFs / 1600 frames)."""
    from __graft_entry__ import entry, staged_pipeline, mapping_pass

    _, args = entry()
    run = staged_pipeline()
    mrun, margs = mapping_pass()
    jax.block_until_ready((run(*args), mrun(*margs)))  # compile

    n = 4 * kf_every
    t0 = time.perf_counter()
    for i in range(n):
        out = run(*args)
        if i % kf_every == kf_every - 1:
            mout = mrun(*margs)
    jax.block_until_ready((out, mout))
    dt = time.perf_counter() - t0
    return n / dt


def make_ba_problem(rng, C, P, obs_per_cam, n_fixed=2, fixed_last=False):
    """(params, BAProblem): C cameras along a line observing P points,
    obs_per_cam observations each at 0.5 px noise, poses and points
    perturbed from the truth; the first (or last) n_fixed cameras fixed."""
    from orbslam3_jax.ops import cameras as cam
    from orbslam3_jax.optim import ba as ba_mod

    params = cam.make_pinhole(458.654, 457.296, 376.0, 240.0)
    pts = np.stack(
        [rng.uniform(-4, 4, P), rng.uniform(-3, 3, P), rng.uniform(4, 12, P)], -1
    ).astype(np.float32)
    cam_R = np.tile(np.eye(3, dtype=np.float32), (C, 1, 1))
    cam_t = np.zeros((C, 3), np.float32)
    cam_t[:, 0] = np.linspace(0, 1.5, C)
    obs_cam = np.repeat(np.arange(C, dtype=np.int32), obs_per_cam)
    obs_pt = np.concatenate(
        [rng.choice(P, obs_per_cam, replace=False) for _ in range(C)]
    ).astype(np.int32)
    Xc = pts[obs_pt] + cam_t[obs_cam]
    uv = np.asarray(cam.pinhole_project(params, jnp.asarray(Xc)))
    uv = uv + rng.normal(0, 0.5, uv.shape).astype(np.float32)
    O = len(obs_cam)
    fixed = (np.arange(C) >= C - n_fixed) if fixed_last else (np.arange(C) < n_fixed)
    prob = ba_mod.BAProblem(
        cam_R=jnp.asarray(cam_R),
        cam_t=jnp.asarray(cam_t + rng.normal(0, 0.01, cam_t.shape).astype(np.float32)),
        cam_fixed=jnp.asarray(fixed),
        points=jnp.asarray(pts + rng.normal(0, 0.02, pts.shape).astype(np.float32)),
        point_valid=jnp.ones(P, bool),
        obs_cam=jnp.asarray(obs_cam), obs_point=jnp.asarray(obs_pt),
        obs_uv=jnp.asarray(uv.astype(np.float32)),
        obs_ur=jnp.full(O, -1.0), obs_sigma2=jnp.ones(O),
        obs_valid=jnp.ones(O, bool),
    )
    return params, prob


def bench_ba(C, P, obs_per_cam, iters=10, pcg_iters=50, dense_schur=False,
             n_fixed=2, fixed_last=False, n_opt_prefix=None,
             camera_major=False):
    """ms per LM iteration, setup excluded: time iters and 2*iters solves
    and take the marginal cost."""
    from orbslam3_jax.ops import cameras as cam
    from orbslam3_jax.optim import ba as ba_mod

    rng = np.random.default_rng(0)
    params, prob = make_ba_problem(rng, C, P, obs_per_cam, n_fixed=n_fixed,
                            fixed_last=fixed_last)

    def run(n):
        res = ba_mod.solve_ba_jit(
            cam.CameraModel.PINHOLE, params, prob, iters=n, pcg_iters=pcg_iters,
            dense_schur=dense_schur, n_opt_prefix=n_opt_prefix,
            obs_per_cam=obs_per_cam if camera_major else None,
        )
        jax.block_until_ready(res.cam_R)

    run(iters)       # compile n=iters
    run(2 * iters)   # compile n=2*iters
    reps = 3
    t1 = min(
        (lambda s: (run(iters), time.perf_counter() - s)[1])(time.perf_counter())
        for _ in range(reps)
    )
    t2 = min(
        (lambda s: (run(2 * iters), time.perf_counter() - s)[1])(time.perf_counter())
        for _ in range(reps)
    )
    return max(t2 - t1, 1e-9) / iters * 1e3


def main():
    device.require_gpu()
    print(device.card_line(), flush=True)
    fps = bench_tracking()

    # Local-BA buckets: the round-3 24/48 window (for cross-round
    # comparability) and the current production 48/128 caps
    # (`local_mapping.lba_caps` — the reference-faithful all-covisibles/
    # maxFixKF setting at the KF counts at-scale replays reach). Point
    # axis compacted to <=8192; dense explicit-Schur path.
    ba_local_ms = bench_ba(C=72, P=8192, obs_per_cam=512, iters=5,
                           dense_schur=True, n_fixed=48)
    ba_local_ms_48_128 = bench_ba(C=176, P=8192, obs_per_cam=512, iters=5,
                                  dense_schur=True, n_fixed=128)
    # PRODUCTION bucket: exactly what `local_mapping._local_ba` dispatches
    # at-scale (48-KF window prefix + 32-KF fixed bucket, 768 obs/cam
    # after compaction, window-restricted reduced system, camera-major
    # Hcc) — the shape the amortized replay pays every keyframe.
    ba_local_ms_prod = bench_ba(C=80, P=8192, obs_per_cam=768, iters=5,
                                dense_schur=True, n_fixed=32,
                                fixed_last=True, n_opt_prefix=48,
                                camera_major=True)
    # Global bucket mirrors the production GBA dispatch (pipeline/gba.py):
    # dense explicit-Schur up to the auto_dense_schur memory cutoff
    # (128 KF x 16k points is inside it; full-capacity Atlas GBA beyond
    # the cutoff stays matrix-free PCG).
    from orbslam3_jax.optim import ba as _ba
    gba_dense = _ba.auto_dense_schur(128, 16384)
    ba_global_ms = bench_ba(C=128, P=16384, obs_per_cam=512, iters=5,
                            dense_schur=gba_dense)

    # Amortized whole-pipeline throughput, MEASURED: a keyframe-inserting
    # device replay (tracking every frame + a full mapping pass every 14th,
    # async dispatches, one fetch). The async mapping executor
    # (pipeline/async_mapping.py, default-on in run_sequence.py) hides the
    # host-side share; on one chip the device work still serializes, which
    # is exactly what this loop measures.
    fps_amortized = bench_amortized()

    print(
        json.dumps(
            {
                "metric": "tracked_frames_per_s_per_chip",
                "value": round(fps, 2),
                "unit": "frames/s",
                "vs_baseline": round(fps / BASELINE_FPS, 3),
                "device": device.device_info(),
                "extras": {
                    "baseline_fps": BASELINE_FPS,
                    "baseline_provenance": "ORB-SLAM3 paper i7 mono EuRoC ~30ms/frame; reference unbuildable here (BASELINE.md)",
                    "fps_amortized_with_mapping": round(fps_amortized, 2),
                    "fps_amortized_provenance": "measured KF-inserting device replay (mapping pass every 14th frame at production LBA shapes), not a formula",
                    "ba_local_ms_per_iter_24kf_48fix_8kpt": round(ba_local_ms, 2),
                    "ba_local_ms_per_iter_48kf_128fix_8kpt": round(ba_local_ms_48_128, 2),
                    "ba_local_ms_per_iter_prod_48win_32fix": round(ba_local_ms_prod, 2),
                    "ba_global_ms_per_iter_128kf_16kpt": round(ba_global_ms, 2),
                    # Which solver the global bucket actually timed — the
                    # auto dispatch flipped PCG->dense-Schur in round 3,
                    # making cross-round "ba_global" comparisons ambiguous
                    # without this (round-3 advisor finding).
                    "ba_global_path": "dense_schur" if gba_dense else "pcg",
                },
            }
        )
    )


if __name__ == "__main__":
    main()
