"""BASELINE config 5 END-TO-END: multi-sequence Atlas with map merging +
global BA ACROSS 2 HOSTS, executed from the live pipeline (not a sidecar).

Two OS processes (the multi-host analog: gloo over localhost, each pinned to its
own 2 cores) replay the SAME multi-map scenario as `drive_multimap.py`
(scripts/multimap_replay.py) as SPMD replicas, with
`System.enable_distributed()` — so when tracking loses, stores the map,
re-initializes and place recognition merges the maps, the post-merge
global BA (`LoopClosing.cc:1967` semantics) runs the point-partitioned
block-Schur solve over the 2-process mesh, and the Atlas merge-candidate
scoring runs the sharded KFDB query. The parent also runs the identical
replay single-device and asserts the distributed run's trajectory matches
to numerical tolerance.

Usage: python scripts/drive_multimap_distributed.py          # parent
       python scripts/drive_multimap_distributed.py --proc I # child
"""

import argparse
import json
import os
import re
import subprocess
import sys
import time

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, REPO)
sys.path.insert(0, os.path.join(REPO, "scripts"))

PORT = 29887
NPROC = 2


def run_replay(nprocs: int, proc_id: int):
    """The shared scenario; distributed iff nprocs > 1."""
    import jax

    jax.config.update("jax_platforms", "cpu")
    if nprocs > 1:
        jax.distributed.initialize(
            coordinator_address=f"localhost:{PORT}",
            num_processes=nprocs, process_id=proc_id,
        )
        assert len(jax.devices()) == nprocs
    from orbslam3_jax.utils import enable_compile_cache

    enable_compile_cache()
    import numpy as np
    from orbslam3_jax.eval.ate import ate_rmse
    from multimap_replay import Scene, make_system, replay

    scene = Scene()
    slam = make_system(scene, distributed=nprocs > 1)
    t0 = time.perf_counter()
    gt_ts, gt_pos, merge_frames = replay(scene, slam, verbose=False)
    wall = time.perf_counter() - t0

    assert slam.multimap.n_merges >= 1, "maps never merged"
    assert slam.multimap.atlas.n_maps == 1

    ts_est, pos_est = slam.get_trajectory()
    err = ate_rmse(ts_est, pos_est, gt_ts, gt_pos, with_scale=True, max_dt=0.01)
    if proc_id == 0:
        print(json.dumps({
            "mode": "dist" if nprocs > 1 else "single",
            "nprocs": nprocs,
            "n_merges": slam.multimap.n_merges,
            "merge_frames": merge_frames,
            "ate_m": round(float(err), 5),
            "n_kf": slam.n_keyframes,
            "wall_s": round(wall, 1),
        }), flush=True)
    if nprocs > 1:
        jax.distributed.shutdown()


def _spawn(nprocs: int):
    env = dict(os.environ)
    env["JAX_PLATFORMS"] = "cpu"
    env["XLA_FLAGS"] = "--xla_force_host_platform_device_count=1"
    env.setdefault("TF_CPP_MIN_LOG_LEVEL", "3")
    procs = []
    for i in range(nprocs):
        argv = ["taskset", "-c", f"{2 * i},{2 * i + 1}",
                sys.executable, os.path.abspath(__file__),
                "--proc", str(i), "--nprocs", str(nprocs)]
        procs.append(subprocess.Popen(
            argv, env=env, stdout=subprocess.PIPE,
            stderr=subprocess.STDOUT, text=True,
        ))
    outs = [p.communicate(timeout=3000)[0] for p in procs]
    rcs = [p.returncode for p in procs]
    return rcs, outs


def _result(out: str):
    for line in reversed(out.strip().splitlines()):
        if line.startswith("{"):
            return json.loads(line)
    return None


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--proc", type=int, default=-1)
    ap.add_argument("--nprocs", type=int, default=NPROC)
    args = ap.parse_args()
    if args.proc >= 0:
        run_replay(args.nprocs, args.proc)
        return

    print("== single-device reference replay (pinned, 2 cores) ==", flush=True)
    rcs1, outs1 = _spawn(1)
    assert rcs1[0] == 0, outs1[0][-3000:]
    ref = _result(outs1[0])
    print(ref, flush=True)

    print(f"== {NPROC}-process distributed replay (gloo, pinned) ==", flush=True)
    rcs2, outs2 = _spawn(NPROC)
    assert all(rc == 0 for rc in rcs2), outs2[0][-3000:] + outs2[-1][-3000:]
    dist = _result(outs2[0])
    print(dist, flush=True)

    # The GBA operator itself is exact vs single-device up to summation
    # order (unit-proven: tests/test_dist_pipeline.py, test_parallel.py,
    # drive_distributed_ba.py). End-to-end, that last-ulp noise feeds
    # THRESHOLDED decisions (keyframe need, match gates), so the two
    # replays may legitimately differ in keyframe count downstream of the
    # merge — the invariants are the STRUCTURE (same merges) and the map
    # QUALITY (post-merge ATE equal to numerical tolerance), which is how
    # BASELINE config 5 is scored.
    assert ref["n_merges"] == dist["n_merges"] >= 1
    date = abs(ref["ate_m"] - dist["ate_m"])
    print(f"|ATE(single) - ATE(dist)| = {date:.2e} m", flush=True)
    assert date < 5e-3, (ref["ate_m"], dist["ate_m"])
    print(json.dumps({
        "config5_ate_m": dist["ate_m"],
        "config5_ate_single_m": ref["ate_m"],
        "n_merges": dist["n_merges"],
        "merge_frames": dist["merge_frames"],
        "ate_delta_vs_single_m": round(date, 6),
        "wall_s": {"single": ref["wall_s"], "dist2": dist["wall_s"]},
    }))
    print("DRIVE OK")


if __name__ == "__main__":
    main()
