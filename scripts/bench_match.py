"""Time the fused Hamming top-2 kernel against XLA's plain projection
search on the GPU, alone and inside the per-frame tracking program.

    python scripts/bench_match.py [--sweep] [--frames 50]

1. `search_by_projection` at 1000 to 65536 queries x 1000 keys (the
   last-frame, fuse and local-map sizes): the matrix path (window mask + Hamming
   matrix + `top_k`) and the fused kernel in its production setting.
   `--sweep` also times the kernel at other block settings.
2. `tracking._track_step` per frame (extraction + the fused two-stage
   track, `__graft_entry__.staged_pipeline`) at Kmax=512, Pmax=65536 with
   the kernel off and on, in the order off, on, on, off.

Prints the card's name and power limit, then one JSON line per
measurement. Exits non-zero without a GPU.
"""

import argparse
import json
import os
import sys
import time

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, REPO)
os.environ.setdefault("TF_CPP_MIN_LOG_LEVEL", "3")

import numpy as np  # noqa: E402
import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from orbslam3_jax.ops import matching  # noqa: E402
from orbslam3_jax.ops import pallas_match as pm  # noqa: E402
from orbslam3_jax.utils import device, enable_compile_cache  # noqa: E402


# (block_q, block_k, num_warps, num_stages) settings timed by --sweep
SWEEP = [
    (16, 128, 4, 2), (16, 256, 8, 2), (32, 64, 4, 2), (32, 128, 8, 2),
    (32, 128, 8, 1), (32, 256, 8, 2), (64, 64, 8, 2), (64, 128, 4, 2),
    (64, 128, 16, 2), (128, 64, 8, 2),
]


def _ms(fn, *args, reps=30):
    jax.block_until_ready(fn(*args))
    ts = []
    for _ in range(reps):
        t0 = time.perf_counter()
        jax.block_until_ready(fn(*args))
        ts.append((time.perf_counter() - t0) * 1e3)
    return float(np.median(ts)), float(np.min(ts))


def _problem(rng, n, m):
    lo = rng.integers(0, 6, n)
    return dict(
        desc_query=jnp.asarray(rng.integers(0, 256, (n, 32), dtype=np.uint8)),
        uv_query=jnp.asarray(rng.uniform(0, 1, (n, 2)) * [752, 480], jnp.float32),
        valid_query=jnp.asarray(rng.random(n) > 0.2),
        desc_kp=jnp.asarray(rng.integers(0, 256, (m, 32), dtype=np.uint8)),
        uv_kp=jnp.asarray(rng.uniform(0, 1, (m, 2)) * [752, 480], jnp.float32),
        valid_kp=jnp.asarray(rng.random(m) > 0.1),
        radius=jnp.asarray(rng.uniform(5, 60, n), jnp.float32),
        octave_kp=jnp.asarray(rng.integers(0, 8, m), jnp.int32),
        octave_lo=jnp.asarray(lo, jnp.int32),
        octave_hi=jnp.asarray(lo + 2, jnp.int32),
    )


def bench_search(sweep: bool):
    rng = np.random.default_rng(0)
    for n, m in ((1000, 1000), (4096, 1000), (16384, 1000), (65536, 1000)):
        p = _problem(rng, n, m)
        out = {"queries": n, "keys": m}
        for fused in (False, True):
            matching.use_fused_projection(fused)
            f = jax.jit(lambda q: matching.search_by_projection(**q)
                        ).lower(p).compile()
            out["fused_ms" if fused else "matrix_ms"] = _ms(f, p)
        matching.use_fused_projection(None)
        print(json.dumps(out), flush=True)
        if not sweep or n != 65536:
            continue
        w = pm.search_window(n, m, p["uv_query"], p["uv_kp"], p["radius"],
                             p["octave_kp"], p["octave_lo"], p["octave_hi"])
        for bq, bk, warps, stages in SWEEP:
            kw = dict(block_q=bq, block_k=bk, num_warps=warps,
                      num_stages=stages)
            f = jax.jit(lambda d, k, v, w_, kw=kw:
                        pm.hamming_top2(d, k, v, w_, **kw))
            try:
                t = _ms(f, p["desc_query"], p["desc_kp"], p["valid_kp"], w)
            except jax.errors.JaxRuntimeError as e:  # e.g. shared memory
                t = f"refused: {str(e)[:120]}"
            print(json.dumps({"queries": n, "keys": m, **kw, "kernel_ms": t}),
                  flush=True)


# Kernel settings tried inside the tracking program (None: matrix path).
TRACK_VARIANTS = [None, dict(pm.CONFIG)]


def bench_track_step(frames: int):
    """Per-frame time of the production tracking program with the kernel
    off and on, in the order off, on, on, off. The switch is read
    when a program is traced, so each variant starts from cleared caches
    (the persistent compile cache makes the repeats cheap)."""
    from __graft_entry__ import entry, staged_pipeline

    default = dict(pm.CONFIG)
    for nf in (1000, 1024):
        _, args = entry(Kmax=512, Pmax=65536, n_features=nf)
        for cfg in TRACK_VARIANTS + TRACK_VARIANTS[::-1]:
            matching.use_fused_projection(cfg is not None)
            pm.CONFIG.update(cfg or default)
            jax.clear_caches()
            run = staged_pipeline(n_features=nf)
            t0 = time.perf_counter()
            jax.block_until_ready(run(*args))
            first_s = time.perf_counter() - t0
            ts = []
            for _ in range(frames):
                t0 = time.perf_counter()
                jax.block_until_ready(run(*args))
                ts.append((time.perf_counter() - t0) * 1e3)
            print(json.dumps({
                "track_step": "matrix" if cfg is None else cfg,
                "Kmax": 512, "Pmax": 65536, "n_features": nf,
                "frames": frames,
                "frame_ms_median": float(np.median(ts)),
                "frame_ms_min": float(np.min(ts)),
                "first_call_s": round(first_s, 3),
            }), flush=True)
    pm.CONFIG.update(default)
    matching.use_fused_projection(None)


def main():
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--sweep", action="store_true")
    ap.add_argument("--frames", type=int, default=50)
    args = ap.parse_args()
    device.require_gpu()
    print(device.card_line(), flush=True)
    enable_compile_cache()
    bench_search(args.sweep)
    bench_track_step(args.frames)


if __name__ == "__main__":
    main()
