"""Run the SLAM main path once on an NVIDIA GPU and check what comes out.

    python chip_smoke.py               # one card: every phase below
    python chip_smoke.py --four-cards  # four cards: the sharded path only

Phases, each printing its numbers on its own line:

  device   the card's name and power limit (nvidia-smi) and jax.devices();
           fails at once if JAX's default backend is not a GPU;
  kernel   the fused Hamming top-2 kernel (ops/pallas_match.py), compiled
           for the card, against the plain reference (XOR+popcount
           distances, the window and octave mask, `best_two`) at 16384 and
           65536 queries x 1000 keys and at ragged sizes: distances
           bit-exact, indices equal wherever the minimum is unique;
  ba       `optim.ba.solve_ba_jit` at the global-BA bucket (C=128,
           P=16384, 512 obs/KF) on the GPU against the same call on the
           CPU device of this process, dense-Schur and PCG paths;
  config1  EuRoC monocular through `System`, driven as
           scripts/run_sequence.py drives it: 752x480 at 20 Hz, ORB 1000
           features / 8 levels / scale 1.2, Kmax=512, Pmax=65536, place
           recognition with assets/ORBvoc_synth_100k.bin, async mapping;
           400 frames; gate: tracking never lost, Sim3 ATE <= 5 cm;
  config3  the same shapes monocular-inertial with 200 Hz IMU, 400
           frames; gate: IMU init, VIBA1 and VIBA2 ran, scale within 5 %.

`--four-cards` runs only System.enable_distributed()'s work on a 4-GPU
mesh: point-sharded global BA at run_sequence.py's capacity (512 KFs,
65536 points) against the one-card solve, and the sharded keyframe-
database query against the one-device query.

Frames and IMU samples are rendered in memory from a seed with
scripts/make_synth_euroc.py's own generator. The last line is
{"ok": true, "device": {...}}; a failed phase exits non-zero before it.
"""

import argparse
import json
import os
import sys
import time
from concurrent.futures import ThreadPoolExecutor

REPO = os.path.dirname(os.path.abspath(__file__))
sys.path.insert(0, REPO)
sys.path.insert(0, os.path.join(REPO, "scripts"))
os.environ.setdefault("TF_CPP_MIN_LOG_LEVEL", "3")

import numpy as np  # noqa: E402
import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from orbslam3_jax.utils import device, enable_compile_cache  # noqa: E402

# Sizes (module constants so a rehearsal can shrink them).
KERNEL_SHAPES = [(16384, 1000), (65536, 1000), (33333, 777), (5, 3)]
BA_SHAPE = (128, 16384, 512)  # cameras, points, observations per camera
BA_ITERS = 5
# BA parity tolerance: relative cost gap, and pose gap in m and rad. Both
# sides run the same f32 solve with full-precision Schur contractions, so
# only the order of reductions differs (first card run: 2e-7 relative cost,
# 3e-5 m). 1e-3 (1 mm, 1 mrad) stays far below the 5 cm ATE gate yet
# catches a solve that differs in substance, such as a reduced-precision
# contraction making the reduced system indefinite.
BA_TOL = 1e-3
FRAMES = 400
KMAX, PMAX = 512, 65536
ATE_GATE_M = 0.05
SCALE_GATE = 0.05
SHARD_SHAPE = (512, 65536, 512)
SHARD_ITERS = 3
KFDB_DB = 512

_FAILED = []


def say(phase, **kv):
    print(json.dumps({"phase": phase, **kv}), flush=True)


def check(phase, cond, what):
    if not cond:
        _FAILED.append(f"{phase}: {what}")
        say(phase, failed=what)


# --- compile-time accounting ------------------------------------------------
_compile_s = [0.0]


def _on_event(event, duration, **_):
    if event.startswith("/jax/core/compile/"):
        _compile_s[0] += duration


jax.monitoring.register_event_duration_secs_listener(_on_event)


def _timed(fn, *args, reps=20):
    """Median wall ms of fn(*args) after one warm-up call."""
    jax.block_until_ready(fn(*args))
    ts = []
    for _ in range(reps):
        t0 = time.perf_counter()
        jax.block_until_ready(fn(*args))
        ts.append((time.perf_counter() - t0) * 1e3)
    return float(np.median(ts))


# --- phase: kernel ------------------------------------------------------------
def _match_inputs(rng, n, m):
    from orbslam3_jax.ops import pallas_match as pm

    desc_q = jnp.asarray(rng.integers(0, 256, (n, 32), dtype=np.uint8))
    desc_k = jnp.asarray(rng.integers(0, 256, (m, 32), dtype=np.uint8))
    valid_k = jnp.asarray(rng.random(m) > 0.1)
    lo = rng.integers(0, 6, n)
    window = pm.MatchWindow(
        uv_q=jnp.asarray(rng.uniform(0, 752, (n, 2)) * [1, 480 / 752], jnp.float32),
        uv_k=jnp.asarray(rng.uniform(0, 752, (m, 2)) * [1, 480 / 752], jnp.float32),
        radius_q=jnp.asarray(rng.uniform(5, 60, n), jnp.float32),
        octave_k=jnp.asarray(rng.integers(0, 8, m), jnp.int32),
        octave_lo=jnp.asarray(lo, jnp.int32),
        octave_hi=jnp.asarray(lo + 2, jnp.int32),
    )
    return desc_q, desc_k, valid_k, window


@jax.jit
def _reference_top2(desc_q, desc_k, valid_k, window):
    from orbslam3_jax.ops import matching

    D = matching.hamming_matrix_xor(desc_q, desc_k)
    mask = matching.window_mask(window.uv_q, window.uv_k, window.radius_q,
                                window.octave_k, window.octave_lo,
                                window.octave_hi) & valid_k[None, :]
    D = jnp.where(mask, D, matching.INF)
    d1, d2, j = matching.best_two(D)
    n_min = jnp.sum(D == d1[:, None], axis=1)
    return d1, d2, j, n_min


def phase_kernel():
    from orbslam3_jax.ops import matching
    from orbslam3_jax.ops import pallas_match as pm

    rng = np.random.default_rng(0)
    for n, m in KERNEL_SHAPES:
        dq, dk, vk, w = _match_inputs(rng, n, m)
        t0 = time.perf_counter()
        d1r, d2r, jr, n_min = jax.block_until_ready(_reference_top2(dq, dk, vk, w))
        d1, d2, j = jax.block_until_ready(pm.hamming_top2(dq, dk, vk, w))
        unique = np.asarray(n_min) == 1
        same_d1 = bool(np.array_equal(np.asarray(d1), np.asarray(d1r)))
        same_d2 = bool(np.array_equal(np.asarray(d2), np.asarray(d2r)))
        j_ok = np.asarray(j)[unique] == np.asarray(jr)[unique]
        say("kernel", queries=n, keys=m, config=pm.CONFIG,
            best_bit_exact=same_d1, second_bit_exact=same_d2,
            unique_rows=int(unique.sum()),
            index_mismatch_unique=int((~j_ok).sum()),
            index_mismatch_ties=int(
                (np.asarray(j)[~unique] != np.asarray(jr)[~unique]).sum()),
            rows_with_candidates=int((np.asarray(d1r) < pm.INF).sum()))
        check("kernel", same_d1 and same_d2 and j_ok.all(),
              f"kernel differs from the reference at {n}x{m}")
        if n < 4096:
            continue
        # Time the projection search both ways, as the pipeline calls it.
        va = jnp.asarray(rng.random(n) > 0.2)
        args = (dq, w.uv_q, va, dk, w.uv_k, vk, w.radius_q)
        kw = dict(octave_kp=w.octave_k, octave_lo=w.octave_lo,
                  octave_hi=w.octave_hi, max_dist=100.0, ratio=0.8)
        ms = {}
        for fused in (False, True):
            matching.use_fused_projection(fused)
            fn = jax.jit(lambda *a: matching.search_by_projection(*a, **kw)
                         ).lower(*args).compile()
            ms["fused" if fused else "matrix"] = _timed(fn, *args)
        matching.use_fused_projection(None)
        say("kernel", queries=n, keys=m, search_ms=ms,
            seconds_incl_compile=round(time.perf_counter() - t0, 3))


# --- phase: BA parity -------------------------------------------------------
def _pose_gap(a, b):
    """Largest rotation (rad) and translation (m) gap over the cameras.
    The angle comes from the skew part of R_a^T R_b, which resolves small
    angles (arccos of the trace bottoms out near 5e-4 rad in float32)."""
    dR = np.einsum("cij,cik->cjk", np.asarray(a.cam_R, np.float64),
                   np.asarray(b.cam_R, np.float64))
    skew = 0.5 * np.stack([dR[:, 2, 1] - dR[:, 1, 2], dR[:, 0, 2] - dR[:, 2, 0],
                           dR[:, 1, 0] - dR[:, 0, 1]], axis=1)
    ang = np.arcsin(np.clip(np.linalg.norm(skew, axis=1), 0.0, 1.0))
    dt = np.linalg.norm(np.asarray(a.cam_t) - np.asarray(b.cam_t), axis=1)
    return float(ang.max()), float(dt.max())


def _compare(phase, res, ref, **extra):
    cost, cost_ref = float(res.cost), float(ref.cost)
    rel = abs(cost - cost_ref) / max(abs(cost_ref), 1e-30)
    dang, dt = _pose_gap(res, ref)
    finite = bool(np.isfinite(cost) and np.isfinite(np.asarray(res.cam_t)).all()
                  and np.isfinite(np.asarray(res.points)).all())
    say(phase, cost=cost, cost_ref=cost_ref, rel_cost_gap=rel,
        max_rot_gap_rad=dang, max_trans_gap_m=dt, tol=BA_TOL, **extra)
    check(phase, finite and rel <= BA_TOL and dang <= BA_TOL and dt <= BA_TOL,
          f"result differs from the reference beyond {BA_TOL} ({extra})")


def phase_ba():
    from bench import make_ba_problem
    from orbslam3_jax.ops import cameras as cam
    from orbslam3_jax.optim import ba

    C, P, opc = BA_SHAPE
    params, prob = make_ba_problem(np.random.default_rng(0), C, P, opc)
    cpu = jax.devices("cpu")[0]
    prob_cpu, params_cpu = jax.device_put((prob, params), cpu)
    for dense in (True, False):
        kw = dict(iters=BA_ITERS, pcg_iters=50, dense_schur=dense)
        t0 = time.perf_counter()
        res = jax.block_until_ready(
            ba.solve_ba_jit(cam.CameraModel.PINHOLE, params, prob, **kw))
        t_gpu = time.perf_counter() - t0
        ms = _timed(lambda: ba.solve_ba_jit(
            cam.CameraModel.PINHOLE, params, prob, **kw), reps=3)
        ref = jax.block_until_ready(
            ba.solve_ba_jit(cam.CameraModel.PINHOLE, params_cpu, prob_cpu, **kw))
        assert ref.cost.devices() == {cpu}
        _compare("ba", res, ref, path="dense_schur" if dense else "pcg",
                 cameras=C, points=P, obs_per_cam=opc, lm_iters=BA_ITERS,
                 gpu_solve_ms=ms, gpu_first_call_s=round(t_gpu, 3))


# --- phase: main path ---------------------------------------------------------
def render_sequence(n_frames, seed=0):
    """Frames (uint8-valued float32, as a dataset loader returns them),
    frame timestamps, IMU samples and ground truth, from the generator
    of scripts/make_synth_euroc.py."""
    import make_synth_euroc as gen

    rng = np.random.default_rng(seed)
    tex = gen.make_textures(rng)
    t0 = 1403636579.763555584
    times = np.arange(n_frames) / gen.CAM_HZ

    def frame(k):
        R_wc, p = gen.pose_at(times[k])
        img = gen.render(tex, R_wc, p)
        noise = np.random.default_rng([seed, k]).normal(0, 1.5, img.shape)
        return np.clip(img + noise, 0, 255).astype(np.uint8).astype(np.float32)

    with ThreadPoolExecutor(max_workers=min(16, os.cpu_count() or 1)) as ex:
        frames = list(ex.map(frame, range(n_frames)))
    gt_pos = np.stack([gen.pose_at(t)[1] for t in times])

    n_imu = int(round(times[-1] * gen.IMU_HZ)) + 1
    t_imu = np.arange(n_imu) / gen.IMU_HZ
    irng = np.random.default_rng([seed, 1 << 20])
    bias_g = np.array([0.002, -0.0015, 0.001])
    bias_a = np.array([0.02, 0.015, -0.01])
    gyro, acc = [], []
    for t in t_imu:
        g, a = gen.imu_sample(t)
        gyro.append(g + bias_g + irng.normal(0, 1.7e-4 * np.sqrt(gen.IMU_HZ), 3))
        acc.append(a + bias_a + irng.normal(0, 2.0e-3 * np.sqrt(gen.IMU_HZ), 3))
    imu = (t0 + t_imu, np.asarray(acc, np.float32), np.asarray(gyro, np.float32))
    intr = np.asarray([gen.FX, gen.FY, gen.CX, gen.CY, 0, 0, 0, 0], np.float32)
    return frames, t0 + times, imu, t0 + times, gt_pos, intr, (gen.W, gen.H)


def run_config(name, seq, inertial, voc):
    from orbslam3_jax.eval.ate import ate_rmse, ate_scale
    from orbslam3_jax.ops import cameras as cam
    from orbslam3_jax.ops import features as feat
    from orbslam3_jax.ops import imu as imu_ops
    from orbslam3_jax.pipeline.tracking import TrackState
    from orbslam3_jax.system import Sensor, System

    frames, ts, (t_imu, acc, gyro), gt_ts, gt_pos, intr, wh = seq
    orb = feat.OrbParams(n_features=1000, n_levels=8, scale_factor=1.2,
                         ini_th=20.0, min_th=7.0)
    imu_calib = None
    if inertial:
        imu_calib = imu_ops.ImuCalib.create(
            Rbc=np.eye(3), tbc=np.zeros(3), noise_gyro=1.7e-4,
            noise_acc=2.0e-3, walk_gyro=1.9e-5, walk_acc=3.0e-3, freq=200.0)
    slam = System(
        Sensor.IMU_MONOCULAR if inertial else Sensor.MONOCULAR,
        cam.CameraModel.PINHOLE, intr, wh, orb_params=orb,
        imu_calib=imu_calib, Kmax=KMAX, Pmax=PMAX, fps=20.0,
    )
    slam.enable_async_mapping()
    slam.enable_place_recognition(voc)
    slam.enable_multimap(voc)

    lost = 0
    started = False
    cursor = 0
    frame_s, frame_compile_s = [], []
    t_start = time.perf_counter()
    for k, img in enumerate(frames):
        c0 = _compile_s[0]
        t0 = time.perf_counter()
        if inertial:
            hi = int(np.searchsorted(t_imu, ts[k], side="right"))
            batch = [(t_imu[j], acc[j], gyro[j]) for j in range(cursor, hi)]
            cursor = hi
            slam.track_monocular(img, float(ts[k]), imu_measurements=batch or None)
        else:
            slam.track_monocular(img, float(ts[k]))
        frame_s.append(time.perf_counter() - t0)
        frame_compile_s.append(_compile_s[0] - c0)
        state = slam.tracking_state
        started |= state == TrackState.OK
        lost += started and state in (TrackState.LOST, TrackState.RECENTLY_LOST)
    slam.shutdown()
    wall = time.perf_counter() - t_start

    est_ts, est_pos = slam.get_trajectory()
    ate_sim3 = ate_rmse(est_ts, est_pos, gt_ts, gt_pos, with_scale=True)
    ate_se3 = ate_rmse(est_ts, est_pos, gt_ts, gt_pos, with_scale=False)
    scale = ate_scale(est_ts, est_pos, gt_ts, gt_pos)
    frame_s = np.asarray(frame_s)
    steady = np.asarray(frame_compile_s) == 0.0
    out = dict(
        frames=len(frames), tracked=len(est_ts), lost_frames=int(lost),
        keyframes=slam.n_keyframes, map_points=slam.n_map_points,
        ate_sim3_m=ate_sim3, ate_se3_m=ate_se3, scale=scale,
        wall_s=round(wall, 3), compile_s=round(sum(frame_compile_s), 3),
        steady_frames=int(steady.sum()),
        steady_fps=float(steady.sum() / frame_s[steady].sum()) if steady.any() else None,
        steady_frame_ms_p50=float(np.median(frame_s[steady]) * 1e3) if steady.any() else None,
        steady_frame_ms_p99=float(np.percentile(frame_s[steady], 99) * 1e3) if steady.any() else None,
        card=device.card_line(),
    )
    if inertial:
        ini = slam.mapper.imu_init
        out.update(imu_init=bool(slam.mapper.imu_initialized),
                   viba1=bool(ini.viba1_done), viba2=bool(ini.viba2_done))
    say(name, **out)
    return out


def phase_main_path():
    from orbslam3_jax.io import vocab_io

    t0 = time.perf_counter()
    seq = render_sequence(FRAMES)
    say("render", frames=FRAMES, seconds=round(time.perf_counter() - t0, 3))
    voc = vocab_io.load_binary_vocabulary(
        os.path.join(REPO, "assets", "ORBvoc_synth_100k.bin"))

    c1 = run_config("config1", seq, inertial=False, voc=voc)
    check("config1", c1["lost_frames"] == 0, "tracking was lost")
    check("config1", c1["ate_sim3_m"] <= ATE_GATE_M,
          f"Sim3 ATE {c1['ate_sim3_m']} m > {ATE_GATE_M} m")

    c3 = run_config("config3", seq, inertial=True, voc=voc)
    check("config3", c3["imu_init"] and c3["viba1"] and c3["viba2"],
          "IMU init, VIBA1 or VIBA2 did not run")
    check("config3", abs(c3["scale"] - 1.0) <= SCALE_GATE,
          f"scale {c3['scale']} off by more than {SCALE_GATE:.0%}")


# --- four cards: the sharded path ---------------------------------------------
def phase_four_cards():
    from bench import make_ba_problem
    from orbslam3_jax.ops import bow
    from orbslam3_jax.ops import cameras as cam
    from orbslam3_jax.io import vocab_io
    from orbslam3_jax.optim import ba
    from orbslam3_jax.parallel import ba_sharded, kfdb_sharded
    from orbslam3_jax.parallel.context import DistributedContext

    devs = jax.devices()
    check("four_cards", len(devs) >= 4, f"{len(devs)} devices, need 4")
    if len(devs) < 4:
        return
    mesh = ba_sharded.make_mesh(devs[:4], axis="pt")
    dist = DistributedContext(mesh)
    model = cam.CameraModel.PINHOLE

    C, P, opc = SHARD_SHAPE
    params, prob = make_ba_problem(np.random.default_rng(1), C, P, opc)
    say("four_cards", cameras=C, points=P, obs_per_cam=opc,
        auto_dense_schur=ba.auto_dense_schur(C, P))
    for dense in (True, False):
        kw = dict(iters=SHARD_ITERS, pcg_iters=50, dense_schur=dense)
        ref = jax.block_until_ready(ba.solve_ba_jit(model, params, prob, **kw))
        ms_one = _timed(lambda: ba.solve_ba_jit(model, params, prob, **kw), reps=3)
        if dense:
            # The live path: AsyncGBA / global_ba through the context.
            prob_s, pn = dist.prep_ba(prob)
            run = lambda: dist.run_ba(model, params, prob_s, iters=SHARD_ITERS,
                                      pcg_iters=50)
            res = jax.block_until_ready(run())
            spread = len(res.points.sharding.device_set)
            res = res._replace(points=res.points[:pn])
        else:
            run = lambda: ba_sharded.solve_ba_point_sharded(
                model, params, prob, mesh, **kw)
            res = jax.block_until_ready(run())
            spread = None
        ms_four = _timed(run, reps=3)
        _compare("four_cards", res, ref, path="dense_schur" if dense else "pcg",
                 one_card_ms=ms_one, four_card_ms=ms_four,
                 point_shards_on_devices=spread)
        if spread is not None:
            check("four_cards", spread == 4, f"points on {spread} devices")

    # Sharded keyframe-database query vs the one-device query.
    voc = vocab_io.load_binary_vocabulary(
        os.path.join(REPO, "assets", "ORBvoc_synth_100k.bin"))
    rng = np.random.default_rng(2)
    base = rng.integers(0, 256, (64, 1000, 32), dtype=np.uint8)
    desc = base[rng.integers(0, 64, KFDB_DB)]
    flip = rng.random(desc.shape) < 0.05
    desc = np.where(flip, rng.integers(0, 256, desc.shape, dtype=np.uint8), desc)
    feat_valid = jnp.ones(1000, bool)
    to_vec = jax.jit(lambda d: bow.bow_vector(voc, bow.transform(voc, d, feat_valid)))
    to_words = jax.jit(lambda d: bow.transform(voc, d, feat_valid))
    db = jnp.stack([to_vec(jnp.asarray(d)) for d in desc])
    valid = jnp.asarray(rng.random(KFDB_DB) > 0.05)
    one = kfdb_sharded.make_mesh(devs[:1])
    mismatches = 0
    for qi in range(8):
        q = jnp.asarray(desc[qi])
        qv, qw = to_vec(q), to_words(q)
        ids4, s4 = dist.kfdb_query(qv, qw, db, valid, n_best=5)
        ids1, s1 = kfdb_sharded.sharded_query(qv, qw, db, valid, one, n_best=5)
        same = (np.array_equal(np.asarray(ids4), np.asarray(ids1))
                and np.allclose(np.asarray(s4), np.asarray(s1), rtol=1e-6))
        mismatches += not same
    say("four_cards", kfdb_keyframes=KFDB_DB, words=int(voc.n_words),
        queries=8, mismatches=mismatches)
    check("four_cards", mismatches == 0, "sharded KFDB query differs")
    # Device 0 also ran the one-card reference; each other card must have
    # held its own shard of the solve (the local Schur coupling block alone
    # is 600 MB at 512 KFs x 16384 points per shard).
    peak = [int((d.memory_stats() or {}).get("peak_bytes_in_use", 0))
            for d in devs[:4]]
    say("four_cards", peak_bytes_per_device=peak)
    check("four_cards", min(peak[1:]) >= 100 << 20,
          "a card held no shard of the solve")


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--four-cards", action="store_true",
                    help="run only the sharded path on a 4-GPU mesh")
    args = ap.parse_args(argv)

    device.require_gpu()
    print(device.card_line(), flush=True)
    say("device", devices=[str(d) for d in jax.devices()])
    cache = enable_compile_cache()
    say("device", compile_cache=cache)

    t0 = time.perf_counter()
    if args.four_cards:
        phase_four_cards()
    else:
        phase_kernel()
        phase_ba()
        phase_main_path()
    say("done", seconds=round(time.perf_counter() - t0, 3),
        compile_s=round(_compile_s[0], 3), failed=_FAILED)
    if _FAILED:
        sys.exit(1)
    print(json.dumps({"ok": True, "device": device.device_info()}), flush=True)


if __name__ == "__main__":
    main()
