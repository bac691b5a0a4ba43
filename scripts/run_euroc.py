"""EuRoC sequence runner — this engine's `mono_euroc` / `mono_inertial_euroc`.

Mirrors the reference example mains (`/root/reference/Examples/Monocular/
mono_euroc.cc`, `Examples/Monocular-Inertial/mono_inertial_euroc.cc`):
load a sequence + (optionally) IMU, replay through the System, save the
trajectory, and report ATE against the EuRoC ground truth when present.

Usage:
  python scripts/run_euroc.py SETTINGS.yaml SEQ_DIR [--mode mono|mono-vi]
      [--timestamps FILE] [--out traj.txt] [--max-frames N]

SETTINGS.yaml accepts the reference's own YAML files unmodified.
"""

import argparse
import os
import sys
import time

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

os.environ.setdefault("TF_CPP_MIN_LOG_LEVEL", "3")
from orbslam3_jax.utils import enable_compile_cache

enable_compile_cache()

import numpy as np


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("settings")
    ap.add_argument("seq_dir")
    ap.add_argument("--mode", choices=["mono", "mono-vi"], default="mono")
    ap.add_argument("--timestamps", default=None)
    ap.add_argument("--out", default="trajectory_tum.txt")
    ap.add_argument("--kf-out", default="kf_trajectory_tum.txt")
    ap.add_argument("--max-frames", type=int, default=0)
    ap.add_argument("--kmax", type=int, default=512)
    ap.add_argument("--pmax", type=int, default=65536)
    ap.add_argument("--no-loop", action="store_true",
                    help="disable place recognition (reloc + loop closing)")
    ap.add_argument("--vocab", default=None,
                    help="vocabulary .npz; trained from the sequence and "
                         "cached here if missing")
    args = ap.parse_args()

    from orbslam3_jax import config as cfg
    from orbslam3_jax.io import datasets
    from orbslam3_jax.ops import imu as imu_ops
    from orbslam3_jax.system import System, Sensor
    from orbslam3_jax.eval.ate import ate_rmse

    settings = cfg.load_settings(args.settings)
    seq = datasets.load_euroc_images(args.seq_dir, args.timestamps)
    n = len(seq) if not args.max_frames else min(len(seq), args.max_frames)
    print(f"{n} frames @ {settings.camera.fps} Hz, camera {settings.camera.model}")

    imu_calib = None
    imu = None
    if args.mode == "mono-vi":
        assert settings.imu is not None, "settings lack IMU section"
        ic = settings.imu
        imu_calib = imu_ops.ImuCalib.create(
            Rbc=ic.Tbc[:3, :3], tbc=ic.Tbc[:3, 3],
            noise_gyro=ic.noise_gyro, noise_acc=ic.noise_acc,
            walk_gyro=ic.walk_gyro, walk_acc=ic.walk_acc, freq=ic.freq,
        )
        imu = datasets.load_euroc_imu(args.seq_dir)

    slam = System(
        Sensor.IMU_MONOCULAR if imu_calib is not None else Sensor.MONOCULAR,
        settings.camera.model, settings.camera.params,
        (settings.camera.width, settings.camera.height),
        orb_params=settings.orb, imu_calib=imu_calib,
        Kmax=args.kmax, Pmax=args.pmax,
    )

    if not args.no_loop:
        # Place recognition (reloc + loop closing), as the reference
        # always runs it (`System.cc:83-95`). The stock ORBvoc isn't
        # shipped with this repository, so train a DBoW2-style tree from the
        # sequence itself and cache it (`ops/bow.build_vocabulary`,
        # ref `TemplatedVocabulary::create`).
        from orbslam3_jax.ops import bow, features as feat_ops
        import jax.numpy as jnp

        voc = None
        if args.vocab and os.path.exists(args.vocab):
            voc = bow.load_npz(args.vocab)
            print(f"vocabulary: {voc.n_words} words (cached: {args.vocab})")
        if voc is None:
            t_voc = time.perf_counter()
            stride = max(1, n // 40)
            train = []
            for k in range(0, n, stride):
                f = feat_ops.extract(jnp.asarray(seq.read(k)), settings.orb)
                train.append(np.asarray(f.desc)[np.asarray(f.valid)])
            train = np.concatenate(train)
            voc = bow.build_vocabulary(train, k=10, depth=4, seed=0)
            print(f"vocabulary: trained {voc.n_words} words on "
                  f"{len(train)} descriptors in "
                  f"{time.perf_counter() - t_voc:.0f}s")
            if args.vocab:
                bow.save_npz(args.vocab, voc)
        slam.enable_place_recognition(voc)
        # Atlas multi-map recovery (always on in the reference,
        # `Tracking.cc:1239-1257`).
        slam.enable_multimap(voc)

    from orbslam3_jax.utils import timing
    if os.environ.get("PROFILE"):
        timing.enable()

    cursor = 0
    t0 = time.perf_counter()
    track_times = []
    for k in range(n):
        img = seq.read(k)
        ts = seq.timestamps[k]
        batch = []
        if imu is not None:
            while cursor < len(imu.timestamps) and imu.timestamps[cursor] <= ts:
                batch.append((imu.timestamps[cursor], imu.acc[cursor], imu.gyro[cursor]))
                cursor += 1
        tic = time.perf_counter()
        slam.track_monocular(img, ts, imu_measurements=batch or None)
        track_times.append(time.perf_counter() - tic)
        if k % 50 == 0:
            print(
                f"[{k}/{n}] state={slam.tracking_state.name} kfs={slam.n_keyframes} "
                f"mps={slam.n_map_points} med_track={np.median(track_times[-50:]) * 1e3:.1f}ms"
            )
            if os.environ.get("PROFILE"):
                timing.print_report()
                timing.reset()
    slam.shutdown()  # drain any in-flight background GBA (ref System.cc:474)
    wall = time.perf_counter() - t0
    print(f"done: {n} frames in {wall:.1f}s ({n / wall:.1f} fps incl. mapping)")

    slam.save_trajectory_tum(args.out)
    slam.save_keyframe_trajectory_tum(args.kf_out)
    print(f"trajectories -> {args.out}, {args.kf_out}")

    gt_path = os.path.join(args.seq_dir, "mav0", "state_groundtruth_estimate0", "data.csv")
    if os.path.exists(gt_path):
        gt_ts, gt_pos, _ = datasets.load_groundtruth_euroc(args.seq_dir)
        ts_est, pos_est = slam.get_trajectory()
        err = ate_rmse(ts_est, pos_est, gt_ts, gt_pos, with_scale=args.mode == "mono")
        print(f"ATE RMSE ({'Sim3' if args.mode == 'mono' else 'SE3'}): {err:.4f} m")


if __name__ == "__main__":
    main()
