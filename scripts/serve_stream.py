"""Live-ingest SLAM server — the analog of the reference's
ROS nodes (`Examples/ROS/ORB_SLAM3/src/ros_mono{,_inertial}.cc`): a
producer streams frames (+IMU) over a UNIX socket; this process owns the
System and streams tracked poses back (protocol: `orbslam3_jax/io/
stream.py`).

Server:  python scripts/serve_stream.py SETTINGS.yaml --socket /tmp/slam.sock
         [--mode mono|mono-vi] [--vocab voc.npz]
Client:  python scripts/serve_stream.py SETTINGS.yaml --socket /tmp/slam.sock \
         --client SEQ_DIR [--dataset euroc] [--max-frames N]
         (replays a dataset through the socket and prints received poses —
          the bag-replay stand-in for a camera driver)
"""

import argparse
import os
import socket
import sys

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

os.environ.setdefault("TF_CPP_MIN_LOG_LEVEL", "3")
from orbslam3_jax.utils import enable_compile_cache

enable_compile_cache()

import numpy as np


def run_server(args):
    from orbslam3_jax import config as cfg
    from orbslam3_jax.io import stream
    from orbslam3_jax.ops import imu as imu_ops
    from orbslam3_jax.system import System, Sensor

    settings = cfg.load_settings(args.settings)
    imu_calib = None
    sensor = Sensor.MONOCULAR
    if args.mode == "mono-vi":
        sensor = Sensor.IMU_MONOCULAR
        imu_calib = imu_ops.ImuCalib(
            Rbc=settings.imu.Rbc, tbc=settings.imu.tbc,
            noise_gyro=settings.imu.noise_gyro, noise_acc=settings.imu.noise_acc,
            walk_gyro=settings.imu.walk_gyro, walk_acc=settings.imu.walk_acc,
            freq=settings.imu.freq,
        )
    slam = System(
        sensor, settings.camera.model, settings.camera.params,
        (settings.camera.width, settings.camera.height),
        orb_params=settings.orb, imu_calib=imu_calib,
        Kmax=args.kmax, Pmax=args.pmax, fps=settings.camera.fps,
    )
    slam.enable_async_mapping()
    if args.vocab and os.path.exists(args.vocab):
        from orbslam3_jax.ops import bow

        slam.enable_place_recognition(bow.load_npz(args.vocab))

    try:
        os.unlink(args.socket)
    except OSError:
        pass
    srv = socket.socket(socket.AF_UNIX, socket.SOCK_STREAM)
    srv.bind(args.socket)
    srv.listen(1)
    print(f"listening on {args.socket}", flush=True)
    conn, _ = srv.accept()
    n = stream.serve(slam, conn)
    slam.shutdown()
    print(f"served {n} frames; kfs={slam.n_keyframes} mps={slam.n_map_points}",
          flush=True)
    if args.out:
        slam.save_trajectory_tum(args.out)
    conn.close()
    srv.close()


def run_client(args):
    from orbslam3_jax.io import datasets, stream

    sock = socket.socket(socket.AF_UNIX, socket.SOCK_STREAM)
    sock.connect(args.socket)
    seq = datasets.load_euroc_images(args.client)
    imu = datasets.load_euroc_imu(args.client) if args.mode == "mono-vi" else None
    total = len(seq.timestamps)
    if args.max_frames:
        total = min(total, args.max_frames)
    cursor = 0
    for k in range(total):
        ts = float(seq.timestamps[k])
        if imu is not None:
            hi = int(np.searchsorted(imu.timestamps, ts, side="right"))
            for j in range(cursor, hi):
                stream.send_imu(sock, float(imu.timestamps[j]), imu.acc[j],
                                imu.gyro[j])
            cursor = hi
        stream.send_frame(sock, ts, seq.read(k).astype(np.uint8))
        msg = stream.recv_message(sock)
        assert msg and msg[0] == stream.MSG_POSE
        t, state, Rwc, twc = stream.parse_pose(msg[1])
        if (k + 1) % 20 == 0:
            print(f"[{k + 1}] state={state} twc={np.round(twc, 3)}", flush=True)
    stream.send_bye(sock)
    sock.close()
    print(f"streamed {total} frames", flush=True)


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("settings")
    ap.add_argument("--socket", default="/tmp/orbslam3_jax.sock")
    ap.add_argument("--mode", choices=["mono", "mono-vi"], default="mono")
    ap.add_argument("--vocab", default=None)
    ap.add_argument("--client", default=None, help="SEQ_DIR: act as producer")
    ap.add_argument("--max-frames", type=int, default=0)
    ap.add_argument("--kmax", type=int, default=256)
    ap.add_argument("--pmax", type=int, default=16384)
    ap.add_argument("--out", default=None)
    args = ap.parse_args()
    if args.client:
        run_client(args)
    else:
        run_server(args)


if __name__ == "__main__":
    main()
