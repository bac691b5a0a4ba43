"""scripts/run_sequence.py executes end-to-end on KITTI and TUM-RGB-D
layouts (the reference's `mono_kitti.cc` / `rgbd_tum.cc` mains): tiny
rendered sequences written in each dataset's on-disk format, replayed
through the runner as a subprocess."""

import os
import subprocess
import sys

import numpy as np
import jax.numpy as jnp
import pytest

from orbslam3_jax.ops import cameras as cam

from test_e2e_mono import H, W, FOCAL, make_world, render, camera_path

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
RUNNER = os.path.join(REPO, "scripts", "run_sequence.py")

SETTINGS = f"""%YAML:1.0
Camera.type: "PinHole"
Camera.fx: {FOCAL}
Camera.fy: {FOCAL}
Camera.cx: {W / 2}
Camera.cy: {H / 2}
Camera.width: {W}
Camera.height: {H}
Camera.fps: 10.0
Camera.bf: 13.0
DepthMapFactor: 5000.0
ORBextractor.nFeatures: 400
ORBextractor.scaleFactor: 1.2
ORBextractor.nLevels: 3
ORBextractor.iniThFAST: 20
ORBextractor.minThFAST: 7
"""


def _frames(rng, n=10):
    params = cam.make_pinhole(FOCAL, FOCAL, W / 2, H / 2)
    pts, shades = make_world(rng)
    poses = camera_path(n)
    return params, pts, shades, poses


def _run(args, timeout=900):
    env = dict(os.environ)
    env["JAX_PLATFORMS"] = "cpu"
    out = subprocess.run(
        [sys.executable, RUNNER] + args,
        capture_output=True, text=True, timeout=timeout, env=env, cwd=REPO,
    )
    assert out.returncode == 0, out.stdout[-3000:] + out.stderr[-3000:]
    return out.stdout


@pytest.mark.slow
def test_kitti_runner(rng, tmp_path):
    import cv2

    params, pts, shades, poses = _frames(rng)
    seq = tmp_path / "kitti_seq"
    (seq / "image_0").mkdir(parents=True)
    with open(seq / "times.txt", "w") as f:
        for k, (R, t) in enumerate(poses):
            cv2.imwrite(
                str(seq / "image_0" / f"{k:06d}.png"),
                render(params, R, t, pts, shades).astype(np.uint8),
            )
            f.write(f"{k * 0.1:.6f}\n")
    st = tmp_path / "settings.yaml"
    st.write_text(SETTINGS)
    out = _run([
        str(st), str(seq), "--dataset", "kitti", "--mode", "mono",
        "--no-loop", "--kmax", "32", "--pmax", "4096",
        "--traj-format", "kitti", "--out", str(tmp_path / "traj.txt"),
        "--kf-out", str(tmp_path / "kf.txt"),
    ])
    assert f"[{len(poses) - 1}/{len(poses)}] state=OK" in out
    rows = np.loadtxt(tmp_path / "traj.txt")
    assert rows.ndim == 2 and rows.shape[1] == 12  # KITTI 3x4 lines


@pytest.mark.slow
def test_tum_rgbd_runner(rng, tmp_path):
    import cv2

    params, pts, shades, poses = _frames(rng)
    seq = tmp_path / "tum_seq"
    (seq / "rgb").mkdir(parents=True)
    (seq / "depth").mkdir(parents=True)
    assoc = seq / "assoc.txt"
    K = np.array([[FOCAL, 0, W / 2], [0, FOCAL, H / 2], [0, 0, 1]], np.float32)
    with open(assoc, "w") as f:
        for k, (R, t) in enumerate(poses):
            img = render(params, R, t, pts, shades)
            cv2.imwrite(str(seq / "rgb" / f"{k}.png"), img.astype(np.uint8))
            # True per-pixel depth: z of the closest rendered square at
            # each pixel; approximate with the plane depth of each square
            # painted far-to-near, like render() does.
            depth = np.zeros((H, W), np.float32)
            Xc = (R @ pts.T).T + t
            uv = np.asarray(cam.pinhole_project(params, jnp.asarray(Xc)))
            for i in np.argsort(-Xc[:, 2]):
                if Xc[i, 2] < 0.5:
                    continue
                u, v = uv[i]
                half = max(2, int(round(12.0 / Xc[i, 2] * 2)))
                ui, vi = int(round(u)), int(round(v))
                if 1 <= ui < W - 1 and 1 <= vi < H - 1:
                    u0, u1 = max(ui - half, 0), min(ui + half, W)
                    v0, v1 = max(vi - half, 0), min(vi + half, H)
                    depth[v0:v1, u0:u1] = Xc[i, 2]
            cv2.imwrite(
                str(seq / "depth" / f"{k}.png"),
                (depth * 5000.0).astype(np.uint16),
            )
            f.write(f"{k * 0.1:.6f} rgb/{k}.png {k * 0.1:.6f} depth/{k}.png\n")
    st = tmp_path / "settings.yaml"
    st.write_text(SETTINGS)
    out = _run([
        str(st), str(seq), "--dataset", "tumrgbd", "--mode", "rgbd",
        "--assoc", str(assoc), "--no-loop", "--kmax", "32", "--pmax", "4096",
        "--out", str(tmp_path / "traj.txt"), "--kf-out", str(tmp_path / "kf.txt"),
    ])
    assert f"[{len(poses) - 1}/{len(poses)}] state=OK" in out
    rows = np.loadtxt(tmp_path / "traj.txt")
    assert rows.ndim == 2 and len(rows) >= 5


@pytest.mark.slow
def test_tumvi_stereo_vi_fisheye_runner(tmp_path):
    """BASELINE config 4 path through the runner: generate a short
    TUM-VI-format stereo-fisheye sequence (--fisheye: KB8 pair + IMU) and
    replay it with --mode stereo-vi — exercises the Camera2/Tlr rig
    wiring in run_sequence plus the two-camera KB8 + inertial pipeline.
    Metric gate: stereo fixes scale, so SE3 ATE (no scale alignment)
    must come out in centimetres."""
    import re

    gen = os.path.join(REPO, "scripts", "make_synth_euroc.py")
    seq = tmp_path / "fe"
    env = dict(os.environ)
    out = subprocess.run(
        [sys.executable, gen, str(seq), "--frames", "16", "--fisheye"],
        capture_output=True, text=True, timeout=600, env=env, cwd=REPO,
    )
    assert out.returncode == 0, out.stderr[-2000:]
    log = _run([
        str(seq / "settings.yaml"), str(seq), "--dataset", "tumvi",
        "--mode", "stereo-vi", "--no-loop", "--kmax", "32",
        "--pmax", "8192", "--out", str(tmp_path / "traj.txt"),
        "--kf-out", str(tmp_path / "kf.txt"),
    ], timeout=1800)
    assert "state=OK" in log
    m = re.search(r"ATE RMSE: ([0-9.]+) m", log)
    assert m, log[-2000:]
    assert float(m.group(1)) < 0.05, log[-2000:]
