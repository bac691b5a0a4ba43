"""Live-ingest streaming (the ROS-node analog, `io/stream.py`): a
producer thread pushes frames+IMU over a socketpair; `stream.serve`
drives a real System and answers every frame with a tracked pose."""

import socket
import threading

import numpy as np
import pytest

from orbslam3_jax.io import stream
from orbslam3_jax.ops import cameras as cam
from orbslam3_jax.ops import features as feat
from orbslam3_jax.system import System, Sensor

from test_e2e_mono import H, W, FOCAL, make_world, render, camera_path


def test_protocol_roundtrip():
    a, b = socket.socketpair()
    img = (np.arange(48 * 64, dtype=np.uint8)).reshape(48, 64)
    stream.send_frame(a, 1.25, img)
    stream.send_imu(a, 1.30, [0.1, 0.2, 9.8], [0.01, -0.02, 0.0])
    stream.send_pose(a, 1.25, 2, np.eye(3, dtype=np.float32),
                     np.asarray([1, 2, 3], np.float32))
    stream.send_bye(a)

    t1, payload = stream.recv_message(b)
    assert t1 == stream.MSG_FRAME
    t, img2 = stream.parse_frame(payload)
    assert t == 1.25 and np.array_equal(img2, img)
    t2, payload = stream.recv_message(b)
    assert t2 == stream.MSG_IMU
    t, acc, gyro = stream.parse_imu(payload)
    assert abs(t - 1.30) < 1e-9 and abs(acc[2] - 9.8) < 1e-5
    t3, payload = stream.recv_message(b)
    assert t3 == stream.MSG_POSE
    t, state, Rwc, twc = stream.parse_pose(payload)
    assert state == 2 and np.allclose(twc, [1, 2, 3])
    assert stream.recv_message(b)[0] == stream.MSG_BYE
    a.close(); b.close()


@pytest.mark.slow
def test_stream_serves_slam(rng):
    params = cam.make_pinhole(FOCAL, FOCAL, W / 2, H / 2)
    pts, shades = make_world(rng)
    poses = camera_path(10)
    orb = feat.OrbParams(n_features=400, n_levels=3)
    slam = System(
        Sensor.MONOCULAR, cam.CameraModel.PINHOLE, params, (W, H),
        orb_params=orb, Kmax=32, Pmax=4096,
    )
    slam.enable_async_mapping()
    srv, cli = socket.socketpair()
    result = {}

    def server():
        result["n"] = stream.serve(slam, srv)

    th = threading.Thread(target=server)
    th.start()
    got = []
    for k, (R, t) in enumerate(poses):
        img = render(params, R, t, pts, shades).astype(np.uint8)
        stream.send_frame(cli, k * 0.1, img)
        msg = stream.recv_message(cli)
        assert msg is not None and msg[0] == stream.MSG_POSE
        got.append(stream.parse_pose(msg[1]))
    stream.send_bye(cli)
    th.join(timeout=120)
    assert result["n"] == 10
    states = [g[1] for g in got]
    assert states[-1] == 2  # OK at the end
    # Poses actually move (camera translates along x).
    assert abs(got[-1][3][0]) > 1e-3
    cli.close(); srv.close()
