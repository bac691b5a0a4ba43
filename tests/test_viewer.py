"""Live HTTP viewer (`viz/server.py`) — the Pangolin GUI thread analog
(ref `Viewer.cc:76` / `FrameDrawer.cc` / `MapDrawer.cc`): page, JSON
snapshot, frame overlay, and map render are all served while a System
tracks, and the snapshot reflects the live map."""

import json
import urllib.request

import numpy as np

from orbslam3_jax.ops import cameras as cam
from orbslam3_jax.ops import features as feat
from orbslam3_jax.system import System, Sensor

from test_e2e_mono import H, W, FOCAL, make_world, render, camera_path


def _get(port, path):
    with urllib.request.urlopen(f"http://127.0.0.1:{port}{path}", timeout=10) as r:
        return r.status, r.read()


def test_live_viewer_serves_tracking_state():
    rng = np.random.default_rng(0)  # same world the e2e test tracks on
    params = cam.make_pinhole(FOCAL, FOCAL, W / 2, H / 2)
    pts, shades = make_world(rng)
    poses = camera_path(12)
    orb = feat.OrbParams(n_features=400, n_levels=3)
    slam = System(
        Sensor.MONOCULAR, cam.CameraModel.PINHOLE, params, (W, H),
        orb_params=orb, Kmax=32, Pmax=4096,
    )
    viewer = slam.enable_viewer(port=0, min_period_s=0.0)
    assert viewer.port > 0

    status, page = _get(viewer.port, "/")
    assert status == 200 and b"orbslam3_jax viewer" in page

    for k, (R, t) in enumerate(poses):
        slam.track_monocular(render(params, R, t, pts, shades), k * 0.1)

    status, body = _get(viewer.port, "/state.json")
    assert status == 200
    snap = json.loads(body)
    assert snap["state"] == "OK"
    assert snap["n_keyframes"] == slam.n_keyframes >= 2
    assert snap["n_map_points"] > 50
    assert len(snap["map_points"]) > 50
    assert len(snap["keyframes"]) == snap["n_keyframes"]
    assert len(snap["trajectory"]) >= 2
    assert snap["current_pose"] is not None and len(snap["current_pose"]) == 3

    # Frame overlay + server-rendered map: both PNGs.
    status, png = _get(viewer.port, "/frame.png")
    assert status == 200 and png[:8] == b"\x89PNG\r\n\x1a\n"
    status, png = _get(viewer.port, "/map.png")
    assert status == 200 and png[:8] == b"\x89PNG\r\n\x1a\n"

    slam.shutdown()  # closes the server
