"""Live map/frame viewer served over HTTP — the headless-host analog of the
reference's Pangolin GUI thread (`/root/reference/src/Viewer.cc:76`,
`FrameDrawer.cc`, `MapDrawer.cc`).

The reference spawns an OpenGL window thread (`System.cc:175-177`) that
re-renders the Atlas and the tracked-keypoint overlay every ~33 ms.
Headless accelerator hosts have no display, so the equivalent is a tiny embedded
HTTP server (stdlib `http.server`, zero dependencies): the tracking loop
publishes a snapshot per frame (`LiveViewer.update`, the analog of
`FrameDrawer::Update` copying state under `mMutexState`,
`FrameDrawer.cc`), and any browser pointed at the port gets

  /            the viewer page (canvas top-down map + frame overlay)
  /state.json  map snapshot: keyframes, map-point subsample, trajectory,
               current pose, tracking state, counters
  /frame.png   the tracked-keypoint overlay (`FrameDrawer::DrawFrame`)
  /map.png     server-rendered top-down map (`MapDrawer::DrawMapPoints`)

Snapshots are produced on the TRACKING thread (host ordering stays
single-threaded — SURVEY §2.3's "versioned state" stance); the HTTP
threads only ever read the latest immutable snapshot, so no lock guards
device state. Device→host copies are throttled (`min_period_s`), and the
map-point cloud is subsampled to `max_points` for the JSON payload.
"""

from __future__ import annotations

import json
import threading
import time
from http.server import BaseHTTPRequestHandler, ThreadingHTTPServer
from typing import Optional

import numpy as np

_PAGE = """<!doctype html>
<html><head><title>orbslam3_jax viewer</title><style>
body{background:#111;color:#ddd;font-family:monospace;margin:12px}
canvas,img{border:1px solid #444;background:#000}
#row{display:flex;gap:12px;flex-wrap:wrap}
</style></head><body>
<div id="hud">connecting...</div>
<div id="row"><canvas id="map" width="640" height="640"></canvas>
<img id="frame" width="480"/></div>
<script>
const cv = document.getElementById('map'), cx = cv.getContext('2d');
function draw(s){
  cx.fillStyle='#000'; cx.fillRect(0,0,cv.width,cv.height);
  const xs=[], ys=[];
  for(const p of s.map_points){xs.push(p[0]); ys.push(p[2]);}
  for(const k of s.keyframes){xs.push(k[0]); ys.push(k[2]);}
  if(!xs.length) return;
  const x0=Math.min(...xs), x1=Math.max(...xs), y0=Math.min(...ys), y1=Math.max(...ys);
  const sc=0.9*cv.width/Math.max(x1-x0, y1-y0, 1e-3);
  const mx=(x0+x1)/2, my=(y0+y1)/2;
  const T=(x,z)=>[cv.width/2+(x-mx)*sc, cv.height/2-(z-my)*sc];
  cx.fillStyle='#999';
  for(const p of s.map_points){const[a,b]=T(p[0],p[2]); cx.fillRect(a,b,1.5,1.5);}
  cx.strokeStyle='#e33'; cx.beginPath();
  s.trajectory.forEach((p,i)=>{const[a,b]=T(p[0],p[2]); i?cx.lineTo(a,b):cx.moveTo(a,b);});
  cx.stroke();
  cx.fillStyle='#3e3';
  for(const k of s.keyframes){const[a,b]=T(k[0],k[2]); cx.fillRect(a-2,b-2,4,4);}
  if(s.current_pose){const[a,b]=T(s.current_pose[0],s.current_pose[2]);
    cx.fillStyle='#ff0'; cx.beginPath(); cx.arc(a,b,5,0,7); cx.fill();}
}
async function tick(){
  try{
    const s = await (await fetch('state.json')).json();
    document.getElementById('hud').textContent =
      `state=${s.state} keyframes=${s.n_keyframes} points=${s.n_map_points}`+
      ` frame=${s.frame_id} loops=${s.n_loops}`;
    draw(s);
    document.getElementById('frame').src = 'frame.png?t=' + Date.now();
  }catch(e){}
  setTimeout(tick, 500);
}
tick();
</script></body></html>"""


class LiveViewer:
    """Embedded viewer server. `update(...)` publishes; HTTP serves."""

    def __init__(self, system, port: int = 0, host: str = "127.0.0.1",
                 min_period_s: float = 0.2, max_points: int = 4000):
        self._system = system
        self.min_period_s = float(min_period_s)
        self.max_points = int(max_points)
        self._state_json = b'{"state": "STARTING", "map_points": [], ' \
                           b'"keyframes": [], "trajectory": [], ' \
                           b'"n_keyframes": 0, "n_map_points": 0, ' \
                           b'"frame_id": -1, "n_loops": 0, ' \
                           b'"current_pose": null}'
        self._frame_png: Optional[bytes] = None
        self._last_pub = 0.0
        self._lock = threading.Lock()  # swaps the snapshot pointers only

        viewer = self

        class Handler(BaseHTTPRequestHandler):
            def log_message(self, *a):  # quiet
                pass

            def do_GET(self):
                path = self.path.split("?")[0]
                if path == "/":
                    body, ctype = _PAGE.encode(), "text/html"
                elif path == "/state.json":
                    with viewer._lock:
                        body = viewer._state_json
                    ctype = "application/json"
                elif path == "/frame.png":
                    with viewer._lock:
                        body = viewer._frame_png
                    if body is None:
                        self.send_response(404)
                        self.end_headers()
                        return
                    ctype = "image/png"
                elif path == "/map.png":
                    body = viewer._render_map_png()
                    ctype = "image/png"
                else:
                    self.send_response(404)
                    self.end_headers()
                    return
                self.send_response(200)
                self.send_header("Content-Type", ctype)
                self.send_header("Content-Length", str(len(body)))
                self.send_header("Cache-Control", "no-store")
                self.end_headers()
                self.wfile.write(body)

        self._httpd = ThreadingHTTPServer((host, port), Handler)
        self._httpd.daemon_threads = True
        self.port = self._httpd.server_address[1]
        self._thread = threading.Thread(
            target=self._httpd.serve_forever, daemon=True,
            name="orbslam3_jax-viewer",
        )
        self._thread.start()

    # -- publishing (tracking-loop side) --------------------------------
    def update(self, img: Optional[np.ndarray] = None, frame=None) -> None:
        """Publish the current map + (optionally) frame overlay. Called
        from the tracking loop after each frame, like the reference's
        `FrameDrawer::Update` / `MapDrawer::SetCurrentCameraPose`.
        Throttled: device→host copies at most every `min_period_s`."""
        now = time.monotonic()
        if now - self._last_pub < self.min_period_s:
            return
        self._last_pub = now
        sysm = self._system
        s = sysm.store.state
        mp = np.asarray(s.mp_pos)
        mv = np.asarray(s.mp_valid)
        kf_R = np.asarray(s.kf_R)
        kf_t = np.asarray(s.kf_t)
        kv = np.asarray(s.kf_valid)
        pts = mp[mv]
        if len(pts) > self.max_points:
            pts = pts[:: max(1, len(pts) // self.max_points)]
        centers = np.einsum("kji,kj->ki", kf_R[kv], -kf_t[kv])
        try:
            ts, traj = sysm.get_trajectory()
        except Exception:
            traj = np.zeros((0, 3))
        if len(traj) > 2000:
            traj = traj[:: len(traj) // 2000]
        cur = None
        tr = sysm.tracker
        if tr.last_frame is not None:
            Rwc, twc = tr.last_frame.Twc()
            cur = np.asarray(twc).round(4).tolist()
        lc = sysm.loop_closer
        snap = {
            "state": sysm.tracking_state.name,
            "n_keyframes": int(kv.sum()),
            "n_map_points": int(mv.sum()),
            "frame_id": -1 if tr.last_frame is None else tr.last_frame.frame_id,
            "n_loops": 0 if lc is None else lc.n_loops_closed,
            "map_points": np.round(pts, 4).tolist(),
            "keyframes": np.round(centers, 4).tolist(),
            "trajectory": np.round(np.asarray(traj), 4).tolist(),
            "current_pose": cur,
        }
        state_json = json.dumps(snap).encode()
        frame_png = None
        if img is not None and frame is not None:
            frame_png = self._encode_overlay(img, frame, snap["state"])
        with self._lock:
            self._state_json = state_json
            if frame_png is not None:
                self._frame_png = frame_png

    def _encode_overlay(self, img, frame, state_name: str) -> Optional[bytes]:
        try:
            import cv2
            from orbslam3_jax.viz.drawer import draw_frame

            uv = np.asarray(frame.features.uv)
            ok = np.asarray(frame.features.valid)
            tracked = np.asarray(frame.mp_assoc) >= 0
            out = draw_frame(
                np.asarray(img), uv[ok], tracked[ok],
                state_text=f"{state_name}  kp={int(ok.sum())}",
            )
            enc_ok, buf = cv2.imencode(".png", out)
            return bytes(buf) if enc_ok else None
        except Exception:
            return None

    def _render_map_png(self) -> bytes:
        import cv2
        from orbslam3_jax.viz.drawer import render_system

        img = render_system(self._system)
        ok, buf = cv2.imencode(".png", img)
        return bytes(buf) if ok else b""

    def close(self) -> None:
        self._httpd.shutdown()
        self._httpd.server_close()
