"""Shared multi-map replay scenario (BASELINE config 5's Atlas core).

One synthetic world, one frame schedule, one replay loop — used by
`drive_multimap.py` (single device) and `drive_multimap_distributed.py`
(the same replay as SPMD replicas over 2 `jax.distributed` processes, with
the post-merge global BA point-partitioned across them). Keeping the
scenario in one module is what makes the distributed run comparable to the
single-device run "to numerical tolerance".

Scenario: track a sweep over wall section 1, blind the camera (hard LOST
-> map stored, new map starts — `Tracking::CreateMapInAtlas`,
`/root/reference/src/Tracking.cc:1239-1257`), re-initialize on unseen wall
section 2, pan back into section 1 → place recognition MERGES the maps
(`LoopClosing::MergeLocal`, `LoopClosing.cc:1332`) and the post-merge
global BA runs (`LoopClosing.cc:1967`).
"""

import numpy as np
import jax.numpy as jnp

from orbslam3_jax.ops import bow
from orbslam3_jax.ops import cameras as cam
from orbslam3_jax.ops import features as feat
from orbslam3_jax.ops import lie

H, W = 240, 320
FOCAL = 260.0
ORB = feat.OrbParams(n_features=400, n_levels=3)


class Scene:
    def __init__(self, seed: int = 3):
        rng = np.random.default_rng(seed)
        self.params = cam.make_pinhole(FOCAL, FOCAL, W / 2, H / 2)
        # Two ADJACENT wall sections: sweep A maps only section 1; after
        # forced loss, sweep B initializes a NEW map on section 2 (unseen
        # by A) and pans back into section 1 -> map MERGE.
        n1, n2 = 110, 110
        pts1 = np.stack(
            [rng.uniform(-3.5, 3.5, n1), rng.uniform(-2.2, 2.2, n1),
             rng.uniform(3.0, 6.0, n1)], axis=-1,
        )
        pts2 = np.stack(
            [rng.uniform(3.5, 10.5, n2), rng.uniform(-2.2, 2.2, n2),
             rng.uniform(3.0, 6.0, n2)], axis=-1,
        )
        self.pts = np.concatenate([pts1, pts2]).astype(np.float32)
        self.quad_shades = rng.uniform(50, 250, (n1 + n2, 2, 2)).astype(np.float32)
        self.blank = np.full((H, W), 35.0, np.float32)

        # Frames: sweep A on wall 1 (x 0 -> 1.4), 28 blank frames (hard
        # LOST -> new map), sweep B from wall 2 (x 6.5) panning back to
        # wall 1 (x -> 0.5): the overlap must MERGE the maps.
        self.schedule = []
        n_a = 14
        for k in range(n_a):
            s_ = k / (n_a - 1)
            self.schedule.append(("A", self.pose_at(1.4 * s_, s_)))
        for _ in range(28):
            self.schedule.append(("blank", None))
        n_b = 26
        for k in range(n_b):
            s_ = k / (n_b - 1)
            self.schedule.append(("B", self.pose_at(6.5 - 6.0 * s_, s_)))

    def pose_at(self, x, s):
        Rcw = np.asarray(lie.exp_so3(jnp.asarray([0.0, -0.03 * s, 0.0], jnp.float32)))
        center = np.array([x, 0.1 * np.sin(4 * s), 0.3 * s], np.float32)
        return Rcw.astype(np.float32), (-Rcw @ center).astype(np.float32)

    def render(self, Rcw, tcw):
        img = np.full((H, W), 35.0, np.float32)
        Xc = (Rcw @ self.pts.T).T + tcw
        uv = np.asarray(cam.pinhole_project(self.params, jnp.asarray(Xc)))
        for i in np.argsort(-Xc[:, 2]):
            if Xc[i, 2] < 0.5:
                continue
            u, v = uv[i]
            half = max(3, int(round(12.0 / Xc[i, 2] * 2)))
            ui, vi = int(round(u)), int(round(v))
            if 1 <= ui < W - 1 and 1 <= vi < H - 1:
                for qy in (0, 1):
                    for qx in (0, 1):
                        y0, y1 = (vi - half, vi) if qy == 0 else (vi, vi + half)
                        x0, x1 = (ui - half, ui) if qx == 0 else (ui, ui + half)
                        img[max(y0, 0) : min(y1, H),
                            max(x0, 0) : min(x1, W)] = self.quad_shades[i, qy, qx]
        return img

    def make_vocabulary(self):
        train = []
        for x in (0.0, 1.0, 2.5, 4.0, 5.5, 6.5):
            f = feat.extract(jnp.asarray(self.render(*self.pose_at(x, 0.0))), ORB)
            train.append(np.asarray(f.desc)[np.asarray(f.valid)])
        return bow.build_vocabulary(np.concatenate(train), k=8, depth=3, seed=0)


def make_system(scene: Scene, distributed: bool = False, post_merge_gba: bool = True):
    from orbslam3_jax.system import System, Sensor

    slam = System(
        Sensor.MONOCULAR, cam.CameraModel.PINHOLE, scene.params, (W, H),
        orb_params=ORB, Kmax=64, Pmax=8192,
    )
    slam.enable_multimap(
        scene.make_vocabulary(), min_kfs_to_store=5, min_merge_matches=15,
        min_sim3_inliers=12, post_merge_gba=post_merge_gba,
    )
    if distributed:
        slam.enable_distributed()
    return slam


def replay(scene: Scene, slam, verbose: bool = True):
    """Run the schedule; returns (gt_ts, gt_pos, merge_frames) — ground
    truth of non-blank frames plus the frame indices where merges fired."""
    gt_ts, gt_pos, merge_frames = [], [], []
    merges_seen = 0
    for i, (tag, pose) in enumerate(scene.schedule):
        ts = i * 0.1
        if tag == "blank":
            img = scene.blank
        else:
            R, t = pose
            img = scene.render(R, t)
            gt_ts.append(ts)
            gt_pos.append(-R.T @ t)
        slam.track_monocular(img, ts)
        if slam.multimap.n_merges > merges_seen:
            merges_seen = slam.multimap.n_merges
            merge_frames.append(i)
        if verbose:
            print(
                f"frame {i} [{tag}]: state={slam.tracking_state.name} "
                f"maps={slam.multimap.atlas.n_maps} kfs={slam.n_keyframes} "
                f"merges={slam.multimap.n_merges}", flush=True,
            )
    return np.asarray(gt_ts), np.stack(gt_pos), merge_frames
