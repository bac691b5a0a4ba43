"""Public API facade — the `ORB_SLAM3::System` of this engine.

Mirrors `/root/reference/src/System.cc` + `include/System.h:85-178`:
sensor modes, per-frame Track* entry points, trajectory export, reset.
Construction wires tracker + local mapper (+ loop closer as it lands)
over a shared `MapStore`, replacing the reference's three std::threads
(`System.cc:138-177`) with host-sequenced device programs.
"""

from __future__ import annotations

import enum
from typing import Optional, Tuple

import numpy as np
import jax.numpy as jnp

from orbslam3_jax.atlas.store import MapStore
from orbslam3_jax.ops import cameras as cam
from orbslam3_jax.ops import features as feat
from orbslam3_jax.io import trajectory as traj_io
from orbslam3_jax.pipeline.local_mapping import LocalMapper
from orbslam3_jax.pipeline.tracking import Tracker, TrackState


class Sensor(enum.Enum):
    """Ref `System::eSensor` (`System.h:85-91`)."""

    MONOCULAR = 0
    STEREO = 1
    RGBD = 2
    IMU_MONOCULAR = 3
    IMU_STEREO = 4


class System:
    def __init__(
        self,
        sensor: Sensor,
        camera_model: cam.CameraModel,
        camera_params,
        img_wh: Tuple[int, int],
        orb_params: feat.OrbParams = feat.OrbParams(),
        bf: float = 0.0,
        imu_calib=None,  # ops.imu.ImuCalib (required for IMU_* sensors)
        camera2=None,  # (params2, Tlr, lapping1, lapping2) — stereo fisheye
        Kmax: int = 256,
        Pmax: int = 16384,
        fps: float = 20.0,
    ):
        self.sensor = sensor
        inertial = sensor in (Sensor.IMU_MONOCULAR, Sensor.IMU_STEREO)
        if inertial:
            assert imu_calib is not None, "IMU sensor modes need imu_calib"
        self.store = MapStore(Kmax=Kmax, Pmax=Pmax, Nf=sum(feat.level_budgets(orb_params)))
        params = jnp.asarray(camera_params, jnp.float32)
        self.tracker = Tracker(
            camera_model, params, img_wh, self.store, orb_params, bf=bf,
            imu_calib=imu_calib if inertial else None, camera2=camera2,
            fps=fps,
        )
        self.tracker.is_stereo_like = sensor in (
            Sensor.STEREO, Sensor.RGBD, Sensor.IMU_STEREO,
        )
        self.mapper = LocalMapper(
            camera_model, params, img_wh, self.store, orb_params, bf=bf,
            imu_calib=imu_calib if inertial else None,
            mono=sensor == Sensor.IMU_MONOCULAR,
        )
        # Metric-depth sensors keep EVERY observation in the local BA
        # (round-5 A/B: dropping the valid-obs tail cost the 600-frame
        # stereo replay 2x ATE while mono was unaffected — stereo rows
        # carry the metric constraints). Covers rectified stereo, RGB-D,
        # and the two-camera fisheye rig (bf == 0 there).
        self.mapper.stereo_like = (
            self.tracker.is_stereo_like or camera2 is not None)
        self.mapper.tracker = self.tracker
        self.tracker.new_kf_callback = self._on_new_keyframe
        self.tracker.anomaly_cb = self._on_timestamp_anomaly
        self.loop_closer = None
        self.multimap = None
        self.async_mapper = None
        self.viewer = None
        self.dist = None  # DistributedContext (enable_distributed)
        self.rectifier = None  # StereoRectifier (enable_rectification)
        # Post-mapping consumers (loop closing, multi-map): the reference's
        # LocalMapping -> LoopClosing hand-off (`LocalMapping.cc:280`) —
        # they see a keyframe only after its mapping pass completed.
        self._kf_downstream = []
        self._lost_streak = 0
        self._shutdown = False

    def _on_new_keyframe(self, slot, initial=False, preint=None):
        if self.async_mapper is not None:
            self.async_mapper.submit(slot, initial=initial, preint=preint)
            return
        self.mapper.process_keyframe(slot, initial=initial, preint=preint)
        for d in self._kf_downstream:
            d(slot)

    def enable_async_mapping(self):
        """Overlap mapping with tracking (ref: LocalMapping as its own
        thread, `System.cc:138`): the per-KF mapping pass runs sliced one
        stage per tracked frame instead of synchronously inside the
        keyframe-inserting frame. See `pipeline/async_mapping.py`."""
        from orbslam3_jax.pipeline.async_mapping import AsyncMapper

        self.async_mapper = AsyncMapper(self.mapper, self._kf_downstream)
        self.tracker.mapper_idle_query = self.async_mapper.idle
        self.tracker.mapping_interrupt = self.async_mapper.interrupt
        self.tracker.mapping_queue_len = self.async_mapper.queue_len

    def enable_distributed(self, mesh=None):
        """Dispatch the pipeline's whole-map work onto a device mesh
        (BASELINE config 5: "map merging + global BA across 2 hosts"):

        * global BA — loop-closure GBA (async chunks and the synchronous
          fallback) runs the point-partitioned block-Schur solve of
          `parallel/ba_sharded.py` over the mesh (one psum of the reduced
          camera system per LM iteration);
        * Atlas place recognition — the multi-map manager's merge-candidate
          scoring runs the sharded KFDB query of `parallel/kfdb_sharded.py`.

        `mesh` defaults to all of `jax.devices()` — in a multi-process
        (`jax.distributed`) run that is the global multi-host mesh, and every
        process must replay the same frames (SPMD replicas). Call in any
        order relative to enable_place_recognition/enable_multimap."""
        from orbslam3_jax.parallel.context import DistributedContext

        self.dist = DistributedContext(mesh)
        lc = self.loop_closer
        if lc is not None:
            lc.dist = self.dist
            if lc.gba_async is not None:
                lc.gba_async.dist = self.dist
        return self.dist

    def enable_rectification(self, rect_left, rect_right):
        """Raw (unrectified) pinhole-stereo ingestion: the reference parses
        `LEFT./RIGHT. K/D/R/P` and builds remap grids once
        (`Tracking.cc:299-323`); its ROS node applies `cv::remap` per frame
        before `TrackStereo`. Here `track_stereo` applies the remap as one
        device gather program before extraction. Args are
        `config.RectifyConfig` (or anything with K/D/R/P/width/height)."""
        from orbslam3_jax.ops.rectify import StereoRectifier

        assert self.sensor in (Sensor.STEREO, Sensor.IMU_STEREO)
        self.rectifier = StereoRectifier(rect_left, rect_right)
        return self.rectifier

    def enable_viewer(self, port: int = 0, **kw):
        """Start the live HTTP viewer (ref: Viewer/FrameDrawer/MapDrawer
        GUI thread, `System.cc:175-177` — re-expressed as an embedded
        web server for headless hosts, `viz/server.py`). Returns the
        viewer; `viewer.port` holds the bound port (0 = ephemeral)."""
        from orbslam3_jax.viz.server import LiveViewer

        self.viewer = LiveViewer(self, port=port, **kw)
        return self.viewer

    def enable_multimap(self, vocabulary, **kw):
        """Atlas multi-map mode (ref `Tracking::CreateMapInAtlas` +
        `LoopClosing::MergeLocal`): hard tracking loss stores the map and
        starts a new one; place recognition later welds them."""
        from orbslam3_jax.pipeline.multimap import MultiMapManager

        self.multimap = MultiMapManager(self, vocabulary, **kw)
        self._kf_downstream.append(self.multimap.on_new_keyframe)

    def enable_place_recognition(self, vocabulary, run_gba: bool = True,
                                 min_bow_matches: int = 20, min_sim3_inliers: int = 20,
                                 consecutive: int = 3, async_gba: bool = True):
        """Attach a vocabulary: enables relocalization + loop closing
        (ref `System.cc:83-95`: vocabulary -> KeyFrameDatabase ->
        LoopClosing thread). `consecutive` is the reference's
        3-consecutive-KF temporal-consistency requirement
        (`LoopClosing.cc:367`); pass 1 for immediate closure in tiny
        tests."""
        from orbslam3_jax.atlas.kfdb import KeyFrameDB
        from orbslam3_jax.pipeline.loop_closing import LoopCloser

        kfdb = KeyFrameDB(vocabulary, Kmax=self.store.state.Kmax)
        self.tracker.kfdb = kfdb
        inertial = self.sensor in (Sensor.IMU_MONOCULAR, Sensor.IMU_STEREO)
        self.loop_closer = LoopCloser(
            self.tracker.model, self.tracker.params, self.store, kfdb,
            self.tracker.sigma2_table, run_gba=run_gba,
            min_bow_matches=min_bow_matches, min_sim3_inliers=min_sim3_inliers,
            consecutive=consecutive, inertial=inertial,
            img_wh=self.tracker.img_wh, scale_table=self.tracker.scale_table,
            mapper=self.mapper, bf=self.tracker.bf,
        )
        self.loop_closer.dist = self.dist
        if run_gba and async_gba:
            from orbslam3_jax.pipeline.gba import AsyncGBA

            self.loop_closer.gba_async = AsyncGBA(
                self.tracker.model, self.tracker.params,
                self.tracker.sigma2_table, bf=self.tracker.bf,
                dist=self.dist,
            )
        self._kf_downstream.append(self.loop_closer.process_keyframe)

    # -- control surface (ref `System.h:102-178`) ----------------------
    def activate_localization_mode(self):
        """Ref `System::ActivateLocalizationMode` (`System.h:106`):
        tracking continues against the frozen map; no keyframes, no
        mapping, no loop closing."""
        self.tracker.only_tracking = True

    def deactivate_localization_mode(self):
        """Ref `System::DeactivateLocalizationMode` (`System.h:108`)."""
        self.tracker.only_tracking = False

    def reset(self):
        """Full reset (`System::Reset` -> `Tracking::Reset`,
        `Tracking.cc:3456`): drop every map, database and the trajectory;
        back to NO_IMAGES_YET."""
        self.tracker.reset_map_state(full=True)
        self._swap_fresh_store()
        if self.multimap is not None:
            self.multimap.atlas.maps = [self.store]
            self.multimap.atlas.active_idx = 0
            self.multimap.kfdbs = {}
            self.multimap.lost_streak = 0

    def reset_active_map(self):
        """Ref `System::ResetActiveMap` -> `Tracking::ResetActiveMap`
        (`Tracking.cc:3521`): discard the active map's content and start
        fresh; stored Atlas maps and their trajectory segments survive."""
        old = self.store
        self.tracker.reset_map_state(full=False)
        self._swap_fresh_store()
        if self.multimap is not None:
            maps = self.multimap.atlas.maps
            maps[maps.index(old)] = self.store
            self.multimap.kfdbs.pop(id(old), None)
            self.multimap.lost_streak = 0

    def shutdown(self):
        """Ref `System::Shutdown` (`System.cc:474`): finish background
        work (mapping passes drain, async GBA joins) and refuse further
        frames."""
        if self.async_mapper is not None:
            self.async_mapper.flush()
        lc = self.loop_closer
        if lc is not None and lc.gba_async is not None:
            lc.gba_async.join(self.store)
        if self.viewer is not None:
            self.viewer.close()
        self._shutdown = True

    def _swap_fresh_store(self):
        s = self.store.state
        self._attach_store(MapStore(Kmax=s.Kmax, Pmax=s.Pmax, Nf=s.Nf))

    def _attach_store(self, new):
        """Re-point every subsystem at `new` as the active map: tracker,
        mapper (fresh preintegrations + IMU-init stage), loop closer (new
        per-map KeyFrameDatabase — the reference keeps ONE database over
        the whole Atlas, but our reloc/loop queries are per-map and the
        multi-map manager holds its own per-map databases for merging)."""
        if self.async_mapper is not None:
            self.async_mapper.abort()  # in-flight kf ids are stale
        self.store = new
        self.tracker.store = new
        self.mapper.store = new
        self.mapper.preints = {}
        self.mapper.recent_mp = []
        self.mapper.bad_imu = False
        if self.mapper.imu_init is not None:
            from orbslam3_jax.pipeline.inertial_support import ImuInitializer

            self.mapper.imu_init = ImuInitializer(
                self.mapper.imu_calib, mono=self.sensor == Sensor.IMU_MONOCULAR
            )
        if self.loop_closer is not None:
            from orbslam3_jax.atlas.kfdb import KeyFrameDB

            kfdb = KeyFrameDB(self.loop_closer.kfdb.voc, Kmax=new.state.Kmax)
            self.loop_closer.kfdb = kfdb
            self.loop_closer.store = new
            self.loop_closer._pending = None
            self.loop_closer.last_loop_kf = -10_000
            self.loop_closer.loop_edges = []
            self.tracker.kfdb = kfdb

    def _on_timestamp_anomaly(self, kind: str):
        """Ref `Tracking::Track` (`Tracking.cc:987-1031`): frame reorder or
        a >1 s gap before IMU init resets the active map; a gap after IMU
        init keeps the (gravity-aligned) map and starts a new one."""
        if kind == "gap_init" and self.multimap is not None:
            self.multimap._create_map()
        else:
            self.reset_active_map()

    # ------------------------------------------------------------------
    def track_monocular(self, img: np.ndarray, timestamp: float, imu_measurements=None):
        """Ref `System::TrackMonocular`: feeds queued IMU samples
        ((t, acc(3), gyro(3)) tuples since the last frame) then tracks."""
        assert self.sensor in (Sensor.MONOCULAR, Sensor.IMU_MONOCULAR)
        if imu_measurements:
            for (t, acc, gyro) in imu_measurements:
                self.tracker.grab_imu(t, acc, gyro)
        out = self.tracker.process_frame(img, timestamp)
        self._post_frame(img)
        return out

    def track_stereo(self, img_left: np.ndarray, img_right: np.ndarray,
                     timestamp: float, imu_measurements=None):
        """Ref `System::TrackStereo` (`System.cc:199`) — rectified pinhole
        stereo."""
        assert self.sensor in (Sensor.STEREO, Sensor.IMU_STEREO)
        if imu_measurements:
            for (t, acc, gyro) in imu_measurements:
                self.tracker.grab_imu(t, acc, gyro)
        if self.rectifier is not None:
            img_left, img_right = self.rectifier(img_left, img_right)
        if self.tracker.camera2 is not None:  # stereo-fisheye rig (Frame.cc:1187)
            out = self.tracker.process_stereo_fisheye_frame(
                img_left, img_right, timestamp
            )
        else:
            out = self.tracker.process_stereo_frame(img_left, img_right, timestamp)
        self._post_frame(img_left)
        return out

    def track_rgbd(self, img: np.ndarray, depth_map: np.ndarray, timestamp: float):
        """Ref `System::TrackRGBD` (`System.cc:265`)."""
        assert self.sensor == Sensor.RGBD
        out = self.tracker.process_rgbd_frame(img, depth_map, timestamp)
        self._post_frame(img)
        return out

    def _post_frame(self, img):
        """Per-frame hooks shared by every Track* entry: background work
        slices, the bad-IMU watchdog (`LocalMapping.cc:183-192`), the
        hard-LOST recovery policy, and the viewer."""
        self._tick_gba()
        if self.mapper.bad_imu:
            # Watchdog fired during mapping: not enough motion to ever
            # initialize the IMU — restart the active map.
            self.reset_active_map()
        elif self.multimap is not None:
            self.multimap.on_frame_done()
        else:
            self._lost_recovery_fallback()
        if self.viewer is not None:
            self.viewer.update(img, self.tracker.last_frame)

    def _lost_recovery_fallback(self):
        """Hard-LOST policy without an Atlas manager (ref `Tracking::Track`
        `Tracking.cc:1239-1257`: <10-KF map -> ResetActiveMap, else
        CreateMapInAtlas). With no multi-map manager enabled there is
        nowhere to store a built map, so only the small-map branch applies:
        a map too thin to relocalize into is discarded and initialization
        restarts; a built map keeps attempting relocalization in place."""
        from orbslam3_jax.pipeline.tracking import TrackState

        if self.tracker.state != TrackState.LOST or self.tracker.only_tracking:
            # Localization mode never mutates the map (`Tracking.cc:1111-
            # 1167` mbOnlyTracking: relocalization only).
            self._lost_streak = 0
            return
        self._lost_streak += 1
        if self._lost_streak >= 5 and self.store.n_kf <= 10:
            self.reset_active_map()
            self._lost_streak = 0

    def _tick_gba(self):
        """Advance background work by one slice per frame: one stage of
        an in-flight mapping pass (the reference's LocalMapping thread)
        and one chunk of a running GBA (its transient GBA thread) —
        time-sliced from the frame loop as async device dispatches;
        tracking never blocks on either."""
        if self.async_mapper is not None:
            self.async_mapper.tick()
        lc = self.loop_closer
        if lc is not None and lc.gba_async is not None and lc.gba_async.running:
            lc.gba_async.tick(self.store)

    @property
    def tracking_state(self) -> TrackState:
        return self.tracker.state

    @property
    def n_keyframes(self) -> int:
        return self.store.n_kf

    @property
    def n_map_points(self) -> int:
        return int(np.asarray(self.store.state.mp_valid).sum())

    # ------------------------------------------------------------------
    def get_trajectory(self):
        """(timestamps, positions (N,3)) of tracked frames (camera centers
        in world), chained through the CURRENT keyframe poses so BA and
        loop corrections apply retroactively (`System.cc:599`)."""
        rows = self.tracker.reconstructed_trajectory()
        ts = np.asarray([t for t, _, _ in rows])
        pos = np.asarray([p for _, _, p in rows])
        return ts, pos

    # -- Atlas checkpoint / resume (ref `System::SaveAtlas/LoadAtlas`,
    # `System.h:163-165,180-186` — designed-but-dormant there, functional
    # here; SURVEY §5.4) ------------------------------------------------
    def save_atlas(self, path: str):
        """Persist every map (multi-map Atlas if enabled, else the active
        map wrapped as a one-map Atlas)."""
        if self.multimap is not None:
            self.multimap.atlas.imu_initialized = bool(self.tracker.imu_ready)
            self.multimap.atlas.save(path)
        else:
            from orbslam3_jax.atlas.atlas import Atlas

            s = self.store.state
            a = Atlas(Kmax=s.Kmax, Pmax=s.Pmax, Nf=s.Nf)
            a.maps = [self.store]
            a.active_idx = 0
            a.imu_initialized = bool(self.tracker.imu_ready)
            a.save(path)

    def load_atlas(self, path: str):
        """Restore a saved Atlas: re-point the pipeline at its active map,
        rebuild the place-recognition indices (inverted files are derived
        state — recomputed from the stored KF descriptors, like the
        reference's PostLoad rewiring, `KeyFrameDatabase.cc:899-927`), and
        drop tracking to LOST so per-frame relocalization re-attaches to
        the loaded map."""
        from orbslam3_jax.atlas.atlas import Atlas
        from orbslam3_jax.pipeline.tracking import TrackState

        atlas = Atlas.load(path)
        act = atlas.active
        self._attach_store(act)
        if self.loop_closer is not None:
            self._reindex_kfdb(self.loop_closer.kfdb, act)
        if self.multimap is not None:
            self.multimap.atlas = atlas
            self.multimap.kfdbs = {}
            for m in atlas.maps:
                self._reindex_kfdb(self.multimap._kfdb(m), m)
        tr = self.tracker
        tr.last_frame = None
        tr.init_frame = None
        tr.ref_kf = -1
        tr.last_kf_id = -1
        tr.velocity = None
        tr.pre_from_kf = None
        tr.frame_prior = None
        tr.imu_ready = bool(atlas.imu_initialized) and tr.imu_calib is not None
        tr.state = (
            TrackState.LOST if act.n_kf > 0 else TrackState.NOT_INITIALIZED
        )

    @staticmethod
    def _reindex_kfdb(db, store):
        s = store.state
        kf_valid = np.asarray(s.kf_valid)
        desc = np.asarray(s.kf_desc)
        fvalid = np.asarray(s.kf_feat_valid)
        for k in range(store.n_kf):
            if kf_valid[k]:
                db.add(k, jnp.asarray(desc[k]), jnp.asarray(fvalid[k]))

    def save_trajectory_tum(self, path: str):
        """Ref `System::SaveTrajectoryTUM` / `SaveTrajectoryEuRoC`."""
        rows = self.tracker.reconstructed_trajectory()
        traj_io.save_tum(path, [r[0] for r in rows], [r[1] for r in rows], [r[2] for r in rows])

    def save_trajectory_kitti(self, path: str):
        """Ref `System::SaveTrajectoryKITTI` (`System.h:158`): one 3x4
        row-major Twc per line, frame order."""
        rows = self.tracker.reconstructed_trajectory()
        traj_io.save_kitti(path, [r[1] for r in rows], [r[2] for r in rows])

    def save_trajectory_euroc(self, path: str):
        """Ref `System::SaveTrajectoryEuRoC` (`System.cc:599-645`):

        * select the LARGEST Atlas map (by keyframe count) and export
          only frames tracked in it (`System.cc:609-621,684`);
        * re-root so the largest map's first keyframe is the origin
          (after loop closure / merge it may not be, `System.cc:624-630`);
        * inertial modes write BODY-frame poses through Tbc
          (`System.cc:698-703`), pure-visual modes camera-frame.

        The reference's bad-KF parent-chain walk at export
        (`System.cc:677-682`) is unnecessary here: the tracker re-roots
        trajectory entries eagerly when their reference KF is culled
        (`tracking.py` cull re-rooting), so every entry's `ref` is live."""
        maps = ([self.store] if self.multimap is None
                else list(self.multimap.atlas.maps))
        big = max(maps, key=lambda m: int(
            np.asarray(m.state.kf_valid[: max(m.n_kf, 1)]).sum()))
        kv = np.asarray(big.state.kf_valid)[: big.n_kf]
        if not kv.any():
            open(path, "w").close()
            return
        first = int(np.flatnonzero(kv)[0])
        kf_R = np.asarray(big.state.kf_R)
        kf_t = np.asarray(big.state.kf_t)
        # T_w0 of the first KF: new world frame (GetPoseInverse analog).
        R0wc = kf_R[first].T
        t0wc = -R0wc @ kf_t[first]
        tr = self.tracker
        inertial = tr.imu_calib is not None
        if inertial:
            Rbc, tbc = tr.Rbc, tr.tbc
        rows_ts, rows_R, rows_t = [], [], []
        for ts, store_e, ref, R_cr, t_cr in tr.trajectory:
            if store_e is not big:
                continue
            if ref >= 0:
                R_cw = R_cr @ kf_R[ref]
                t_cw = R_cr @ kf_t[ref] + t_cr
            else:
                R_cw, t_cw = R_cr, t_cr
            # Re-root: Tcw' = Tcw * Twc(first).
            R_cw2 = R_cw @ R0wc
            t_cw2 = R_cw @ t0wc + t_cw
            if inertial:
                R_bw = Rbc @ R_cw2
                t_bw = Rbc @ t_cw2 + tbc
                Rw = R_bw.T
                rows_R.append(Rw)
                rows_t.append(-Rw @ t_bw)
            else:
                Rw = R_cw2.T
                rows_R.append(Rw)
                rows_t.append(-Rw @ t_cw2)
            rows_ts.append(ts)
        traj_io.save_euroc(path, rows_ts, rows_R, rows_t)

    def save_keyframe_trajectory_tum(self, path: str):
        s = self.store.state
        valid = np.asarray(s.kf_valid)
        ids = np.flatnonzero(valid[: self.store.n_kf])
        kf_R = np.asarray(s.kf_R)
        kf_t = np.asarray(s.kf_t)
        Rwc = [kf_R[i].T for i in ids]
        twc = [-kf_R[i].T @ kf_t[i] for i in ids]
        traj_io.save_tum(path, self.store.kf_ts[ids], Rwc, twc)

    def save_keyframe_trajectory_euroc(self, path: str):
        """Ref `System::SaveKeyFrameTrajectoryEuRoC` (`System.cc:722`):
        largest-map keyframes in id order, EuRoC row format (body frame
        for inertial sensors)."""
        maps = ([self.store] if self.multimap is None
                else list(self.multimap.atlas.maps))
        big = max(maps, key=lambda m: int(
            np.asarray(m.state.kf_valid[: max(m.n_kf, 1)]).sum()))
        s = big.state
        ids = np.flatnonzero(np.asarray(s.kf_valid)[: big.n_kf])
        kf_R = np.asarray(s.kf_R)
        kf_t = np.asarray(s.kf_t)
        tr = self.tracker
        Rwl, twl = [], []
        for i in ids:
            if tr.imu_calib is not None:
                R_bw = tr.Rbc @ kf_R[i]
                t_bw = tr.Rbc @ kf_t[i] + tr.tbc
                Rwl.append(R_bw.T)
                twl.append(-R_bw.T @ t_bw)
            else:
                Rwl.append(kf_R[i].T)
                twl.append(-kf_R[i].T @ kf_t[i])
        traj_io.save_euroc(path, big.kf_ts[ids], Rwl, twl)
