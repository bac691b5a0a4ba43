"""Loop closing: place recognition -> Sim3 verification -> graph correction.

Re-design of `/root/reference/src/LoopClosing.cc` (same-map loop path;
multi-map merge lands with the Atlas). Stage mapping:

* candidate fetch           -> `atlas.kfdb.detect_candidates`
  (`KeyFrameDatabase::DetectNBestCandidates`, `LoopClosing.cc:513`)
* geometric verification    -> Hamming match of KF vs candidate window +
  batched Horn Sim3 RANSAC (`Sim3Solver`, `LoopClosing.cc:746`) +
  guided-projection count gates (`:633-637`: nBoWMatches=20,
  nSim3Inliers=20, nProjMatches=50 scaled down for our smaller feature
  budget at test time)
* correction                -> Sim3 pose graph (`OptimizeEssentialGraph`
  via `optim.pose_graph`) + map-point re-expression (`CorrectLoop`
  `LoopClosing.cc:1093-1330`), then full BA
  (`RunGlobalBundleAdjustment`, `:2513`).

Robustness machinery (ref `LoopClosing.cc`):

* 3-consecutive-confirmation temporal consistency (`:367`,
  `DetectAndReffineSim3FromLastKF:564`): a geometrically verified
  candidate only arms a *pending region*; the next keyframes must
  re-verify against the same covisible region before the correction
  fires (`consecutive` param; 1 = fire immediately, for tiny tests).
* `SearchAndFuse` (`:1259`) after the pose-graph correction: loop-side
  map points are projected into the current-side window and duplicate
  landmarks are replaced keeping the most-observed point.
* 4-DoF essential graph (`OptimizeEssentialGraph4DoF`,
  `Optimizer.cc:8604`) when the map is inertial (gravity + scale are
  observable -> only yaw + translation drift), 7-DoF Sim3 otherwise.
"""

from __future__ import annotations

import functools
from typing import Optional

import jax
import jax.numpy as jnp
import numpy as np

from orbslam3_jax.atlas import store as st
from orbslam3_jax.atlas.kfdb import KeyFrameDB
from orbslam3_jax.utils import timing
from orbslam3_jax.ops import cameras as cam
from orbslam3_jax.ops import lie, matching, ransac
from orbslam3_jax.optim import ba as ba_mod
from orbslam3_jax.optim import pose_graph as pg


class LoopCloser:
    def __init__(
        self,
        model: cam.CameraModel,
        params: jnp.ndarray,
        store: st.MapStore,
        kfdb: KeyFrameDB,
        sigma2_table: jnp.ndarray,
        min_bow_matches: int = 20,
        min_sim3_inliers: int = 20,
        min_kfs: int = 12,
        run_gba: bool = True,
        consecutive: int = 3,
        inertial: bool = False,
        img_wh=None,
        scale_table=None,
        mapper=None,
        bf: float = 0.0,
    ):
        self.model = model
        self.params = params
        self.store = store
        self.kfdb = kfdb
        self.sigma2_table = sigma2_table
        # Stereo baseline*fx: the virtual-stereo residual ur_hat = u - bf/z
        # in global BA needs it on rectified-stereo maps (AsyncGBA gets it
        # at construction; the synchronous fallback here must match).
        self.bf = bf
        self.min_bow_matches = min_bow_matches
        self.min_sim3_inliers = min_sim3_inliers
        self.min_kfs = min_kfs
        self.run_gba = run_gba
        self.consecutive = consecutive
        self.inertial = inertial
        self.img_wh = img_wh
        self.scale_table = scale_table
        self.mapper = mapper  # for purge_freed after SearchAndFuse
        self.last_loop_kf = -10_000
        # Persistent loop edges (ref `KeyFrame::AddLoopEdge`,
        # `KeyFrame.h:316-330`): every accepted closure's measured Sim3
        # constrains ALL subsequent essential-graph solves, not just the
        # one that created it.
        self.loop_edges = []  # [(kf_i, kf_j, R21, t21, s21), ...]
        self.n_loops_closed = 0
        # Background interruptible GBA (ref transient thread,
        # `LoopClosing.cc:1323`); None = synchronous fallback.
        self.gba_async = None
        # DistributedContext: point-partitioned GBA over a mesh (config 5).
        self.dist = None
        # Observability hook: called as on_correction(phase, kf_id,
        # loop_kf) with phase "before"/"after" around the essential-graph
        # correction — lets replays report ATE deltas per closure.
        self.on_correction = None
        # Pending region for temporal consistency: (loop_kf, count,
        # last confirming kf). Ref mnLoopNumCoincidences
        # (`LoopClosing.cc:345-475`).
        self._pending: Optional[tuple] = None

    # ------------------------------------------------------------------
    def process_keyframe(self, kf_id: int) -> bool:
        """Returns True if a loop was closed at this keyframe."""
        s = self.store.state
        kf_j = jnp.asarray(kf_id)
        self.kfdb.add(kf_id, s.kf_desc[kf_j], s.kf_feat_valid[kf_j])
        if self.store.n_kf < self.min_kfs:  # ref guard LoopClosing.cc:331
            return False
        if kf_id - self.last_loop_kf < 10:  # cool-down after a closure
            return False
        with timing.span("loop/covis+query"):
            covis_np = self.store.covisibility_np()
            covis = jnp.asarray(covis_np)
            cand_ids, cand_scores = self.kfdb.query(kf_id, covis)
        for c in np.asarray(cand_ids):
            if c < 0 or c == kf_id:
                continue
            # Temporal guard: candidates too close in time are not loops.
            if abs(int(c) - kf_id) < 10:
                continue
            verdict = self._verify_sim3(kf_id, int(c))
            if verdict is None:
                continue
            R21, t21, s21 = verdict
            if self._confirm(kf_id, int(c), covis_np):
                self._correct_loop(kf_id, int(c), R21, t21, s21)
                self._pending = None
                self.last_loop_kf = kf_id
                self.n_loops_closed += 1
                return True
            return False  # armed/extended the pending region this KF
        # No candidate verified this KF: a pending region that missed a
        # beat is dropped (ref resets mnLoopNumCoincidences via
        # mnLoopNumNotFound, `LoopClosing.cc:456-470`).
        if self._pending is not None and kf_id - self._pending[2] >= 2:
            self._pending = None
        return False

    # ------------------------------------------------------------------
    def _confirm(self, kf_id: int, cand: int, covis_np) -> bool:
        """Temporal-consistency accounting (`LoopClosing.cc:367`): the
        verified (kf, cand) pair must hit the SAME loop region as the
        pending detection on `consecutive` consecutive keyframes."""
        if self.consecutive <= 1:
            return True
        if self._pending is not None:
            loop_kf, count, last_kf = self._pending
            same_region = (
                abs(cand - loop_kf) <= 15
                or covis_np[cand, loop_kf] >= 15
            )
            if same_region and kf_id > last_kf:
                count += 1
                self._pending = (cand, count, kf_id)
                return count >= self.consecutive
        self._pending = (cand, 1, kf_id)
        return 1 >= self.consecutive

    # ------------------------------------------------------------------
    def _verify_sim3(self, kf_id: int, cand: int):
        with timing.span("loop/verify_sim3"):
            return self._verify_sim3_impl(kf_id, cand)

    def _verify_sim3_impl(self, kf_id: int, cand: int):
        s = self.store.state
        kf_j = jnp.asarray(kf_id)
        cd_j = jnp.asarray(cand)
        # 1) descriptor matches between the two KFs, restricted to features
        #    with map points (3D-3D pairs for Horn).
        mp1 = np.asarray(s.kf_mp[kf_j])
        mp2 = np.asarray(s.kf_mp[cd_j])
        has1 = jnp.asarray(mp1 >= 0) & s.kf_feat_valid[kf_j]
        has2 = jnp.asarray(mp2 >= 0) & s.kf_feat_valid[cd_j]
        m = matching.match_nn(
            s.kf_desc[kf_j], s.kf_desc[cd_j], has1, has2,
            max_dist=matching.TH_LOW, ratio=0.75, cross_check=True,
        )
        n_m = int(np.asarray(m.valid).sum())
        if n_m < self.min_bow_matches:
            return None

        # 2) Sim3 RANSAC on the matched 3D points, expressed in each KF's
        #    camera frame (ref Sim3Solver operates on camera-frame points).
        idx2 = np.asarray(m.idx)
        valid = np.asarray(m.valid)
        pts1_w = np.asarray(s.mp_pos)[np.clip(mp1, 0, None)]
        pts2_w = np.asarray(s.mp_pos)[np.clip(mp2[np.clip(idx2, 0, None)], 0, None)]
        R1, t1 = np.asarray(s.kf_R[kf_j]), np.asarray(s.kf_t[kf_j])
        R2, t2 = np.asarray(s.kf_R[cd_j]), np.asarray(s.kf_t[cd_j])
        X1 = (R1 @ pts1_w.T).T + t1  # in KF1 camera frame
        X2 = (R2 @ pts2_w.T).T + t2

        s2t = np.asarray(self.sigma2_table)
        oct1 = np.asarray(s.kf_octave[kf_j])
        oct2 = np.asarray(s.kf_octave[cd_j])[np.clip(idx2, 0, None)]
        err1 = 9.21 * s2t[np.clip(oct1, 0, len(s2t) - 1)]
        err2 = 9.21 * s2t[np.clip(oct2, 0, len(s2t) - 1)]
        uv1 = np.asarray(s.kf_uv[kf_j])
        uv2 = np.asarray(s.kf_uv[cd_j])[np.clip(idx2, 0, None)]

        model, params = self.model, self.params
        proj = lambda X: cam.project(model, params, X)
        ok, R12, t12, s12, inl = ransac.sim3_ransac(
            jnp.asarray(X1, jnp.float32), jnp.asarray(X2, jnp.float32),
            jnp.asarray(valid), jax.random.PRNGKey(kf_id),
            jnp.asarray(err1, jnp.float32), jnp.asarray(err2, jnp.float32),
            proj, proj, jnp.asarray(uv1, jnp.float32), jnp.asarray(uv2, jnp.float32),
            fix_scale=self.inertial, min_inliers=self.min_sim3_inliers,
        )
        if not bool(ok):
            return None

        # 3) Gauss-Newton Sim3 refinement on the matched pairs
        #    (`Optimizer::OptimizeSim3`, `Optimizer.cc:4111`; called from
        #    `LoopClosing.cc:758`): dual-reprojection polish + chi2
        #    re-gating, then the nSim3Inliers gate (`LoopClosing.cc:636`).
        from orbslam3_jax.optim import sim3 as sim3_mod

        s2_1 = s2t[np.clip(oct1, 0, len(s2t) - 1)]
        s2_2 = s2t[np.clip(oct2, 0, len(s2t) - 1)]
        ref = sim3_mod.optimize_sim3(
            self.model, self.params,
            jnp.asarray(R12), jnp.asarray(t12), jnp.asarray(s12),
            jnp.asarray(X1, jnp.float32), jnp.asarray(X2, jnp.float32),
            jnp.asarray(uv1, jnp.float32), jnp.asarray(uv2, jnp.float32),
            jnp.asarray(s2_1, jnp.float32), jnp.asarray(s2_2, jnp.float32),
            jnp.asarray(valid), fix_scale=self.inertial,
        )
        if int(ref.n_inliers) < self.min_sim3_inliers:
            return None

        # 4) SECOND ROUND (`LoopClosing.cc:763-840`): re-match by guided
        #    projection under the Sim3 over the CANDIDATE'S COVISIBILITY-
        #    WINDOW point cloud (5 best covisibles + cand,
        #    `LoopClosing.cc:765-789`), re-optimize the Sim3 on the
        #    AUGMENTED correspondence set, then apply the tight
        #    nProjOptMatches gate with the refined transform. This is the
        #    round that rescues marginal-overlap closures: the BoW match
        #    set alone under-samples the overlap, while the coarse-Sim3
        #    projection recruits every cloud point that lands on a
        #    matching KF1 feature.
        n_feat = s.kf_desc.shape[1]
        min_proj = max(self.min_sim3_inliers, int(round(50 * n_feat / 1000.0)))
        min_proj_opt = int(round(80 * n_feat / 1000.0))
        cloud = self._cov_window_points(cand, exclude=kf_id)
        mm, X1p, cloud_ok = self._sim3_projection_matches(
            kf_id, cloud, R2, t2, np.asarray(ref.R), np.asarray(ref.t),
            float(ref.s), radius=8.0, max_dist=matching.TH_HIGH,
        )
        n_coarse = int(np.asarray(mm.valid).sum())
        if n_coarse < min_proj:  # nProjMatches=50 gate (`:806`)
            return None

        # Augmented pairs indexed by KF1 feature: forward residual
        # (cloud point -> KF1 pixel) always; backward residual only when
        # the matched point is also OBSERVED in the candidate KF
        # (`OptimizeSim3` bAllPoints=true semantics, `Optimizer.cc:4255`).
        midx = np.asarray(mm.idx)  # per-cloud-point -> KF1 feature
        mval = np.asarray(mm.valid)
        Nf = n_feat
        a_X2 = np.zeros((Nf, 3), np.float32)
        a_uv2 = np.zeros((Nf, 2), np.float32)
        a_s2_2 = np.zeros(Nf, np.float32)  # 0 => forward-only pair
        a_valid = np.zeros(Nf, bool)
        feat_of = np.clip(midx, 0, Nf - 1)
        pts_w_cloud = np.asarray(s.mp_pos)[np.clip(cloud, 0, None)]
        X2_cloud = (R2 @ pts_w_cloud.T).T + t2
        a_X2[feat_of[mval]] = X2_cloud[mval]
        a_valid[feat_of[mval]] = True
        # Backward observations: cloud points present in the cand's row.
        slot_of_point = np.full(int(np.asarray(s.mp_pos).shape[0]), -1,
                                np.int64)
        slot_of_point[mp2[mp2 >= 0]] = np.flatnonzero(mp2 >= 0)
        cl_slot = slot_of_point[np.clip(cloud, 0, None)]
        has_bk = mval & (cl_slot >= 0)
        uv2_all = np.asarray(s.kf_uv[cd_j])
        oct2_all = np.asarray(s.kf_octave[cd_j])
        a_uv2[feat_of[has_bk]] = uv2_all[cl_slot[has_bk]]
        a_s2_2[feat_of[has_bk]] = s2t[
            np.clip(oct2_all[cl_slot[has_bk]], 0, len(s2t) - 1)]
        # X1 side: the KF1 feature's OWN map point (needed for the
        # backward residual; weightless where absent).
        own1 = mp1 >= 0
        X1_own = np.zeros((Nf, 3), np.float32)
        X1_own[own1] = (R1 @ np.asarray(s.mp_pos)[mp1[own1]].T).T + t1
        a_s2_2 = np.where(own1, a_s2_2, 0.0).astype(np.float32)
        a_s2_1 = s2t[np.clip(oct1, 0, len(s2t) - 1)].astype(np.float32)
        uv1_all = np.asarray(s.kf_uv[kf_j])

        ref2 = sim3_mod.optimize_sim3(
            self.model, self.params,
            jnp.asarray(ref.R), jnp.asarray(ref.t), jnp.asarray(float(ref.s)),
            jnp.asarray(X1_own), jnp.asarray(a_X2),
            jnp.asarray(uv1_all, jnp.float32), jnp.asarray(a_uv2),
            jnp.asarray(a_s2_1), jnp.asarray(a_s2_2),
            jnp.asarray(a_valid), fix_scale=self.inertial,
        )
        if int(ref2.n_inliers) < self.min_sim3_inliers:
            return None

        # Tight gate with the REFINED Sim3 (`LoopClosing.cc:826-832`:
        # th=5, ratio 1.0, nProjOptMatches=80 scaled to our budget).
        mm2, _, _ = self._sim3_projection_matches(
            kf_id, cloud, R2, t2, np.asarray(ref2.R), np.asarray(ref2.t),
            float(ref2.s), radius=5.0, max_dist=matching.TH_HIGH,
        )
        n_tight = int(np.asarray(mm2.valid).sum())
        if n_tight < min_proj_opt:
            return None
        # Sim3 mapping X2(cand camera) = S21(X1(cur camera)):
        # horn gave X2 ~= s R X1 + t, i.e. S21 = (R, t, s) refined.
        return np.asarray(ref2.R), np.asarray(ref2.t), float(ref2.s)

    def _cov_window_points(self, cand: int, n_cov: int = 5,
                           cap: int = 4096, exclude: int = -1) -> np.ndarray:
        """Unique valid map-point ids seen by `cand` and its `n_cov` best
        covisible keyframes (`LoopClosing.cc:765-789` point cloud).
        `exclude` (the CURRENT keyframe) is never part of the cloud: the
        reference filters the current KF's covisible group out at
        candidate selection (`DetectNBestCandidates` spConnectedKeyFrames)
        — a cloud containing the query's own points would make the
        projection gates self-certifying."""
        s = self.store.state
        covis = self.store.covisibility_np()
        nkf = self.store.n_kf
        row = covis[cand, :nkf].copy()
        row[cand] = 0
        if 0 <= exclude < nkf:
            row[exclude] = 0
        order = np.argsort(-row)
        kfs = [cand] + [int(k) for k in order[:n_cov]
                        if row[k] > 0 and int(k) != exclude]
        mp = np.asarray(s.kf_mp[jnp.asarray(np.asarray(kfs, np.int32))])
        fv = np.asarray(s.kf_feat_valid[jnp.asarray(np.asarray(kfs, np.int32))])
        ids = np.unique(mp[(mp >= 0) & fv])
        ids = ids[np.asarray(s.mp_valid)[ids]]
        return ids[:cap]

    def _sim3_projection_matches(
        self, kf_id: int, point_ids: np.ndarray, R2, t2, R21, t21, s21,
        radius: float = 8.0, max_dist: int = None,
    ):
        """Guided-projection matching of a point cloud through a Sim3
        into KF1 (`ORBmatcher::SearchByProjection` Sim3 overload,
        `ORBmatcher.cc:1455`, used by the nProjMatches /
        nProjOptMatches gates `LoopClosing.cc:806,832`): world points ->
        the cand camera frame (R2, t2) -> S21^-1 -> KF1 pixels, windowed
        Hamming match against KF1's features inside `radius`. Returns
        (match struct indexed by cloud point, projected KF1-frame
        coords, in-front/in-image mask)."""
        if max_dist is None:
            max_dist = matching.TH_HIGH
        s = self.store.state
        kf_j = jnp.asarray(kf_id)
        pid = np.asarray(point_ids)
        pts_w = np.asarray(s.mp_pos)[pid]
        ok = np.asarray(s.mp_valid)[pid]
        X2 = (R2 @ pts_w.T).T + t2
        X1 = (1.0 / s21) * ((X2 - t21) @ R21)  # S21^-1
        ok = ok & (X1[:, 2] > 0.05)
        uv = np.asarray(cam.project(self.model, self.params, jnp.asarray(X1)))
        if self.img_wh is not None:
            wh = np.asarray(self.img_wh)
            ok = ok & (uv[:, 0] >= 0) & (uv[:, 1] >= 0) \
                 & (uv[:, 0] < wh[0]) & (uv[:, 1] < wh[1])
        m = matching.search_by_projection(
            jnp.asarray(np.asarray(s.mp_desc)[pid]), jnp.asarray(uv),
            jnp.asarray(ok),
            s.kf_desc[kf_j], s.kf_uv[kf_j], s.kf_feat_valid[kf_j],
            radius=jnp.asarray(radius), max_dist=max_dist, ratio=1.0,
        )
        m = matching.assign_unique(m, int(s.kf_desc.shape[1]))
        return m, X1, ok

    # ------------------------------------------------------------------
    def _correct_loop(self, kf_id: int, loop_kf: int, R21, t21, s21):
        """`CorrectLoop` (`LoopClosing.cc:1093`) + essential graph +
        global BA. The corrected pose of the current KF:
        S_cur_w(corrected) = S21^-1 * S_loop_w ... more precisely the
        measured relative Sim3 gives the *drift-free* transform between
        the two camera frames; the pose graph spreads the discrepancy."""
        store = self.store
        s = store.state
        nkf = store.n_kf
        K = s.Kmax
        if self.on_correction is not None:
            self.on_correction("before", kf_id, loop_kf)

        # Vertices: current SE3 poses lifted to Sim3.
        Rk = s.kf_R
        tk = s.kf_t
        sk = jnp.ones(K)
        fixed = np.zeros(K, bool)
        fixed[loop_kf] = True
        fixed[nkf:] = True  # untouched slots
        kf_valid = np.asarray(s.kf_valid)
        fixed |= ~kf_valid

        # Edges: temporal chain + covisibility(>=30) + the loop edge.
        covis = self.store.covisibility_np()
        ei, ej = [], []
        ew = []
        for k in range(1, nkf):
            if kf_valid[k] and kf_valid[k - 1]:
                ei.append(k - 1); ej.append(k); ew.append(1.0)
        ii, jj = np.nonzero(np.triu(covis[:nkf, :nkf] >= 30, 2))
        for a, b in zip(ii, jj):
            if kf_valid[a] and kf_valid[b]:
                ei.append(a); ej.append(b); ew.append(1.0)
        # Loop edges: every PREVIOUS closure's measured Sim3 (persistent,
        # ref `KeyFrame::AddLoopEdge` `KeyFrame.h:316-330` — accumulated
        # in the graph across closures) + the new measurement.
        n_chain = len(ei)
        live_loops = [
            (a, b, Rm, tm, sm)
            for (a, b, ts_a, ts_b, Rm, tm, sm) in self.loop_edges
            if a < nkf and b < nkf and kf_valid[a] and kf_valid[b]
            # Slots are recycled after culling: the timestamp must still
            # identify the SAME keyframe the edge was measured between.
            and store.kf_ts[a] == ts_a and store.kf_ts[b] == ts_b
        ]
        for (a, b, _, _, _) in live_loops:
            ei.append(a); ej.append(b); ew.append(5.0)
        # The new loop edge with the measured Sim3: M_ji with i=cur,
        # j=loop: M_{loop,cur} = (R21, t21, s21).
        ei.append(kf_id); ej.append(loop_kf)
        ew.append(5.0)

        E = len(ei)
        ei = np.asarray(ei, np.int32)
        ej = np.asarray(ej, np.int32)
        eR = np.zeros((E, 3, 3), np.float32)
        et = np.zeros((E, 3), np.float32)
        es = np.ones(E, np.float32)
        Rn = np.asarray(s.kf_R)
        tn = np.asarray(s.kf_t)
        for n in range(n_chain):
            a, b = ei[n], ej[n]
            # M_ba = T_b T_a^-1 from current estimates.
            Rba = Rn[b] @ Rn[a].T
            tba = tn[b] - Rba @ tn[a]
            eR[n] = Rba
            et[n] = tba
        for k, (_, _, Rm, tm, sm) in enumerate(live_loops):
            eR[n_chain + k] = Rm
            et[n_chain + k] = tm
            es[n_chain + k] = sm
        eR[E - 1] = R21
        et[E - 1] = t21
        es[E - 1] = s21
        self.loop_edges.append(
            (int(kf_id), int(loop_kf),
             float(store.kf_ts[kf_id]), float(store.kf_ts[loop_kf]),
             np.asarray(R21, np.float32).copy(),
             np.asarray(t21, np.float32).copy(), float(s21))
        )

        graph = pg.PoseGraph(
            R=Rk, t=tk, s=sk, fixed=jnp.asarray(fixed),
            edge_i=jnp.asarray(ei), edge_j=jnp.asarray(ej),
            edge_R=jnp.asarray(eR), edge_t=jnp.asarray(et), edge_s=jnp.asarray(es),
            edge_valid=jnp.ones(E, bool), edge_weight=jnp.asarray(ew, np.float32),
        )
        R_old, t_old = s.kf_R, s.kf_t
        # Inertial maps: gravity + scale observable -> 4-DoF essential
        # graph (yaw + translation, unit scale; ref
        # `OptimizeEssentialGraph4DoF` `Optimizer.cc:8604`, chosen at
        # `LoopClosing.cc:1298`). Visual maps: full 7-DoF Sim3.
        R_new, t_new, s_new = pg.solve_pose_graph(
            graph, iters=12, dof4=self.inertial
        )

        # Map points: re-express through their reference (first) KF.
        ref = jnp.clip(s.mp_first_kf, 0, K - 1)
        newp = pg.correct_points(
            s.mp_pos,
            R_old[ref], t_old[ref], jnp.ones(s.Pmax),
            R_new[ref], t_new[ref], s_new[ref],
        )
        newp = jnp.where(s.mp_valid[:, None], newp, s.mp_pos)

        # Fold scale into SE3: Tcw = [R | t/s] (ref CorrectLoop :1158).
        t_se3 = t_new / s_new[:, None]
        store.state = s._replace(kf_R=R_new, kf_t=t_se3, mp_pos=newp)
        store.bump()
        if self.on_correction is not None:
            self.on_correction("after", kf_id, loop_kf)

        self._search_and_fuse(kf_id, loop_kf, covis)

        if self.run_gba:
            if self.gba_async is not None:
                # A new closure aborts any in-flight GBA and starts over
                # from the freshly corrected map (`LoopClosing.cc:1099-1118`).
                self.gba_async.abort()
                self.gba_async.start(self.store)
            else:
                self._global_ba(kf_id)

    # ------------------------------------------------------------------
    def _search_and_fuse(self, kf_id: int, loop_kf: int, covis):
        """`SearchAndFuse` (`LoopClosing.cc:1259`): after correction, the
        loop side and the current side overlap in space but hold
        duplicate landmarks. Project the loop window's map points into
        the current window's keyframes; replace duplicates keeping the
        most-observed point. Without this, duplicated points double-count
        observations and skew covisibility after every closure."""
        if self.img_wh is None:
            return  # not wired (legacy construction) — skip
        from orbslam3_jax.pipeline import local_mapping as lm

        store = self.store
        s = store.state
        nkf = store.n_kf
        cw = np.asarray(covis)

        def window(center, n):
            order = np.argsort(-cw[center][:nkf])
            w = [center] + [int(x) for x in order[:n] if cw[center][x] >= 15]
            return w

        cur_win = window(kf_id, 10)
        loop_win = window(loop_kf, 10)
        kf_mp = store.kf_mp_np()
        pool = np.unique(kf_mp[loop_win].reshape(-1))
        pool = pool[pool >= 0]
        if not len(pool):
            return
        conflicts_src, conflicts_dst = [], []
        CAP = 4096
        for tgt in cur_win:
            tgt_j = jnp.asarray(int(tgt))
            for start in range(0, len(pool), CAP):
                chunk = pool[start : start + CAP]
                pad = CAP - len(chunk)
                ids = np.concatenate([chunk, np.zeros(pad, chunk.dtype)])
                valid = np.concatenate(
                    [np.ones(len(chunk), bool), np.zeros(pad, bool)]
                )
                new_row, _n, inc, conf = lm.fuse_into_kf(
                    self.model, self.params, store.state, tgt_j,
                    jnp.asarray(ids, jnp.int32), jnp.asarray(valid),
                    jnp.asarray(self.img_wh), self.sigma2_table,
                )
                store.state = store.state._replace(
                    kf_mp=store.state.kf_mp.at[tgt_j].set(new_row)
                )
                conf = np.asarray(conf)
                if conf.any():
                    conflicts_src.append(ids.astype(np.int64)[conf])
                    conflicts_dst.append(np.asarray(inc)[conf])
        if conflicts_src:
            freed = lm.resolve_and_replace(
                store, conflicts_src, conflicts_dst, kf_id
            )
            if self.mapper is not None:
                self.mapper.purge_freed(freed)
            if self.scale_table is not None:
                row = np.asarray(store.state.kf_mp[jnp.asarray(kf_id)])
                st.refresh_points(store, row[row >= 0], self.scale_table)
        store.bump()

    def _global_ba(self, kf_id: int):
        """`RunGlobalBundleAdjustment` (`LoopClosing.cc:2513`): full BA,
        10 iterations, KF0 fixed. With a DistributedContext attached the
        solve is point-partitioned over its mesh (config 5)."""
        from orbslam3_jax.pipeline import gba as gba_mod

        s = self.store.state
        nkf = self.store.n_kf
        K = s.Kmax
        fixed = np.ones(K, bool)
        fixed[1:nkf] = ~np.asarray(s.kf_valid)[1:nkf]
        fixed[0] = True
        fixed_j = jnp.asarray(fixed)

        prob = gba_mod.build_gba_problem(s, fixed_j, self.sigma2_table)
        if self.dist is not None and self.dist.n_shards > 1:
            prob_s, _pn = self.dist.prep_ba(prob)
            res = self.dist.run_ba(
                self.model, self.params, prob_s, bf=self.bf,
                iters=10, pcg_iters=50,
            )
            res = res._replace(
                cam_R=jnp.asarray(self.dist.fetch(res.cam_R)),
                cam_t=jnp.asarray(self.dist.fetch(res.cam_t)),
                points=jnp.asarray(self.dist.fetch(res.points))[: s.Pmax],
            )
        else:
            res = ba_mod.solve_ba(
                self.model, self.params, prob, bf=self.bf, iters=10,
                pcg_iters=50,
                dense_schur=ba_mod.auto_dense_schur(
                    int(s.kf_R.shape[0]), int(s.mp_pos.shape[0])
                ),
            )
        self.store.state = s._replace(
            kf_R=jnp.where(fixed_j[:, None, None], s.kf_R, res.cam_R),
            kf_t=jnp.where(fixed_j[:, None], s.kf_t, res.cam_t),
            mp_pos=jnp.where(s.mp_valid[:, None], res.points, s.mp_pos),
        )
        self.store.bump()
