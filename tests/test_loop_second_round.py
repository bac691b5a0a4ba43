"""Second-round Sim3 verification (`LoopClosing.cc:763-840`): after the
RANSAC + first OptimizeSim3, the reference re-matches by GUIDED PROJECTION
under the Sim3 over the candidate's covisibility-window point cloud,
re-optimizes on the augmented set, and applies the tight nProjOptMatches
gate. A marginal-overlap closure (few direct KF<->KF matches but plenty of
overlap through the candidate's covisible neighbors) must be ACCEPTED by
recruiting the cloud — and the same marginal pair WITHOUT cloud support
must stay rejected (no new false positives)."""

import numpy as np
import jax.numpy as jnp
import pytest

from orbslam3_jax.atlas import store as st
from orbslam3_jax.ops import cameras as cam
from orbslam3_jax.ops import features as feat
from orbslam3_jax.pipeline.loop_closing import LoopCloser

NF = 512
W, H = 320, 240
PARAMS = cam.make_pinhole(300.0, 300.0, W / 2, H / 2)


def _project(R, t, X):
    Xc = X @ R.T + t
    uv = np.asarray(cam.project(cam.CameraModel.PINHOLE, PARAMS, jnp.asarray(Xc)))
    return uv.astype(np.float32), Xc


def _add_kf(store, slot_pose, pt_ids, pts, descs, prev=-1):
    R, t = slot_pose
    slot = store.alloc_kf()
    n = len(pt_ids)
    assert n <= NF
    uv, Xc = _project(R, t, pts[pt_ids])
    assert (Xc[:, 2] > 0.1).all()
    uv_pad = np.zeros((NF, 2), np.float32)
    uv_pad[:n] = uv
    desc_pad = np.zeros((NF, 32), np.uint8)
    desc_pad[:n] = descs[pt_ids]
    assoc = np.full(NF, -1, np.int32)
    assoc[:n] = pt_ids
    fv = np.zeros(NF, bool)
    fv[:n] = True
    store.state = st.add_keyframe(
        store.state, slot, jnp.asarray(R.astype(np.float32)),
        jnp.asarray(t.astype(np.float32)),
        jnp.asarray(uv_pad), jnp.full(NF, -1.0), jnp.zeros(NF, jnp.int32),
        jnp.zeros(NF), jnp.asarray(desc_pad), jnp.asarray(fv),
        jnp.asarray(assoc), prev_kf=prev,
    )
    store.kf_ts[slot] = float(slot)
    return slot


def _make_scene(rng, cloud_support: bool):
    """KFs: 0=cand, 1..2=cand's covisibles, 3=current. Direct
    cand<->current overlap is MARGINAL (22 points); the covisibles see
    120 more of the current KF's points IFF cloud_support."""
    n_total = 600
    pts = np.stack([
        rng.uniform(-2.5, 2.5, n_total), rng.uniform(-1.8, 1.8, n_total),
        rng.uniform(5.0, 9.0, n_total),
    ], -1).astype(np.float32)
    descs = rng.integers(0, 256, (n_total, 32), dtype=np.uint8)

    cur_ids = np.arange(0, 300)           # points the CURRENT KF sees
    shared_direct = cur_ids[:22]          # also seen by cand (marginal)
    shared_via_cov = cur_ids[100:220]     # seen by cand's covisibles
    cand_own = np.arange(300, 450)        # cand-only points
    far_ids = np.arange(450, 600)         # unrelated (no-support case)

    store = st.MapStore(Kmax=8, Pmax=1024, Nf=NF)
    slots = store.alloc_mps(n_total)
    assert (np.asarray(slots) == np.arange(n_total)).all()
    store.state = st.add_points(
        store.state, jnp.asarray(slots), jnp.asarray(pts),
        jnp.asarray(descs), jnp.zeros((n_total, 3)),
        jnp.zeros(n_total), jnp.full(n_total, 100.0),
        jnp.zeros(n_total, jnp.int32), jnp.ones(n_total, bool),
    )

    I = np.eye(3)
    t_cand = np.asarray([0.3, 0.0, 0.0])
    t_cov = np.asarray([0.25, 0.05, 0.0])
    t_cur = np.asarray([0.0, 0.0, 0.0])
    cov_sees = shared_via_cov if cloud_support else far_ids[:120]
    k_cand = _add_kf(store, (I, t_cand),
                     np.concatenate([shared_direct, cand_own]), pts, descs)
    prev = k_cand
    for _ in range(2):
        k = _add_kf(store, (I, t_cov),
                    np.concatenate([cand_own[:60], cov_sees]), pts, descs,
                    prev=prev)
        prev = k
    k_cur = _add_kf(store, (I, t_cur), cur_ids, pts, descs, prev=prev)
    return store, k_cand, k_cur, (t_cand, t_cur)


def _closer(store):
    orb = feat.OrbParams(n_features=NF, n_levels=4)
    return LoopCloser(
        cam.CameraModel.PINHOLE, PARAMS, store, kfdb=None,
        sigma2_table=jnp.asarray(feat.sigma2(orb)),
        img_wh=jnp.asarray([float(W), float(H)]), consecutive=1,
    )


def test_marginal_closure_accepted_via_cloud(rng):
    store, k_cand, k_cur, (t_cand, t_cur) = _make_scene(rng, cloud_support=True)
    lc = _closer(store)
    out = lc._verify_sim3_impl(k_cur, k_cand)
    assert out is not None, (
        "second-round projection over the covisibility cloud must rescue "
        "the marginal closure (22 direct matches < the 26-point scaled "
        "nProjMatches gate)")
    R21, t21, s21 = out
    # Exact-geometry scene: S21 = relative pose cand<-cur, scale 1.
    np.testing.assert_allclose(s21, 1.0, atol=0.02)
    np.testing.assert_allclose(R21, np.eye(3), atol=0.02)
    np.testing.assert_allclose(t21, t_cand - t_cur, atol=0.05)


def test_marginal_closure_rejected_without_cloud(rng):
    store, k_cand, k_cur, _ = _make_scene(rng, cloud_support=False)
    lc = _closer(store)
    out = lc._verify_sim3_impl(k_cur, k_cand)
    assert out is None, (
        "22 direct matches with no covisibility-cloud support must not "
        "pass the nProjMatches/nProjOptMatches gates (false positive)")
