"""Place-recognition recall with a vocabulary trained on DIFFERENT
scenes than the ones queried — the reference ships an offline ~1M-word
ORBvoc trained on unrelated imagery (`/root/reference/README.md:17-19`,
`Thirdparty/DBoW2`), so its KeyFrameDatabase must generalize. Round-2
review flagged that our in-sequence-trained vocab never proved held-out
recall; this test trains on scenes A/B and runs relocalization-style
queries on scene C."""

import numpy as np
import jax.numpy as jnp
import pytest

from orbslam3_jax.ops import bow
from orbslam3_jax.ops import cameras as cam
from orbslam3_jax.ops import features as feat

from test_e2e_mono import H, W, FOCAL, make_world, render, camera_path


def _scene(seed):
    rng = np.random.default_rng(seed)
    params = cam.make_pinhole(FOCAL, FOCAL, W / 2, H / 2)
    pts, shades = make_world(rng)
    return params, pts, shades


def _extract(params, pts, shades, R, t, orb):
    img = render(params, R, t, pts, shades)
    f = feat.extract(jnp.asarray(img.astype(np.float32)), orb)
    return np.asarray(f.desc), np.asarray(f.valid)


def _scene_descs(seed, n_frames=8, orb=None):
    """Render a synthetic scene and return per-frame descriptor sets."""
    params, pts, shades = _scene(seed)
    return [
        _extract(params, pts, shades, R, t, orb)
        for (R, t) in camera_path(n_frames)
    ]


@pytest.mark.slow
def test_heldout_scene_recall():
    orb = feat.OrbParams(n_features=400, n_levels=3)
    # Train on two scenes the query scene never sees.
    train = []
    for seed in (11, 22):
        for d, v in _scene_descs(seed, n_frames=6, orb=orb):
            train.append(d[v])
    voc = bow.build_vocabulary(np.concatenate(train), k=10, depth=3, seed=0)

    # Held-out scene: index its frames' BoW vectors, query each frame —
    # the true match (itself / its neighbors) must rank first among all
    # frames of TWO distractor scenes plus its own.
    held = _scene_descs(33, n_frames=8, orb=orb)
    distract = _scene_descs(44, n_frames=8, orb=orb) + _scene_descs(
        55, n_frames=8, orb=orb
    )
    db = []
    for d, v in held + distract:
        words = bow.transform(voc, jnp.asarray(d), jnp.asarray(v))
        db.append(np.asarray(bow.bow_vector(voc, words)))
    db = np.stack(db)  # (24, n_words)

    # Queries: RE-RENDERED views of the held-out scene from genuinely
    # shifted + rotated cameras (never-indexed poses — real viewpoint
    # change, not descriptor dropout; round-3 review flagged the dropout
    # shortcut as under-perturbing). ~4 deg extra yaw/pitch and a lateral/
    # depth offset relative to the indexed path.
    from orbslam3_jax.ops import lie

    params, pts, shades = _scene(33)
    path = camera_path(8)
    hits = 0
    qrng = np.random.default_rng(7)
    for qi in range(len(held)):
        R0, t0 = path[qi]
        dR = np.asarray(lie.exp_so3(jnp.asarray(
            qrng.uniform(-0.07, 0.07, 3).astype(np.float32)
        )))
        Rq = (dR @ R0).astype(np.float32)
        center0 = -R0.T @ t0
        centerq = center0 + qrng.uniform(-0.12, 0.12, 3).astype(np.float32)
        tq = (-Rq @ centerq).astype(np.float32)
        d, v = _extract(params, pts, shades, Rq, tq, orb)
        words = bow.transform(voc, jnp.asarray(d), jnp.asarray(v))
        q = np.asarray(bow.bow_vector(voc, words))
        scores = np.asarray(bow.score_l1(jnp.asarray(q), jnp.asarray(db)))
        best = int(np.argmax(scores))
        # Top hit must be a frame of the SAME (held-out) scene.
        if best < len(held):
            hits += 1
    # Recall >= 7/8 on the held-out scene with an unrelated vocabulary,
    # under true viewpoint change.
    assert hits >= 7, hits
