import jax.numpy as jnp
import numpy as np
import pytest

from orbslam3_jax.ops import features as feat
from orbslam3_jax.ops import matching


def synthetic_corners(rng, H=240, W=320, n=40, half=4):
    """Image with bright axis-aligned squares on dark background: strong
    corners at the 4 square corners."""
    img = np.full((H, W), 30.0, np.float32)
    centers = []
    m = feat.EDGE_THRESHOLD + 10
    for _ in range(n):
        y = rng.integers(m, H - m)
        x = rng.integers(m, W - m)
        img[y - half : y + half, x - half : x + half] = 220.0
        centers.append((x, y))
    return img, np.array(centers)


SMALL = feat.OrbParams(n_features=300, n_levels=4)


def test_fast_finds_square_corners(rng):
    img, centers = synthetic_corners(rng)
    f = feat.extract(jnp.asarray(img), SMALL)
    uv = np.asarray(f.uv)[np.asarray(f.valid)]
    assert len(uv) > 30
    # Each detected keypoint at octave 0 should be near some square corner.
    oct0 = uv[np.asarray(f.octave)[np.asarray(f.valid)] == 0]
    sq_corners = []
    for cx, cy in centers:
        for dx in (-4, 3):
            for dy in (-4, 3):
                sq_corners.append((cx + dx, cy + dy))
    sq = np.array(sq_corners)
    d = np.linalg.norm(oct0[:, None, :] - sq[None, :, :], axis=-1).min(axis=1)
    assert np.median(d) < 3.0


def test_no_keypoints_on_blank_image():
    img = jnp.full((240, 320), 128.0)
    f = feat.extract(img, SMALL)
    assert int(np.sum(np.asarray(f.valid))) == 0


def test_budget_respected(rng):
    img, _ = synthetic_corners(rng, n=80)
    f = feat.extract(jnp.asarray(img), SMALL)
    assert f.uv.shape[0] == sum(feat.level_budgets(SMALL))
    assert int(np.asarray(f.valid).sum()) <= SMALL.n_features + 8


def test_descriptors_match_across_translation(rng):
    """Same scene shifted by 8px: descriptors of corresponding corners
    should match with low Hamming distance."""
    img, _ = synthetic_corners(rng, n=30)
    shift = 8
    img2 = np.roll(img, shift, axis=1)
    f1 = feat.extract(jnp.asarray(img), SMALL)
    f2 = feat.extract(jnp.asarray(img2), SMALL)
    m = matching.match_nn(f1.desc, f2.desc, f1.valid, f2.valid, max_dist=40, ratio=0.8)
    uv1 = np.asarray(f1.uv)
    uv2 = np.asarray(f2.uv)
    ok = np.asarray(m.valid)
    assert ok.sum() >= 20
    # Matched displacement should be ~ (shift, 0)
    disp = uv2[np.asarray(m.idx)[ok]] - uv1[ok]
    med = np.median(disp, axis=0)
    np.testing.assert_allclose(med, [shift, 0.0], atol=1.0)


def test_hamming_matmul_equals_xor(rng):
    a = jnp.asarray(rng.integers(0, 256, size=(64, 32), dtype=np.uint8))
    b = jnp.asarray(rng.integers(0, 256, size=(96, 32), dtype=np.uint8))
    d1 = np.asarray(matching.hamming_matrix(a, b))
    d2 = np.asarray(matching.hamming_matrix_xor(a, b))
    np.testing.assert_array_equal(d1, d2)


def test_match_nn_permutation(rng):
    a = jnp.asarray(rng.integers(0, 256, size=(50, 32), dtype=np.uint8))
    perm = rng.permutation(50)
    b = a[jnp.asarray(perm)]
    m = matching.match_nn(a, b, max_dist=0, ratio=1.0)
    # Every descriptor should find its permuted twin.
    assert np.asarray(m.valid).all()
    np.testing.assert_array_equal(np.asarray(m.idx), np.argsort(perm))


def test_window_mask():
    uv_q = jnp.asarray([[10.0, 10.0], [100.0, 100.0]])
    uv_k = jnp.asarray([[12.0, 9.0], [80.0, 100.0], [101.0, 99.0]])
    m = np.asarray(matching.window_mask(uv_q, uv_k, 5.0))
    assert m.tolist() == [[True, False, False], [False, False, True]]


def test_assign_unique(rng):
    # Two rows matched to same column: only the closer one survives.
    m = matching.Matches(
        idx=jnp.asarray([2, 2, 1]),
        dist=jnp.asarray([10.0, 5.0, 3.0]),
        valid=jnp.asarray([True, True, True]),
    )
    out = matching.assign_unique(m, 4)
    assert np.asarray(out.valid).tolist() == [False, True, True]
