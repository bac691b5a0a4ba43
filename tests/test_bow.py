import jax.numpy as jnp
import numpy as np
import pytest

from orbslam3_jax.ops import bow


@pytest.fixture(scope="module")
def vocab():
    rng = np.random.default_rng(1)
    # Training descriptors: 20 clusters with bit-flip noise.
    protos = rng.integers(0, 256, size=(20, 32), dtype=np.uint8)
    descs = []
    for p in protos:
        for _ in range(50):
            d = p.copy()
            flips = rng.integers(0, 32, size=6)
            d[flips] ^= rng.integers(1, 255, size=6).astype(np.uint8)
            descs.append(d)
    return bow.build_vocabulary(np.stack(descs), k=5, depth=3, seed=0), protos


def test_vocab_structure(vocab):
    voc, _ = vocab
    assert voc.n_words > 10
    # Children table consistent: root has children.
    assert int((voc.node_children[0] >= 0).sum()) > 0
    # Every leaf has a word id.
    leaves = ~np.any(np.asarray(voc.node_children) >= 0, axis=1)
    leaves[0] = False
    assert (np.asarray(voc.node_word)[leaves] >= 0).all()


def test_transform_deterministic(vocab):
    voc, protos = vocab
    d = jnp.asarray(protos)
    v = jnp.ones(len(protos), bool)
    w1 = np.asarray(bow.transform(voc, d, v))
    w2 = np.asarray(bow.transform(voc, d, v))
    np.testing.assert_array_equal(w1, w2)
    assert (w1 >= 0).all()


def test_similar_images_score_high(vocab):
    voc, protos = vocab
    rng = np.random.default_rng(2)

    def noisy_set(protos, n=30):
        out = []
        for _ in range(n):
            d = protos[rng.integers(0, len(protos))].copy()
            d[rng.integers(0, 32)] ^= 1
            out.append(d)
        return np.stack(out)

    # Two "images" from the same scene (same protos), one from inverted protos.
    imgA = noisy_set(protos[:10])
    imgB = noisy_set(protos[:10])
    imgC = noisy_set(~protos[10:])
    vecs = []
    for img in (imgA, imgB, imgC):
        words = bow.transform(voc, jnp.asarray(img), jnp.ones(len(img), bool))
        vecs.append(bow.bow_vector(voc, words))
    db = jnp.stack(vecs[1:])
    s = np.asarray(bow.score_l1(vecs[0], db))
    assert s[0] > s[1] + 0.15, s
    assert 0.0 <= s.min() and s.max() <= 1.0 + 1e-6


def test_invalid_descriptors_ignored(vocab):
    voc, protos = vocab
    d = jnp.asarray(protos[:8])
    valid = jnp.asarray([True] * 4 + [False] * 4)
    words = np.asarray(bow.transform(voc, d, valid))
    assert (words[4:] == -1).all()
    vec = np.asarray(bow.bow_vector(voc, jnp.asarray(words)))
    np.testing.assert_allclose(vec.sum(), 1.0, atol=1e-5)
