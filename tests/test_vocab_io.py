import numpy as np
import jax.numpy as jnp
import pytest

from orbslam3_jax.io import vocab_io
from orbslam3_jax.io.native import get_lib
from orbslam3_jax.ops import bow


@pytest.fixture(scope="module")
def vocab():
    rng = np.random.default_rng(5)
    descs = rng.integers(0, 256, (600, 32), dtype=np.uint8)
    return bow.build_vocabulary(descs, k=4, depth=3, seed=1)


def test_native_lib_builds():
    lib = get_lib()
    assert lib is not None, "g++ native build failed"


def test_binary_roundtrip(tmp_path, vocab):
    path = str(tmp_path / "voc.bin")
    vocab_io.save_binary_vocabulary(path, vocab)
    voc2 = vocab_io.load_binary_vocabulary(path)
    assert voc2.k == vocab.k and voc2.depth == vocab.depth
    assert voc2.n_words == vocab.n_words
    # Same transform results on random descriptors.
    rng = np.random.default_rng(6)
    d = jnp.asarray(rng.integers(0, 256, (64, 32), dtype=np.uint8))
    v = jnp.ones(64, bool)
    w1 = np.asarray(bow.transform(vocab, d, v))
    w2 = np.asarray(bow.transform(voc2, d, v))
    np.testing.assert_array_equal(w1, w2)


def test_numpy_fallback_reader(tmp_path, vocab):
    path = str(tmp_path / "voc2.bin")
    vocab_io.save_binary_vocabulary(path, vocab)
    k, L, parent, desc, weight, leaf = vocab_io._read_binary_numpy(path)
    k2, L2, parent2, desc2, weight2, leaf2 = vocab_io._read_binary_native(path)
    np.testing.assert_array_equal(parent, parent2)
    np.testing.assert_array_equal(desc, desc2)
    np.testing.assert_array_equal(leaf, leaf2)
    np.testing.assert_allclose(weight, weight2)


def test_native_csv_parser(tmp_path):
    lib = get_lib()
    if lib is None:
        pytest.skip("no native lib")
    import ctypes

    path = tmp_path / "imu.csv"
    path.write_text(
        "#ts,wx,wy,wz,ax,ay,az\n"
        "1403636579758555392,-0.1,0.2,0.3,9.8,-0.1,0.05\n"
        "1403636579763555584,-0.2,0.1,0.25,9.7,0.0,0.06\n"
    )
    ts = np.zeros(10, np.int64)
    vals = np.zeros((10, 6), np.float64)
    n = lib.parse_sensor_csv(
        str(path).encode(), 6,
        ts.ctypes.data_as(ctypes.POINTER(ctypes.c_int64)),
        vals.ctypes.data_as(ctypes.POINTER(ctypes.c_double)),
        10,
    )
    assert n == 2
    assert ts[0] == 1403636579758555392
    np.testing.assert_allclose(vals[1], [-0.2, 0.1, 0.25, 9.7, 0.0, 0.06])
