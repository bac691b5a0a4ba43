"""Backend handling: no CPU fallback, no interpret mode outside tests, the
compile-cache location, host fetches, and the GPU-only checks."""

import os
import subprocess
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest

from orbslam3_jax.utils import cache, fetch

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


@pytest.fixture
def restore_cache_dir():
    before = jax.config.jax_compilation_cache_dir
    yield
    jax.config.update("jax_compilation_cache_dir", before)


def test_compile_cache_honours_env(monkeypatch, tmp_path, restore_cache_dir):
    """With JAX_COMPILATION_CACHE_DIR set, JAX reads it itself and no
    directory is set in code."""
    jax.config.update("jax_compilation_cache_dir", None)
    monkeypatch.setenv("JAX_COMPILATION_CACHE_DIR", str(tmp_path))
    assert cache.enable_compile_cache() == str(tmp_path)
    assert jax.config.jax_compilation_cache_dir is None


def test_compile_cache_default_in_checkout(monkeypatch, restore_cache_dir):
    """Unset, the cache lands in `<checkout>/.jax_cache`, keyed on nothing
    about the host."""
    monkeypatch.delenv("JAX_COMPILATION_CACHE_DIR", raising=False)
    path = cache.enable_compile_cache()
    assert path == os.path.join(REPO, ".jax_cache")
    assert jax.config.jax_compilation_cache_dir == path


def test_dryrun_multichip_needs_devices():
    """Asking for more devices than exist raises instead of swapping in
    virtual CPU devices."""
    import __graft_entry__ as ge

    with pytest.raises(RuntimeError, match="needs 64 devices"):
        ge.dryrun_multichip(64)


def test_chip_smoke_fails_without_gpu(tmp_path):
    """On a CPU-only host chip_smoke.py exits non-zero and prints no ok
    line."""
    env = dict(os.environ, JAX_PLATFORMS="cpu")
    out = subprocess.run(
        [sys.executable, os.path.join(REPO, "chip_smoke.py")],
        capture_output=True, text=True, timeout=300, env=env, cwd=tmp_path,
    )
    assert out.returncode != 0
    assert '"ok"' not in out.stdout
    assert "no GPU" in out.stderr


def test_fetch_concurrent_tree():
    """`fetch` returns numpy leaves in the same structure, passes
    non-arrays through, and unwraps a single argument."""
    a = jnp.arange(6).reshape(2, 3)
    tree = {"a": a, "b": (jnp.ones(4), 3.5), "c": None}
    got = fetch.fetch(tree)
    assert isinstance(got["a"], np.ndarray) and got["b"][1] == 3.5
    np.testing.assert_array_equal(got["a"], np.arange(6).reshape(2, 3))
    x, y = fetch.fetch(a, jnp.zeros((300_000,), jnp.float32))
    assert x.shape == (2, 3) and y.shape == (300_000,) and not y.any()


@pytest.mark.gpu
def test_fused_kernel_compiled_on_gpu(gpu):
    """The kernel as compiled for the card equals the plain reference."""
    from orbslam3_jax.ops import matching
    from orbslam3_jax.ops import pallas_match as pm

    rng = np.random.default_rng(0)
    n, m = 5000, 1000
    dq = jnp.asarray(rng.integers(0, 256, (n, 32), dtype=np.uint8))
    dk = jnp.asarray(rng.integers(0, 256, (m, 32), dtype=np.uint8))
    vk = jnp.asarray(rng.random(m) > 0.1)
    window = pm.search_window(n, m, jnp.zeros((n, 2)), jnp.zeros((m, 2)),
                              1.0, None, None, None)
    D = jnp.where(vk[None, :], matching.hamming_matrix_xor(dq, dk), matching.INF)
    got = pm.hamming_top2(dq, dk, vk, window)
    for got, ref in zip(got, matching.best_two(D)):
        np.testing.assert_array_equal(np.asarray(got), np.asarray(ref))
