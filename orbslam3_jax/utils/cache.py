"""Persistent XLA compilation cache.

The solvers in this package are big XLA programs; caching their
executables makes repeated runs (tests, benchmarks, replays) start in
seconds instead of minutes.

Where `JAX_COMPILATION_CACHE_DIR` is set, JAX reads it itself and no
directory is set here. Otherwise the cache lives in `.jax_cache` at the
root of the checkout: a fixed path, since the path is part of what a
later run looks up.
"""

import os

DEFAULT_DIR = os.path.join(
    os.path.dirname(os.path.dirname(os.path.dirname(os.path.abspath(__file__)))),
    ".jax_cache",
)


def enable_compile_cache() -> str:
    """Turn the persistent cache on; returns its directory."""
    import jax

    path = os.environ.get("JAX_COMPILATION_CACHE_DIR")
    if not path:
        path = DEFAULT_DIR
        jax.config.update("jax_compilation_cache_dir", path)
    jax.config.update("jax_persistent_cache_min_compile_time_secs", 0.5)
    jax.config.update("jax_persistent_cache_min_entry_size_bytes", 0)
    return path
