"""Small shared utilities."""

from orbslam3_jax.utils.cache import enable_compile_cache  # noqa: F401
