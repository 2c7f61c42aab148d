"""Persistent XLA compilation cache (shared across CLI invocations).

The first compilation of the fused chain and of the device warps takes
seconds; the persistent cache lets every later process reuse them. Where
``JAX_COMPILATION_CACHE_DIR`` is set, the cache lives there and nowhere
else. Otherwise it lives at one fixed directory inside the checkout
(``.jax_cache``, listed in ``.gitignore``), so that every run of a
checkout finds what earlier runs compiled.
"""

import os

ENV_VAR = 'JAX_COMPILATION_CACHE_DIR'
DEFAULT_DIR = os.path.join(
    os.path.dirname(os.path.dirname(os.path.dirname(
        os.path.abspath(__file__)))), '.jax_cache')


def cache_dir():
    """The directory the persistent compilation cache uses."""
    return os.environ.get(ENV_VAR) or DEFAULT_DIR


def enable():
    """Point JAX's persistent compilation cache at ``cache_dir()``;
    programs that compile in under a second are not stored.

    Call it at process start, before the first compilation: JAX opens
    the cache once, at its first compile."""
    import jax
    path = cache_dir()
    os.makedirs(path, exist_ok=True)
    jax.config.update('jax_compilation_cache_dir', path)
    jax.config.update('jax_persistent_cache_min_compile_time_secs', 1.0)
    return path
