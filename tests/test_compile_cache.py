"""Where the persistent compilation cache lives.

Set, ``JAX_COMPILATION_CACHE_DIR`` is the only place the cache is
written; unset, the cache sits at one fixed directory of the checkout.
The compiling cases run in a subprocess: JAX opens its cache once per
process, at the first compilation.
"""

import os
import subprocess
import sys

from proteus_jax.utils import compile_cache

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))

_COMPILE = (
    'import sys; sys.path.insert(0, {root!r})\n'
    'from proteus_jax.utils import compile_cache\n'
    'print(compile_cache.enable())\n'
    'import jax, jax.numpy as jnp\n'
    "jax.config.update('jax_persistent_cache_min_compile_time_secs', 0)\n"
    'print(jax.config.jax_compilation_cache_dir)\n'
    'jax.jit(lambda x: x * 3 + 1)(jnp.arange(7.0)).block_until_ready()\n')


def _run(env_dir):
    env = dict(os.environ, JAX_PLATFORMS='cpu')
    env.pop('JAX_COMPILATION_CACHE_DIR', None)
    if env_dir is not None:
        env['JAX_COMPILATION_CACHE_DIR'] = env_dir
    out = subprocess.run([sys.executable, '-c', _COMPILE.format(root=ROOT)],
                         env=env, capture_output=True, text=True,
                         timeout=300, check=True)
    return out.stdout.split()


def test_env_dir_is_used(monkeypatch, tmp_path):
    monkeypatch.setenv('JAX_COMPILATION_CACHE_DIR', str(tmp_path))
    assert compile_cache.cache_dir() == str(tmp_path)


def test_default_dir_is_fixed_inside_checkout(monkeypatch):
    monkeypatch.delenv('JAX_COMPILATION_CACHE_DIR', raising=False)
    assert compile_cache.cache_dir() == os.path.join(ROOT, '.jax_cache')
    assert compile_cache.cache_dir() == compile_cache.DEFAULT_DIR
    with open(os.path.join(ROOT, '.gitignore')) as fh:
        assert '.jax_cache/' in fh.read().split()


def test_compiled_program_lands_in_env_dir(tmp_path):
    cache = tmp_path / 'xla'
    enabled, configured = _run(str(cache))
    assert enabled == configured == str(cache)
    assert os.listdir(cache), 'nothing was written to the cache'


def test_unset_env_configures_the_checkout_dir():
    enabled, configured = _run(None)
    assert enabled == configured == compile_cache.DEFAULT_DIR
