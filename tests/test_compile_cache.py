"""Where the entry points put JAX's persistent compilation cache."""

import os

from tpu21cmvae.utils.compile_cache import cache_dir

_ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def test_env_variable_wins_and_no_other_dir_is_set():
    assert cache_dir({"JAX_COMPILATION_CACHE_DIR": "/some/cache"}) is None


def test_unset_env_uses_fixed_gitignored_checkout_dir():
    d = cache_dir({})
    assert d == os.path.join(_ROOT, ".jax_cache")
    assert cache_dir({"JAX_COMPILATION_CACHE_DIR": ""}) == d
    with open(os.path.join(_ROOT, ".gitignore")) as f:
        assert ".jax_cache/" in f.read().split()
