"""Persistent XLA compilation cache for the program's entry points.

A cold process recompiles every program it runs; for the emulator's
mega-batch and sampler programs that is a large share of a short run.
The entry points (``python -m tpu21cmvae``, ``serve``, ``bench.py``,
``bench_mcmc.py``, ``chip_smoke.py``) call :func:`enable_compile_cache`
first, so a second run on the same machine reuses the compiled code.
Importing the package changes nothing.
"""

from __future__ import annotations

import os
from typing import Mapping, Optional

#: the checkout this package was imported from (``<checkout>/tpu21cmvae``)
_CHECKOUT = os.path.dirname(
    os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
)


def cache_dir(environ: Optional[Mapping[str, str]] = None) -> Optional[str]:
    """The directory :func:`enable_compile_cache` points JAX at.

    ``None`` where ``JAX_COMPILATION_CACHE_DIR`` is set: JAX reads that
    variable itself and no other directory is set. Otherwise the fixed
    ``<checkout>/.jax_cache`` — fixed because the path is part of the
    cache's key, so a directory that moves between runs never hits.
    """
    env = os.environ if environ is None else environ
    if env.get("JAX_COMPILATION_CACHE_DIR"):
        return None
    return os.path.join(_CHECKOUT, ".jax_cache")


def enable_compile_cache() -> Optional[str]:
    """Turn on JAX's persistent compilation cache (see :func:`cache_dir`);
    returns the directory set, or ``None`` when the environment names
    one. Call before the first compilation."""
    import jax

    d = cache_dir()
    if d is not None:
        jax.config.update("jax_compilation_cache_dir", d)
    return d
