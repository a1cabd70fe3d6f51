"""Sharded mega-batch inference — the MCMC north-star inner loop.

The reference emulates one signal per ~40 ms ``Model.predict`` call
(reference ``README.rst:11``; call stack in SURVEY.md §3.3). Here a batch
of 1e4–1e6 parameter draws is ONE device call: the batch axis is sharded
over the mesh, weights are replicated, and the whole
``par_transform → MLP → unpreproc`` chain runs fused on device with no
host round trips inside the loop.

Static-shape discipline: jit compiles per input shape, so arbitrary MCMC
batch sizes are padded up to a bucket boundary (powers of two times the
mesh size) — a bounded number of compilations regardless of walker count.
"""

from __future__ import annotations

from typing import Callable, Optional

import jax
import jax.numpy as jnp
import numpy as np
from jax.sharding import Mesh

from tpu21cmvae.parallel.mesh import batch_sharding, make_mesh, replicated_sharding


def _bucket_size(n: int, quantum: int) -> int:
    """Smallest power-of-two multiple of ``quantum`` ≥ n (min 1 quantum)."""
    b = quantum
    while b < n:
        b *= 2
    return b


class ShardedEmulator:
    """Wrap a pure ``(weights, raw_params) → signals`` function for
    mesh-sharded batched inference.

    Typically built from a model:
    ``ShardedEmulator.for_model(direct_emulator)`` or explicitly with any
    jittable predict function.
    """

    def __init__(
        self,
        predict_fn: Callable,
        params,
        mesh: Optional[Mesh] = None,
        min_quantum: int = 8,
    ):
        import math

        self.mesh = mesh if mesh is not None else make_mesh()
        n_dev = self.mesh.devices.size
        # every bucket must divide evenly across the mesh — lcm, not max,
        # so non-power-of-two meshes (3, 5, 6 devices, …) shard cleanly
        self.quantum = math.lcm(min_quantum, n_dev)
        self._data_sharding = batch_sharding(self.mesh)
        self._repl = replicated_sharding(self.mesh)
        self.params = jax.device_put(params, self._repl)
        self._fn = jax.jit(
            predict_fn,
            in_shardings=(self._repl, self._data_sharding),
            out_shardings=self._data_sharding,
        )

    @classmethod
    def for_model(
        cls,
        model,
        mesh: Optional[Mesh] = None,
        precision=None,
        **kwargs,
    ):
        """Build from any model exposing ``predict_fn()`` + ``params``
        (all three families; works for any (weights, raw)→signal fn).
        ``precision`` picks the direct family's matmul tier."""
        mesh = mesh if mesh is not None else make_mesh()
        # predict_fn() is already jitted; wrapping it in the sharded jit
        # here just inlines it — XLA sees one program with the shardings.
        # (only the direct family's predict_fn takes a precision tier)
        fn = (
            model.predict_fn()
            if precision is None
            else model.predict_fn(precision=precision)
        )
        return cls(fn, model.params, mesh=mesh, **kwargs)

    def __call__(self, raw_params) -> np.ndarray:
        """Emulate a batch of parameter draws; returns host ndarray.

        Pads to a bucket boundary (replicating row 0, results discarded)
        so repeated MCMC calls with varying walker counts hit a bounded
        set of compiled programs.
        """
        raw = np.atleast_2d(np.asarray(raw_params, dtype=np.float32))
        n = raw.shape[0]
        b = _bucket_size(n, self.quantum)
        if b != n:
            raw = np.concatenate(
                [raw, np.broadcast_to(raw[:1], (b - n, raw.shape[1]))], axis=0
            )
        x = jax.device_put(jnp.asarray(raw), self._data_sharding)
        out = self._fn(self.params, x)
        out = np.asarray(out)[:n]
        # single-row squeeze, matching DirectEmulator.predict (reference
        # emulator.py:404-407)
        return out[0] if n == 1 else out

    def warmup(self, batch_sizes, n_params: int = 7) -> None:
        """Precompile the bucketed programs an MCMC run will hit, so no
        walker-count change pays a compile inside the sampling loop.
        ``n_params``: input feature count (7 for the standard parameter
        space)."""
        buckets = sorted({_bucket_size(max(int(n), 1), self.quantum)
                          for n in batch_sizes})
        for b in buckets:
            x = jax.device_put(
                jnp.ones((b, n_params), jnp.float32), self._data_sharding
            )
            jax.block_until_ready(self._fn(self.params, x))

    def device_call(self, raw_params_device):
        """Zero-copy path for callers that keep data on device (e.g. a
        JAX-native MCMC sampler): no padding, no host transfer. The batch
        size must be divisible by the mesh size."""
        return self._fn(self.params, raw_params_device)
