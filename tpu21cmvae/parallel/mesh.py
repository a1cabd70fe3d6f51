"""Device-mesh construction and sharding helpers.

The reference is strictly single-device Keras (SURVEY.md §2.3: no
``tf.distribute``, no collectives). The one parallelism that is
semantically meaningful for this workload is **data parallelism over the
batch axis** — the model is 372k params (replicated everywhere); the
scaling axis is MCMC-scale batches of parameter draws. Design: one 1-D
``jax.sharding.Mesh`` over all devices, batch sharded with
``NamedSharding(P("data"))`` under jit, gradient/batch collectives
inserted by XLA (multi-host via ``jax.distributed.initialize``).

This module is a no-op on one device and scales to several without code
changes; tests exercise it on a virtual 8-device CPU mesh.
"""

from __future__ import annotations

from typing import Optional, Sequence

import jax
import numpy as np
from jax.sharding import Mesh, NamedSharding, PartitionSpec as P

DATA_AXIS = "data"


def make_mesh(devices: Optional[Sequence] = None, axis: str = DATA_AXIS) -> Mesh:
    """1-D mesh over all (or the given) devices, batch axis ``axis``."""
    if devices is None:
        devices = jax.devices()
    return Mesh(np.asarray(devices), (axis,))


def multihost_init(**kwargs) -> None:
    """Initialize multi-host JAX — thin alias so users have one entry
    point; call before :func:`make_mesh` on a multi-host cluster."""
    jax.distributed.initialize(**kwargs)


def replicate(tree, mesh: Mesh):
    """Place every leaf fully replicated on the mesh (model weights)."""
    return jax.device_put(tree, NamedSharding(mesh, P()))


def shard_batch(x, mesh: Mesh, axis: str = DATA_AXIS):
    """Shard the leading (batch) dimension across the mesh."""
    return jax.device_put(x, NamedSharding(mesh, P(axis)))


def batch_sharding(mesh: Mesh, axis: str = DATA_AXIS) -> NamedSharding:
    return NamedSharding(mesh, P(axis))


def replicated_sharding(mesh: Mesh) -> NamedSharding:
    return NamedSharding(mesh, P())
