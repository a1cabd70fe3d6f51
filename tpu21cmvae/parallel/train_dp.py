"""Data-parallel training over a device mesh.

The reference trains single-device via ``Model.fit``
(reference ``emulator.py:369-378``). Here the same jitted epoch loop runs
data-parallel: weights and optimizer state replicated, every batch
sharded on the ``data`` axis; XLA inserts the gradient all-reduce (psum)
automatically from the shardings — no hand-written collective needed
(SURVEY.md §2.3/§5).

``dp_fit`` is a drop-in for :func:`tpu21cmvae.train.loop.fit` with a
``mesh`` argument; ``make_dp_train_step`` exposes the single fused
train step for custom loops and the multi-chip dry run.
"""

from __future__ import annotations

import numpy as np

import jax
import jax.numpy as jnp
from jax.sharding import Mesh

from tpu21cmvae.parallel.mesh import (
    batch_sharding,
    replicate,
    replicated_sharding,
    shard_batch,
)
from tpu21cmvae.train.adam import adam_init, adam_update
from tpu21cmvae.train.loop import fit
from tpu21cmvae.utils.config import TrainConfig


def make_dp_train_step(loss_fn, cfg: TrainConfig, mesh: Mesh):
    """One data-parallel train step: ``(params, opt_state, lr, bx, by) →
    (params, opt_state, loss)`` with params/opt replicated and the batch
    sharded. The gradient all-reduce is implicit in the shardings."""
    repl = replicated_sharding(mesh)
    dsh = batch_sharding(mesh)

    def step(params, opt_state, lr, bx, by):
        def batch_loss(p):
            return jnp.mean(loss_fn(p, bx, by))

        loss_val, grads = jax.value_and_grad(batch_loss)(params)
        params, opt_state = adam_update(
            grads,
            params,
            opt_state,
            lr,
            beta_1=cfg.beta_1,
            beta_2=cfg.beta_2,
            epsilon=cfg.epsilon,
        )
        return params, opt_state, loss_val

    return jax.jit(
        step,
        in_shardings=(repl, repl, None, dsh, dsh),
        out_shardings=(repl, repl, None),
    )


def _pad_to_mesh(x, mesh: Mesh):
    """Pad the leading axis to a mesh-size multiple by cycling real rows
    (finite values — a 0-weight row must not produce NaN losses, since
    ``0 × NaN = NaN`` would poison the masked reduction). Returns
    ``(padded_array, n_real)``; no-op when already divisible.

    Real split sizes are rarely divisible (21cmGEM: 26,889 train / 1,704
    val — reference ``sample_notebook.ipynb`` cell 19), and
    ``device_put`` with a batch sharding rejects uneven leading dims.
    """
    x = np.asarray(x, np.float32)
    n = x.shape[0]
    pad = (-n) % mesh.size
    if pad == 0:
        return x, n
    reps = -(-pad // n)  # pad may exceed n for tiny arrays
    filler = np.concatenate([x] * reps, axis=0)[:pad]
    return np.concatenate([x, filler], axis=0), n


def dp_fit(
    params,
    loss_fn,
    x_train,
    y_train,
    x_val,
    y_val,
    cfg: TrainConfig,
    mesh: Mesh,
    *,
    opt_state=None,
    stochastic: bool = False,
    pass_epoch: bool = False,
    verbose: bool = False,
    **fit_kwargs,
):
    """Data-parallel :func:`~tpu21cmvae.train.loop.fit`: places the data
    batch-sharded and params/opt-state replicated before entering the
    same jitted epoch loop; XLA propagates the shardings through the
    scan and inserts collectives.

    Split sizes need not divide the mesh: uneven splits are padded to a
    mesh multiple and the pad rows weight-masked out of every loss and
    gradient, so results match the single-device run."""
    params = replicate(params, mesh)
    if opt_state is None:
        opt_state = replicate(adam_init(params), mesh)
    x_train, n_train = _pad_to_mesh(x_train, mesh)
    y_train, _ = _pad_to_mesh(y_train, mesh)
    x_val, n_val = _pad_to_mesh(x_val, mesh)
    y_val, _ = _pad_to_mesh(y_val, mesh)
    x_train = shard_batch(jnp.asarray(x_train), mesh)
    y_train = shard_batch(jnp.asarray(y_train), mesh)
    x_val = shard_batch(jnp.asarray(x_val), mesh)
    y_val = shard_batch(jnp.asarray(y_val), mesh)
    return fit(
        params,
        loss_fn,
        x_train,
        y_train,
        x_val,
        y_val,
        cfg,
        opt_state=opt_state,
        stochastic=stochastic,
        pass_epoch=pass_epoch,
        verbose=verbose,
        n_train_real=n_train,
        n_val_real=n_val,
        **fit_kwargs,
    )


def dp_fit_scan(
    params,
    loss_fn,
    x_train,
    y_train,
    x_val,
    y_val,
    cfg: TrainConfig,
    mesh: Mesh,
    *,
    opt_state=None,
    stochastic: bool = False,
    pass_epoch: bool = False,
):
    """Data-parallel, device-resident training: the whole run is ONE XLA
    program over the mesh (:func:`tpu21cmvae.train.scan.fit_scan` with
    the dataset batch-sharded and params/optimizer replicated).

    The per-epoch permutation is global, so batch re-sharding rides XLA
    collectives; gradients all-reduce via the shardings as in
    :func:`make_dp_train_step`. Semantics (shuffles, callbacks,
    histories) are identical to the single-device path.
    """
    from tpu21cmvae.train.scan import fit_scan

    params = replicate(params, mesh)
    if opt_state is None:
        opt_state = replicate(adam_init(params), mesh)
    x_train, n_train = _pad_to_mesh(x_train, mesh)
    y_train, _ = _pad_to_mesh(y_train, mesh)
    x_val, n_val = _pad_to_mesh(x_val, mesh)
    y_val, _ = _pad_to_mesh(y_val, mesh)
    x_train = shard_batch(jnp.asarray(x_train), mesh)
    y_train = shard_batch(jnp.asarray(y_train), mesh)
    x_val = shard_batch(jnp.asarray(x_val), mesh)
    y_val = shard_batch(jnp.asarray(y_val), mesh)
    return fit_scan(
        params,
        loss_fn,
        x_train,
        y_train,
        x_val,
        y_val,
        cfg,
        opt_state=opt_state,
        stochastic=stochastic,
        pass_epoch=pass_epoch,
        n_train_real=n_train,
        n_val_real=n_val,
    )
