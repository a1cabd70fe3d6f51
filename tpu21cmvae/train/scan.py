"""Device-resident training: the ENTIRE run is one XLA program.

:func:`tpu21cmvae.train.loop.fit` follows Keras' shape — one device call
per epoch, callbacks on host (reference ``Model.fit`` semantics,
``emulator.py:369-378``). That costs two host↔device syncs per epoch,
which dominates wall time whenever an epoch's compute is short next to
the dispatch and sync latency.

:func:`fit_scan` is the device-resident alternative: a ``lax.scan`` over
epochs whose carry holds everything the host loop tracked — parameters,
Adam moments, learning rate, EarlyStopping monitor (best value / wait /
best-so-far weights), ReduceLROnPlateau monitor — with the stop decision
as a carried flag that turns later epochs into no-ops via ``lax.cond``.
One dispatch trains to completion; per-epoch (loss, val_loss, lr) come
back as arrays.

Semantics parity: the shuffle-key derivation, batch padding/weighting,
Adam update, and both callback state machines are the same computations
as the host path, so ``fit_scan`` and ``fit`` produce bit-identical
histories on the same inputs (pinned by ``tests/test_scan_fit.py``).
Checkpoint/resume and live metrics streaming need the host loop — use
``fit`` when you need those; ``fit_scan`` when you need speed.

At reference scale (flagship model, 26,888 training rows, batch 256 →
106 steps/epoch) an epoch is a few hundred small GEMMs, so per-epoch
host round trips are what this one-program design removes; the GPU
time per epoch is not measured yet (ROADMAP W1).

Retrace avoidance: the whole-run program is built by a cached factory
keyed on ``(loss_fn, seed-normalized config, static sizes)`` with the
PRNG keys passed as traced arguments, so repeated calls with the same
loss function object and same-shape data reuse the SAME jitted callable
— zero retracing and zero recompilation (the tuner's dominant overhead
otherwise; pinned by ``tests/test_retrace.py``). Callers enable this by
reusing one loss closure across runs (see the per-activation loss
caches in :mod:`tpu21cmvae.tuner`); a fresh closure per call degrades
gracefully to one trace per call.
"""

from __future__ import annotations



import dataclasses
import functools
from typing import Optional

import jax
import jax.numpy as jnp
import numpy as np

from tpu21cmvae.train.adam import adam_init, adam_update
from tpu21cmvae.train.loop import History, LossFn, _weak_fn_cache
from tpu21cmvae.utils.config import TrainConfig


def fit_scan(
    params,
    loss_fn: LossFn,
    x_train,
    y_train,
    x_val,
    y_val,
    cfg: TrainConfig,
    *,
    opt_state=None,
    stochastic: bool = False,
    pass_epoch: bool = False,
    n_train_real: Optional[int] = None,
    n_val_real: Optional[int] = None,
):
    """Train entirely on device; returns ``(params, opt_state, History)``.

    Same contract as :func:`~tpu21cmvae.train.loop.fit` minus the host
    hooks (``verbose``/``epoch_callback``/checkpointing), including the
    ``n_train_real``/``n_val_real`` pad-row masking data-parallel callers
    use.
    """
    x_train = jnp.asarray(x_train, jnp.float32)
    y_train = jnp.asarray(y_train, jnp.float32)
    x_val = jnp.asarray(x_val, jnp.float32)
    y_val = jnp.asarray(y_val, jnp.float32)
    n = x_train.shape[0]
    n_real = n if n_train_real is None else n_train_real
    if not 0 < n_real <= n:
        raise ValueError(f"n_train_real={n_real} must be in (0, {n}]")
    nv = x_val.shape[0]
    nv_real = nv if n_val_real is None else n_val_real

    if opt_state is None:
        opt_state = adam_init(params)

    # seed enters through the traced keys below, NOT the factory cache
    # key — per-trial seeds must not defeat the jit cache
    train_all = _build_train_all(
        loss_fn, dataclasses.replace(cfg, seed=0), n, n_real, nv, nv_real,
        stochastic, pass_epoch,
    )
    root_key = jax.random.key(cfg.seed)
    eval_key = jax.random.key(cfg.seed ^ 0x5EED)  # match loop._make_eval_fn

    params, opt_state, losses, val_losses, lrs, stopped_at, best_epoch = (
        train_all(
            params, opt_state, root_key, eval_key,
            x_train, y_train, x_val, y_val,
        )
    )
    # ONE host sync for the whole run:
    losses = np.asarray(losses)
    val_losses = np.asarray(val_losses)
    lrs = np.asarray(lrs)
    stopped_at = int(stopped_at)
    n_ran = cfg.epochs if stopped_at < 0 else stopped_at + 1

    use_early = cfg.early_stop_patience is not None
    history = History(
        loss=[float(v) for v in losses[:n_ran]],
        val_loss=[float(v) for v in val_losses[:n_ran]],
        lr=[float(v) for v in lrs[:n_ran]],
        epoch_time_s=[],
        stopped_epoch=None if stopped_at < 0 else stopped_at,
        best_epoch=int(best_epoch) if use_early and int(best_epoch) >= 0 else None,
    )
    return params, opt_state, history


def fit_scan_stack(
    params_stack,
    loss_fn: LossFn,
    x_train,
    y_train,
    x_val,
    y_val,
    cfg: TrainConfig,
    *,
    seeds,
    opt_state_stack=None,
    stochastic: bool = False,
    pass_epoch: bool = False,
    n_train_real: Optional[int] = None,
    n_val_real: Optional[int] = None,
    mesh=None,
):
    """Train M member replicas as ONE vmapped whole-run XLA program.

    The deep-ensembles construction (same data, same recipe, per-member
    init/shuffle seeds — ``models/ensemble.py``) is M independent
    :func:`fit_scan` runs. Running them sequentially serializes M
    programs; this stacks the member axis under ``jax.vmap`` of the SAME
    cached whole-run program, so every training matmul becomes a batched
    matmul and all members train in one device call. The in-program
    callbacks (EarlyStopping / ReduceLROnPlateau) are already
    masking-based (``lax.cond`` on a carried flag), so each member stops
    at its own epoch exactly as it would alone; histories are sliced
    per member on the way out.

    ``params_stack``: a params pytree with a leading member axis of size
    ``len(seeds)`` on every leaf (e.g. ``tree_map(jnp.stack, members)``).
    ``seeds``: one per member — reproduces the single-run key schedule
    (``fit_scan`` derives shuffle/loss keys from ``jax.random.key(seed)``).

    ``mesh``: optional :class:`jax.sharding.Mesh` — the member axis is
    sharded over ``mesh`` (``len(seeds)`` must divide the device count
    evenly into it) and the dataset is replicated, so each device trains
    its members locally with ZERO collectives: ensemble/seed parallelism,
    the third parallelism axis next to batch DP (``parallel/train_dp.py``)
    and sharded inference.

    Returns ``(params_stack, opt_state_stack, [History per member])``.
    """
    x_train = jnp.asarray(x_train, jnp.float32)
    y_train = jnp.asarray(y_train, jnp.float32)
    x_val = jnp.asarray(x_val, jnp.float32)
    y_val = jnp.asarray(y_val, jnp.float32)
    seeds = [int(s) for s in seeds]
    m = len(seeds)
    lead = {int(leaf.shape[0]) for leaf in jax.tree_util.tree_leaves(params_stack)}
    if lead != {m}:
        raise ValueError(
            f"params_stack leading axes {sorted(lead)} != len(seeds)={m}"
        )
    n = x_train.shape[0]
    n_real = n if n_train_real is None else n_train_real
    if not 0 < n_real <= n:
        raise ValueError(f"n_train_real={n_real} must be in (0, {n}]")
    nv = x_val.shape[0]
    nv_real = nv if n_val_real is None else n_val_real

    if opt_state_stack is None:
        opt_state_stack = jax.vmap(adam_init)(params_stack)

    stack_all = _build_train_all_stack(
        loss_fn, dataclasses.replace(cfg, seed=0), n, n_real, nv, nv_real,
        stochastic, pass_epoch,
    )
    # same key schedule as fit_scan: key(seed) / key(seed ^ 0x5EED)
    root_keys = jax.vmap(jax.random.key)(jnp.asarray(seeds, jnp.int32))
    eval_keys = jax.vmap(jax.random.key)(
        jnp.asarray([s ^ 0x5EED for s in seeds], jnp.int32)
    )

    if mesh is not None:
        from jax.sharding import NamedSharding, PartitionSpec

        if m % mesh.size != 0:
            raise ValueError(
                f"{m} members do not shard evenly over {mesh.size} devices"
            )
        member_s = NamedSharding(mesh, PartitionSpec(mesh.axis_names[0]))
        repl = NamedSharding(mesh, PartitionSpec())
        params_stack = jax.device_put(params_stack, member_s)
        opt_state_stack = jax.device_put(opt_state_stack, member_s)
        root_keys = jax.device_put(root_keys, member_s)
        eval_keys = jax.device_put(eval_keys, member_s)
        x_train, y_train, x_val, y_val = (
            jax.device_put(a, repl) for a in (x_train, y_train, x_val, y_val)
        )

    params_stack, opt_state_stack, losses, val_losses, lrs, stopped, best = (
        stack_all(
            params_stack, opt_state_stack, root_keys, eval_keys,
            x_train, y_train, x_val, y_val,
        )
    )
    # ONE host sync for all members:
    losses = np.asarray(losses)
    val_losses = np.asarray(val_losses)
    lrs = np.asarray(lrs)
    stopped = np.asarray(stopped)
    best = np.asarray(best)
    use_early = cfg.early_stop_patience is not None
    histories = []
    for i in range(m):
        stopped_at = int(stopped[i])
        n_ran = cfg.epochs if stopped_at < 0 else stopped_at + 1
        histories.append(History(
            loss=[float(v) for v in losses[i, :n_ran]],
            val_loss=[float(v) for v in val_losses[i, :n_ran]],
            lr=[float(v) for v in lrs[i, :n_ran]],
            epoch_time_s=[],
            stopped_epoch=None if stopped_at < 0 else stopped_at,
            best_epoch=int(best[i]) if use_early and int(best[i]) >= 0 else None,
        ))
    return params_stack, opt_state_stack, histories


@_weak_fn_cache
def _build_train_all_stack(
    loss_fn: LossFn,
    cfg: TrainConfig,
    n: int,
    n_real: int,
    nv: int,
    nv_real: int,
    stochastic: bool,
    pass_epoch: bool,
):
    """jit(vmap(train_all)) over the member axis, cached like the single-
    run factory (and the inner program IS the single-run factory's —
    the two share one trace of the epoch body)."""
    train_all = _build_train_all(
        loss_fn, cfg, n, n_real, nv, nv_real, stochastic, pass_epoch,
    )
    return jax.jit(jax.vmap(
        train_all, in_axes=(0, 0, 0, 0, None, None, None, None)
    ))


@_weak_fn_cache
def _build_train_all(
    loss_fn: LossFn,
    cfg: TrainConfig,
    n: int,
    n_real: int,
    nv: int,
    nv_real: int,
    stochastic: bool,
    pass_epoch: bool,
):
    """Build the jitted whole-run program.

    Cached on ``(loss_fn identity, cfg, static sizes, flags)`` — callers
    normalize ``cfg.seed`` to 0 and pass the PRNG keys as arguments, so
    same-shape runs (tuner trials, SHA rungs) reuse one callable and hit
    jax's jit cache with zero retraces. The loss-closure key is WEAK
    (``loop._WeakFnCache``): dropping the closure frees its programs and
    captured constants.
    """
    bs = cfg.batch_size
    nb = -(-n // bs)
    padded = nb * bs
    use_early = cfg.early_stop_patience is not None
    use_plateau = cfg.plateau_patience is not None
    # Keras callbacks take |min_delta| (callbacks.py); match exactly
    es_min_delta = abs(cfg.early_stop_min_delta)
    pl_min_delta = abs(cfg.plateau_min_delta)

    # The dataset is threaded through as jit ARGUMENTS (not closed over):
    # closing over it would embed ~n×bins×4 bytes of constants in the
    # compiled program — slower compiles and a duplicate HBM copy.
    def run_epoch(x_train, y_train, params, opt_state, lr, shuffle_key,
                  loss_key, epoch_idx):
        perm = jax.random.permutation(shuffle_key, n_real)
        # dataset pad rows then batch pad — both at the tail, one mask
        # (identical construction to loop._make_epoch_fn)
        perm = jnp.concatenate([
            perm,
            jnp.arange(n_real, n, dtype=perm.dtype),
            jnp.zeros((padded - n,), perm.dtype),
        ])
        weights = (jnp.arange(padded) < n_real).astype(x_train.dtype)
        xb = x_train[perm].reshape(nb, bs, *x_train.shape[1:])
        yb = y_train[perm].reshape(nb, bs, *y_train.shape[1:])
        wb = weights.reshape(nb, bs)

        def step(carry, batch):
            params, opt_state, total = carry
            bx, by, bw, i = batch
            count = jnp.sum(bw)

            def batch_loss(p):
                extra = (epoch_idx,) if pass_epoch else ()
                if stochastic:
                    per_sample = loss_fn(
                        p, bx, by, jax.random.fold_in(loss_key, i), *extra
                    )
                else:
                    per_sample = loss_fn(p, bx, by, *extra)
                return jnp.sum(per_sample * bw) / jnp.maximum(count, 1)

            loss_val, grads = jax.value_and_grad(batch_loss)(params)
            new_params, new_opt = adam_update(
                grads, params, opt_state, lr,
                beta_1=cfg.beta_1, beta_2=cfg.beta_2, epsilon=cfg.epsilon,
            )
            has_samples = count > 0
            params, opt_state = jax.tree_util.tree_map(
                lambda new, old: jnp.where(has_samples, new, old),
                (new_params, new_opt),
                (params, opt_state),
            )
            return (params, opt_state, total + loss_val * count), None

        (params, opt_state, total), _ = jax.lax.scan(
            step,
            (params, opt_state, jnp.zeros((), x_train.dtype)),
            (xb, yb, wb, jnp.arange(nb)),
        )
        return params, opt_state, total / n_real

    def evaluate(x_val, y_val, eval_key, params, epoch_idx):
        extra = (epoch_idx,) if pass_epoch else ()
        if stochastic:
            per_sample = loss_fn(params, x_val, y_val, eval_key, *extra)
        else:
            per_sample = loss_fn(params, x_val, y_val, *extra)
        if nv_real == nv:
            return jnp.mean(per_sample)
        w = (jnp.arange(nv) < nv_real).astype(per_sample.dtype)
        return jnp.sum(per_sample * w) / nv_real

    def epoch_body(data, carry, epoch):
        x_train, y_train, x_val, y_val, eval_key = data
        (params, opt_state, lr, key, es_best, es_wait, es_best_epoch,
         best_params, pl_best, pl_wait, stopped_at) = carry
        # identical key derivation to loop.fit: split the root key per
        # epoch, then split the epoch key into (shuffle, loss) keys
        key, sub = jax.random.split(key)
        shuffle_key, loss_key = jax.random.split(sub)
        active = stopped_at < 0

        def do_epoch(operand):
            params, opt_state, lr = operand
            new_params, new_opt, train_loss = run_epoch(
                x_train, y_train, params, opt_state, lr, shuffle_key,
                loss_key, epoch,
            )
            # monitor at the final-epoch objective (stationary under
            # schedule-dependent losses; mirrors loop.fit)
            val_loss = evaluate(x_val, y_val, eval_key, new_params, cfg.epochs - 1)
            return new_params, new_opt, train_loss, val_loss

        def skip_epoch(operand):
            params, opt_state, _ = operand
            return params, opt_state, jnp.float32(jnp.nan), jnp.float32(jnp.nan)

        params, opt_state, train_loss, val_loss = jax.lax.cond(
            active, do_epoch, skip_epoch, (params, opt_state, lr)
        )
        lr_used = lr  # the host loop records the lr the epoch ran with

        # EarlyStopping (min mode): improvement iff val < best - min_delta
        if use_early:
            improved = active & (val_loss < es_best - es_min_delta)
            es_best = jnp.where(improved, val_loss, es_best)
            es_best_epoch = jnp.where(improved, epoch, es_best_epoch)
            best_params = jax.tree_util.tree_map(
                lambda b, p: jnp.where(improved, p, b), best_params, params
            )
            es_wait = jnp.where(improved, 0, jnp.where(active, es_wait + 1, es_wait))
            stop_now = active & (es_wait >= cfg.early_stop_patience)
            stopped_at = jnp.where(stop_now, epoch, stopped_at)

        # ReduceLROnPlateau (min mode, cooldown 0)
        if use_plateau:
            pl_improved = active & (val_loss < pl_best - pl_min_delta)
            pl_best = jnp.where(pl_improved, val_loss, pl_best)
            pl_wait = jnp.where(
                pl_improved, 0, jnp.where(active, pl_wait + 1, pl_wait)
            )
            reduce_now = (
                active & (pl_wait >= cfg.plateau_patience) & (lr > cfg.plateau_min_lr)
            )
            lr = jnp.where(
                reduce_now,
                jnp.maximum(lr * cfg.plateau_factor, cfg.plateau_min_lr),
                lr,
            )
            pl_wait = jnp.where(reduce_now, 0, pl_wait)

        carry = (params, opt_state, lr, key, es_best, es_wait, es_best_epoch,
                 best_params, pl_best, pl_wait, stopped_at)
        return carry, (train_loss, val_loss, lr_used)

    @jax.jit
    def train_all(params, opt_state, root_key, eval_key,
                  x_train, y_train, x_val, y_val):
        body = functools.partial(
            epoch_body, (x_train, y_train, x_val, y_val, eval_key)
        )
        init = (
            params,
            opt_state,
            jnp.float32(cfg.learning_rate),
            root_key,
            jnp.float32(jnp.inf),          # es_best
            jnp.int32(0),                  # es_wait
            jnp.int32(-1),                 # es_best_epoch
            params,                        # best_params
            jnp.float32(jnp.inf),          # pl_best
            jnp.int32(0),                  # pl_wait
            jnp.int32(-1),                 # stopped_at (-1 = running)
        )
        carry, (losses, val_losses, lrs) = jax.lax.scan(
            body, init, jnp.arange(cfg.epochs)
        )
        (params, opt_state, _, _, _, _, es_best_epoch, best_params, _, _,
         stopped_at) = carry
        if use_early and cfg.restore_best_weights:
            # Keras restores best weights only when stopping triggered AND
            # some epoch actually improved (host path: best_weights stays
            # None otherwise and the last params stand — callbacks.py)
            restore = (stopped_at >= 0) & (es_best_epoch >= 0)
            params = jax.tree_util.tree_map(
                lambda p, b: jnp.where(restore, b, p), params, best_params
            )
        return params, opt_state, losses, val_losses, lrs, stopped_at, es_best_epoch

    return train_all
