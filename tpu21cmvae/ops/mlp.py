"""Dense-MLP core: weights as a pytree + a pure apply function.

Replaces the reference's Keras ``Sequential`` builder ``_gen_model``
(reference ``emulator.py:12-48``). Weights use the Keras kernel layout
``(in_dim, out_dim)`` so the shipped pretrained ``.h5`` files import
without transposition, and initialization matches Keras Dense defaults
(Glorot-uniform kernels, zero biases) so retraining dynamics are
comparable.

The parameter pytree is a tuple of ``{"w": (in, out), "b": (out,)}`` layer
dicts — trivially shardable, checkpointable, and differentiable.
"""

from __future__ import annotations

from typing import Callable, Sequence, Tuple, Union

import jax
import jax.numpy as jnp

MLPParams = Tuple[dict, ...]

_ACTIVATIONS = {
    "relu": jax.nn.relu,
    "tanh": jnp.tanh,
    "sigmoid": jax.nn.sigmoid,
    "gelu": jax.nn.gelu,
    "elu": jax.nn.elu,
    "softplus": jax.nn.softplus,
    "linear": lambda x: x,
}


def resolve_activation(activation: Union[str, Callable]) -> Callable:
    """Accepts a name (Keras-style, reference ``emulator.py:25-27``) or a
    callable."""
    if callable(activation):
        return activation
    try:
        return _ACTIVATIONS[activation]
    except KeyError:
        raise ValueError(
            f"Unknown activation {activation!r}; one of {sorted(_ACTIVATIONS)} "
            "or a callable."
        ) from None


def glorot_uniform_init(key: jax.Array, in_dim: int, out_dim: int, dtype=jnp.float32):
    """Keras Dense default kernel init: U(-limit, limit),
    limit = sqrt(6 / (fan_in + fan_out))."""
    limit = (6.0 / (in_dim + out_dim)) ** 0.5
    return jax.random.uniform(
        key, (in_dim, out_dim), dtype=dtype, minval=-limit, maxval=limit
    )


def init_mlp(key: jax.Array, sizes: Sequence[int], dtype=jnp.float32) -> MLPParams:
    """Initialize an MLP with layer widths ``sizes = (in, *hidden, out)``."""
    keys = jax.random.split(key, len(sizes) - 1)
    return tuple(
        {
            "w": glorot_uniform_init(k, d_in, d_out, dtype),
            "b": jnp.zeros((d_out,), dtype=dtype),
        }
        for k, d_in, d_out in zip(keys, sizes[:-1], sizes[1:])
    )


# At or below this fan-in, a dense layer runs as broadcast multiply-adds
# instead of a matmul: exactly in_dim fused multiply-adds per output in
# native f32, exact regardless of the matmul precision tier, with no
# contraction dim padded up to a matrix-unit tile. Covers the
# 7-parameter input layer; deliberately below the AE/VAE latent width
# (9) so latent→decoder stays a matmul. Whether it is faster than a
# matmul on a GPU is not measured yet.
SKINNY_DENSE_MAX_IN = 8


def skinny_dense(x: jax.Array, w: jax.Array, b: jax.Array) -> jax.Array:
    """``x @ w + b`` as explicit broadcast multiply-adds over the (small,
    static) fan-in — elementwise work, exact f32 accumulation."""
    acc = b[None, :] + x[:, 0:1] * w[0][None, :]
    for k in range(1, w.shape[0]):
        acc = acc + x[:, k: k + 1] * w[k][None, :]
    return acc


def mlp_apply(
    params: MLPParams,
    x: jax.Array,
    activation: Union[str, Callable] = "relu",
    precision=jax.lax.Precision.HIGHEST,
) -> jax.Array:
    """Forward pass: ``activation`` after every layer except the last,
    which is linear (matching ``_gen_model``'s output layer,
    reference ``emulator.py:45-46``).

    ``precision`` defaults to HIGHEST, exact f32 on every backend: the
    backend's default f32 matmul may round its inputs (TF32 on an
    NVIDIA GPU), which costs digits on trained weights — the fast tiers
    are gated separately by ``bench.py``. A first layer with fan-in ≤
    :data:`SKINNY_DENSE_MAX_IN` runs as exact broadcast multiply-adds at
    every tier (see :func:`skinny_dense`).

    ``precision`` may also be a SEQUENCE of per-layer precisions (one
    per layer, skinny first layer included for alignment though it
    ignores its entry) — the mixed-tier hook: per-layer bf16
    sensitivity is wildly uneven on trained weights (docs/PERF.md).
    NOTE the deliberate convention clash with ``jnp.matmul``'s
    ``(lhs, rhs)`` 2-tuple form: here a tuple/list ALWAYS means
    per-layer (length must equal the layer count — enforced); to give
    one layer a per-operand pair, nest it as that layer's entry, e.g.
    ``((HIGH, HIGHEST), HIGH, HIGH)``.
    """
    act = resolve_activation(activation)
    per_layer = isinstance(precision, (tuple, list))
    if per_layer and len(precision) != len(params):
        raise ValueError(
            f"per-layer precision needs {len(params)} entries, "
            f"got {len(precision)}"
        )
    for i, layer in enumerate(params):
        w = layer["w"]
        prec = precision[i] if per_layer else precision
        if i == 0 and x.ndim == 2 and w.shape[0] <= SKINNY_DENSE_MAX_IN:
            x = skinny_dense(x, w, layer["b"])
        else:
            x = jnp.matmul(x, w, precision=prec) + layer["b"]
        if i < len(params) - 1:
            x = act(x)
    return x


def mlp_sizes(params: MLPParams) -> Tuple[int, ...]:
    """Recover layer widths from a parameter pytree."""
    return (params[0]["w"].shape[0], *(layer["w"].shape[1] for layer in params))


def count_params(params) -> int:
    """Total number of scalar parameters in any pytree."""
    return sum(p.size for p in jax.tree_util.tree_leaves(params))
