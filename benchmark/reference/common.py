"""Plain float32 building blocks shared by the family references.

Written from the published layer equations of 21cmVAE (Bye, Portillo &
Fialkov 2022, arXiv:2107.05581, Sec. 2 and App. A) and the arrays of a
checkpoint file. Nothing here imports the package under test.

* parameter transform: log10 of f*, V_c and f_X (f_X = 0 clamped to
  1e-6), then the affine map of the training range of each column onto
  [-1, 1];
* dense layers: ``x @ W + b``, ReLU after every hidden layer, the last
  layer linear;
* output: ``y * std + mean`` (the inverse of the signal standardisation).

Every matrix product goes through a ``matmul`` argument so the control
of the benchmark's comparison can run the same equations at a lower
precision (:func:`matmul_bf16x3`).
"""

from __future__ import annotations

import json

import jax
import jax.numpy as jnp
import numpy as np

FX_CLAMP = 1e-6
N_LOG_COLS = 3  # f*, V_c, f_X are log-uniform parameters


def read_npz(path: str):
    """``(leaves, metadata)`` of a checkpoint file: the arrays ``leaf_0 …
    leaf_{n-1}`` in order, and the JSON metadata of its header."""
    with np.load(path) as data:
        header = json.loads(bytes(data["__header__"]).decode())
        leaves = [np.asarray(data[f"leaf_{i}"], np.float32)
                  for i in range(header["n_leaves"])]
    return leaves, header["metadata"]


def layers_from(leaves, sizes):
    """Pair ``(b, w)`` leaves into ``[(w, b), …]`` and check each shape
    against the published widths ``sizes = (in, *hidden, out)``."""
    if len(leaves) != 2 * (len(sizes) - 1):
        raise ValueError(f"{len(leaves)} arrays for {len(sizes) - 1} layers")
    out = []
    for i, (d_in, d_out) in enumerate(zip(sizes[:-1], sizes[1:])):
        b, w = leaves[2 * i], leaves[2 * i + 1]
        if w.shape != (d_in, d_out) or b.shape != (d_out,):
            raise ValueError(
                f"layer {i}: w {w.shape}, b {b.shape}; published "
                f"({d_in}, {d_out})")
        out.append((w, b))
    return out


def normalizer_from(leaves, n_bins: int, n_params: int):
    """The four standardisation arrays: per-bin signal mean, global
    signal std, per-column min and max of the log-transformed
    parameters."""
    mean, std, pmin, pmax = leaves
    if (mean.shape, std.shape, pmin.shape, pmax.shape) != (
            (n_bins,), (), (n_params,), (n_params,)):
        raise ValueError("normaliser arrays do not match the widths")
    return {"mean": mean, "std": std, "pmin": pmin, "pmax": pmax}


def matmul_f32(a, b):
    """Exact float32 product (no TF32 rounding of the inputs)."""
    return jnp.matmul(a, b, precision=jax.lax.Precision.HIGHEST)


def _to_bf16(a):
    """Round to bfloat16 with ``reduce_precision``: a compiler allowed
    excess precision may drop a float32→bfloat16→float32 round trip of
    plain casts (XLA on the GPU does), which would make the low half of
    the split below zero and the product one pass."""
    return jax.lax.reduce_precision(a, exponent_bits=8, mantissa_bits=7)


def _split(a):
    hi = _to_bf16(a)
    lo = _to_bf16(a - hi)
    return hi.astype(jnp.bfloat16), lo.astype(jnp.bfloat16)


def _bf16x3(a, b):
    a_hi, a_lo = _split(a)
    b_hi, b_lo = _split(b)

    def dot(x, y):
        return jnp.matmul(x, y, preferred_element_type=jnp.float32)

    return dot(a_hi, b_hi) + dot(a_hi, b_lo) + dot(a_lo, b_hi)


@jax.custom_vjp
def matmul_bf16x3(a, b):
    """float32 product in three bfloat16 passes (hi·hi + hi·lo + lo·hi,
    float32 accumulation) — the "high" tier one step below exact
    float32. Its backward uses the same three passes."""
    return _bf16x3(a, b)


def _bf16x3_fwd(a, b):
    return _bf16x3(a, b), (a, b)


def _bf16x3_bwd(res, g):
    a, b = res
    return _bf16x3(g, b.T), _bf16x3(a.T, g)


matmul_bf16x3.defvjp(_bf16x3_fwd, _bf16x3_bwd)

MATMULS = {"f32": matmul_f32, "bf16x3": matmul_bf16x3}


def par_transform(raw, norm, xp=jnp):
    """Raw parameters (B, 7) → network inputs in [-1, 1]. ``xp`` is
    ``jax.numpy`` (float32, on the device) or ``numpy`` (the float64
    host path that builds a likelihood mix's observation)."""
    raw = xp.asarray(raw, norm["pmin"].dtype)
    head = raw[:, :N_LOG_COLS]
    fx = head[:, 2:3]
    head = xp.concatenate(
        [head[:, :2], xp.where(fx == 0.0, FX_CLAMP, fx)], axis=1)
    x = xp.concatenate([xp.log10(head), raw[:, N_LOG_COLS:]], axis=1)
    return 2.0 * (x - norm["pmin"]) / (norm["pmax"] - norm["pmin"]) - 1.0


def dense_chain(layers, x, matmul, xp=jnp):
    """ReLU after every layer but the last, which is linear."""
    for i, (w, b) in enumerate(layers):
        x = matmul(x, w) + b
        if i < len(layers) - 1:
            x = xp.maximum(x, 0.0)
    return x


def as_float64(weights):
    """The weights as float64 NumPy arrays, for the host path."""
    return jax.tree.map(lambda a: np.asarray(a, np.float64), weights)


def unpreproc(y, norm):
    return y * norm["std"] + norm["mean"]


def loglik(signals, obs, noise_var):
    """Gaussian log-likelihood of each row: -½ Σ (signal − obs)² / σ²."""
    r = signals - obs
    return -0.5 * jnp.sum(r * r, axis=-1) / noise_var
