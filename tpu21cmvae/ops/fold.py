"""Constant folding for the emulator chain and its Gaussian likelihood.

The flagship inference chain is ``par_transform → MLP → unpreproc``
(reference call stack: ``emulator.py:383-407``; SURVEY.md §3.3). Its
affine stages fold into the network's own weights:

* the affine part of ``par_transform`` (map the log-space training range
  onto [-1, 1]) folds into the first layer — an affine map feeding a
  linear layer is just a different linear layer;
* ``unpreproc`` (× global std, + per-bin mean) folds into the last
  (linear) layer the same way;
* for a likelihood, the observation and the noise whitening fold into
  the last layer too (:func:`fold_loglik_constants`), and the linear
  output layer collapses into a quadratic form (:func:`gram_fold`), so
  the 451-wide signal never needs to exist.

Only the log10/clamp on the first three parameter columns (reference
``preprocess.py:74-76``) remains as elementwise work
(:func:`_log_clamp`). The XLA likelihood paths in
:mod:`tpu21cmvae.ops.loglik`, :mod:`tpu21cmvae.foregrounds` and
:mod:`tpu21cmvae.noisescale` build on these helpers.
"""

from __future__ import annotations

import jax
import jax.numpy as jnp

from tpu21cmvae.ops.mlp import MLPParams
from tpu21cmvae.ops.transforms import _FX_CLAMP, _N_LOG_COLS, Normalizer

_PRECISIONS = {
    "default": jax.lax.Precision.DEFAULT,
    "high": jax.lax.Precision.HIGH,
    "highest": jax.lax.Precision.HIGHEST,
    # the exact-f32 accuracy-contract tier under its contract name —
    # the documented escape hatch wherever a fast tier's measured error
    # bound is not acceptable (e.g. near-mode |ΔlogL| — see
    # DirectEmulator.loglik_fn)
    "contract": jax.lax.Precision.HIGHEST,
}


def resolve_precision(precision) -> jax.lax.Precision:
    """Matmul precision tier from a name (``"default"``, ``"high"``,
    ``"highest"``, ``"contract"``) or a ``jax.lax.Precision``.

    ``HIGHEST`` (= ``"contract"``) is exact f32 on every backend. What
    ``DEFAULT`` and ``HIGH`` compute is the backend's choice: on an
    NVIDIA GPU an f32 dot at either tier may run on the tensor cores in
    TF32. ``bench.py`` / ``bench_mcmc.py`` and ``chip_smoke.py`` measure
    each tier's error against the exact path on the device at hand.
    """
    if isinstance(precision, str):
        return _PRECISIONS[precision.lower()]
    return precision


def fold_emulator_constants(params: MLPParams, norm: Normalizer) -> MLPParams:
    """Fold the normalization constants into the first/last layer weights.

    ``par_transform``'s affine stage is ``x ↦ a·x_log + c`` with per-column
    ``a = 2/(max−min)``, ``c = −(max+min)/(max−min)`` (reference
    ``preprocess.py:100-108``); feeding a linear layer ``x@W + b`` this is
    ``x_log @ (a[:,None]·W) + (c@W + b)``. ``unpreproc`` is
    ``y ↦ y·std + mean`` (reference ``preprocess.py:27-46``) after a
    *linear* output layer, so ``W' = W·std``, ``b' = b·std + mean``.

    Cheap (runs on the small weight arrays under jit, re-folded per call),
    and exact: the folded network computes bit-identically structured
    matmuls, just with different constants.
    """
    a = 2.0 / (norm.par_max - norm.par_min)
    c = -(norm.par_max + norm.par_min) / (norm.par_max - norm.par_min)
    if len(params) == 1:  # no hidden layers: both folds land on one layer
        (only,) = params
        w = a[:, None] * only["w"]
        b = c @ only["w"] + only["b"]
        return (
            {"w": w * norm.signal_std, "b": b * norm.signal_std + norm.signal_mean},
        )
    first, *mid, last = params
    first = {
        "w": a[:, None] * first["w"],
        "b": c @ first["w"] + first["b"],
    }
    last = {
        "w": last["w"] * norm.signal_std,
        "b": last["b"] * norm.signal_std + norm.signal_mean,
    }
    return (first, *mid, last)


def _log_clamp(x: jax.Array) -> jax.Array:
    """log10 on columns 0..2 with the ``fx == 0 → 1e-6`` clamp
    (reference ``preprocess.py:74-76``); other columns pass through."""
    col = jax.lax.broadcasted_iota(jnp.int32, x.shape, 1)
    is_log = col < _N_LOG_COLS
    is_fx = col == _N_LOG_COLS - 1
    clamped = jnp.where(is_fx & (x == 0.0), _FX_CLAMP, x)
    return jnp.where(is_log, jnp.log10(jnp.where(is_log, clamped, 1.0)), x)


_LN10 = 2.302585092994046


def _log_clamp_grad(x: jax.Array) -> jax.Array:
    """Elementwise derivative of :func:`_log_clamp` — ``1/(x·ln10)`` on
    the log columns (0 where the ``fx == 0`` clamp fired, matching
    autodiff through the ``where``), 1 elsewhere. Used by the analytic
    likelihood backward pass (:mod:`tpu21cmvae.ops.loglik`)."""
    col = jax.lax.broadcasted_iota(jnp.int32, x.shape, 1)
    is_log = col < _N_LOG_COLS
    clamp_fired = (col == _N_LOG_COLS - 1) & (x == 0.0)
    safe = jnp.where(is_log & ~clamp_fired, x, 1.0)
    d = jnp.where(is_log, 1.0 / (safe * _LN10), 1.0)
    return jnp.where(clamp_fired, 0.0, d)


def noise_scale(noise_var, n_bins: int) -> jax.Array:
    """Residual-whitening operator from a noise spec: per-bin ``1/σ``
    column scale (1-D) from a scalar or ``(n_bins,)`` variance, or the
    precomputed ``(n_bins, n_bins)`` factor ``R`` with ``P = R·Rᵀ``
    from a foreground-marginalized noise model
    (:class:`tpu21cmvae.foregrounds.MarginalizedNoise`). Both fold into
    the emulator's linear output layer
    (:func:`fold_loglik_constants`), so every downstream path — gram
    form, analytic gradient — is whitening-agnostic."""
    from tpu21cmvae.foregrounds import MarginalizedNoise

    if isinstance(noise_var, MarginalizedNoise):
        w = jnp.asarray(noise_var.whiten, jnp.float32)
        if w.shape != (n_bins, n_bins):
            raise ValueError(
                f"MarginalizedNoise built for {w.shape[0]} bins; the "
                f"model has {n_bins}"
            )
        return w
    nv = jnp.asarray(noise_var, jnp.float32)
    return jnp.broadcast_to(jax.lax.rsqrt(nv), (n_bins,))


def noise_log_norm(noise_var) -> float:
    """θ-independent additive log-likelihood constant of a noise spec
    (0 for plain diagonal noise; the marginal-density normalization for
    :class:`~tpu21cmvae.foregrounds.MarginalizedNoise`). Irrelevant to
    posterior sampling; required for comparable evidences."""
    from tpu21cmvae.foregrounds import MarginalizedNoise

    if isinstance(noise_var, MarginalizedNoise):
        return float(noise_var.log_norm)
    return 0.0


def fold_loglik_constants(
    params: MLPParams, norm: Normalizer, obs: jax.Array, scale: jax.Array
) -> MLPParams:
    """Fold normalization + observation + noise into the weight pytree.

    On top of :func:`fold_emulator_constants` (par-affine into the first
    layer, unpreproc into the last), shift the last bias by ``-obs`` and
    whiten the last layer — exact, since the output layer is linear.
    ``scale`` is :func:`noise_scale`'s operator: a per-bin ``1/σ``
    column scale (diagonal noise) or a full ``(n_bins, n_bins)`` factor
    ``R`` (foreground-marginalized noise, ``P = R·Rᵀ`` — the fold
    ``W @ R`` makes marginalization free per sample). Either way the
    folded network's output has ``‖out‖² = rᵀ·P·r``.
    """
    folded = fold_emulator_constants(params, norm)
    *rest, last = folded
    if scale.ndim == 2:
        hp = jax.lax.Precision.HIGHEST
        return (
            *rest,
            {"w": jnp.matmul(last["w"], scale, precision=hp),
             "b": jnp.matmul(last["b"] - obs, scale, precision=hp)},
        )
    return (
        *rest,
        {"w": last["w"] * scale, "b": (last["b"] - obs) * scale},
    )


def gram_fold(
    params: MLPParams, norm: Normalizer, obs: jax.Array, scale: jax.Array
):
    """Collapse the (linear) output layer into a Gram form.

    With the folded last layer ``r = h@W + b`` (see
    :func:`fold_loglik_constants`), the squared residual norm is

        ‖r‖² = h·(W Wᵀ)·hᵀ + 2·h·(W b) + b·b

    so the 451-wide output never needs to exist: the last matmul
    shrinks from (hidden, n_bins) to (hidden, hidden) — for the
    flagship, 224×451 → 224×224. ``G = W Wᵀ`` etc. are computed once
    per call at HIGHEST precision on the tiny weight arrays.

    Numerical caveat: the Gram form evaluates ‖r‖² as a difference of
    large terms (each ~‖h@W‖², vs the result ~‖r‖²), so it loses
    ~log₁₀(‖pred − mean‖/‖r‖) digits to cancellation near the posterior
    mode. ``bench_mcmc.py``'s gate decides admissibility on a trained
    model.

    Returns ``(trunk_layers, G, u, c)``.
    """
    folded = fold_loglik_constants(params, norm, obs, scale)
    *trunk, last = folded
    w, b = last["w"], last["b"]
    hp = jax.lax.Precision.HIGHEST
    G = jnp.matmul(w, w.T, precision=hp)
    u = jnp.matmul(w, b, precision=hp)
    c = jnp.dot(b, b, precision=hp)
    return tuple(trunk), G, u, c
