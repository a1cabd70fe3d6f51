"""Gaussian log-likelihood of an observed signal under the emulator.

The MCMC north-star workload (SURVEY.md §6): a sampler proposes batches
of astrophysical parameter draws and scores each against an observed
sky-averaged spectrum, ``logL(θ) = -0.5·Σ_bins (emulate(θ) − obs)²/σ²``.
The reference leaves this composition to the user at ~40 ms per signal
(reference ``emulator.py:383-407``, ``README.rst:11``); here it is a
first-class fused device function over mega-batches.

The emulator's predict chain and the residual reduction compile as one
jittable XLA program. ``method="gram"`` additionally folds the
observation, the noise whitening and the linear output layer into a
quadratic form (:mod:`tpu21cmvae.ops.fold`), so the (B, 451) signal
block is never materialized. Measured rates are in docs/PERF.md
(``bench_mcmc.py``).
"""

from __future__ import annotations

from typing import Optional

import jax
import jax.numpy as jnp
import numpy as np

from tpu21cmvae.ops.mlp import mlp_apply
from tpu21cmvae.ops.transforms import Normalizer, par_transform, unpreproc
from tpu21cmvae.utils.config import DirectEmulatorConfig


def _resid_quad(noise_var, n_bins: int, precision=None):
    """``(residual (…, n_bins) → rᵀ·P·r rows, log_norm)`` for a noise
    spec: diagonal (scalar / per-bin σ²) or foreground-marginalized
    (:class:`tpu21cmvae.foregrounds.MarginalizedNoise`, where ``P``
    projects the foreground modes out — see that module). The shared
    residual reduction of every non-folded likelihood path here."""
    from tpu21cmvae.foregrounds import MarginalizedNoise
    from tpu21cmvae.ops.fold import noise_log_norm

    if isinstance(noise_var, MarginalizedNoise):
        r_mat = jnp.asarray(noise_var.whiten, jnp.float32)
        if r_mat.shape != (n_bins, n_bins):
            raise ValueError(
                f"MarginalizedNoise built for {r_mat.shape[0]} bins; "
                f"the observation has {n_bins}"
            )
        prec = jax.lax.Precision.HIGHEST if precision is None else precision

        def quad(r):
            z = jnp.matmul(r, r_mat, precision=prec)
            return jnp.sum(z * z, axis=-1)

        return quad, noise_log_norm(noise_var)

    invvar = jnp.broadcast_to(
        1.0 / jnp.asarray(noise_var, jnp.float32), (n_bins,)
    )

    def quad(r):
        return jnp.sum(r * r * invvar, axis=-1)

    return quad, 0.0


def make_loglik_from_predict(predict_fn, obs, noise_var=1.0):
    """Generic Gaussian log-likelihood over ANY ``(weights, raw) →
    signals`` prediction function — the two-stage families
    (:class:`AutoEncoderEmulator`, :class:`VAEEmulator`) plug their
    ``predict_fn`` in here. The direct family should prefer
    :func:`make_loglik`, whose folded/gram specializations only
    exist for a single-MLP forward. ``noise_var``: scalar, per-bin σ²,
    a :class:`~tpu21cmvae.foregrounds.MarginalizedNoise`, or a
    :class:`~tpu21cmvae.noisescale.ScaleMarginalNoise`."""
    from tpu21cmvae.noisescale import ScaleMarginalNoise

    if isinstance(noise_var, ScaleMarginalNoise):
        base = make_loglik_from_predict(predict_fn, obs, noise_var.base)
        return noise_var.wrap_value(base, int(np.shape(obs)[-1]))
    obs = jnp.asarray(obs, jnp.float32)
    quad, log_norm = _resid_quad(noise_var, int(obs.shape[-1]))

    def loglik(weights, raw_params):
        raw = jnp.atleast_2d(jnp.asarray(raw_params, jnp.float32))
        pred = predict_fn(weights, raw)
        return -0.5 * quad(pred - obs) + log_norm

    return loglik


def make_loglik_and_grad_from_predict(predict_fn, obs, noise_var=1.0):
    """Value + per-row gradient companion of
    :func:`make_loglik_from_predict` for ANY ``(weights, raw) →
    signals`` prediction function (the two-stage families' sampler
    path) — autodiff with a ones-cotangent VJP (each row's logL depends
    only on its own row). The direct family's
    :func:`make_loglik_and_grad` has a faster analytic variant.
    """
    base = make_loglik_from_predict(predict_fn, obs, noise_var)

    def loglik_and_grad(weights, raw_params):
        raw = jnp.atleast_2d(jnp.asarray(raw_params, jnp.float32))
        val, vjp = jax.vjp(lambda r: base(weights, r), raw)
        (g,) = vjp(jnp.ones_like(val))
        return val, g

    return loglik_and_grad


def make_loglik(
    config: DirectEmulatorConfig,
    norm: Normalizer,
    obs,
    noise_var=1.0,
    *,
    method: str = "direct",
    precision=None,
):
    """Build ``fn(params, raw_params) → (B,)`` Gaussian log-likelihoods.

    ``obs``: observed signal in mK, shape (n_bins,); ``noise_var``:
    scalar or per-bin σ² in mK². A 1-D ``raw_params`` input scores as a
    single row, returning shape (1,).

    ``method="direct"`` evaluates the full network and reduces the
    residual; ``method="gram"`` collapses the output layer into a
    quadratic form (``‖h@W+b‖² = h·G·hᵀ + 2h·u + c`` — the wide output
    never exists), trading ~half the widest layer's matmul work for
    quadratic-form cancellation (measured error tables in docs/PERF.md).

    ``precision`` defaults to the fast tier ``Precision.HIGH``, whose
    arithmetic is the backend's choice (see
    :func:`tpu21cmvae.ops.fold.resolve_precision`); ``bench_mcmc.py``
    gates each tier against the exact path on a converged checkpoint
    (|ΔlogL| ≤ 0.25 near the posterior mode, plus 1.5e-3 per unit of
    depth). On an H100 the fast tiers run TF32 and fail that gate
    (docs/PERF.md); pass ``precision="contract"`` (= ``"highest"``,
    exact-f32 matmuls) wherever log-density values matter. Jit the
    result for dispatch (it is shard-transparent: batch-sharded inputs
    propagate).
    """
    if method not in ("direct", "gram"):
        raise ValueError(f"method must be 'direct' or 'gram'; got {method!r}")
    from tpu21cmvae.noisescale import ScaleMarginalNoise

    if isinstance(noise_var, ScaleMarginalNoise):
        # noise-level marginalization is an exact scalar post-transform
        # of the σ=1 base likelihood (tpu21cmvae.noisescale) — every
        # method/tier below is reused unchanged
        base = make_loglik(
            config, norm, obs, noise_var.base, method=method,
            precision=precision,
        )
        return noise_var.wrap_value(base, config.n_bins)
    from tpu21cmvae.ops.fold import resolve_precision

    precision = resolve_precision(
        jax.lax.Precision.HIGH if precision is None else precision
    )
    obs = jnp.asarray(obs, jnp.float32)

    if method == "gram":
        from tpu21cmvae.ops.fold import (
            _log_clamp,
            gram_fold,
            noise_log_norm,
            noise_scale,
        )

        scale = noise_scale(noise_var, config.n_bins)
        log_norm = noise_log_norm(noise_var)

        from tpu21cmvae.ops.mlp import (
            SKINNY_DENSE_MAX_IN,
            resolve_activation,
            skinny_dense,
        )

        # gram only requires the OUTPUT layer to be linear (always true
        # for these MLPs); trunk layers use the configured activation
        act = resolve_activation(config.activation)

        def loglik_gram(params, raw_params):
            trunk, G, u, c = gram_fold(params, norm, obs, scale)
            h = _log_clamp(jnp.atleast_2d(raw_params.astype(jnp.float32)))
            for i, layer in enumerate(trunk):  # trunk layers are hidden
                if i == 0 and layer["w"].shape[0] <= SKINNY_DENSE_MAX_IN:
                    h = skinny_dense(h, layer["w"], layer["b"])  # exact f32
                else:
                    h = (
                        jnp.matmul(h, layer["w"], precision=precision)
                        + layer["b"]
                    )
                h = act(h)
            g = jnp.matmul(h, G, precision=precision)
            return (
                -0.5 * (jnp.sum((g + 2.0 * u) * h, axis=-1) + c) + log_norm
            )

        return loglik_gram

    quad, log_norm = _resid_quad(noise_var, config.n_bins)
    activation = config.activation

    def loglik(params, raw_params):
        raw = jnp.atleast_2d(raw_params.astype(jnp.float32))
        x = par_transform(raw, norm)
        pred = unpreproc(
            mlp_apply(params, x, activation, precision=precision), norm
        )
        return -0.5 * quad(pred - obs) + log_norm

    return loglik


def make_loglik_multi_from_predict(predict_fn, obs_batch, noise_var=1.0):
    """Stacked-observation companion of :func:`make_loglik_from_predict`
    for ANY ``(weights, raw) → signals`` prediction function — the
    two-stage families' (:class:`AutoEncoderEmulator` /
    :class:`VAEEmulator`) batched-survey path. Row ``o·W + w`` of the
    observation-major batch scores against ``obs_batch[o]``; ``W`` is
    inferred per call (see :func:`make_loglik_multi`). ``noise_var``:
    scalar, per-bin vector, or
    :class:`~tpu21cmvae.foregrounds.MarginalizedNoise`, or a
    :class:`~tpu21cmvae.noisescale.ScaleMarginalNoise` (the noise
    LEVEL is then marginalized per observation) — shared across
    observations."""
    from tpu21cmvae.noisescale import ScaleMarginalNoise

    if isinstance(noise_var, ScaleMarginalNoise):
        base = make_loglik_multi_from_predict(
            predict_fn, obs_batch, noise_var.base
        )
        return noise_var.wrap_value(
            base, int(np.atleast_2d(np.asarray(obs_batch)).shape[-1])
        )
    obs_batch = jnp.atleast_2d(jnp.asarray(obs_batch, jnp.float32))
    n_obs = int(obs_batch.shape[0])
    _check_multi_noise(noise_var, int(obs_batch.shape[1]))
    quad, log_norm = _resid_quad(noise_var, int(obs_batch.shape[1]))

    def loglik(weights, raw_params):
        raw = jnp.atleast_2d(jnp.asarray(raw_params, jnp.float32))
        if raw.shape[0] % n_obs:
            raise ValueError(
                f"batch of {raw.shape[0]} rows does not divide across "
                f"{n_obs} observations"
            )
        w = raw.shape[0] // n_obs
        pred = predict_fn(weights, raw)
        r = pred.reshape(n_obs, w, -1) - obs_batch[:, None, :]
        return (-0.5 * quad(r) + log_norm).reshape(-1)

    return loglik


def _check_multi_noise(noise_var, n_bins: int):
    """Shared-noise validation for the stacked-observation builders:
    scalar, per-bin (n_bins,) vector, or a MarginalizedNoise of the
    right bin count (per-OBSERVATION noise would break the shared gram
    structure — score heterogeneous-noise surveys in groups)."""
    from tpu21cmvae.foregrounds import MarginalizedNoise

    if isinstance(noise_var, MarginalizedNoise):
        if noise_var.whiten.shape != (n_bins, n_bins):
            raise ValueError(
                f"MarginalizedNoise built for {noise_var.whiten.shape[0]} "
                f"bins; the observations have {n_bins}"
            )
        return
    nv = jnp.asarray(noise_var, jnp.float32)
    if nv.ndim > 1 or (nv.ndim == 1 and nv.shape[0] != n_bins):
        raise ValueError(
            "noise_var must be a scalar, a per-bin vector shared across "
            "observations, or a MarginalizedNoise; got shape "
            f"{nv.shape}"
        )


def per_row_grad(loglik):
    """Wrap a batched ``(weights, raw) → (B,)`` likelihood as
    ``(weights, raw) → ((B,), (B, P))`` via a ones-cotangent VJP —
    exact whenever each row's value depends only on its own row (true
    for every likelihood in this module: observation pairing is a
    static reshape, never a cross-row reduction)."""

    def loglik_and_grad(weights, raw_params):
        raw = jnp.atleast_2d(jnp.asarray(raw_params, jnp.float32))
        val, vjp = jax.vjp(lambda r: loglik(weights, r), raw)
        (g,) = vjp(jnp.ones_like(val))
        return val, g

    return loglik_and_grad


def make_loglik_multi(
    config: DirectEmulatorConfig,
    norm: Normalizer,
    obs_batch,
    noise_var=1.0,
    *,
    method: str = "gram",
    precision=None,
):
    """Stacked-observation likelihood: ``fn(params, raw (O·W, P)) →
    (O·W,)`` where row ``o·W + w`` scores against ``obs_batch[o]`` —
    survey-scale inference (many observed spectra) as ONE device
    program. ``W`` is inferred from the batch (rows must be
    observation-major and divide evenly by ``O``), so the SAME sampler
    machinery (:func:`tpu21cmvae.sampling.sample_mh` /
    :func:`~tpu21cmvae.sampling.sample_hmc`) runs ``O`` independent
    posteriors at once — walkers for every observation advance in each
    likelihood batch, exactly the mega-batch shape the matmuls want
    (:meth:`DirectEmulator.sample_posterior_batch` wraps this; SBC in
    :mod:`tpu21cmvae.calibration` is built on it).

    ``obs_batch``: (O, n_bins) observed signals in mK. ``noise_var``:
    scalar, per-bin (n_bins,) variance, or
    :class:`~tpu21cmvae.foregrounds.MarginalizedNoise` — SHARED across
    observations (per-observation noise would break the shared gram
    form — score heterogeneous-noise surveys in groups).
    ``method="gram"`` keeps the single-observation speed structure:
    ``G = WWᵀ`` and the trunk are observation-independent (computed
    once), only the tiny ``u``/``c`` constants become per-observation
    rows. Precision semantics match :func:`make_loglik`.
    """
    if method not in ("direct", "gram"):
        raise ValueError(f"method must be 'direct' or 'gram'; got {method!r}")
    from tpu21cmvae.noisescale import ScaleMarginalNoise

    if isinstance(noise_var, ScaleMarginalNoise):
        base = make_loglik_multi(
            config, norm, obs_batch, noise_var.base, method=method,
            precision=precision,
        )
        return noise_var.wrap_value(base, config.n_bins)
    obs_batch = jnp.atleast_2d(jnp.asarray(obs_batch, jnp.float32))
    n_obs = int(obs_batch.shape[0])
    if obs_batch.shape[1] != config.n_bins:
        raise ValueError(
            f"obs_batch must be (O, {config.n_bins}); got {obs_batch.shape}"
        )
    _check_multi_noise(noise_var, config.n_bins)
    from tpu21cmvae.ops.fold import resolve_precision

    precision = resolve_precision(
        jax.lax.Precision.HIGH if precision is None else precision
    )

    def _rows_per_obs(raw):
        b = raw.shape[0]
        if b % n_obs:
            raise ValueError(
                f"batch of {b} rows does not divide across {n_obs} "
                "observations; pass observation-major rows, W per obs"
            )
        return b // n_obs

    if method == "direct":
        quad, log_norm = _resid_quad(noise_var, config.n_bins)
        activation = config.activation

        def loglik_direct(params, raw_params):
            raw = jnp.atleast_2d(raw_params.astype(jnp.float32))
            w = _rows_per_obs(raw)
            x = par_transform(raw, norm)
            pred = unpreproc(
                mlp_apply(params, x, activation, precision=precision), norm
            )
            r = pred.reshape(n_obs, w, config.n_bins) - obs_batch[:, None, :]
            return (-0.5 * quad(r) + log_norm).reshape(-1)

        return loglik_direct

    from tpu21cmvae.ops.mlp import (
        SKINNY_DENSE_MAX_IN,
        resolve_activation,
        skinny_dense,
    )
    from tpu21cmvae.ops.fold import (
        _log_clamp,
        fold_loglik_constants,
        noise_log_norm,
        noise_scale,
    )

    scale = noise_scale(noise_var, config.n_bins)
    log_norm = noise_log_norm(noise_var)
    act = resolve_activation(config.activation)
    hp = jax.lax.Precision.HIGHEST

    def _constants(params):
        # one fold at obs=0 gives the shared trunk and whitened last
        # layer (Wₛ, b₀); G = Wₛ Wₛᵀ is observation-independent, and
        # each observation only shifts the folded bias (b_o = b₀ −
        # whiten(obs_o)), so the gram constants vectorize exactly:
        # u_o = Wₛ b_o, c_o = b_o·b_o — tiny (O, hidden) rows.
        folded = fold_loglik_constants(
            params, norm, jnp.zeros((config.n_bins,), jnp.float32), scale
        )
        *trunk, last = folded
        w_s, b0 = last["w"], last["b"]
        G = jnp.matmul(w_s, w_s.T, precision=hp)
        if scale.ndim == 2:  # marginalized noise: whiten = right-matmul
            b_all = b0 - jnp.matmul(obs_batch, scale, precision=hp)
        else:
            b_all = b0 - obs_batch * scale  # (O, n_bins)
        u_all = jnp.matmul(b_all, w_s.T, precision=hp)  # (O, hidden)
        c_all = jnp.sum(b_all * b_all, axis=-1)  # (O,)
        return tuple(trunk), G, u_all, c_all

    def loglik_gram(params, raw_params):
        raw = jnp.atleast_2d(raw_params.astype(jnp.float32))
        w_rows = _rows_per_obs(raw)
        trunk, G, u_all, c_all = _constants(params)
        h = _log_clamp(raw)
        for i, layer in enumerate(trunk):
            if i == 0 and layer["w"].shape[0] <= SKINNY_DENSE_MAX_IN:
                h = skinny_dense(h, layer["w"], layer["b"])
            else:
                h = jnp.matmul(h, layer["w"], precision=precision) + layer["b"]
            h = act(h)
        g1 = jnp.matmul(h, G, precision=precision)  # shared across obs
        hh = h.reshape(n_obs, w_rows, -1)
        gg = g1.reshape(n_obs, w_rows, -1)
        quad = jnp.sum(
            (gg + 2.0 * u_all[:, None, :]) * hh, axis=-1
        ) + c_all[:, None]
        return (-0.5 * quad + log_norm).reshape(-1)

    return loglik_gram


def make_loglik_and_grad_multi(
    config: DirectEmulatorConfig,
    norm: Normalizer,
    obs_batch,
    noise_var=1.0,
    *,
    method: str = "gram",
    precision=None,
):
    """Value + per-row gradient companion of :func:`make_loglik_multi`
    — the stacked-observation HMC inner loop, ``(params, (O·W, P)) →
    ((O·W,), (O·W, P))``. Autodiff with a ones-cotangent VJP: every
    row's logL depends only on its own row (the observation pairing is
    a static reshape), so the block-diagonal Jacobian collapses to the
    per-row gradient in one backward pass."""
    base = make_loglik_multi(
        config, norm, obs_batch, noise_var, method=method,
        precision=precision,
    )

    def loglik_and_grad(params, raw_params):
        raw = jnp.atleast_2d(jnp.asarray(raw_params, jnp.float32))
        val, vjp = jax.vjp(lambda r: base(params, r), raw)
        (g,) = vjp(jnp.ones_like(val))
        return val, g

    return loglik_and_grad


def make_loglik_and_grad(
    config: DirectEmulatorConfig,
    norm: Normalizer,
    obs,
    noise_var=1.0,
    *,
    method: str = "gram",
    variant: Optional[str] = None,
    precision=None,
    grad_precision=None,
):
    """Build ``fn(params, raw_params) → (logL, dlogL/draw)`` with shapes
    ``(B,), (B, n_params)`` — the gradient-based-sampler (HMC/NUTS)
    inner loop as one device call. The per-row gradient is with respect
    to the RAW astrophysical parameters (the sampling variables); chain
    any reparameterization (e.g. a sigmoid box map) outside.

    Variants (the ∇logL benchmark in ``bench_mcmc.py`` crosses them and
    selects by measurement under a gradient accuracy gate):

    * ``variant="autodiff"`` — ``jax.vjp`` through :func:`make_loglik`
      at the same method/tier. The baseline; stores every trunk
      activation between forward and backward.
    * ``method="gram", variant="analytic"`` (default) — hand-written
      backward. Two structural wins over autodiff: the gram head's
      gradient REUSES the forward's ``h@G`` product (``G = WWᵀ`` is
      exactly symmetric, so ``d(h·G·hᵀ)/dh = 2(h@G)`` — autodiff spends
      a second hidden×hidden matmul here), and the backward tier is
      independently selectable via ``grad_precision``.

    ``grad_precision`` (analytic only) tiers the backward matmuls
    separately from the value's ``precision``. A cheaper backward than
    value tier is admissible for HMC: leapfrog with any deterministic
    approximate force field remains reversible and volume-preserving,
    so the Metropolis accept step (which uses the gated VALUE) keeps
    the posterior exact — gradient error only costs acceptance rate
    (measured bounds in docs/PERF.md).
    """
    if variant is None:
        # gram has a hand-written backward; the direct method only
        # exists as autodiff
        variant = "autodiff" if method == "direct" else "analytic"
    from tpu21cmvae.noisescale import ScaleMarginalNoise

    if isinstance(noise_var, ScaleMarginalNoise):
        # exact chain rule through the scalar post-transform — the
        # analytic gradient carries over unchanged
        base = make_loglik_and_grad(
            config, norm, obs, noise_var.base, method=method,
            variant=variant, precision=precision,
            grad_precision=grad_precision,
        )
        return noise_var.wrap_valgrad(base, config.n_bins)
    if variant == "autodiff":
        base = make_loglik(
            config, norm, obs, noise_var, method=method, precision=precision,
        )

        def loglik_grad_ad(params, raw_params):
            raw = jnp.atleast_2d(jnp.asarray(raw_params, jnp.float32))
            val, vjp = jax.vjp(lambda r: base(params, r), raw)
            # each row's logL depends only on its own row, so the ones-
            # cotangent VJP IS the per-row gradient (block-diagonal J)
            (g,) = vjp(jnp.ones_like(val))
            return val, g

        return loglik_grad_ad
    if variant != "analytic":
        raise ValueError(
            f"variant must be 'autodiff' or 'analytic'; got {variant!r}"
        )
    if method != "gram":
        raise ValueError("the analytic backward exists for method='gram' only")
    if config.activation != "relu":
        raise NotImplementedError(
            "the analytic backward hard-codes ReLU masks; got "
            f"activation={config.activation!r} — use variant='autodiff'"
        )
    from tpu21cmvae.ops.fold import (
        _log_clamp,
        _log_clamp_grad,
        gram_fold,
        noise_log_norm,
        noise_scale,
        resolve_precision,
    )
    from tpu21cmvae.ops.mlp import SKINNY_DENSE_MAX_IN, skinny_dense

    fwd_prec = resolve_precision(
        jax.lax.Precision.HIGH if precision is None else precision
    )
    bwd_prec = (
        fwd_prec if grad_precision is None
        else resolve_precision(grad_precision)
    )
    hp = jax.lax.Precision.HIGHEST
    scale = noise_scale(noise_var, config.n_bins)
    log_norm = noise_log_norm(noise_var)

    def loglik_grad(params, raw_params):
        trunk, G, u, c = gram_fold(params, norm, obs, scale)
        x = jnp.atleast_2d(raw_params.astype(jnp.float32))
        h = _log_clamp(x)
        acts = []
        for i, layer in enumerate(trunk):
            if i == 0 and layer["w"].shape[0] <= SKINNY_DENSE_MAX_IN:
                h = skinny_dense(h, layer["w"], layer["b"])  # exact f32
            else:
                h = jnp.matmul(h, layer["w"], precision=fwd_prec) + layer["b"]
            h = jnp.maximum(h, 0.0)
            acts.append(h)
        g1 = jnp.matmul(h, G, precision=fwd_prec)
        quad = jnp.sum((g1 + 2.0 * u) * h, axis=-1) + c
        e = g1 + u  # = ½·dquad/dh — G symmetric, h@G reused
        for i in range(len(trunk) - 1, -1, -1):
            e = jnp.where(acts[i] > 0.0, e, 0.0)
            # first-layer backward contracts to n_params wide — tiny;
            # run it exact (same spirit as the skinny forward path)
            pr = hp if i == 0 else bwd_prec
            e = jnp.matmul(e, trunk[i]["w"].T, precision=pr)
        grad = -(_log_clamp_grad(x) * e)
        return -0.5 * quad + log_norm, grad

    return loglik_grad
