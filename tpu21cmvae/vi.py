"""Automatic-differentiation variational inference (ADVI) — fast
approximate posteriors over the same fused value+gradient path the HMC
sampler and ML fitter ride.

The reference community's workflow is hours of emcee around 40 ms
``predict`` calls (reference ``README.rst:9-11``); the MCMC stack here
already collapses that to seconds. ADVI is the next rung down in
latency: a full-rank Gaussian posterior approximation fitted by
stochastic gradient ascent on the ELBO (Kucukelbir et al. 2017, JMLR
18) — hundreds of optimizer steps, each one batched
``valgrad`` call, giving a mean + covariance (and cheap iid draws) in a
fraction of a chain's wall time. Use it for quick-look posteriors,
Laplace-quality error bars away from hard box edges, and warm starts
(``sample_posterior(..., x0=res.sample(n_walkers))``); use the chain
samplers when the posterior may be non-Gaussian in the whitened space.

Device shape: the whole fit is ONE ``lax.scan`` device program; each
step evaluates ``n_mc`` reparameterized draws through the analytic
value+gradient path — the same mega-batch economics as everything
else in this framework (a 512-draw step is a tiny fraction of one
2²⁰-row value+gradient batch; rates in docs/PERF.md).

Design notes (mirrors :func:`tpu21cmvae.sampling.fit_map` /
``sample_hmc``):

* The Gaussian lives in the sigmoid-whitened UNBOUNDED space
  ``y = logit((x − lo)/span)`` — draws can never leave the prior box,
  and the Jacobian ``Σ log(span·s·(1−s))`` is part of the target (this
  is exactly Stan's ADVI transform for box constraints).
* Gradients are reparameterized (``y = μ + Lε``): the integrand's
  y-gradient needs only the FIRST-order ``valgrad`` — no
  differentiating through the emulator twice.
* ``L`` is parameterized as ``tril(A, −1) + diag(exp(d))`` so the
  entropy is ``Σ d + const`` and positivity is structural.
"""

from __future__ import annotations

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np

from tpu21cmvae.sampling import (
    _resolve_bounds,
    _whitened_center,
    _whitened_vi_target,
)

__all__ = ["ADVIResult", "fit_advi", "fit_advi_batch"]


@dataclasses.dataclass
class ADVIResult:
    """Fitted full-rank Gaussian posterior approximation (whitened
    space) from :func:`fit_advi`.

    ``mu`` / ``chol``: variational mean and Cholesky factor in the
    whitened space (diagnostic); ``elbo``: per-step ELBO estimates —
    a flat tail means converged, a climbing tail means raise
    ``n_steps``. User-facing views are in RAW parameter units:
    :meth:`sample` (iid draws — no autocorrelation, no thinning),
    :meth:`mean` / :meth:`std` (moments of the drawn cloud).
    """

    mu: np.ndarray
    chol: np.ndarray
    elbo: np.ndarray
    _lo: np.ndarray
    _hi: np.ndarray

    def sample(self, n: int, seed: int = 0) -> np.ndarray:
        """``n`` iid raw-parameter draws from the fitted posterior."""
        rng = np.random.default_rng(seed)
        eps = rng.standard_normal((n, self.mu.shape[0]))
        y = self.mu + eps @ self.chol.T
        s = 1.0 / (1.0 + np.exp(-y))
        return (self._lo + (self._hi - self._lo) * s).astype(np.float32)

    def mean(self, n: int = 65536, seed: int = 0) -> np.ndarray:
        return self.sample(n, seed).mean(0)

    def std(self, n: int = 65536, seed: int = 0) -> np.ndarray:
        return self.sample(n, seed).std(0)


def fit_advi(
    valgrad,
    params,
    *,
    n_steps: int = 600,
    n_mc: int = 512,
    bounds=None,
    learning_rate: float = 0.05,
    seed: int = 0,
    x0=None,
    log_prior=None,
) -> ADVIResult:
    """Fit a full-rank Gaussian posterior approximation by ADVI.

    ``valgrad(params, raw) → (logL, ∇logL)`` — the fused
    value+gradient path (``model.loglik_and_grad_fn``). ``x0``:
    optional raw-space center to initialize the variational mean at
    (e.g. ``fit_map(...).best`` — an ML warm start typically halves
    the steps to convergence); default is the box center. ``log_prior``
    adds a smooth prior to the target (the fit approximates ``L·π``).
    Returns an :class:`ADVIResult`.
    """
    lo, hi = _resolve_bounds(bounds)
    n_params = int(lo.shape[0])
    span = hi - lo
    if x0 is not None:
        mu0 = _whitened_center(x0, lo, hi)
    else:
        mu0 = jnp.zeros((n_params,), jnp.float32)
    # start wide (sigmoid(±1.5) spans ~60% of the box) so early steps
    # see the whole landscape, not one basin wall
    d0 = jnp.full((n_params,), jnp.log(1.5), jnp.float32)
    a0 = jnp.zeros((n_params, n_params), jnp.float32)
    key = jax.random.key(seed)

    # shared variational integrand (span-Jacobian convention): target
    # value + FIRST-order y-gradient via the reparameterization trick
    integrand = _whitened_vi_target(
        valgrad, lo, span, log_prior, span_jac=True
    )

    b1, b2, eps_adam = 0.9, 0.999, 1e-8
    tril_mask = jnp.tril(jnp.ones((n_params, n_params), jnp.float32), -1)

    def step(state, tk):
        t, k = tk
        mu, a, d, m, v = state
        L = a * tril_mask + jnp.diag(jnp.exp(d))
        eps = jax.random.normal(k, (n_mc, n_params), jnp.float32)
        y = mu + eps @ L.T
        f, g = integrand(params, y)
        g = jnp.where(jnp.isfinite(g), g, 0.0)
        # reparameterized ELBO gradients (entropy terms analytic)
        g_mu = g.mean(axis=0)
        g_full = (g[:, :, None] * eps[:, None, :]).mean(axis=0)
        g_a = g_full * tril_mask
        g_d = jnp.diagonal(g_full) * jnp.exp(d) + 1.0  # +1: entropy Σd
        elbo = f.mean() + jnp.sum(d)  # + const
        # one Adam over the concatenated parameters
        flat = (g_mu, g_a, g_d)
        m = jax.tree_util.tree_map(
            lambda mm, gg: b1 * mm + (1 - b1) * gg, m, flat
        )
        v = jax.tree_util.tree_map(
            lambda vv, gg: b2 * vv + (1 - b2) * gg * gg, v, flat
        )
        lr = learning_rate * (0.05 + 0.95 * 0.5 * (
            1.0 + jnp.cos(jnp.pi * (t - 1.0) / n_steps)
        ))

        def upd(p, mm, vv):
            return p + lr * (mm / (1 - b1**t)) / (
                jnp.sqrt(vv / (1 - b2**t)) + eps_adam
            )

        mu = upd(mu, m[0], v[0])
        a = upd(a, m[1], v[1])
        d = upd(d, m[2], v[2])
        return (mu, a, d, m, v), elbo

    @jax.jit
    def run(mu, a, d, keys):
        zeros = (jnp.zeros_like(mu), jnp.zeros_like(a), jnp.zeros_like(d))
        state = (mu, a, d, zeros, zeros)
        (mu, a, d, _, _), elbo = jax.lax.scan(
            step, state,
            (jnp.arange(1, n_steps + 1, dtype=jnp.float32), keys),
        )
        return mu, a * tril_mask + jnp.diag(jnp.exp(d)), elbo

    mu, L, elbo = run(mu0, a0, d0, jax.random.split(key, n_steps))
    return ADVIResult(
        mu=np.asarray(mu),
        chol=np.asarray(L),
        elbo=np.asarray(elbo),
        _lo=np.asarray(lo, np.float64),
        _hi=np.asarray(hi, np.float64),
    )


@dataclasses.dataclass(frozen=True)
class _AdviBatchProgram:
    """Statics of :func:`_build_advi_batch_program`, keyed in full
    (``sampling/_common.py::_auto_key``)."""

    n_obs: int
    n_steps: int
    n_mc: int
    learning_rate: float


def _build_advi_batch_program(valgrad_multi, log_prior, lo, hi, cfg):
    """Module-level batched-ADVI program builder — no free variables
    (the structural cache-key contract). One Adam ascent advances
    ``n_obs`` independent full-rank Gaussians; every step is ONE
    observation-major ``(n_obs·n_mc)``-row valgrad batch."""
    span = hi - lo
    n_params = int(lo.shape[0])
    n_obs, n_steps, n_mc = cfg.n_obs, cfg.n_steps, cfg.n_mc
    learning_rate = cfg.learning_rate
    integrand = _whitened_vi_target(
        valgrad_multi, lo, span, log_prior, span_jac=True
    )
    b1, b2, eps_adam = 0.9, 0.999, 1e-8
    tril_mask = jnp.tril(jnp.ones((n_params, n_params), jnp.float32), -1)
    eye = jnp.eye(n_params, dtype=jnp.float32)

    def make_step(params):
        def step(state, tk):
            t, k = tk
            mu, a, d, m, v = state
            L = a * tril_mask + jnp.exp(d)[:, :, None] * eye  # (O,P,P)
            eps = jax.random.normal(
                k, (n_obs, n_mc, n_params), jnp.float32
            )
            y = mu[:, None, :] + jnp.einsum("onp,oqp->onq", eps, L)
            f, g = integrand(params, y.reshape(-1, n_params))
            f = f.reshape(n_obs, n_mc)
            g = jnp.where(jnp.isfinite(g), g, 0.0).reshape(
                n_obs, n_mc, n_params
            )
            g_mu = g.mean(axis=1)
            g_full = jnp.einsum("onp,onq->opq", g, eps) / n_mc
            g_a = g_full * tril_mask
            g_d = (jnp.diagonal(g_full, axis1=1, axis2=2)
                   * jnp.exp(d) + 1.0)
            elbo = f.mean(axis=1) + jnp.sum(d, axis=1)
            flat = (g_mu, g_a, g_d)
            m = jax.tree_util.tree_map(
                lambda mm, gg: b1 * mm + (1 - b1) * gg, m, flat
            )
            v = jax.tree_util.tree_map(
                lambda vv, gg: b2 * vv + (1 - b2) * gg * gg, v, flat
            )
            lr = learning_rate * (0.05 + 0.95 * 0.5 * (
                1.0 + jnp.cos(jnp.pi * (t - 1.0) / n_steps)
            ))

            def upd(p, mm, vv):
                return p + lr * (mm / (1 - b1**t)) / (
                    jnp.sqrt(vv / (1 - b2**t)) + eps_adam
                )

            mu = upd(mu, m[0], v[0])
            a = upd(a, m[1], v[1])
            d = upd(d, m[2], v[2])
            return (mu, a, d, m, v), elbo

        return step

    def run(params, mu, a, d, keys):
        zeros = (jnp.zeros_like(mu), jnp.zeros_like(a),
                 jnp.zeros_like(d))
        state = (mu, a, d, zeros, zeros)
        (mu, a, d, _, _), elbo = jax.lax.scan(
            make_step(params), state,
            (jnp.arange(1, n_steps + 1, dtype=jnp.float32), keys),
        )
        L = a * tril_mask + jnp.exp(d)[:, :, None] * eye
        return mu, L, elbo

    return jax.jit(run)


def fit_advi_batch(
    valgrad_multi,
    params,
    n_obs: int,
    *,
    n_steps: int = 600,
    n_mc: int = 512,
    bounds=None,
    learning_rate: float = 0.05,
    seed: int = 0,
    x0=None,
    log_prior=None,
) -> list:
    """Batched :func:`fit_advi`: fit ``n_obs`` INDEPENDENT full-rank
    Gaussian posteriors — one per observation of a stacked likelihood
    ``valgrad_multi(params, raw (O·W, P)) → ((O·W,), (O·W, P))`` — as
    one device program (round-4 VERDICT item 6: the per-row escalation
    fits ignored the batch economics the rest of the framework is
    built on). ``x0``: optional ``(n_obs, P)`` raw-space centers (one
    per row — e.g. the batched Laplace sweep's MAPs). Returns a list
    of ``n_obs`` :class:`ADVIResult`.

    Per-row trajectories are NOT bit-identical to sequential
    :func:`fit_advi` calls (independent RNG streams), but each row
    converges to the same variational optimum — the fit is
    deterministic given (seed, statics).
    """
    from tpu21cmvae.sampling._common import _auto_key, _chain_program

    lo, hi = _resolve_bounds(bounds)
    n_params = int(lo.shape[0])
    if x0 is not None:
        x0 = np.atleast_2d(np.asarray(x0, np.float64))
        if x0.shape != (n_obs, n_params):
            raise ValueError(
                f"x0 must be ({n_obs}, {n_params}) row centers; "
                f"got {x0.shape}"
            )
        lo64 = np.asarray(lo, np.float64)
        span64 = np.asarray(hi, np.float64) - lo64
        frac = np.clip((x0 - lo64) / span64, 1e-4, 1.0 - 1e-4)
        mu0 = jnp.asarray(np.log(frac / (1.0 - frac)), jnp.float32)
    else:
        mu0 = jnp.zeros((n_obs, n_params), jnp.float32)
    d0 = jnp.full((n_obs, n_params), jnp.log(1.5), jnp.float32)
    a0 = jnp.zeros((n_obs, n_params, n_params), jnp.float32)

    cfg = _AdviBatchProgram(
        n_obs=int(n_obs),
        n_steps=int(n_steps),
        n_mc=int(n_mc),
        learning_rate=float(learning_rate),
    )
    run = _chain_program(
        valgrad_multi,
        _auto_key(cfg, lo, hi, log_prior),
        lambda: _build_advi_batch_program(
            valgrad_multi, log_prior, lo, hi, cfg
        ),
    )
    keys = jax.random.split(jax.random.key(seed), n_steps)
    mu, L, elbo = run(params, mu0, a0, d0, keys)
    mu, L, elbo = np.asarray(mu), np.asarray(L), np.asarray(elbo)
    lo64 = np.asarray(lo, np.float64)
    hi64 = np.asarray(hi, np.float64)
    return [
        ADVIResult(mu=mu[o], chol=L[o], elbo=elbo[:, o],
                   _lo=lo64, _hi=hi64)
        for o in range(n_obs)
    ]
