"""Normalizing-flow variational inference — posterior fits and
importance-sampled evidence for the posteriors the Gaussian tools
measurably cannot cover.

Two measured findings motivate this module (docs/PERF.md):

* the adaptive Student-t importance stage behind
  :func:`tpu21cmvae.sampling.laplace_evidence` carries ``khat ≥ 0.7``
  on ~half of a real 64-observation batch — posteriors with a CURVED
  ridge that no ellipsoidal proposal (Gaussian or t, however adapted)
  can cover, leaving those rows with unreliable error bars;
* full-rank Gaussian ADVI (:func:`tpu21cmvae.vi.fit_advi`) by
  construction cannot represent that curvature either — its ELBO
  saturates at the best ellipsoid.

A RealNVP-style flow (Dinh et al. 2017) fixes both with one object: an
invertible map ``y = f(z)`` from a standard normal, built from affine
coupling layers whose scale/shift are tiny MLPs of the frozen half of
the coordinates. The flow lives in the same sigmoid-whitened ``y``
space as every gradient-based tool here (box constraints are
structural, :func:`tpu21cmvae.sampling._whitened_target`), its density
``log q(y) = log N(z) − log|det J|`` is exact in both directions
(affine couplings invert analytically), and it trains by
reparameterized ELBO ascent over the SAME fused value+gradient path as
ADVI/HMC — only first-order emulator gradients, no Hessians
(reference users differentiate nothing: the reference feeds external
CPU samplers, ``README.rst:9-11``).

Device shape: the whole fit is ONE ``lax.scan`` device program
(``n_steps`` × one batched valgrad call on ``n_mc`` draws + a few
7-wide coupling MLPs — negligible next to the emulator trunk); the
evidence sweep is one batched value call. Everything is fixed-shape,
scan-friendly, and jit-cached on the valgrad closure
(:func:`tpu21cmvae.sampling._chain_program`).

Capability position vs the reference: the reference ships no inference
at all; this is ecosystem parity with the flow-based tools 21-cm
analyses increasingly use (pocoMC's preconditioned MC, nautilus'
neural-network importance sampling) — here as three calls:
``fit_flow`` → ``FlowResult.sample`` / ``flow_evidence`` /
``method="flow"`` on every family's ``log_evidence``.
"""

from __future__ import annotations

import dataclasses
import math
from typing import Optional

import jax
import jax.numpy as jnp
import numpy as np

from tpu21cmvae.sampling import (
    _chain_program,
    _prior_log_box_mean,
    _psis,
    _resolve_bounds,
    _resolve_log_prior,
    _whitened_center,
    _whitened_vi_target,
)
from tpu21cmvae.sampling._common import _auto_key

__all__ = ["FlowResult", "FlowEvidenceResult", "fit_flow", "fit_flow_batch", "flow_evidence_batch", "evidence_with_flow_batch",
           "flow_evidence", "evidence_with_flow"]

#: scale clamp for the coupling log-scales: s = CAP·tanh(raw/CAP) keeps
#: every layer's expansion within e^±CAP so a half-trained conditioner
#: cannot blow a draw out of float32 range mid-fit
_SCALE_CAP = 3.0


def _masks(n_params: int, n_layers: int) -> np.ndarray:
    """Alternating-parity binary masks, one per coupling layer —
    ``m[i, j] = (j + i) % 2``. Consecutive layers freeze complementary
    halves, so two layers give every coordinate one update and
    ``n_layers`` of them compose the usual RealNVP deep stack."""
    j = np.arange(n_params)
    return np.stack(
        [((j + i) % 2).astype(np.float32) for i in range(n_layers)]
    )


def init_flow(key, n_params: int, *, n_layers: int = 6,
              width: int = 64, mu0=None, d0: float = math.log(1.5),
              chol0=None):
    """Flow parameter pytree at the near-identity start: coupling
    output layers are ZERO (every coupling starts as the identity) so
    the initial flow is exactly its full-rank Gaussian base — by
    default the wide diagonal ADVI start (``σ = e^{d0}``, spanning
    ~60 % of the box), or, with ``chol0`` (a whitened-space
    lower-triangular Cholesky, e.g. a fitted ``ADVIResult.chol``), the
    matched Gaussian whose curvature the couplings then only need to
    BEND. The warm start matters on sharp posteriors: measured on the
    shipped trained checkpoint, a cold flow left the IS tail unusable
    (ESS 29/16k, khat 1.04) where the ADVI-seeded fit is healthy —
    see :func:`fit_flow`."""
    mu = (jnp.zeros((n_params,), jnp.float32) if mu0 is None
          else jnp.asarray(mu0, jnp.float32))
    if chol0 is not None:
        c = np.asarray(chol0, np.float64)
        d = jnp.asarray(np.log(np.diag(c)), jnp.float32)
        a = jnp.asarray(np.tril(c, -1), jnp.float32)
    else:
        d = jnp.full((n_params,), d0, jnp.float32)
        a = jnp.zeros((n_params, n_params), jnp.float32)
    layers = []
    for i in range(n_layers):
        key, k1 = jax.random.split(key)
        w1 = jax.random.normal(k1, (n_params, width), jnp.float32) * (
            1.0 / math.sqrt(n_params)
        )
        layers.append({
            "w1": w1,
            "b1": jnp.zeros((width,), jnp.float32),
            "w2": jnp.zeros((width, 2 * n_params), jnp.float32),
            "b2": jnp.zeros((2 * n_params,), jnp.float32),
        })
    return {"mu": mu, "d": d, "a": a, "layers": layers}


def _base_chol(theta):
    """Full-rank base Cholesky ``tril(a, −1) + diag(exp(d))`` —
    positivity structural, entropy ``Σ d`` (the ADVI parameterization,
    ``tpu21cmvae/vi.py``)."""
    n = theta["d"].shape[0]
    tril = jnp.tril(jnp.ones((n, n), theta["a"].dtype), -1)
    return theta["a"] * tril + jnp.diag(jnp.exp(theta["d"]))


def _coupling_st(layer, m, y):
    """Conditioner: the frozen half ``m·y`` → per-dim (log-scale,
    shift) for the moving half. One hidden tanh layer — at 7 input
    dims this is noise next to the emulator trunk."""
    h = jnp.tanh((y * m) @ layer["w1"] + layer["b1"])
    st = h @ layer["w2"] + layer["b2"]
    n = y.shape[-1]
    s = _SCALE_CAP * jnp.tanh(st[..., :n] / _SCALE_CAP)
    return s * (1.0 - m), st[..., n:] * (1.0 - m)


def flow_forward(theta, z, masks):
    """``z (B, P) → (y (B, P), logdet (B,))`` — full-rank base affine
    then the coupling stack. Differentiable in ``theta`` (the fit
    pulls ELBO cotangents back through it in one ``vjp``)."""
    y = theta["mu"] + z @ _base_chol(theta).T
    logdet = jnp.full(z.shape[:-1], jnp.sum(theta["d"]))
    for layer, m in zip(theta["layers"], masks):
        m = jnp.asarray(m)
        s, t = _coupling_st(layer, m, y)
        y = y * m + (1.0 - m) * (y * jnp.exp(s) + t)
        logdet = logdet + jnp.sum(s, axis=-1)
    return y, logdet


def flow_inverse(theta, y, masks):
    """``y (B, P) → (z (B, P), logdet (B,))`` with the SAME logdet
    convention as :func:`flow_forward` (``log|det ∂y/∂z|``), so
    ``log q(y) = log N(z) − logdet`` either way. Exact: the frozen
    half of each coupling is untouched, so the conditioner sees
    identical inputs in both directions."""
    logdet = jnp.zeros(y.shape[:-1], y.dtype)
    for layer, m in zip(reversed(theta["layers"]), reversed(list(masks))):
        m = jnp.asarray(m)
        s, t = _coupling_st(layer, m, y)
        y = y * m + (1.0 - m) * (y - t) * jnp.exp(-s)
        logdet = logdet + jnp.sum(s, axis=-1)
    z = jax.scipy.linalg.solve_triangular(
        _base_chol(theta), (y - theta["mu"]).T, lower=True
    ).T
    return z, logdet + jnp.sum(theta["d"])


def _base_logpdf(z):
    return -0.5 * jnp.sum(z * z, axis=-1) - 0.5 * z.shape[-1] * math.log(
        2.0 * math.pi
    )


@dataclasses.dataclass
class FlowResult:
    """Fitted normalizing-flow posterior approximation from
    :func:`fit_flow`.

    ``elbo``: per-step ELBO trace (full ELBO including the base
    entropy, in the whitened-space convention of
    :func:`~tpu21cmvae.sampling.laplace_evidence` — comparable across
    runs; a flat tail means converged). User-facing views are in RAW
    parameter units: :meth:`sample` (iid draws — no autocorrelation),
    :meth:`mean` / :meth:`std`, :meth:`log_q` (exact per-row density
    in the whitened space, the piece importance sampling needs).
    """

    theta: dict
    masks: np.ndarray
    elbo: np.ndarray
    _lo: np.ndarray
    _hi: np.ndarray

    def _device(self):
        fn = getattr(self, "_jitted", None)
        if fn is None:
            masks = self.masks

            @jax.jit
            def draw(theta, z):
                y, _ = flow_forward(theta, z, masks)
                return y

            @jax.jit
            def logq(theta, y):
                z, ld = flow_inverse(theta, y, masks)
                return _base_logpdf(z) - ld

            fn = self._jitted = (draw, logq)
        return fn

    def sample_y(self, n: int, seed: int = 0) -> jnp.ndarray:
        """``n`` iid draws in the whitened ``y`` space."""
        draw, _ = self._device()
        z = jax.random.normal(
            jax.random.key(seed), (n, self.theta["mu"].shape[0])
        )
        return draw(self.theta, z)

    def sample(self, n: int, seed: int = 0) -> np.ndarray:
        """``n`` iid raw-parameter draws from the fitted posterior."""
        y = np.asarray(self.sample_y(n, seed), np.float64)
        s = np.exp(-np.logaddexp(0.0, -y))  # overflow-safe sigmoid
        return (self._lo + (self._hi - self._lo) * s).astype(np.float32)

    def log_q(self, y) -> np.ndarray:
        """Exact flow log-density of whitened rows ``y (B, P)``."""
        _, logq = self._device()
        return np.asarray(logq(self.theta, jnp.asarray(y, jnp.float32)))

    def mean(self, n: int = 65536, seed: int = 0) -> np.ndarray:
        return self.sample(n, seed).mean(0)

    def std(self, n: int = 65536, seed: int = 0) -> np.ndarray:
        return self.sample(n, seed).std(0)


@dataclasses.dataclass(frozen=True)
class _FlowFitProgram:
    """Statics of :func:`_build_flow_fit_program`, keyed in full
    (:func:`tpu21cmvae.sampling._common._auto_key`)."""

    n_steps: int
    n_mc: int
    n_layers: int
    width: int
    learning_rate: float


def _build_flow_fit_program(valgrad, log_prior, lo, hi, cfg):
    """Module-level ELBO-ascent program builder for :func:`fit_flow` —
    no free variables (the structural cache-key contract; see
    ``sampling/_common.py::_auto_key``)."""
    span = hi - lo
    n_params = int(lo.shape[0])
    n_steps, n_mc = cfg.n_steps, cfg.n_mc
    learning_rate = cfg.learning_rate
    masks = _masks(n_params, cfg.n_layers)
    integrand_val_grad = _whitened_vi_target(
        valgrad, lo, span, log_prior, span_jac=False
    )
    b1, b2, eps_adam = 0.9, 0.999, 1e-8
    h_base = 0.5 * n_params * math.log(2.0 * math.pi * math.e)

    def run(params, theta, keys):
        # params is a RUN argument (not baked into the trace): the
        # cached program must honor fresh weights when the same
        # valgrad closure is reused after retraining
        def step(state, tk):
            t, k = tk
            theta, m, v = state
            z = jax.random.normal(k, (n_mc, n_params), jnp.float32)
            (y, logdet), pull = jax.vjp(
                lambda th: flow_forward(th, z, masks), theta
            )
            f, g_y = integrand_val_grad(params, y)
            g_y = jnp.where(jnp.isfinite(g_y), g_y, 0.0)
            # ∂/∂θ E[f(y) + logdet]: one pullback carries both the
            # integrand cotangent and the logdet's (entropy ascent)
            (g_th,) = pull((
                g_y / n_mc, jnp.full((n_mc,), 1.0 / n_mc),
            ))
            elbo = f.mean() + logdet.mean() + h_base
            m = jax.tree_util.tree_map(
                lambda mm, gg: b1 * mm + (1 - b1) * gg, m, g_th
            )
            v = jax.tree_util.tree_map(
                lambda vv, gg: b2 * vv + (1 - b2) * gg * gg, v, g_th
            )
            lr = learning_rate * (0.05 + 0.95 * 0.5 * (
                1.0 + jnp.cos(jnp.pi * (t - 1.0) / n_steps)
            ))
            theta = jax.tree_util.tree_map(
                lambda p, mm, vv: p + lr * (mm / (1 - b1**t)) / (
                    jnp.sqrt(vv / (1 - b2**t)) + eps_adam
                ),
                theta, m, v,
            )
            return (theta, m, v), elbo

        zeros = jax.tree_util.tree_map(jnp.zeros_like, theta)
        state = (theta, zeros, zeros)
        (theta, _, _), elbo = jax.lax.scan(
            step, state,
            (jnp.arange(1, n_steps + 1, dtype=jnp.float32), keys),
        )
        return theta, elbo

    return jax.jit(run)


@dataclasses.dataclass(frozen=True)
class _FlowISProgram:
    """Statics of :func:`_build_flow_is_program`, keyed in full; the
    flow's mask stack is keyed as an array extra."""

    n_is: int


def _build_flow_is_program(loglik, log_prior, lo, hi, masks, cfg):
    """Module-level flow-IS program builder for :func:`flow_evidence`
    — no free variables (see ``sampling/_common.py::_auto_key``)."""
    span = hi - lo
    n_params = int(lo.shape[0])
    n_is = cfg.n_is

    def run(params, theta, key):
        z = jax.random.normal(key, (n_is, n_params), jnp.float32)
        y, logdet = flow_forward(theta, z, masks)
        logq = _base_logpdf(z) - logdet
        s = jnp.clip(jax.nn.sigmoid(y), 1e-7, 1.0 - 1e-7)
        xr = lo + span * s
        ll = loglik(params, xr)
        if log_prior is not None:
            ll = ll + _resolve_log_prior(log_prior)(xr)
        g = ll + jnp.sum(
            jax.nn.log_sigmoid(y) + jax.nn.log_sigmoid(-y),
            axis=-1,
        )
        return g - logq, xr

    return jax.jit(run)


def fit_flow(
    valgrad,
    params,
    *,
    n_steps: int = 1500,
    n_mc: int = 256,
    n_layers: int = 6,
    width: int = 64,
    bounds=None,
    learning_rate: float = 3e-3,
    seed: int = 0,
    x0=None,
    log_prior=None,
    warm_start: bool = True,
    warm_steps: int = 400,
) -> FlowResult:
    """Fit a RealNVP flow to the posterior by reparameterized ELBO
    ascent — :func:`tpu21cmvae.vi.fit_advi`'s drop-in upgrade for
    non-Gaussian (curved, skewed) posteriors.

    ``valgrad(params, raw) → (logL, ∇logL)`` — the fused
    value+gradient path (``model.loglik_and_grad_fn``); only
    first-order gradients are used (the ELBO cotangent pulls back
    through the flow in one ``vjp``). ``x0``: optional raw-space
    center for the base Gaussian (e.g. ``fit_map(...).best``).
    ``log_prior``: optional smooth prior added to the target. The fit
    is ONE ``lax.scan`` device program; Adam with cosine learning-rate
    decay, mirroring :func:`~tpu21cmvae.vi.fit_advi` (whose 0.05 rate
    is far too hot for conditioner weights — measured divergence;
    3e-3 with the near-identity init is stable across seeds).

    Check ``FlowResult.elbo``: a tail still climbing means raise
    ``n_steps``. For a unimodal, roughly-Gaussian posterior ADVI
    reaches the same ELBO in fewer steps — the flow pays off exactly
    when the two ELBOs separate (see ``tests/test_flows.py``'s banana
    target, and the ``khat`` comparison in :func:`flow_evidence`).
    Default budget, measured on that curved-ridge target: 600 steps
    left the IS tail heavy (khat 0.82); 1,500 steps reach khat 0.44
    with a 94 % weight ESS where the adaptive-t Laplace stage sits at
    16 % — each step is one ``n_mc``-row valgrad batch, microseconds
    at the measured ~4×10⁷ ∇logL/s (docs/PERF.md).

    ``warm_start`` (default True): seed the flow's full-rank Gaussian
    base from a ``warm_steps``-step :func:`~tpu21cmvae.vi.fit_advi`
    run, so the couplings start from the best ELLIPSOID and only
    learn the bend. This is load-bearing on sharp posteriors: on the
    shipped trained checkpoint's ~10⁵-nat-dynamic-range posterior a
    cold wide start left the evidence weights unusable (ESS 29/16k,
    khat 1.04) while the warm-started fit is healthy (see
    docs/PERF.md). Set False only for deliberately cheap targets.
    """
    lo, hi = _resolve_bounds(bounds)
    n_params = int(lo.shape[0])
    span = hi - lo
    mu0 = None if x0 is None else _whitened_center(x0, lo, hi)
    masks = _masks(n_params, n_layers)
    key = jax.random.key(seed)
    k_init, k_fit = jax.random.split(key)
    chol0 = None
    if warm_start:
        from tpu21cmvae.vi import fit_advi

        adv = fit_advi(valgrad, params, n_steps=warm_steps,
                       n_mc=n_mc, bounds=bounds, seed=seed,
                       x0=x0, log_prior=log_prior)
        mu0, chol0 = jnp.asarray(adv.mu, jnp.float32), adv.chol
    theta0 = init_flow(k_init, n_params, n_layers=n_layers,
                       width=width, mu0=mu0, chol0=chol0)

    fcfg = _FlowFitProgram(
        n_steps=int(n_steps),
        n_mc=int(n_mc),
        n_layers=int(n_layers),
        width=int(width),
        learning_rate=float(learning_rate),
    )
    run = _chain_program(
        valgrad,
        _auto_key(fcfg, lo, hi, log_prior),
        lambda: _build_flow_fit_program(valgrad, log_prior, lo, hi, fcfg),
    )
    theta, elbo = run(params, theta0, jax.random.split(k_fit, n_steps))
    return FlowResult(
        theta=jax.tree_util.tree_map(np.asarray, theta),
        masks=masks,
        elbo=np.asarray(elbo),
        _lo=np.asarray(lo, np.float64),
        _hi=np.asarray(hi, np.float64),
    )


def evidence_with_flow(
    loglik,
    valgrad,
    params,
    *,
    bounds=None,
    n_is: int = 16384,
    seed: int = 0,
    log_prior=None,
    flow: Optional["FlowResult"] = None,
    **fit_kwargs,
) -> "FlowEvidenceResult":
    """The ``method="flow"`` body shared by every model family's
    ``log_evidence`` (one implementation — the four families'
    per-method blocks stay one-liners): fit a flow on the fused
    value+gradient path, then importance-sample the evidence through
    it with the VALUE function. Pass ``flow=`` to reuse a fit (e.g.
    from :meth:`DirectEmulator.fit_flow`) and skip straight to the IS
    sweep; remaining kwargs go to :func:`fit_flow`."""
    if flow is None:
        flow = fit_flow(valgrad, params, bounds=bounds, seed=seed,
                        log_prior=log_prior, **fit_kwargs)
    elif fit_kwargs:
        raise ValueError(
            "fit kwargs and a prefitted flow= are mutually exclusive; "
            f"got both (kwargs {sorted(fit_kwargs)})"
        )
    res = flow_evidence(loglik, params, flow, bounds=bounds,
                        n_is=n_is, seed=seed + 1,
                        log_prior=log_prior)
    res.flow = flow
    return res


@dataclasses.dataclass
class FlowEvidenceResult:
    """Flow-proposal importance-sampled evidence from
    :func:`flow_evidence`.

    ``logz`` / ``logz_err``: evidence under the box-normalized prior
    (the shared convention of every evidence path here) with its MC
    error. ``khat``: Pareto-smoothed-importance-sampling tail
    diagnostic (Vehtari et al. 2021) — < 0.7 means the flow covers the
    posterior and the estimate is trustworthy; ≥ 0.7 means refit the
    flow (more steps/layers) or fall back to ``method="nested"``.
    ``is_ess``: Kish effective sample size of the weights.
    :meth:`posterior` importance-resamples raw-parameter draws.
    """

    logz: float
    logz_err: float
    khat: float
    is_ess: float
    n_draws: int
    _x: np.ndarray
    _logw: np.ndarray
    #: the proposal that produced the estimate (set by
    #: :func:`evidence_with_flow` so callers can reuse/refit it)
    flow: Optional["FlowResult"] = None

    def posterior(self, n: int, seed: int = 0) -> np.ndarray:
        w = np.exp(self._logw - self._logw.max())
        w /= w.sum()
        idx = np.random.default_rng(seed).choice(
            self._x.shape[0], size=n, p=w
        )
        return self._x[idx]

    def summary(self) -> str:
        return (
            f"log Z = {self.logz:.2f} ± {self.logz_err:.2f} "
            f"(flow-IS, {self.n_draws} draws, "
            f"ESS {self.is_ess:.0f}, khat {self.khat:.2f})"
        )


def flow_evidence(
    loglik,
    params,
    flow: FlowResult,
    *,
    n_is: int = 16384,
    bounds=None,
    seed: int = 0,
    log_prior=None,
) -> FlowEvidenceResult:
    """Importance-sampled ``log Z`` with a fitted flow as the proposal
    — the estimator for the curved-ridge posteriors where the adaptive
    Student-t behind :func:`~tpu21cmvae.sampling.laplace_evidence`
    measurably saturates at ``khat ≥ 0.7`` (docs/PERF.md): the flow
    proposal FOLLOWS the ridge, so the weights stay bounded.

    One batched device call: draw ``n_is`` flow samples, evaluate the
    whitened target ``g(y) = logL (+ logπ_raw) + Σ log σ'(y)`` and the
    exact flow density, Pareto-smooth the weights
    (:func:`~tpu21cmvae.sampling._psis`), and report under the
    box-normalized-prior convention
    (:func:`~tpu21cmvae.sampling._prior_log_box_mean`). Asymptotically
    exact for any fixed flow (the proposal only sets the weight
    variance — same argument as the Laplace IS stage); ``khat`` is the
    trust signal. ``bounds``/``log_prior`` MUST match the fit.
    """
    lo, hi = _resolve_bounds(bounds)
    if not (
        np.array_equal(np.asarray(lo, np.float64), flow._lo)
        and np.array_equal(np.asarray(hi, np.float64), flow._hi)
    ):
        raise ValueError(
            "bounds do not match the box the flow was fitted in "
            f"(fit lo={flow._lo.tolist()} hi={flow._hi.tolist()}); "
            "pass the same bounds= used for fit_flow, or refit"
        )
    span = hi - lo
    n_params = int(lo.shape[0])
    prior_lbm = _prior_log_box_mean(log_prior, lo, hi)
    masks = flow.masks
    theta = jax.tree_util.tree_map(jnp.asarray, flow.theta)

    # masks keyed as an array extra: the program closes over the mask
    # stack, so a flow with a different layer count/pattern must not
    # hit a stale entry (zip would silently truncate the coupling stack)
    icfg = _FlowISProgram(n_is=int(n_is))
    run = _chain_program(
        loglik,
        _auto_key(icfg, lo, hi, log_prior, np.asarray(masks)),
        lambda: _build_flow_is_program(
            loglik, log_prior, lo, hi, masks, icfg
        ),
    )
    logw, xr = run(params, theta, jax.random.key(seed))
    logw = np.asarray(logw, np.float64)
    logw = np.where(np.isfinite(logw), logw, -np.inf)
    logw, khat = _psis(logw)
    m = logw.max()
    w = np.exp(logw - m)
    mean_w = float(w.mean())
    return FlowEvidenceResult(
        logz=float(m + np.log(mean_w)) - prior_lbm,
        logz_err=float(
            w.std(ddof=1) / (np.sqrt(float(w.size)) * mean_w)
        ),
        khat=float(khat),
        is_ess=float(w.sum() ** 2 / (w * w).sum()),
        n_draws=int(n_is),
        _x=np.asarray(xr, np.float32),
        _logw=logw,
    )


@dataclasses.dataclass(frozen=True)
class _FlowFitBatchProgram:
    """Statics of :func:`_build_flow_fit_batch_program`, keyed in full
    (``sampling/_common.py::_auto_key``)."""

    n_obs: int
    n_steps: int
    n_mc: int
    n_layers: int
    width: int
    learning_rate: float


def _build_flow_fit_batch_program(valgrad_multi, log_prior, lo, hi, cfg):
    """Module-level batched flow-ELBO-ascent builder — no free
    variables. ``n_obs`` INDEPENDENT RealNVP flows advance under one
    Adam; per step, every flow's ``n_mc`` reparameterized draws ride
    ONE observation-major ``(n_obs·n_mc)``-row valgrad batch, and the
    per-flow parameter gradients come back through a single ``vjp`` of
    the vmapped forward (rows are independent, so the stacked Jacobian
    is block-diagonal by construction)."""
    span = hi - lo
    n_params = int(lo.shape[0])
    n_obs, n_steps, n_mc = cfg.n_obs, cfg.n_steps, cfg.n_mc
    learning_rate = cfg.learning_rate
    masks = _masks(n_params, cfg.n_layers)
    integrand_val_grad = _whitened_vi_target(
        valgrad_multi, lo, span, log_prior, span_jac=False
    )
    b1, b2, eps_adam = 0.9, 0.999, 1e-8
    h_base = 0.5 * n_params * math.log(2.0 * math.pi * math.e)
    fwd = jax.vmap(lambda th, zz: flow_forward(th, zz, masks))

    def make_step(params):
        def step(state, tk):
            t, k = tk
            theta, m, v = state
            z = jax.random.normal(
                k, (n_obs, n_mc, n_params), jnp.float32
            )
            (y, logdet), pull = jax.vjp(
                lambda th: fwd(th, z), theta
            )
            f, g_y = integrand_val_grad(
                params, y.reshape(-1, n_params)
            )
            f = f.reshape(n_obs, n_mc)
            g_y = jnp.where(jnp.isfinite(g_y), g_y, 0.0).reshape(
                n_obs, n_mc, n_params
            )
            # ∂/∂θ_o E[f + logdet] for every o at once: one pullback,
            # block-diagonal across the stacked flows
            (g_th,) = pull((
                g_y / n_mc,
                jnp.full((n_obs, n_mc), 1.0 / n_mc),
            ))
            elbo = f.mean(axis=1) + logdet.mean(axis=1) + h_base
            m = jax.tree_util.tree_map(
                lambda mm, gg: b1 * mm + (1 - b1) * gg, m, g_th
            )
            v = jax.tree_util.tree_map(
                lambda vv, gg: b2 * vv + (1 - b2) * gg * gg, v, g_th
            )
            lr = learning_rate * (0.05 + 0.95 * 0.5 * (
                1.0 + jnp.cos(jnp.pi * (t - 1.0) / n_steps)
            ))
            theta = jax.tree_util.tree_map(
                lambda p, mm, vv: p + lr * (mm / (1 - b1**t)) / (
                    jnp.sqrt(vv / (1 - b2**t)) + eps_adam
                ),
                theta, m, v,
            )
            return (theta, m, v), elbo

        return step

    def run(params, theta, keys):
        zeros = jax.tree_util.tree_map(jnp.zeros_like, theta)
        state = (theta, zeros, zeros)
        (theta, _, _), elbo = jax.lax.scan(
            make_step(params), state,
            (jnp.arange(1, n_steps + 1, dtype=jnp.float32), keys),
        )
        return theta, elbo

    return jax.jit(run)


def fit_flow_batch(
    valgrad_multi,
    params,
    n_obs: int,
    *,
    n_steps: int = 1500,
    n_mc: int = 256,
    n_layers: int = 6,
    width: int = 64,
    bounds=None,
    learning_rate: float = 3e-3,
    seed: int = 0,
    x0=None,
    log_prior=None,
    warm_start: bool = True,
    warm_steps: int = 400,
) -> list:
    """Batched :func:`fit_flow`: fit ``n_obs`` independent RealNVP
    flows — one per observation of a stacked likelihood — as ONE
    device program (round-4 VERDICT item 6: the real-batch escalation
    ran 35 per-row flow fits sequentially, 1,294 s of a 1,362 s wall).

    ``valgrad_multi(params, raw (O·W, P)) → ((O·W,), (O·W, P))`` is
    the stacked value+gradient path
    (:func:`tpu21cmvae.ops.loglik.make_loglik_and_grad_multi`).
    ``x0``: optional ``(n_obs, P)`` per-row raw-space centers (the
    batched Laplace sweep's MAPs — the same warm start the per-row
    path applies). ``warm_start`` seeds every flow's full-rank base
    from a BATCHED ADVI run (:func:`tpu21cmvae.vi.fit_advi_batch`),
    exactly mirroring the single-row policy measured load-bearing on
    sharp posteriors (docs/PERF.md). Returns ``n_obs``
    :class:`FlowResult`, ordered like the observations.
    """
    from tpu21cmvae.sampling._common import _chain_program

    lo, hi = _resolve_bounds(bounds)
    n_params = int(lo.shape[0])
    masks = _masks(n_params, n_layers)
    key = jax.random.key(seed)
    k_init, k_fit = jax.random.split(key)
    mu0 = chol0 = None
    if x0 is not None:
        x0 = np.atleast_2d(np.asarray(x0, np.float64))
        if x0.shape != (n_obs, n_params):
            raise ValueError(
                f"x0 must be ({n_obs}, {n_params}) row centers; "
                f"got {x0.shape}"
            )
    if warm_start:
        from tpu21cmvae.vi import fit_advi_batch

        adv = fit_advi_batch(
            valgrad_multi, params, n_obs, n_steps=warm_steps,
            n_mc=n_mc, bounds=bounds, seed=seed, x0=x0,
            log_prior=log_prior,
        )
        mu0 = np.stack([a.mu for a in adv])
        chol0 = np.stack([a.chol for a in adv])
    elif x0 is not None:
        lo64 = np.asarray(lo, np.float64)
        span64 = np.asarray(hi, np.float64) - lo64
        frac = np.clip((x0 - lo64) / span64, 1e-4, 1.0 - 1e-4)
        mu0 = np.log(frac / (1.0 - frac))
    thetas = []
    for o in range(n_obs):
        thetas.append(init_flow(
            jax.random.fold_in(k_init, o), n_params,
            n_layers=n_layers, width=width,
            mu0=None if mu0 is None else jnp.asarray(mu0[o], jnp.float32),
            chol0=None if chol0 is None else chol0[o],
        ))
    theta0 = jax.tree_util.tree_map(
        lambda *xs: jnp.stack(xs), *thetas
    )

    cfg = _FlowFitBatchProgram(
        n_obs=int(n_obs),
        n_steps=int(n_steps),
        n_mc=int(n_mc),
        n_layers=int(n_layers),
        width=int(width),
        learning_rate=float(learning_rate),
    )
    run = _chain_program(
        valgrad_multi,
        _auto_key(cfg, lo, hi, log_prior),
        lambda: _build_flow_fit_batch_program(
            valgrad_multi, log_prior, lo, hi, cfg
        ),
    )
    theta, elbo = run(params, theta0, jax.random.split(k_fit, n_steps))
    theta = jax.tree_util.tree_map(np.asarray, theta)
    elbo = np.asarray(elbo)
    lo64 = np.asarray(lo, np.float64)
    hi64 = np.asarray(hi, np.float64)
    return [
        FlowResult(
            theta=jax.tree_util.tree_map(lambda le, o=o: le[o], theta),
            masks=masks,
            elbo=elbo[:, o],
            _lo=lo64,
            _hi=hi64,
        )
        for o in range(n_obs)
    ]


@dataclasses.dataclass(frozen=True)
class _FlowISBatchProgram:
    """Statics of :func:`_build_flow_is_batch_program`, keyed in
    full; the mask stack is keyed as an array extra."""

    n_obs: int
    n_is: int


def _build_flow_is_batch_program(loglik_multi, log_prior, lo, hi,
                                 masks, cfg):
    """Module-level batched flow-IS builder — no free variables. One
    call draws every flow's ``n_is`` samples and scores them through
    ONE observation-major stacked-likelihood batch."""
    span = hi - lo
    n_params = int(lo.shape[0])
    n_obs, n_is = cfg.n_obs, cfg.n_is
    fwd = jax.vmap(lambda th, zz: flow_forward(th, zz, masks))

    def run(params, theta, key):
        z = jax.random.normal(
            key, (n_obs, n_is, n_params), jnp.float32
        )
        y, logdet = fwd(theta, z)
        logq = _base_logpdf(
            z.reshape(-1, n_params)
        ).reshape(n_obs, n_is) - logdet
        s = jnp.clip(jax.nn.sigmoid(y), 1e-7, 1.0 - 1e-7)
        xr = (lo + span * s).reshape(-1, n_params)
        ll = loglik_multi(params, xr)
        if log_prior is not None:
            ll = ll + _resolve_log_prior(log_prior)(xr)
        yf = y.reshape(-1, n_params)
        g = ll + jnp.sum(
            jax.nn.log_sigmoid(yf) + jax.nn.log_sigmoid(-yf), axis=-1
        )
        return g.reshape(n_obs, n_is) - logq, xr.reshape(
            n_obs, n_is, n_params
        )

    return jax.jit(run)


def flow_evidence_batch(
    loglik_multi,
    params,
    flows,
    *,
    n_is: int = 16384,
    bounds=None,
    seed: int = 0,
    log_prior=None,
) -> list:
    """Batched :func:`flow_evidence`: one device call draws and scores
    every row's ``n_is`` importance samples through the stacked
    likelihood; the per-row PSIS smoothing runs host-side. ``flows``:
    the ``n_obs`` :class:`FlowResult` (same architecture — one mask
    stack) from :func:`fit_flow_batch`. Returns ``n_obs``
    :class:`FlowEvidenceResult`."""
    from tpu21cmvae.sampling._common import _chain_program

    lo, hi = _resolve_bounds(bounds)
    n_obs = len(flows)
    for fl in flows:
        if not (
            np.array_equal(np.asarray(lo, np.float64), fl._lo)
            and np.array_equal(np.asarray(hi, np.float64), fl._hi)
        ):
            raise ValueError(
                "bounds do not match the box the flows were fitted in"
            )
        if not np.array_equal(np.asarray(fl.masks),
                              np.asarray(flows[0].masks)):
            raise ValueError(
                "flow_evidence_batch needs one shared architecture; "
                "got differing mask stacks"
            )
    masks = flows[0].masks
    prior_lbm = _prior_log_box_mean(log_prior, lo, hi)
    theta = jax.tree_util.tree_map(
        lambda *xs: jnp.stack([jnp.asarray(x) for x in xs]),
        *[fl.theta for fl in flows]
    )
    icfg = _FlowISBatchProgram(n_obs=int(n_obs), n_is=int(n_is))
    run = _chain_program(
        loglik_multi,
        _auto_key(icfg, lo, hi, log_prior, np.asarray(masks)),
        lambda: _build_flow_is_batch_program(
            loglik_multi, log_prior, lo, hi, masks, icfg
        ),
    )
    logw_all, xr_all = run(params, theta, jax.random.key(seed))
    logw_all = np.asarray(logw_all, np.float64)
    xr_all = np.asarray(xr_all, np.float32)
    out = []
    for o in range(n_obs):
        logw = np.where(np.isfinite(logw_all[o]), logw_all[o], -np.inf)
        logw, khat = _psis(logw)
        m = logw.max()
        w = np.exp(logw - m)
        mean_w = float(w.mean())
        out.append(FlowEvidenceResult(
            logz=float(m + np.log(mean_w)) - prior_lbm,
            logz_err=float(
                w.std(ddof=1) / (np.sqrt(float(w.size)) * mean_w)
            ),
            khat=float(khat),
            is_ess=float(w.sum() ** 2 / (w * w).sum()),
            n_draws=int(n_is),
            _x=xr_all[o],
            _logw=logw,
        ))
    return out


def evidence_with_flow_batch(
    loglik_multi,
    valgrad_multi,
    params,
    n_obs: int,
    *,
    bounds=None,
    n_is: int = 16384,
    seed: int = 0,
    log_prior=None,
    **fit_kwargs,
) -> list:
    """Batched :func:`evidence_with_flow`: fit ``n_obs`` flows as one
    program (:func:`fit_flow_batch`), then importance-sample every
    evidence in one stacked sweep (:func:`flow_evidence_batch`).
    The per-row results carry their fitted flow in ``.flow``, exactly
    like the sequential path."""
    flows = fit_flow_batch(
        valgrad_multi, params, n_obs, bounds=bounds, seed=seed,
        log_prior=log_prior, **fit_kwargs,
    )
    out = flow_evidence_batch(
        loglik_multi, params, flows, bounds=bounds, n_is=n_is,
        seed=seed + 1, log_prior=log_prior,
    )
    for r, fl in zip(out, flows):
        r.flow = fl
    return out
