"""Gradient-based samplers over the fused value+gradient likelihood:
HMC (:func:`sample_hmc`), ChEES-adapted HMC (:func:`sample_chees`), and
iterative NUTS (:func:`sample_nuts`), plus the shared whitening map and
metric (mass-matrix) machinery.

Split from the round-3 ``sampling.py`` monolith with zero behavior
change; see the package ``__init__`` for the map.
"""

from __future__ import annotations

import dataclasses
from typing import Optional

import jax
import jax.numpy as jnp
import numpy as np

from tpu21cmvae.sampling._common import (
    _auto_key,
    _chain_program,
    _init_walkers,
    _log_prior_val_grad,
    _resolve_bounds,
    _shard_walkers,
    _thin_state,
    _thin_write,
    _to_host,
)
from tpu21cmvae.sampling.results import SampleResult

def _whiten_init(x, lo, span):
    """Raw box coordinates → unbounded sigmoid-whitened ``y``
    (clipped 1e-4 inside the box so boundary starts stay finite)."""
    frac = jnp.clip((x - lo) / span, 1e-4, 1.0 - 1e-4)
    return jnp.log(frac / (1.0 - frac))


def _whitened_target(valgrad, log_prior, lo, span):
    """The gradient-based samplers' shared target: ``(to_params,
    logp_and_grad)`` over the sigmoid-whitened ``y``-space. ``lp`` is
    the log-posterior INCLUDING the log-Jacobian of the sigmoid map (so
    the flat box prior is exact in ``y``), ``glp`` its gradient via the
    chain rule — the one place the raw-space ``valgrad`` and optional
    smooth ``log_prior`` meet the whitening (see module docstring)."""

    def to_params(y):
        return lo + span * jax.nn.sigmoid(y)

    def logp_and_grad(params, y):
        xr = to_params(y)
        ll, g_raw = valgrad(params, xr)
        if log_prior is not None:
            lpr, g_pr = _log_prior_val_grad(log_prior, xr)
            ll = ll + lpr
            g_raw = g_raw + g_pr
        s = jax.nn.sigmoid(y)
        lp = ll + jnp.sum(
            jax.nn.log_sigmoid(y) + jax.nn.log_sigmoid(-y), axis=-1
        )
        glp = g_raw * (span * s * (1.0 - s)) + (1.0 - 2.0 * s)
        return lp, glp

    return to_params, logp_and_grad


def _whitened_center(x0, lo, hi):
    """Raw-space center → whitened ``mu0`` (float32), the shared
    ``x0=`` handling of :func:`tpu21cmvae.vi.fit_advi` and
    :func:`tpu21cmvae.flows.fit_flow`. Host-side float64 on purpose
    (a one-off conversion; float32 logit loses digits near the box
    edge). Raises if ``x0`` is not a single ``(P,)`` center."""
    lo = np.asarray(lo, np.float64)
    span = np.asarray(hi, np.float64) - lo
    frac = np.clip(
        (np.asarray(x0, np.float64) - lo) / span, 1e-4, 1.0 - 1e-4
    )
    mu0 = jnp.asarray(np.log(frac / (1.0 - frac)), jnp.float32)
    if mu0.shape != lo.shape:
        raise ValueError(
            f"x0 must be a single ({lo.shape[0]},) center; "
            f"got {np.shape(x0)}"
        )
    return mu0


def _whitened_vi_target(valgrad, lo, span, log_prior, *, span_jac):
    """The variational fitters' shared ELBO integrand: ``(params, y) →
    (target value, y-gradient)`` over the sigmoid-whitened space, using
    only the FIRST-order ``valgrad`` (reparameterization trick). The
    sigmoid is clamped because float32 saturates to exactly 0/1 at
    |y|≳17, which would poison the span-Jacobian with log(0).

    Two equivalent log-Jacobian conventions, chosen by ``span_jac``
    (they differ by the constant ``Σ log span``, which shifts the ELBO
    but not its gradient): ``True`` → ``Σ log(span·s·(1−s))``, the ADVI
    convention (:func:`tpu21cmvae.vi.fit_advi`); ``False`` →
    ``Σ [log σ(y) + log σ(−y)]``, the chain-sampler convention
    (:func:`_whitened_target`) that :func:`tpu21cmvae.flows.fit_flow`
    shares so its ELBO and the flow-IS weights cancel the box volume
    exactly (see :func:`tpu21cmvae.flows.flow_evidence`)."""

    def val_grad(params, y):
        s = jnp.clip(jax.nn.sigmoid(y), 1e-7, 1.0 - 1e-7)
        xr = lo + span * s
        ll, g_raw = valgrad(params, xr)
        if log_prior is not None:
            lpr, g_pr = _log_prior_val_grad(log_prior, xr)
            ll = ll + lpr
            g_raw = g_raw + g_pr
        if span_jac:
            jac = jnp.sum(jnp.log(span * s * (1.0 - s)), axis=-1)
        else:
            jac = jnp.sum(
                jax.nn.log_sigmoid(y) + jax.nn.log_sigmoid(-y), axis=-1
            )
        g_y = g_raw * (span * s * (1.0 - s)) + (1.0 - 2.0 * s)
        return ll + jac, g_y

    return val_grad


def _ens_metric(y, dense):
    """Ensemble-statistics metric from the cross-walker spread of ``y``.

    ``dense=False``: per-dimension std, normalized to unit geometric
    mean (dual averaging owns the GLOBAL step scale) and clipped to
    [0.1, 10] so a not-yet-spread dimension cannot zero its step.

    ``dense=True``: the symmetric square root ``L = V·√w·Vᵀ`` of the
    cross-walker covariance, eigenvalues normalized to unit geometric
    mean and clipped to [0.01, 100] (the diagonal clip squared). The
    leapfrog then integrates in the ``L``-whitened space, which removes
    cross-parameter CORRELATIONS the diagonal metric cannot see — on
    correlated posteriors NUTS trees shrink and ChEES trajectories
    shorten accordingly (docs/PERF.md). The covariance deliberately
    uses the FULL ensemble, unconverged stragglers included: their
    spread gives the not-yet-contracted directions large early steps
    (a top-half-by-log-density estimate was measured WORSE — it starves
    exactly those directions). D is tiny here (7), so the eigh and the
    per-step (B,D)@(D,D) matmuls are negligible against the emulator
    chain. Under a sharded walker axis the reductions are GSPMD
    collectives — still one program.
    """
    if not dense:
        raw_sd = jnp.std(y, axis=0)
        sd = raw_sd / jnp.maximum(jnp.exp(
            jnp.mean(jnp.log(jnp.maximum(raw_sd, 1e-6)))
        ), 1e-6)
        return jnp.clip(sd, 0.1, 10.0)
    d = y.shape[1]
    yc = y - jnp.mean(y, axis=0)
    cov = yc.T @ yc / y.shape[0] + 1e-10 * jnp.eye(d, dtype=y.dtype)
    w, v = jnp.linalg.eigh(cov)
    w = jnp.maximum(w, 1e-12)
    w = w / jnp.exp(jnp.mean(jnp.log(w)))
    w = jnp.clip(w, 1e-2, 1e2)
    return (v * jnp.sqrt(w)) @ v.T


def _met_scale(met, v):
    """Metric-space momentum → y-space displacement (``L v``).
    ``met``: (D,) shared diagonal, (B, D) per-walker diagonal (the
    per-block metrics of the batched-observation samplers, expanded to
    rows), or (1|B, D, D) square roots — shared dense carries a leading
    broadcast axis (see :func:`_ens_metric_blocks`) because a bare
    (D, D) would be indistinguishable from a per-walker diagonal
    whenever ``n_walkers == D``. Rank alone now dispatches: ≤2 is
    elementwise diagonal, 3 is a (batched or broadcast) matmul."""
    if met.ndim <= 2:
        return v * met
    return jnp.squeeze(jnp.matmul(met, v[..., None]), -1)


def _met_pull(met, g):
    """y-space gradient → metric-space force (``Lᵀ g``); shapes as in
    :func:`_met_scale`."""
    if met.ndim <= 2:
        return g * met
    return jnp.squeeze(
        jnp.matmul(jnp.swapaxes(met, -1, -2), g[..., None]), -1
    )


def _ens_metric_blocks(y, dense, n_blk):
    """Per-block ensemble metric for batched-observation chains: each
    contiguous walker slab (one observation's posterior) gets its OWN
    cross-walker metric — a pooled metric over a MIXTURE of posteriors
    measures the between-observation spread of the truths, not any
    posterior's geometry. Returns per-walker rows ((B, D) diagonals /
    (B, D, D) square roots) for the per-walker :func:`_met_scale` /
    :func:`_met_pull` paths; the ``n_blk == 1`` dense metric is lifted
    to (1, D, D) so rank disambiguates it from a per-walker diagonal."""
    if n_blk == 1:
        met = _ens_metric(y, dense)
        return met[None] if dense else met
    w = y.shape[0] // n_blk
    yb = y.reshape(n_blk, w, y.shape[1])
    mets = jax.vmap(lambda yy: _ens_metric(yy, dense))(yb)
    return jnp.repeat(mets, w, axis=0)


def _resolve_metric(metric, precondition, n_warmup, n_walkers,
                    auto_dense):
    """Shared policy for the gradient samplers: returns ``(use_metric,
    dense)``. ``metric``: "dense", "diag", or "auto" — which resolves
    per sampler (``auto_dense``). As of round 4 every sampler's "auto"
    resolves DIAG: on the production posterior dense NUTS carries a
    seed-dependent 0.2-1.2 % divergence rate (walker-local sharp
    curvature the 0.8-target global step cannot respect — a third
    ε-re-adaptation window was built and measured WORSE, see
    docs/PERF.md round-4 A/B) and 17-25 % LOWER min-ESS/s than diag,
    while HMC/ChEES measured the diag preference in round 3 (a rotation
    from a still-converging ensemble starves sharp-posterior
    stragglers). ``metric="dense"`` stays the documented opt-in for
    correlated targets, where it collapses NUTS trees ~6× and makes
    fixed-L HMC exact (docs/PERF.md)."""
    if metric not in ("auto", "dense", "diag"):
        raise ValueError(
            f'metric must be "auto", "dense" or "diag"; got {metric!r}'
        )
    use_metric = precondition and n_warmup >= 20 and n_walkers >= 16
    dense = metric == "dense" or (metric == "auto" and auto_dense)
    return use_metric, use_metric and dense


@dataclasses.dataclass(frozen=True)
class _HmcProgram:
    """Every static :func:`_build_hmc_program` bakes into its closure;
    the cache key is ALL fields automatically (:func:`_auto_key`).
    Phase structure (warmup split, metric use) is DERIVED from these
    fields via :meth:`phases`, so it can never escape the key — the
    round-4 bug class (a hand-assembled key missing one baked boolean,
    measured at 99 % NUTS divergences) is structurally closed."""

    n_walkers: int
    n_warmup: int
    n_leapfrog: int
    target_accept: float
    init_step: float
    adapt_blocks: int
    thin: int
    jitter: bool
    precondition: bool
    metric: str

    def phases(self):
        use_metric, dense = _resolve_metric(
            self.metric, self.precondition, self.n_warmup,
            self.n_walkers, auto_dense=False,
        )
        n_warm1 = self.n_warmup // 2 if use_metric else self.n_warmup
        return use_metric, dense, n_warm1


def _build_hmc_program(valgrad, log_prior, lo, hi, cfg):
    """Module-level program builder for :func:`sample_hmc` — no free
    variables: every static comes from ``cfg`` or the keyed
    ``(lo, hi, log_prior)``. Returns ``(to_params, run)``."""
    span = hi - lo
    to_params, logp_and_grad = _whitened_target(
        valgrad, log_prior, lo, span
    )
    use_metric, dense, n_warm1 = cfg.phases()
    n_blk = cfg.adapt_blocks
    thin = cfg.thin
    n_leapfrog = cfg.n_leapfrog
    target_accept = cfg.target_accept
    l_min = max(1, (n_leapfrog + 1) // 2)

    def draw_l(k):
        if not cfg.jitter or l_min == n_leapfrog:
            return jnp.int32(n_leapfrog)
        return jax.random.randint(k, (), l_min, n_leapfrog + 1)

    def hmc_step(params, y, lp, glp, met, eps_blk, n_leap, k):
        # ``eps_blk``: (adapt_blocks,) per-block steps, expanded to
        # rows; ``met``: the ensemble metric (a (D,) diagonal or (D,D)
        # dense square root — momenta live in the metric-whitened
        # space, positions in ``y``, the standard mass-matrix
        # equivalence); ``n_leap``: traced leapfrog count.
        eps = jnp.repeat(eps_blk, y.shape[0] // n_blk)[:, None]
        kp, ku = jax.random.split(k)
        p0 = jax.random.normal(kp, y.shape, y.dtype)
        p = p0 + 0.5 * eps * _met_pull(met, glp)

        def leap(_, qpg):
            q, p, g = qpg
            q = q + eps * _met_scale(met, p)
            _, g = logp_and_grad(params, q)
            p = p + eps * _met_pull(met, g)
            return q, p, g

        q, p, g = jax.lax.fori_loop(0, n_leap - 1, leap, (y, p, glp))
        q = q + eps * _met_scale(met, p)
        lp_new, g_new = logp_and_grad(params, q)
        p = p + 0.5 * eps * _met_pull(met, g_new)
        dh = (lp_new - lp) - 0.5 * (jnp.sum(p**2, -1) - jnp.sum(p0**2, -1))
        acc = jnp.log(jax.random.uniform(ku, (y.shape[0],))) < dh
        # recover walkers with a non-finite current lp (see sample_mh)
        acc = acc | (~jnp.isfinite(lp) & jnp.isfinite(lp_new))
        y = jnp.where(acc[:, None], q, y)
        lp = jnp.where(acc, lp_new, lp)
        glp = jnp.where(acc[:, None], g_new, glp)
        # per-block mean Metropolis probability (capped at 1; NaN dh —
        # diverged trajectory — counts as 0) drives adaptation
        a = jnp.where(
            jnp.isfinite(dh), jnp.minimum(1.0, jnp.exp(dh)), 0.0
        )
        return y, lp, glp, a.reshape(n_blk, -1).mean(axis=1)

    # dual averaging (Hoffman & Gelman 2014, Alg. 5) — all in-carry;
    # ``mu`` is traced so a post-preconditioning restart can re-anchor
    gamma, t0, kappa = 0.05, 10.0, 0.75

    def make_warm_step(params):
        def warm_step(state, ik):
            i, k = ik
            kl, kh = jax.random.split(k)
            y, lp, glp, sd, mu, log_eps, log_eps_bar, h_bar = state
            y, lp, glp, a_mean = hmc_step(
                params, y, lp, glp, sd, jnp.exp(log_eps), draw_l(kl), kh
            )
            t = i + 1.0
            h_bar = (1.0 - 1.0 / (t + t0)) * h_bar + (
                target_accept - a_mean
            ) / (t + t0)
            log_eps = mu - jnp.sqrt(t) / gamma * h_bar
            w = t ** (-kappa)
            log_eps_bar = w * log_eps + (1.0 - w) * log_eps_bar
            return (
                y, lp, glp, sd, mu, log_eps, log_eps_bar, h_bar
            ), a_mean

        return warm_step

    def warm_phase(params, y, lp, glp, sd, eps0, ik):
        # ``eps0``: (adapt_blocks,) — the dual-averaging state is a
        # per-block vector throughout (every update is elementwise)
        state = (
            y, lp, glp, sd, jnp.log(10.0 * eps0), jnp.log(eps0),
            jnp.log(eps0), jnp.zeros_like(eps0),
        )
        state, _ = jax.lax.scan(make_warm_step(params), state, ik)
        y, lp, glp, _, _, _, log_eps_bar, _ = state
        return y, lp, glp, jnp.exp(log_eps_bar)

    def run(params, y, warm1_ik, warm2_ik, run_keys):
        def run_step(state, tk):
            t, k = tk
            y, lp, glp, sd, eps, buf = state
            kl, kh = jax.random.split(k)
            y, lp, glp, a_mean = hmc_step(
                params, y, lp, glp, sd, eps, draw_l(kl), kh
            )
            if thin:
                buf = _thin_write(
                    buf, t, to_params(y), thin, n_keep
                )
            return (y, lp, glp, sd, eps, buf), jnp.mean(a_mean)

        lp, glp = logp_and_grad(params, y)
        sd = jnp.ones((y.shape[1],), y.dtype)
        eps = jnp.full((n_blk,), cfg.init_step, jnp.float32)
        if n_warm1 > 0:  # static — no hidden warmup on continuation
            y, lp, glp, eps = warm_phase(
                params, y, lp, glp, sd, eps, warm1_ik
            )
        if use_metric:
            sd = _ens_metric_blocks(y, dense, 1)
            y, lp, glp, eps = warm_phase(
                params, y, lp, glp, sd, eps, warm2_ik
            )
            # (no post-warmup metric refresh here: with a FIXED
            # trajectory length the step cannot re-adapt to the
            # refreshed geometry — measured worse on the correlated
            # Gaussian; ChEES/NUTS refresh because their
            # trajectories adapt per step)
        n_keep, buf = _thin_state(run_keys.shape[0], thin, y)
        (y, lp, glp, _, _, buf), rates = jax.lax.scan(
            run_step, (y, lp, glp, sd, eps, buf),
            (jnp.arange(run_keys.shape[0], dtype=jnp.int32),
             run_keys),
        )
        return y, lp, rates, buf[:n_keep], eps

    return to_params, jax.jit(run)


def sample_hmc(
    valgrad,
    params,
    *,
    n_walkers: int = 4096,
    n_steps: int = 200,
    n_warmup: int = 100,
    n_leapfrog: int = 8,
    bounds=None,
    target_accept: float = 0.8,
    init_step: float = 0.01,
    adapt_blocks: int = 1,
    thin: int = 5,
    seed: int = 0,
    x0=None,
    jitter: bool = True,
    precondition: bool = True,
    metric: str = "auto",
    log_prior=None,
    mesh=None,
) -> SampleResult:
    """HMC ensemble over ``valgrad(params, raw) → (logL, dlogL/raw)``.

    ``adapt_blocks=G``: keep G independent dual-averaged step sizes,
    one per contiguous walker block — the batched-observation path
    passes ``G = n_obs`` so each observation's posterior gets its own
    step (see :func:`sample_mh`). The ensemble metric stays POOLED
    across blocks deliberately: it is normalized to unit geometric
    mean (shape only — dual averaging owns the scale), and the per-
    block scale difference is exactly what the per-block step absorbs.

    ``valgrad`` is typically ``DirectEmulator.loglik_and_grad_fn(obs,
    noise_var)`` (the analytic gram value+gradient path).
    Sampling happens in the sigmoid-whitened ``y``-space (flat box prior
    exact via the Jacobian term); warmup adapts the leapfrog step by
    dual averaging toward ``target_accept``, then the sampling phase
    runs at the adapted step. Both phases are single ``lax.scan``
    programs.

    Two robustness features (both valid-MCMC — they change mixing
    speed, never the target):

    * ``precondition`` — a mass matrix from ENSEMBLE statistics:
      halfway through warmup the leapfrog rescales by the cross-walker
      spread of ``y`` (thousands of walkers give an instantaneous
      estimate — no within-chain adaptation windows, the
      accelerator-ensemble analogue of NUTS's metric warmup), and dual
      averaging restarts at the rescaled step. ``metric`` picks the
      shape: ``"diag"`` is the per-dimension std (fixes scale
      mismatches); ``"dense"`` is the symmetric square root of the full
      cross-walker COVARIANCE (additionally removes correlations — the
      leapfrog integrates in the whitened space, a (B,D)@(D,D) matmul
      per half-step, negligible at D=7); ``"auto"`` (default) resolves
      per sampler — diag here and in :func:`sample_chees` (the
      trajectory is frozen after warmup, so a rotation estimated from
      a still-converging ensemble can starve the straggler directions
      — measured), dense in :func:`sample_nuts` (per-walker trees
      re-adapt every draw; see `_resolve_metric`).
    * ``jitter`` — each iteration draws its leapfrog count uniformly
      from ``{⌈n_leapfrog/2⌉ … n_leapfrog}`` (shared by all walkers;
      independent of state, so detailed balance is untouched). Breaks
      the periodic-orbit resonances a fixed trajectory length is
      vulnerable to (Neal 2011 §3.2). The count is a traced scalar: the
      leapfrog runs as a ``lax.fori_loop`` with a dynamic trip count —
      one compiled program, no per-length retraces.

    ``log_prior``: optional SMOOTH traceable log-density over RAW
    parameters added to the target (see :func:`sample_mh` /
    :mod:`tpu21cmvae.priors`); its gradient enters the leapfrog force
    via autodiff, so it must be differentiable inside the box.
    ``mesh``: optional device mesh — walkers shard across it (see
    :func:`sample_mh`); the ensemble-statistics metric's cross-walker
    std is the one (scalar-sized) collective per warmup phase.
    """
    lo, hi = _resolve_bounds(bounds)
    span = hi - lo
    if n_walkers % adapt_blocks:
        raise ValueError(
            f"n_walkers ({n_walkers}) must divide into adapt_blocks "
            f"({adapt_blocks}) equal contiguous blocks"
        )
    key = jax.random.key(seed)
    k_init, k_warm, k_run = jax.random.split(key, 3)
    x = _shard_walkers(
        jnp.asarray(x0, jnp.float32)
        if x0 is not None
        else _init_walkers(k_init, n_walkers, lo, hi),
        mesh,
    )
    y = _whiten_init(x, lo, span)

    # metric estimation needs enough walkers for a stable cross-walker
    # spread and enough warmup for phase 2 to re-adapt the step —
    # all derived inside cfg.phases() from keyed fields
    cfg = _HmcProgram(
        n_walkers=int(y.shape[0]),
        n_warmup=int(n_warmup),
        n_leapfrog=int(n_leapfrog),
        target_accept=float(target_accept),
        init_step=float(init_step),
        adapt_blocks=int(adapt_blocks),
        thin=int(thin),
        jitter=bool(jitter),
        precondition=bool(precondition),
        metric=str(metric),
    )
    _, _, n_warm1 = cfg.phases()  # validates `metric` eagerly too
    to_params, run = _chain_program(
        valgrad,
        _auto_key(cfg, lo, hi, log_prior),
        lambda: _build_hmc_program(valgrad, log_prior, lo, hi, cfg),
    )

    def ik(k, n):
        n = max(n, 1)
        return (jnp.arange(n, dtype=jnp.float32), jax.random.split(k, n))

    k_warm1, k_warm2 = jax.random.split(k_warm)
    run_keys = jax.random.split(k_run, n_steps)
    y, lp, rates, kept, eps = run(
        params, y, ik(k_warm1, n_warm1), ik(k_warm2, n_warmup - n_warm1),
        run_keys,
    )
    chain = (
        _to_host(kept)
        if thin
        else np.empty((0, y.shape[0], y.shape[1]), np.float32)
    )
    return SampleResult(
        chain=chain,
        final=_to_host(to_params(y)),
        logp=_to_host(lp),
        accept_rate=_to_host(rates),
        step_size=float(np.mean(_to_host(eps))),
        block_step_sizes=_to_host(eps),
    )


def _vdc(i):
    """Van der Corput base-2 sequence of a traced int32 index — the
    32-bit reversal of ``i+1`` read as a binary fraction in (0, 1).
    Used as the quasi-random trajectory jitter in :func:`sample_chees`
    (Hoffman, Radul & Sountsov 2021 §4 use the same Halton jitter):
    low-discrepancy coverage of trajectory fractions beats iid uniform
    for both the ChEES gradient estimate and the sampling phase, and it
    is deterministic in the step index — no extra RNG stream."""
    b = (i + 1).astype(jnp.uint32)
    b = ((b & jnp.uint32(0x55555555)) << 1) | ((b & jnp.uint32(0xAAAAAAAA)) >> 1)
    b = ((b & jnp.uint32(0x33333333)) << 2) | ((b & jnp.uint32(0xCCCCCCCC)) >> 2)
    b = ((b & jnp.uint32(0x0F0F0F0F)) << 4) | ((b & jnp.uint32(0xF0F0F0F0)) >> 4)
    b = ((b & jnp.uint32(0x00FF00FF)) << 8) | ((b & jnp.uint32(0xFF00FF00)) >> 8)
    b = (b << 16) | (b >> 16)
    return b.astype(jnp.float32) * jnp.float32(2.0**-32)


@dataclasses.dataclass
class ChEESSampleResult(SampleResult):
    """:class:`SampleResult` from :func:`sample_chees`, plus the
    adapted total trajectory time ``trajectory_length`` (whitened
    ``y``-space units): each iteration integrates for ``u·τ`` — ``u``
    the Halton jitter fraction — so the mean leapfrog count is
    ``≈ τ/(2·step_size)``. A ``trajectory_length`` pinned at
    ``step_size·max_leapfrog`` means the cap bound the adaptation —
    raise ``max_leapfrog``."""

    trajectory_length: float = 0.0


@dataclasses.dataclass(frozen=True)
class _CheesProgram:
    """Statics of :func:`_build_chees_program`, keyed in full
    (:func:`_auto_key`); phase structure derives via :meth:`phases`
    (see :class:`_HmcProgram`)."""

    n_walkers: int
    n_warmup: int
    target_accept: float
    init_step: float
    h0: float
    max_leapfrog: int
    traj_lr: float
    thin: int
    precondition: bool
    metric: str

    def phases(self):
        use_metric, dense = _resolve_metric(
            self.metric, self.precondition, self.n_warmup,
            self.n_walkers, auto_dense=False,
        )
        n_warm1 = self.n_warmup // 2 if use_metric else self.n_warmup
        return use_metric, dense, n_warm1


def _build_chees_program(valgrad, log_prior, lo, hi, cfg):
    """Module-level program builder for :func:`sample_chees` — no free
    variables (see :func:`_auto_key`). Returns ``(to_params, run)``."""
    span = hi - lo
    to_params, logp_and_grad = _whitened_target(
        valgrad, log_prior, lo, span
    )
    use_metric, dense, n_warm1 = cfg.phases()
    thin = cfg.thin
    n_warmup = cfg.n_warmup
    max_leapfrog = cfg.max_leapfrog
    target_accept = cfg.target_accept
    traj_lr = cfg.traj_lr
    gamma, t0, kappa = 0.05, 10.0, 0.75  # dual averaging (H&G Alg. 5)
    b1, b2, adam_eps = 0.9, 0.99, 1e-8  # Adam on log τ
    log_cap = float(np.log(max_leapfrog))

    def chees_step(params, y, lp, glp, sd, eps_s, h, u, k, want_grad):
        # ``eps_s``: scalar step; ``sd``: the ensemble metric ((D,)
        # diagonal or (D,D) dense square root); ``h``: total trajectory
        # time; ``u``: this iteration's jitter fraction. ``want_grad``
        # is static — the sampling phase skips the ChEES-gradient
        # arithmetic (and its cross-walker mean).
        n_leap = jnp.clip(
            jnp.ceil(u * h / eps_s).astype(jnp.int32), 1, max_leapfrog
        )
        kp, ku = jax.random.split(k)
        p0 = jax.random.normal(kp, y.shape, y.dtype)
        p = p0 + 0.5 * eps_s * _met_pull(sd, glp)

        def leap(_, qpg):
            q, p, g = qpg
            q = q + eps_s * _met_scale(sd, p)
            _, g = logp_and_grad(params, q)
            p = p + eps_s * _met_pull(sd, g)
            return q, p, g

        q, p, g = jax.lax.fori_loop(0, n_leap - 1, leap, (y, p, glp))
        q = q + eps_s * _met_scale(sd, p)
        lp_new, g_new = logp_and_grad(params, q)
        p_end = p + 0.5 * eps_s * _met_pull(sd, g_new)
        dh = (lp_new - lp) - 0.5 * (
            jnp.sum(p_end**2, -1) - jnp.sum(p0**2, -1)
        )
        if want_grad:
            # ChEES gradient wrt log τ (Hoffman et al. 2021 eq. 8):
            # Δ·⟨q'−m, dq'/dt⟩ per walker, accept-prob weighted, with
            # dt/dlogτ ∝ u·τ — the constant τ is absorbed by Adam's
            # scale invariance, the per-iteration u is not. Velocity in
            # scalar-time units is L·p (metric chain rule).
            alpha = jnp.exp(jnp.minimum(dh, 0.0))
            m = jnp.mean(y, axis=0)
            dqp = q - m
            delta = jnp.sum(dqp**2, -1) - jnp.sum((y - m) ** 2, -1)
            dot = jnp.sum(dqp * _met_scale(sd, p_end), -1)
            per = alpha * u * delta * dot
            ok = jnp.isfinite(per)
            w = jnp.where(ok, alpha, 0.0)
            g_logh = jnp.sum(jnp.where(ok, per, 0.0)) / jnp.maximum(
                jnp.sum(w), 1e-6
            )
        else:
            g_logh = jnp.float32(0.0)
        acc = jnp.log(jax.random.uniform(ku, (y.shape[0],))) < dh
        acc = acc | (~jnp.isfinite(lp) & jnp.isfinite(lp_new))
        y = jnp.where(acc[:, None], q, y)
        lp = jnp.where(acc, lp_new, lp)
        glp = jnp.where(acc[:, None], g_new, glp)
        a_mean = jnp.mean(jnp.minimum(1.0, jnp.exp(dh)))
        return y, lp, glp, a_mean, g_logh

    def make_warm_step(params):
        def warm_step(state, txk):
            t, i, k = txk
            (y, lp, glp, sd, mu, log_eps, log_eps_bar, h_bar,
             log_h, log_h_bar, m_a, v_a) = state
            y, lp, glp, a_mean, g = chees_step(
                params, y, lp, glp, sd, jnp.exp(log_eps),
                jnp.exp(log_h), _vdc(i), k, True,
            )
            # dual averaging on log ε (identical to sample_hmc)
            h_bar = (1.0 - 1.0 / (t + t0)) * h_bar + (
                target_accept - a_mean
            ) / (t + t0)
            log_eps = mu - jnp.sqrt(t) / gamma * h_bar
            w = t ** (-kappa)
            log_eps_bar = w * log_eps + (1.0 - w) * log_eps_bar
            # Adam ascent on log τ, clamped to the leapfrog budget
            m_a = b1 * m_a + (1.0 - b1) * g
            v_a = b2 * v_a + (1.0 - b2) * g * g
            mhat = m_a / (1.0 - b1**t)
            vhat = v_a / (1.0 - b2**t)
            log_h = log_h + traj_lr * mhat / (jnp.sqrt(vhat) + adam_eps)
            log_h = jnp.clip(log_h, log_eps, log_eps + log_cap)
            log_h_bar = w * log_h + (1.0 - w) * log_h_bar
            return (
                y, lp, glp, sd, mu, log_eps, log_eps_bar, h_bar,
                log_h, log_h_bar, m_a, v_a,
            ), a_mean

        return warm_step

    def warm_phase(params, y, lp, glp, sd, eps0, h0, txk):
        state = (
            y, lp, glp, sd, jnp.log(10.0 * eps0), jnp.log(eps0),
            jnp.log(eps0), jnp.float32(0.0), jnp.log(h0), jnp.log(h0),
            jnp.float32(0.0), jnp.float32(0.0),
        )
        state, _ = jax.lax.scan(make_warm_step(params), state, txk)
        y, lp, glp = state[0], state[1], state[2]
        return y, lp, glp, jnp.exp(state[6]), jnp.exp(state[9])

    def run(params, y, warm1_txk, warm2_txk, run_ixk):
        def run_step(state, ixk):
            i, k = ixk
            y, lp, glp, sd, eps, h, buf = state
            y, lp, glp, a_mean, _ = chees_step(
                params, y, lp, glp, sd, eps, h, _vdc(i), k, False
            )
            if thin:
                # i is the GLOBAL step index (warmup offset, for
                # the van-der-Corput jitter); thinning counts
                # post-warmup steps
                buf = _thin_write(
                    buf, i - n_warmup, to_params(y), thin, n_keep
                )
            return (y, lp, glp, sd, eps, h, buf), a_mean

        lp, glp = logp_and_grad(params, y)
        sd = jnp.ones((y.shape[1],), y.dtype)
        eps = jnp.float32(cfg.init_step)
        h = jnp.float32(cfg.h0)
        if n_warm1 > 0:  # static — no hidden warmup on continuation
            y, lp, glp, eps, h = warm_phase(
                params, y, lp, glp, sd, eps, h, warm1_txk
            )
        if use_metric:
            sd = _ens_metric_blocks(y, dense, 1)
            y, lp, glp, eps, h = warm_phase(
                params, y, lp, glp, sd, eps, h, warm2_txk
            )
            # (no post-warmup metric refresh: like sample_hmc, the
            # adapted step+trajectory cannot re-tune to refreshed
            # geometry — measured acceptance collapse on a sharp
            # emulator posterior; NUTS refreshes because per-walker
            # trees re-adapt the trajectory every draw)
        n_keep, buf = _thin_state(run_ixk[0].shape[0], thin, y)
        (y, lp, glp, _, _, _, buf), rates = jax.lax.scan(
            run_step, (y, lp, glp, sd, eps, h, buf), run_ixk
        )
        return y, lp, rates, buf[:n_keep], eps, h

    return to_params, jax.jit(run)


def sample_chees(
    valgrad,
    params,
    *,
    n_walkers: int = 4096,
    n_steps: int = 200,
    n_warmup: int = 300,
    bounds=None,
    target_accept: float = 0.651,
    init_step: float = 0.01,
    init_traj: Optional[float] = None,
    max_leapfrog: int = 128,
    traj_lr: float = 0.05,
    thin: int = 5,
    seed: int = 0,
    x0=None,
    precondition: bool = True,
    metric: str = "auto",
    log_prior=None,
    mesh=None,
) -> ChEESSampleResult:
    """ChEES-HMC: HMC with the trajectory length adapted from ensemble
    statistics (Hoffman, Radul & Sountsov 2021, "An Adaptive-MCMC
    Scheme for Setting Trajectory Lengths in Hamiltonian Monte Carlo")
    — the accelerator-native answer to "how long should HMC integrate?".

    NUTS answers that question with per-chain dynamic tree building —
    recursion, data-dependent trip counts, and early exits that are
    hostile to batched SPMD execution (every walker would pay the
    slowest tree, and the tree state is a stack). ChEES-HMC gets the
    same adaptivity from the ensemble instead: all walkers share one
    jittered trajectory per iteration, and warmup ascends the ChEES
    criterion — the expected squared change of the squared distance
    from the posterior mean, a proxy for maximizing ESS of second
    moments — whose gradient with respect to the trajectory time has a
    closed form in the endpoint momentum (their eq. 8). The result
    keeps every iteration a fixed-shape batched leapfrog (one compiled
    program) while matching NUTS-quality trajectory
    tuning; the paper finds it competitive with or better than NUTS
    across their benchmark posteriors.

    Mechanics (all inside two ``lax.scan`` programs, like
    :func:`sample_hmc`):

    * iteration ``i`` integrates for time ``u_i·τ`` where ``u_i`` is
      the base-2 van der Corput (Halton) fraction of the global step
      index — state-independent, so detailed balance is untouched —
      and the leapfrog count is ``ceil(u_i·τ/ε)``, a traced dynamic
      ``fori_loop`` trip count (no per-length retraces);
    * warmup adapts ``ε`` by dual averaging toward ``target_accept``
      (0.651 is the ChEES paper's choice) exactly as in
      :func:`sample_hmc`, and ``log τ`` by Adam ascent (lr
      ``traj_lr``) on the per-iteration ChEES gradient, iterate-
      averaged with the same ``t^{-0.75}`` weights; ``τ`` is clamped
      to ``[ε, ε·max_leapfrog]``;
    * ``precondition``/``metric`` reuse the ensemble-statistics metric
      (halfway restart) from :func:`sample_hmc`; ``metric="dense"``
      opts into the covariance square root, so the trajectory
      adaptation only has to learn the residual whitened geometry
      (``"auto"`` stays diag here — see `_resolve_metric`).

    ``valgrad``/``bounds``/``log_prior``/``mesh``/``thin`` as in
    :func:`sample_hmc` (the ChEES gradient adds one cross-walker mean
    per warmup iteration — a scalar-sized collective under ``mesh``).
    Prefer this over :func:`sample_hmc` when the trajectory length is
    unknown: on anisotropic targets a mistuned fixed ``n_leapfrog``
    costs orders of magnitude in ESS, which is exactly what the
    adaptation recovers (``tests/test_sampling.py``).
    """
    lo, hi = _resolve_bounds(bounds)
    span = hi - lo
    key = jax.random.key(seed)
    k_init, k_warm, k_run = jax.random.split(key, 3)
    x = _shard_walkers(
        jnp.asarray(x0, jnp.float32)
        if x0 is not None
        else _init_walkers(k_init, n_walkers, lo, hi),
        mesh,
    )
    y = _whiten_init(x, lo, span)
    h0 = float(init_traj) if init_traj is not None else 8.0 * init_step

    cfg = _CheesProgram(
        n_walkers=int(y.shape[0]),
        n_warmup=int(n_warmup),
        target_accept=float(target_accept),
        init_step=float(init_step),
        h0=float(h0),
        max_leapfrog=int(max_leapfrog),
        traj_lr=float(traj_lr),
        thin=int(thin),
        precondition=bool(precondition),
        metric=str(metric),
    )
    _, _, n_warm1 = cfg.phases()  # validates `metric` eagerly too
    to_params, run = _chain_program(
        valgrad,
        _auto_key(cfg, lo, hi, log_prior),
        lambda: _build_chees_program(valgrad, log_prior, lo, hi, cfg),
    )

    def txk(k, n, start):
        n_pad = max(n, 1)
        return (
            jnp.arange(1, n_pad + 1, dtype=jnp.float32),
            jnp.arange(start, start + n_pad, dtype=jnp.int32),
            jax.random.split(k, n_pad),
        )

    def ixk(k, n, start):
        return (
            jnp.arange(start, start + n, dtype=jnp.int32),
            jax.random.split(k, n),
        )

    k_warm1, k_warm2 = jax.random.split(k_warm)
    n_warm2 = n_warmup - n_warm1
    y, lp, rates, kept, eps, h = run(
        params, y, txk(k_warm1, n_warm1, 0), txk(k_warm2, n_warm2, n_warm1),
        ixk(k_run, n_steps, n_warmup),
    )
    chain = (
        _to_host(kept)
        if thin
        else np.empty((0, y.shape[0], y.shape[1]), np.float32)
    )
    return ChEESSampleResult(
        chain=chain,
        final=_to_host(to_params(y)),
        logp=_to_host(lp),
        accept_rate=_to_host(rates),
        step_size=float(eps),
        trajectory_length=float(h),
    )


def _popcount32(n):
    """Population count of a traced int32/uint32 (Hacker's Delight
    fig. 5-2) — checkpoint indexing for :func:`sample_nuts`'s iterative
    tree building."""
    n = n.astype(jnp.uint32)
    n = n - ((n >> 1) & jnp.uint32(0x55555555))
    n = (n & jnp.uint32(0x33333333)) + ((n >> 2) & jnp.uint32(0x33333333))
    n = (n + (n >> 4)) & jnp.uint32(0x0F0F0F0F)
    return ((n * jnp.uint32(0x01010101)) >> 24).astype(jnp.int32)


@dataclasses.dataclass
class NUTSSampleResult(SampleResult):
    """:class:`SampleResult` from :func:`sample_nuts`, plus NUTS-specific
    diagnostics: ``divergence_rate`` — fraction of (draw, walker) pairs
    whose trajectory hit a divergence (ΔH > 1000; a nonzero rate on a
    smooth emulator posterior means the step size adapted too large —
    lower ``target_accept``... or raise it, Stan-style, toward 0.95);
    ``mean_leapfrog`` — mean leapfrog steps per draw per walker (the
    cost knob: compare against ``2**max_depth - 1`` to see whether the
    U-turn criterion, not the depth cap, is ending trajectories)."""

    divergence_rate: float = 0.0
    mean_leapfrog: float = 0.0


@dataclasses.dataclass(frozen=True)
class _NutsProgram:
    """Statics of :func:`_build_nuts_program`, keyed in full
    (:func:`_auto_key`). The warmup-phase structure — including the
    ``n_warm3 > 0`` boolean whose omission from the round-4 hand key
    replayed the wrong compiled program at 99 % divergences — derives
    from these fields via :meth:`phases`, so it cannot escape the key.
    ``n_walkers`` is the ACTUAL walker-row count (x0 may override the
    kwarg)."""

    n_walkers: int
    n_warmup: int
    max_depth: int
    target_accept: float
    init_step: float
    thin: int
    precondition: bool
    metric: str
    adapt_blocks: int
    dense_readapt: bool

    def phases(self):
        use_metric, dense = _resolve_metric(
            self.metric, self.precondition, self.n_warmup,
            self.n_walkers // self.adapt_blocks, auto_dense=False,
        )
        n_warm1 = self.n_warmup // 2 if use_metric else self.n_warmup
        # a third window re-adapting eps under the refreshed dense
        # metric was built and A/B-measured in round 4 (6 seeds,
        # production posterior, docs/PERF.md): it made divergences
        # WORSE (0.63 % vs 0.21 % mean) — the matched metric lets dual
        # averaging push eps higher, and the divergences come from
        # walker-local sharp curvature, not an eps/metric mismatch.
        # Kept behind ``dense_readapt`` for the record; the production
        # fix is ``metric="auto"`` resolving DIAG for NUTS.
        n_rest = self.n_warmup - n_warm1
        n_warm3 = (n_rest // 2
                   if (use_metric and dense and self.dense_readapt)
                   else 0)
        n_warm2 = n_rest - n_warm3
        return use_metric, dense, n_warm1, n_warm2, n_warm3


def _build_nuts_program(valgrad, log_prior, lo, hi, cfg):
    """Module-level program builder for :func:`sample_nuts` — no free
    variables (see :func:`_auto_key`). Returns ``(to_params, run)``."""
    span = hi - lo
    to_params, logp_and_grad = _whitened_target(
        valgrad, log_prior, lo, span
    )
    use_metric, dense, n_warm1, n_warm2, n_warm3 = cfg.phases()
    n_blk = cfg.adapt_blocks
    md = cfg.max_depth
    thin = cfg.thin
    target_accept = cfg.target_accept
    init_step = cfg.init_step
    gamma, t0, kappa = 0.05, 10.0, 0.75  # dual averaging (H&G Alg. 5)

    def nuts_step(params, y, lp, glp, sd, eps_blk, k):
        B, D = y.shape
        # (adapt_blocks,) per-block steps, expanded to walker rows
        eps_w = jnp.repeat(eps_blk, B // n_blk)
        kp, kt = jax.random.split(k)
        p0 = jax.random.normal(kp, (B, D), y.dtype)
        h0 = lp - 0.5 * jnp.sum(p0**2, -1)  # leaf log-weight base

        def build(state, kd, d):
            (zl, pl, gl, zr, pr, gr, zp, lpp, gp, rho, logw, done,
             ndiv, a_sum, a_cnt, nleap) = state
            k_dir, k_take, k_sub = jax.random.split(kd, 3)
            right = jax.random.bernoulli(k_dir, 0.5, (B,))
            # per-walker signed SCALAR step; the metric enters through
            # _met_scale/_met_pull in the leapfrog below
            eps_d = jnp.where(right, eps_w, -eps_w)[:, None]
            z0 = jnp.where(right[:, None], zr, zl)
            q0 = jnp.where(right[:, None], pr, pl)
            g0 = jnp.where(right[:, None], gr, gl)
            n_ck = max(d, 1)

            def leaf(i, carry):
                (z, p, g, cum, lw, zs, ls, gs, turn, div, pck, rck,
                 asum, k_s) = carry
                k_s, ku = jax.random.split(k_s)
                ph = p + 0.5 * eps_d * _met_pull(sd, g)
                z2 = z + eps_d * _met_scale(sd, ph)
                lp2, g2 = logp_and_grad(params, z2)
                p2 = ph + 0.5 * eps_d * _met_pull(sd, g2)
                w = lp2 - 0.5 * jnp.sum(p2**2, -1) - h0
                w = jnp.where(jnp.isfinite(w), w, -jnp.inf)
                div = div | (w < -1000.0)
                lw_new = jnp.logaddexp(lw, w)
                # streaming multinomial within the subtree: leaf i wins
                # the proposal slot with prob w_i / Σ_{j≤i} w_j
                take = jnp.log(
                    jax.random.uniform(ku, (B,))
                ) < (w - lw_new)
                zs = jnp.where(take[:, None], z2, zs)
                ls = jnp.where(take, lp2, ls)
                gs = jnp.where(take[:, None], g2, gs)
                cum = cum + p2
                pc = _popcount32(i)
                even = (i % 2) == 0
                slot = jnp.where(even, pc, 0)
                # even leaf: store (p, cumulative ρ) at slot popcount(i)
                # (odd leaves write the old value back — a no-op)
                pck = pck.at[slot].set(
                    jnp.where(even, p2, pck[slot])
                )
                rck = rck.at[slot].set(
                    jnp.where(even, cum, rck[slot])
                )
                # odd leaf: U-turn-check the complete sub-subtrees
                # ending here — checkpoint slots [pc - tz(i+1), pc - 1]
                tz = _popcount32(~(i + 1) & i)
                smin, smax = pc - tz, pc - 1

                def chk(s, turn):
                    seg = cum - rck[s] + pck[s]
                    t_s = (
                        jnp.sum(seg * pck[s], -1) <= 0.0
                    ) | (jnp.sum(seg * p2, -1) <= 0.0)
                    m = (~even) & (s >= smin) & (s <= smax)
                    return turn | (m & t_s)

                turn = jax.lax.fori_loop(0, n_ck, chk, turn)
                asum = asum + jnp.where(
                    ~done, jnp.minimum(1.0, jnp.exp(w)), 0.0
                )
                return (
                    z2, p2, g2, cum, lw_new, zs, ls, gs, turn, div,
                    pck, rck, asum, k_s,
                )

            zeros_ck = jnp.zeros((n_ck, B, D), y.dtype)
            init = (
                z0, q0, g0, jnp.zeros((B, D), y.dtype),
                jnp.full((B,), -jnp.inf, y.dtype), z0,
                jnp.full((B,), -jnp.inf, y.dtype), g0,
                jnp.zeros((B,), bool), jnp.zeros((B,), bool),
                zeros_ck, zeros_ck, a_sum, k_sub,
            )
            (z_e, p_e, g_e, rho_sub, lw_sub, zs, ls, gs, turn_s,
             div_s, _, _, a_sum, _) = jax.lax.fori_loop(
                0, 2**d, leaf, init
            )
            ok = (~done) & (~turn_s) & (~div_s)
            # biased-progressive acceptance of the new subtree's proposal
            take = ok & (
                jnp.log(jax.random.uniform(k_take, (B,)))
                < (lw_sub - logw)
            )
            zp = jnp.where(take[:, None], zs, zp)
            lpp = jnp.where(take, ls, lpp)
            gp = jnp.where(take[:, None], gs, gp)
            logw = jnp.where(ok, jnp.logaddexp(logw, lw_sub), logw)
            rho = jnp.where(ok[:, None], rho + rho_sub, rho)
            upd_r = (ok & right)[:, None]
            upd_l = (ok & ~right)[:, None]
            zr = jnp.where(upd_r, z_e, zr)
            pr = jnp.where(upd_r, p_e, pr)
            gr = jnp.where(upd_r, g_e, gr)
            zl = jnp.where(upd_l, z_e, zl)
            pl = jnp.where(upd_l, p_e, pl)
            gl = jnp.where(upd_l, g_e, gl)
            full_turn = (jnp.sum(rho * pl, -1) <= 0.0) | (
                jnp.sum(rho * pr, -1) <= 0.0
            )
            ndiv = ndiv + jnp.where((~done) & div_s, 1.0, 0.0)
            nleap = nleap + jnp.where(~done, float(2**d), 0.0)
            a_cnt = a_cnt + jnp.where(~done, float(2**d), 0.0)
            done = done | turn_s | div_s | (ok & full_turn)
            return (zl, pl, gl, zr, pr, gr, zp, lpp, gp, rho, logw,
                    done, ndiv, a_sum, a_cnt, nleap)

        zb = jnp.zeros((B,), jnp.float32)
        state = (
            y, p0, glp, y, p0, glp, y, lp, glp, p0,
            jnp.zeros((B,), y.dtype), jnp.zeros((B,), bool),
            zb, zb, zb, zb,
        )
        for d in range(md):
            kd = jax.random.fold_in(kt, d)
            state = jax.lax.cond(
                jnp.all(state[11]),
                lambda s: s,
                lambda s, _kd=kd, _d=d: build(s, _kd, _d),
                state,
            )
        (_, _, _, _, _, _, zp, lpp, gp, _, _, _, ndiv, a_sum, a_cnt,
         nleap) = state
        # (adapt_blocks,) per-block mean accept-stat drives adaptation
        a_blk = (
            a_sum / jnp.maximum(a_cnt, 1.0)
        ).reshape(n_blk, -1).mean(axis=1)
        return (
            zp, lpp, gp, a_blk,
            jnp.mean((ndiv > 0).astype(jnp.float32)), jnp.mean(nleap),
        )

    def make_warm_step(params):
        def warm_step(state, ik):
            i, k = ik
            y, lp, glp, sd, mu, log_eps, log_eps_bar, h_bar = state
            y, lp, glp, a_mean, _, _ = nuts_step(
                params, y, lp, glp, sd, jnp.exp(log_eps), k
            )
            t = i + 1.0
            h_bar = (1.0 - 1.0 / (t + t0)) * h_bar + (
                target_accept - a_mean
            ) / (t + t0)
            log_eps = mu - jnp.sqrt(t) / gamma * h_bar
            w = t ** (-kappa)
            log_eps_bar = w * log_eps + (1.0 - w) * log_eps_bar
            return (
                y, lp, glp, sd, mu, log_eps, log_eps_bar, h_bar
            ), a_mean

        return warm_step

    def warm_phase(params, y, lp, glp, sd, eps0, ik):
        # ``eps0``: (adapt_blocks,) — the dual-averaging state is a
        # per-block vector throughout (every update is elementwise)
        state = (
            y, lp, glp, sd, jnp.log(10.0 * eps0), jnp.log(eps0),
            jnp.log(eps0), jnp.zeros_like(eps0),
        )
        state, _ = jax.lax.scan(make_warm_step(params), state, ik)
        y, lp, glp, _, _, _, log_eps_bar, _ = state
        return y, lp, glp, jnp.exp(log_eps_bar)

    def run(params, y, warm1_ik, warm2_ik, warm3_ik, run_keys):
        def run_step(state, tk):
            t, k = tk
            y, lp, glp, sd, eps, buf = state
            y, lp, glp, a_mean, dv, nl = nuts_step(
                params, y, lp, glp, sd, eps, k
            )
            if thin:
                buf = _thin_write(
                    buf, t, to_params(y), thin, n_keep
                )
            return (y, lp, glp, sd, eps, buf), (
                jnp.mean(a_mean), dv, nl
            )

        lp, glp = logp_and_grad(params, y)
        sd = jnp.ones((y.shape[1],), y.dtype)
        eps = jnp.full((n_blk,), init_step, jnp.float32)
        if n_warm1 > 0:  # static — no hidden warmup on continuation
            y, lp, glp, eps = warm_phase(
                params, y, lp, glp, sd, eps, warm1_ik
            )
        if use_metric:
            sd = _ens_metric_blocks(y, dense, n_blk)
            y, lp, glp, eps = warm_phase(
                params, y, lp, glp, sd, eps, warm2_ik
            )
            if dense:
                # refresh from the now-mixed ensemble (see
                # sample_hmc), then RE-ADAPT ε under the refreshed
                # metric — running the sampling phase with a step
                # tuned for the previous metric was the measured
                # 0.39 % divergence source (docs/PERF.md)
                sd = _ens_metric_blocks(y, dense, n_blk)
                if n_warm3 > 0:
                    y, lp, glp, eps = warm_phase(
                        params, y, lp, glp, sd, eps, warm3_ik
                    )
        n_keep, buf = _thin_state(run_keys.shape[0], thin, y)
        (y, lp, glp, _, _, buf), (rates, divs, leaps) = jax.lax.scan(
            run_step, (y, lp, glp, sd, eps, buf),
            (jnp.arange(run_keys.shape[0], dtype=jnp.int32),
             run_keys),
        )
        return y, lp, rates, divs, leaps, buf[:n_keep], eps

    return to_params, jax.jit(run)


def sample_nuts(
    valgrad,
    params,
    *,
    n_walkers: int = 4096,
    n_steps: int = 200,
    n_warmup: int = 300,
    max_depth: int = 6,
    bounds=None,
    target_accept: float = 0.8,
    init_step: float = 0.01,
    thin: int = 5,
    seed: int = 0,
    x0=None,
    precondition: bool = True,
    metric: str = "auto",
    log_prior=None,
    mesh=None,
    adapt_blocks: int = 1,
    _dense_readapt: bool = False,
) -> NUTSSampleResult:
    """No-U-Turn Sampler (multinomial NUTS) over ``valgrad``, built as a
    BATCHED ITERATIVE tree — the accelerator formulation of the sampler
    Stan/PyMC/NumPyro users expect.

    ``adapt_blocks=G``: keep G independent dual-averaged step sizes AND
    G independent ensemble metrics, one per contiguous walker block —
    the batched-observation mode (``sample_posterior_batch``), where
    each block is one observation's posterior. Pooling would be wrong
    twice over there: one step size compromises across heterogeneous
    posterior widths (as in :func:`sample_hmc`), and a pooled
    cross-walker metric measures the BETWEEN-observation spread of the
    posterior locations, not any posterior's local geometry — the
    per-block metric (:func:`_ens_metric_blocks`) is what makes
    whitened per-walker trees meaningful per observation.

    Textbook NUTS is recursive with data-dependent trajectory lengths —
    hostile to SPMD batching (see :func:`sample_chees`, the fixed-shape
    adaptive alternative). This implementation removes the recursion, not the
    algorithm: per draw, trajectory doubling ``d = 0 … max_depth-1``
    runs as an unrolled loop of fixed-shape subtree builds (one
    ``fori_loop`` of ``2**d`` leapfrog steps, each one batched device
    call across all walkers), with

    * **multinomial sampling** within and across subtrees (Betancourt
      2017 §A.3): streaming categorical by cumulative ``logaddexp``
      weight within a subtree, biased-progressive acceptance
      ``min(1, w_subtree/w_tree)`` across subtrees;
    * **sub-U-turn checks without recursion** via the checkpoint-stack
      scheme (as in NumPyro's iterative NUTS): build-order leaf ``i``
      stores its (momentum, cumulative-momentum-sum) at stack slot
      ``popcount(i)`` when ``i`` is even, and when odd checks the
      generalized U-turn criterion ``⟨ρ_seg, p_left⟩ ≤ 0 ∨
      ⟨ρ_seg, p_right⟩ ≤ 0`` against slots ``[popcount(i) -
      tz(i+1), popcount(i) - 1]`` — exactly the complete sub-subtrees
      ending at leaf ``i``, with ``ρ_seg`` recovered from the stored
      cumulative sums. ``max_depth`` stack slots suffice;
    * **lockstep walkers with masked termination**: every walker runs
      every doubling until ALL are done (then a ``lax.cond`` skips the
      remaining depths); finished walkers' updates are ``where``-masked.
      This lockstep cost — each draw pays the slowest walker's tree —
      is exactly why ChEES wins on throughput; NUTS is here for
      robustness (per-walker trajectory adaptation, divergence
      diagnostics) and ecosystem parity;
    * step-size warmup by dual averaging toward ``target_accept``
      (Stan's accept-stat: trajectory-mean ``min(1, e^{-ΔH})``), with
      the ensemble-statistics metric restart of :func:`sample_hmc`
      under ``precondition``. ``metric="auto"`` resolves DIAG (round-4
      measurement: dense carries a seed-dependent 0.2-1.2 %
      divergence rate and lower min-ESS/s on the production posterior
      — `_resolve_metric`); pass ``metric="dense"`` for correlated
      posteriors, where the whitened trees terminate orders of
      magnitude earlier (measured mean-leapfrog numbers in
      docs/PERF.md).

    ``valgrad``/``bounds``/``log_prior``/``mesh``/``thin``/``x0`` as in
    :func:`sample_hmc`; sampling happens in the same sigmoid-whitened
    ``y``-space. Divergences (ΔH > 1000, Stan's threshold) end the
    walker's trajectory with the offending subtree discarded and are
    reported in ``divergence_rate``. The reference leaves sampling to
    external CPU samplers entirely (``README.rst:9-11``).
    """
    lo, hi = _resolve_bounds(bounds)
    span = hi - lo
    key = jax.random.key(seed)
    k_init, k_warm, k_run = jax.random.split(key, 3)
    x = _shard_walkers(
        jnp.asarray(x0, jnp.float32)
        if x0 is not None
        else _init_walkers(k_init, n_walkers, lo, hi),
        mesh,
    )
    y = _whiten_init(x, lo, span)

    if n_walkers % adapt_blocks:
        raise ValueError(
            f"n_walkers ({n_walkers}) must divide into adapt_blocks "
            f"({adapt_blocks}) equal contiguous blocks"
        )
    md = int(max_depth)
    if md < 1:
        raise ValueError(f"max_depth must be >= 1; got {max_depth}")
    cfg = _NutsProgram(
        n_walkers=int(y.shape[0]),
        n_warmup=int(n_warmup),
        max_depth=md,
        target_accept=float(target_accept),
        init_step=float(init_step),
        thin=int(thin),
        precondition=bool(precondition),
        metric=str(metric),
        adapt_blocks=int(adapt_blocks),
        dense_readapt=bool(_dense_readapt),
    )
    _, _, n_warm1, n_warm2, n_warm3 = cfg.phases()
    to_params, run = _chain_program(
        valgrad,
        _auto_key(cfg, lo, hi, log_prior),
        lambda: _build_nuts_program(valgrad, log_prior, lo, hi, cfg),
    )

    def ik(k, n):
        n = max(n, 1)
        return (jnp.arange(n, dtype=jnp.float32), jax.random.split(k, n))

    k_warm1, k_warm2, k_warm3 = jax.random.split(k_warm, 3)
    run_keys = jax.random.split(k_run, n_steps)
    y, lp, rates, divs, leaps, kept, eps = run(
        params, y, ik(k_warm1, n_warm1), ik(k_warm2, n_warm2),
        ik(k_warm3, n_warm3), run_keys,
    )
    chain = (
        _to_host(kept)
        if thin
        else np.empty((0, y.shape[0], y.shape[1]), np.float32)
    )
    return NUTSSampleResult(
        chain=chain,
        final=_to_host(to_params(y)),
        logp=_to_host(lp),
        accept_rate=_to_host(rates),
        step_size=float(np.mean(_to_host(eps))),
        block_step_sizes=_to_host(eps),
        divergence_rate=float(np.mean(np.asarray(divs))),
        mean_leapfrog=float(np.mean(np.asarray(leaps))),
    )


