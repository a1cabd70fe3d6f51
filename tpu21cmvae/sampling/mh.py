"""Gradient-free samplers: random-walk Metropolis (:func:`sample_mh`)
and the red-black affine-invariant stretch ensemble
(:func:`sample_ensemble`).

Split from the round-3 ``sampling.py`` monolith with zero behavior
change; see the package ``__init__`` for the map.
"""

from __future__ import annotations

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np

from tpu21cmvae.sampling._common import (
    _auto_key,
    _chain_program,
    _dual_averaging_consts,
    _init_walkers,
    _resolve_bounds,
    _resolve_log_prior,
    _shard_walkers,
    _thin_state,
    _thin_write,
    _to_host,
)
from tpu21cmvae.sampling.results import SampleResult


@dataclasses.dataclass(frozen=True)
class _MHProgram:
    """Every static :func:`_build_mh_program` bakes into its closure.
    The cache key is ALL fields automatically (:func:`_auto_key`)."""

    step_frac: float
    target_accept: float
    adapt: bool
    adapt_blocks: int
    thin: int
    n_warmup: int


def _build_mh_program(loglik, log_prior, lo, hi, cfg):
    """Module-level program builder for :func:`sample_mh` — zero free
    variables by construction: every static comes from ``cfg`` (keyed
    in full) or the explicitly-keyed ``(lo, hi, log_prior)``."""
    log_prior = _resolve_log_prior(log_prior)
    base_scale = cfg.step_frac * (hi - lo)
    mid = (lo + hi) / 2.0
    n_blk = cfg.adapt_blocks
    thin = cfg.thin

    def mh_step(params, x, lp, mult, k):
        # ``mult``: (adapt_blocks,) per-block scale multipliers,
        # expanded to rows (block = contiguous walker slab)
        k1, k2 = jax.random.split(k)
        m_row = jnp.repeat(mult, x.shape[0] // n_blk)[:, None]
        prop = x + m_row * base_scale * jax.random.normal(
            k1, x.shape, x.dtype
        )
        inside = ((prop >= lo) & (prop <= hi)).all(axis=1)
        safe = jnp.where(inside[:, None], prop, mid)
        lp_prop = loglik(params, safe) + log_prior(safe)
        lp_prop = jnp.where(inside, lp_prop, -jnp.inf)
        acc = jnp.log(jax.random.uniform(k2, (x.shape[0],))) < lp_prop - lp
        # a walker whose current lp is non-finite (e.g. started
        # outside the model's valid domain) would otherwise stick
        # forever: every NaN comparison rejects. Always step it
        # onto a finite proposal.
        acc = acc | (~jnp.isfinite(lp) & jnp.isfinite(lp_prop))
        x = jnp.where(acc[:, None], prop, x)
        lp = jnp.where(acc, lp_prop, lp)
        return x, lp, acc.reshape(n_blk, -1).mean(axis=1)

    mu, gamma, t0, kappa = _dual_averaging_consts(1.0)

    def run(params, x, warm_ik, run_keys):
        def warm_step(state, ik):
            i, k = ik
            x, lp, log_m, log_m_bar, h_bar = state
            x, lp, a = mh_step(params, x, lp, jnp.exp(log_m), k)
            t = i + 1.0
            h_bar = (1.0 - 1.0 / (t + t0)) * h_bar + (
                cfg.target_accept - a
            ) / (t + t0)
            log_m = jnp.where(
                cfg.adapt, mu - jnp.sqrt(t) / gamma * h_bar, log_m
            )
            w = t ** (-kappa)
            log_m_bar = jnp.where(
                cfg.adapt, w * log_m + (1.0 - w) * log_m_bar, log_m_bar
            )
            return (x, lp, log_m, log_m_bar, h_bar), a

        def run_step(state, tk):
            t, k = tk
            x, lp, mult, buf = state
            x, lp, a = mh_step(params, x, lp, mult, k)
            if thin:
                buf = _thin_write(buf, t, x, thin, n_keep)
            return (x, lp, mult, buf), jnp.mean(a)

        lp = loglik(params, x) + log_prior(x)
        # warmup presence is static (part of the cache key): with
        # 0, skip the warmup scan entirely — continuation runs via
        # x0 must not take hidden extra steps
        if cfg.n_warmup > 0:
            zeros = jnp.zeros((n_blk,), jnp.float32)
            state = (x, lp, zeros, zeros, zeros)
            state, _ = jax.lax.scan(warm_step, state, warm_ik)
            x, lp, _, log_m_bar, _ = state
            mult = jnp.exp(log_m_bar)
        else:
            mult = jnp.ones((n_blk,), jnp.float32)
        n_keep, buf = _thin_state(run_keys.shape[0], thin, x)
        (x, lp, mult, buf), rates = jax.lax.scan(
            run_step,
            (x, lp, mult, buf),
            (jnp.arange(run_keys.shape[0], dtype=jnp.int32),
             run_keys),
        )
        return x, lp, rates, buf[:n_keep], mult

    return jax.jit(run)

def sample_mh(
    loglik,
    params,
    *,
    n_walkers: int = 8192,
    n_steps: int = 500,
    n_warmup: int = 200,
    bounds=None,
    step_frac: float = 0.01,
    target_accept: float = 0.3,
    adapt: bool = True,
    adapt_blocks: int = 1,
    thin: int = 10,
    seed: int = 0,
    x0=None,
    log_prior=None,
    mesh=None,
) -> SampleResult:
    """Metropolis-Hastings ensemble over ``loglik(params, raw) → (B,)``.

    ``loglik`` is any jittable batched log-likelihood — typically
    ``DirectEmulator.loglik_fn(obs, noise_var)`` (the gram form).
    Proposals are isotropic Gaussians scaled per parameter by
    ``step_frac`` of the prior span; proposals outside the prior box are
    REJECTED (the target is zero there — exact Metropolis
    with a symmetric proposal; a clipped proposal is not symmetric at
    the faces and piles stationary mass on the boundary, which matters
    for near-flat targets). The likelihood is evaluated on a safe
    midpoint row for outside proposals so the emulator's log-transform
    never sees a negative parameter. During warmup the
    scale multiplier adapts by dual averaging toward ``target_accept``
    (0.3 ≈ random-walk-optimal in moderate dimension); ``adapt=False``
    pins ``step_frac``. ``adapt_blocks=G`` keeps G INDEPENDENT
    multipliers, one per contiguous walker block — the batched-
    observation path passes ``G = n_obs`` so each observation's
    posterior gets its own proposal scale (heterogeneous widths are the
    norm there: per-sim noise levels, different data; one pooled scale
    mixes the narrow posteriors arbitrarily slowly — on a 50×-width
    block split the pooled scale strands the narrow block entirely,
    ``tests/test_sampling::test_mh_adapt_blocks_heterogeneous_widths``;
    at mild heterogeneity pooled adaptation stays calibrated, just
    slower). Per-block statistics are a reshape+mean over the walker
    axis — free next to the likelihood call. ``thin > 0`` keeps every
    ``thin``-th post-warmup step. Runs as two ``lax.scan`` programs
    (warmup, sampling) — zero host round trips inside the chains.

    ``log_prior``: optional traceable log-density over RAW parameters
    added to the target (e.g.
    ``GaussianBoxPrior(...).log_prior`` — see
    :mod:`tpu21cmvae.priors`); the box stays a hard indicator on top.

    ``mesh``: optional :class:`jax.sharding.Mesh` — the walker axis
    shards across its devices (walker count must divide evenly) and the
    whole chain runs as one SPMD program; see :func:`_shard_walkers`.
    """
    lo, hi = _resolve_bounds(bounds)
    base_scale = step_frac * (hi - lo)
    if n_walkers % adapt_blocks:
        raise ValueError(
            f"n_walkers ({n_walkers}) must divide into adapt_blocks "
            f"({adapt_blocks}) equal contiguous blocks"
        )
    key = jax.random.key(seed)
    k_init, k_warm, k_run = jax.random.split(key, 3)
    x = _shard_walkers(
        # initialization (not part of the chain): pull stray rows into
        # the box so every walker starts on the target's support
        jnp.clip(jnp.asarray(x0, jnp.float32), lo, hi)
        if x0 is not None
        else _init_walkers(k_init, n_walkers, lo, hi),
        mesh,
    )
    cfg = _MHProgram(
        step_frac=float(step_frac),
        target_accept=float(target_accept),
        adapt=bool(adapt),
        adapt_blocks=int(adapt_blocks),
        thin=int(thin),
        n_warmup=int(n_warmup),
    )
    run = _chain_program(
        loglik,
        _auto_key(cfg, lo, hi, log_prior),
        lambda: _build_mh_program(loglik, log_prior, lo, hi, cfg),
    )
    warm_ik = (
        jnp.arange(max(n_warmup, 1), dtype=jnp.float32),
        jax.random.split(k_warm, max(n_warmup, 1)),
    )
    run_keys = jax.random.split(k_run, n_steps)
    x, lp, rates, kept, mult = run(params, x, warm_ik, run_keys)
    chain = (
        _to_host(kept)
        if thin
        else np.empty((0,) + x.shape, np.float32)
    )
    return SampleResult(
        chain=chain,
        final=_to_host(x),
        logp=_to_host(lp),
        accept_rate=_to_host(rates),
        step_size=float(np.mean(_to_host(mult)))
        * float(_to_host(base_scale).mean()),
        block_step_sizes=_to_host(mult)
        * float(_to_host(base_scale).mean()),
    )


@dataclasses.dataclass(frozen=True)
class _StretchProgram:
    """Statics of :func:`_build_stretch_program`, keyed in full."""

    a: float
    n_walkers: int
    thin: int
    n_warmup: int


def _build_stretch_program(loglik, log_prior, lo, hi, cfg):
    """Module-level program builder for :func:`sample_ensemble` (no
    free variables; see :func:`_auto_key`). Weights are a RUN argument
    so retrained models never hit a stale compiled closure."""
    log_prior = _resolve_log_prior(log_prior)
    mid = (lo + hi) / 2.0
    n_params = int(lo.shape[0])
    half = cfg.n_walkers // 2
    a = cfg.a
    thin = cfg.thin

    def safe_loglik(params, xs):
        inside = ((xs >= lo) & (xs <= hi)).all(axis=1)
        safe = jnp.where(inside[:, None], xs, mid)
        lp = loglik(params, safe) + log_prior(safe)
        return jnp.where(inside, lp, -jnp.inf)

    def half_move(params, xa, lpa, xb, k):
        kz, kj, ku = jax.random.split(k, 3)
        # z ~ g(z) ∝ 1/√z on [1/a, a] via inverse CDF
        u = jax.random.uniform(kz, (xa.shape[0],), xa.dtype)
        z = ((a - 1.0) * u + 1.0) ** 2 / a
        j = jax.random.randint(kj, (xa.shape[0],), 0, xb.shape[0])
        xj = xb[j]
        prop = xj + z[:, None] * (xa - xj)
        lp_prop = safe_loglik(params, prop)
        log_ratio = (n_params - 1.0) * jnp.log(z) + lp_prop - lpa
        acc = jnp.log(jax.random.uniform(ku, (xa.shape[0],))) < log_ratio
        # self-recover walkers with a non-finite current lp (see sample_mh)
        acc = acc | (~jnp.isfinite(lpa) & jnp.isfinite(lp_prop))
        xa = jnp.where(acc[:, None], prop, xa)
        lpa = jnp.where(acc, lp_prop, lpa)
        return xa, lpa, jnp.mean(acc)

    def move(params, x, lp, k):
        ka, kb = jax.random.split(k)
        xa, lpa = x[:half], lp[:half]
        xb, lpb = x[half:], lp[half:]
        xa, lpa, ra = half_move(params, xa, lpa, xb, ka)
        xb, lpb, rb = half_move(params, xb, lpb, xa, kb)
        return (
            jnp.concatenate([xa, xb]),
            jnp.concatenate([lpa, lpb]),
            0.5 * (ra + rb),
        )

    def run(params, x, warm_keys, run_keys):
        def warm_step(state, k):
            x, lp = state
            x, lp, _ = move(params, x, lp, k)
            return (x, lp), None

        def run_step(state, tk):
            t, k = tk
            x, lp, buf = state
            x, lp, r = move(params, x, lp, k)
            if thin:
                buf = _thin_write(buf, t, x, thin, n_keep)
            return (x, lp, buf), r

        lp = safe_loglik(params, x)
        if cfg.n_warmup > 0:  # static — no hidden warmup on continuation
            (x, lp), _ = jax.lax.scan(warm_step, (x, lp), warm_keys)
        n_keep, buf = _thin_state(run_keys.shape[0], thin, x)
        (x, lp, buf), rates = jax.lax.scan(
            run_step, (x, lp, buf),
            (jnp.arange(run_keys.shape[0], dtype=jnp.int32), run_keys),
        )
        return x, lp, rates, buf[:n_keep]

    return jax.jit(run)


def sample_ensemble(
    loglik,
    params,
    *,
    n_walkers: int = 8192,
    n_steps: int = 500,
    n_warmup: int = 100,
    bounds=None,
    a: float = 2.0,
    thin: int = 10,
    seed: int = 0,
    x0=None,
    log_prior=None,
    mesh=None,
) -> SampleResult:
    """Affine-invariant ensemble sampler (Goodman & Weare 2010 stretch
    move — the algorithm behind emcee), entirely on device.

    The reference's published analyses drive its ~25-predictions/s
    emulator from host-side emcee (reference ``README.rst:9-11``);
    :func:`make_emcee_log_prob` reproduces that setup with a batched
    device likelihood. This is the step further: the ensemble itself
    lives on device, the whole chain is one ``lax.scan`` program, and
    each stretch move is two half-ensemble likelihood batches — zero
    host round trips and no tuning parameter besides the stretch scale
    ``a`` (affine invariance makes the move self-scaling, so unlike
    :func:`sample_mh` there is nothing to adapt during warmup; warmup
    steps are ordinary moves whose samples are discarded).

    Parallelization is the red-black split emcee uses for vectorized
    moves (Foreman-Mackey et al. 2013 §3): walkers split into two fixed
    halves; half A proposes ``x_j + z (x_i - x_j)`` against partners
    ``j`` drawn from half B with ``z ~ g(z) ∝ 1/√z`` on ``[1/a, a]``,
    accepted with probability ``min(1, z^(d-1) · L'/L)``; then B moves
    against the UPDATED A (required for detailed balance). Proposals
    outside the flat prior box score ``-inf`` (evaluated on a safe
    midpoint row so the emulator's log-transform never sees a negative
    parameter — reference ``preprocess.py:74``). ``n_walkers`` must be
    even and at least ``2 · n_params + 2`` so each half-ensemble spans
    parameter space. Returns a :class:`SampleResult` whose
    ``step_size`` field reports the stretch scale ``a``.
    ``log_prior``: optional log-density added to the target (see
    :func:`sample_mh`); affine invariance is unaffected — the prior is
    part of the target, not the move. ``mesh``: optional device mesh —
    walkers shard across it (see :func:`sample_mh`); the cross-half
    pairing gathers only the tiny ``(n_walkers/2, n_params)`` block.
    """
    lo, hi = _resolve_bounds(bounds)
    n_params = int(lo.shape[0])
    if n_walkers % 2:
        raise ValueError(f"n_walkers must be even; got {n_walkers}")
    if n_walkers < 2 * n_params + 2:
        raise ValueError(
            f"n_walkers must be >= 2*n_params+2 = {2 * n_params + 2} "
            f"for the stretch move to span parameter space; got {n_walkers}"
        )
    if a <= 1.0:
        raise ValueError(f"stretch scale a must be > 1; got {a}")
    key = jax.random.key(seed)
    k_init, k_warm, k_run = jax.random.split(key, 3)
    x = _shard_walkers(
        # initialization (not part of the chain): pull stray rows into
        # the box so every walker starts on the target's support
        jnp.clip(jnp.asarray(x0, jnp.float32), lo, hi)
        if x0 is not None
        else _init_walkers(k_init, n_walkers, lo, hi),
        mesh,
    )
    cfg = _StretchProgram(
        a=float(a),
        n_walkers=int(n_walkers),
        thin=int(thin),
        n_warmup=int(n_warmup),
    )
    run = _chain_program(
        loglik,
        _auto_key(cfg, lo, hi, log_prior),
        lambda: _build_stretch_program(loglik, log_prior, lo, hi, cfg),
    )
    warm_keys = jax.random.split(k_warm, max(n_warmup, 1))
    run_keys = jax.random.split(k_run, n_steps)
    x, lp, rates, kept = run(params, x, warm_keys, run_keys)
    chain = (
        _to_host(kept)
        if thin
        else np.empty((0,) + x.shape, np.float32)
    )
    return SampleResult(
        chain=chain,
        final=_to_host(x),
        logp=_to_host(lp),
        accept_rate=_to_host(rates),
        step_size=float(a),
    )


