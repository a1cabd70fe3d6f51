"""Adaptive-temperature sequential Monte Carlo (:func:`sample_smc`)
with systematic resampling and an unbiased evidence estimate.

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
    _init_walkers,
    _resolve_bounds,
    _resolve_log_prior,
    _to_host,
)

@dataclasses.dataclass(frozen=True)
class _SMCProgram:
    """Statics of :func:`_build_smc_program`, keyed in full
    (:func:`_auto_key`)."""

    n_particles: int
    n_mh: int
    a: float
    target_ess_frac: float
    max_stages: int


def _build_smc_program(loglik, log_prior, lo, hi, cfg):
    """Module-level program builder for :func:`sample_smc` — no free
    variables: every static comes from ``cfg`` or the keyed
    ``(lo, hi, log_prior)`` (see :func:`_auto_key`)."""
    has_prior = log_prior is not None
    log_prior = _resolve_log_prior(log_prior)
    n_params = int(lo.shape[0])
    mid = (lo + hi) / 2.0
    m = cfg.n_particles // 2  # per sub-population
    half = m // 2
    a = cfg.a
    n_mh = cfg.n_mh
    tef = cfg.target_ess_frac
    ms = cfg.max_stages

    def eval_ll(params, flat):
        inside = ((flat >= lo) & (flat <= hi)).all(axis=1)
        safe = jnp.where(inside[:, None], flat, mid)
        ll = loglik(params, safe)
        ll = jnp.where(jnp.isfinite(ll) & inside, ll, -jnp.inf)
        return ll, log_prior(safe), inside

    def half_move(params, xa, lla, lpra, xb, beta, k):
        # red-black stretch move within each sub-population
        # (axis 0 = the two independent replicas)
        kz, kj, ku = jax.random.split(k, 3)
        u = jax.random.uniform(kz, (2, half), xa.dtype)
        z = ((a - 1.0) * u + 1.0) ** 2 / a
        j = jax.random.randint(kj, (2, half), 0, half)
        xj = jnp.take_along_axis(xb, j[:, :, None], axis=1)
        prop = xj + z[:, :, None] * (xa - xj)
        ll_p, lpr_p, inside = (
            v.reshape(2, half) for v in
            eval_ll(params, prop.reshape(-1, n_params))
        )
        logr = (
            (n_params - 1.0) * jnp.log(z)
            + beta * (ll_p - lla) + (lpr_p - lpra)
        )
        logr = jnp.where(inside, logr, -jnp.inf)
        acc = jnp.log(jax.random.uniform(ku, (2, half))) < logr
        xa = jnp.where(acc[:, :, None], prop, xa)
        lla = jnp.where(acc, ll_p, lla)
        lpra = jnp.where(acc, lpr_p, lpra)
        return xa, lla, lpra, jnp.mean(acc)

    def indep_move(params, x, ll, lpr, prop_stats, beta, k):
        # independence MH from the population-moment-matched
        # Gaussian (pymc-SMC's IMH kernel): a GLOBAL move — one
        # accepted draw fully decorrelates a resampled duplicate,
        # which the local stretch move only manages geometrically
        # (with the adaptive refresh criterion below, measured
        # anneal-lag evidence bias on a sharp trained-emulator
        # posterior: −4.9 → −0.6 nats at the default budget,
        # within the replication error at larger ones). The
        # proposal is FROZEN per stage (moments of the
        # post-resample population), so this is plain MH wrt π_β.
        mean, sd_p, cr, icr = prop_stats
        kz, ku = jax.random.split(k)
        eps = jax.random.normal(kz, x.shape, x.dtype)
        prop = mean[:, None] + jnp.einsum(
            "rij,rkj->rik", eps, cr
        ) * sd_p[:, None]
        ll_p, lpr_p, inside = (
            v.reshape(2, m) for v in
            eval_ll(params, prop.reshape(-1, n_params))
        )

        def logq(v):
            w = jnp.einsum(
                "rik,rjk->rij",
                (v - mean[:, None]) / sd_p[:, None], icr,
            )
            return -0.5 * jnp.sum(w * w, axis=-1)

        logr = (
            beta * (ll_p - ll) + (lpr_p - lpr)
            + logq(x) - logq(prop)
        )
        logr = jnp.where(inside, logr, -jnp.inf)
        acc = jnp.log(jax.random.uniform(ku, (2, m))) < logr
        x = jnp.where(acc[:, :, None], prop, x)
        ll = jnp.where(acc, ll_p, ll)
        lpr = jnp.where(acc, lpr_p, lpr)
        return x, ll, lpr, acc

    def prop_from(x):
        # per-replica moment-matched proposal in STANDARDIZED
        # coordinates (raw covariance spans ~13 decades on sharp
        # emulator posteriors — an f32 cholesky needs the
        # correlation form), lightly ridged for rank safety
        mean = jnp.mean(x, axis=1)
        sd_p = jnp.std(x, axis=1) + 1e-12
        z = (x - mean[:, None]) / sd_p[:, None]
        corr = jnp.einsum("rij,rik->rjk", z, z) / m
        corr = corr + 1e-4 * jnp.eye(n_params, dtype=x.dtype)
        cr = jnp.linalg.cholesky(corr)
        eye = jnp.broadcast_to(
            jnp.eye(n_params, dtype=x.dtype), cr.shape
        )
        icr = jax.scipy.linalg.solve_triangular(cr, eye, lower=True)
        return mean, sd_p, cr, icr

    def mutate(params, x, ll, lpr, beta, k):
        # ADAPTIVE sweep count: at least n_mh sweeps, then keep
        # going until ≥95 % of particles have accepted at least one
        # independence refresh (a refreshed particle is a fresh
        # draw — the duplicate correlation resampling created is
        # GONE, which is exactly what bounds the anneal-lag
        # evidence bias), capped at 4·n_mh. Self-tunes the
        # mutation budget to each stage's difficulty.
        prop_stats = prop_from(x)
        cap = 4 * n_mh

        def cond(c):
            i, _, _, _, _, fresh = c
            return (i < cap) & (
                (i < n_mh) | (jnp.mean(fresh) < 0.95)
            )

        def body(c):
            i, x, ll, lpr, r, fresh = c
            ka, kb, ki = jax.random.split(
                jax.random.fold_in(k, i), 3
            )
            xa, lla, lpra, ra = half_move(
                params, x[:, :half], ll[:, :half], lpr[:, :half],
                x[:, half:], beta, ka,
            )
            xb, llb, lprb, rb = half_move(
                params, x[:, half:], ll[:, half:], lpr[:, half:],
                xa, beta, kb,
            )
            x = jnp.concatenate([xa, xb], axis=1)
            ll = jnp.concatenate([lla, llb], axis=1)
            lpr = jnp.concatenate([lpra, lprb], axis=1)
            x, ll, lpr, acc = indep_move(
                params, x, ll, lpr, prop_stats, beta, ki
            )
            return (
                i + 1, x, ll, lpr, r + 0.5 * (ra + rb),
                fresh | acc,
            )

        i, x, ll, lpr, r, _ = jax.lax.while_loop(
            cond, body,
            (jnp.int32(0), x, ll, lpr, jnp.float32(0.0),
             jnp.zeros((2, m), bool)),
        )
        return x, ll, lpr, r / jnp.maximum(i, 1).astype(jnp.float32)

    def resample(x, ll, lpr, logw, k):
        # systematic resampling WITHIN each sub-population: the two
        # replicas never exchange particles, so their logz
        # estimates stay independent
        lse = jax.scipy.special.logsumexp(logw, axis=1,
                                          keepdims=True)
        cdf = jnp.cumsum(jnp.exp(logw - lse), axis=1)
        u = jax.random.uniform(k, (2, 1))
        pos = (jnp.arange(m, dtype=jnp.float32)[None] + u) / m
        idx = jnp.stack([
            jnp.searchsorted(cdf[0], pos[0]),
            jnp.searchsorted(cdf[1], pos[1]),
        ]).clip(0, m - 1)
        gather = lambda v: jnp.take_along_axis(  # noqa: E731
            v, idx[:, :, None] if v.ndim == 3 else idx, axis=1
        )
        return gather(x), gather(ll), gather(lpr)

    def ess_frac(g, d):
        # normalized ESS of incremental weights exp(d·g), pooled
        # over both replicas (the schedule is shared)
        lw = (d * g).reshape(-1)
        lse = jax.scipy.special.logsumexp(lw)
        lse2 = jax.scipy.special.logsumexp(2.0 * lw)
        return jnp.exp(2.0 * lse - lse2) / (2 * m)

    def pick_delta(g, beta):
        cap = 1.0 - beta
        full = ess_frac(g, cap) >= tef

        def bis(i, lohi):
            lo_d, hi_d = lohi
            mid_d = 0.5 * (lo_d + hi_d)
            ok = ess_frac(g, mid_d) >= tef
            return (
                jnp.where(ok, mid_d, lo_d),
                jnp.where(ok, hi_d, mid_d),
            )

        lo_d, _ = jax.lax.fori_loop(
            0, 32, bis, (jnp.float32(0.0), cap)
        )
        return jnp.where(full, cap, lo_d), full

    def run(params, x, key_root):
        ll, lpr, _ = (
            v.reshape(2, m) if v.ndim == 1 else v
            for v in eval_ll(params, x.reshape(-1, n_params))
        )
        if has_prior:
            # uncredited importance conversion box → prior
            kr, km_ = jax.random.split(
                jax.random.fold_in(key_root, ms + 1)
            )
            x, ll, lpr = resample(x, ll, lpr, lpr, kr)
            x, ll, lpr, _ = mutate(
                params, x, ll, lpr, jnp.float32(0.0), km_
            )

        def cond(c):
            return (c[3] < 1.0) & (c[4] < ms)

        def body(c):
            x, ll, lpr, beta, stage, lza, lzb, betas, esss, accs = c
            d, _ = pick_delta(ll, beta)
            lw = d * ll
            lz_inc = (
                jax.scipy.special.logsumexp(lw, axis=1)
                - jnp.log(float(m))
            )
            kr, km_ = jax.random.split(
                jax.random.fold_in(key_root, stage)
            )
            ef = ess_frac(ll, d)
            x, ll, lpr = resample(x, ll, lpr, lw, kr)
            beta = jnp.minimum(beta + d, 1.0)
            x, ll, lpr, acc = mutate(params, x, ll, lpr, beta, km_)
            return (
                x, ll, lpr, beta, stage + 1,
                lza + lz_inc[0], lzb + lz_inc[1],
                betas.at[stage + 1].set(beta),
                esss.at[stage].set(ef),
                accs.at[stage].set(acc),
            )

        # pad value 0 (not NaN — the debug-NaN hook flags produced
        # NaNs); the caller slices the pad off before returning
        z = jnp.float32(0.0)
        init = (
            x, ll, lpr, z, jnp.int32(0), z, z,
            jnp.zeros((ms + 1,), jnp.float32),
            jnp.zeros((ms,), jnp.float32),
            jnp.zeros((ms,), jnp.float32),
        )
        (x, ll, lpr, beta, stage, lza, lzb, betas, esss, accs) = (
            jax.lax.while_loop(cond, body, init)
        )
        return x, ll, lpr, beta, stage, lza, lzb, betas, esss, accs

    return jax.jit(run)


@dataclasses.dataclass
class SMCResult:
    """Output of :func:`sample_smc` — an equally-weighted posterior
    particle population plus the evidence the anneal integrates on the
    way there.

    ``final``: ``(n_particles, n_params)`` posterior draws at β=1
    (post-resample population — equally weighted, but RESAMPLING
    duplicates ancestors, so these are not ``n_particles`` independent
    samples; treat like one well-mixed MCMC batch). ``flat`` aliases it
    for API uniformity with :class:`SampleResult`. ``logp``: per-
    particle ``logL + log_prior``. ``logz``: the SMC evidence — the sum
    over anneal stages of the log-mean incremental weight, same
    normalized-prior convention as :func:`log_evidence` /
    :func:`tpu21cmvae.nested.nested_sampling`. ``logz_err``: half the
    |difference| of the two INDEPENDENT sub-populations' estimates
    (they share the β schedule but never exchange particles — genuine
    replication, unlike a post-hoc split of one genealogy).
    ``n_stages``: anneal stages actually used (``== max_stages`` means
    the schedule was truncated — raise ``max_stages`` or inspect
    ``betas``). ``betas``: the adaptive schedule,
    ``stage_ess``: the normalized incremental-weight ESS fraction each
    stage targeted, ``accept_rate``: per-stage mutation acceptance
    (values ≲ 0.1 mean ``n_mh`` sweeps are too few to decorrelate the
    resampled duplicates).
    """

    final: np.ndarray
    logp: np.ndarray
    logz: float
    logz_err: float
    n_stages: int
    betas: np.ndarray
    stage_ess: np.ndarray
    accept_rate: np.ndarray

    @property
    def flat(self) -> np.ndarray:
        return self.final

    def summary(self, labels=None) -> str:
        mean, std = self.final.mean(0), self.final.std(0)
        labels = labels or [f"p{i}" for i in range(self.final.shape[-1])]
        lines = [
            f"  {l:>8}: {m:12.5g} ± {s:10.4g}"
            for l, m, s in zip(labels, mean, std)
        ]
        return (
            f"log Z = {self.logz:.4f} ± {self.logz_err:.4f} "
            f"({self.n_stages} stages, mutation accept "
            f"{float(np.mean(self.accept_rate)):.2f})\n"
            + "\n".join(lines)
        )


def sample_smc(
    loglik,
    params,
    *,
    n_particles: int = 4096,
    n_mh: int = 8,
    bounds=None,
    a: float = 2.0,
    target_ess_frac: float = 0.5,
    max_stages: int = 64,
    seed: int = 0,
    log_prior=None,
    mesh=None,
) -> SMCResult:
    """Adaptive tempered Sequential Monte Carlo (Del Moral, Doucet &
    Jasra 2006): anneal a particle population from the prior to the
    posterior along a SELF-CHOSEN β schedule, harvesting the evidence
    on the way — the algorithm modern cosmology samplers (pocoMC;
    dynesty's rivals) build on, and a natural device program: every stage
    is three fixed-shape population-wide batches (weight, resample,
    mutate), no sequential chain anywhere.

    Each stage: (1) choose the largest ``δβ`` whose incremental
    weights ``w ∝ L^δβ`` keep the population's normalized ESS at
    ``target_ess_frac`` (32-step bisection — monotone in δβ), capped
    at β=1; (2) credit ``log mean w`` to ``log Z`` (stepping-stone
    identity, same normalized-prior convention as
    :func:`log_evidence`); (3) systematic-resample; (4) decorrelate
    the duplicates with ``n_mh`` red-black affine-invariant stretch
    sweeps targeting ``β·logL + logπ`` (the self-scaling move that
    anneals 10⁵-nat likelihoods from prior draws where random-walk MH
    stalls — :func:`_pt_kernel`). With an external ``log_prior`` the
    box population is first importance-converted to the prior (one
    uncredited reweight+resample+mutate at β=0), matching
    :func:`sample_pt`'s prior-rung semantics.

    The whole anneal is ONE ``lax.while_loop`` device program with a
    data-dependent stage count (bounded by ``max_stages``); programs
    cache on the likelihood closure (:func:`_chain_program`). The
    population runs as TWO independent sub-populations (shared
    schedule, disjoint resampling and mutation) so ``logz_err`` is a
    genuine replication error, not a within-genealogy optimism.
    Compared to the PT stepping-stone ladder (:func:`log_evidence`)
    the schedule is adaptive instead of guessed (no ``beta_min`` /
    ``n_rungs`` tuning, no ladder-drift alarm needed) and every
    likelihood row works at the CURRENT β instead of equilibrating a
    full ladder each sweep; compared to nested sampling it is one
    fixed-shape program with no sorted live-set bookkeeping.
    Multimodal targets: resampling preserves mode weights as long as
    the anneal is gentle (ESS targeting makes it so) — measured on the
    80/20 two-Gaussian target every single-temperature sampler fails
    (``tests/test_smc.py``).

    ``n_particles`` must be divisible by 4 (two sub-populations × two
    stretch-move half-ensembles) with each quarter ≥ ``n_params + 1``;
    ``mesh`` shards the per-sub-population particle axis. The reference
    has no sampler at all (its emulator feeds external CPU samplers,
    ``README.rst:9-11``).
    """
    lo, hi = _resolve_bounds(bounds)
    n_params = int(lo.shape[0])
    if n_particles % 4:
        raise ValueError(
            f"n_particles must be divisible by 4; got {n_particles}"
        )
    m = n_particles // 2  # per sub-population
    if m // 2 < n_params + 1:
        raise ValueError(
            f"n_particles must be >= 4*(n_params+1) = "
            f"{4 * (n_params + 1)} for the stretch move to span "
            f"parameter space; got {n_particles}"
        )
    if a <= 1.0:
        raise ValueError(f"stretch scale a must be > 1; got {a}")
    if not 0.0 < target_ess_frac < 1.0:
        raise ValueError(
            f"target_ess_frac must be in (0, 1); got {target_ess_frac}"
        )
    if max_stages < 2:
        raise ValueError(f"max_stages must be >= 2; got {max_stages}")
    key = jax.random.key(seed)
    k_init, k_run = jax.random.split(key)
    x = _init_walkers(k_init, 2 * m, lo, hi).reshape(2, m, n_params)
    if mesh is not None:
        from jax.sharding import NamedSharding, PartitionSpec

        n_dev = int(mesh.devices.size)
        if m % n_dev:
            raise ValueError(
                f"n_particles/2 = {m} must divide evenly across the "
                f"{n_dev}-device mesh"
            )
        x = jax.device_put(x, NamedSharding(
            mesh, PartitionSpec(None, mesh.axis_names, None)
        ))
    ms = int(max_stages)
    cfg = _SMCProgram(
        n_particles=int(n_particles),
        n_mh=int(n_mh),
        a=float(a),
        target_ess_frac=float(target_ess_frac),
        max_stages=int(max_stages),
    )
    run = _chain_program(
        loglik,
        _auto_key(cfg, lo, hi, log_prior),
        lambda: _build_smc_program(loglik, log_prior, lo, hi, cfg),
    )
    x, ll, lpr, beta, stage, lza, lzb, betas, esss, accs = run(
        params, x, k_run
    )
    if float(beta) < 1.0:
        raise RuntimeError(
            f"SMC anneal truncated at beta={float(beta):.4g} after "
            f"{int(stage)} stages; raise max_stages (= {ms}) or "
            f"target a lower target_ess_frac"
        )
    lza, lzb = float(lza), float(lzb)
    n_stages = int(stage)
    return SMCResult(
        final=_to_host(x.reshape(-1, n_params)),
        logp=_to_host((ll + lpr).reshape(-1)),
        logz=0.5 * (lza + lzb),
        logz_err=0.5 * abs(lza - lzb),
        n_stages=n_stages,
        betas=_to_host(betas)[: n_stages + 1],
        stage_ess=_to_host(esss)[:n_stages],
        accept_rate=_to_host(accs)[:n_stages],
    )


