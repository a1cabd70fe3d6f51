"""Parallel tempering (:func:`sample_pt`): a geometric inverse-
temperature ladder with rung-sharded walkers and ppermute replica
exchange.

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
    _shard_walkers,
    _thin_state,
    _thin_write,
    _to_host,
)
from tpu21cmvae.sampling.results import SampleResult

def _pt_kernel(loglik, log_prior, lo, hi, n_rungs, n_walkers, a, n_sw):
    """Shared tempered-ensemble kernel behind :func:`sample_pt` and
    :func:`log_evidence` (the ptemcee machinery, measured in
    ``examples/multimodal_pt.py``):

    * ``sweep`` — one tempered red-black affine-invariant stretch move
      on every rung (two half-ensemble likelihood batches, self-scaling
      across a 10⁵-nat anneal where random-walk MH measurably stalls),
      with the β=0 rung refreshed by EXACT independence draws from the
      box (fresh mode assignments enter the ladder every sweep);
    * ``swap_phase`` — ``n_sw`` walker-aligned replica-exchange sweeps
      on alternating edges per likelihood sweep (likelihood-FREE, so
      state transport runs at ~K/a likelihood sweeps instead of the
      single-swap K²/a random walk).

    Returns ``(eval_ll, sweep, swap_phase)``; all take ``params`` /
    state as arguments so callers can cache jitted programs on the
    likelihood closure (:func:`_chain_program`).
    """
    n_params = int(lo.shape[0])
    mid = (lo + hi) / 2.0
    half = n_walkers // 2

    def eval_ll(params, flat):
        inside = ((flat >= lo) & (flat <= hi)).all(axis=1)
        safe = jnp.where(inside[:, None], flat, mid)
        return loglik(params, safe), log_prior(safe), inside

    def half_move(params, xa, lla, lpra, xb, betas, k):
        # tempered red-black stretch move: half-ensemble ``xa`` of
        # every rung proposes against partners from the OTHER half
        # ``xb``; target of rung r is β_r·logL + logπ
        kz, kj, ku, kp = jax.random.split(k, 4)
        u = jax.random.uniform(kz, (n_rungs, half), xa.dtype)
        z = ((a - 1.0) * u + 1.0) ** 2 / a
        j = jax.random.randint(kj, (n_rungs, half), 0, half)
        xj = jnp.take_along_axis(xb, j[:, :, None], axis=1)
        prop = xj + z[:, :, None] * (xa - xj)
        # β=0 rung: exact INDEPENDENCE refresh from the box — for a
        # uniform-constant proposal the MH ratio reduces to the prior
        # ratio (≡ 1 for a flat prior). Fresh draws mean fresh MODE
        # assignments enter the ladder every sweep instead of random-
        # walking the prior — this is what makes mode-weight transport
        # fast (and hands the evidence estimator an iid prior rung).
        prop = prop.at[0].set(
            lo + (hi - lo) * jax.random.uniform(kp, (half, n_params))
        )
        ll_p, lpr_p, inside = (
            v.reshape(n_rungs, half) if v.ndim == 1 else v
            for v in eval_ll(params, prop.reshape(-1, n_params))
        )
        stretch = (n_params - 1.0) * jnp.log(z)
        # rung 0's move is independence, not a stretch — no z term
        stretch = stretch.at[0].set(0.0)
        logr = stretch + betas[:, None] * (ll_p - lla) + (lpr_p - lpra)
        logr = jnp.where(inside, logr, -jnp.inf)
        acc = jnp.log(jax.random.uniform(ku, (n_rungs, half))) < logr
        xa = jnp.where(acc[:, :, None], prop, xa)
        lla = jnp.where(acc, ll_p, lla)
        lpra = jnp.where(acc, lpr_p, lpra)
        return xa, lla, lpra, jnp.mean(acc, axis=1)

    def sweep(params, x, ll, lpr, betas, k):
        ka, kb = jax.random.split(k)
        xa, lla, lpra, ra = half_move(
            params, x[:, :half], ll[:, :half], lpr[:, :half],
            x[:, half:], betas, ka,
        )
        # second half moves against the UPDATED first half (required
        # for detailed balance — emcee §3)
        xb, llb, lprb, rb = half_move(
            params, x[:, half:], ll[:, half:], lpr[:, half:],
            xa, betas, kb,
        )
        return (
            jnp.concatenate([xa, xb], axis=1),
            jnp.concatenate([lla, llb], axis=1),
            jnp.concatenate([lpra, lprb], axis=1),
            0.5 * (ra + rb),
        )

    def swaps(x, ll, lpr, betas, parity, k):
        u = jax.random.uniform(k, (n_rungs - 1, n_walkers))
        edge = (jnp.arange(n_rungs - 1) % 2) == parity
        dbeta = betas[1:] - betas[:-1]
        logr = dbeta[:, None] * (ll[:-1] - ll[1:])
        acc = edge[:, None] & (jnp.log(u) < logr)
        pad = jnp.zeros((1, n_walkers), bool)
        take_next = jnp.concatenate([acc, pad])
        take_prev = jnp.concatenate([pad, acc])
        x = jnp.where(
            take_next[:, :, None], jnp.roll(x, -1, 0),
            jnp.where(take_prev[:, :, None], jnp.roll(x, 1, 0), x),
        )
        ll, lpr = (
            jnp.where(
                take_next, jnp.roll(v, -1, 0),
                jnp.where(take_prev, jnp.roll(v, 1, 0), v),
            )
            for v in (ll, lpr)
        )
        # raw per-edge acceptance (inactive edges report 0; double
        # when averaging over alternating sweeps)
        return x, ll, lpr, jnp.mean(acc, axis=1)

    def swap_phase(x, ll, lpr, betas, i0, k):
        parities = jnp.mod(i0 + jnp.arange(n_sw, dtype=jnp.float32), 2.0)
        keys = jax.random.split(k, n_sw)

        def one(carry, pk):
            parity, kk = pk
            x, ll, lpr = carry
            x, ll, lpr, r = swaps(x, ll, lpr, betas, parity, kk)
            return (x, ll, lpr), r

        (x, ll, lpr), rs = jax.lax.scan(one, (x, ll, lpr), (parities, keys))
        # n_sw is even → each edge active on exactly half the sweeps →
        # 2× raw mean = per-attempt acceptance
        return x, ll, lpr, 2.0 * rs.mean(axis=0)

    return eval_ll, sweep, swap_phase


def _pt_sizes_check(n_rungs, n_walkers, n_params, a):
    if n_rungs < 2:
        raise ValueError(f"n_rungs must be >= 2; got {n_rungs}")
    if n_walkers % 2:
        raise ValueError(f"n_walkers must be even; got {n_walkers}")
    if n_walkers < 2 * n_params + 2:
        raise ValueError(
            f"n_walkers must be >= 2*n_params+2 = {2 * n_params + 2} "
            f"for the stretch move to span parameter space; got {n_walkers}"
        )
    if a <= 1.0:
        raise ValueError(f"stretch scale a must be > 1; got {a}")


def _pt_swap_sweeps(swap_sweeps, n_rungs):
    # even (both parities each step); default scales with the ladder
    if swap_sweeps is None:
        swap_sweeps = min(max(n_rungs, 2), 64)
    n_sw = int(swap_sweeps) + (int(swap_sweeps) % 2)
    if n_sw < 2:
        raise ValueError(f"swap_sweeps must be >= 1; got {swap_sweeps}")
    return n_sw


def _geometric_ladder(n_rungs, beta_min):
    """β=0 prior rung + geometric ``beta_min → 1``: equal β ratios give
    ~constant per-edge swap acceptance (≈ exp(-(d/2)(r-1)²/r) at ratio
    ``r`` for Gaussian-ish targets), where power-law ladders' bottom
    edges measurably collapse (docstrings of :func:`sample_pt`)."""
    if not 0.0 < beta_min < 1.0:
        raise ValueError(f"beta_min must be in (0, 1); got {beta_min}")
    if n_rungs == 2:
        # geomspace(beta_min, 1, num=1) returns [beta_min], which would
        # silently make the "posterior" rung β=beta_min — degenerate PT
        # with no tempering is [prior, posterior]
        return np.array([0.0, 1.0])
    return np.concatenate([[0.0], np.geomspace(beta_min, 1.0, n_rungs - 1)])


@dataclasses.dataclass(frozen=True)
class _PTProgram:
    """Statics of :func:`_build_pt_program`, keyed in full
    (:func:`_auto_key`)."""

    n_rungs: int
    n_walkers: int
    a: float
    beta_min: float
    adapt_ladder: bool
    n_sw: int
    thin: int
    n_warmup: int


def _build_pt_program(loglik, log_prior, lo, hi, cfg):
    """Module-level program builder for :func:`sample_pt` — no free
    variables: every static comes from ``cfg`` or the keyed
    ``(lo, hi, log_prior)`` (see :func:`_auto_key`)."""
    log_prior = _resolve_log_prior(log_prior)
    n_rungs, n_walkers = cfg.n_rungs, cfg.n_walkers
    n_params = int(lo.shape[0])
    thin = cfg.thin
    # initial ladder; adaptation (if on) moves the interior gaps,
    # endpoints β=0 / β=1 stay pinned
    betas0 = _geometric_ladder(n_rungs, cfg.beta_min)
    log_gaps0 = jnp.log(jnp.asarray(np.diff(betas0), jnp.float32))
    # ladder-adaptation gain: decays like t0/(t+t0) so the ladder
    # freezes well before the kept phase; t0 scales with the warmup
    # length so short and long warmups both spend ~the first half
    # moving
    t0_ladder = max(float(cfg.n_warmup) / 10.0, 10.0)
    t_adapt_start = float(cfg.n_warmup) / 3.0

    def ladder(log_gaps):
        g = jnp.exp(log_gaps)
        c = jnp.cumsum(g)
        # normalize by the cumsum's own tail so β[-1] is EXACTLY
        # 1.0 (sum() may reduce in a different order → 1±1ulp)
        return jnp.concatenate([jnp.zeros((1,), g.dtype), c / c[-1]])

    eval_ll, sweep, swap_phase = _pt_kernel(
        loglik, log_prior, lo, hi, n_rungs, n_walkers, cfg.a, cfg.n_sw
    )

    def run(params, x, warm_ik, run_ik):
        def warm_step(state, ik):
            i, k = ik
            km, ks = jax.random.split(k)
            x, ll, lpr, log_gaps, a_ema = state
            betas = ladder(log_gaps)
            x, ll, lpr, _ = sweep(params, x, ll, lpr, betas, km)
            x, ll, lpr, s = swap_phase(x, ll, lpr, betas, i, ks)
            if cfg.adapt_ladder and n_rungs > 2:
                # Vousden-style: equalize per-edge swap rates.
                # EMA the per-attempt acceptance, widen gaps
                # whose edges swap more than the ladder average.
                # GATED past the first third of warmup: while the
                # rungs are still annealing from prior draws their
                # logL levels are all similar, so every cold edge
                # reports spuriously high acceptance — adapting on
                # that transient coarsens the ladder bottom by
                # orders of magnitude (measured: β₁ 1e-6 → 1e-3,
                # choking the prior-rung supply to 1e-4)
                t = i + 1.0
                a_ema = 0.8 * a_ema + 0.2 * s
                tt = jnp.maximum(t - t_adapt_start, 0.0)
                gate = (t > t_adapt_start).astype(jnp.float32)
                gain = gate * 0.3 * t0_ladder / (tt + t0_ladder)
                log_gaps = log_gaps + gain * (a_ema - a_ema.mean())
                log_gaps = log_gaps - jnp.mean(log_gaps)  # bounded
            return (x, ll, lpr, log_gaps, a_ema), None

        def run_step(state, ik):
            i, k = ik
            km, ks = jax.random.split(k)
            x, ll, lpr, buf = state
            x, ll, lpr, acc = sweep(params, x, ll, lpr, betas, km)
            x, ll, lpr, s = swap_phase(x, ll, lpr, betas, i, ks)
            if thin:  # β=1 rung only
                buf = _thin_write(
                    buf, i.astype(jnp.int32), x[-1], thin, n_keep
                )
            return (x, ll, lpr, buf), (jnp.mean(acc), s)

        ll, lpr, _ = eval_ll(params, x.reshape(-1, n_params))
        ll = ll.reshape(n_rungs, n_walkers)
        lpr = lpr.reshape(n_rungs, n_walkers)
        log_gaps = log_gaps0
        if cfg.n_warmup > 0:
            state = (
                x, ll, lpr, log_gaps,
                jnp.full((n_rungs - 1,), 0.25, jnp.float32),
            )
            state, _ = jax.lax.scan(warm_step, state, warm_ik)
            x, ll, lpr, log_gaps, _ = state
        betas = ladder(log_gaps)
        n_keep, buf = _thin_state(
            run_ik[0].shape[0], thin, x[-1]
        )
        (x, ll, lpr, buf), (rates, srates) = jax.lax.scan(
            run_step, (x, ll, lpr, buf), run_ik
        )
        return x, ll, lpr, betas, rates, srates, buf[:n_keep]

    return jax.jit(run)


@dataclasses.dataclass
class PTSampleResult(SampleResult):
    """:class:`SampleResult` for the cold (β=1) rung of a parallel-
    tempering run, plus ladder diagnostics: ``swap_rate`` — per-edge
    replica-exchange acceptance (values ≪ 0.1 mean the ladder is too
    coarse to transport modes; add rungs or raise ``n_warmup`` so
    adaptation converges), ``betas`` — the ladder AFTER warmup
    adaptation (``betas[0]=0`` prior rung, ``betas[-1]=1`` posterior)."""

    swap_rate: np.ndarray = None
    betas: np.ndarray = None


def sample_pt(
    loglik,
    params,
    *,
    n_rungs: int = 32,
    n_walkers: int = 256,
    n_steps: int = 400,
    n_warmup: int = 200,
    bounds=None,
    a: float = 2.0,
    beta_min: float = 1e-6,
    adapt_ladder: bool = False,
    swap_sweeps: int = None,
    thin: int = 10,
    seed: int = 0,
    x0=None,
    log_prior=None,
    mesh=None,
) -> PTSampleResult:
    """Parallel-tempering posterior sampler — the tool for MULTIMODAL
    posteriors, where every single-temperature chain sampler here
    (:func:`sample_mh` / :func:`sample_ensemble` / :func:`sample_hmc`)
    goes metastable: walkers stay in whichever basin initialization
    dropped them in, so mode WEIGHTS come out wrong even when all modes
    are found (see :meth:`DirectEmulator.sample_posterior` notes and
    the measured ladder pathology in docs/PERF.md — the machinery here
    is the same, but sampling the β=1 rung is robust where the
    evidence integral was not: swaps only need to TRANSPORT states
    across barriers, not equilibrate every rung's normalization).

    A ``β``-ladder of ``n_rungs`` tempered replicas (β=0 samples the
    prior, β=1 the posterior) runs ``n_walkers`` walker-aligned chains
    per rung; every Metropolis sweep is ONE ``(n_rungs·n_walkers)``-row
    likelihood batch, and replica exchange on alternating edges is
    likelihood-free. Hot rungs cross barriers freely; exchange carries
    those states down to β=1, so the cold chain mixes BETWEEN modes at
    the swap rate instead of the (exponentially small) direct-crossing
    rate. Returns a :class:`PTSampleResult` for the β=1 rung only (the
    hot rungs are scaffolding); ``log_prior``/``mesh``/``x0`` as in
    :func:`log_evidence` (the rung axis shards across ``mesh``).

    The design is ptemcee's (Vousden, Farr & Mandel 2016, MNRAS 455,
    1919), rebuilt as one scanned device program:

    * **within-rung moves are tempered affine-invariant stretch moves**
      (:func:`sample_ensemble`'s red-black scheme with the rung's
      ``β·logL + logπ`` target and stretch scale ``a``) — self-scaling,
      so a 10⁵-nat anneal from prior draws to a sharp 451-bin mode
      needs no step-size adaptation and converges where random-walk MH
      measurably does not (a per-rung adapted-scale MH variant left the
      cold rung ~5,000 nats above the mode after 700 sweeps on the
      `examples/multimodal_pt.py` target; the stretch version
      equilibrates);
    * **the β=0 rung is an exact independence sampler** — fresh
      uniform box draws every sweep (the MH ratio reduces to the prior
      ratio), so fresh MODE assignments enter the ladder at the prior
      rate instead of random-walking;
    * **many swap sweeps per likelihood sweep** (``swap_sweeps``,
      default ≈ ``n_rungs``): exchange is likelihood-free — a sweep
      costs (K−1)·W elementwise ops vs the (K·W)-row likelihood batch —
      so state transport through the ladder runs at ~K/a sweeps
      instead of the single-swap K²/a random walk;
    * **the ladder is geometric from ``beta_min`` to 1** (plus the
      pinned β=0 prior rung) — equal β RATIOS give ~constant per-edge
      swap acceptance for Gaussian-ish targets (acceptance ≈
      ``exp(-(d/2)(r-1)²/r)`` at ratio ``r``), where a power-law
      ladder's bottom edges collapse (measured 2×10⁻⁴ on a sharp
      451-bin emulator likelihood, choking the fresh-mode supply).
      Set ``beta_min ≲ 1/|logL at prior draws|`` so the coldest
      tempered rung still overlaps the prior; the default 1e-6 covers
      |logL| up to ~10⁶ nats;
    * **optional ladder adaptation** (``adapt_ladder=True``): interior
      β gaps move to EQUALIZE per-edge swap rates (the Vousden scheme
      in β-gap space, endpoints pinned), gated past the first third of
      warmup and with a ``t0/(t+t0)``-decaying gain. Off by default —
      MEASURED on a sharp 451-bin emulator likelihood, equalization
      coarsens the prior edge (β₁ 1e-6 → 7e-4, its swap rate → 0,
      recovered mode split 0.65 vs 0.69 with the fixed geometric
      ladder; see ``examples/multimodal_pt.py``); reach for it only
      when ``beta_min`` is badly mis-set and can't be fixed directly.

    Mode-WEIGHT convergence is transport-limited: expect O(10³) kept
    steps for the cold-chain split to equilibrate (each mode
    assignment must traverse the ladder). That is cheap here — sweeps
    are fixed-shape mega-batches, the whole run one program.

    Programs are cached on the likelihood closure (weights are traced
    arguments), so repeated calls with the same statics re-trace
    nothing (:func:`_chain_program`). ``n_walkers`` must be even and
    ≥ ``2·n_params + 2`` (red-black halves must span parameter space).
    """
    lo, hi = _resolve_bounds(bounds)
    n_params = int(lo.shape[0])
    _pt_sizes_check(n_rungs, n_walkers, n_params, a)
    _geometric_ladder(n_rungs, beta_min)  # validate beta_min eagerly
    n_sw = _pt_swap_sweeps(swap_sweeps, n_rungs)
    key = jax.random.key(seed)
    k_init, k_warm, k_run = jax.random.split(key, 3)
    if x0 is not None:
        seed_rows = jnp.clip(jnp.asarray(x0, jnp.float32), lo, hi)
        if seed_rows.shape != (n_walkers, n_params):
            raise ValueError(
                f"x0 must have shape ({n_walkers}, {n_params}); "
                f"got {seed_rows.shape}"
            )
        x = jnp.broadcast_to(seed_rows[None], (n_rungs, n_walkers, n_params))
    else:
        x = _init_walkers(
            k_init, n_rungs * n_walkers, lo, hi
        ).reshape(n_rungs, n_walkers, n_params)
    x = _shard_walkers(x, mesh)

    cfg = _PTProgram(
        n_rungs=int(n_rungs),
        n_walkers=int(n_walkers),
        a=float(a),
        beta_min=float(beta_min),
        adapt_ladder=bool(adapt_ladder),
        n_sw=int(n_sw),
        thin=int(thin),
        n_warmup=int(n_warmup),
    )
    run = _chain_program(
        loglik,
        _auto_key(cfg, lo, hi, log_prior),
        lambda: _build_pt_program(loglik, log_prior, lo, hi, cfg),
    )

    def ik(k, n):
        n = max(n, 1)
        return (jnp.arange(n, dtype=jnp.float32), jax.random.split(k, n))

    x, ll, lpr, betas, rates, srates, kept = run(
        params, x, ik(k_warm, n_warmup), ik(k_run, n_steps)
    )
    chain = (
        _to_host(kept)
        if thin
        else np.empty((0, n_walkers, n_params), np.float32)
    )
    return PTSampleResult(
        chain=chain,
        final=_to_host(x[-1]),
        logp=_to_host(ll[-1] + lpr[-1]),
        accept_rate=_to_host(rates),
        step_size=float(a),  # the stretch scale (cf. sample_ensemble)
        swap_rate=_to_host(srates).mean(axis=0),
        betas=_to_host(betas),
    )


