"""Point estimation on the posterior: MAP fits (:func:`fit_map`, with
the shared whitened-Adam ascent) and profile likelihoods
(:func:`profile_likelihood`).

Split from the round-3 ``sampling.py`` monolith with zero behavior
change; see the package ``__init__`` for the map.
"""

from __future__ import annotations

import dataclasses
from typing import Tuple

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
)


@dataclasses.dataclass(frozen=True)
class _AscentProgram:
    """Statics of :func:`_build_ascent_program`, keyed in full
    (:func:`_auto_key`)."""

    n_steps: int
    learning_rate: float
    jacobian: bool


def _build_ascent_program(valgrad, log_prior, lo, hi, free, cfg):
    """Module-level program builder for :func:`_whitened_adam_ascent`
    — no free variables: statics from ``cfg``, everything else from
    the keyed ``(lo, hi, log_prior, free)`` (see :func:`_auto_key`)."""
    span = hi - lo
    n_steps = cfg.n_steps

    def ll_and_grad_y(params, y):
        s = jax.nn.sigmoid(y)
        xr = lo + span * s
        ll, g_raw = valgrad(params, xr)
        if log_prior is not None:
            lpr, g_pr = _log_prior_val_grad(log_prior, xr)
            ll = ll + lpr
            g_raw = g_raw + g_pr
        g_y = g_raw * (span * s * (1.0 - s))
        if cfg.jacobian:
            ll = ll + jnp.sum(
                jax.nn.log_sigmoid(y) + jax.nn.log_sigmoid(-y), axis=-1
            )
            g_y = g_y + (1.0 - 2.0 * s)
        if free is not None:
            g_y = g_y * free
        return ll, g_y

    b1, b2, eps = 0.9, 0.999, 1e-8

    def run(params, y):
        def adam_step(state, t):
            y, m, v = state
            ll, g = ll_and_grad_y(params, y)
            # dead start ≠ NaN poison
            g = jnp.where(jnp.isfinite(g), g, 0.0)
            m = b1 * m + (1.0 - b1) * g
            v = b2 * v + (1.0 - b2) * g * g
            mh = m / (1.0 - b1 ** t)
            vh = v / (1.0 - b2 ** t)
            # cosine decay to 5% of the initial rate: large early
            # steps to cross the rugged landscape, small late steps
            # to polish the optimum below the Adam-jitter floor
            lr = cfg.learning_rate * (0.05 + 0.95 * 0.5 * (
                1.0 + jnp.cos(jnp.pi * (t - 1.0) / n_steps)
            ))
            y = y + lr * mh / (jnp.sqrt(vh) + eps)  # ascent
            return (y, m, v), None

        state = (y, jnp.zeros_like(y), jnp.zeros_like(y))
        (y, _, _), _ = jax.lax.scan(
            adam_step, state,
            jnp.arange(1, n_steps + 1, dtype=jnp.float32),
        )
        ll, _ = ll_and_grad_y(params, y)
        return lo + span * jax.nn.sigmoid(y), ll

    return jax.jit(run)

@dataclasses.dataclass
class FitResult:
    """Multi-start maximum-likelihood fit output (:func:`fit_map`).

    ``params``: final position of every start, ``(n_starts, n_params)``
    raw units. ``logp``: final log-likelihood per start. ``best`` /
    ``best_logp``: the single best start. Multi-modality shows up as
    clusters in ``params`` with distinct ``logp`` plateaus.
    """

    params: np.ndarray
    logp: np.ndarray
    best: np.ndarray
    best_logp: float

    def top(self, k: int) -> Tuple[np.ndarray, np.ndarray]:
        """The ``k`` best (params, logp) rows, best first."""
        order = np.argsort(-self.logp)[:k]
        return self.params[order], self.logp[order]

    def summary(self, labels=None) -> str:
        labels = labels or [f"p{i}" for i in range(self.params.shape[-1])]
        lines = [
            f"  {l:>8}: {v:12.6g}" for l, v in zip(labels, self.best)
        ]
        return f"best logL {self.best_logp:.6g}\n" + "\n".join(lines)


def fit_map(
    valgrad,
    params,
    *,
    n_starts: int = 1024,
    n_steps: int = 300,
    bounds=None,
    learning_rate: float = 0.05,
    seed: int = 0,
    x0=None,
    log_prior=None,
    mesh=None,
) -> FitResult:
    """Multi-start maximum-likelihood fit of the astrophysical
    parameters: Adam ascent on ``valgrad(params, raw) → (logL, grad)``
    from ``n_starts`` prior draws at once, the whole optimization as one
    ``lax.scan`` on device.

    This replaces the scipy.optimize / grid-search loop reference users
    wrap around 40 ms ``predict`` calls (reference ``README.rst:9-11``
    names fitting observed spectra as the intended use; the reference
    ships no fitter). A thousand restarts cost what one costs — the
    batch rides the same fused value+gradient path the HMC sampler uses
    (measured rates in docs/PERF.md), and multi-start is the practical
    defense against local optima in the 7-parameter landscape.

    The ascent runs in the same sigmoid-whitened unbounded space as
    :func:`sample_hmc` (per-parameter scale = prior span; iterates can
    never leave the box) but WITHOUT the flat-prior Jacobian term — the
    optimum of the raw-space likelihood is wanted, not the mode of the
    transformed density. ``learning_rate`` is in whitened units where
    the box spans ~12 sigmoid units end to end. Use the result to seed
    samplers: ``sample_*(..., x0=result.params)``.

    ``log_prior``: optional smooth log-density over RAW parameters —
    when given, the ascent maximizes ``logL + log π`` (the raw-space
    MAP) instead of the bare likelihood. ``mesh``: optional device mesh
    — starts are embarrassingly parallel and shard across it with zero
    collectives inside the ascent (see :func:`sample_mh`).
    """
    lo, hi = _resolve_bounds(bounds)
    key = jax.random.key(seed)
    x = _shard_walkers(
        jnp.asarray(x0, jnp.float32)
        if x0 is not None
        else _init_walkers(key, n_starts, lo, hi),
        mesh,
    )
    x_fin, ll = _whitened_adam_ascent(
        valgrad, params, lo, hi, x,
        n_steps=n_steps, learning_rate=learning_rate, log_prior=log_prior,
    )
    x_np, ll_np = np.asarray(x_fin), np.asarray(ll)
    best = int(np.nanargmax(ll_np))
    return FitResult(
        params=x_np,
        logp=ll_np,
        best=x_np[best],
        best_logp=float(ll_np[best]),
    )


def _whitened_adam_ascent(
    valgrad, params, lo, hi, x,
    *, n_steps, learning_rate, log_prior, free=None, jacobian=False,
):
    """The shared constrained-ascent core of :func:`fit_map`,
    :func:`profile_likelihood` and :func:`laplace_evidence`:
    cosine-decayed Adam ascent on ``logL(+logπ)`` in the
    sigmoid-whitened box space, starting from raw rows ``x``. ``free``:
    optional (n_params,) 0/1 mask — a 0 coordinate is PINNED (no
    gradient, no movement; its init uses a tighter logit clip so the
    pinned value moves by ≤1e-7·span rather than the free coords' 1e-4,
    since nothing can pull it back). ``jacobian=True`` adds the
    sigmoid-map log-Jacobian so the target is the TRANSFORMED density
    in ``y`` (what a ``y``-space Laplace approximation needs) rather
    than the raw-space likelihood. Returns device ``(x_final, logp)``.
    """
    span = hi - lo
    frac = jnp.clip((x - lo) / span, 1e-4, 1.0 - 1e-4)
    if free is not None:
        pinned = jnp.clip((x - lo) / span, 1e-7, 1.0 - 1e-7)
        frac = jnp.where(free.astype(bool), frac, pinned)
    y0 = jnp.log(frac / (1.0 - frac))

    # cached on the valgrad closure (the sampler idiom,
    # _chain_program): repeated fits / profiles / Laplace runs / ladder
    # warm starts with the same statics reuse one compiled program —
    # every warm call skips the retrace and recompile. ``params`` is a
    # RUN argument, so a
    # retrained model's weights can never go stale in the cache.
    cfg = _AscentProgram(
        n_steps=int(n_steps),
        learning_rate=float(learning_rate),
        jacobian=bool(jacobian),
    )
    free_arr = None if free is None else np.asarray(free)
    run = _chain_program(
        valgrad,
        _auto_key(cfg, lo, hi, log_prior, free_arr, tuple(np.shape(x))),
        lambda: _build_ascent_program(
            valgrad, log_prior, lo, hi,
            None if free_arr is None else jnp.asarray(free_arr), cfg,
        ),
    )
    return run(params, y0)



@dataclasses.dataclass
class ProfileResult:
    """Profile-likelihood curve from :func:`profile_likelihood`.

    ``grid``: the scanned values of the profiled parameter; ``logl``:
    the profile log-likelihood ``max_{others} logL(grid_i, others)``
    per grid point; ``params``: the maximizing full parameter vector at
    each grid point, ``(G, n_params)``. ``interval(level)`` returns the
    Wilks confidence interval — the grid range where
    ``logl ≥ max(logl) − χ²₁(level)/2`` — with the crossings located by
    linear interpolation; an endpoint equal to ``grid[0]``/``grid[-1]``
    means the interval is CENSORED by the scanned range (widen the
    grid)."""

    index: int
    grid: np.ndarray
    logl: np.ndarray
    params: np.ndarray

    def interval(self, level: float = 0.68) -> Tuple[float, float]:
        from scipy.stats import chi2

        if not 0.0 < level < 1.0:
            raise ValueError(f"level must be in (0, 1); got {level}")
        thresh = self.logl.max() - 0.5 * chi2.ppf(level, df=1)
        above = self.logl >= thresh
        if not above.any():  # pragma: no cover - thresh <= max always
            raise RuntimeError("no grid point above the Wilks threshold")
        i0, i1 = np.flatnonzero(above)[[0, -1]]
        lo = self.grid[0] if i0 == 0 else float(np.interp(
            thresh, self.logl[i0 - 1:i0 + 1], self.grid[i0 - 1:i0 + 1]
        ))
        hi = self.grid[-1] if i1 == len(self.grid) - 1 else float(
            np.interp(
                -thresh,
                -self.logl[i1:i1 + 2],
                self.grid[i1:i1 + 2],
            )
        )
        return float(lo), float(hi)


def profile_likelihood(
    valgrad,
    params,
    index: int,
    grid,
    *,
    n_starts: int = 256,
    n_steps: int = 300,
    bounds=None,
    learning_rate: float = 0.05,
    seed: int = 0,
    log_prior=None,
    mesh=None,
) -> ProfileResult:
    """Profile likelihood of ONE parameter — the frequentist
    confidence-interval workflow (Wilks' theorem) the reference
    community runs as a grid of scipy refits around 40 ms ``predict``
    calls: for every value ``g`` in ``grid``, maximize
    ``logL(θ | θ_index = g)`` over the remaining parameters.

    Device shape: the ENTIRE scan — ``len(grid) · n_starts`` constrained
    multi-start Adam ascents — is ONE batched device program riding the
    same fused value+gradient path as :func:`fit_map` (the profiled
    coordinate is pinned by masking its whitened-space gradient).
    A 64-point grid with 256 restarts each costs what a single fit
    costs per step. ``log_prior`` profiles ``logL + logπ`` instead
    (profile posterior). Returns a :class:`ProfileResult`;
    ``result.interval(0.68)`` / ``.interval(0.95)`` give the Wilks
    intervals.
    """
    lo, hi = _resolve_bounds(bounds)
    n_params = int(lo.shape[0])
    if not 0 <= index < n_params:
        raise ValueError(f"index must be in [0, {n_params}); got {index}")
    grid = np.asarray(grid, np.float32)
    if grid.ndim != 1 or grid.shape[0] < 2:
        raise ValueError("grid must be 1-D with >= 2 points")
    if (grid < np.asarray(lo)[index]).any() or (
        grid > np.asarray(hi)[index]
    ).any():
        raise ValueError("grid values must lie inside the prior box")
    g_count = grid.shape[0]
    key = jax.random.key(seed)
    x = _init_walkers(key, g_count * n_starts, lo, hi)
    x = x.reshape(g_count, n_starts, n_params)
    x = x.at[:, :, index].set(grid[:, None])
    x = _shard_walkers(x.reshape(-1, n_params), mesh)
    free = jnp.ones((n_params,), jnp.float32).at[index].set(0.0)
    xr, ll = _whitened_adam_ascent(
        valgrad, params, lo, hi, x,
        n_steps=n_steps, learning_rate=learning_rate,
        log_prior=log_prior, free=free,
    )
    xr = np.asarray(xr).reshape(g_count, n_starts, n_params)
    ll = np.asarray(ll).reshape(g_count, n_starts)
    # a dead start's FINAL value can still be non-finite (only the
    # gradient is sanitized mid-ascent): never let one NaN start poison
    # a grid point's profile value
    ll = np.where(np.isfinite(ll), ll, -np.inf)
    best = ll.argmax(axis=1)
    rows = np.arange(g_count)
    out_params = xr[rows, best]
    # the ascent's sigmoid parameterization cannot land EXACTLY on the
    # pinned value (≤1e-7·span off); restore it exactly
    out_params[:, index] = grid
    return ProfileResult(
        index=index, grid=grid, logl=ll[rows, best], params=out_params
    )


