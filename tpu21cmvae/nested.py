"""On-device nested sampling — robust Bayesian evidence for sharp,
rugged, multimodal emulator posteriors.

Nested sampling (Skilling 2006) is THE evidence workflow of 21-cm
analyses — the reference's users run MultiNest/PolyChord around ~40 ms
``predict`` calls (reference ``README.rst:9-11``; Bye et al. 2022 §4).
Here the whole sampler is a device program over the gram likelihood
(:func:`tpu21cmvae.ops.loglik.make_loglik`).

Why this exists next to :func:`tpu21cmvae.sampling.log_evidence` (the
parallel-tempering stepping-stone path): measured on real trained-
emulator posteriors, the PT ladder is NOT reliable — its estimate
drifts by hundreds of nats as the ladder densifies (−380 → −704 → −953
at K = 32 → 128 → 256 on the same problem) and keeps ~75–115-nat
seed-to-seed scatter even when warm-started from a converged multi-
start fit, while its within-run split-half error reads ~0.2 (each run
is stuck in its own quasi-stationary state; the landscape is rugged
and effectively multimodal). Nested sampling sidesteps equilibration
entirely: it only ever needs samples UNIFORM in the prior above a
rising likelihood threshold, compresses geometrically by construction,
and handles multimodality by carrying ``n_live`` points that populate
every mode in proportion to volume. Measured on the same problem, its
seed-to-seed spread is ~1 nat (docs/PERF.md).

Device mapping: the classic algorithm kills ONE point per iteration —
serial and tiny. Here each iteration kills the ``n_batch`` worst live
points at once and regrows them with ``n_mh`` Metropolis steps
constrained to ``logL > L*``, all chains advancing in one batched
likelihood call per step; iterations run inside ``lax.scan`` chunks
with only the stop test on the host. Volume bookkeeping stays exact
for batched deaths: death ``m`` of a batch shrinks ``log X`` by
``1/(n_live − m)`` (the standard result with deaths ordered within the
batch), and all weight arithmetic is done in log space so posteriors
compressed by thousands of nats don't underflow.
"""

from __future__ import annotations

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np

from tpu21cmvae.sampling import _init_walkers, _resolve_bounds
from tpu21cmvae.sampling._common import _to_host

__all__ = ["NestedResult", "nested_sampling", "nested_sampling_batch"]


def _log1mexp(neg_delta: np.ndarray) -> np.ndarray:
    """log(1 - exp(neg_delta)) for neg_delta < 0, stable near 0."""
    neg_delta = np.minimum(neg_delta, -1e-300)
    out = np.empty_like(neg_delta)
    small = neg_delta > -0.6931471805599453  # log 2
    out[small] = np.log(-np.expm1(neg_delta[small]))
    out[~small] = np.log1p(-np.exp(neg_delta[~small]))
    return out


@dataclasses.dataclass
class NestedResult:
    """Result of :func:`nested_sampling`.

    ``logz`` / ``logz_err``: the evidence ``log Z = log ∫ L π dθ``
    under the flat box prior and its statistical error
    ``sqrt(H / n_live)`` (Skilling 2006 §6; H is the information —
    prior-to-posterior compression in nats). Unlike the PT ladder's
    split-half error this bound is structural: volume shrinkage is
    geometric by construction, so there is no unequilibrated-chain
    failure mode for it to miss. ``samples`` / ``logl`` / ``log_w``:
    all dead + final live points, their log-likelihoods, and NORMALIZED
    posterior log-weights (``logsumexp(log_w) = 0``) — use
    :meth:`posterior` for equal-weight resampling. ``logx``: each
    sample's log prior-volume coordinate. ``ess``: Kish effective
    sample size of the weighted posterior. ``n_like``: total
    likelihood rows evaluated. ``truncated``: True if ``max_iters``
    hit before the live-set remainder fell below ``stop_frac`` of the
    accumulated evidence — the estimate is then a lower bound;
    raise ``max_iters``/``n_live``.
    """

    logz: float
    logz_err: float
    h: float
    samples: np.ndarray
    logl: np.ndarray
    log_w: np.ndarray
    logx: np.ndarray
    ess: float
    n_iters: int
    n_like: int
    accept_rate: float
    truncated: bool

    def posterior(self, n: int, seed: int = 0) -> np.ndarray:
        """Equal-weight posterior draws by multinomial resampling."""
        rng = np.random.default_rng(seed)
        p = np.exp(self.log_w - self.log_w.max())
        p /= p.sum()
        idx = rng.choice(len(p), size=n, p=p)
        return self.samples[idx]

    def summary(self) -> str:
        note = (
            "  ** truncated at max_iters: logz is a LOWER bound — "
            "raise max_iters or n_live **"
            if self.truncated
            else ""
        )
        return (
            f"log Z = {self.logz:.4f} ± {self.logz_err:.3f}  "
            f"(H = {self.h:.1f} nats, {self.n_iters} dead points, "
            f"ESS {self.ess:.0f}, MH accept {self.accept_rate:.2f})"
            f"{note}"
        )


@dataclasses.dataclass(frozen=True)
class _NestedProgram:
    """Statics of :func:`_build_nested_programs`, keyed in full
    (``sampling/_common.py::_auto_key``); the prior transform and the
    mesh identity are keyed as extras."""

    n_obs: int
    n_live: int
    n_batch: int
    n_mh: int
    target_accept: float
    iters_per_chunk: int


def _build_nested_programs(loglik_multi, to_theta, lo, hi, pin_rows, cfg):
    """Module-level program builder for the (batched) nested sampler —
    no free variables: statics from ``cfg``, everything else from the
    keyed arguments (the structural cache-key contract of
    ``sampling/_common.py::_auto_key``). Returns jitted
    ``(init, run_chunk)`` over observation-major state arrays
    ``x (O, n_live, P)``, ``ll (O, n_live)``, ``log_scale (O,)``."""
    n_obs, n_live, n_batch = cfg.n_obs, cfg.n_live, cfg.n_batch
    n_params = int(lo.shape[0])
    mid = (lo + hi) / 2.0
    oi = jnp.arange(n_obs)[:, None]

    def safe_ll_p(params, flat):
        # flat: (O*B, P) observation-major — row o*B + b is a chain of
        # observation o, exactly make_loglik_multi's row convention;
        # weights are a traced run argument (never baked)
        inside = ((flat >= lo) & (flat <= hi)).all(axis=1)
        ll = loglik_multi(params, to_theta(
            jnp.where(inside[:, None], flat, mid)
        ))
        return jnp.where(inside, ll, -jnp.inf)

    def one_iter(params, state, k):
        x, ll, log_scale = state
        k_start, k_mh = jax.random.split(k)
        order = jnp.argsort(ll, axis=1)  # (O, L) ascending
        dead_idx = order[:, :n_batch]
        lstar = jnp.take_along_axis(
            ll, order[:, n_batch - 1:n_batch], axis=1
        )  # (O, 1)
        surv_idx = order[:, n_batch:]  # (O, S)
        xs = jnp.take_along_axis(x, surv_idx[:, :, None], axis=1)
        # per-obs per-dim survivor spread sets the proposal shape; the
        # per-obs adapted global factor sets its size (degenerate dims
        # get a floor so chains can move off a collapsed face)
        std = jnp.std(xs, axis=1) + 1e-7 * (hi - lo)  # (O, P)
        ri = jax.random.randint(
            k_start, (n_obs, n_batch), 0, n_live - n_batch
        )
        starts = jnp.take_along_axis(surv_idx, ri, axis=1)  # (O, B)
        # re-pin the replacement chains: the survivor gather above
        # would otherwise leave them replicated, serializing the MH
        # likelihood scan below (the FLOP-dominant part)
        xc = pin_rows(
            jnp.take_along_axis(x, starts[:, :, None], axis=1)
        )  # (O, B, P)
        llc = jnp.take_along_axis(ll, starts, axis=1)
        scale = jnp.exp(log_scale)[:, None, None]

        def mh(carry, kk):
            xc, llc, nacc = carry
            kk1, _ = jax.random.split(kk)
            prop = xc + scale * std[:, None, :] * jax.random.normal(
                kk1, xc.shape, xc.dtype
            )
            llp = safe_ll_p(
                params, prop.reshape(-1, n_params)
            ).reshape(n_obs, n_batch)
            ok = llp > lstar
            xc = jnp.where(ok[:, :, None], prop, xc)
            llc = jnp.where(ok, llp, llc)
            return (xc, llc, nacc + jnp.mean(ok, axis=1)), None

        (xc, llc, nacc), _ = jax.lax.scan(
            mh, (xc, llc, jnp.zeros((n_obs,), jnp.float32)),
            jax.random.split(k_mh, cfg.n_mh),
        )
        acc = nacc / cfg.n_mh  # (O,)
        dead_ll = jnp.take_along_axis(ll, dead_idx, axis=1)  # ascending
        dead_x = jnp.take_along_axis(x, dead_idx[:, :, None], axis=1)
        x = x.at[oi, dead_idx].set(xc)
        ll = ll.at[oi, dead_idx].set(llc)
        log_scale = jnp.clip(
            log_scale + 0.5 * (acc - cfg.target_accept), -8.0, 2.0
        )
        return (x, ll, log_scale), (dead_ll, dead_x, acc)

    def run_chunk(params, x, ll, log_scale, keys):
        def step(state, k):
            return one_iter(params, state, k)

        (x, ll, log_scale), (dll, dx, accs) = jax.lax.scan(
            step, (x, ll, log_scale), keys
        )
        return x, ll, log_scale, dll, dx, accs

    def init(params, k):
        x = pin_rows(
            _init_walkers(k, n_obs * n_live, lo, hi).reshape(
                n_obs, n_live, n_params
            )
        )
        return x, safe_ll_p(params, x.reshape(-1, n_params)).reshape(
            n_obs, n_live
        )

    return jax.jit(init), jax.jit(run_chunk)


def nested_sampling_batch(
    loglik_multi,
    params,
    n_obs: int,
    *,
    n_live: int = 1024,
    n_batch: int | None = None,
    n_mh: int = 24,
    bounds=None,
    target_accept: float = 0.3,
    stop_frac: float = 1e-3,
    max_iters: int = 4096,
    iters_per_chunk: int = 32,
    seed: int = 0,
    prior_transform=None,
    mesh=None,
) -> list:
    """Nested sampling over a BATCH of observations as one device
    program — the definitive tier of the evidence-reliability loop,
    batched (round-4 VERDICT "next round" item 1).

    ``loglik_multi(params, raw (O·W, P)) → (O·W,)`` is the stacked-
    observation likelihood (:func:`tpu21cmvae.ops.loglik.
    make_loglik_multi`; row ``o·W + w`` scores against observation
    ``o``). Every observation carries its OWN live set, threshold
    ladder, and adapted proposal scale; each iteration kills the
    ``n_batch`` worst points of EVERY observation and regrows them
    with constrained MH — so each device call advances
    ``n_obs · n_batch`` chains in one observation-major mega-batch,
    exactly the shape the stacked gram trunk shares work across
    (measured: 25 sequential per-row nested runs at ~4-10 s each
    dominated the real-batch escalation wall, docs/PERF.md; the batch
    runs them as one program). Iterations continue until EVERY
    observation passes the per-observation stop test (converged rows
    keep compressing harmlessly — their extra dead points carry
    negligible weight and sharpen ``logz`` slightly).

    The volume bookkeeping is per-observation and identical to
    :func:`nested_sampling` (all rows share ``n_live``/``n_batch``,
    hence one shared log-volume ladder). Programs cache on the
    likelihood closure with a structurally-complete auto-derived key
    (``sampling/_common.py::_auto_key``), so repeated batched finals
    re-trace nothing.

    ``prior_transform``/``bounds``/``mesh`` as in
    :func:`nested_sampling` (the transform is shared by all rows; the
    live-point axis shards over ``mesh``). Returns a list of ``n_obs``
    :class:`NestedResult`, ordered like the observations; per-row
    ``logz`` agrees with the sequential path within ``logz_err``
    (``tests/test_nested.py::test_batch_matches_sequential``).
    """
    from tpu21cmvae.sampling._common import _auto_key, _chain_program

    lo_raw, hi_raw = _resolve_bounds(bounds)
    n_params = int(lo_raw.shape[0])
    if prior_transform is None:
        lo, hi = lo_raw, hi_raw

        def to_theta(u):
            return u

    else:
        lo = jnp.zeros((n_params,), jnp.float32)
        hi = jnp.ones((n_params,), jnp.float32)
        to_theta = prior_transform
    if n_batch is None:
        n_batch = max(1, n_live // 8)
    if not 1 <= n_batch < n_live:
        raise ValueError(
            f"n_batch must be in [1, n_live); got {n_batch} vs {n_live}"
        )
    if n_obs < 1:
        raise ValueError(f"n_obs must be >= 1; got {n_obs}")
    key = jax.random.key(seed)
    k_init, k_run = jax.random.split(key)

    if mesh is not None:
        from jax.sharding import NamedSharding, PartitionSpec

        n_dev = int(mesh.devices.size)
        if n_live % n_dev or n_batch % n_dev:
            raise ValueError(
                f"n_live ({n_live}) and n_batch ({n_batch}) must divide "
                f"evenly across the {n_dev}-device mesh"
            )
        _rows = NamedSharding(
            mesh, PartitionSpec(None, mesh.axis_names, None)
        )

        def pin_rows(a):
            return jax.lax.with_sharding_constraint(a, _rows)

        mesh_key = (",".join(map(str, mesh.axis_names)),
                    int(mesh.devices.size), id(mesh))
    else:

        def pin_rows(a):
            return a

        mesh_key = None

    cfg = _NestedProgram(
        n_obs=int(n_obs),
        n_live=int(n_live),
        n_batch=int(n_batch),
        n_mh=int(n_mh),
        target_accept=float(target_accept),
        iters_per_chunk=int(iters_per_chunk),
    )
    init, run_chunk = _chain_program(
        loglik_multi,
        _auto_key(cfg, lo_raw, hi_raw, prior_transform, mesh_key),
        lambda: _build_nested_programs(
            loglik_multi, to_theta, lo, hi, pin_rows, cfg
        ),
    )

    x, ll = init(params, k_init)
    log_scale = jnp.zeros((n_obs,), jnp.float32)
    # exact batched shrinkage: death m of a batch shrinks log X by
    # 1/(n_live - m); deaths within a batch are ordered ascending in L
    per_death = 1.0 / (n_live - np.arange(n_batch, dtype=np.float64))
    batch_shrink = per_death.sum()
    cum_in_batch = np.cumsum(per_death)

    dead_ll_chunks: list[np.ndarray] = []  # each (iters, O, B)
    dead_x_chunks: list[np.ndarray] = []
    acc_chunks: list[np.ndarray] = []
    n_done = 0
    done = np.zeros(n_obs, bool)
    chunk_keys = jax.random.split(k_run, -(-max_iters // iters_per_chunk))
    for ck in chunk_keys:
        keys = jax.random.split(ck, iters_per_chunk)
        x, ll, log_scale, dll, dx, accs = run_chunk(
            params, x, ll, log_scale, keys
        )
        dead_ll_chunks.append(_to_host(dll).astype(np.float64))
        dead_x_chunks.append(_to_host(dx))
        acc_chunks.append(_to_host(accs))
        n_done += iters_per_chunk
        # per-observation stop test: can the live set still move the
        # total? The chunk loop continues until EVERY row passes.
        dead_flat = np.concatenate(dead_ll_chunks)  # (iters, O, B)
        logx_now = -n_done * batch_shrink
        ll_host = _to_host(ll).astype(np.float64)  # (O, L)
        remainder = (
            logx_now
            + np.logaddexp.reduce(ll_host, axis=1)
            - np.log(n_live)
        )
        for o in np.flatnonzero(~done):
            logz_dead_o = _logz_dead(
                dead_flat[:, o, :].reshape(-1), batch_shrink,
                cum_in_batch,
            )
            if remainder[o] < logz_dead_o + np.log(stop_frac):
                done[o] = True
        if done.all():
            break

    dead_ll = np.concatenate(dead_ll_chunks)  # (n_iters_tot/B, O, B)
    dead_x = np.concatenate(dead_x_chunks)
    accs = np.concatenate(acc_chunks)  # (chunks*iters, O)
    n_iters = dead_ll.shape[0] * n_batch
    n_chunks_done = n_done // iters_per_chunk
    n_like_per_obs = (
        n_live + n_chunks_done * iters_per_chunk * n_batch * n_mh
    )

    # shared exact log-volume ladder (identical n_live/n_batch per row)
    j = np.arange(n_iters) // n_batch
    i = np.arange(n_iters) % n_batch
    logx = -(j * batch_shrink + cum_in_batch[i])
    logx_prev = np.concatenate([[0.0], logx[:-1]])
    log_dx = logx_prev + _log1mexp(logx - logx_prev)
    logx_final = logx[-1] if n_iters else 0.0
    log_dx_live = np.full(n_live, logx_final - np.log(n_live))

    ll_live = _to_host(ll).astype(np.float64)  # (O, L)
    x_live = _to_host(x)
    theta_fn = None
    if prior_transform is not None:
        theta_fn = jax.jit(to_theta)

    results = []
    for o in range(n_obs):
        dll_o = dead_ll[:, o, :].reshape(-1)
        dx_o = dead_x[:, o, :, :].reshape(-1, n_params)
        all_ll = np.concatenate([dll_o, ll_live[o]])
        all_x = np.concatenate([dx_o, x_live[o]])
        if theta_fn is not None:
            # internal coordinates were unit-cube u; report RAW θ
            all_x = np.asarray(theta_fn(jnp.asarray(all_x, jnp.float32)))
        all_logx = np.concatenate([logx, np.full(n_live, logx_final)])
        log_w = np.concatenate(
            [dll_o + log_dx, ll_live[o] + log_dx_live]
        )
        logz = np.logaddexp.reduce(log_w)
        log_p = log_w - logz
        p = np.exp(log_p)
        finite = np.isfinite(all_ll)
        h = float((p[finite] * (all_ll[finite] - logz)).sum())
        ess = float(1.0 / (p**2).sum())
        results.append(NestedResult(
            logz=float(logz),
            logz_err=float(np.sqrt(max(h, 0.0) / n_live)),
            h=h,
            samples=all_x,
            logl=all_ll,
            log_w=log_p,
            logx=all_logx,
            ess=ess,
            n_iters=n_iters,
            n_like=n_like_per_obs,
            accept_rate=float(accs[:, o].mean()),
            truncated=bool(not done[o]),
        ))
    return results


def nested_sampling(
    loglik,
    params,
    *,
    n_live: int = 1024,
    n_batch: int | None = None,
    n_mh: int = 24,
    bounds=None,
    target_accept: float = 0.3,
    stop_frac: float = 1e-3,
    max_iters: int = 4096,
    iters_per_chunk: int = 32,
    seed: int = 0,
    prior_transform=None,
    mesh=None,
) -> NestedResult:
    """Evidence by batched nested sampling over the flat box prior.

    ``loglik(params, x)`` maps ``(B, n_params)`` rows to ``(B,)`` log-
    likelihoods (e.g. :meth:`DirectEmulator.loglik_fn`'s output).
    Each iteration replaces the ``n_batch`` (default ``n_live // 8``)
    worst live points: survivor-seeded Metropolis chains take ``n_mh``
    steps with proposals scaled by the survivors' per-dimension spread
    times a globally adapted factor (driven toward ``target_accept``
    inside the scan), accepting only in-box moves with
    ``logL > L*``. Runs ``iters_per_chunk`` iterations per device
    program and stops once the live-set remainder
    ``max(logL_live) + log X`` can contribute less than ``stop_frac``
    of the evidence accumulated so far.

    Cost: ``n_iters × n_mh`` batched likelihood calls of ``n_batch``
    rows, where ``n_iters ≈ n_live · H / n_batch`` — about 10⁶ rows
    for the defaults on a 50-nat-compression posterior.

    ``prior_transform``: optional unit-cube map (the MultiNest/dynesty
    convention — e.g.
    :meth:`tpu21cmvae.priors.GaussianBoxPrior.prior_transform`): a
    traceable ``(B, P) u ∈ [0,1]^P → θ`` such that uniform ``u`` is
    prior-distributed ``θ``. The sampler then explores in ``u``-space
    where ANY prior is uniform — the plain ``logL > L*`` rule and the
    exact volume bookkeeping carry over unchanged, which is why nested
    sampling wants the transform view rather than a density. ``bounds``
    then only fixes the dimensionality (the transform encodes the
    geometry); returned ``samples`` are in RAW θ units either way, and
    ``logz`` is the evidence under the transform's (normalized) prior.

    ``mesh``: optional :class:`jax.sharding.Mesh` — the live set and
    the per-iteration MH chains shard over its devices (``n_live`` and
    ``n_batch`` must divide evenly), so every constrained-likelihood
    batch runs on local rows.

    Since round 5 this is the ``n_obs = 1`` view of
    :func:`nested_sampling_batch` — one shared, cached, auto-keyed
    device program serves both (a single-observation ``loglik`` IS a
    stacked likelihood with ``O = 1``).
    """
    return nested_sampling_batch(
        loglik, params, 1,
        n_live=n_live, n_batch=n_batch, n_mh=n_mh, bounds=bounds,
        target_accept=target_accept, stop_frac=stop_frac,
        max_iters=max_iters, iters_per_chunk=iters_per_chunk,
        seed=seed, prior_transform=prior_transform, mesh=mesh,
    )[0]


def _logz_dead(
    dead_ll: np.ndarray, batch_shrink: float, cum_in_batch: np.ndarray
) -> float:
    n_batch = len(cum_in_batch)
    n = len(dead_ll)
    j = np.arange(n) // n_batch
    i = np.arange(n) % n_batch
    logx = -(j * batch_shrink + cum_in_batch[i])
    logx_prev = np.concatenate([[0.0], logx[:-1]])
    log_dx = logx_prev + _log1mexp(logx - logx_prev)
    return float(np.logaddexp.reduce(dead_ll + log_dx))
