"""Simulation-based calibration of the on-device inference stack.

SBC (Talts et al. 2018, arXiv:1804.06788) is the end-to-end correctness
test for a Bayesian pipeline: draw parameters from the prior, simulate
observations through the forward model, sample each posterior, and rank
the true parameter among the posterior draws. If — and only if — the
sampler targets the correct posterior, the ranks are uniform for EVERY
statistic; a biased likelihood tier, a broken prior term, or an
unconverged sampler all show up as rank-histogram slopes/humps. The
reference has nothing like this (its users' sampler correctness rests
on emcee + hand-glued likelihoods; reference ``README.rst:9-11``).

The usual obstacle is cost — hundreds of full posterior runs. Here the
whole study is TWO device programs: one batched predict for the
simulated observations, one stacked-observation chain
(:meth:`DirectEmulator.sample_posterior_batch` /
:func:`tpu21cmvae.ops.loglik.make_loglik_multi`) that advances all
``n_sims`` posteriors' walkers in every fused likelihood batch — the
mega-batch shape that fills the device. Ranks use each simulation's FINAL kept
step across walkers: the MH/HMC ensembles evolve walkers independently
(no cross-walker moves), so after warmup those are approximately
independent posterior draws, which is exactly what SBC's uniformity
statement assumes.
"""

from __future__ import annotations

import dataclasses

import numpy as np

__all__ = ["BatchGOFResult", "GOFResult", "SBCResult",
           "goodness_of_fit", "goodness_of_fit_batch", "sbc"]


@dataclasses.dataclass
class SBCResult:
    """Rank statistics from one SBC study.

    ``ranks``: ``(n_sims, n_params)`` integer rank of the true
    parameter among ``n_posterior`` posterior draws — uniform on
    ``{0, …, n_posterior}`` iff the pipeline is calibrated.
    ``pvalues``: per-parameter KS test of the (tie-broken, normalized)
    ranks against U(0,1); with a calibrated pipeline these are
    themselves uniform, so a single small value among 7 parameters is
    expected noise — act on systematic smallness. ``thetas`` /
    ``n_posterior`` record the study inputs."""

    ranks: np.ndarray
    n_posterior: int
    pvalues: np.ndarray
    thetas: np.ndarray

    @property
    def normalized(self) -> np.ndarray:
        """Ranks mapped to (0, 1) with deterministic mid-tie placement
        (rank + 0.5) / (n + 1) — the KS-test input."""
        return (self.ranks + 0.5) / (self.n_posterior + 1.0)

    def summary(self, labels=None) -> str:
        labels = labels or [f"p{i}" for i in range(self.ranks.shape[1])]
        lines = [
            f"  {lab:>8}: KS p = {p:.3f}"
            for lab, p in zip(labels, self.pvalues)
        ]
        verdict = (
            "calibrated (no parameter rejects uniformity at 0.01)"
            if (self.pvalues > 0.01).all()
            else "NOT calibrated — investigate the flagged parameters"
        )
        return (
            f"SBC over {self.ranks.shape[0]} simulations, "
            f"{self.n_posterior} posterior draws each: {verdict}\n"
            + "\n".join(lines)
        )


def _ks_uniform_pvalue(u: np.ndarray) -> float:
    """One-sample KS test p-value against U(0,1) (asymptotic Kolmogorov
    distribution — standard SBC sample counts are far past its n≳35
    validity range)."""
    u = np.sort(np.asarray(u, np.float64))
    n = len(u)
    grid = np.arange(1, n + 1) / n
    d = float(np.max(np.maximum(grid - u, u - (grid - 1.0 / n))))
    t = (np.sqrt(n) + 0.12 + 0.11 / np.sqrt(n)) * d
    j = np.arange(1, 101)
    p = 2.0 * np.sum((-1.0) ** (j - 1) * np.exp(-2.0 * (j * t) ** 2))
    return float(min(max(p, 0.0), 1.0))


def sbc(
    model,
    *,
    n_sims: int = 128,
    n_walkers: int = 64,
    n_steps: int = 300,
    n_warmup: int = 300,
    thin: int = 10,
    noise_var=25.0,
    bounds=None,
    sampler: str = "mh",
    seed: int = 0,
    prior=None,
    **kwargs,
) -> SBCResult:
    """Run an SBC study against ``model``'s own forward model.

    ``model``: anything exposing ``predict`` and
    ``sample_posterior_batch`` (the direct family). Truth draws are
    uniform over ``bounds`` (the flat box prior the samplers target;
    defaults to the 21cmGEM-shaped ranges), observations are
    ``predict(θ) + N(0, noise_var)`` — the same noise the likelihood
    assumes, closing the self-consistency loop SBC tests.

    ``noise_var`` also accepts the marginalized specs
    (:class:`~tpu21cmvae.foregrounds.MarginalizedNoise`,
    :class:`~tpu21cmvae.noisescale.ScaleMarginalNoise` — the latter
    needs a PROPER InvGamma prior, the improper Jeffreys one cannot be
    sampled): observations are then drawn from the spec's OWN
    generative model (``spec.sample_noise`` — per-simulation foreground
    coefficients and/or noise-level draws from the prior being
    marginalized), so the study certifies the analytic marginalization
    end to end: a wrong ``n_eff``, prior convention, or folded
    constant shows up as non-uniform ranks. ``n_walkers``
    is per simulation; ranks use the final kept step's walkers (see
    module docstring), so ``n_walkers`` sets the rank resolution.
    ``kwargs`` forward to :meth:`sample_posterior_batch` (e.g.
    ``mesh=`` to shard the ``n_sims · n_walkers`` stacked walker axis).

    ``prior``: optional :class:`tpu21cmvae.priors.GaussianBoxPrior` —
    truths are then drawn FROM that prior (via its exact unit-cube
    transform) and the chains target ``L·π`` (its ``log_prior`` is
    passed to the sampler), so the study certifies the informative-
    prior machinery end to end: a prior used for drawing but not
    sampling (or vice versa) shows up as sloped rank histograms.
    """
    import jax
    import jax.numpy as jnp

    from tpu21cmvae.sampling import _resolve_bounds

    if bounds is None and prior is not None and hasattr(prior, "lo"):
        # the chains must walk the box the truths are drawn in
        bounds = np.stack(
            [np.asarray(prior.lo), np.asarray(prior.hi)], axis=1
        )
    lo, hi = _resolve_bounds(bounds)
    lo = np.asarray(lo, np.float64)
    hi = np.asarray(hi, np.float64)
    if bounds is None:
        bounds = np.stack([lo, hi], axis=1)
    rng = np.random.default_rng(seed)
    u = rng.uniform(size=(n_sims, lo.shape[0]))
    if prior is not None and hasattr(prior, "lo"):
        # truths are drawn through prior.prior_transform inside ITS box;
        # the chains walk the resolved box — a silent mismatch piles
        # ranks at the edges and reads as a garbage "NOT calibrated"
        if not (np.allclose(np.asarray(prior.lo), lo)
                and np.allclose(np.asarray(prior.hi), hi)):
            raise ValueError(
                "prior box != sampler box: pass bounds= matching the "
                "prior's (prior.lo/prior.hi) so truths and chains "
                "share one support"
            )
    if prior is not None:
        thetas = np.asarray(
            jax.jit(prior.prior_transform)(jnp.asarray(u, jnp.float32)),
            np.float32,
        )
        kwargs.setdefault("log_prior", prior.log_prior)
    else:
        thetas = (lo + (hi - lo) * u).astype(np.float32)
    clean = np.atleast_2d(np.asarray(model.predict(thetas)))
    if callable(getattr(noise_var, "sample_noise", None)):
        obs = clean + noise_var.sample_noise(rng, clean.shape[0])
    else:
        obs = clean + rng.normal(0.0, np.sqrt(noise_var), clean.shape)

    res = model.sample_posterior_batch(
        obs, noise_var, sampler=sampler, n_walkers=n_walkers,
        bounds=bounds, n_steps=n_steps, n_warmup=n_warmup, thin=thin,
        seed=seed + 1, **kwargs,
    )
    # check the INNER result's chain: BatchSampleResult.chain is a
    # reshaping view that cannot infer its axis on a size-0 chain
    if res.result.chain.shape[0] == 0:
        raise ValueError("sbc needs a stored chain; run with thin > 0")
    draws = res.chain[-1]  # (n_sims, n_walkers, n_params) — final step
    ranks = (draws < thetas[:, None, :]).sum(axis=1)
    u = (ranks + 0.5) / (n_walkers + 1.0)
    pvalues = np.array([_ks_uniform_pvalue(u[:, j])
                        for j in range(u.shape[1])])
    return SBCResult(
        ranks=ranks, n_posterior=n_walkers, pvalues=pvalues, thetas=thetas
    )

@dataclasses.dataclass
class GOFResult:
    """Posterior predictive goodness-of-fit for one observed spectrum.

    ``p_value``: posterior predictive p of the whitened residual
    quadratic form ``T(d, θ) = (d − m(θ))ᵀ P (d − m(θ))`` (Gelman,
    Meng & Stern 1996). Because ``T(d_rep, θ) | θ ~ χ²_dof`` EXACTLY
    under the Gaussian noise model, no replicate data are simulated:
    ``p = E_θ[SF_χ²(T(d_obs, θ))]`` over the posterior draws — one
    batched predict. ``p → 0``: the model cannot reach the data
    (unmodeled structure — e.g. a foreground outside the marginalized
    basis — or underestimated noise). ``p → 1``: residuals
    implausibly SMALL (overestimated noise / double-fitted data).
    Posterior predictive p-values are conservative (Meng 1994): under
    a correct model they concentrate near 0.5 rather than being
    uniform, so act on extremes, not mild values.

    ``q``: the per-draw quadratic form ``(B,)``; ``dof`` its χ²
    degrees of freedom (``n_bins``, minus the number of flat-prior
    foreground terms under a
    :class:`~tpu21cmvae.foregrounds.MarginalizedNoise`). ``bin_z``:
    per-bin posterior predictive z-scores
    ``mean residual / √(noise + predictive variance)`` — localizes a
    misfit in frequency (foreground-cleaned first via the GLS fit when
    the spec marginalizes one out)."""

    p_value: float
    dof: float
    q: np.ndarray
    bin_z: np.ndarray

    def summary(self) -> str:
        verdict = (
            "no evidence of misfit"
            if 0.01 < self.p_value < 0.99
            else ("MISFIT: the model cannot reach the data "
                  "(unmodeled structure or underestimated noise)"
                  if self.p_value <= 0.01 else
                  "residuals implausibly small (overestimated noise)")
        )
        return (
            f"posterior predictive p = {self.p_value:.3f} "
            f"(q/dof = {float(np.mean(self.q)) / self.dof:.3f} over "
            f"{self.q.shape[0]} draws, dof = {self.dof:.0f}; "
            f"max |bin z| = {float(np.abs(self.bin_z).max()):.2f}): "
            f"{verdict}"
        )


def goodness_of_fit(
    model,
    obs,
    noise_var=25.0,
    draws=None,
    *,
    max_draws: int = 512,
    seed: int = 0,
) -> GOFResult:
    """Posterior predictive check of ``model`` against one observed
    spectrum — the model-checking step of the Bayesian workflow
    (sample → :func:`sbc` certifies the SAMPLER; this certifies the
    MODEL: did the assumed signal+noise family actually generate the
    data?). The reference leaves this entirely to its users.

    ``draws``: posterior draws in RAW parameter units — a
    :class:`~tpu21cmvae.sampling.SampleResult` (its stored chain, or
    final walkers when ``thin=0``) or a ``(B, n_params)`` array,
    subsampled to ``max_draws`` rows (the χ² tail average converges
    fast; 512 draws give ~±0.01 on ``p``). ``noise_var`` accepts
    everything the likelihoods do EXCEPT a
    :class:`~tpu21cmvae.noisescale.ScaleMarginalNoise` — the
    marginalized level rescales itself to absorb any overall misfit,
    so this omnibus statistic has no power there; check the level with
    ``spec.sigma2_posterior(residual)`` and the shape with a
    foreground-basis split instead.

    One batched ``model.predict`` + one tiny device reduction; exact
    χ² tail via ``gammaincc`` (no replicate simulation needed).

    An UNCONVERGED chain inflates ``q`` and reads as misfit (draws far
    from the posterior leave signal in the residual — measured on a
    trained emulator: 400 MH warmup steps gave q/dof ≈ 8.8 where the
    converged HMC chain gave 1.01). Check ``result.rhat()`` first, or
    use a gradient sampler; an elevated ``q/dof`` with only moderate
    ``bin_z`` suggests unconverged draws (their spread inflates the
    ``bin_z`` denominator), where a real misfit stands out in ``bin_z``
    (measured 5.6 vs 74 on the same corruption)."""
    from tpu21cmvae.noisescale import ScaleMarginalNoise

    if isinstance(noise_var, ScaleMarginalNoise):
        raise ValueError(
            "goodness_of_fit is powerless under a marginalized noise "
            "LEVEL (sigma^2 rescales to absorb any overall misfit): "
            "check the level with spec.sigma2_posterior(residual) and "
            "pass the base spec here for the shape test"
        )
    if draws is None:
        raise ValueError(
            "pass posterior draws (a SampleResult or a (B, n_params) "
            "array), e.g. model.sample_posterior(obs, noise_var)"
        )
    if hasattr(draws, "per_obs"):  # BatchSampleResult (.flat is a METHOD)
        raise ValueError(
            "got a BatchSampleResult: score the whole survey with "
            "goodness_of_fit_batch(model, obs_batch, noise_var, draws) "
            "or one observation with draws.per_obs(i)"
        )
    if hasattr(draws, "chain"):
        draws = draws.flat if draws.chain.shape[0] else draws.final
    draws = np.atleast_2d(np.asarray(draws, np.float32))
    obs = np.asarray(obs, np.float64).reshape(-1)
    sf, q, dof, bin_z = _gof_core(
        model, obs[None, :], noise_var, draws[None], max_draws, seed
    )
    return GOFResult(
        p_value=float(sf[0].mean()), dof=dof, q=q[0], bin_z=bin_z[0]
    )


def _gof_core(model, obs_batch, noise_var, draws, max_draws, seed):
    """Shared scoring core of :func:`goodness_of_fit` (O=1 slice) and
    :func:`goodness_of_fit_batch`: ``obs_batch (O, n)`` float64 +
    ``draws (O, B, P)`` → per-draw exact-χ² tails ``sf (O, B)``,
    quadratic forms ``q (O, B)``, ``dof``, per-bin ``bin_z (O, n)``."""
    from tpu21cmvae.foregrounds import MarginalizedNoise

    n_obs, n = obs_batch.shape
    if draws.shape[1] > max_draws:
        rng = np.random.default_rng(seed)
        draws = draws[
            np.arange(n_obs)[:, None],
            rng.choice(draws.shape[1], max_draws, replace=False)[None, :],
        ]
    b = draws.shape[1]
    m = np.asarray(
        model.predict(draws.reshape(n_obs * b, -1)), np.float64
    ).reshape(n_obs, b, n)
    r = obs_batch[:, None, :] - m

    if isinstance(noise_var, MarginalizedNoise):
        z = r @ noise_var.whiten.astype(np.float64)
        q = np.einsum("obi,obi->ob", z, z)
        dof = float(
            n - noise_var.n_terms
            if noise_var.prior_var is None
            else n
        )
        # foreground-cleaned per-bin diagnostic: subtract the GLS fit
        # to the mean residual, then z against the base noise
        coeff, _ = noise_var.coeff_posterior(r.mean(axis=1))
        cleaned = r - noise_var.reconstruct(coeff)[:, None, :]
        bin_z = cleaned.mean(axis=1) / np.sqrt(
            noise_var.noise_var + cleaned.var(axis=1)
        )
    else:
        nv = np.broadcast_to(np.asarray(noise_var, np.float64), (n,))
        q = np.einsum("obi,obi->ob", r / nv, r)
        dof = float(n)
        bin_z = r.mean(axis=1) / np.sqrt(nv + r.var(axis=1))

    # SF_chi2(q; dof) = Q(dof/2, q/2), exact upper regularized gamma
    import jax.numpy as jnp
    from jax.scipy.special import gammaincc

    sf = np.asarray(gammaincc(
        jnp.float32(dof / 2.0), jnp.asarray(q / 2.0, jnp.float32)
    ))
    return sf, q, dof, bin_z

@dataclasses.dataclass
class BatchGOFResult:
    """Per-observation posterior predictive checks for a survey
    (:func:`goodness_of_fit_batch`): ``p_values`` ``(O,)``, shared
    ``dof``, per-observation mean quadratic form ``q_mean`` ``(O,)``
    and per-bin z-scores ``bin_z`` ``(O, n_bins)``. Same reading as
    :class:`GOFResult`; ``flagged`` lists the observations whose p
    leaves (0.01, 0.99)."""

    p_values: np.ndarray
    dof: float
    q_mean: np.ndarray
    bin_z: np.ndarray

    @property
    def flagged(self) -> np.ndarray:
        return np.where(
            (self.p_values <= 0.01) | (self.p_values >= 0.99)
        )[0]

    def summary(self) -> str:
        o = self.p_values.shape[0]
        bad = self.flagged
        head = (
            f"posterior predictive check over {o} observations "
            f"(dof = {self.dof:.0f}): "
        )
        if bad.size == 0:
            return head + "no observation shows evidence of misfit"
        lines = [
            f"  obs {i}: p = {self.p_values[i]:.4f} "
            f"(q/dof = {self.q_mean[i] / self.dof:.2f}, "
            f"max |bin z| = {float(np.abs(self.bin_z[i]).max()):.1f})"
            for i in bad
        ]
        return (head + f"{bad.size} flagged\n" + "\n".join(lines))


def goodness_of_fit_batch(
    model,
    obs_batch,
    noise_var=25.0,
    draws=None,
    *,
    max_draws: int = 256,
    seed: int = 0,
) -> BatchGOFResult:
    """:func:`goodness_of_fit` for a SURVEY: ``O`` observations checked
    in ONE batched predict over all observations' posterior draws
    (the same stacked economics as ``sample_posterior_batch`` — the
    whole survey's model checking costs about one chain step).

    ``draws``: a :class:`~tpu21cmvae.sampling.BatchSampleResult` from
    ``sample_posterior_batch(obs_batch, …)``, or a ``(O, B, n_params)``
    array of per-observation posterior draws; each observation's draws
    are subsampled to ``max_draws``. ``noise_var`` follows
    :func:`goodness_of_fit` (shared across observations, like the
    stacked likelihood)."""
    from tpu21cmvae.noisescale import ScaleMarginalNoise

    if isinstance(noise_var, ScaleMarginalNoise):
        raise ValueError(
            "goodness_of_fit is powerless under a marginalized noise "
            "LEVEL (sigma^2 rescales to absorb any overall misfit): "
            "check levels with spec.sigma2_posterior per observation "
            "and pass the base spec here for the shape test"
        )
    obs_batch = np.atleast_2d(np.asarray(obs_batch, np.float64))
    n_obs, n = obs_batch.shape
    if draws is None:
        raise ValueError(
            "pass per-observation posterior draws (a BatchSampleResult "
            "or a (O, B, n_params) array), e.g. "
            "model.sample_posterior_batch(obs_batch, noise_var)"
        )
    if hasattr(draws, "per_obs"):  # BatchSampleResult
        if draws.n_obs != n_obs:
            raise ValueError(
                f"draws carry {draws.n_obs} observations, obs_batch "
                f"has {n_obs}"
            )
        r = draws.result
        if r.chain.shape[0]:
            k, _, p = r.chain.shape
            stacked = r.chain.reshape(k, n_obs, -1, p)
            draws = np.moveaxis(stacked, 1, 0).reshape(n_obs, -1, p)
        else:
            draws = r.final.reshape(n_obs, -1, r.final.shape[-1])
    draws = np.asarray(draws, np.float32)
    if draws.ndim != 3 or draws.shape[0] != n_obs:
        raise ValueError(
            f"draws must be (O, B, n_params) with O = {n_obs}; got "
            f"{draws.shape}"
        )
    sf, q, dof, bin_z = _gof_core(
        model, obs_batch, noise_var, draws, max_draws, seed
    )
    return BatchGOFResult(
        p_values=sf.mean(axis=1), dof=dof, q_mean=q.mean(axis=1),
        bin_z=bin_z,
    )
