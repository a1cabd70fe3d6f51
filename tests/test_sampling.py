"""On-device posterior samplers (tpu21cmvae/sampling/).

The target is an easy synthetic inverse problem: observe a trained tiny
emulator's own signal + noise, sample, and check the machinery — chain
shapes, box containment, adaptation behavior, and that the posterior
concentrates relative to the prior. Runs on the virtual CPU mesh with
small walker counts.
"""

import numpy as np
import pytest

from tpu21cmvae.models.direct import DirectEmulator
from tpu21cmvae.utils.config import DirectEmulatorConfig, TrainConfig


@pytest.fixture(scope="module")
def setup(splits):
    model = DirectEmulator(
        splits, config=DirectEmulatorConfig(hidden_dims=(32, 24))
    )
    model.train(
        train_config=TrainConfig(
            epochs=25, early_stop_patience=None, plateau_patience=None
        ),
        device_loop=True,
    )
    rng = np.random.default_rng(7)
    truth = np.asarray(splits.par_test[1], np.float32)
    obs = model.predict(truth) + rng.normal(0, 3.0, splits.n_bins)
    return model, truth, obs


def _bounds(splits):
    par = np.asarray(splits.par_train, np.float64)
    lo, hi = par.min(0), par.max(0)
    pad = 0.05 * (hi - lo) + 1e-6
    lo, hi = lo - pad, hi + pad
    # the first three parameters are log-transformed by par_transform —
    # the prior box must stay positive there (fx == 0 alone is clamped)
    lo[:3] = np.maximum(lo[:3], 1e-6)
    return np.stack([lo, hi], axis=1).astype(np.float32)


def test_mh_sampler_machinery(setup, splits):
    from tpu21cmvae.sampling import sample_mh

    model, truth, obs = setup
    bounds = _bounds(splits)
    res = sample_mh(
        model.loglik_fn(obs, 9.0), model.params,
        n_walkers=256, n_steps=60, n_warmup=40, thin=10,
        bounds=bounds, seed=1,
    )
    assert res.final.shape == (256, 7)
    assert res.chain.shape == (6, 256, 7)
    assert res.flat.shape == (6 * 256, 7)
    # all samples stay inside the box
    assert (res.flat >= bounds[:, 0] - 1e-5).all()
    assert (res.flat <= bounds[:, 1] + 1e-5).all()
    # acceptance is neither stuck nor saturated
    assert 0.05 < float(res.accept_rate.mean()) < 0.999
    assert np.isfinite(res.logp).all()
    assert "accept rate" in res.summary(model.par_labels)


def test_mh_posterior_concentrates(setup, splits):
    """Post-warmup walkers concentrate: mean log-likelihood far above
    the prior-draw average (the chain actually moved toward the data)."""
    from tpu21cmvae.sampling import sample_mh

    model, truth, obs = setup
    bounds = _bounds(splits)
    loglik = model.loglik_fn(obs, 9.0)
    res = sample_mh(
        loglik, model.params, n_walkers=256, n_steps=150, n_warmup=150,
        thin=0, bounds=bounds, seed=2,
    )
    rng = np.random.default_rng(0)
    prior = bounds[:, 0] + (bounds[:, 1] - bounds[:, 0]) * rng.random(
        (256, 7)
    ).astype(np.float32)
    prior_lp = np.asarray(loglik(model.params, prior))
    assert res.logp.mean() > prior_lp.mean() + 100.0


def test_hmc_sampler_adapts_and_moves(setup, splits):
    from tpu21cmvae.sampling import sample_hmc

    model, truth, obs = setup
    bounds = _bounds(splits)
    valgrad = model.loglik_and_grad_fn(obs, 9.0)
    res = sample_hmc(
        valgrad, model.params, n_walkers=128, n_steps=40, n_warmup=60,
        n_leapfrog=5, thin=5, bounds=bounds, seed=3,
    )
    assert res.final.shape == (128, 7)
    assert res.chain.shape == (8, 128, 7)
    assert (res.flat >= bounds[:, 0] - 1e-4).all()
    assert (res.flat <= bounds[:, 1] + 1e-4).all()
    # dual averaging produced a usable step and a healthy acceptance
    assert res.step_size > 0
    assert 0.2 < float(res.accept_rate.mean()) <= 1.0
    assert np.isfinite(res.logp).all()


def test_model_sample_posterior_entry(setup, splits):
    model, truth, obs = setup
    res = model.sample_posterior(
        obs, 9.0, sampler="mh", bounds=_bounds(splits),
        n_walkers=64, n_steps=30, n_warmup=20, thin=0, seed=4,
    )
    assert res.final.shape == (64, 7)
    res_hmc = model.sample_posterior(
        obs, 9.0, sampler="hmc", bounds=_bounds(splits),
        n_walkers=32, n_steps=10, n_warmup=15, n_leapfrog=3, thin=0, seed=5,
    )
    assert res_hmc.final.shape == (32, 7)
    with pytest.raises(ValueError, match="sampler"):
        model.sample_posterior(obs, sampler="slice")


def test_sampler_resume_from_state(setup, splits):
    """Passing x0 continues a chain — long runs can be segmented."""
    from tpu21cmvae.sampling import sample_mh

    model, truth, obs = setup
    bounds = _bounds(splits)
    loglik = model.loglik_fn(obs, 9.0)
    a = sample_mh(loglik, model.params, n_walkers=64, n_steps=20,
                  n_warmup=10, thin=0, bounds=bounds, seed=6)
    b = sample_mh(loglik, model.params, n_walkers=64, n_steps=20,
                  n_warmup=0, thin=0, bounds=bounds, seed=7, x0=a.final)
    assert b.final.shape == a.final.shape
    assert not np.allclose(a.final, b.final)  # the chain kept moving


def test_mh_adaptation_converges_to_target(setup, splits):
    """Dual-averaging scale adaptation lands near the target acceptance
    (measured: the unadapted default sat at 0.09 on an earlier drive;
    on this problem a 150-step warmup lands within ~0.02 of 0.3)."""
    from tpu21cmvae.sampling import sample_mh

    model, truth, obs = setup
    bounds = _bounds(splits)
    loglik = model.loglik_fn(obs, 9.0)
    fixed = sample_mh(loglik, model.params, n_walkers=128, n_steps=40,
                      n_warmup=150, thin=0, bounds=bounds, seed=8,
                      adapt=False)
    adapted = sample_mh(loglik, model.params, n_walkers=128, n_steps=40,
                        n_warmup=150, thin=0, bounds=bounds, seed=8)
    assert abs(float(adapted.accept_rate.mean()) - 0.3) < 0.1
    assert adapted.step_size != fixed.step_size


def _fake_result(chain):
    from tpu21cmvae.sampling import SampleResult

    chain = np.asarray(chain, np.float32)
    return SampleResult(
        chain=chain, final=chain[-1], logp=np.zeros(chain.shape[1]),
        accept_rate=np.ones(1), step_size=1.0,
    )


def test_rhat_ess_contracts():
    """Diagnostic math on known chains: IID chains read ≈1 R̂ and ≈full
    ESS; random-walk chains are flagged (R̂ ≫ 1, ESS ≪ total)."""
    rng = np.random.default_rng(0)
    iid = rng.standard_normal((200, 32, 3))
    r = _fake_result(iid).rhat()
    e = _fake_result(iid).ess()
    assert r.shape == (3,) and (np.abs(r - 1.0) < 0.05).all()
    assert (e > 0.5 * 200 * 32).all()

    walk = np.cumsum(rng.standard_normal((200, 32, 3)), axis=0)
    rw = _fake_result(walk).rhat()
    ew = _fake_result(walk).ess()
    assert (rw > 1.5).all()  # non-stationary chains are flagged
    assert (ew < 0.2 * 200 * 32).all()

    # tail ESS of IID chains is of the same order as the draw count
    et = _fake_result(iid).ess_tail()
    assert et.shape == (3,) and (et > 0.5 * 200 * 32).all()


def test_tail_pathology_refused_where_plain_diagnostics_read_clean():
    """The round-3 VERDICT weak-#3 scenario, exactly: chains that agree
    in mean and variance-weighted bulk but differ in their TAILS. Half
    the walkers draw N(0,1); half draw the same normal truncated to
    |x| < 1 — between-chain means agree, so plain split-R̂ (which only
    compares chain means against pooled variance) reads 1.000, and the
    bulk ESS reads ≈ full. The rank-normalized folded R̂ (Vehtari et
    al. 2021 §4.2) and the tail ESS (§4.3) must refuse: the truncated
    walkers NEVER visit the pooled 5 %/95 % tails, so any credible
    interval from this "converged-looking" chain would be wrong."""
    rng = np.random.default_rng(0)
    n, m = 500, 32
    full = rng.standard_normal((n, m // 2, 1))
    pool = rng.standard_normal((n * 6, m // 2)).T
    trunc = np.stack(
        [row[np.abs(row) < 1.0][:n] for row in pool], axis=1
    )[:, :, None]
    res = _fake_result(np.concatenate([full, trunc], axis=1))

    # the pre-round-4 diagnostics read CLEAN on this chain set
    assert abs(float(res.rhat(rank_normalized=False)[0]) - 1.0) < 0.01
    assert float(res.ess(rank_normalized=False)[0]) > 0.9 * n * m
    # bulk is genuinely fine — rank-normalized bulk ESS agrees ...
    assert float(res.ess()[0]) > 0.9 * n * m
    # ... but the folded rank-R̂ flags the tail disagreement and the
    # tail ESS collapses (measured: R̂ 1.045, tail ESS ≈ 410 of 16k)
    assert float(res.rhat()[0]) > 1.02
    assert float(res.ess_tail()[0]) < 0.05 * n * m


def test_ess_tail_nan_when_tail_never_toggles():
    """Too few draws to say anything about a tail → NaN, not a number
    pretending to be evidence (and sample_to_ess treats NaN as
    not-converged)."""
    rng = np.random.default_rng(1)
    # 4 kept steps x 8 walkers: the 5% pooled quantile indicator flips
    # on so few draws that some chains stay constant; with constant
    # chains the combined estimator's W is still > 0 here, so instead
    # build an explicitly constant chain to pin the NaN contract
    const = np.zeros((8, 4, 1))
    res = _fake_result(const.transpose(1, 0, 2))
    assert np.isnan(res.ess_tail()).all()
    # and a healthy chain never returns NaN
    ok = _fake_result(rng.standard_normal((100, 8, 2)))
    assert np.isfinite(ok.ess_tail()).all()


def test_diagnostics_on_real_run(setup, splits):
    """A short overdispersed-start run is honestly flagged as unmixed."""
    from tpu21cmvae.sampling import sample_mh

    model, truth, obs = setup
    bounds = _bounds(splits)
    res = sample_mh(model.loglik_fn(obs, 9.0), model.params,
                    n_walkers=64, n_steps=120, n_warmup=80, thin=2,
                    bounds=bounds, seed=9)
    r = res.rhat()
    e = res.ess()
    assert r.shape == (7,) and e.shape == (7,)
    assert np.isfinite(r).all() and (r > 1.05).all()  # not mixed yet
    assert (e >= 1).all() and (e <= res.chain.shape[0] * 64 + 1e-9).all()
    # no-chain run raises clearly
    res0 = sample_mh(model.loglik_fn(obs, 9.0), model.params,
                     n_walkers=32, n_steps=5, n_warmup=0, thin=0,
                     bounds=bounds, seed=10)
    with pytest.raises(ValueError, match="thin"):
        res0.rhat()


def test_two_stage_families_sample_posterior(splits):
    """AE and VAE emulators expose the same sampling surface (autodiff
    value+grad through the em→decoder pipeline)."""
    from tpu21cmvae.models.autoencoder import AutoEncoderEmulator
    from tpu21cmvae.models.vae import VAEEmulator
    from tpu21cmvae.utils.config import AutoEncoderConfig, VAEConfig

    bounds = _bounds(splits)
    cfg = dict(latent_dim=3, enc_hidden_dims=(16,), dec_hidden_dims=(16,),
               em_hidden_dims=(16,))
    for cls, config in (
        (AutoEncoderEmulator, AutoEncoderConfig(**cfg)),
        (VAEEmulator, VAEConfig(**cfg)),
    ):
        emu = cls(splits, config=config)
        obs = emu.predict(splits.par_test[0])
        res = emu.sample_posterior(
            obs, 25.0, sampler="hmc", bounds=bounds,
            n_walkers=16, n_steps=5, n_warmup=8, n_leapfrog=3, thin=0,
        )
        assert res.final.shape == (16, 7)
        res_mh = emu.sample_posterior(
            obs, 25.0, sampler="mh", bounds=bounds,
            n_walkers=16, n_steps=5, n_warmup=5, thin=0,
        )
        assert np.isfinite(res_mh.logp).all()


def test_emcee_log_prob_adapter(setup, splits):
    """The emcee adapter: numpy contract, -inf outside the box, device
    likelihood inside, single-row float return."""
    from tpu21cmvae.sampling import make_emcee_log_prob

    model, truth, obs = setup
    bounds = _bounds(splits)
    loglik = model.loglik_fn(obs, 9.0)
    log_prob = make_emcee_log_prob(loglik, model.params, bounds=bounds)

    coords = np.asarray(splits.par_test[:8], np.float64)
    lp = log_prob(coords)
    want = np.asarray(loglik(model.params, coords.astype(np.float32)))
    np.testing.assert_allclose(lp, want, rtol=1e-6)

    out = coords.copy()
    out[0, 1] = bounds[1, 1] + 1.0  # push one row outside the box
    lp2 = log_prob(out)
    assert lp2[0] == -np.inf and np.isfinite(lp2[1:]).all()

    one = log_prob(coords[2])
    assert isinstance(one, float) and np.isclose(one, lp[2])


def test_emcee_integration():
    """Real emcee over the adapter, when emcee is installed."""
    emcee = pytest.importorskip("emcee")
    import jax.numpy as jnp

    from tpu21cmvae.sampling import make_emcee_log_prob

    # trivial quadratic 'likelihood' keeps this independent of fixtures
    def loglik(params, x):
        return -0.5 * jnp.sum((x - params) ** 2, axis=-1)

    center = jnp.zeros(3)
    bounds = np.array([[-5.0, 5.0]] * 3)
    log_prob = make_emcee_log_prob(loglik, center, bounds=bounds)
    rng = np.random.default_rng(0)
    sampler = emcee.EnsembleSampler(16, 3, log_prob, vectorize=True)
    sampler.run_mcmc(rng.normal(0, 0.5, (16, 3)), 200, progress=False)
    flat = sampler.get_chain(discard=100, flat=True)
    assert abs(flat.mean()) < 0.5 and 0.5 < flat.std() < 2.0


def test_ensemble_sampler_machinery(setup, splits):
    from tpu21cmvae.sampling import sample_ensemble

    model, truth, obs = setup
    bounds = _bounds(splits)
    res = sample_ensemble(
        model.loglik_fn(obs, 9.0), model.params,
        n_walkers=256, n_steps=60, n_warmup=40, thin=10,
        bounds=bounds, seed=1,
    )
    assert res.final.shape == (256, 7)
    assert res.chain.shape == (6, 256, 7)
    assert (res.flat >= bounds[:, 0] - 1e-5).all()
    assert (res.flat <= bounds[:, 1] + 1e-5).all()
    # stretch-move acceptance on a smooth 7-d target is healthy
    assert 0.05 < float(res.accept_rate.mean()) < 0.999
    assert np.isfinite(res.logp).all()
    assert res.step_size == 2.0  # reports the stretch scale


def test_ensemble_posterior_concentrates(setup, splits):
    """Post-warmup walkers shrink toward the truth relative to the
    prior span, like the MH version of this test."""
    from tpu21cmvae.sampling import sample_ensemble

    model, truth, obs = setup
    bounds = _bounds(splits)
    res = sample_ensemble(
        model.loglik_fn(obs, 9.0), model.params,
        n_walkers=512, n_steps=150, n_warmup=150, thin=10,
        bounds=bounds, seed=2,
    )
    span = bounds[:, 1] - bounds[:, 0]
    spread = res.flat.std(0)
    # concentrated well below the flat-prior std (span/sqrt(12))
    assert (spread < 0.8 * span / np.sqrt(12.0)).mean() >= 0.5


def test_ensemble_exact_on_analytic_gaussian():
    """Statistical correctness: on an analytic Gaussian target the
    stretch move must reproduce the known mean and covariance scale
    (this checks the z^(d-1) acceptance factor — an implementation
    with the wrong exponent biases the variance by tens of percent)."""
    import jax.numpy as jnp

    from tpu21cmvae.sampling import sample_ensemble

    mu = np.array([0.5, -1.0, 2.0], np.float32)
    sig = np.array([0.3, 0.7, 0.2], np.float32)

    def loglik(params, x):
        return -0.5 * jnp.sum(((x - mu) / sig) ** 2, axis=-1)

    bounds = np.stack([mu - 8 * sig, mu + 8 * sig], axis=1)
    res = sample_ensemble(
        loglik, None, n_walkers=128, n_steps=600, n_warmup=300,
        thin=5, bounds=bounds, seed=3,
    )
    flat = res.flat
    # mean within a few MC standard errors; std within 10 %
    assert np.allclose(flat.mean(0), mu, atol=4 * sig / np.sqrt(200))
    assert np.allclose(flat.std(0), sig, rtol=0.10)


def test_ensemble_input_validation():
    from tpu21cmvae.sampling import sample_ensemble

    bounds = np.array([[0.0, 1.0]] * 3)
    dummy = lambda p, x: x.sum(-1)  # noqa: E731
    with pytest.raises(ValueError, match="even"):
        sample_ensemble(dummy, None, n_walkers=17, bounds=bounds)
    with pytest.raises(ValueError, match="2\\*n_params"):
        sample_ensemble(dummy, None, n_walkers=6, bounds=bounds)
    with pytest.raises(ValueError, match="stretch scale"):
        sample_ensemble(dummy, None, n_walkers=16, a=1.0, bounds=bounds)


def test_ensemble_resume_and_model_entry(setup, splits):
    from tpu21cmvae.sampling import sample_ensemble

    model, truth, obs = setup
    bounds = _bounds(splits)
    loglik = model.loglik_fn(obs, 9.0)
    a = sample_ensemble(loglik, model.params, n_walkers=64, n_steps=20,
                        n_warmup=10, thin=0, bounds=bounds, seed=6)
    b = sample_ensemble(loglik, model.params, n_walkers=64, n_steps=20,
                        n_warmup=0, thin=0, bounds=bounds, seed=7,
                        x0=a.final)
    assert b.final.shape == a.final.shape
    assert not np.allclose(a.final, b.final)  # the chain kept moving
    res = model.sample_posterior(
        obs, 9.0, sampler="ensemble", bounds=bounds,
        n_walkers=64, n_steps=20, n_warmup=10, thin=0, seed=8,
    )
    assert res.final.shape == (64, 7)


def test_fit_map_analytic_gaussian():
    """fit_map must land on the analytic optimum from random starts."""
    import jax.numpy as jnp

    from tpu21cmvae.sampling import fit_map

    mu = np.array([0.5, -1.0, 2.0], np.float32)
    sig = np.array([0.3, 0.7, 0.2], np.float32)

    def valgrad(params, x):
        ll = -0.5 * jnp.sum(((x - mu) / sig) ** 2, axis=-1)
        return ll, -(x - mu) / sig**2

    bounds = np.stack([mu - 5 * sig, mu + 5 * sig], axis=1)
    res = fit_map(valgrad, None, n_starts=64, n_steps=400, bounds=bounds,
                  seed=0)
    assert res.params.shape == (64, 3)
    assert np.allclose(res.best, mu, atol=0.02 * sig)
    assert res.best_logp > -1e-3
    top_p, top_l = res.top(5)
    assert top_p.shape == (5, 3)
    assert (np.diff(top_l) <= 1e-6).all()  # sorted best-first
    # the smooth unimodal target pulls essentially every start home
    assert (top_l > -0.01).all()


def test_fit_params_recovers_truth_and_seeds_sampler(setup, splits):
    model, truth, obs = setup
    bounds = _bounds(splits)
    # 512 starts x 500 steps is the measured reliability recipe on this
    # rugged landscape (see sampling::log_evidence warm-start notes);
    # weaker fits pass or fail seed-to-seed
    res = model.fit_params(
        obs, 9.0, bounds=bounds, n_starts=512, n_steps=500, seed=1,
    )
    assert res.params.shape == (512, 7)
    # the ML point must beat (or match) the generating truth's logL
    ll_truth = float(np.asarray(
        model.loglik_fn(obs, 9.0)(model.params, truth[None])
    )[0])
    assert res.best_logp >= ll_truth - 1.0
    # ... and reproduce the observation at the noise floor
    resid = np.asarray(model.predict(res.best)) - obs
    assert np.sqrt((resid**2).mean()) < 2.0 * 3.0
    # fits warm-start a sampler run
    warm = model.sample_posterior(
        obs, 9.0, sampler="ensemble", bounds=bounds,
        n_walkers=128, n_steps=10, n_warmup=0, thin=0, seed=2,
        x0=res.top(128)[0],
    )
    assert warm.final.shape == (128, 7)


def test_log_evidence_matches_analytic_gaussian():
    """Stepping-stone logZ must match the closed form for a truncated
    Gaussian likelihood under the flat box prior — this checks the
    ladder, the per-rung MH targets, the replica exchange, and the
    pooled estimator jointly (a wrong β exponent or a biased prior rung
    moves logZ by O(1))."""
    import math

    import jax.numpy as jnp

    from tpu21cmvae.sampling import log_evidence

    mu = np.array([0.5, -1.0, 2.0], np.float32)
    sig = np.array([0.3, 0.7, 0.2], np.float32)
    lo, hi = mu - 4 * sig, mu + 4 * sig
    bounds = np.stack([lo, hi], axis=1)

    def loglik(params, x):
        return -0.5 * jnp.sum(((x - mu) / sig) ** 2, axis=-1)

    logz_true = -float(np.log(hi - lo).sum())
    for d in range(3):
        a = (lo[d] - mu[d]) / (math.sqrt(2) * sig[d])
        b = (hi[d] - mu[d]) / (math.sqrt(2) * sig[d])
        logz_true += math.log(sig[d] * math.sqrt(2 * math.pi)) + math.log(
            0.5 * (math.erf(b) - math.erf(a))
        )

    res = log_evidence(loglik, None, n_rungs=24, n_walkers=256,
                       n_steps=300, n_warmup=150, bounds=bounds, seed=0)
    assert abs(res.logz - logz_true) < 0.15
    assert res.rung_logz.shape == (23,)
    assert np.isclose(res.rung_logz.sum(), res.logz)
    # the stretch move is self-scaling: healthy acceptance on every
    # rung with no adaptation (the β=0 independence rung accepts ~1)
    assert (res.accept_rate > 0.15).all()
    assert res.accept_rate[0] > 0.95
    # the β=1 rung is a posterior sample set
    assert np.allclose(res.posterior.mean(0), mu, atol=4 * sig / np.sqrt(50))
    assert "log Z" in res.summary()


def test_log_evidence_model_comparison(setup, splits):
    """The generating model must win the evidence comparison against a
    broken variant of itself (its signal scaled 20%) on the same data —
    the end-use contract of log_evidence."""
    import jax

    model, truth, obs = setup
    bounds = _bounds(splits)
    kwargs = dict(n_rungs=12, n_walkers=128, n_steps=120, n_warmup=100,
                  bounds=bounds, seed=0)
    good = model.log_evidence(obs, 9.0, method="ladder", **kwargs)
    base = model.loglik_fn(obs, 9.0)

    def broken_loglik(params, raw):  # a forward model that can't fit
        return base(params, raw) * 0.0 + jax.numpy.float32(-1e4)

    from tpu21cmvae.sampling import log_evidence

    bad = log_evidence(broken_loglik, model.params, **kwargs)
    assert np.isclose(bad.logz, -1e4, atol=1.0)  # flat logL: Z = e^{-1e4}
    assert good.logz > bad.logz + 100.0
    with pytest.raises(ValueError, match="n_rungs"):
        log_evidence(base, model.params, n_rungs=1, bounds=bounds)


def test_hmc_exact_on_analytic_anisotropic_gaussian():
    """Statistical correctness of the upgraded HMC: on an analytic
    Gaussian with a 40× scale split between dimensions, the ensemble-
    statistics preconditioner + jittered trajectories must recover the
    known moments on BOTH axes (an identity-metric HMC at a step sized
    for the narrow axis needs ~40× the trajectory to traverse the wide
    one — the wide axis's std comes out tens of percent low)."""
    import jax.numpy as jnp

    from tpu21cmvae.sampling import sample_hmc

    mu = np.array([1.0, -0.5, 2.0], np.float32)
    sig = np.array([2.0, 0.05, 0.4], np.float32)

    def valgrad(params, x):
        z = (x - mu) / sig
        return -0.5 * jnp.sum(z**2, axis=-1), -z / sig

    bounds = np.stack([mu - 8 * sig, mu + 8 * sig], axis=1)
    res = sample_hmc(
        valgrad, None, n_walkers=256, n_steps=300, n_warmup=150,
        n_leapfrog=8, thin=5, bounds=bounds, seed=2,
    )
    flat = res.flat
    assert np.allclose(flat.mean(0), mu, atol=4 * sig / np.sqrt(300))
    assert np.allclose(flat.std(0), sig, rtol=0.12)
    assert 0.5 < float(res.accept_rate[-20:].mean()) <= 1.0


def test_hmc_plain_path_still_exact(setup, splits):
    """jitter=False, precondition=False reproduces the original fixed-
    trajectory identity-metric sampler (continuation contract)."""
    from tpu21cmvae.sampling import sample_hmc

    model, truth, obs = setup
    bounds = _bounds(splits)
    valgrad = model.loglik_and_grad_fn(obs, 9.0)
    res = sample_hmc(
        valgrad, model.params, n_walkers=64, n_steps=20, n_warmup=30,
        n_leapfrog=4, thin=0, bounds=bounds, seed=9,
        jitter=False, precondition=False,
    )
    assert res.final.shape == (64, 7)
    assert np.isfinite(res.logp).all() and res.step_size > 0


def test_posterior_predictive_bands():
    """Band statistics match analytic Gaussian propagation through a
    linear 'emulator'; streaming in chunks is exact; noise widens."""
    from tpu21cmvae.sampling import posterior_predictive

    rng = np.random.default_rng(0)
    w = rng.normal(size=(3, 11))
    mu = np.array([1.0, -2.0, 0.5])
    sig = np.array([0.3, 0.1, 0.2])
    samples = mu + sig * rng.normal(size=(50_000, 3))

    def predict(x):
        return np.asarray(x) @ w

    band = posterior_predictive(predict, samples)
    np.testing.assert_allclose(band.mean, mu @ w, atol=0.02)
    np.testing.assert_allclose(
        band.std, np.sqrt(((sig[:, None] * w) ** 2).sum(0)), rtol=0.03
    )
    # default levels: (0.16, 0.5, 0.84) rows ascend; median ~ mean
    assert (np.diff(band.bands, axis=0) > 0).all()
    np.testing.assert_allclose(band.bands[1], band.mean, atol=0.03)
    # the 68% band half-width of a Gaussian is ~1 std
    np.testing.assert_allclose(
        (band.bands[2] - band.bands[0]) / 2.0, band.std, rtol=0.05
    )
    # chunked streaming is exactly the single-batch result
    band2 = posterior_predictive(predict, samples, max_batch=1777)
    np.testing.assert_allclose(band2.bands, band.bands)
    # observation noise widens every bin
    bandn = posterior_predictive(predict, samples, noise_var=4.0, seed=1)
    assert (bandn.std > band.std).all()
    # a 1-D single sample row is accepted
    one = posterior_predictive(predict, mu)
    assert one.mean.shape == (11,)


def test_pt_recovers_mode_weights_where_mh_cannot():
    """An 80/20 bimodal target with well-separated modes: every plain-MH
    walker stays in its initialization basin (mass split frozen at the
    ~50/50 of uniform init), while parallel tempering's replica exchange
    transports states across the barrier and recovers the true split.
    Exactness + diagnostics of the PT cold chain are also checked."""
    from tpu21cmvae.sampling import sample_mh, sample_pt

    # two sharp 1-D Gaussians at +/-3, sigma 0.1, weights 0.8/0.2 —
    # a ~400-sigma barrier no local proposal crosses
    mu_a, mu_b, sig, w_a = -3.0, 3.0, 0.1, 0.8
    bounds = np.array([[-6.0, 6.0]])

    import jax.numpy as jnp

    def loglik(params, x):
        x = jnp.asarray(x)[..., 0]
        la = jnp.log(w_a) - 0.5 * ((x - mu_a) / sig) ** 2
        lb = jnp.log(1 - w_a) - 0.5 * ((x - mu_b) / sig) ** 2
        return jnp.logaddexp(la, lb)

    common = dict(n_walkers=512, n_steps=600, n_warmup=400, thin=10,
                  bounds=bounds, seed=0)
    mh = sample_mh(loglik, None, **common)
    frac_mh = float((mh.flat[:, 0] < 0).mean())
    # frozen at the init split: far from 0.8
    assert abs(frac_mh - 0.5) < 0.1, frac_mh

    pt = sample_pt(loglik, None, n_rungs=16, **common)
    frac_pt = float((pt.flat[:, 0] < 0).mean())
    assert abs(frac_pt - w_a) < 0.05, frac_pt
    # within-mode geometry is exact too
    in_a = pt.flat[pt.flat[:, 0] < 0, 0]
    assert abs(in_a.mean() - mu_a) < 0.02
    assert abs(in_a.std() - sig) < 0.02
    # diagnostics present: ladder + per-edge swap rates that actually
    # exchanged states
    assert pt.betas.shape == (16,) and pt.betas[-1] == 1.0
    assert pt.swap_rate.shape == (15,)
    assert pt.swap_rate.min() > 0.05


def test_model_level_pt(splits):
    """sampler="pt" dispatches through sample_posterior on a real
    emulator likelihood."""
    em = DirectEmulator(splits, config=DirectEmulatorConfig(hidden_dims=(16,)))
    obs = em.predict(splits.par_test[0])
    par = np.asarray(splits.par_train, np.float64)
    lo, hi = par.min(0), par.max(0)
    lo[:3] = np.maximum(lo[:3], 1e-6)
    bounds = np.stack([lo, hi], axis=1)
    res = em.sample_posterior(
        obs, 25.0, sampler="pt", bounds=bounds, n_rungs=8, n_walkers=32,
        n_steps=40, n_warmup=40, thin=10, seed=0,
    )
    assert res.chain.shape[1:] == (32, 7)
    assert np.isfinite(res.logp).all()
    assert res.swap_rate.shape == (7,)


def test_chain_program_cache_no_retrace():
    """Repeated sample_mh / sample_hmc calls with the same statics
    reuse ONE traced program (the per-closure chain cache) — different
    seeds and different WEIGHTS included; changing a static (bounds,
    step_frac, prior) builds a fresh program."""
    import jax.numpy as jnp

    from tpu21cmvae.sampling import sample_hmc, sample_mh

    bounds = np.array([[-4.0, 4.0]] * 2)
    traces = []

    def loglik(params, x):
        traces.append(1)
        z = jnp.asarray(x) + (0.0 if params is None else params)
        return -0.5 * jnp.sum(z * z, axis=-1)

    common = dict(n_walkers=64, n_steps=20, n_warmup=10, thin=5,
                  bounds=bounds)
    w0, w1 = jnp.float32(0.0), jnp.float32(1.5)
    r1 = sample_mh(loglik, w0, seed=0, **common)
    n1 = len(traces)
    r2 = sample_mh(loglik, w0, seed=1, **common)
    assert len(traces) == n1  # same program, new randomness
    assert not np.array_equal(r1.final, r2.final)
    r3 = sample_mh(loglik, w1, seed=0, **common)
    assert len(traces) == n1  # weights are an argument, not a constant
    assert not np.array_equal(r1.final, r3.final)  # ...and they matter
    # same seed + same statics → bit-identical chain
    r1b = sample_mh(loglik, w0, seed=0, **common)
    np.testing.assert_array_equal(r1.final, r1b.final)
    # a changed static keys a new program
    sample_mh(loglik, w0, seed=0, step_frac=0.02, **common)
    assert len(traces) == 2 * n1

    def valgrad(params, x):
        traces.append(1)
        x = jnp.asarray(x)
        return -0.5 * jnp.sum(x * x, axis=-1), -x

    traces.clear()
    h = dict(n_walkers=64, n_steps=10, n_warmup=20, n_leapfrog=4, thin=5,
             bounds=bounds)
    sample_hmc(valgrad, None, seed=0, **h)
    n1 = len(traces)
    sample_hmc(valgrad, None, seed=3, **h)
    assert len(traces) == n1


def test_sample_to_ess_reaches_target():
    import jax.numpy as jnp

    from tpu21cmvae.sampling import sample_to_ess

    bounds = np.array([[-5.0, 5.0]] * 2)

    def loglik(params, x):
        z = jnp.asarray(x)
        return -0.5 * jnp.sum(z * z, axis=-1)

    res = sample_to_ess(
        loglik, None, target_ess=3000, chunk_steps=100, n_walkers=128,
        n_warmup=150, thin=10, bounds=bounds, seed=0, max_chunks=30,
    )
    assert res.ess().min() >= 3000
    # statistically exact along the way
    assert np.allclose(res.flat.mean(0), 0.0, atol=0.1)
    assert np.allclose(res.flat.std(0), 1.0, rtol=0.1)
    # chunked continuation reused programs: the cache holds exactly the
    # warmup program + the continuation program
    assert len(loglik._t21_chain_cache) == 2
    with pytest.raises(ValueError, match="thin"):
        sample_to_ess(loglik, None, thin=0, bounds=bounds)


def test_model_level_target_ess(splits):
    """sampler="mh" + target_ess dispatches to sample_to_ess from
    sample_posterior (with n_steps accepted as the chunk size) on every
    family that exposes the dispatch."""
    em = DirectEmulator(splits, config=DirectEmulatorConfig(hidden_dims=(16,)))
    obs = em.predict(splits.par_test[0])
    par = np.asarray(splits.par_train, np.float64)
    lo, hi = par.min(0), par.max(0)
    lo[:3] = np.maximum(lo[:3], 1e-6)
    bounds = np.stack([lo, hi], axis=1)
    res = em.sample_posterior(
        obs, 25.0, sampler="mh", bounds=bounds, target_ess=50.0,
        n_walkers=64, n_steps=40, n_warmup=60, thin=10, seed=0,
        max_chunks=12,
    )
    # the run either reached the target under the honest combined
    # bulk+tail gate, or honestly exhausted its chunk budget trying
    # (the round-4 estimator includes between-chain variance, so stuck
    # walkers can no longer fake convergence on this rugged tiny-model
    # posterior — it reads ~40 ESS here no matter how long it runs)
    tail = res.ess_tail()
    tail_min = np.nanmin(tail) if np.isfinite(tail).any() else 0.0
    converged = min(res.ess().min(), tail_min) >= 50.0
    exhausted = res.chain.shape[0] == 12 * (40 // 10)
    assert converged or exhausted
    assert res.chain.shape[1:] == (64, 7)


def test_autocorr_time_matches_ess():
    """autocorr_time is the emcee-convention view of ess: τ·ESS =
    kept·walkers, and an iid chain reports τ ≈ 1."""
    import jax.numpy as jnp

    from tpu21cmvae.sampling import sample_mh

    bounds = np.array([[-4.0, 4.0]] * 2)

    def loglik(params, x):
        return -0.5 * jnp.sum(jnp.asarray(x) ** 2, axis=-1)

    res = sample_mh(loglik, None, n_walkers=128, n_steps=400, n_warmup=200,
                    thin=20, bounds=bounds, seed=0)
    tau = res.autocorr_time()
    n, w, _ = res.chain.shape
    np.testing.assert_allclose(tau * res.ess(), n * w, rtol=1e-12)
    assert (tau < 3.0).all()  # thin=20 leaves nearly-iid samples


def test_review_regressions_pt_cache_and_ladder_and_to_ess():
    """Three review-verified regressions stay fixed: (1) chain-program
    cache keys include n_walkers (a second sample_pt on the same
    closure with a different walker count must NOT hit the first
    program's baked shapes); (2) n_rungs=2 ladder is [0, 1], not
    [0, beta_min]; (3) sample_to_ess accepts user step_frac/x0 without
    colliding with its own continuation arguments."""
    import jax.numpy as jnp

    from tpu21cmvae.sampling import (
        _geometric_ladder,
        log_evidence,
        sample_pt,
        sample_to_ess,
    )

    bounds = np.array([[-3.0, 3.0]] * 2)

    def loglik(params, x):
        return -0.5 * jnp.sum(jnp.asarray(x) ** 2, axis=-1)

    common = dict(n_steps=6, n_warmup=4, thin=3, bounds=bounds, seed=0)
    r1 = sample_pt(loglik, None, n_rungs=4, n_walkers=8, **common)
    r2 = sample_pt(loglik, None, n_rungs=4, n_walkers=16, **common)
    assert r1.final.shape == (8, 2) and r2.final.shape == (16, 2)
    e1 = log_evidence(loglik, None, n_rungs=4, n_walkers=8,
                      n_steps=6, n_warmup=4, bounds=bounds, seed=0)
    e2 = log_evidence(loglik, None, n_rungs=4, n_walkers=16,
                      n_steps=6, n_warmup=4, bounds=bounds, seed=0)
    assert np.isfinite([e1.logz, e2.logz]).all()

    np.testing.assert_array_equal(_geometric_ladder(2, 1e-6), [0.0, 1.0])
    # n_rungs=2 evidence integrates [prior, posterior] — logz lands
    # near truth for a Gaussian in a box, not at ~0
    ev2 = log_evidence(loglik, None, n_rungs=2, n_walkers=256,
                       n_steps=300, n_warmup=100, bounds=bounds, seed=0)
    logz_true = float(
        np.log(2 * np.pi) - 2 * np.log(6.0)
    )  # erf(3/sqrt2)^2 ≈ 0.9946 → +2·log(0.99865) ≈ -0.0027, inside tol
    assert abs(ev2.logz - logz_true) < 0.1

    res = sample_to_ess(
        loglik, None, target_ess=200, chunk_steps=60, n_walkers=64,
        n_warmup=50, thin=10, bounds=bounds, seed=0, step_frac=0.08,
        x0=np.zeros((64, 2), np.float32), max_chunks=20,
    )
    assert res.ess().min() >= 200


def test_profile_likelihood_analytic_gaussian():
    """On an analytic Gaussian likelihood the profile curve is the
    marginal quadratic and the Wilks interval is mu ± z·sigma (0.68 →
    ±1σ, 0.95 → ±1.96σ) — this pins the constrained-ascent machinery,
    the pinned-coordinate mask, and the interval interpolation."""
    import jax.numpy as jnp

    from tpu21cmvae.sampling import profile_likelihood

    mu = np.array([0.5, -1.0], np.float32)
    sig = np.array([0.4, 0.7], np.float32)
    bounds = np.array([[-3.0, 3.0], [-4.0, 4.0]])

    def valgrad(params, x):
        z = (jnp.asarray(x) - mu) / sig
        return -0.5 * jnp.sum(z * z, axis=-1), -z / sig

    grid = np.linspace(-1.0, 2.0, 61)
    res = profile_likelihood(
        valgrad, None, 0, grid, n_starts=32, n_steps=200, bounds=bounds,
        seed=0,
    )
    assert res.logl.shape == (61,) and res.params.shape == (61, 2)
    # profile over the free param leaves the pure quadratic in dim 0
    want = -0.5 * ((grid - mu[0]) / sig[0]) ** 2
    np.testing.assert_allclose(res.logl, want, atol=5e-3)
    # the free coordinate sits at its conditional optimum everywhere
    np.testing.assert_allclose(res.params[:, 1], mu[1], atol=0.01)
    np.testing.assert_array_equal(res.params[:, 0], grid.astype(np.float32))
    lo68, hi68 = res.interval(0.68)
    assert abs(lo68 - (mu[0] - 0.994 * sig[0])) < 0.03
    assert abs(hi68 - (mu[0] + 0.994 * sig[0])) < 0.03
    lo95, hi95 = res.interval(0.95)
    assert abs(lo95 - (mu[0] - 1.96 * sig[0])) < 0.04
    assert abs(hi95 - (mu[0] + 1.96 * sig[0])) < 0.04
    # censoring: a grid that stops inside the interval reports its edge
    short = profile_likelihood(
        valgrad, None, 0, np.linspace(0.3, 0.7, 11), n_starts=16,
        n_steps=150, bounds=bounds, seed=0,
    )
    i95 = short.interval(0.95)
    assert i95[0] == pytest.approx(0.3) and i95[1] == pytest.approx(0.7)
    with pytest.raises(ValueError, match="grid"):
        profile_likelihood(valgrad, None, 0, [5.0, 6.0], bounds=bounds)
    with pytest.raises(ValueError, match="index"):
        profile_likelihood(valgrad, None, 9, grid, bounds=bounds)


def test_model_level_profile_likelihood(splits):
    em = DirectEmulator(splits, config=DirectEmulatorConfig(hidden_dims=(16,)))
    truth = np.asarray(splits.par_test[0], np.float32)
    obs = em.predict(truth)
    par = np.asarray(splits.par_train, np.float64)
    lo, hi = par.min(0), par.max(0)
    lo[:3] = np.maximum(lo[:3], 1e-6)
    bounds = np.stack([lo, hi], axis=1)
    grid = np.linspace(lo[3] + 0.1 * (hi[3] - lo[3]),
                       hi[3] - 0.1 * (hi[3] - lo[3]), 9)
    res = em.profile_likelihood(
        obs, 25.0, 3, grid, bounds=bounds, n_starts=24, n_steps=80, seed=0,
    )
    assert np.isfinite(res.logl).all()
    # the profile peaks in the grid cell containing (or nearest) truth
    peak = res.grid[res.logl.argmax()]
    assert abs(peak - truth[3]) < 0.25 * (hi[3] - lo[3])


def test_chees_exact_on_analytic_anisotropic_gaussian():
    """Statistical correctness of ChEES-HMC: exact moments on an
    anisotropic Gaussian, with the trajectory length ADAPTED far above
    its tiny initial value (8·init_step = 0.08) — the adaptation, not
    the initialization, must be doing the work."""
    import jax.numpy as jnp

    from tpu21cmvae.sampling import ChEESSampleResult, sample_chees

    mu = np.array([1.0, -0.5, 2.0], np.float32)
    sig = np.array([2.0, 0.05, 0.4], np.float32)

    def valgrad(params, x):
        z = (x - mu) / sig
        return -0.5 * jnp.sum(z**2, axis=-1), -z / sig

    bounds = np.stack([mu - 8 * sig, mu + 8 * sig], axis=1)
    res = sample_chees(
        valgrad, None, n_walkers=256, n_steps=300, n_warmup=200,
        thin=5, bounds=bounds, seed=2,
    )
    assert isinstance(res, ChEESSampleResult)
    flat = res.flat
    assert np.allclose(flat.mean(0), mu, atol=4 * sig / np.sqrt(300))
    assert np.allclose(flat.std(0), sig, rtol=0.12)
    assert 0.4 < float(res.accept_rate[-20:].mean()) <= 1.0
    assert res.trajectory_length > 10 * 0.08  # adapted >10× the init
    assert res.step_size > 0


def test_chees_beats_fixed_trajectory_on_correlated_gaussian():
    """The ChEES selling point: on a 0.99-correlated Gaussian a
    diagonal metric cannot decorrelate, only LONG trajectories mix the
    stiff direction — fixed-L8 HMC leaves the correlated dims with a
    >15 % std error and a fraction of the ESS, ChEES adapts the
    trajectory and nails both."""
    import jax.numpy as jnp

    from tpu21cmvae.sampling import sample_chees, sample_hmc

    C = np.array(
        [[1.0, 0.99, 0.0], [0.99, 1.0, 0.0], [0.0, 0.0, 0.04]],
        np.float32,
    )
    P = np.linalg.inv(C).astype(np.float32)

    def valgrad(params, x):
        g = -x @ P.T
        return 0.5 * jnp.sum(x * g, axis=-1), g

    sig = np.sqrt(np.diag(C))
    bounds = np.stack([-8 * sig, 8 * sig], axis=1)
    # metric="diag" pins the regime under test: under metric="dense"
    # the whitened target is isotropic and even fixed-L8 mixes
    # (see test_dense_metric_whitens_correlated_gaussian)
    kw = dict(n_walkers=256, n_steps=300, n_warmup=200, thin=5, seed=3,
              bounds=bounds, metric="diag")
    r_c = sample_chees(valgrad, None, **kw)
    r_h = sample_hmc(valgrad, None, n_leapfrog=8, **kw)
    assert np.allclose(r_c.flat.std(0), sig, rtol=0.08)
    assert abs(r_h.flat.std(0)[0] - sig[0]) > 0.15 * sig[0]
    assert r_c.ess().min() > 2.0 * r_h.ess().min()


def test_chees_model_entry_continuation_and_cache(setup, splits):
    """sampler="chees" on the model entry point; x0 continuation and
    thin=0 fast path; repeated calls reuse ONE cached chain program."""
    model, truth, obs = setup
    bounds = _bounds(splits)
    kw = dict(sampler="chees", bounds=bounds, n_walkers=64, n_steps=30,
              n_warmup=40, thin=0, seed=4)
    res = model.sample_posterior(obs, 9.0, **kw)
    assert res.final.shape == (64, 7)
    assert np.isfinite(res.logp).all()
    assert res.trajectory_length > 0
    # continuation from final state (fresh warmup by design) and cache
    valgrad = model.loglik_and_grad_fn(obs, 9.0, grad_precision="default")
    n_cached = len(valgrad._t21_chain_cache)
    res2 = model.sample_posterior(obs, 9.0, x0=res.final, **kw)
    assert res2.final.shape == (64, 7)
    assert len(valgrad._t21_chain_cache) == n_cached  # no new program
    # inside the box
    assert (res2.final >= bounds[:, 0] - 1e-5).all()
    assert (res2.final <= bounds[:, 1] + 1e-5).all()


def test_chees_posterior_concentrates_with_prior(setup, splits):
    """End-to-end on the emulator likelihood with a smooth external
    prior: the posterior concentrates relative to the prior box and
    the prior pulls the constrained parameter toward its mean."""
    from tpu21cmvae.priors import GaussianBoxPrior
    from tpu21cmvae.sampling import sample_chees

    model, truth, obs = setup
    bounds = _bounds(splits)
    valgrad = model.loglik_and_grad_fn(obs, 9.0, grad_precision="default")
    res = sample_chees(
        valgrad, model.params, n_walkers=128, n_steps=150, n_warmup=150,
        thin=5, bounds=bounds, seed=5,
    )
    flat = res.flat
    span = bounds[:, 1] - bounds[:, 0]
    # concentrated vs the flat prior (uniform std = span/sqrt(12))
    assert (flat.std(0) < 0.75 * span / np.sqrt(12.0)).all()
    prior = GaussianBoxPrior.for_params(
        {6: (float(truth[6]), float(0.02 * span[6]))},
        n_params=7, bounds=bounds,
    )
    res_p = sample_chees(
        valgrad, model.params, n_walkers=128, n_steps=150, n_warmup=150,
        thin=5, bounds=bounds, seed=5, log_prior=prior.log_prior,
    )
    assert res_p.flat.std(0)[6] < 0.8 * flat.std(0)[6] + 1e-9


def test_nuts_exact_on_analytic_anisotropic_gaussian():
    """Statistical correctness of batched iterative NUTS: exact moments
    on an anisotropic Gaussian, adapted step near the 0.8 accept
    target, zero divergences on a smooth target."""
    import jax.numpy as jnp

    from tpu21cmvae.sampling import NUTSSampleResult, sample_nuts

    mu = np.array([1.0, -0.5, 2.0], np.float32)
    sig = np.array([2.0, 0.05, 0.4], np.float32)

    def valgrad(params, x):
        z = (x - mu) / sig
        return -0.5 * jnp.sum(z**2, axis=-1), -z / sig

    bounds = np.stack([mu - 8 * sig, mu + 8 * sig], axis=1)
    res = sample_nuts(
        valgrad, None, n_walkers=256, n_steps=300, n_warmup=200,
        thin=5, bounds=bounds, seed=2,
    )
    assert isinstance(res, NUTSSampleResult)
    flat = res.flat
    assert np.allclose(flat.mean(0), mu, atol=4 * sig / np.sqrt(300))
    assert np.allclose(flat.std(0), sig, rtol=0.12)
    assert 0.6 < float(res.accept_rate[-20:].mean()) <= 1.0
    assert res.divergence_rate == 0.0
    assert 1.0 <= res.mean_leapfrog <= 2**6 - 1
    assert res.step_size > 0


def test_nuts_deep_trees_on_correlated_gaussian():
    """The NUTS selling point: on a 0.99-correlated Gaussian the
    U-turn criterion grows the trees (mean leapfrog well above the
    whitened-target ~3) until the stiff direction mixes — exact stds
    and high ESS with no trajectory-length knob at all."""
    import jax.numpy as jnp

    from tpu21cmvae.sampling import sample_nuts

    C = np.array(
        [[1.0, 0.99, 0.0], [0.99, 1.0, 0.0], [0.0, 0.0, 0.04]],
        np.float32,
    )
    P = np.linalg.inv(C).astype(np.float32)

    def valgrad(params, x):
        g = -x @ P.T
        return 0.5 * jnp.sum(x * g, axis=-1), g

    sig = np.sqrt(np.diag(C))
    bounds = np.stack([-8 * sig, 8 * sig], axis=1)
    res = sample_nuts(
        valgrad, None, n_walkers=256, n_steps=300, n_warmup=200,
        thin=5, seed=3, bounds=bounds, max_depth=8, metric="diag",
    )
    assert np.allclose(res.flat.std(0), sig, rtol=0.08)
    assert res.mean_leapfrog > 8.0  # trees actually deepened
    assert res.divergence_rate == 0.0
    assert res.ess().min() > 1000.0


def test_dense_metric_whitens_correlated_gaussian():
    """The dense ensemble metric (metric="auto"/"dense"): the leapfrog
    integrates in the cross-walker-covariance square-root space, so the
    0.99 correlation the diagonal metric cannot see disappears — NUTS
    trees collapse toward the isotropic ~3 leapfrogs (vs >8 deep under
    metric="diag"), and even fixed-L8 HMC (whose diag-metric stds are
    >15 % wrong on this target — see the ChEES test above) becomes
    exact. Same target, same budget, same seeds as those tests."""
    import jax.numpy as jnp

    from tpu21cmvae.sampling import sample_hmc, sample_nuts

    C = np.array(
        [[1.0, 0.99, 0.0], [0.99, 1.0, 0.0], [0.0, 0.0, 0.04]],
        np.float32,
    )
    P = np.linalg.inv(C).astype(np.float32)

    def valgrad(params, x):
        g = -x @ P.T
        return 0.5 * jnp.sum(x * g, axis=-1), g

    sig = np.sqrt(np.diag(C))
    bounds = np.stack([-8 * sig, 8 * sig], axis=1)
    kw = dict(n_walkers=256, n_steps=300, n_warmup=200, thin=5, seed=3,
              bounds=bounds)
    r_n = sample_nuts(valgrad, None, max_depth=8, metric="dense", **kw)
    assert np.allclose(r_n.flat.std(0), sig, rtol=0.08)
    assert r_n.mean_leapfrog < 6.0  # whitened trees terminate early
    assert r_n.ess().min() > 1000.0
    # round-4 policy: metric="auto" resolves DIAG for NUTS too (dense
    # measured a seed-dependent divergence rate and lower min-ESS/s on
    # the production posterior — _resolve_metric); on this correlated
    # target the auto/diag trees therefore stay deep where explicit
    # dense collapses them — dense is the documented opt-in
    r_a = sample_nuts(valgrad, None, max_depth=8, **kw)
    assert r_a.mean_leapfrog > 2.0 * r_n.mean_leapfrog
    r_h = sample_hmc(valgrad, None, n_leapfrog=8, metric="dense", **kw)
    assert np.allclose(r_h.flat.std(0), sig, rtol=0.10)
    assert np.allclose(r_h.flat.mean(0), 0.0, atol=0.15 * sig)
    with pytest.raises(ValueError, match="metric"):
        sample_hmc(valgrad, None, metric="full", **kw)


def test_nuts_metric_auto_policy_and_dense_phase_cache_key():
    """Round-3 VERDICT weak #5, resolved by MEASUREMENT (docs/PERF.md
    round-4 A/B): dense NUTS's divergences on the production posterior
    are walker-local sharp curvature, not an ε/metric mismatch — a
    third warmup window re-adapting ε under the refreshed metric made
    them WORSE (0.63 % vs 0.21 % mean over 6 seeds), while diag
    measures ~0 divergences AND higher min-ESS/s. Policy under test:
    (1) ``metric="auto"`` resolves diag for NUTS (a defaults-trusting
    user gets the divergence-free config); (2) explicit dense — with
    and without the ``_dense_readapt`` research knob — stays exact on
    a sharp correlated target, and the two phase structures compile as
    SEPARATE cached programs (the baked-boolean cache-key bug measured
    99 % divergences when one config replayed the other's program)."""
    import jax.numpy as jnp

    from tpu21cmvae.sampling import sample_nuts

    C = np.array(
        [[1.0, 0.95, 0.0], [0.95, 1.0, 0.0], [0.0, 0.0, 1e-4]],
        np.float32,
    )
    P = np.linalg.inv(C).astype(np.float32)

    def valgrad(params, x):
        g = -x @ P.T
        return 0.5 * jnp.sum(x * g, axis=-1), g

    sig = np.sqrt(np.diag(C))
    bounds = np.stack([-8 * sig, 8 * sig], axis=1)
    kw = dict(n_walkers=256, n_steps=300, n_warmup=200, thin=5,
              seed=3, bounds=bounds, max_depth=8)

    auto = sample_nuts(valgrad, None, metric="auto", **kw)
    dense = sample_nuts(valgrad, None, metric="dense", **kw)
    # (1) auto == diag: deep unwhitened trees; dense is the opt-in that
    # collapses them on this correlated target
    assert auto.mean_leapfrog > 2.0 * dense.mean_leapfrog
    assert np.allclose(dense.flat.std(0), sig, rtol=0.10)
    assert np.allclose(auto.flat.std(0), sig, rtol=0.10)

    # (2) the readapt phase structure is a DIFFERENT cached program —
    # same likelihood closure, same shapes except the third window; a
    # key collision replays a 1-step ε re-adapt and diverges massively
    re = sample_nuts(valgrad, None, metric="dense",
                     _dense_readapt=True, **kw)
    assert re.divergence_rate < 0.05
    assert np.allclose(re.flat.std(0), sig, rtol=0.10)
    # and running plain dense again still hits ITS OWN program
    dense2 = sample_nuts(valgrad, None, metric="dense", **kw)
    np.testing.assert_allclose(dense2.flat, dense.flat, atol=1e-6)


def test_nuts_divergences_are_detected():
    """A step size far too large for a narrow Gaussian makes the
    leapfrog unstable — NUTS must flag the divergences (ΔH > 1000)
    rather than accept garbage, and the reported samples stay finite
    (diverged subtrees are discarded)."""
    import jax.numpy as jnp

    from tpu21cmvae.sampling import sample_nuts

    sig = np.float32(1e-3)

    def valgrad(params, x):
        return -0.5 * jnp.sum((x / sig) ** 2, axis=-1), -x / sig**2

    bounds = np.array([[-1.0, 1.0], [-1.0, 1.0]], np.float32)
    res = sample_nuts(
        valgrad, None, n_walkers=64, n_steps=20, n_warmup=0,
        init_step=10.0, thin=0, bounds=bounds, seed=0,
    )
    assert res.divergence_rate > 0.5
    assert np.isfinite(res.final).all()
    assert np.isfinite(res.logp).all()


def test_nuts_model_entry_and_cache(setup, splits):
    """sampler="nuts" on the model entry point; diagnostics populated;
    repeated calls reuse ONE cached chain program; box containment."""
    model, truth, obs = setup
    bounds = _bounds(splits)
    kw = dict(sampler="nuts", bounds=bounds, n_walkers=64, n_steps=30,
              n_warmup=40, thin=0, seed=4, max_depth=5)
    res = model.sample_posterior(obs, 9.0, **kw)
    assert res.final.shape == (64, 7)
    assert np.isfinite(res.logp).all()
    assert res.mean_leapfrog >= 1.0
    valgrad = model.loglik_and_grad_fn(obs, 9.0, grad_precision="default")
    n_cached = len(valgrad._t21_chain_cache)
    res2 = model.sample_posterior(obs, 9.0, x0=res.final, **kw)
    assert res2.final.shape == (64, 7)
    assert len(valgrad._t21_chain_cache) == n_cached  # no new program
    assert (res2.final >= bounds[:, 0] - 1e-5).all()
    assert (res2.final <= bounds[:, 1] + 1e-5).all()


def test_device_thinning_matches_full_chain():
    """Thinning now happens INSIDE the chain program (a keep-buffer in
    the scan carry — ~1/thin the HBM and host transfer of emitting
    every step). Kept rows must be bit-identical to slicing an
    unthinned (thin=1) run of the same seed: ``chain[thin-1::thin]``,
    including a trailing remainder that is silently dropped."""
    import jax.numpy as jnp

    from tpu21cmvae.sampling import (
        sample_chees, sample_ensemble, sample_hmc, sample_mh,
        sample_nuts, sample_pt, valgrad_from_loglik,
    )

    mu = np.array([0.3, -0.5, 1.2], np.float32)

    def loglik(params, x):
        return -0.5 * jnp.sum(((x - mu) / 0.4) ** 2, axis=-1)

    bounds = np.stack([mu - 2.0, mu + 2.0], axis=1)
    kw = dict(bounds=bounds, n_steps=11, n_warmup=16, seed=3)
    for name, run in (
        ("mh", lambda thin: sample_mh(
            loglik, None, n_walkers=32, thin=thin, **kw)),
        ("ensemble", lambda thin: sample_ensemble(
            loglik, None, n_walkers=32, thin=thin, **kw)),
        ("hmc", lambda thin: sample_hmc(
            valgrad_from_loglik(loglik), None, n_walkers=32,
            n_leapfrog=3, thin=thin, **kw)),
        ("pt", lambda thin: sample_pt(
            loglik, None, n_walkers=32, n_rungs=4, thin=thin, **kw)),
        # chees counts kept steps from a GLOBAL (warmup-offset) index
        ("chees", lambda thin: sample_chees(
            valgrad_from_loglik(loglik), None, n_walkers=32,
            thin=thin, **kw)),
        ("nuts", lambda thin: sample_nuts(
            valgrad_from_loglik(loglik), None, n_walkers=32,
            max_depth=3, thin=thin, **kw)),
    ):
        full = run(1)
        thinned = run(3)
        assert full.chain.shape[0] == 11, name
        assert thinned.chain.shape[0] == 3, name  # 11 // 3
        np.testing.assert_array_equal(
            thinned.chain, full.chain[2::3], err_msg=name
        )
        np.testing.assert_array_equal(
            thinned.final, full.final, err_msg=name
        )
        # thin=0 keeps nothing but still runs the same chain
        none = run(0)
        assert none.chain.shape[0] == 0, name
        np.testing.assert_array_equal(none.final, full.final,
                                      err_msg=name)


def test_mh_adapt_blocks_heterogeneous_widths():
    """Per-block proposal scales (the batched-observation path's
    ``adapt_blocks=n_obs``): on a target whose two walker blocks are
    Gaussians with a 50× width split, per-block adaptation recovers
    BOTH blocks' moments, and the adapted block scales split by an
    order of magnitude (a pooled scale is one number — it cannot serve
    both, which shows up as SBC rank drift on heterogeneous surveys)."""
    import jax.numpy as jnp

    from tpu21cmvae.sampling import sample_mh

    sig_blk = np.array([1.0, 0.02], np.float32)
    mu = np.zeros(3, np.float32)

    def loglik(params, x):
        s = jnp.repeat(jnp.asarray(sig_blk), x.shape[0] // 2)[:, None]
        return -0.5 * jnp.sum(((x - mu) / s) ** 2, axis=-1)

    bounds = np.stack([mu - 8.0, mu + 8.0], axis=1)
    res = sample_mh(loglik, None, n_walkers=256, adapt_blocks=2,
                    n_steps=800, n_warmup=600, thin=5, bounds=bounds,
                    seed=0)
    wide = res.chain[:, :128].reshape(-1, 3)
    narrow = res.chain[:, 128:].reshape(-1, 3)
    assert np.allclose(wide.std(0), 1.0, rtol=0.15)
    assert np.allclose(narrow.std(0), 0.02, rtol=0.15)
    # the adapted scales actually split per block
    assert res.block_step_sizes.shape == (2,)
    assert res.block_step_sizes[0] > 8 * res.block_step_sizes[1]
    assert np.isclose(res.step_size, res.block_step_sizes.mean())
    with pytest.raises(ValueError, match="adapt_blocks"):
        sample_mh(loglik, None, n_walkers=100, adapt_blocks=3,
                  bounds=bounds)


def test_hmc_adapt_blocks_heterogeneous_widths():
    """Per-block leapfrog steps in HMC: same 50×-split block target;
    per-block dual averaging recovers both blocks' moments (the pooled
    metric is shape-only — identity here — so the block scale rides
    entirely on the per-block step)."""
    import jax.numpy as jnp

    from tpu21cmvae.sampling import sample_hmc

    sig_blk = np.array([1.0, 0.02], np.float32)
    mu = np.zeros(3, np.float32)

    def valgrad(params, x):
        s = jnp.repeat(jnp.asarray(sig_blk), x.shape[0] // 2)[:, None]
        z = (x - mu) / s
        return -0.5 * jnp.sum(z**2, axis=-1), -z / s

    bounds = np.stack([mu - 8.0, mu + 8.0], axis=1)
    res = sample_hmc(
        valgrad, None, n_walkers=256, adapt_blocks=2, n_steps=400,
        n_warmup=300, n_leapfrog=8, thin=5, bounds=bounds, seed=1,
    )
    wide = res.chain[:, :128].reshape(-1, 3)
    narrow = res.chain[:, 128:].reshape(-1, 3)
    assert np.allclose(wide.std(0), 1.0, rtol=0.15)
    assert np.allclose(narrow.std(0), 0.02, rtol=0.15)
    assert res.block_step_sizes.shape == (2,)
    assert res.block_step_sizes[0] > 8 * res.block_step_sizes[1]
    with pytest.raises(ValueError, match="adapt_blocks"):
        sample_hmc(valgrad, None, n_walkers=100, adapt_blocks=3,
                   bounds=bounds)


def test_nuts_adapt_blocks_heterogeneous_geometry():
    """Per-block NUTS adaptation (the batched-observation path): on a
    two-block target with a 50x width split AND opposite anisotropy
    axes, per-block step sizes and per-block metrics recover BOTH
    blocks' moments — a pooled metric would whiten neither block (and
    would also see the spurious between-block spread)."""
    import jax.numpy as jnp

    from tpu21cmvae.sampling import sample_nuts

    sig = np.array([[2.0, 0.2, 2.0], [0.2, 2.0, 0.2]], np.float32)
    mu = np.zeros(3, np.float32)

    def valgrad(params, x):
        s = jnp.repeat(jnp.asarray(sig), x.shape[0] // 2, axis=0)
        z = (x - mu) / s
        return -0.5 * jnp.sum(z**2, axis=-1), -z / s

    bounds = np.stack([mu - 8.0, mu + 8.0], axis=1)
    res = sample_nuts(valgrad, None, n_walkers=256, adapt_blocks=2,
                      n_steps=300, n_warmup=400, thin=5, bounds=bounds,
                      seed=0, max_depth=7)
    draws = res.chain.reshape(res.chain.shape[0], 2, 128, 3)
    for b in range(2):
        flat = draws[:, b].reshape(-1, 3)
        np.testing.assert_allclose(flat.std(0), sig[b], rtol=0.15)
        assert np.abs(flat.mean(0)).max() < 0.3
    assert res.block_step_sizes.shape == (2,)
    assert res.divergence_rate < 0.02
    # the per-block dense metric whitens EACH block (measured ~2.9
    # leapfrogs/draw); a pooled metric sees the conflicting shapes'
    # mixture and must buy the residual anisotropy with tree depth
    pooled = sample_nuts(valgrad, None, n_walkers=256, adapt_blocks=1,
                         n_steps=100, n_warmup=400, thin=5,
                         bounds=bounds, seed=0, max_depth=7)
    assert res.mean_leapfrog < 8
    assert pooled.mean_leapfrog > 1.5 * res.mean_leapfrog
    with pytest.raises(ValueError, match="adapt_blocks"):
        sample_nuts(valgrad, None, n_walkers=100, adapt_blocks=3,
                    bounds=bounds)
