"""Noise-level marginalization (`tpu21cmvae.noisescale`).

Float64 brute-force parity of the Student-t-form marginal against
numeric integration over σ² (Jeffreys and proper inverse-gamma priors),
composition with analytic foreground marginalization via an INDEPENDENT
double marginalization (exact Gaussian algebra over the coefficients,
numeric quadrature over the level), gradient-wrapper parity against
autodiff, backend agreement, and the σ²-posterior readout.
"""

import math

import jax
import jax.numpy as jnp
import numpy as np
import pytest

from tpu21cmvae.data import synthetic_dataset
from tpu21cmvae.models.direct import DirectEmulator
from tpu21cmvae.noisescale import ScaleMarginalNoise, marginalize_noise_scale
from tpu21cmvae.utils.config import DirectEmulatorConfig


@pytest.fixture(scope="module")
def splits():
    return synthetic_dataset(n_train=256, n_val=64, n_test=64, seed=7)


@pytest.fixture(scope="module")
def model(splits):
    return DirectEmulator(
        splits, config=DirectEmulatorConfig(hidden_dims=(24, 24))
    )


@pytest.fixture(scope="module")
def noise_shape(model):
    return np.random.default_rng(3).uniform(
        5.0, 50.0, model.config.n_bins
    )


@pytest.fixture(scope="module")
def obs(model, splits, noise_shape):
    sig = np.asarray(model.predict(splits.par_test[0]))
    # generated at TRUE level 2.5× the assumed shape — the scale
    # marginal must absorb it
    return (
        sig
        + np.random.default_rng(5).normal(0, np.sqrt(2.5 * noise_shape))
    ).astype(np.float32)


@pytest.fixture(scope="module")
def rows(splits):
    return np.asarray(splits.par_test[:6], np.float32)


def _sigma_quad(log_integrand_of_s2):
    """log ∫ f(σ²) dσ² by trapezoid on a wide log-σ² grid (float64)."""
    ls2 = np.linspace(-14.0, 14.0, 60001)
    s2 = np.exp(ls2)
    vals = log_integrand_of_s2(s2) + ls2  # dσ² = σ²·d(logσ²)
    mx = vals.max()
    return mx + np.log(np.trapezoid(np.exp(vals - mx), ls2))


@pytest.mark.parametrize("alpha,beta", [(None, None), (3.0, 2.0)])
def test_brute_force_parity_diag(model, obs, rows, noise_shape, alpha, beta):
    """Wrapped value == float64 numeric integral over σ², in the repo's
    dropped-constant convention (drop −½log|2πN₀|)."""
    sm = marginalize_noise_scale(noise_shape, alpha=alpha, beta=beta)
    fn = model.loglik_fn(obs, sm, precision="highest", memo=False)
    got = np.asarray(fn(model.params, rows))

    pred = np.asarray(model.predict(rows), np.float64)
    r = pred - np.asarray(obs, np.float64)
    q0 = np.sum(r * r / noise_shape, axis=-1)
    n = len(noise_shape)

    def log_prior(s2):
        if alpha is None:
            return -np.log(s2)  # Jeffreys, unnormalized
        return (
            alpha * math.log(beta)
            - math.lgamma(alpha)
            - (alpha + 1) * np.log(s2)
            - beta / s2
        )

    want = np.array([
        _sigma_quad(
            lambda s2, q=q: log_prior(s2) - (n / 2) * np.log(s2)
            - q / (2 * s2)
        )
        for q in q0
    ])
    np.testing.assert_allclose(got, want, rtol=0, atol=5e-3)


def test_brute_force_parity_foreground_composed(model, rows, noise_shape,
                                                splits):
    """ScaleMarginalNoise over a flat-prior MarginalizedNoise ==
    independent float64 double marginalization: exact Gaussian algebra
    over the K coefficients at each σ (written from the textbook
    formula, NOT via the module under test), then numeric quadrature
    over σ² — checks n_eff = n_bins − K and the composed constant."""
    from tpu21cmvae.foregrounds import linlog_basis

    F = linlog_basis(model.frequencies, 4)
    sig = np.asarray(model.predict(splits.par_test[1]))
    rng = np.random.default_rng(11)
    obs = (
        sig + F @ np.array([600.0, -40.0, 12.0, -3.0])
        + rng.normal(0, np.sqrt(2.0 * noise_shape))
    ).astype(np.float32)

    mn = model.marginalize_foreground(noise_shape, n_terms=4,
                                      basis="linlog")
    sm = marginalize_noise_scale(mn)
    fn = model.loglik_fn(obs, sm, precision="highest", memo=False)
    got = np.asarray(fn(model.params, rows))

    pred = np.asarray(model.predict(rows), np.float64)
    r = pred - np.asarray(obs, np.float64)
    n, k = F.shape
    nv = np.asarray(noise_shape, np.float64)
    fn_mat = F / nv[:, None]                       # N₀⁻¹F
    a_mat = F.T @ fn_mat                           # FᵀN₀⁻¹F
    sign, logdet_a = np.linalg.slogdet(a_mat)
    # flat-prior coefficient marginal at level σ²  (textbook Gaussian
    # integral; repo convention adds back ½log|2πσ²N₀|):
    #   −q_P/(2σ²) + (k/2)log(2πσ²) − ½log|FᵀN₀⁻¹F|
    rtn = r / nv
    q_p = np.sum(r * rtn, axis=-1) - np.einsum(
        "bi,ij,bj->b", r @ fn_mat, np.linalg.inv(a_mat), r @ fn_mat
    )

    want = np.array([
        _sigma_quad(
            lambda s2, q=q: -np.log(s2)            # Jeffreys
            - ((n - k) / 2) * np.log(s2) - q / (2 * s2)
        )
        + (k / 2) * math.log(2 * math.pi) - 0.5 * logdet_a
        for q in q_p
    ])
    # atol: the device path projects a ~600-amplitude foreground to ~0
    # through the float32 whiten factor — catastrophic-cancellation
    # roundoff in q_P of a few 1e-2 absolute (exact in float64)
    np.testing.assert_allclose(got, want, rtol=0, atol=0.05)


def test_valgrad_matches_autodiff(model, obs, rows, noise_shape):
    """wrap_valgrad's chain-rule rescale == jax.grad through the
    wrapped value, on both the analytic and autodiff gradient routes."""
    sm = marginalize_noise_scale(noise_shape, alpha=2.0, beta=3.0)
    val_fn = model.loglik_fn(obs, sm, precision="highest", memo=False)
    want_v = np.asarray(val_fn(model.params, rows))
    want_g = np.asarray(
        jax.vmap(jax.grad(lambda p: val_fn(model.params, p[None])[0]))(
            jnp.asarray(rows)
        )
    )
    for method in ("gram", "direct"):  # analytic / autodiff routes
        fn = model.loglik_and_grad_fn(
            obs, sm, method=method, precision="highest", memo=False,
        )
        v, g = (np.asarray(x) for x in fn(model.params, rows))
        np.testing.assert_allclose(v, want_v, rtol=1e-5, atol=1e-4)
        np.testing.assert_allclose(g, want_g, rtol=1e-4, atol=1e-4)


def test_backend_parity(model, obs, rows, noise_shape):
    """Gram and direct agree under scale marginalization — the wrapper
    is blind to the path underneath."""
    sm = marginalize_noise_scale(noise_shape)
    ref = np.asarray(
        model.loglik_fn(obs, sm, method="direct", precision="highest",
                        memo=False)(model.params, rows)
    )
    from tpu21cmvae.ops.loglik import make_loglik

    fn = make_loglik(
        model.config, model.normalizer, obs, sm, method="gram",
        precision="highest",
    )
    got = np.asarray(jax.jit(fn)(model.params, jnp.asarray(rows)))
    np.testing.assert_allclose(got, ref, rtol=1e-4, atol=5e-3)


def test_multi_observation(model, splits, rows, noise_shape):
    """Stacked-observation path marginalizes the level PER observation
    — rows score identically to their single-observation wrapped
    values."""
    sigs = np.asarray(model.predict(splits.par_test[:2]))
    rng = np.random.default_rng(7)
    obs2 = (sigs + rng.normal(0, 4.0, sigs.shape)).astype(np.float32)
    sm = marginalize_noise_scale(noise_shape)
    multi = model.loglik_multi_fn(obs2, sm, precision="highest",
                                  memo=False)
    got = np.asarray(multi(model.params, np.tile(rows, (2, 1))))
    for o in range(2):
        single = model.loglik_fn(obs2[o], sm, precision="highest",
                                 memo=False)
        want = np.asarray(single(model.params, rows))
        np.testing.assert_allclose(
            got[o * len(rows):(o + 1) * len(rows)], want,
            rtol=1e-5, atol=1e-3,
        )


def test_scale_invariance_of_posterior_shape(model, obs, rows,
                                             noise_shape):
    """Jeffreys scale marginal is invariant to rescaling the assumed
    noise shape: logL differences between parameter rows are identical
    for base shapes nv and 100·nv (only the constant shifts)."""
    f1 = model.loglik_fn(obs, marginalize_noise_scale(noise_shape),
                         precision="highest", memo=False)
    f2 = model.loglik_fn(obs,
                         marginalize_noise_scale(100.0 * noise_shape),
                         precision="highest", memo=False)
    a = np.asarray(f1(model.params, rows))
    b = np.asarray(f2(model.params, rows))
    np.testing.assert_allclose(a - a[0], b - b[0], rtol=0, atol=2e-2)


def test_sigma2_posterior_readout(model, splits, noise_shape):
    """The σ² posterior concentrates near the true injected level when
    the residual is pure noise: mean β/(α−1) within ~3 posterior sds."""
    sig = np.asarray(model.predict(splits.par_test[2]))
    rng = np.random.default_rng(13)
    true_level = 2.5
    obs = sig + rng.normal(0, np.sqrt(true_level * noise_shape))
    sm = marginalize_noise_scale(noise_shape)
    a_post, b_post = sm.sigma2_posterior(obs - sig)
    mean = b_post / (a_post - 1)
    sd = mean / math.sqrt(a_post - 2)
    assert abs(mean - true_level) < 3 * sd
    # batched rows return per-row beta
    a2, b2 = sm.sigma2_posterior(np.stack([obs - sig] * 3))
    assert np.allclose(b2, b_post) and b2.shape == (3,)


def test_validation_and_memo(model, obs, noise_shape):
    with pytest.raises(ValueError, match="together"):
        marginalize_noise_scale(noise_shape, alpha=2.0)
    with pytest.raises(ValueError, match="alpha > 0"):
        marginalize_noise_scale(noise_shape, alpha=-1.0, beta=1.0)
    with pytest.raises(ValueError, match="positive"):
        marginalize_noise_scale(-1.0)
    sm = marginalize_noise_scale(noise_shape)
    with pytest.raises(ValueError, match="already marginalized"):
        marginalize_noise_scale(sm)
    # value-keyed program memo: same spec → same program object
    f1 = model.loglik_fn(obs, marginalize_noise_scale(noise_shape))
    f2 = model.loglik_fn(obs, marginalize_noise_scale(noise_shape))
    f3 = model.loglik_fn(
        obs, marginalize_noise_scale(noise_shape, alpha=2.0, beta=2.0)
    )
    assert f1 is f2 and f1 is not f3


def test_sampler_end_to_end(model, splits, noise_shape):
    """A short MH chain under the scale marginal concentrates on the
    true parameters even though the assumed noise level is 4× off —
    the workflow the feature exists for."""
    truth = np.asarray(splits.par_test[3], np.float32)
    sig = np.asarray(model.predict(truth))
    rng = np.random.default_rng(17)
    obs = (sig + rng.normal(0, np.sqrt(4.0 * noise_shape))).astype(
        np.float32
    )
    sm = marginalize_noise_scale(noise_shape)
    res = model.sample_posterior(
        obs, sm, n_walkers=64, n_steps=150, n_warmup=75, seed=0,
    )
    lo = np.percentile(res.chain, 1, axis=(0, 1))
    hi = np.percentile(res.chain, 99, axis=(0, 1))
    # the posterior support brackets the truth on most parameters
    inside = (truth >= lo) & (truth <= hi)
    assert inside.sum() >= truth.size - 2


def test_cli_scale_marginal(tmp_path, splits):
    """`sample --marginalize-noise-scale` runs end to end (composed
    with --fg-terms), and --noise-alpha without the flag is an error."""
    import json as _json

    from tpu21cmvae.__main__ import main

    model = DirectEmulator(
        splits, config=DirectEmulatorConfig(hidden_dims=(16,))
    )
    ckpt = str(tmp_path / "m.npz")
    model.save(ckpt)
    obs = model.predict(splits.par_test[0])
    obs_file = str(tmp_path / "obs.json")
    with open(obs_file, "w") as f:
        _json.dump({"obs": np.asarray(obs).tolist(), "noise_var": 25.0},
                   f)
    out = str(tmp_path / "chain.npz")
    main(["sample", ckpt, "--obs", obs_file, "--sampler", "mh",
          "--walkers", "32", "--steps", "20", "--warmup", "10",
          "--thin", "5", "--marginalize-noise-scale",
          "--noise-alpha", "3.0", "--noise-beta", "2.0",
          "--fg-terms", "3", "--out", out])
    blob = np.load(out)
    assert blob["final"].shape == (32, model.config.n_params)
    assert np.isfinite(blob["logp"]).all()
    with pytest.raises(ValueError, match="together"):
        main(["sample", ckpt, "--obs", obs_file, "--sampler", "mh",
              "--walkers", "32", "--steps", "10", "--warmup", "5",
              "--marginalize-noise-scale", "--noise-alpha", "3.0",
              "--out", out])


def test_zero_residual_jeffreys_finite(model, splits, rows):
    """A noiseless observation evaluated at its own parameters gives
    residual q = 0; under Jeffreys (beta=0) the exact marginal diverges,
    but the implementation must floor it to a FINITE value (and finite
    gradients) — +inf poisons MH ratios (inf-inf=NaN) and the
    a/(beta+q/2) chain-rule rescale. Regression: the old q-floor was a
    float32 subnormal, which accelerator code flushes to zero -> log(0)."""
    from tpu21cmvae.ops.loglik import make_loglik, make_loglik_and_grad

    obs0 = np.asarray(model.predict(splits.par_test[0]), np.float32)
    sm = marginalize_noise_scale(
        np.full(model.config.n_bins, 25.0, np.float32)
    )
    batch = np.concatenate(
        [np.asarray(splits.par_test[:1], np.float32), rows]
    )
    ll = np.asarray(
        jax.jit(
            make_loglik(model.config, model.normalizer, obs0, sm)
        )(model.params, batch)
    )
    assert np.isfinite(ll).all(), ll
    # the degenerate row still dominates: a perfect fit is the MAP
    assert ll[0] >= ll[1:].max()
    v, g = jax.jit(
        make_loglik_and_grad(model.config, model.normalizer, obs0, sm)
    )(model.params, batch)
    assert np.isfinite(np.asarray(v)).all()
    assert np.isfinite(np.asarray(g)).all()


def test_sample_noise_generative_moments(model, noise_shape):
    """sample_noise draws from the spec's own generative model: the
    implied level estimates q_i/n concentrate on InvGamma draws whose
    sample mean matches E[sigma^2] = beta/(alpha-1); Jeffreys refuses;
    scalar bases refuse (no bin count)."""
    rng = np.random.default_rng(11)
    n_draw = 3000
    sm = marginalize_noise_scale(noise_shape, alpha=4.0, beta=9.0)
    x = sm.sample_noise(rng, n_draw)
    lvl = np.mean(x * x / noise_shape, axis=1)  # ~ sigma^2_i (n=451)
    want = 9.0 / 3.0
    # var of the InvGamma(4,9) mean estimate over 3000 draws
    sd = math.sqrt((want**2 / 2.0) / n_draw)  # var = b^2/((a-1)^2(a-2))
    assert abs(lvl.mean() - want) < 6 * sd + 0.02
    with pytest.raises(ValueError, match="Jeffreys"):
        marginalize_noise_scale(noise_shape).sample_noise(rng, 2)
    with pytest.raises(ValueError, match="per-bin"):
        marginalize_noise_scale(25.0, alpha=4.0, beta=9.0).sample_noise(
            rng, 2
        )
    # composed with a flat-prior foreground base: the projected
    # quadratic form still reads the drawn level (fg directions null)
    mn = model.marginalize_foreground(noise_shape, n_terms=4)
    smfg = marginalize_noise_scale(mn, alpha=4.0, beta=9.0)
    xf = smfg.sample_noise(rng, n_draw, flat_coeff_scale=500.0)
    z = xf @ mn.whiten.astype(np.float64)
    lvlf = np.einsum("bi,bi->b", z, z) / (451 - 4)
    assert abs(lvlf.mean() - want) < 6 * sd + 0.02


def test_fisher_student_t_correction(model, noise_shape):
    """Fisher under a proper-prior ScaleMarginalNoise equals the plain
    Gaussian Fisher times the closed-form multivariate-t factor
    (alpha/beta)*(2a+n_eff)/(2a+n_eff+2), with n_eff = n - K when the
    base is a flat-prior MarginalizedNoise; Jeffreys raises."""
    theta = np.asarray(
        [0.05, 16.5, 1.0, 0.06, 1.3, 2.0, 30.0], np.float32
    )
    F0, _ = model.fisher_forecast(theta, noise_shape)
    sm = marginalize_noise_scale(noise_shape, alpha=3.0, beta=2.0)
    Ft, _ = model.fisher_forecast(theta, sm)
    n = model.config.n_bins
    want = (3.0 / 2.0) * (6.0 + n) / (6.0 + n + 2.0)
    np.testing.assert_allclose(Ft, want * F0, rtol=1e-5)
    # composed: base fg-marginalized (flat, K=4) -> n_eff = n - 4 and
    # the Gaussian part is the fg-marginalized Fisher
    mn = model.marginalize_foreground(noise_shape, n_terms=4)
    Fm, _ = model.fisher_forecast(theta, mn)
    smfg = marginalize_noise_scale(mn, alpha=3.0, beta=2.0)
    Ftm, _ = model.fisher_forecast(theta, smfg)
    want2 = (3.0 / 2.0) * (6.0 + (n - 4)) / (6.0 + (n - 4) + 2.0)
    np.testing.assert_allclose(Ftm, want2 * Fm, rtol=1e-5)
    # fg marginalization can only LOSE information — in the matrix
    # AND in the quoted sigmas (forecast_errors' noise-floored float64
    # eigensolve keeps this monotone; the old float32 pseudo-inverse
    # let noise eigenvalues through and sigma could SHRINK)
    assert (np.diag(Fm) <= np.diag(F0) * (1 + 1e-6)).all()
    _, sig0 = model.fisher_forecast(theta, noise_shape)
    _, sigm = model.fisher_forecast(theta, mn)
    assert (np.asarray(sigm) >= np.asarray(sig0) * (1 - 1e-9)).all()
    with pytest.raises(ValueError, match="Jeffreys"):
        model.fisher_forecast(theta, marginalize_noise_scale(noise_shape))


def test_direct_construction_validates_prior(model):
    """ScaleMarginalNoise built directly (not via the factory) rejects
    half-specified InvGamma priors instead of crashing late or silently
    scoring a hybrid density."""
    import pytest

    from tpu21cmvae.noisescale import ScaleMarginalNoise

    with pytest.raises(ValueError, match="together"):
        ScaleMarginalNoise(base=25.0, alpha=3.0)
    with pytest.raises(ValueError, match="together"):
        ScaleMarginalNoise(base=25.0, beta=5.0)
    with pytest.raises(ValueError, match="alpha > 0"):
        ScaleMarginalNoise(base=25.0, alpha=-1.0, beta=2.0)
