"""Analytic foreground marginalization (tpu21cmvae/foregrounds.py).

The contract: for ``d = m(θ) + F·a + n`` with Gaussian (or flat)
coefficient prior, every likelihood path fed a
:class:`~tpu21cmvae.foregrounds.MarginalizedNoise` must equal the
float64 brute-force marginal Gaussian ``N(d; m(θ), N + F·S·Fᵀ)`` (in
the repo's dropped-``½log|2πN|`` convention), and with a flat prior
must be EXACTLY invariant to foreground injection (``P·F = 0``). The
reference has no likelihood at all (its users marginalize host-side
around 40 ms predict calls, reference ``README.rst:9-11``).
"""

import numpy as np
import pytest

import jax
import jax.numpy as jnp

from tpu21cmvae.foregrounds import (
    MarginalizedNoise,
    foreground_basis,
    linlog_basis,
    marginalize_foreground,
    polynomial_basis,
    powerlaw_basis,
)
from tpu21cmvae.models.direct import DirectEmulator
from tpu21cmvae.utils.config import DirectEmulatorConfig


@pytest.fixture(scope="module")
def tiny(splits):
    em = DirectEmulator(
        splits, config=DirectEmulatorConfig(hidden_dims=(32, 24))
    )
    rng = np.random.default_rng(1)
    F = linlog_basis(em.frequencies, 5)
    a_true = np.array([1500.0, -120.0, 40.0, -8.0, 2.0])
    sig = np.asarray(em.predict(splits.par_test[0]))
    obs = (sig + F @ a_true + rng.normal(0, 5, sig.shape)).astype(
        np.float32
    )
    return em, F, a_true, sig, obs


def _brute_force_marginal(em, obs, theta, F, nv, pv):
    """float64 reference: logN(d; m(θ), N + F·S·Fᵀ) + ½log|2πN|."""
    pred = np.asarray(em.predict(theta), np.float64)
    r = pred - np.asarray(obs, np.float64)
    n_diag = np.full(F.shape[0], float(nv))
    C = np.diag(n_diag) + F @ np.diag(pv) @ F.T
    Ci = np.linalg.inv(C)
    return (
        -0.5 * np.einsum("bi,ij,bj->b", r, Ci, r)
        - 0.5 * (np.linalg.slogdet(C)[1] - np.sum(np.log(n_diag)))
    )


def test_matches_brute_force_marginal(tiny):
    """Proper-prior marginalized likelihood == the float64 marginal
    Gaussian, on the direct, gram, and from_predict paths."""
    em, F, _, _, obs = tiny
    pv = np.full(5, 1e6)
    mn = em.marginalize_foreground(25.0, basis=F, prior_var=pv)
    theta = em.data.par_test[:8]
    ref = _brute_force_marginal(em, obs, theta, F, 25.0, pv)
    scale = np.abs(ref).max()
    for method in ("direct", "gram"):
        ll = np.asarray(
            em.loglik_fn(obs, mn, method=method, precision="highest")(
                em.params, theta
            ),
            np.float64,
        )
        assert np.abs(ll - ref).max() < 2e-3 * scale, method
    from tpu21cmvae.ops.loglik import make_loglik_from_predict

    gen = make_loglik_from_predict(em.predict_fn("highest"), obs, mn)
    ll = np.asarray(gen(em.params, theta), np.float64)
    assert np.abs(ll - ref).max() < 2e-3 * scale


def test_flat_prior_is_injection_invariant(tiny):
    """Flat coefficient prior → P annihilates the foreground columns,
    so ANY F·a added to the observation leaves logL unchanged (up to
    float32 roundoff of the 1e4-scale injected spectrum)."""
    em, F, _, _, obs = tiny
    mn = em.marginalize_foreground(25.0, basis=F)
    theta = em.data.par_test[:8]
    base = np.asarray(
        em.loglik_fn(obs, mn, precision="highest")(em.params, theta)
    )
    rng = np.random.default_rng(7)
    obs2 = (obs + (F @ rng.normal(0, 100, 5))).astype(np.float32)
    moved = np.asarray(
        em.loglik_fn(obs2, mn, precision="highest")(em.params, theta)
    )
    assert np.abs(moved - base).max() < 1e-3 * np.abs(base).max()
    # sanity: the PLAIN likelihood moves by a huge margin on the same
    # injection (this is the problem marginalization solves)
    plain = np.asarray(
        em.loglik_fn(obs, 25.0, precision="highest")(em.params, theta)
    )
    plain2 = np.asarray(
        em.loglik_fn(obs2, 25.0, precision="highest")(em.params, theta)
    )
    assert np.abs(plain2 - plain).min() > 100.0


def test_all_backends_agree(tiny):
    """direct / gram / analytic valgrad / autodiff valgrad agree on a
    MarginalizedNoise."""
    em, F, _, _, obs = tiny
    mn = em.marginalize_foreground(25.0, basis=F)
    theta = em.data.par_test[:8]
    ref = np.asarray(
        em.loglik_fn(obs, mn, method="direct", precision="highest")(
            em.params, theta
        )
    )
    scale = np.abs(ref).max()
    for method in ("direct", "gram"):
        ll = np.asarray(
            em.loglik_fn(obs, mn, method=method,
                         precision="highest")(em.params, theta)
        )
        assert np.abs(ll - ref).max() < 2e-3 * scale, method
    va, ga = em.loglik_and_grad_fn(obs, mn, precision="highest")(
        em.params, theta
    )
    from tpu21cmvae.ops.loglik import make_loglik_and_grad

    vd, gd = make_loglik_and_grad(
        em.config, em.normalizer, obs, mn, variant="autodiff",
        method="direct", precision="highest",
    )(em.params, theta)
    assert np.abs(np.asarray(va) - np.asarray(vd)).max() < 2e-3 * scale
    gscale = np.abs(np.asarray(gd)).max()
    assert np.abs(np.asarray(ga) - np.asarray(gd)).max() < 2e-3 * gscale


def test_multi_observation_marginalized(tiny):
    """The stacked-observation builders accept a shared
    MarginalizedNoise; each observation row matches its
    single-observation likelihood."""
    em, F, _, sig, obs = tiny
    mn = em.marginalize_foreground(25.0, basis=F)
    rng = np.random.default_rng(3)
    obs_b = np.stack(
        [obs, (sig + F @ rng.normal(0, 50, 5) + 3.0).astype(np.float32)]
    )
    theta = em.data.par_test[:4]
    raw = np.concatenate([theta, theta])  # obs-major, W=4 each
    for method in ("direct", "gram"):
        ll = np.asarray(
            em.loglik_multi_fn(obs_b, mn, method=method,
                               precision="highest")(em.params, raw)
        ).reshape(2, 4)
        for o in range(2):
            single = np.asarray(
                em.loglik_fn(obs_b[o], mn, method=method,
                             precision="highest")(em.params, theta)
            )
            np.testing.assert_allclose(ll[o], single, rtol=1e-4,
                                       atol=2e-2)


def test_coeff_posterior_recovers_injection(tiny):
    """GLS coefficient posterior pulls the injected foreground back out
    of a residual, within its own error bars; reconstruct() returns the
    matching spectrum."""
    em, F, a_true, sig, obs = tiny
    mn = em.marginalize_foreground(25.0, basis=F)
    r = np.asarray(obs, np.float64) - sig
    mean, cov = mn.coeff_posterior(r)
    pull = np.abs(mean - a_true) / np.sqrt(np.diag(cov))
    assert pull.max() < 4.0, pull
    rec = mn.reconstruct(mean)
    assert rec.shape == (F.shape[0],)
    assert np.abs(rec - F @ a_true).max() < 10.0
    # batched residual rows
    means, _ = mn.coeff_posterior(np.stack([r, r]))
    np.testing.assert_allclose(means[0], mean)


def test_log_norm_shifts_evidence_not_posterior(tiny):
    """The θ-independent normalization: posterior densities differ by a
    constant between prior_var choices (sampling unaffected), and the
    constant equals −½ log|I + S·FᵀN⁻¹F| as the marginal density
    requires."""
    em, F, _, _, obs = tiny
    theta = em.data.par_test[:6]
    mn_wide = em.marginalize_foreground(25.0, basis=F,
                                        prior_var=np.full(5, 1e8))
    mn_flat = em.marginalize_foreground(25.0, basis=F)
    lw = np.asarray(
        em.loglik_fn(obs, mn_wide, precision="highest")(em.params, theta),
        np.float64,
    )
    lf = np.asarray(
        em.loglik_fn(obs, mn_flat, precision="highest")(em.params, theta),
        np.float64,
    )
    d = lw - lf
    # wide-proper and flat differ by a near-constant offset only
    assert d.max() - d.min() < 2e-3 * np.abs(lf).max()
    # and the offsets are the two conventions' log_norm difference
    np.testing.assert_allclose(
        d.mean(), mn_wide.log_norm - mn_flat.log_norm, atol=0.05
    )


def test_memoization_and_validation(tiny):
    """Model-level program memo keys distinguish MarginalizedNoise by
    VALUE; input validation is loud."""
    em, F, _, _, obs = tiny
    mn1 = em.marginalize_foreground(25.0, basis=F)
    mn1b = em.marginalize_foreground(25.0, basis=F)
    mn2 = em.marginalize_foreground(25.0, basis=F,
                                    prior_var=np.full(5, 1e4))
    assert em.loglik_fn(obs, mn1) is em.loglik_fn(obs, mn1b)
    assert em.loglik_fn(obs, mn1) is not em.loglik_fn(obs, mn2)
    assert em.loglik_fn(obs, mn1) is not em.loglik_fn(obs, 25.0)
    with pytest.raises(ValueError, match="bins"):
        marginalize_foreground(F[:100], 25.0, n_bins=451)
    with pytest.raises(ValueError, match="positive"):
        marginalize_foreground(F, -1.0)
    with pytest.raises(ValueError, match="fewer"):
        marginalize_foreground(np.ones((4, 4)), 1.0)
    with pytest.raises(ValueError, match="singular|dependent"):
        marginalize_foreground(
            np.stack([F[:, 0], F[:, 0]], axis=1), 25.0
        )
    bad = MarginalizedNoise(
        whiten=np.eye(100, dtype=np.float32),
        log_norm=0.0,
        basis=np.ones((100, 1)),
        noise_var=np.ones(100),
        prior_var=None,
    )
    with pytest.raises(ValueError, match="bins"):
        em.loglik_fn(obs, bad, memo=False)


def test_bases_shapes_and_conditioning():
    freqs = np.linspace(50.0, 200.0, 451)
    for kind in ("linlog", "powerlaw", "polynomial"):
        b = foreground_basis(freqs, 6, kind)
        assert b.shape == (451, 6)
        assert np.isfinite(b).all()
        # columns independent enough to marginalize over
        mn = marginalize_foreground(b, 1.0)
        assert np.isfinite(mn.log_norm)
        # P has exactly k zero eigenvalues (flat prior projects k dims)
        lam = np.linalg.eigvalsh(
            np.asarray(mn.whiten, np.float64)
            @ np.asarray(mn.whiten, np.float64).T
        )
        assert (lam < 1e-9).sum() == 6
    with pytest.raises(ValueError, match="n_terms"):
        polynomial_basis(freqs, 0)
    with pytest.raises(ValueError, match="nu_ref"):
        foreground_basis(freqs, 3, "polynomial", nu_ref=100.0)
    with pytest.raises(ValueError, match="kind"):
        foreground_basis(freqs, 3, "sinusoid")
    # powerlaw at nu_ref: first column is 1 at the reference frequency
    b = powerlaw_basis(freqs, 3, nu_ref=100.0)
    i = np.argmin(np.abs(freqs - 100.0))
    assert abs(b[i, 0] - 1.0) < 1e-2


def test_sampler_recovers_theta_under_foreground(tiny):
    """End to end: MH sampling with the marginalized likelihood
    concentrates near the true parameters even though the observation
    is dominated by a foreground the plain likelihood would chase."""
    em, F, _, sig, obs = tiny
    mn = em.marginalize_foreground(25.0, basis=F)
    par = np.asarray(em.data.par_train, np.float64)
    lo, hi = par.min(0), par.max(0)
    pad = 0.05 * (hi - lo) + 1e-6
    lo, hi = lo - pad, hi + pad
    lo[:3] = np.maximum(lo[:3], 1e-6)
    bounds = np.stack([lo, hi], axis=1).astype(np.float32)
    res = em.sample_posterior(
        obs, mn, sampler="mh", bounds=bounds, n_walkers=256,
        n_steps=150, n_warmup=100, seed=0,
    )
    best = res.flat[np.argmax(
        np.asarray(em.loglik_fn(obs, mn, precision="highest")(
            em.params, res.flat
        ))
    )]
    pred = np.asarray(em.predict(best))
    # the marginalized fit explains the SIGNAL component: residual to
    # truth far below the foreground amplitude (~1e3 mK)
    assert np.abs(pred - sig).mean() < 50.0


def test_cli_fg_flags(tmp_path, tiny):
    """`fit --fg-terms` drives the marginalized likelihood end to end
    from the command line: the ML fit lands near the injected signal
    despite the 1e3-mK foreground in the observation."""
    import json as _json

    from tpu21cmvae.__main__ import main

    em, F, _, sig, obs = tiny
    ckpt = str(tmp_path / "m.npz")
    em.save(ckpt)
    obs_file = str(tmp_path / "obs.json")
    with open(obs_file, "w") as f:
        _json.dump({"obs": np.asarray(obs, np.float64).tolist(),
                    "noise_var": 25.0}, f)
    out = str(tmp_path / "fit.npz")
    main(["fit", ckpt, "--obs", obs_file, "--starts", "64",
          "--steps", "80", "--fg-terms", "5", "--out", out])
    blob = np.load(out)
    pred = np.asarray(em.predict(blob["best"]))
    assert np.abs(pred - sig).mean() < 60.0
    # without marginalization the same budget chases the foreground:
    # its best fit explains the signal strictly worse
    out2 = str(tmp_path / "fit_plain.npz")
    main(["fit", ckpt, "--obs", obs_file, "--starts", "64",
          "--steps", "80", "--out", out2])
    pred2 = np.asarray(em.predict(np.load(out2)["best"]))
    assert (np.abs(pred2 - sig).mean() > np.abs(pred - sig).mean())


def test_sample_noise_matches_whitened_form(tiny):
    """The generative counterpart is consistent with the spec's own
    scoring: for draws from sample_noise, the whitened quadratic form
    q = ||R^T x||^2 is chi^2 with n - K dof under the flat prior (the
    injected foreground lies exactly in P's null space) and n dof under
    a proper prior (the marginal covariance IS P^{-1})."""
    em = tiny[0]
    rng = np.random.default_rng(42)
    n, n_draw = 451, 4000
    nv = np.full(n, 25.0)
    flat = em.marginalize_foreground(nv, n_terms=5)
    x = flat.sample_noise(rng, n_draw, flat_coeff_scale=500.0)
    q = np.einsum("bi,bi->b", x @ flat.whiten.astype(np.float64),
                  x @ flat.whiten.astype(np.float64))
    dof = n - 5
    assert abs(q.mean() / dof - 1.0) < 5 * np.sqrt(2.0 / dof / n_draw) + 0.01
    proper = em.marginalize_foreground(nv, n_terms=5, prior_var=1e4)
    xp = proper.sample_noise(rng, n_draw)
    qp = np.einsum("bi,bi->b", xp @ proper.whiten.astype(np.float64),
                   xp @ proper.whiten.astype(np.float64))
    assert abs(qp.mean() / n - 1.0) < 5 * np.sqrt(2.0 / n / n_draw) + 0.01
