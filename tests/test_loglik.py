"""Emulate→log-likelihood: parity across methods and tiers.

The direct and gram likelihoods (obs/noise folded into the last layer
for gram) must agree with the hand-written predict-then-reduce a user
would compose from the reference's API (reference
``emulator.py:383-407``), and the value+gradient builders with autodiff.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest

from tpu21cmvae.data.synthetic import synthetic_params
from tpu21cmvae.models.direct import DirectEmulator
from tpu21cmvae.ops.fold import _log_clamp, fold_loglik_constants, noise_scale
from tpu21cmvae.ops.loglik import make_loglik
from tpu21cmvae.ops.mlp import mlp_apply
from tpu21cmvae.utils.config import DirectEmulatorConfig


@pytest.fixture(scope="module")
def model(splits):
    return DirectEmulator(
        splits, config=DirectEmulatorConfig(hidden_dims=(48, 56))
    )


@pytest.fixture(scope="module")
def obs(model, splits):
    # a synthetic "observation": a test signal plus fixed noise
    sig = model.predict(splits.par_test[0])
    return jnp.asarray(
        sig + np.random.default_rng(5).normal(0, 5.0, sig.shape), jnp.float32
    )


def _composed(model, obs, noise_var, raw):
    """What a user composes by hand: predict, subtract, reduce."""
    pred = model.predict_fn()(model.params, jnp.atleast_2d(raw))
    return -0.5 * jnp.sum(
        (pred - obs) ** 2 / jnp.asarray(noise_var, jnp.float32), axis=-1
    )


def test_xla_loglik_matches_composed(model, obs, splits):
    raw = jnp.asarray(splits.par_test[:33], jnp.float32)
    fn = make_loglik(
        model.config, model.normalizer, obs, 25.0, precision="highest",
    )
    got = fn(model.params, raw)
    want = _composed(model, obs, 25.0, raw)
    assert got.shape == (33,)
    np.testing.assert_allclose(np.asarray(got), np.asarray(want), rtol=1e-5)


def test_fold_loglik_constants_exact(model, obs):
    """Folded network output == noise-whitened residual (pred − obs)/σ."""
    scale = noise_scale(25.0, model.config.n_bins)
    folded = fold_loglik_constants(model.params, model.normalizer, obs, scale)
    raw = jnp.asarray(model.data.par_test[:9], jnp.float32)
    r = mlp_apply(folded, _log_clamp(raw))
    pred = model.predict_fn()(model.params, raw)
    want = (pred - obs) / 5.0
    np.testing.assert_allclose(
        np.asarray(r), np.asarray(want), rtol=2e-4, atol=2e-3
    )


def test_perbin_noise_variance(model, obs):
    """A per-bin σ² vector weights bins correctly."""
    nv = np.linspace(4.0, 100.0, model.config.n_bins).astype(np.float32)
    raw = jnp.asarray(model.data.par_test[:16], jnp.float32)
    want = np.asarray(_composed(model, obs, jnp.asarray(nv), raw))
    fn = jax.jit(make_loglik(
        model.config, model.normalizer, obs, nv, precision="highest",
    ))
    got = np.asarray(fn(model.params, raw))
    np.testing.assert_allclose(got, want, rtol=1e-4, atol=1e-3)


def test_single_row_and_model_entry(model, obs):
    """1-D input scores as one row through DirectEmulator.loglik_fn,
    for both methods."""
    raw1 = jnp.asarray(model.data.par_test[0], jnp.float32)
    want = np.asarray(_composed(model, obs, 25.0, raw1))
    for method in ("direct", "gram"):
        out = model.loglik_fn(obs, 25.0, method=method)(model.params, raw1)
        assert out.shape == (1,)
        np.testing.assert_allclose(np.asarray(out), want, rtol=2e-3)


def test_bad_backend_raises(model, obs):
    with pytest.raises(ValueError):
        make_loglik(model.config, model.normalizer, obs, method="cholesky")


def test_gram_fold_identity(model, obs):
    """h·G·hᵀ + 2h·u + c == ‖h@W + b‖² exactly (up to f32 rounding)."""
    from tpu21cmvae.ops.fold import gram_fold

    scale = noise_scale(25.0, model.config.n_bins)
    trunk_g, G, u, c = gram_fold(model.params, model.normalizer, obs, scale)
    folded = fold_loglik_constants(model.params, model.normalizer, obs, scale)
    *trunk, last = folded
    assert len(trunk_g) == len(trunk)
    h = jax.random.normal(jax.random.key(3), (17, last["w"].shape[0]))
    r = h @ last["w"] + last["b"]
    want = np.sum(np.asarray(r) ** 2, axis=-1)
    got = np.asarray(jnp.sum((h @ G + 2.0 * u) * h, axis=-1) + c)
    np.testing.assert_allclose(got, want, rtol=1e-4)


def test_gram_method_matches_direct(model, obs):
    """method='gram' == method='direct' within quadratic-form
    cancellation error, odd batch size, fx == 0 rows."""
    rng = np.random.default_rng(21)
    raw = synthetic_params(77, rng).astype(np.float32)
    raw[:2, 2] = 0.0
    want = np.asarray(_composed(model, obs, 25.0, jnp.asarray(raw)))
    fn = jax.jit(
        make_loglik(
            model.config, model.normalizer, obs, 25.0,
            method="gram", precision="highest",
        )
    )
    got = np.asarray(fn(model.params, jnp.asarray(raw)))
    assert got.shape == (77,)
    # cancellation: ‖pred−mean‖²-scale terms cancel to ‖r‖²-scale result
    np.testing.assert_allclose(got, want, rtol=1e-3, atol=0.5)


def test_two_stage_family_loglik(splits, obs):
    """AE and VAE emulators expose the same loglik contract through
    their predict pipelines (reference users hand-composed this at
    ~40 ms/signal; reference ``emulator.py:770-795``)."""
    from tpu21cmvae.models.autoencoder import AutoEncoderEmulator
    from tpu21cmvae.models.vae import VAEEmulator

    raw = jnp.asarray(splits.par_test[:9], jnp.float32)
    for cls in (AutoEncoderEmulator, VAEEmulator):
        m = cls(splits)
        fn = m.loglik_fn(obs, 25.0)
        got = np.asarray(fn(m.params, raw))
        pred = m.predict(np.asarray(raw))
        want = -0.5 * np.sum((pred - np.asarray(obs)) ** 2 / 25.0, axis=-1)
        assert got.shape == (9,)
        np.testing.assert_allclose(got, want, rtol=1e-5)
        one = fn(m.params, raw[0])
        assert one.shape == (1,)


def test_loglik_is_differentiable(model, obs):
    """HMC/NUTS need ∇logL: both methods differentiate natively and
    their gradients agree."""
    raw = jnp.asarray(model.data.par_test[:5], jnp.float32)

    def gradnorm(fn):
        g = jax.grad(lambda r: jnp.sum(fn(model.params, r)))(raw)
        return np.asarray(g)

    ref = gradnorm(
        make_loglik(model.config, model.normalizer, obs, 25.0,
                    method="direct", precision="highest")
    )
    assert np.isfinite(ref).all() and np.abs(ref).max() > 0
    g = gradnorm(
        make_loglik(model.config, model.normalizer, obs, 25.0,
                    method="gram", precision="highest")
    )
    np.testing.assert_allclose(g, ref, rtol=1e-3, atol=1e-2)


def test_fisher_matches_finite_difference(model):
    """Fisher via jacfwd == finite-difference Jacobian contraction, and
    forecast errors are positive and finite at a test fiducial."""
    from tpu21cmvae.ops.fisher import (
        forecast_errors,
        make_fisher,
        make_signal_jacobian,
    )

    theta = jnp.asarray(model.data.par_test[3], jnp.float32)
    jac = make_signal_jacobian(model.config, model.normalizer)
    J = np.asarray(jac(model.params, theta))
    assert J.shape == (model.config.n_bins, 7)

    # central finite differences on the public predict
    eps = 1e-3 * np.maximum(np.abs(np.asarray(theta)), 1e-3)
    J_fd = np.empty_like(J)
    for k in range(7):
        tp = np.asarray(theta).copy(); tp[k] += eps[k]
        tm = np.asarray(theta).copy(); tm[k] -= eps[k]
        J_fd[:, k] = (model.predict(tp) - model.predict(tm)) / (2 * eps[k])
    scale = np.abs(J).max(axis=0, keepdims=True)
    # atol bounds FD truncation error on the log10-curved parameters
    np.testing.assert_allclose(J / scale, J_fd / scale, atol=2e-2)

    fisher = make_fisher(model.config, model.normalizer, noise_var=25.0)
    F = np.asarray(fisher(model.params, theta))
    assert F.shape == (7, 7)
    np.testing.assert_allclose(F, F.T, rtol=1e-5)  # symmetric
    want = (J / 25.0).T @ J
    np.testing.assert_allclose(F, want, rtol=1e-4)

    sig = np.asarray(forecast_errors(F))
    assert sig.shape == (7,) and np.isfinite(sig).all() and (sig >= 0).all()
    # batched fiducials via vmap
    thetas = jnp.asarray(model.data.par_test[:4], jnp.float32)
    Fb = jax.vmap(lambda t: fisher(model.params, t))(thetas)
    assert Fb.shape == (4, 7, 7)
    assert np.asarray(forecast_errors(Fb)).shape == (4, 7)


def test_model_fisher_forecast_entry(model):
    F, sig = model.fisher_forecast(model.data.par_test[0], noise_var=25.0)
    assert F.shape == (7, 7) and sig.shape == (7,)
    assert np.isfinite(sig).all()
    Fb, sb = model.fisher_forecast(model.data.par_test[:3], noise_var=25.0)
    assert Fb.shape == (3, 7, 7) and sb.shape == (3, 7)
    np.testing.assert_allclose(Fb[0], F, rtol=1e-5)


def test_gram_honors_activation(splits, obs):
    """method='gram' must use the configured activation, not hardcoded
    ReLU (regression: tanh models got silently wrong likelihoods)."""
    m = DirectEmulator(
        splits,
        config=DirectEmulatorConfig(hidden_dims=(32, 48), activation="tanh"),
    )
    raw = jnp.asarray(splits.par_test[:16], jnp.float32)
    want = np.asarray(_composed(m, obs, 25.0, raw))
    fn = make_loglik(m.config, m.normalizer, obs, 25.0,
                     method="gram", precision="highest")
    got = np.asarray(fn(m.params, raw))
    np.testing.assert_allclose(got, want, rtol=1e-3, atol=0.5)


# -- value+gradient builders (make_loglik_and_grad) ------------------------


def _ad_reference(model, obs, noise_var, raw):
    """Contract gradient: autodiff through the exact-f32 direct path."""
    from tpu21cmvae.ops.loglik import make_loglik_and_grad

    fn = make_loglik_and_grad(
        model.config, model.normalizer, obs, noise_var,
        method="direct", variant="autodiff", precision="highest",
    )
    return fn(model.params, raw)


def test_loglik_and_grad_autodiff_matches_grad(model, obs, splits):
    """The ones-cotangent VJP equals per-row jax.grad (block-diag J)."""
    from tpu21cmvae.ops.loglik import make_loglik, make_loglik_and_grad

    raw = jnp.asarray(splits.par_test[:7], jnp.float32)
    val, g = _ad_reference(model, obs, 25.0, raw)
    assert val.shape == (7,) and g.shape == (7, model.config.n_params)
    base = make_loglik(
        model.config, model.normalizer, obs, 25.0, precision="highest",
        method="direct",
    )
    for i in (0, 3):
        gi = jax.grad(lambda r: base(model.params, r[None, :])[0])(raw[i])
        # batched-vjp vs single-row grad trace different programs →
        # different fusion → fp-noise-level differences only
        np.testing.assert_allclose(
            np.asarray(g[i]), np.asarray(gi),
            rtol=1e-4, atol=1e-5 * float(np.abs(np.asarray(gi)).max()),
        )


def test_analytic_gram_grad_matches_autodiff(model, obs, splits):
    """Hand-written backward (h@G reuse, explicit ReLU masks, log-clamp
    chain) == autodiff through the same gram forward, at HIGHEST."""
    from tpu21cmvae.ops.loglik import make_loglik_and_grad

    raw = np.asarray(splits.par_test[:65], np.float32)
    raw[3, 2] = 0.0  # fx == 0 clamp row: gradient must be 0 in that slot
    raw = jnp.asarray(raw)
    ana = make_loglik_and_grad(
        model.config, model.normalizer, obs, 25.0,
        method="gram", variant="analytic",
        precision="highest", grad_precision="highest",
    )
    ad = make_loglik_and_grad(
        model.config, model.normalizer, obs, 25.0,
        method="gram", variant="autodiff", precision="highest",
    )
    va, ga = ana(model.params, raw)
    vd, gd = ad(model.params, raw)
    np.testing.assert_allclose(np.asarray(va), np.asarray(vd), rtol=1e-6)
    scale = np.abs(np.asarray(gd)).max()
    np.testing.assert_allclose(
        np.asarray(ga), np.asarray(gd), rtol=1e-5, atol=1e-6 * scale
    )
    assert np.asarray(ga)[3, 2] == 0.0  # clamp kills the fx gradient


def test_analytic_gram_grad_vs_contract(model, obs, splits):
    """Analytic gram ∇logL tracks the exact direct-path gradient."""
    raw = jnp.asarray(splits.par_test[:33], jnp.float32)
    from tpu21cmvae.ops.loglik import make_loglik_and_grad

    ana = make_loglik_and_grad(
        model.config, model.normalizer, obs, 25.0,
        precision="highest", grad_precision="highest",
    )  # defaults: gram + analytic
    va, ga = ana(model.params, raw)
    vr, gr = _ad_reference(model, obs, 25.0, raw)
    np.testing.assert_allclose(np.asarray(va), np.asarray(vr), rtol=1e-4)
    norm = np.linalg.norm(np.asarray(gr), axis=1)
    err = np.linalg.norm(np.asarray(ga) - np.asarray(gr), axis=1)
    assert (err <= 1e-4 * (norm + norm.mean())).all()


def test_loglik_and_grad_rejects_bad_combos(model, obs):
    from tpu21cmvae.ops.loglik import make_loglik_and_grad

    with pytest.raises(ValueError, match="variant"):
        make_loglik_and_grad(
            model.config, model.normalizer, obs, variant="nope"
        )
    with pytest.raises(ValueError, match="analytic"):
        make_loglik_and_grad(
            model.config, model.normalizer, obs, method="direct",
            variant="analytic",
        )


def test_grad_finite_difference(model, obs, splits):
    """∇logL from the analytic path agrees with central differences."""
    from tpu21cmvae.ops.loglik import make_loglik, make_loglik_and_grad

    base = make_loglik(
        model.config, model.normalizer, obs, 25.0, precision="highest",
        method="gram",
    )
    ana = make_loglik_and_grad(
        model.config, model.normalizer, obs, 25.0,
        precision="highest", grad_precision="highest",
    )
    theta = np.asarray(splits.par_test[1], np.float64)
    _, g = ana(model.params, jnp.asarray(theta, jnp.float32))
    g = np.asarray(g)[0]
    for j in range(model.config.n_params):
        h = 1e-3 * max(abs(theta[j]), 1e-3)
        tp, tm = theta.copy(), theta.copy()
        tp[j] += h
        tm[j] -= h
        fd = (
            float(base(model.params, jnp.asarray(tp, jnp.float32))[0])
            - float(base(model.params, jnp.asarray(tm, jnp.float32))[0])
        ) / (2 * h)
        assert abs(g[j] - fd) <= 2e-2 * (abs(fd) + np.abs(g).mean() + 1.0), (
            j, g[j], fd
        )


def test_contract_precision_alias(model, obs, splits):
    """precision="contract" is the documented exact-f32 escape hatch —
    bitwise identical to "highest" on every builder."""
    from tpu21cmvae.ops.loglik import make_loglik, make_loglik_and_grad

    raw = jnp.asarray(splits.par_test[:5], jnp.float32)
    for method in ("direct", "gram"):
        a = make_loglik(model.config, model.normalizer, obs, 25.0,
                        method=method, precision="contract")(model.params, raw)
        b = make_loglik(model.config, model.normalizer, obs, 25.0,
                        method=method, precision="highest")(model.params, raw)
        np.testing.assert_array_equal(np.asarray(a), np.asarray(b))
    va, ga = make_loglik_and_grad(
        model.config, model.normalizer, obs, 25.0,
        precision="contract", grad_precision="contract",
    )(model.params, raw)
    vb, gb = make_loglik_and_grad(
        model.config, model.normalizer, obs, 25.0,
        precision="highest", grad_precision="highest",
    )(model.params, raw)
    np.testing.assert_array_equal(np.asarray(va), np.asarray(vb))
    np.testing.assert_array_equal(np.asarray(ga), np.asarray(gb))
