"""Regression tests for review findings: shard divisibility, loss-fn
signatures, shape promotion, NaN trial ranking, axis persistence."""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np

from tpu21cmvae.utils.config import TrainConfig


def test_sharded_emulator_non_power_of_two_mesh(splits):
    """Buckets must divide across a 3-device mesh (lcm, not max)."""
    from tpu21cmvae.models.direct import DirectEmulator
    from tpu21cmvae.parallel import ShardedEmulator
    from tpu21cmvae.parallel.mesh import make_mesh
    from tpu21cmvae.utils.config import DirectEmulatorConfig

    model = DirectEmulator(splits, config=DirectEmulatorConfig(hidden_dims=(16,)))
    mesh = make_mesh(jax.devices()[:3])
    sharded = ShardedEmulator.for_model(model, mesh=mesh)
    assert sharded.quantum % 3 == 0
    out = sharded(np.asarray(splits.par_test[:10], np.float32))
    assert out.shape == (10, splits.n_bins)
    np.testing.assert_allclose(
        out, model.predict(splits.par_test[:10]), rtol=1e-5, atol=1e-4
    )


def test_vae_loss_fn_signature_matches_fit(splits, normalizer):
    """VAE.loss_fn(scaled_mean) plugs straight into fit(stochastic=True)."""
    from tpu21cmvae.models.vae import VAE
    from tpu21cmvae.ops.transforms import preproc
    from tpu21cmvae.train.loop import fit
    from tpu21cmvae.utils.config import VAEConfig

    vae = VAE(VAEConfig(latent_dim=4, enc_hidden_dims=(16,), dec_hidden_dims=(16,)))
    loss = vae.loss_fn(normalizer.scaled_mean)
    y = preproc(jnp.asarray(splits.signal_train[:64], jnp.float32), normalizer)
    yv = preproc(jnp.asarray(splits.signal_val[:32], jnp.float32), normalizer)
    cfg = TrainConfig(
        epochs=2, batch_size=32, learning_rate=1e-3,
        early_stop_patience=None, plateau_patience=None,
    )
    _, _, hist = fit(vae.params, loss, y, y, yv, yv, cfg, stochastic=True)
    assert len(hist.loss) == 2 and np.isfinite(hist.loss).all()


def test_error_single_row_against_2d_truth():
    """A squeezed (bins,) prediction against a (1, bins) truth reduces
    over bins, not over the singleton row."""
    from tpu21cmvae.utils.metrics import error

    rng = np.random.default_rng(0)
    truth = rng.normal(0, 50, (1, 451))
    pred = truth[0] + 1.0  # squeezed single prediction, off by 1 mK
    err = error(truth, pred, relative=False)
    assert err.shape == (1,)
    np.testing.assert_allclose(err, [1.0], rtol=1e-6)
    # both 1-D → scalar, unchanged behavior
    assert np.ndim(error(truth[0], pred, relative=False)) == 0


def test_tuner_nan_trials_rank_last():
    from tpu21cmvae.tuner import Trial, _run_trials

    configs = iter(["a", "b", "c"])
    results = iter([float("nan"), 0.5, 0.2])

    res = _run_trials(
        3,
        lambda rng: next(configs),
        lambda cfg, seed: (next(results), 0.0, 1, 1),
        seed=0,
        verbose=False,
    )
    assert [t.val_error for t in res.trials][:2] == [0.2, 0.5]
    assert np.isnan(res.trials[-1].val_error)
    assert res.best.val_error == 0.2


def test_ae_vae_checkpoints_persist_axes(tmp_path, splits):
    from tpu21cmvae.models.autoencoder import AutoEncoderEmulator
    from tpu21cmvae.models.vae import VAEEmulator
    from tpu21cmvae.utils.config import AutoEncoderConfig, VAEConfig

    z = np.linspace(6.0, 30.0, 451)
    small = dict(latent_dim=4, enc_hidden_dims=(16,), dec_hidden_dims=(16,),
                 em_hidden_dims=(12,))
    ae = AutoEncoderEmulator(splits, config=AutoEncoderConfig(**small), redshifts=z)
    p = str(tmp_path / "ae.npz")
    ae.save(p)
    back = AutoEncoderEmulator.from_checkpoint(p)
    np.testing.assert_allclose(back.redshifts, z)

    vae = VAEEmulator(splits, config=VAEConfig(**small, beta=2e-4,
                                               kl_anneal_epochs=7), redshifts=z)
    p = str(tmp_path / "vae.npz")
    vae.save(p)
    back = VAEEmulator.from_checkpoint(p)
    np.testing.assert_allclose(back.redshifts, z)
    assert back.config.beta == 2e-4
    assert back.config.kl_anneal_epochs == 7


def test_eval_monitor_uses_final_epoch_objective(splits, normalizer):
    """With pass_epoch, val_loss is computed at the final-epoch schedule
    value, so a warm-up cannot masquerade as degradation."""
    from tpu21cmvae.train.loop import fit
    from tpu21cmvae.ops.mlp import init_mlp, mlp_apply
    from tpu21cmvae.ops.transforms import par_transform, preproc

    params = init_mlp(jax.random.key(0), (7, 8, splits.n_bins))
    x = par_transform(jnp.asarray(splits.par_train[:64], jnp.float32), normalizer)
    y = preproc(jnp.asarray(splits.signal_train[:64], jnp.float32), normalizer)

    seen = []

    def loss_fn(p, bx, by, epoch):
        seen.append(True)
        base = jnp.mean((mlp_apply(p, bx) - by) ** 2, axis=-1)
        return base + 0.0 * epoch + 1000.0 * (epoch < 2)  # huge warm-up term

    cfg = TrainConfig(epochs=3, batch_size=32, early_stop_patience=None,
                      plateau_patience=None)
    _, _, hist = fit(params, loss_fn, x, y, x, y, cfg, pass_epoch=True)
    # train loss sees the warm-up spike in epochs 0-1; val never does
    assert hist.loss[0] > 500 and hist.loss[2] < 500
    assert all(v < 500 for v in hist.val_loss)


def test_scan_no_improvement_keeps_last_params(splits, normalizer):
    """Early stop with zero improving epochs must NOT restore the initial
    weights (host-loop semantics: best_weights stays unset → last params
    stand)."""
    from tpu21cmvae.ops.mlp import init_mlp, mlp_apply
    from tpu21cmvae.ops.transforms import par_transform, preproc
    from tpu21cmvae.train.loop import fit
    from tpu21cmvae.train.scan import fit_scan

    params = init_mlp(jax.random.key(0), (7, 16, splits.n_bins))
    sm = normalizer.scaled_mean

    def loss_fn(p, x, y):
        from tpu21cmvae.ops.losses import relative_mse

        return relative_mse(y, mlp_apply(p, x), sm)

    def nan_loss_fn(p, x, y):
        return loss_fn(p, x, y) * jnp.nan  # diverged run: monitor is NaN

    x = par_transform(jnp.asarray(splits.par_train[:64], jnp.float32), normalizer)
    y = preproc(jnp.asarray(splits.signal_train[:64], jnp.float32), normalizer)
    cfg = TrainConfig(
        epochs=6, batch_size=32, early_stop_patience=2, plateau_patience=None,
    )
    pa, _, ha = fit(params, nan_loss_fn, x, y, x, y, cfg)
    pb, _, hb = fit_scan(params, nan_loss_fn, x, y, x, y, cfg)
    # NaN never improves the monitor → stop at `patience` epochs, and the
    # LAST params stand in both paths (no best weights to restore); before
    # the fix the scan path restored the untouched initial weights.
    assert ha.stopped_epoch == hb.stopped_epoch == 1
    assert ha.best_epoch is None and hb.best_epoch is None
    for la, lb, l0 in zip(pa, pb, params):
        a, b = np.asarray(la["w"]), np.asarray(lb["w"])
        np.testing.assert_allclose(a, b, rtol=1e-6, equal_nan=True)
        assert not np.array_equal(b, np.asarray(l0["w"]))


def test_dp_fit_forwards_pass_epoch(splits, normalizer):
    from tpu21cmvae.ops.mlp import init_mlp, mlp_apply
    from tpu21cmvae.ops.losses import relative_mse
    from tpu21cmvae.ops.transforms import par_transform, preproc
    from tpu21cmvae.parallel.mesh import make_mesh
    from tpu21cmvae.parallel.train_dp import dp_fit

    params = init_mlp(jax.random.key(0), (7, 8, splits.n_bins))
    sm = normalizer.scaled_mean

    def loss_fn(p, x, y, epoch):
        return relative_mse(y, mlp_apply(p, x), sm) + 0.0 * epoch

    x = par_transform(jnp.asarray(splits.par_train[:64], jnp.float32), normalizer)
    y = preproc(jnp.asarray(splits.signal_train[:64], jnp.float32), normalizer)
    cfg = TrainConfig(epochs=2, batch_size=32, early_stop_patience=None,
                      plateau_patience=None)
    _, _, hist = dp_fit(params, loss_fn, x, y, x, y, cfg, make_mesh(),
                        pass_epoch=True)
    assert len(hist.loss) == 2


def test_tuner_resamples_duplicates():
    """A small space should be swept, not silently truncated by
    duplicate draws."""
    from tpu21cmvae.tuner import _run_trials

    pool = ["a", "b", "a", "a", "b", "c"]

    def sample(rng):
        return pool[int(rng.integers(0, len(pool)))]

    res = _run_trials(3, sample, lambda cfg, seed: (1.0, 0.0, 1, 1),
                      seed=0, verbose=False)
    assert len({t.config for t in res.trials}) == len(res.trials) == 3


def test_retrain_best_ae_honors_config(splits):
    import dataclasses

    from tpu21cmvae.tuner import LatentSearchSpace, SearchSpace, retrain_best, tune_autoencoder

    fast = TrainConfig(epochs=2, batch_size=64, learning_rate=1e-3,
                       early_stop_patience=None, plateau_patience=None)
    res = tune_autoencoder(
        splits, n_trials=1,
        space=LatentSearchSpace(min_layers=1, max_layers=1,
                                width_choices=(16,), latent_choices=(4,)),
        em_space=SearchSpace(min_layers=1, max_layers=1, width_choices=(12,)),
        ae_train_config=fast, em_train_config=fast, seed=0,
    )
    model = retrain_best(res, splits,
                         train_config=dataclasses.replace(fast, epochs=3))
    assert len(model.history["autoencoder"].loss) == 3  # config honored


def test_fisher_forecast_cache_is_bounded(splits):
    """Distinct per-bin noise specs must not pin unbounded compiled
    programs (LRU, cap 8 — mirrors serve.py's loglik cache)."""
    from tpu21cmvae.models.direct import DirectEmulator
    from tpu21cmvae.utils.config import DirectEmulatorConfig

    model = DirectEmulator(splits, config=DirectEmulatorConfig(hidden_dims=(8,)))
    theta = splits.par_test[0]
    for i in range(10):
        noise = np.full(splits.n_bins, 1.0 + 0.1 * i, np.float32)
        F, sig = model.fisher_forecast(theta, noise)
        assert np.isfinite(sig).all()
    assert len(model._fisher_cache) <= 8
    # the most recent spec is still cached (LRU evicts oldest first);
    # keys are value-identity via noise_key (float64 bytes)
    nk = np.asarray(noise, np.float64)
    assert (nk.shape, nk.tobytes()) in model._fisher_cache
