"""Tuner tests: small random searches on the synthetic dataset.

The reference's tuner is advertised but absent (reference ``README.rst:13``,
``.gitignore:14``), so there is no reference test to mirror; these pin the
search contract: deterministic sampling, ranked results, dedup of repeated
architectures, and a retrainable winner.
"""

import dataclasses

import numpy as np
import pytest

from tpu21cmvae.tuner import (
    LatentSearchSpace,
    SearchSpace,
    TuneResult,
    retrain_best,
    tune_autoencoder,
    tune_direct,
)
from tpu21cmvae.utils.config import DirectEmulatorConfig, TrainConfig

FAST = TrainConfig(
    epochs=8, early_stop_patience=None, plateau_patience=None, learning_rate=0.005
)


def test_search_space_sampling():
    space = SearchSpace(min_layers=2, max_layers=4, width_choices=(32, 64))
    rng = np.random.default_rng(0)
    for _ in range(20):
        dims = space.sample(rng)
        assert 2 <= len(dims) <= 4
        assert all(w in (32, 64) for w in dims)


def test_tune_direct_ranks_trials(splits):
    res = tune_direct(
        splits,
        n_trials=3,
        space=SearchSpace(min_layers=1, max_layers=2, width_choices=(24, 32, 48)),
        train_config=FAST,
        seed=0,
    )
    assert isinstance(res, TuneResult)
    assert 1 <= len(res.trials) <= 3  # dedup may drop repeats
    errs = [t.val_error for t in res.trials]
    assert errs == sorted(errs)
    assert all(np.isfinite(e) for e in errs)
    best = res.best
    assert isinstance(best.config, DirectEmulatorConfig)
    assert best.weight_count > 0 and best.epochs_ran == FAST.epochs
    assert "val_err" in res.leaderboard()


def test_tune_is_deterministic(splits):
    kw = dict(
        n_trials=2,
        space=SearchSpace(min_layers=1, max_layers=1, width_choices=(24, 40)),
        train_config=FAST,
        seed=3,
    )
    a = tune_direct(splits, **kw)
    b = tune_direct(splits, **kw)
    assert [t.config for t in a.trials] == [t.config for t in b.trials]
    assert np.allclose(
        [t.val_error for t in a.trials], [t.val_error for t in b.trials]
    )


def test_retrain_best_direct(splits):
    res = tune_direct(
        splits,
        n_trials=1,
        space=SearchSpace(min_layers=1, max_layers=1, width_choices=(32,)),
        train_config=FAST,
        seed=1,
    )
    model = retrain_best(
        res, splits, train_config=dataclasses.replace(FAST, epochs=4)
    )
    assert model.config == res.best.config
    pred = model.predict(splits.par_test[:3])
    assert pred.shape == (3, splits.n_bins)


def test_retrain_best_multi_seed_picks_best_val(splits):
    """n_seeds>1 trains the replicas in ONE vmapped program and returns
    the seed with the lowest validation loss."""
    res = tune_direct(
        splits,
        n_trials=1,
        space=SearchSpace(min_layers=1, max_layers=1, width_choices=(32,)),
        train_config=FAST,
        seed=1,
    )
    tc = dataclasses.replace(FAST, epochs=4)
    best = retrain_best(res, splits, train_config=tc, seed=0, n_seeds=3)
    assert best.config == res.best.config
    singles = [
        retrain_best(res, splits, train_config=tc, seed=s) for s in range(3)
    ]
    want = min(min(m.history.val_loss) for m in singles)
    got = min(best.history.val_loss)
    np.testing.assert_allclose(got, want, rtol=1e-5)


def test_tune_autoencoder_runs(splits):
    res = tune_autoencoder(
        splits,
        n_trials=2,
        space=LatentSearchSpace(
            min_layers=1, max_layers=1, width_choices=(32,), latent_choices=(4, 6)
        ),
        em_space=SearchSpace(min_layers=1, max_layers=1, width_choices=(24,)),
        ae_train_config=FAST,
        em_train_config=FAST,
        seed=0,
    )
    assert len(res.trials) >= 1
    assert all(np.isfinite(t.val_error) for t in res.trials)
    assert res.best.config.latent_dim in (4, 6)


def test_tune_direct_halving(splits):
    from tpu21cmvae.tuner import tune_direct_halving

    res = tune_direct_halving(
        splits,
        n_initial=4,
        rungs=2,
        eta=2,
        rung_epochs=3,
        space=SearchSpace(min_layers=1, max_layers=2, width_choices=(16, 24, 32)),
        train_config=FAST,
        seed=0,
    )
    # 4 start, halved once → 2 finalists, each trained 2 rungs = 6 epochs
    assert len(res.trials) == 2
    assert all(t.epochs_ran == 6 for t in res.trials)
    errs = [t.val_error for t in res.trials]
    assert errs == sorted(errs) and np.isfinite(errs).all()


def test_tune_direct_halving_deterministic(splits):
    from tpu21cmvae.tuner import tune_direct_halving

    kw = dict(
        n_initial=3, rungs=2, eta=2, rung_epochs=2,
        space=SearchSpace(min_layers=1, max_layers=1, width_choices=(16, 24, 32)),
        train_config=FAST, seed=5,
    )
    a = tune_direct_halving(splits, **kw)
    b = tune_direct_halving(splits, **kw)
    assert [t.config for t in a.trials] == [t.config for t in b.trials]
    assert np.allclose([t.val_error for t in a.trials],
                       [t.val_error for t in b.trials])


def test_tune_direct_halving_device_loop(splits):
    from tpu21cmvae.tuner import tune_direct_halving

    res = tune_direct_halving(
        splits, n_initial=2, rungs=2, eta=2, rung_epochs=2,
        space=SearchSpace(min_layers=1, max_layers=1, width_choices=(16, 24)),
        train_config=FAST, seed=0, device_loop=True,
    )
    assert len(res.trials) == 1 and res.trials[0].epochs_ran == 4


def test_tune_vae_runs_and_ranks(splits):
    from tpu21cmvae.tuner import VAESearchSpace, tune_vae
    from tpu21cmvae.utils.config import VAEConfig

    res = tune_vae(
        splits,
        n_trials=2,
        space=VAESearchSpace(
            min_layers=1, max_layers=1, width_choices=(24,),
            latent_choices=(4, 6), beta_choices=(1e-4, 1e-3),
        ),
        em_space=SearchSpace(min_layers=1, max_layers=1, width_choices=(16,)),
        vae_train_config=FAST,
        em_train_config=FAST,
        kl_anneal_epochs=2,
        seed=0,
    )
    assert 1 <= len(res.trials) <= 2
    assert all(np.isfinite(t.val_error) for t in res.trials)
    best = res.best
    assert isinstance(best.config, VAEConfig)
    assert best.config.beta in (1e-4, 1e-3)
    assert best.weight_count > 0
    # beta shows up in the leaderboard via the config repr
    assert "beta" in res.leaderboard()


def test_tune_vae_weight_count_exact(splits):
    """_vae_weight_count matches the actual parameter pytree."""
    import jax

    from tpu21cmvae.models.vae import VAE
    from tpu21cmvae.tuner import _vae_weight_count
    from tpu21cmvae.utils.config import VAEConfig

    cfg = VAEConfig(latent_dim=4, enc_hidden_dims=(24, 16),
                    dec_hidden_dims=(12,), em_hidden_dims=(8,))
    vae = VAE(cfg, seed=0)
    n_vae = sum(x.size for x in jax.tree_util.tree_leaves(vae.params))
    n_em = cfg.emulator().weight_count
    assert _vae_weight_count(cfg) == n_vae + n_em


def test_tune_vae_halving(splits):
    from tpu21cmvae.tuner import VAESearchSpace, tune_vae_halving

    res = tune_vae_halving(
        splits, n_initial=4, rungs=2, eta=2, rung_epochs=2,
        space=VAESearchSpace(
            min_layers=1, max_layers=1, width_choices=(16, 24),
            latent_choices=(4, 6), beta_choices=(1e-4,),
        ),
        em_space=SearchSpace(min_layers=1, max_layers=1, width_choices=(12,)),
        seed=0, device_loop=True,
    )
    assert len(res.trials) == 2
    assert all(t.epochs_ran == 8 for t in res.trials)
    errs = [t.val_error for t in res.trials]
    assert errs == sorted(errs) and np.isfinite(errs).all()


def test_retrain_best_vae(splits):
    """retrain_best dispatches VAEConfig to the VAE family (it subclasses
    AutoEncoderConfig, so the isinstance order matters)."""
    from tpu21cmvae.models.vae import VAEEmulator
    from tpu21cmvae.tuner import Trial, TuneResult, retrain_best
    from tpu21cmvae.utils.config import VAEConfig

    cfg = VAEConfig(latent_dim=4, enc_hidden_dims=(16,),
                    dec_hidden_dims=(16,), em_hidden_dims=(12,),
                    kl_anneal_epochs=0)
    res = TuneResult([Trial(cfg, 1.0, 1.0, 2, 0.1, 123)])
    model = retrain_best(res, splits, train_config=FAST)
    assert isinstance(model, VAEEmulator)
    assert model.predict(splits.par_test[:2]).shape == (2, splits.n_bins)


def test_tune_direct_halving_exhausted_space(splits):
    """A space with fewer unique architectures than n_initial must
    terminate (the sampling loop previously spun forever once the space
    was exhausted) and proceed with the uniques it found."""
    from tpu21cmvae.tuner import tune_direct_halving

    res = tune_direct_halving(
        splits, n_initial=4, rungs=1, eta=2, rung_epochs=2,
        space=SearchSpace(min_layers=1, max_layers=1, width_choices=(16,)),
        train_config=FAST, seed=0,
    )
    assert len(res.trials) == 1
    assert res.trials[0].config.hidden_dims == (16,)


def test_tune_autoencoder_halving(splits):
    from tpu21cmvae.tuner import LatentSearchSpace, tune_autoencoder_halving

    res = tune_autoencoder_halving(
        splits, n_initial=4, rungs=2, eta=2, rung_epochs=2,
        space=LatentSearchSpace(min_layers=1, max_layers=1,
                                width_choices=(16, 24), latent_choices=(4, 6)),
        em_space=SearchSpace(min_layers=1, max_layers=1, width_choices=(12,)),
        seed=0, device_loop=True,
    )
    assert len(res.trials) == 2
    assert all(t.epochs_ran == 8 for t in res.trials)  # 2 rungs × 2 stages × 2
    errs = [t.val_error for t in res.trials]
    assert errs == sorted(errs) and np.isfinite(errs).all()


def test_best_efficient_prefers_cheaper_mxu_within_slack():
    """Throughput-aware selection: within the accuracy slack the
    cheapest padded trial wins; outside it, accuracy rules."""
    from tpu21cmvae.tuner import Trial, TuneResult
    from tpu21cmvae.utils.config import DirectEmulatorConfig

    ref = Trial(DirectEmulatorConfig(), 0.160, 0.0, 10, 1.0, 371907)
    ali = Trial(
        DirectEmulatorConfig(hidden_dims=(256, 384, 256, 128)),
        0.170, 0.0, 10, 1.0, 300000,
    )
    # the reference stack pays ~78% more padded work than the
    # aligned one (288->384, 352->384, 224->256 at a 128-wide tile)
    assert ref.padded_flops_per_row > 1.7 * ali.padded_flops_per_row
    res = TuneResult([ref, ali])
    assert res.best is ref
    assert res.best_efficient(slack=0.10) is ali
    assert res.best_efficient(slack=0.01) is ref
    with pytest.raises(ValueError):
        res.best_efficient(slack=-0.1)


def test_mxu_aligned_space_samples_are_tile_exact():
    from tpu21cmvae.tuner import MXU_ALIGNED_SPACE

    rng = np.random.default_rng(3)
    for _ in range(20):
        stack = MXU_ALIGNED_SPACE.sample(rng)
        assert all(w % 128 == 0 for w in stack)
        assert 3 <= len(stack) <= 5
