"""Checkpoint/resume tests: a resumed run must be bit-compatible with an
uninterrupted one (SURVEY.md §5 — the preemption story the
reference lacks entirely; its ``save`` raises ``NotImplementedError``,
reference ``emulator.py:441-442``)."""

import dataclasses
import os

import jax
import jax.numpy as jnp
import numpy as np

from tpu21cmvae.ops.losses import relative_mse
from tpu21cmvae.ops.mlp import init_mlp, mlp_apply
from tpu21cmvae.ops.transforms import par_transform, preproc
from tpu21cmvae.train.loop import fit, latest_checkpoint
from tpu21cmvae.utils.config import TrainConfig


def _setup(splits, normalizer):
    params = init_mlp(jax.random.key(0), (7, 24, splits.n_bins))
    sm = normalizer.scaled_mean

    def loss_fn(p, x, y):
        return relative_mse(y, mlp_apply(p, x), sm)

    x = par_transform(jnp.asarray(splits.par_train[:200], jnp.float32), normalizer)
    y = preproc(jnp.asarray(splits.signal_train[:200], jnp.float32), normalizer)
    xv = par_transform(jnp.asarray(splits.par_val[:64], jnp.float32), normalizer)
    yv = preproc(jnp.asarray(splits.signal_val[:64], jnp.float32), normalizer)
    return params, loss_fn, x, y, xv, yv


CFG8 = TrainConfig(
    epochs=8,
    batch_size=64,
    learning_rate=0.003,
    early_stop_patience=None,
    plateau_patience=2,
    plateau_factor=0.5,
    plateau_min_delta=10.0,  # force reductions so LR state is exercised
    plateau_min_lr=1e-4,
)


def test_checkpoint_files_written(tmp_path, splits, normalizer):
    params, loss_fn, x, y, xv, yv = _setup(splits, normalizer)
    ckpt = str(tmp_path / "ck")
    fit(
        params, loss_fn, x, y, xv, yv,
        dataclasses.replace(CFG8, epochs=5),
        checkpoint_dir=ckpt, checkpoint_every=2,
    )
    names = sorted(os.listdir(ckpt))
    # epochs are 0-indexed: saves after epochs 1, 3 (every 2) and 4 (final)
    assert names == ["ckpt_000001.npz", "ckpt_000003.npz", "ckpt_000004.npz"]
    assert latest_checkpoint(ckpt).endswith("ckpt_000004.npz")


def test_resume_matches_uninterrupted_run(tmp_path, splits, normalizer):
    params, loss_fn, x, y, xv, yv = _setup(splits, normalizer)

    # uninterrupted 8-epoch run
    pa, _, ha = fit(params, loss_fn, x, y, xv, yv, CFG8)

    # interrupted: 4 epochs with checkpoints, then resume to 8
    ckpt = str(tmp_path / "ck")
    fit(
        params, loss_fn, x, y, xv, yv,
        dataclasses.replace(CFG8, epochs=4),
        checkpoint_dir=ckpt, checkpoint_every=100,  # only the final save
    )
    pb, _, hb = fit(
        params, loss_fn, x, y, xv, yv, CFG8,
        checkpoint_dir=ckpt, resume=True,
    )

    assert len(hb.loss) == len(ha.loss) == 8
    np.testing.assert_allclose(hb.loss, ha.loss, rtol=1e-6)
    np.testing.assert_allclose(hb.lr, ha.lr, rtol=0)
    for la, lb in zip(pa, pb):
        np.testing.assert_allclose(la["w"], lb["w"], rtol=1e-6, atol=1e-7)


def test_resume_with_early_stop_state(tmp_path, splits, normalizer):
    params, loss_fn, x, y, xv, yv = _setup(splits, normalizer)
    cfg = dataclasses.replace(
        CFG8, early_stop_patience=3, early_stop_min_delta=0.0
    )
    pa, _, ha = fit(params, loss_fn, x, y, xv, yv, cfg)

    ckpt = str(tmp_path / "ck")
    fit(
        params, loss_fn, x, y, xv, yv,
        dataclasses.replace(cfg, epochs=4),
        checkpoint_dir=ckpt, checkpoint_every=100,
    )
    pb, _, hb = fit(
        params, loss_fn, x, y, xv, yv, cfg, checkpoint_dir=ckpt, resume=True
    )
    np.testing.assert_allclose(hb.loss, ha.loss, rtol=1e-6)
    assert hb.stopped_epoch == ha.stopped_epoch
    assert hb.best_epoch == ha.best_epoch


def test_resume_after_early_stop_restores_best_epoch(
    tmp_path, splits, normalizer
):
    """Resuming a run that already early-stopped must report the same
    best_epoch as the uninterrupted run (the checkpoint is written before
    best_epoch is assigned, so it must be recovered from the restored
    EarlyStopping state, not the checkpointed None)."""
    params, loss_fn, x, y, xv, yv = _setup(splits, normalizer)
    cfg = dataclasses.replace(
        CFG8, epochs=20, early_stop_patience=2, early_stop_min_delta=10.0
    )  # huge min_delta: stops at epoch 2 with best_epoch 0
    ckpt = str(tmp_path / "ck")
    pa, _, ha = fit(
        params, loss_fn, x, y, xv, yv, cfg,
        checkpoint_dir=ckpt, checkpoint_every=100,
    )
    assert ha.stopped_epoch is not None and ha.best_epoch is not None
    pb, _, hb = fit(
        params, loss_fn, x, y, xv, yv, cfg, checkpoint_dir=ckpt, resume=True
    )
    assert hb.stopped_epoch == ha.stopped_epoch
    assert hb.best_epoch == ha.best_epoch
    for la, lb in zip(pa, pb):
        np.testing.assert_allclose(la["w"], lb["w"], rtol=0)


def test_resume_after_completion_is_noop(tmp_path, splits, normalizer):
    params, loss_fn, x, y, xv, yv = _setup(splits, normalizer)
    cfg = dataclasses.replace(CFG8, epochs=3)
    ckpt = str(tmp_path / "ck")
    pa, _, ha = fit(
        params, loss_fn, x, y, xv, yv, cfg, checkpoint_dir=ckpt
    )
    pb, _, hb = fit(
        params, loss_fn, x, y, xv, yv, cfg, checkpoint_dir=ckpt, resume=True
    )
    assert hb.loss == ha.loss
    for la, lb in zip(pa, pb):
        np.testing.assert_allclose(la["w"], lb["w"], rtol=0)


def test_resume_without_checkpoint_trains_fresh(tmp_path, splits, normalizer):
    params, loss_fn, x, y, xv, yv = _setup(splits, normalizer)
    cfg = dataclasses.replace(CFG8, epochs=2)
    pa, _, ha = fit(
        params, loss_fn, x, y, xv, yv, cfg,
        checkpoint_dir=str(tmp_path / "empty"), resume=True,
    )
    assert len(ha.loss) == 2


def test_model_train_checkpoint_kwargs(tmp_path, splits):
    from tpu21cmvae.models.direct import DirectEmulator
    from tpu21cmvae.utils.config import DirectEmulatorConfig

    model = DirectEmulator(splits, config=DirectEmulatorConfig(hidden_dims=(16,)))
    ckpt = str(tmp_path / "ck")
    cfg = TrainConfig(epochs=3, early_stop_patience=None, plateau_patience=None)
    model.train(train_config=cfg, checkpoint_dir=ckpt)
    assert latest_checkpoint(ckpt) is not None

def test_ae_two_stage_checkpoint_resume(tmp_path, splits):
    """A restart after stage A completed resumes stage A as a no-op and
    stage B from its checkpoint, matching the uninterrupted two-stage run."""
    from tpu21cmvae.models.autoencoder import AutoEncoderEmulator
    from tpu21cmvae.utils.config import AutoEncoderConfig

    small = AutoEncoderConfig(
        latent_dim=4, enc_hidden_dims=(24,), dec_hidden_dims=(24,),
        em_hidden_dims=(16,),
    )
    cfg = TrainConfig(
        epochs=4, batch_size=64, learning_rate=1e-3,
        early_stop_patience=None, plateau_patience=None,
    )

    a = AutoEncoderEmulator(splits, config=small, seed=0)
    a.train(ae_train_config=cfg, em_train_config=cfg)

    ckpt = str(tmp_path / "ck")
    b = AutoEncoderEmulator(splits, config=small, seed=0)
    b.train(ae_train_config=cfg, em_train_config=cfg, checkpoint_dir=ckpt)
    assert os.path.isdir(os.path.join(ckpt, "stage_ae"))
    assert os.path.isdir(os.path.join(ckpt, "stage_em"))

    # fresh model resumes entirely from checkpoints: same final state
    c = AutoEncoderEmulator(splits, config=small, seed=0)
    c.train(
        ae_train_config=cfg, em_train_config=cfg,
        checkpoint_dir=ckpt, resume=True,
    )
    np.testing.assert_allclose(
        c.predict(splits.par_test[:5]), a.predict(splits.par_test[:5]),
        rtol=1e-5, atol=1e-4,
    )


def test_checkpoint_rotation(tmp_path, splits, normalizer):
    """Only the newest `checkpoint_keep` files survive; resume still works
    from the newest one."""
    params, loss_fn, x, y, xv, yv = _setup(splits, normalizer)
    ckpt = str(tmp_path / "ck")
    cfg = dataclasses.replace(CFG8, epochs=6)
    fit(
        params, loss_fn, x, y, xv, yv, cfg,
        checkpoint_dir=ckpt, checkpoint_every=1, checkpoint_keep=2,
    )
    names = sorted(os.listdir(ckpt))
    assert names == ["ckpt_000004.npz", "ckpt_000005.npz"]
    pb, _, hb = fit(
        params, loss_fn, x, y, xv, yv, cfg, checkpoint_dir=ckpt, resume=True
    )
    assert len(hb.loss) == 6  # restored complete history, no-op continue
