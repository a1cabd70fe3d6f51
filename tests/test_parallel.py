import jax
import jax.numpy as jnp
import numpy as np

from tpu21cmvae.models.direct import DirectEmulator
from tpu21cmvae.ops.mlp import init_mlp, mlp_apply
from tpu21cmvae.parallel import (
    ShardedEmulator,
    dp_fit,
    make_dp_train_step,
    make_mesh,
    replicate,
    shard_batch,
)
from tpu21cmvae.train.adam import adam_init
from tpu21cmvae.train.loop import fit
from tpu21cmvae.utils.config import TrainConfig


def test_virtual_mesh_has_8_devices():
    mesh = make_mesh()
    assert mesh.devices.size == 8, (
        "conftest must provide 8 virtual CPU devices"
    )


def test_sharded_predict_matches_single_device(splits):
    em = DirectEmulator(splits, seed=3)
    sharded = ShardedEmulator.for_model(em)
    raw = splits.par_test[:64]
    got = sharded(raw)
    expected = em.predict(raw)
    assert got.shape == expected.shape
    assert np.allclose(got, expected, atol=1e-5)


def test_sharded_predict_pads_ragged_batches(splits):
    em = DirectEmulator(splits, seed=3)
    sharded = ShardedEmulator.for_model(em)
    for n in (1, 7, 8, 13, 100):
        got = sharded(splits.par_test[:n])
        assert got.shape == ((451,) if n == 1 else (n, 451))
        # ragged sizes bucket to powers of two — same compiled program
    got1 = sharded(splits.par_test[0])
    assert got1.shape == (451,)
    assert np.allclose(got1, em.predict(splits.par_test[0]), atol=1e-5)


def test_dp_train_step_matches_single_device(splits, normalizer):
    mesh = make_mesh()
    cfg = TrainConfig()
    params = init_mlp(jax.random.key(0), (7, 32, 451))

    def loss_fn(p, x, y):
        return jnp.mean((mlp_apply(p, x) - y) ** 2, axis=-1)

    from tpu21cmvae.ops.transforms import par_transform, preproc

    x = par_transform(jnp.asarray(splits.par_train[:64], jnp.float32), normalizer)
    y = preproc(jnp.asarray(splits.signal_train[:64], jnp.float32), normalizer)

    # single-device step
    from tpu21cmvae.train.adam import adam_update

    def single_step(p, s, lr, bx, by):
        lv, g = jax.value_and_grad(lambda q: jnp.mean(loss_fn(q, bx, by)))(p)
        p, s = adam_update(g, p, s, lr)
        return p, s, lv

    p1, s1, l1 = single_step(params, adam_init(params), jnp.float32(0.01), x, y)

    dp_step = make_dp_train_step(loss_fn, cfg, mesh)
    p2, s2, l2 = dp_step(
        replicate(params, mesh),
        replicate(adam_init(params), mesh),
        jnp.float32(0.01),
        shard_batch(x, mesh),
        shard_batch(y, mesh),
    )
    assert np.allclose(float(l1), float(l2), rtol=1e-5)
    for a, b in zip(
        jax.tree_util.tree_leaves(p1), jax.tree_util.tree_leaves(p2)
    ):
        assert np.allclose(np.asarray(a), np.asarray(b), atol=1e-5)


def test_dp_fit_matches_single_device_fit(splits, normalizer):
    from tpu21cmvae.ops.transforms import par_transform, preproc

    mesh = make_mesh()
    cfg = TrainConfig(epochs=3, early_stop_patience=None, plateau_patience=None)
    params = init_mlp(jax.random.key(1), (7, 16, 451))

    def loss_fn(p, x, y):
        return jnp.mean((mlp_apply(p, x) - y) ** 2, axis=-1)

    x = par_transform(jnp.asarray(splits.par_train[:256], jnp.float32), normalizer)
    y = preproc(jnp.asarray(splits.signal_train[:256], jnp.float32), normalizer)
    xv = par_transform(jnp.asarray(splits.par_val[:64], jnp.float32), normalizer)
    yv = preproc(jnp.asarray(splits.signal_val[:64], jnp.float32), normalizer)

    p_single, _, h_single = fit(params, loss_fn, x, y, xv, yv, cfg)
    p_dp, _, h_dp = dp_fit(params, loss_fn, x, y, xv, yv, cfg, mesh)
    # same permutations (same cfg.seed) → same trajectories up to
    # reduction-order float noise
    assert np.allclose(h_single.loss, h_dp.loss, rtol=1e-4)
    for a, b in zip(
        jax.tree_util.tree_leaves(p_single), jax.tree_util.tree_leaves(p_dp)
    ):
        assert np.allclose(np.asarray(a), np.asarray(b), atol=1e-4)


def test_dp_fit_uneven_splits_match_single_device(splits, normalizer):
    """Split sizes that do NOT divide the mesh are padded + weight-masked;
    training must match the unpadded single-device run. 333/65 rows on an
    8-device mesh (neither divisible by 8)."""
    from tpu21cmvae.ops.transforms import par_transform, preproc

    mesh = make_mesh()
    cfg = TrainConfig(
        epochs=3, batch_size=64, learning_rate=0.003,
        early_stop_patience=None, plateau_patience=None,
    )
    params = init_mlp(jax.random.key(1), (7, 16, 451))

    def loss_fn(p, x, y):
        return jnp.mean((mlp_apply(p, x) - y) ** 2, axis=-1)

    x = par_transform(jnp.asarray(splits.par_train[:333], jnp.float32), normalizer)
    y = preproc(jnp.asarray(splits.signal_train[:333], jnp.float32), normalizer)
    xv = par_transform(jnp.asarray(splits.par_val[:65], jnp.float32), normalizer)
    yv = preproc(jnp.asarray(splits.signal_val[:65], jnp.float32), normalizer)

    p_single, _, h_single = fit(params, loss_fn, x, y, xv, yv, cfg)
    p_dp, _, h_dp = dp_fit(params, loss_fn, x, y, xv, yv, cfg, mesh)
    np.testing.assert_allclose(h_dp.loss, h_single.loss, rtol=1e-4)
    np.testing.assert_allclose(h_dp.val_loss, h_single.val_loss, rtol=1e-4)
    for a, b in zip(
        jax.tree_util.tree_leaves(p_single), jax.tree_util.tree_leaves(p_dp)
    ):
        np.testing.assert_allclose(np.asarray(a), np.asarray(b), atol=1e-4)


def test_dp_fit_all_pad_batch_is_noop(splits, normalizer):
    """126 rows at batch 63 on an 8-device mesh pads to 128 → a THIRD
    batch containing only padding. That batch must be an exact no-op
    (params, Adam moments, loss) so the run matches single-device."""
    from tpu21cmvae.ops.transforms import par_transform, preproc

    mesh = make_mesh()
    cfg = TrainConfig(
        epochs=2, batch_size=63, learning_rate=0.003,
        early_stop_patience=None, plateau_patience=None,
    )
    params = init_mlp(jax.random.key(2), (7, 16, 451))

    def loss_fn(p, x, y):
        return jnp.mean((mlp_apply(p, x) - y) ** 2, axis=-1)

    x = par_transform(jnp.asarray(splits.par_train[:126], jnp.float32), normalizer)
    y = preproc(jnp.asarray(splits.signal_train[:126], jnp.float32), normalizer)
    xv = par_transform(jnp.asarray(splits.par_val[:64], jnp.float32), normalizer)
    yv = preproc(jnp.asarray(splits.signal_val[:64], jnp.float32), normalizer)

    p_single, _, h_single = fit(params, loss_fn, x, y, xv, yv, cfg)
    p_dp, _, h_dp = dp_fit(params, loss_fn, x, y, xv, yv, cfg, mesh)
    np.testing.assert_allclose(h_dp.loss, h_single.loss, rtol=1e-5)
    for a, b in zip(
        jax.tree_util.tree_leaves(p_single), jax.tree_util.tree_leaves(p_dp)
    ):
        np.testing.assert_allclose(np.asarray(a), np.asarray(b), atol=1e-5)


def test_dp_fit_scan_real_dataset_split_sizes(normalizer):
    """The REAL 21cmGEM split sizes — 26,889 train / 1,704 val (reference
    ``sample_notebook.ipynb`` cell 19; total ≈30,000 per README.rst:11) —
    train data-parallel on the 8-device mesh without error and match the
    single-device device-resident trainer."""
    from tpu21cmvae.data import synthetic_dataset
    from tpu21cmvae.ops.transforms import par_transform, preproc
    from tpu21cmvae.parallel.train_dp import dp_fit_scan
    from tpu21cmvae.train.scan import fit_scan

    data = synthetic_dataset(n_train=26889, n_val=1704, n_test=8, seed=11)
    assert data.par_train.shape[0] % 8 != 0
    # 1,704 happens to divide 8 (it breaks on 16-device meshes); the
    # train axis is the uneven one here

    params = init_mlp(jax.random.key(0), (7, 8, 451))

    def loss_fn(p, x, y):
        return jnp.mean((mlp_apply(p, x) - y) ** 2, axis=-1)

    x = par_transform(jnp.asarray(data.par_train, jnp.float32), normalizer)
    y = preproc(jnp.asarray(data.signal_train, jnp.float32), normalizer)
    xv = par_transform(jnp.asarray(data.par_val, jnp.float32), normalizer)
    yv = preproc(jnp.asarray(data.signal_val, jnp.float32), normalizer)
    cfg = TrainConfig(
        epochs=2, learning_rate=0.003,
        early_stop_patience=None, plateau_patience=None,
    )

    mesh = make_mesh()
    p_dp, _, h_dp = dp_fit_scan(params, loss_fn, x, y, xv, yv, cfg, mesh)
    p_1, _, h_1 = fit_scan(params, loss_fn, x, y, xv, yv, cfg)
    np.testing.assert_allclose(h_dp.loss, h_1.loss, rtol=1e-4)
    np.testing.assert_allclose(h_dp.val_loss, h_1.val_loss, rtol=1e-4)
    for la, lb in zip(p_dp, p_1):
        np.testing.assert_allclose(
            np.asarray(la["w"]), np.asarray(lb["w"]), rtol=1e-4, atol=1e-5
        )


def test_sharded_emulator_ae_and_vae_families(splits):
    """ShardedEmulator.for_model works for every family via predict_fn +
    params (mesh-sharded mega-batch inference is family-agnostic)."""
    import numpy as np

    from tpu21cmvae.models.autoencoder import AutoEncoderEmulator
    from tpu21cmvae.models.vae import VAEEmulator
    from tpu21cmvae.parallel import ShardedEmulator
    from tpu21cmvae.utils.config import AutoEncoderConfig, VAEConfig

    small_ae = AutoEncoderConfig(
        latent_dim=4, enc_hidden_dims=(32,), dec_hidden_dims=(32,),
        em_hidden_dims=(24,),
    )
    small_vae = VAEConfig(
        latent_dim=4, enc_hidden_dims=(32,), dec_hidden_dims=(32,),
        em_hidden_dims=(24,),
    )
    for model in (
        AutoEncoderEmulator(splits, config=small_ae),
        VAEEmulator(splits, config=small_vae),
    ):
        sharded = ShardedEmulator.for_model(model)
        raw = np.asarray(splits.par_test[:33], np.float32)
        out = sharded(raw)
        assert out.shape == (33, splits.n_bins)
        np.testing.assert_allclose(out, model.predict(raw), rtol=1e-5, atol=1e-4)


def test_dp_fit_scan_multichip(splits, normalizer):
    """Device-resident DP training over the virtual 8-device mesh matches
    the single-device scan trainer."""
    import jax
    import jax.numpy as jnp
    import numpy as np

    from tpu21cmvae.ops.losses import relative_mse
    from tpu21cmvae.ops.mlp import init_mlp, mlp_apply
    from tpu21cmvae.ops.transforms import par_transform, preproc
    from tpu21cmvae.parallel.mesh import make_mesh
    from tpu21cmvae.parallel.train_dp import dp_fit_scan
    from tpu21cmvae.train.scan import fit_scan
    from tpu21cmvae.utils.config import TrainConfig

    params = init_mlp(jax.random.key(0), (7, 16, splits.n_bins))
    sm = normalizer.scaled_mean

    def loss_fn(p, x, y):
        return relative_mse(y, mlp_apply(p, x), sm)

    x = par_transform(jnp.asarray(splits.par_train[:256], jnp.float32), normalizer)
    y = preproc(jnp.asarray(splits.signal_train[:256], jnp.float32), normalizer)
    xv = par_transform(jnp.asarray(splits.par_val[:64], jnp.float32), normalizer)
    yv = preproc(jnp.asarray(splits.signal_val[:64], jnp.float32), normalizer)
    cfg = TrainConfig(
        epochs=3, batch_size=64, learning_rate=0.003,
        early_stop_patience=None, plateau_patience=None,
    )

    mesh = make_mesh()
    assert mesh.devices.size == 8
    p_dp, _, h_dp = dp_fit_scan(params, loss_fn, x, y, xv, yv, cfg, mesh)
    p_1, _, h_1 = fit_scan(params, loss_fn, x, y, xv, yv, cfg)
    np.testing.assert_allclose(h_dp.loss, h_1.loss, rtol=1e-5)
    for la, lb in zip(p_dp, p_1):
        np.testing.assert_allclose(
            np.asarray(la["w"]), np.asarray(lb["w"]), rtol=1e-5, atol=1e-6
        )


def test_sharded_emulator_device_call(splits):
    """Zero-copy device path: no padding, batch divisible by mesh size."""
    import jax
    import jax.numpy as jnp
    import numpy as np

    from tpu21cmvae.models.direct import DirectEmulator
    from tpu21cmvae.parallel import ShardedEmulator
    from tpu21cmvae.parallel.mesh import shard_batch
    from tpu21cmvae.utils.config import DirectEmulatorConfig

    model = DirectEmulator(splits, config=DirectEmulatorConfig(hidden_dims=(16,)))
    sharded = ShardedEmulator.for_model(model)
    raw = shard_batch(
        jnp.asarray(splits.par_test[:16], jnp.float32), sharded.mesh
    )
    out = sharded.device_call(raw)
    assert isinstance(out, jax.Array) and out.shape == (16, splits.n_bins)
    np.testing.assert_allclose(
        np.asarray(out), model.predict(splits.par_test[:16]), rtol=1e-5, atol=1e-4
    )


def test_sharded_emulator_warmup_precompiles(splits):
    """warmup() covers the buckets later calls hit — results stay correct
    across several batch sizes."""
    import numpy as np

    from tpu21cmvae.models.direct import DirectEmulator
    from tpu21cmvae.parallel import ShardedEmulator
    from tpu21cmvae.utils.config import DirectEmulatorConfig

    model = DirectEmulator(splits, config=DirectEmulatorConfig(hidden_dims=(16,)))
    sharded = ShardedEmulator.for_model(model)
    sharded.warmup([5, 17, 40])
    for n in (5, 17, 40):
        out = sharded(np.asarray(splits.par_test[:n], np.float32))
        assert out.shape == (n, splits.n_bins)


def test_sharded_loglik_matches_single_device(splits):
    """The fused likelihood is shard-transparent: batch-sharded walkers
    with replicated weights give the same (B,) log-likelihoods as the
    unsharded call — the multi-chip MCMC inner loop (SURVEY.md §2.3)."""
    em = DirectEmulator(splits, seed=5)
    obs = jnp.asarray(
        em.predict(splits.par_test[0])
        + np.random.default_rng(9).normal(0, 5.0, splits.n_bins),
        jnp.float32,
    )
    mesh = make_mesh()
    weights = replicate(em.params, mesh)
    raw = jnp.asarray(splits.par_test[:64], jnp.float32)
    for method in ("direct", "gram"):
        fn = em.loglik_fn(obs, 25.0, method=method)
        want = np.asarray(fn(em.params, raw))
        got = fn(weights, shard_batch(raw, mesh))
        assert got.sharding.spec == shard_batch(raw, mesh).sharding.spec
        np.testing.assert_allclose(np.asarray(got), want, rtol=1e-5)


def test_sharded_emulator_wraps_loglik(splits):
    """ShardedEmulator accepts ANY (weights, raw)->out function — wrap
    the fused likelihood for host-side samplers (ragged batches padded
    to buckets, (B,) output)."""
    em = DirectEmulator(splits, seed=5)
    obs = jnp.asarray(
        em.predict(splits.par_test[0])
        + np.random.default_rng(9).normal(0, 5.0, splits.n_bins),
        jnp.float32,
    )
    fn = em.loglik_fn(obs, 25.0)
    sharded = ShardedEmulator(fn, em.params)
    raw = splits.par_test[:13]
    got = sharded(raw)
    want = np.asarray(fn(em.params, jnp.asarray(raw, jnp.float32)))
    assert got.shape == (13,)
    np.testing.assert_allclose(got, want, rtol=1e-5)
    one = sharded(splits.par_test[0])
    assert np.ndim(one) == 0 or np.shape(one) == ()  # single-row squeeze


def test_ensemble_member_sharded_training_matches_unsharded(splits):
    """Seed/ensemble parallelism: fit_scan_stack with the member axis
    sharded over the 8-device mesh produces the same weights as the
    unsharded vmapped run (each device trains its member locally; the
    program has no cross-member collectives to get wrong)."""
    from tpu21cmvae.models.ensemble import DeepEnsemble
    from tpu21cmvae.utils.config import DirectEmulatorConfig

    cfg = DirectEmulatorConfig(hidden_dims=(16,))
    tc = TrainConfig(epochs=4, early_stop_patience=None,
                     plateau_patience=None)
    seeds = list(range(8))
    plain = DeepEnsemble.train(splits, n_members=8, config=cfg,
                               train_config=tc, seeds=seeds, parallel=True)
    meshed = DeepEnsemble.train(splits, n_members=8, config=cfg,
                                train_config=tc, seeds=seeds, parallel=True,
                                mesh=make_mesh())
    for mp, ms in zip(meshed.members, plain.members):
        np.testing.assert_allclose(mp.history.loss, ms.history.loss,
                                   rtol=1e-6)
        for lp, ls in zip(mp.params, ms.params):
            np.testing.assert_allclose(np.asarray(lp["w"]),
                                       np.asarray(ls["w"]),
                                       rtol=1e-6, atol=1e-7)
