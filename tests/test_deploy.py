"""Deployment artifacts (`tpu21cmvae.deploy`): jax.export round trips.

The contract under test: a saved artifact is SELF-CONTAINED (weights and
normalization folded in — no checkpoint, dataset, or model object at call
time), batch-POLYMORPHIC (one export serves every batch size), and
reproduces the in-process jitted programs (bit-exact for predict and the
direct-method likelihood; the gram likelihood to float32 reduction-order
tolerance — measured ~2e-6 relative, see deploy module docstring).
"""

import numpy as np
import pytest

import jax

from tpu21cmvae import deploy
from tpu21cmvae.models.autoencoder import AutoEncoderEmulator
from tpu21cmvae.models.direct import DirectEmulator
from tpu21cmvae.models.ensemble import DeepEnsemble
from tpu21cmvae.utils.config import AutoEncoderConfig, DirectEmulatorConfig

TINY = DirectEmulatorConfig(hidden_dims=(16, 16))


@pytest.fixture(scope="module")
def direct(normalizer):
    return DirectEmulator(normalizer=normalizer, config=TINY, seed=3)


def test_predict_artifact_roundtrip(tmp_path, direct, rng):
    path = deploy.save_predict_artifact(direct, str(tmp_path / "em.bin"))
    fn = deploy.load_artifact(path)
    # lowered for serving on a GPU even though this process is CPU-only
    assert set(fn.platforms) == {"cpu", "cuda"}
    assert fn.n_in == 7
    # symbolic batch: one artifact, several batch sizes, no re-export
    n_bins = direct.normalizer.signal_mean.shape[-1]
    for n in (1, 5, 13):
        raw = rng.uniform(0.2, 0.8, (n, 7)).astype(np.float32)
        got = fn(raw)
        want = direct.predict(raw)
        # 2-D input is never squeezed, so this holds for n == 1 too
        assert got.shape == (n, n_bins)
        np.testing.assert_allclose(got, np.atleast_2d(want), atol=1e-3)


def test_default_platforms_lower_for_gpu_and_replay_here(tmp_path, direct):
    """Defaults lower for cpu + cuda with no GPU attached, and the same
    artifact replays on this (CPU) host."""
    assert deploy.DEFAULT_PLATFORMS == ("cpu", "cuda")
    fn = deploy.load_artifact(
        deploy.save_predict_artifact(direct, str(tmp_path / "em.bin"))
    )
    assert fn.platforms == deploy.DEFAULT_PLATFORMS
    raw = np.full((2, 7), 0.5, np.float32)
    np.testing.assert_array_equal(fn(raw), direct.predict(raw))


def test_single_row_squeeze_convention(tmp_path, direct):
    path = deploy.save_predict_artifact(direct, str(tmp_path / "em.bin"))
    fn = deploy.load_artifact(path)
    row = np.full((7,), 0.5, np.float32)
    out = fn(row)
    assert out.shape == (451,)
    np.testing.assert_allclose(out, direct.predict(row), atol=1e-3)


def test_loglik_artifact_matches_fused_loglik(tmp_path, direct, rng):
    obs = np.asarray(direct.predict(np.full((7,), 0.5, np.float32)))
    raw = rng.uniform(0.2, 0.8, (9, 7)).astype(np.float32)
    # direct method: same graph, but the recompiled artifact may order
    # the 451-bin residual reduction differently → f32 rounding-level
    # relative tolerance, not bit-exactness
    path = deploy.save_loglik_artifact(
        direct, str(tmp_path / "ll_d.bin"), obs, 1e-2, method="direct"
    )
    want = np.asarray(
        direct.loglik_fn(obs, 1e-2, method="direct")(direct.params, raw)
    )
    got = deploy.load_artifact(path)(raw)
    assert got.shape == (9,)
    np.testing.assert_allclose(got, want, rtol=1e-5)
    # gram method: the recompiled quadratic form may sum in a different
    # order — float32 reduction-order tolerance, not exactness (random
    # tiny weights are the cancellation-hostile worst case; the shipped
    # trained checkpoint measures ~2e-6 relative)
    path = deploy.save_loglik_artifact(
        direct, str(tmp_path / "ll_g.bin"), obs, 1e-2
    )
    want = np.asarray(direct.loglik_fn(obs, 1e-2)(direct.params, raw))
    np.testing.assert_allclose(
        deploy.load_artifact(path)(raw), want, rtol=2e-3
    )


def test_valgrad_artifact_matches_fused_valgrad(tmp_path, direct, rng):
    """The (logL, grad) tuple artifact: structure survives serialization
    and both leaves match the in-process fused value+gradient program to
    reduction-order tolerance."""
    obs = np.asarray(direct.predict(np.full((7,), 0.5, np.float32)))
    raw = rng.uniform(0.2, 0.8, (6, 7)).astype(np.float32)
    path = deploy.save_valgrad_artifact(
        direct, str(tmp_path / "vg.bin"), obs, 1e-2
    )
    fn = deploy.load_artifact(path)
    got_v, got_g = fn(raw)
    want_v, want_g = direct.loglik_and_grad_fn(obs, 1e-2)(
        direct.params, raw
    )
    assert got_v.shape == (6,) and got_g.shape == (6, 7)
    np.testing.assert_allclose(got_v, np.asarray(want_v), rtol=2e-3)
    scale = float(np.max(np.abs(np.asarray(want_g))))
    np.testing.assert_allclose(
        got_g, np.asarray(want_g), rtol=1e-3, atol=1e-4 * scale
    )
    # single-row squeeze applies leaf-wise to the tuple
    v1, g1 = fn(raw[0])
    assert v1.shape == () and g1.shape == (7,)


def test_two_stage_family_exports(tmp_path, normalizer, rng):
    cfg = AutoEncoderConfig(
        latent_dim=3, enc_hidden_dims=(8,), dec_hidden_dims=(8,),
        em_hidden_dims=(8,),
    )
    ae = AutoEncoderEmulator(normalizer=normalizer, config=cfg, seed=5)
    path = deploy.save_predict_artifact(ae, str(tmp_path / "ae.bin"))
    fn = deploy.load_artifact(path)
    raw = rng.uniform(0.2, 0.8, (4, 7)).astype(np.float32)
    np.testing.assert_allclose(fn(raw), ae.predict(raw), atol=1e-3)


def test_ensemble_exports_mean_prediction(tmp_path, normalizer, rng):
    members = [
        DirectEmulator(normalizer=normalizer, config=TINY, seed=s)
        for s in (0, 1)
    ]
    ens = DeepEnsemble(members)
    path = deploy.save_predict_artifact(ens, str(tmp_path / "ens.bin"))
    fn = deploy.load_artifact(path)
    raw = rng.uniform(0.2, 0.8, (4, 7)).astype(np.float32)
    np.testing.assert_allclose(fn(raw), ens.predict(raw), atol=1e-3)


def test_precision_tier_forwarding(tmp_path, direct, rng):
    # HIGH-tier export runs and stays near the HIGHEST-tier artifact
    # (identical on CPU, where every tier is f32)
    path = deploy.save_predict_artifact(
        direct, str(tmp_path / "hi.bin"), precision=jax.lax.Precision.HIGH
    )
    fn = deploy.load_artifact(path)
    raw = rng.uniform(0.2, 0.8, (3, 7)).astype(np.float32)
    np.testing.assert_allclose(fn(raw), direct.predict(raw), atol=1e-3)


def test_cli_export_artifact(tmp_path, direct, rng):
    from tpu21cmvae.__main__ import main

    ckpt = str(tmp_path / "model.npz")
    direct.save(ckpt)
    out = str(tmp_path / "deploy.bin")
    main(["export-artifact", ckpt, "--out", out])
    fn = deploy.load_artifact(out)
    raw = rng.uniform(0.2, 0.8, (3, 7)).astype(np.float32)
    np.testing.assert_allclose(fn(raw), direct.predict(raw), atol=1e-3)

    # loglik variant through the serve obs-spec file format
    obs = np.asarray(direct.predict(np.full((7,), 0.5, np.float32)))
    spec = str(tmp_path / "obs.npz")
    np.savez(spec, obs=obs, noise_var=np.float32(1e-2))
    ll_out = str(tmp_path / "ll.bin")
    main(["export-artifact", ckpt, "--obs", spec, "--out", ll_out])
    llfn = deploy.load_artifact(ll_out)
    want = np.asarray(direct.loglik_fn(obs, 1e-2)(direct.params, raw))
    np.testing.assert_allclose(llfn(raw), want, rtol=2e-3)

    # --valgrad without --obs is a usage error, not a crash
    assert main(["export-artifact", ckpt, "--valgrad"]) == 2
    # --valgrad with --obs exports the (logL, grad) pair
    vg_out = str(tmp_path / "vg.bin")
    main(["export-artifact", ckpt, "--obs", spec, "--out", vg_out,
          "--valgrad"])
    v, g = deploy.load_artifact(vg_out)(raw)
    assert v.shape == (3,) and g.shape == (3, 7)


def test_artifact_calls_without_model_state(tmp_path, normalizer, rng):
    """The artifact must not depend on live model/python state: export,
    drop the model, deserialize from raw bytes in a fresh Exported."""
    model = DirectEmulator(normalizer=normalizer, config=TINY, seed=11)
    raw = rng.uniform(0.2, 0.8, (3, 7)).astype(np.float32)
    want = model.predict(raw)
    blob = deploy.export_predict(model).serialize()
    del model
    from jax import export as jxe

    got = np.asarray(jxe.deserialize(bytearray(blob)).call(raw))
    np.testing.assert_allclose(got, want, atol=1e-3)
