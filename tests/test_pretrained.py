"""Golden tests against the SHIPPED pretrained checkpoints.

The reference's accuracy tests load its shipped artifacts + the Zenodo
dataset at import time and so cannot run offline (reference
``tests/test_emulator.py:50-52``); here both the artifacts
(``pretrained/``) and the dataset (deterministic synthetic surrogate)
live in the repo, so the golden numbers are asserted in every CI run.
"""

import os

import numpy as np
import pytest

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
DIRECT = os.path.join(REPO, "pretrained", "direct_synthetic.npz")
AE = os.path.join(REPO, "pretrained", "ae_synthetic.npz")

pytestmark = pytest.mark.skipif(
    not os.path.exists(DIRECT), reason="pretrained artifacts not present"
)


@pytest.fixture(scope="module")
def refdata():
    from tpu21cmvae.data import synthetic_dataset

    # the exact split the artifacts were trained on (seeded, deterministic)
    return synthetic_dataset(n_train=26888, n_val=1704, n_test=1704, seed=0)


def test_pretrained_direct_golden(refdata):
    from tpu21cmvae.models import load_model

    em = load_model(DIRECT, refdata)
    err = em.test_error()
    assert err.mean() < 0.20  # trained to 0.159 %
    assert np.median(err) < 0.20
    assert err.max() < 3.0
    one = em.predict(refdata.par_test[0])
    assert one.shape == (451,)


def test_pretrained_ae_golden(refdata):
    from tpu21cmvae.models import load_model

    ae = load_model(AE, refdata)
    err = ae.test_error()
    rec = ae.test_error(use_autoencoder=True)
    assert err.mean() < 0.25  # trained to 0.180 %
    assert rec.mean() < 0.20  # reconstruction trained to 0.125 %


def test_pretrained_needs_no_training_data():
    """The bundled Normalizer makes inference self-contained."""
    from tpu21cmvae.models import load_model

    em = load_model(DIRECT)  # no dataset attached
    sig = em.predict([0.05, 16.5, 1.0, 0.06, 1.3, 2.0, 30.0])
    assert sig.shape == (451,) and np.isfinite(sig).all()


def test_pretrained_vae_golden(refdata):
    """Round-3 checkpoint (halving-tuned latent 7, β=3e-6, strong
    recipes): beats the reference's published AE-based 0.39 % with the
    majority of the latent space ACTIVE — no posterior collapse."""
    import jax

    from tpu21cmvae.models import load_model
    from tpu21cmvae.ops.transforms import preproc

    vae = load_model(
        os.path.join(REPO, "pretrained", "vae_synthetic.npz"), refdata
    )
    err = vae.test_error()
    assert err.mean() < 0.35  # trained to 0.278 % (scripts/train_vae_r3.py)
    assert np.median(err) < 0.35  # trained to 0.244 %
    # ≥ half the latent dims are active: collapsed dims pin z_mean ≈ 0
    # for every input (round-2 checkpoint had 4/13 — VERDICT weak)
    y_val = preproc(
        np.asarray(refdata.signal_val, np.float32), vae.normalizer
    )
    mu = np.asarray(
        jax.jit(lambda p, y: vae.vae.encode(p, y)[0])(vae.vae.params, y_val)
    )
    active = int((mu.var(axis=0) > 0.01).sum())
    assert 2 * active >= vae.config.latent_dim, (
        f"{active}/{vae.config.latent_dim} active latents"
    )
    # the interpretable latent space is usable out of the box
    curves = vae.latent_traversal(dim=0, values=np.linspace(-2, 2, 5))
    assert curves.shape == (5, 451) and np.isfinite(curves).all()


def test_pretrained_ensemble_golden(refdata):
    """The shipped 3-member ensemble: mean error beats every member
    (trained to 0.150 % vs 0.17/0.33/0.30 %) and uncertainty works."""
    from tpu21cmvae.models.ensemble import DeepEnsemble

    ens = DeepEnsemble.load(
        os.path.join(REPO, "pretrained", "ensemble_direct"), refdata
    )
    assert len(ens.members) == 3
    err = ens.test_error()
    assert err.mean() < 0.25
    mean, std = ens.predict_with_uncertainty(refdata.par_test[:8])
    assert mean.shape == std.shape == (8, refdata.n_bins)
    assert np.isfinite(std).all() and std.max() > 0


def test_pretrained_bf16_native_golden(refdata):
    """Tier-native checkpoints: golden error at the checkpoint's NATIVE
    tier (on CPU the DEFAULT tier lowers to f32, so this pins the
    weights' accuracy and the native_precision plumbing; what the tier
    computes on a GPU is measured by chip_smoke.py and bench.py)."""
    import os

    import jax.numpy as jnp

    from tpu21cmvae.models.direct import DirectEmulator
    from tpu21cmvae.utils.config import DIRECT_ALIGNED
    from tpu21cmvae.utils.metrics import error

    root = os.path.join(os.path.dirname(__file__), "..", "pretrained")
    for fname, cfg_check, bound in (
        ("direct_synthetic_bf16.npz", None, 0.20),
        ("direct_aligned_bf16.npz", DIRECT_ALIGNED, 0.25),
    ):
        em = DirectEmulator.from_checkpoint(os.path.join(root, fname))
        assert em.native_precision == "default"
        if cfg_check is not None:
            assert em.config == cfg_check
        pred = np.asarray(em.predict_fn(precision="native")(
            em.params, jnp.asarray(refdata.par_test, jnp.float32)
        ))
        err = error(refdata.signal_test, pred, relative=True,
                    nu_arr=em.frequencies)
        assert err.mean() < bound, (fname, err.mean())
        # saving round-trips the native tier
        out = os.path.join("/tmp", "rt_" + fname)
        em.save(out)
        em2 = DirectEmulator.from_checkpoint(out)
        assert em2.native_precision == "default"
