"""``chip_smoke.py`` at tiny sizes on the CPU backend.

The script's phases are functions of their sizes; ``main()`` runs them at
full size on a GPU. Here each phase runs small on the virtual CPU mesh
(tests/conftest.py), which checks its control flow and its comparisons,
and the device check must refuse the CPU — the script never falls back.
"""

import os
import sys

import numpy as np
import pytest

_ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
if _ROOT not in sys.path:
    sys.path.insert(0, _ROOT)

import chip_smoke as cs  # noqa: E402


@pytest.fixture(scope="module")
def models():
    from tpu21cmvae.models.direct import DirectEmulator

    return (DirectEmulator.from_checkpoint(cs.PRETRAINED),
            DirectEmulator.from_checkpoint(cs.PRETRAINED_NATIVE))


@pytest.fixture(scope="module")
def golden():
    from tpu21cmvae.data import synthetic_dataset

    # the golden split's generator and seed, cut to a CPU-test size
    return synthetic_dataset(n_train=2048, n_val=256, n_test=256, seed=0)


def test_numpy_reference_matches_predict(models, golden):
    """The float64 reference the predict phase gates on agrees with the
    model's own HIGHEST forward, fx == 0 clamp rows included."""
    model, _ = models
    raw = np.asarray(golden.par_test[:16], np.float32).copy()
    raw[:2, 2] = 0.0
    ref = cs.numpy_forward(model, raw)
    assert cs._rel_to_amp(model.predict(raw), ref) < cs.PREDICT_REL_TO_AMP


def test_device_phase_refuses_cpu():
    with pytest.raises(cs.PhaseFailed, match="not a 'gpu' device"):
        cs.phase_device()


def test_main_fails_on_cpu_without_ok_line(capsys):
    with pytest.raises(cs.PhaseFailed):
        cs.main([])
    assert '"ok": true' not in capsys.readouterr().out


PHASES = {
    "predict": lambda m, n, g, obs: cs.phase_predict(
        m, n, g, n_rows=64, n_check=32),
    "likelihood": lambda m, n, g, obs: cs.phase_likelihood(
        m, obs, g.par_test[0], n_walkers=256, n_near=64),
    "train": lambda m, n, g, obs: cs.phase_train(g, epochs=3),
    "sample": lambda m, n, g, obs: cs.phase_sample(
        m, obs, n_walkers=64, n_steps=20, n_warmup=20),
    "serve": lambda m, n, g, obs: cs.phase_serve(m, obs, batches=(1, 16)),
    "deploy": lambda m, n, g, obs: cs.phase_deploy(
        m, g, cs.PRETRAINED, n_rows=16),
    "four_gpus": lambda m, n, g, obs: cs.phase_four_gpus(
        m, g, obs, n_devices=4, n_rows=64, n_walkers=64, n_steps=20),
}


@pytest.mark.parametrize("phase", sorted(PHASES))
def test_phase_at_tiny_size(phase, models, golden):
    model, native = models
    obs = np.asarray(golden.signal_test[0], np.float32)
    out = PHASES[phase](model, native, golden, obs)
    assert isinstance(out, dict) and out


def test_deploy_phase_without_serialization(models, golden, monkeypatch,
                                            capsys):
    """Where jax.export cannot serialize (no flatbuffers), the deploy
    phase still runs the exported program and says what it skipped."""
    import importlib.util

    real = importlib.util.find_spec
    monkeypatch.setattr(
        importlib.util, "find_spec",
        lambda name, *a: None if name == "flatbuffers" else real(name, *a),
    )
    model, _ = models
    out = cs.phase_deploy(model, golden, cs.PRETRAINED, n_rows=4)
    assert set(out) == {"exported_max_abs_mk"}
    assert "lacks" in capsys.readouterr().out
