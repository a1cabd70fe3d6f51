"""The folded-constant forward (:mod:`tpu21cmvae.ops.fold`) equals the
model's own predict chain at HIGHEST precision."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest

from tpu21cmvae.models.direct import DirectEmulator
from tpu21cmvae.ops.fold import _log_clamp, fold_emulator_constants
from tpu21cmvae.ops.mlp import mlp_apply
from tpu21cmvae.utils.config import DirectEmulatorConfig

CASES = {
    "fx0_rows": ((32, 24), 9, [0, 4]),
    "single_row": ((32, 24), 1, []),
    "no_hidden": ((), 5, [1]),
}


@pytest.mark.parametrize("case", sorted(CASES))
def test_folded_forward_matches_predict(case, splits, normalizer):
    hidden, n, fx0 = CASES[case]
    model = DirectEmulator(
        normalizer=normalizer,
        config=DirectEmulatorConfig(hidden_dims=hidden), seed=2,
    )
    raw = np.asarray(splits.par_test[:n], np.float32).copy()
    raw[fx0, 2] = 0.0  # the fx == 0 log clamp
    norm = model.normalizer

    @jax.jit
    def folded_forward(params, x):
        return mlp_apply(fold_emulator_constants(params, norm),
                         _log_clamp(x), precision=jax.lax.Precision.HIGHEST)

    got = folded_forward(model.params, jnp.asarray(raw))
    want = model.predict_fn()(model.params, jnp.asarray(raw))
    assert got.shape == want.shape == (n, model.config.n_bins)
    amp = np.abs(np.asarray(want)).max(axis=1, keepdims=True)
    assert (np.abs(np.asarray(got) - np.asarray(want)) / amp).max() < 1e-5
