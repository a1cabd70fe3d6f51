"""Property-based tests (hypothesis) for the pure transform/metric layer.

The reference's tests check single hand-picked cases
(reference ``tests/test_preprocess.py``); these pin the algebraic
invariants across generated inputs: inversion, range mapping, metric
identities, and the weight-folding equivalence the fused kernel relies on.
"""

import numpy as np
from hypothesis import given, settings, strategies as st
from hypothesis.extra import numpy as hnp

from tpu21cmvae.ops.transforms import Normalizer, par_transform, preproc, unpreproc
from tpu21cmvae.utils.frequency import freq2redshift, redshift2freq
from tpu21cmvae.utils.metrics import error

SETTINGS = dict(max_examples=25, deadline=None)

signals = hnp.arrays(
    np.float64,
    st.tuples(st.integers(4, 12), st.just(16)),
    elements=st.floats(-250.0, 60.0, allow_nan=False),
)

params7 = hnp.arrays(
    np.float64,
    st.tuples(st.integers(4, 12), st.just(7)),
    elements=st.floats(1e-4, 100.0, allow_nan=False),
)


def _norm(sig, par):
    # guard degenerate generated data (zero std / zero range)
    sig = sig + np.arange(sig.shape[0])[:, None]  # break constancy
    par = par * (1.0 + 0.1 * np.arange(par.shape[0])[:, None])
    return Normalizer.from_data(par, sig), sig, par


@settings(**SETTINGS)
@given(signals, params7)
def test_unpreproc_inverts_preproc(sig, par):
    norm, sig, par = _norm(sig, par)
    back = np.asarray(unpreproc(preproc(sig, norm), norm))
    np.testing.assert_allclose(back, sig, rtol=1e-4, atol=1e-3)


@settings(**SETTINGS)
@given(signals, params7)
def test_preproc_training_set_statistics(sig, par):
    """Standardized training signals have ~zero per-bin mean (the
    reference's test_proc invariant). NOTE: unit global std is NOT an
    invariant — preproc divides by the global std of the RAW data, and
    subtracting per-bin means removes the between-bin variance, so the
    residual std is ≤ 1 in general (reference preprocess.py:22-23)."""
    norm, sig, par = _norm(sig, par)
    proc = np.asarray(preproc(sig, norm))
    scale = np.abs(np.asarray(sig)).max() / float(norm.signal_std) + 1.0
    np.testing.assert_allclose(proc.mean(axis=0), 0.0, atol=1e-5 * scale)
    assert proc.std() <= 1.0 + 1e-3


@settings(**SETTINGS)
@given(signals, params7)
def test_par_transform_maps_training_range_to_unit_box(sig, par):
    norm, sig, par = _norm(sig, par)
    t = np.asarray(par_transform(par, norm))
    assert t.min() >= -1.0 - 1e-4 and t.max() <= 1.0 + 1e-4
    # each column attains both endpoints on the training set itself
    np.testing.assert_allclose(t.min(axis=0), -1.0, atol=1e-4)
    np.testing.assert_allclose(t.max(axis=0), 1.0, atol=1e-4)


@settings(**SETTINGS)
@given(hnp.arrays(np.float64, st.integers(3, 40),
                  elements=st.floats(0.1, 60.0, allow_nan=False)))
def test_z_nu_roundtrip(z):
    np.testing.assert_allclose(freq2redshift(redshift2freq(z)), z, rtol=1e-12)


@settings(**SETTINGS)
@given(signals)
def test_error_identities(sig):
    sig = sig + np.linspace(1.0, 2.0, sig.shape[0])[:, None]  # nonzero amp
    np.testing.assert_allclose(error(sig, sig, relative=False), 0.0, atol=0)
    shifted = sig + 2.0
    np.testing.assert_allclose(
        error(sig, shifted, relative=False), 2.0, rtol=1e-9
    )
    # relative error is scale-invariant
    a = error(sig, shifted, relative=True)
    b = error(3.0 * sig, 3.0 * (sig + 2.0 / 3.0 * 3.0) - 4.0, relative=True)
    # (just check scaling of the simple case)
    c = error(3.0 * sig, 3.0 * shifted, relative=True)
    np.testing.assert_allclose(c, a, rtol=1e-9)


@settings(**SETTINGS)
@given(params7)
def test_fold_constants_equals_transform_then_apply(par):
    """The weight folding is algebraically exact for any normalizer and
    any weights (up to float error)."""
    import jax
    import jax.numpy as jnp

    from tpu21cmvae.ops.mlp import init_mlp, mlp_apply
    from tpu21cmvae.ops.fold import _log_clamp, fold_emulator_constants

    rng = np.random.default_rng(0)
    sig = rng.normal(-50, 30, (8, 16))
    norm, sig, par = _norm(sig, par)
    params = init_mlp(jax.random.key(1), (7, 8, 16))
    x = jnp.asarray(par, jnp.float32)
    ref = unpreproc(mlp_apply(params, par_transform(x, norm)), norm)
    got = mlp_apply(fold_emulator_constants(params, norm), _log_clamp(x))
    scale = np.abs(np.asarray(ref)).max() + 1.0
    np.testing.assert_allclose(
        np.asarray(got) / scale, np.asarray(ref) / scale, atol=5e-5
    )
