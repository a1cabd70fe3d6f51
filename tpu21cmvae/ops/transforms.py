"""Signal standardization and parameter transforms as pure jnp functions.

Capability parity with the reference's ``preprocess.py`` (``preproc``
``:4-24``, ``unpreproc`` ``:27-46``, ``par_transform`` ``:49-110``), with a
a redesign: the reference recomputes the training-set statistics on
every call — O(N_train) work per predict (``preprocess.py:88-101``). Here
the statistics are computed once into a :class:`Normalizer` pytree that is
closed over by jitted functions and saved with every model checkpoint, so
inference never needs the training data in memory.
"""

from __future__ import annotations

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np

_FX_CLAMP = 1e-6  # reference preprocess.py:76 — avoids log10(0) for fx == 0
_N_LOG_COLS = 3  # log10 applied to columns 0-2 (fstar, Vc, fx)


@jax.tree_util.register_dataclass
@dataclasses.dataclass(frozen=True)
class Normalizer:
    """Normalization constants bundled as a pytree.

    Fields
    ------
    signal_mean : (bins,) per-bin mean of the training signals
        (reference ``preprocess.py:22``).
    signal_std : () global scalar std over all training-signal elements
        (reference ``preprocess.py:23`` — NumPy ``std`` with no axis).
    par_min, par_max : (n_params,) per-column min/max of the
        *log-transformed* training parameters
        (reference ``preprocess.py:100-101``).
    """

    signal_mean: jax.Array
    signal_std: jax.Array
    par_min: jax.Array
    par_max: jax.Array

    @classmethod
    def from_data(cls, par_train, signal_train, dtype=jnp.float32) -> "Normalizer":
        """Compute the constants once from the training split.

        Statistics are accumulated in float64 on host (matching the
        reference's NumPy defaults) and stored at ``dtype`` for the device.
        """
        par_train = np.asarray(par_train, dtype=np.float64)
        signal_train = np.asarray(signal_train, dtype=np.float64)
        logp = _log_transform_np(par_train)
        return cls(
            signal_mean=jnp.asarray(signal_train.mean(axis=0), dtype=dtype),
            signal_std=jnp.asarray(signal_train.std(), dtype=dtype),
            par_min=jnp.asarray(logp.min(axis=0), dtype=dtype),
            par_max=jnp.asarray(logp.max(axis=0), dtype=dtype),
        )

    @classmethod
    def template(cls, n_bins: int, n_params: int) -> "Normalizer":
        """Zero-filled Normalizer with the right leaf shapes — the pytree
        template checkpoint loaders unflatten into."""
        return cls(
            signal_mean=jnp.zeros(n_bins),
            signal_std=jnp.zeros(()),
            par_min=jnp.zeros(n_params),
            par_max=jnp.zeros(n_params),
        )

    @property
    def scaled_mean(self) -> jax.Array:
        """signal_mean / signal_std — the constant the relative-MSE loss
        adds back to standardized signals (reference ``emulator.py:70-72``)."""
        return self.signal_mean / self.signal_std


def _log_transform_np(params: np.ndarray) -> np.ndarray:
    """Host-side: log10 of the first three columns with the fx==0 clamp."""
    out = params.astype(np.float64, copy=True)
    head = out[:, :_N_LOG_COLS]
    head[head[:, 2] == 0.0, 2] = _FX_CLAMP
    out[:, :_N_LOG_COLS] = np.log10(head)
    return out


def preproc(signal: jax.Array, norm: Normalizer) -> jax.Array:
    """Standardize signals: subtract the per-bin training mean, divide by
    the global training std (reference ``preprocess.py:4-24``)."""
    return (signal - norm.signal_mean) / norm.signal_std


def unpreproc(signal: jax.Array, norm: Normalizer) -> jax.Array:
    """Exact inverse of :func:`preproc` (reference ``preprocess.py:27-46``)."""
    return signal * norm.signal_std + norm.signal_mean


def par_transform(params: jax.Array, norm: Normalizer) -> jax.Array:
    """Map raw astrophysical parameters to the network input space.

    log10 of columns 0-2 (``fx == 0`` clamped to 1e-6), then an affine map
    sending the training-set range of each column onto [-1, 1]
    (reference ``preprocess.py:49-110``). Pure and traceable; 1-D inputs
    are promoted to a single row (reference ``preprocess.py:71-72``).
    """
    params = jnp.asarray(params)
    if params.ndim == 1:
        params = params[None, :]
    col = jnp.arange(params.shape[-1])
    is_log = col < _N_LOG_COLS
    is_fx = col == 2
    clamped = jnp.where(is_fx & (params == 0.0), _FX_CLAMP, params)
    logged = jnp.where(is_log, jnp.log10(jnp.where(is_log, clamped, 1.0)), clamped)
    return 2.0 * (logged - norm.par_min) / (norm.par_max - norm.par_min) - 1.0


def resolve_normalizer(data, normalizer) -> Normalizer:
    """The constructor contract shared by every model family: an explicit
    Normalizer wins; otherwise compute one from the training split; with
    neither, fail loudly."""
    if normalizer is not None:
        return normalizer
    if data is None:
        raise ValueError(
            "Provide `data` (to compute normalization constants) or an "
            "explicit `normalizer`."
        )
    return Normalizer.from_data(data.par_train, data.signal_train)
