"""Ahead-of-time deployment artifacts: serialized StableHLO programs.

The reference "deploys" a trained emulator as Keras h5 weight files that
need the full package, TensorFlow, AND the training dataset's
normalization statistics at load time (reference ``emulator.py:319-337``;
the stats are recomputed from ``signal_train``/``par_train`` on every
predict, ``preprocess.py:88-101``). Here deployment is one
self-contained binary: :func:`jax.export.export` serializes the whole
jitted chain — ``par_transform → MLP → unpreproc`` with the trained
weights and every normalization constant folded in — as a versioned
StableHLO program with a **symbolic batch dimension**, lowered for
multiple platforms at once (CPU and CUDA GPUs by default).

The artifact replays on any machine with a compatible JAX install::

    from jax import export
    fn = export.deserialize(open("emulator.bin", "rb").read())
    signals = fn.call(params_batch)          # any batch size, no retrace

— no tpu21cmvae import, no checkpoint file, no dataset, no Python model
code. That is the serving story the HTTP layer (:mod:`tpu21cmvae.serve`)
can't give a non-Python consumer, and the JAX analogue of shipping a
TensorFlow SavedModel.

Caveats stated up front:

- **Compatibility window.** ``jax.export`` guarantees artifacts stay
  loadable across JAX releases for a bounded window (~6 months back /
  ~3 weeks forward of the serializing version). Artifacts are a
  *deployment* format, not an archival one — checkpoints
  (:mod:`tpu21cmvae.models.checkpoint`) remain the durable format.
- **Reduction-order tolerance.** Re-compiling the serialized program may
  fuse float32 reductions in a different order than the in-process jit.
  Measured: predict reproduces bit-exactly; the likelihoods (which
  reduce 451 residual terms per row with heavy cancellation) reproduce
  to reduction-order tolerance — ≲1e-5 relative for
  ``method="direct"``, and for the gram form ~2e-6 on the shipped
  trained checkpoint / ~1e-4 worst-case on cancellation-hostile random
  weights — far inside every tier gate in ``bench_mcmc.py``.
"""

from __future__ import annotations

from typing import Sequence, Tuple

import numpy as np

import jax
from jax import export as _jxe

from tpu21cmvae.utils.io import atomic_write

#: Platforms every artifact is lowered for unless overridden. Lowering
#: for "cuda" does not need a GPU attached — it happens at the StableHLO
#: level — so CI (CPU-only) produces artifacts that serve on GPU hosts.
DEFAULT_PLATFORMS: Tuple[str, ...] = ("cpu", "cuda")


def _export_batched(fn, n_in: int, platforms: Sequence[str], dtype=np.float32):
    """Export ``raw (b, n_in) → out`` with a symbolic batch dimension.

    One artifact serves every batch size: the exported program is traced
    once over ``b`` as a dimension *variable*, so the deserialized
    ``.call`` accepts any leading dimension without re-export (it still
    jit-compiles per concrete shape on the serving host, like any jitted
    function).
    """
    (b,) = _jxe.symbolic_shape("b")
    spec = jax.ShapeDtypeStruct((b, n_in), dtype)
    return _jxe.export(jax.jit(fn), platforms=list(platforms))(spec)


def export_predict(
    model,
    *,
    platforms: Sequence[str] = DEFAULT_PLATFORMS,
    precision=None,
):
    """Export a model's batched predict as a :class:`jax.export.Exported`.

    Works for every family exposing the ``predict_fn()`` + ``params``
    contract (direct, AE-based, VAE, deep ensemble — the same contract
    :class:`~tpu21cmvae.parallel.inference.ShardedEmulator` consumes).
    Weights and normalizer constants are folded into the program; the
    exported signature is ``(b, n_params) float32 → (b, n_bins)``.

    ``precision`` forwards to ``predict_fn`` where the family accepts a
    tier (direct/ensemble); ``None`` keeps each family's default
    (the HIGHEST-precision contract path).
    """
    fn = (
        model.predict_fn()
        if precision is None
        else model.predict_fn(precision=precision)
    )
    weights = model.params
    n_in = int(model.config.n_params)
    return _export_batched(
        lambda raw: fn(weights, raw), n_in, platforms
    )


def export_loglik(
    model,
    obs,
    noise_var=1.0,
    *,
    platforms: Sequence[str] = DEFAULT_PLATFORMS,
    **loglik_kwargs,
):
    """Export a model's fused Gaussian log-likelihood for one observation.

    The observation and noise spec fold into the program alongside the
    weights: the artifact is the complete MCMC inner loop for that
    dataset, signature ``(b, n_params) float32 → (b,) float32``.
    ``loglik_kwargs`` forward to the family's ``loglik_fn`` (``method=``,
    ``precision=``, prior/foreground/noise-marginalization options —
    whatever the family supports).
    """
    ll = model.loglik_fn(obs, noise_var, **loglik_kwargs)
    weights = model.params
    n_in = int(model.config.n_params)
    return _export_batched(
        lambda raw: ll(weights, raw), n_in, platforms
    )


def export_valgrad(
    model,
    obs,
    noise_var=1.0,
    *,
    platforms: Sequence[str] = DEFAULT_PLATFORMS,
    **valgrad_kwargs,
):
    """Export the fused value+gradient likelihood: signature
    ``(b, n_params) float32 → ((b,) logL, (b, n_params) dlogL/draw)``.

    This is the HMC/NUTS inner loop as one program — the artifact for
    users who sample with an EXTERNAL gradient-based sampler (BlackJAX,
    NumPyro, Stan-adjacent tooling): they get the emulator's analytic
    gram backward (docs/PERF.md's measured winner) without importing
    tpu21cmvae. ``valgrad_kwargs`` forward to the family's
    ``loglik_and_grad_fn`` (``method=``, tier options, marginalized
    noise specs).
    """
    vg = model.loglik_and_grad_fn(obs, noise_var, **valgrad_kwargs)
    weights = model.params
    n_in = int(model.config.n_params)
    return _export_batched(
        lambda raw: vg(weights, raw), n_in, platforms
    )


def save_artifact(exported, path: str) -> str:
    """Serialize an :class:`jax.export.Exported` to ``path`` atomically
    (write-then-rename — a crashed writer never leaves a torn artifact)."""
    data = exported.serialize()
    with atomic_write(path) as fh:
        fh.write(data)
    return path


def save_predict_artifact(model, path: str, **kwargs) -> str:
    """:func:`export_predict` + :func:`save_artifact` in one call."""
    return save_artifact(export_predict(model, **kwargs), path)


def save_loglik_artifact(model, path: str, obs, noise_var=1.0, **kwargs) -> str:
    """:func:`export_loglik` + :func:`save_artifact` in one call."""
    return save_artifact(
        export_loglik(model, obs, noise_var, **kwargs), path
    )


def save_valgrad_artifact(model, path: str, obs, noise_var=1.0, **kwargs) -> str:
    """:func:`export_valgrad` + :func:`save_artifact` in one call."""
    return save_artifact(
        export_valgrad(model, obs, noise_var, **kwargs), path
    )


class ExportedFn:
    """Callable wrapper over a deserialized artifact.

    Restores the package's input convention on top of the raw
    ``Exported.call``: accepts lists/1-D single rows, casts to float32,
    and squeezes the batch axis back out for 1-D input (matching
    ``DirectEmulator.predict``, reference ``emulator.py:404-407``).
    Pure consumers that don't want the convenience can use
    ``jax.export.deserialize`` directly — the artifact is plain JAX.
    """

    def __init__(self, exported):
        self.exported = exported

    @property
    def platforms(self) -> Tuple[str, ...]:
        return tuple(self.exported.platforms)

    @property
    def n_in(self) -> int:
        return int(self.exported.in_avals[0].shape[1])

    def __call__(self, raw_params):
        raw = np.asarray(raw_params, dtype=np.float32)
        single = raw.ndim == 1
        out = self.exported.call(np.atleast_2d(raw))

        def _host(a):
            a = np.asarray(a)
            return a[0] if single else a

        # predict/loglik artifacts return one array; valgrad artifacts a
        # (logL, grad) tuple — map over whatever structure comes back
        return jax.tree_util.tree_map(_host, out)


def load_artifact(path: str) -> ExportedFn:
    """Load an artifact written by :func:`save_artifact`.

    The serving platform must be one the artifact was lowered for
    (``.platforms``); calling on any other raises from inside JAX.
    """
    with open(path, "rb") as fh:
        data = fh.read()
    return ExportedFn(_jxe.deserialize(bytearray(data)))
