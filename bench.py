"""Benchmark: batched-inference throughput of the flagship emulator on a GPU.

Prints ONE JSON line on stdout:
``{"metric": ..., "value": N, "unit": "signals/s", "vs_baseline": N,
"device": {...}}``. Per-candidate lines go to stderr.

Baseline: the reference emulates ~1 signal per 40 ms ≈ 25 signals/s
(reference ``README.rst:11``; BASELINE.md). Here a mega-batch of raw
parameter draws runs through ``par_transform → MLP → unpreproc`` in one
device call per batch.

Candidates (fastest gate-passing one is selected):

* ``xla-highest`` — the accuracy-contract path (exact-f32 matmuls);
* ``xla-high`` and ``xla-default`` — the backend's fast f32 dots (TF32
  tensor-core arithmetic on an NVIDIA GPU), same weights;
* ``xla-native-<tier>`` / ``xla-aligned-<tier>`` — the tier-native
  checkpoints (fine-tuned with the fast forward in their loss) at their
  recorded tier.

Accuracy gates. Same-weights candidates: max error relative to signal
amplitude against the contract path ≤ 1.5e-3 — under half of the 0.34 %
mean-relative-error contract (BASELINE.md), so tier selection can never
cost the golden numbers. The gate runs on the shipped CONVERGED
checkpoint ``pretrained/direct_synthetic.npz``: trained weights have far
more cancellation than random init, so a random-init gate would admit
tiers that fail on real weights. Tier-native checkpoints: mean relative
test error on the golden synthetic split ≤ 0.34 % (their weights differ,
so f32 agreement is the wrong question).

Methodology: warm up the compile, then time ``ITERS`` repeated calls on
a resident device batch ending in ``block_until_ready``. Every candidate
is timed; the gate decides which may be selected. Each line reports the
achieved logical TFLOP/s (matmul FLOPs of the network per row times the
row rate). A candidate that raises fails the run. Runs only on a GPU.
"""

from __future__ import annotations

import json
import os
import sys
import time

import jax
import jax.numpy as jnp
import numpy as np

BASELINE_SIGNALS_PER_SEC = 25.0  # reference: ~40 ms/signal, README.rst:11
BATCH = 1 << 20
ITERS = 20
GATE_REL_TO_AMP = 1.5e-3
_CHECK = 1 << 16  # rows used for the accuracy gate

_HERE = os.path.dirname(os.path.abspath(__file__))
PRETRAINED = os.path.join(_HERE, "pretrained", "direct_synthetic.npz")
# tier-NATIVE checkpoints: fine-tuned WITH the fast forward in the loss
# (scripts/finetune_bf16.py, scripts/train_aligned.py), gated on
# accuracy-to-TRUTH on the golden synthetic split
PRETRAINED_NATIVE = os.path.join(_HERE, "pretrained", "direct_synthetic_bf16.npz")
PRETRAINED_ALIGNED = os.path.join(_HERE, "pretrained", "direct_aligned_bf16.npz")
GATE_GOLDEN_MEAN_PCT = 0.34  # the reference contract (README.rst:11)
SHIP_REGIME_PCT = 0.20  # the shipped-checkpoint regime (pretrained/)


def golden_split():
    """The golden synthetic split of ``tests/test_pretrained.py``."""
    from tpu21cmvae.data import synthetic_dataset

    return synthetic_dataset(n_train=26888, n_val=1704, n_test=1704, seed=0)


def golden_error_pct(model, data, precision=None):
    """(mean, median) relative test error in % on ``data``'s test split
    at ``precision`` (``"native"`` for a tier-native checkpoint)."""
    from tpu21cmvae.utils.metrics import error

    pred = np.asarray(model.predict_fn(precision=precision)(
        model.params, jnp.asarray(data.par_test, jnp.float32)
    ))
    err = error(data.signal_test, pred, relative=True,
                nu_arr=model.frequencies)
    return float(err.mean()), float(np.median(err))


def _candidates(model, native, aligned):
    """(name, fn, weights model, gate) rows; ``gate`` is ``"f32"``
    (agreement with the contract path of the SAME weights) or
    ``"golden"`` (accuracy-to-truth of a tier-native checkpoint)."""
    return [
        ("xla-highest", model.predict_fn(), model, "f32"),
        ("xla-high", model.predict_fn(precision="high"), model, "f32"),
        ("xla-default", model.predict_fn(precision="default"), model,
         "f32"),
        (f"xla-native-{native.native_precision}",
         native.predict_fn(precision="native"), native, "golden"),
        (f"xla-aligned-{aligned.native_precision}",
         aligned.predict_fn(precision="native"), aligned, "golden"),
    ]


def _time_fn(fn, params, x) -> float:
    jax.block_until_ready(fn(params, x))  # compile + warm
    t0 = time.perf_counter()
    for _ in range(ITERS):
        out = fn(params, x)
    jax.block_until_ready(out)
    return (time.perf_counter() - t0) / ITERS


def main():
    from tpu21cmvae.data.synthetic import synthetic_params
    from tpu21cmvae.models.direct import DirectEmulator
    from tpu21cmvae.utils.compile_cache import enable_compile_cache
    from tpu21cmvae.utils.profiling import gpu_card_info, matmul_flops_per_row

    enable_compile_cache()
    dev = jax.devices()[0]
    if dev.platform != "gpu":
        sys.exit(f"bench: needs a GPU; JAX found {dev.platform}")
    device = {"platform": dev.platform, "kind": dev.device_kind,
              "count": len(jax.devices())}
    print(f"bench: {device} | nvidia-smi: {gpu_card_info()}",
          file=sys.stderr)

    model = DirectEmulator.from_checkpoint(PRETRAINED)
    native = DirectEmulator.from_checkpoint(PRETRAINED_NATIVE)
    aligned = DirectEmulator.from_checkpoint(PRETRAINED_ALIGNED)
    raw = synthetic_params(BATCH, np.random.default_rng(0)).astype(np.float32)
    x = jnp.asarray(raw)
    data = golden_split()

    ref = np.asarray(model.predict_fn()(model.params, x[:_CHECK]))
    amp = np.abs(ref).max(axis=1, keepdims=True)

    best_name, best_dt = None, float("inf")
    for name, fn, m, gate in _candidates(model, native, aligned):
        if gate == "f32":
            err = float((np.abs(np.asarray(fn(m.params, x[:_CHECK])) - ref)
                         / amp).max())
            ok = err <= GATE_REL_TO_AMP  # NaN-safe: NaN never passes
            detail = f"err {err:.3e} (gate {GATE_REL_TO_AMP:.1e})"
        else:
            mean_pct, median_pct = golden_error_pct(m, data, "native")
            ok = mean_pct <= GATE_GOLDEN_MEAN_PCT
            detail = (f"golden mean {mean_pct:.4f}%/median "
                      f"{median_pct:.4f}% (gate {GATE_GOLDEN_MEAN_PCT}%, "
                      f"ship regime {SHIP_REGIME_PCT}%)")
        dt = _time_fn(fn, m.params, x)
        logical, _ = matmul_flops_per_row(m.config.mlp().sizes,
                                          skip_first=False)
        print(f"bench: {name} gate {'ok' if ok else 'REJECTED'} {detail}, "
              f"{BATCH / dt / 1e6:.2f}M signals/s, "
              f"{BATCH / dt * logical / 1e12:.1f} logical TFLOP/s",
              file=sys.stderr)
        if ok and dt < best_dt:
            best_name, best_dt = name, dt

    if best_name is None:
        sys.exit("bench: no candidate passed its accuracy gate")
    sps = BATCH / best_dt
    print(json.dumps({
        "metric": f"signals_per_sec_batched_inference[{best_name}]",
        "value": sps,
        "unit": "signals/s",
        "vs_baseline": sps / BASELINE_SIGNALS_PER_SEC,
        "device": device,
    }), flush=True)


if __name__ == "__main__":
    main()
