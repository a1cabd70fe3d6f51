"""Tier-native checkpoints: fast-tier inference within the golden
accuracy contract.

The reference runs every prediction at one implicit precision
(~40 ms/signal, reference ``README.rst:11``). Here the matmul precision
TIER is a knob, gated on accuracy-to-TRUTH instead of f32-agreement: a
checkpoint fine-tuned WITH the fast forward in its loss
(``DirectEmulator.train(loss_precision=jax.lax.Precision.DEFAULT)``,
``scripts/finetune_bf16.py``) holds the golden test error AT the fast
tier, where the same-weights agreement gate can reject it. bench.py
times every tier and docs/PERF.md records the rates on a GPU.

This demo is headless and CPU-safe (the DEFAULT tier is plain f32 on the
CPU, so the printed errors are the weights' golden numbers at f32).
"""

from __future__ import annotations

import os
import sys

import numpy as np

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, ROOT)


def main():
    import jax.numpy as jnp

    from tpu21cmvae.data import synthetic_dataset
    from tpu21cmvae.models.direct import DirectEmulator
    from tpu21cmvae.utils.metrics import error
    from tpu21cmvae.utils.profiling import matmul_flops_per_row

    data = synthetic_dataset(n_train=26888, n_val=1704, n_test=1704,
                             seed=0)
    par = jnp.asarray(data.par_test, jnp.float32)

    rows = []
    for fname, note in (
        ("direct_synthetic.npz", "reference shape, contract tier"),
        ("direct_synthetic_bf16.npz",
         "reference shape, tier-native"),
        ("direct_aligned_bf16.npz",
         "128-aligned widths, tier-native"),
    ):
        path = os.path.join(ROOT, "pretrained", fname)
        if not os.path.exists(path):
            print(f"  {fname}: not present, skipping")
            continue
        em = DirectEmulator.from_checkpoint(path)
        tier = em.native_precision or "contract"
        pred = np.asarray(
            em.predict_fn(precision="native")(em.params, par)
        )
        err = error(data.signal_test, pred, relative=True,
                    nu_arr=em.frequencies)
        logical, padded = matmul_flops_per_row(em.config.mlp().sizes)
        rows.append((fname, tier, err.mean(), np.median(err),
                     em.config.mlp().weight_count, padded, note))

    print(f"{'checkpoint':34} {'tier':9} {'mean%':>7} {'med%':>7} "
          f"{'weights':>8} {'padded FLOP/row':>15}")
    for fname, tier, m, md, w, p, note in rows:
        print(f"{fname:34} {tier:9} {m:7.3f} {md:7.3f} {w:8d} {p:15.0f}"
              f"   <- {note}")
    print(
        "\nAll three hold the reference's 0.34 % contract "
        "(reference tests/test_emulator.py:76). Pick per workload:\n"
        "  - contract tier: exact f32 forward\n"
        "  - tier-native:   the fast tier at golden accuracy\n"
        "  - aligned:       the same, with 2.7x fewer padded FLOPs\n"
        "Rates per tier on a GPU: bench.py and docs/PERF.md. The "
        "native tier is a PREDICT tier; keep loglik_fn at its default "
        "(a tier-native likelihood moved posteriors by 0.2-0.4 sd when "
        "it was last measured, with a bf16 forward)."
    )


if __name__ == "__main__":
    main()
