"""Fine-tune a TIER-NATIVE flagship checkpoint: the recipe of the shipped
``pretrained/direct_synthetic_bf16.npz``.

A fast matmul tier (``Precision.DEFAULT``) can fail bench.py's gate,
which compares each tier against exact-f32 OF THE SAME WEIGHTS: on
converged weights a single-pass bf16 forward drifts to ~1.4e-2
relative-to-amplitude. The real contract, though, is test_error <= 0.34 % against TRUTH (reference
``tests/test_emulator.py:72-80``), not f32-agreement: a checkpoint
fine-tuned WITH the fast forward in its loss (quantization-aware
fine-tuning) is gated by the golden numbers directly. The shipped
checkpoint was fine-tuned against a single-pass bf16 forward; what
``DEFAULT`` computes depends on the backend (TF32 on an NVIDIA GPU), so
rerunning this recipe on another backend fine-tunes for that backend's
arithmetic.

This job:

1. loads ``pretrained/direct_synthetic.npz`` (0.159 % mean at the
   contract tier) and the golden synthetic split (26888/1704/1704,
   seed 0 — the split of ``tests/test_pretrained.py``);
2. records the un-fine-tuned DEFAULT-tier error (the starting point the
   gate rejected);
3. fine-tunes a small (learning_rate x seed) grid with
   ``loss_precision=Precision.DEFAULT`` — the forward AND its gradient
   run through the fast-tier matmuls, so the optimum is a point whose
   fast forward fits the data (``DirectEmulator.loss_fn``);
4. selects by DEFAULT-tier validation error, reports DEFAULT- and
   HIGHEST-tier test error of the winner;
5. ships ``pretrained/direct_synthetic_bf16.npz`` with
   ``native_precision="default"`` iff the winner holds the accuracy
   regime (mean <= GATE_MEAN_PCT at the native tier).

Run:         python scripts/finetune_bf16.py   (writes runs/finetune_bf16.json)
Smoke (CPU): python scripts/finetune_bf16.py --smoke
"""

from __future__ import annotations

import dataclasses
import json
import os
import sys
import time

import numpy as np

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, REPO)

# the accuracy regime the shipped checkpoints live in: the reference
# contract is 0.34 % mean relative error (reference
# ``tests/test_emulator.py:76``); the shipped f32 checkpoint holds
# 0.159 % and tests/test_pretrained.py gates it at 0.20 %. A tier-native
# checkpoint must stay in the SHIPPED regime, not just the contract:
GATE_MEAN_PCT = 0.34
SHIP_REGIME_PCT = 0.20

OUT_JSON = os.path.join(REPO, "runs", "finetune_bf16.json")
OUT_CKPT = os.path.join(REPO, "pretrained", "direct_synthetic_bf16.npz")


def main(smoke: bool = False):
    import jax

    if smoke:
        jax.config.update("jax_platforms", "cpu")
    from tpu21cmvae.data import synthetic_dataset
    from tpu21cmvae.models.direct import DirectEmulator
    from tpu21cmvae.utils.config import TrainConfig
    from tpu21cmvae.utils.metrics import error

    print(f"devices: {jax.devices()}", flush=True)
    if smoke:
        data = synthetic_dataset(n_train=512, n_val=128, n_test=128, seed=0)
        grid = [(1e-3, 0)]
        epochs = 3
    else:
        data = synthetic_dataset(
            n_train=26888, n_val=1704, n_test=1704, seed=0
        )
        grid = [(3e-3, 0), (1e-3, 0), (1e-3, 1)]
        epochs = 250

    base = DirectEmulator.from_checkpoint(
        os.path.join(REPO, "pretrained", "direct_synthetic.npz"), data
    )
    prec_default = jax.lax.Precision.DEFAULT

    def tier_err(model, split_pars, split_sigs, precision):
        pred = np.asarray(
            model.predict_fn(precision=precision)(model.params,
                                                  split_pars)
        )
        return error(split_sigs, pred, relative=True,
                     nu_arr=model.frequencies)

    rec = {"smoke": smoke, "grid": [], "gate_mean_pct": GATE_MEAN_PCT}
    e0_hi = tier_err(base, data.par_test, data.signal_test, None)
    e0_lo = tier_err(base, data.par_test, data.signal_test, prec_default)
    rec["baseline"] = {
        "test_mean_highest": float(e0_hi.mean()),
        "test_mean_default": float(e0_lo.mean()),
        "test_median_default": float(np.median(e0_lo)),
    }
    print(f"baseline: contract tier {e0_hi.mean():.4f} % | DEFAULT tier "
          f"{e0_lo.mean():.4f} % mean test error", flush=True)

    best = None
    for lr, seed in grid:
        t0 = time.time()
        trial = DirectEmulator(
            data, config=base.config, normalizer=base.normalizer,
            params=base.params,
        )
        cfg = TrainConfig(
            epochs=epochs,
            learning_rate=lr,
            early_stop_patience=30,
            seed=seed,
        )
        trial.train(train_config=cfg, device_loop=True,
                    loss_precision=prec_default)
        val = tier_err(trial, data.par_val, data.signal_val, prec_default)
        dt = time.time() - t0
        entry = {
            "lr": lr, "seed": seed,
            "epochs_run": len(trial.history.loss),
            "val_mean_default": float(val.mean()),
            "wall_s": round(dt, 1),
        }
        rec["grid"].append(entry)
        print(f"trial lr={lr} seed={seed}: DEFAULT-tier val mean "
              f"{val.mean():.4f} % ({entry['epochs_run']} epochs, "
              f"{dt:.0f}s)", flush=True)
        if best is None or val.mean() < best[0]:
            best = (float(val.mean()), trial, entry)

    _, winner, wentry = best
    te_lo = tier_err(winner, data.par_test, data.signal_test, prec_default)
    te_hi = tier_err(winner, data.par_test, data.signal_test, None)
    rec["winner"] = dict(
        wentry,
        test_mean_default=float(te_lo.mean()),
        test_median_default=float(np.median(te_lo)),
        test_max_default=float(te_lo.max()),
        test_mean_highest=float(te_hi.mean()),
    )
    passed = te_lo.mean() <= GATE_MEAN_PCT
    rec["winner"]["gate_passed"] = bool(passed)
    rec["winner"]["ship_regime"] = bool(te_lo.mean() <= SHIP_REGIME_PCT)
    print(
        f"winner lr={wentry['lr']} seed={wentry['seed']}: DEFAULT-tier "
        f"test mean {te_lo.mean():.4f} % / median "
        f"{np.median(te_lo):.4f} % (contract-tier mean of same weights "
        f"{te_hi.mean():.4f} %) — gate {'PASS' if passed else 'FAIL'}",
        flush=True,
    )
    if passed and not smoke:
        winner.native_precision = "default"
        winner.save(OUT_CKPT)
        rec["checkpoint"] = OUT_CKPT
        print(f"shipped {OUT_CKPT}", flush=True)

    os.makedirs(os.path.dirname(OUT_JSON), exist_ok=True)
    with open(OUT_JSON + (".smoke" if smoke else ""), "w") as fh:
        json.dump(rec, fh, indent=2)
    print(json.dumps(rec["winner"]), flush=True)


if __name__ == "__main__":
    main(smoke="--smoke" in sys.argv)
