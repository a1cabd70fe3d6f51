"""Train and measure a 128-aligned flagship architecture: the recipe of
the shipped ``pretrained/direct_aligned_bf16.npz``.

The reference's 288/352/288/224 stack is a laptop-era choice: at a
128-wide tile granularity it multiplies 288→384, 352→384, 224→256
tiles — ~30 % of its padded matmul work is padding
(``matmul_flops_per_row``). This job:

1. successive-halving search over :data:`tpu21cmvae.tuner.
   MXU_ALIGNED_SPACE` (widths ∈ {128, 256, 384}) on the golden
   synthetic split, selecting with the new throughput-aware
   ``TuneResult.best_efficient`` (cheapest padded cost within an
   accuracy slack of the best);
2. strong-retrains the selection (2 seeds, ``DIRECT_TRAIN_STRONG``);
3. tier-native fine-tune (``scripts/finetune_bf16.py``) so the aligned
   stack competes at the fast ``DEFAULT`` tier;
4. times aligned vs reference shape at the HIGH and DEFAULT tiers on a
   2²⁰ batch (bench methodology);
5. ships ``pretrained/direct_aligned_bf16.npz`` iff the accuracy
   regime holds (mean <= 0.20 % at the native tier).

Run: python scripts/train_aligned.py   (writes runs/train_aligned.json;
     --smoke for a tiny CPU run)
"""

from __future__ import annotations

import json
import os
import sys
import time

import numpy as np

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, ROOT)

BATCH = 1 << 20
ITERS = 20
SHIP_REGIME_PCT = 0.20
OUT_JSON = os.path.join(ROOT, "runs", "train_aligned.json")
OUT_CKPT = os.path.join(ROOT, "pretrained", "direct_aligned_bf16.npz")


def _time_fn(fn, params, x):
    import jax

    jax.block_until_ready(fn(params, x))
    t0 = time.perf_counter()
    for _ in range(ITERS):
        out = fn(params, x)
    jax.block_until_ready(out)
    return (time.perf_counter() - t0) / ITERS


def main(smoke: bool = False):
    import jax

    if smoke:
        jax.config.update("jax_platforms", "cpu")
    import jax.numpy as jnp

    from tpu21cmvae.data import synthetic_dataset
    from tpu21cmvae.data.synthetic import synthetic_params
    from tpu21cmvae.models.direct import DirectEmulator
    from tpu21cmvae.tuner import MXU_ALIGNED_SPACE, tune_direct_halving
    from tpu21cmvae.utils.config import DIRECT_TRAIN_STRONG, TrainConfig
    from tpu21cmvae.utils.metrics import error
    from tpu21cmvae.utils.profiling import matmul_flops_per_row

    print(f"devices: {jax.devices()}", flush=True)
    if smoke:
        data = synthetic_dataset(n_train=512, n_val=128, n_test=128,
                                 seed=0)
        n_initial, rungs, rung_epochs = 4, 2, 3
        strong_epochs, ft_epochs = 4, 2
        global BATCH, ITERS
        BATCH, ITERS = 1 << 10, 2
    else:
        data = synthetic_dataset(n_train=26888, n_val=1704,
                                 n_test=1704, seed=0)
        n_initial, rungs, rung_epochs = 12, 3, 25
        strong_epochs, ft_epochs = None, 250
    rec = {}

    # -- 1. aligned search, throughput-aware selection -------------------
    t0 = time.time()
    result = tune_direct_halving(
        data, n_initial=n_initial, rungs=rungs, eta=2,
        rung_epochs=rung_epochs,
        space=MXU_ALIGNED_SPACE, seed=0, verbose=True,
        device_loop=True,
    )
    win = result.best_efficient(slack=0.08)
    rec["search"] = {
        "wall_s": round(time.time() - t0, 1),
        "best": repr(result.best.config),
        "best_val": result.best.val_error,
        "best_padded_flops": result.best.padded_flops_per_row,
        "selected": repr(win.config),
        "selected_val": win.val_error,
        "selected_padded_flops": win.padded_flops_per_row,
    }
    print(f"search: best {result.best.config.hidden_dims} "
          f"({result.best.val_error:.3f}%), selected "
          f"{win.config.hidden_dims} ({win.val_error:.3f}%, "
          f"{win.padded_flops_per_row:.0f} padded flops/row)",
          flush=True)

    # -- 2. strong retrain (2 seeds, keep best val) ----------------------
    t0 = time.time()
    best = None
    strong_cfg = DIRECT_TRAIN_STRONG
    if strong_epochs is not None:
        import dataclasses as _dc

        strong_cfg = _dc.replace(DIRECT_TRAIN_STRONG,
                                 epochs=strong_epochs)
    for s in (0, 1):
        m = DirectEmulator(data, config=win.config, seed=s)
        m.train(train_config=strong_cfg, device_loop=True)
        v = min(m.history.val_loss)
        if best is None or v < best[0]:
            best = (v, m, s)
    _, model, seed_used = best
    err_f32 = error(data.signal_test, model.predict(data.par_test),
                    relative=True, nu_arr=model.frequencies)
    rec["strong_retrain"] = {
        "wall_s": round(time.time() - t0, 1),
        "seed": seed_used,
        "test_mean_f32": float(err_f32.mean()),
        "test_median_f32": float(np.median(err_f32)),
        "weight_count": win.config.mlp().weight_count,
    }
    print(f"strong retrain: {err_f32.mean():.4f}% mean f32 test error "
          f"({win.config.mlp().weight_count} weights)", flush=True)

    # -- 3. bf16-native fine-tune ---------------------------------------
    prec_default = jax.lax.Precision.DEFAULT

    def tier_err(m, precision):
        pred = np.asarray(
            m.predict_fn(precision=precision)(
                m.params, jnp.asarray(data.par_test, jnp.float32)
            )
        )
        return error(data.signal_test, pred, relative=True,
                     nu_arr=m.frequencies)

    t0 = time.time()
    ft = DirectEmulator(data, config=win.config,
                        normalizer=model.normalizer,
                        params=model.params)
    ft.train(
        train_config=TrainConfig(epochs=ft_epochs, learning_rate=1e-3,
                                 early_stop_patience=30),
        device_loop=True, loss_precision=prec_default,
    )
    e_lo = tier_err(ft, prec_default)
    rec["bf16_finetune"] = {
        "wall_s": round(time.time() - t0, 1),
        "test_mean_default": float(e_lo.mean()),
        "test_median_default": float(np.median(e_lo)),
        "test_mean_highest": float(tier_err(ft, None).mean()),
    }
    print(f"bf16 fine-tune: {e_lo.mean():.4f}% mean at DEFAULT tier",
          flush=True)

    # -- 4. throughput: aligned vs reference shape -----------------------
    ref = DirectEmulator.from_checkpoint(
        os.path.join(ROOT, "pretrained", "direct_synthetic_bf16.npz")
    )
    raw = jnp.asarray(
        synthetic_params(BATCH, np.random.default_rng(0)).astype(
            np.float32
        )
    )
    timing = {}
    for name, m, prec in (
        ("ref-high", ref, jax.lax.Precision.HIGH),
        ("ref-default", ref, prec_default),
        ("aligned-high", ft, jax.lax.Precision.HIGH),
        ("aligned-default", ft, prec_default),
    ):
        dt = _time_fn(m.predict_fn(precision=prec), m.params, raw)
        timing[name] = round(BATCH / dt, 1)
        print(f"{name}: {BATCH / dt / 1e6:.1f}M signals/s", flush=True)
    logical, padded = matmul_flops_per_row(win.config.mlp().sizes)
    rlog, rpad = matmul_flops_per_row(ref.config.mlp().sizes)
    rec["throughput"] = dict(
        timing,
        aligned_padded_flops=padded, aligned_logical_flops=logical,
        ref_padded_flops=rpad, ref_logical_flops=rlog,
    )

    # -- 5. ship if the regime holds -------------------------------------
    shipped = bool(e_lo.mean() <= SHIP_REGIME_PCT) and not smoke
    rec["shipped"] = shipped
    if shipped:
        ft.native_precision = "default"
        ft.save(OUT_CKPT)
        rec["checkpoint"] = OUT_CKPT
        print(f"shipped {OUT_CKPT}", flush=True)
    else:
        print(f"NOT shipped: {e_lo.mean():.4f}% > {SHIP_REGIME_PCT}%",
              flush=True)

    os.makedirs(os.path.dirname(OUT_JSON), exist_ok=True)
    with open(OUT_JSON + (".smoke" if smoke else ""), "w") as f:
        json.dump(rec, f, indent=1)
    print(json.dumps({"aligned": rec["throughput"],
                      "mean_default_pct": float(e_lo.mean()),
                      "shipped": shipped}), flush=True)


if __name__ == "__main__":
    main(smoke="--smoke" in sys.argv)
