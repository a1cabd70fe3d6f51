"""End-to-end inference workflow: maximum-likelihood fit, then a
warm-started affine-invariant ensemble posterior run — all on device.

This is the analysis pipeline reference users assemble by hand around
40 ms ``predict`` calls (scipy.optimize for the fit, host emcee for the
posterior — reference ``README.rst:9-11`` names fitting observed
spectra as the intended use). Here both halves are single ``lax.scan``
device programs over the fused likelihood paths:

1. :func:`tpu21cmvae.sampling.fit_map` — multi-start Adam ascent on the
   analytic value+gradient path (rates in docs/PERF.md); 1,024
   restarts cost what one costs.
2. :func:`tpu21cmvae.sampling.sample_ensemble` — the Goodman & Weare
   stretch move (emcee's algorithm) with the walkers seeded from the
   fit's final positions, so warmup only has to decorrelate, not find
   the mode.
3. :func:`tpu21cmvae.nested.nested_sampling` (via
   ``model.log_evidence`` — the default method) — batched nested
   sampling log Z for model comparison. Measured ~0.04-nat seed
   spread on real posteriors, where the PT-ladder alternative
   (``method="ladder"``) is metastable and scatters by ~100 nats
   (docs/PERF.md).

Usage:
    python examples/fit_and_sample.py --walkers 1024 --steps 400
"""

from __future__ import annotations

import argparse
import time

import numpy as np

from tpu21cmvae.data.synthetic import PAR_RANGES, synthetic_params

from hmc_inference import load_model  # shipped-checkpoint-or-toy loader


def main():
    ap = argparse.ArgumentParser(description=__doc__)
    ap.add_argument("--walkers", type=int, default=1024)
    ap.add_argument("--steps", type=int, default=400)
    ap.add_argument("--warmup", type=int, default=100)
    ap.add_argument("--starts", type=int, default=1024)
    ap.add_argument("--fit-steps", type=int, default=300)
    ap.add_argument("--retrain", action="store_true",
                    help="train a toy model inline instead of loading "
                         "the shipped checkpoint")
    ap.add_argument("--train-epochs", type=int, default=40)
    args = ap.parse_args()

    model = load_model(args.retrain, args.train_epochs)

    # Synthetic observation: a known parameter vector's signal + noise.
    rng = np.random.default_rng(1)
    truth = synthetic_params(1, rng)[0].astype(np.float32)
    obs = model.predict(truth) + rng.normal(0, 5.0, 451)
    noise_var = 25.0

    # ---- stage 1: multi-start ML fit ---------------------------------
    t0 = time.perf_counter()
    fit = model.fit_params(
        obs, noise_var, bounds=PAR_RANGES,
        n_starts=args.starts, n_steps=args.fit_steps, seed=0,
    )
    fit_s = time.perf_counter() - t0
    print(f"fit: {args.starts} starts × {args.fit_steps} Adam steps "
          f"in {fit_s:.2f}s (incl. compile)")
    print(fit.summary(model.par_labels))

    # ---- stage 2: posterior, walkers seeded from the fit -------------
    # take the best `walkers` final fit positions as walker seeds
    n_walkers = min(args.walkers, args.starts) & ~1  # even, ≤ n_starts
    seeds, _ = fit.top(n_walkers)
    t0 = time.perf_counter()
    res = model.sample_posterior(
        obs, noise_var, sampler="ensemble", bounds=PAR_RANGES,
        n_walkers=n_walkers, n_steps=args.steps,
        n_warmup=args.warmup, thin=10, seed=1, x0=seeds,
    )
    samp_s = time.perf_counter() - t0
    moves = (args.steps + args.warmup) * n_walkers
    print(f"ensemble: {n_walkers} walkers × "
          f"{args.steps + args.warmup} stretch moves in {samp_s:.2f}s "
          f"(incl. compile) → {moves / samp_s:.3e} walker-moves/s, "
          f"accept rate {float(res.accept_rate.mean()):.2f}")
    if res.chain.shape[0] >= 4:
        rhat = res.rhat()
        print(f"split-R̂ max {rhat.max():.3f}")

    flat = res.flat
    print(f"{'param':>8} {'truth':>11} {'ML fit':>11} "
          f"{'post mean':>11} {'post std':>11}")
    for i, label in enumerate(model.par_labels):
        print(f"{label:>8} {truth[i]:11.4g} {fit.best[i]:11.4g} "
              f"{flat[:, i].mean():11.4g} {flat[:, i].std():11.4g}")

    # ---- stage 3: Bayesian evidence by nested sampling ---------------
    t0 = time.perf_counter()
    ev = model.log_evidence(
        obs, noise_var, bounds=PAR_RANGES, n_live=2048, seed=2,
    )
    print(f"evidence: {time.perf_counter() - t0:.2f}s  {ev.summary()}")


if __name__ == "__main__":
    main()
