"""MCMC-scale batched inference — the framework's north-star workload.

The reference emulates one signal per ~40 ms ``Model.predict`` call
(reference ``README.rst:11``), which caps MCMC samplers at ~25 likelihood
evaluations/sec. Here a full ensemble of walkers is ONE device call:
raw parameter draws stream through the fused
``par_transform → MLP → unpreproc`` chain, batch-sharded over every chip
in the mesh with replicated weights (:mod:`tpu21cmvae.parallel`).

This demo runs a toy Metropolis-Hastings ensemble against a synthetic
"observation", entirely on device — the emulator is the likelihood's
forward model and the sampler never leaves JAX, so there are zero host
round trips inside the chain.

Usage:
    python examples/mcmc_inference.py --walkers 8192 --steps 200
"""

from __future__ import annotations

import argparse
import time

import jax
import jax.numpy as jnp
import numpy as np

from tpu21cmvae.data.synthetic import PAR_RANGES, synthetic_params

from hmc_inference import load_model  # shipped-checkpoint-or-toy loader


def main():
    ap = argparse.ArgumentParser(description=__doc__)
    ap.add_argument("--walkers", type=int, default=8192)
    ap.add_argument("--steps", type=int, default=200)
    ap.add_argument("--retrain", action="store_true",
                    help="train a toy model inline instead of loading "
                         "the shipped converged checkpoint")
    ap.add_argument("--train-epochs", type=int, default=40)
    args = ap.parse_args()

    model = load_model(args.retrain, args.train_epochs)

    from tpu21cmvae.parallel.mesh import make_mesh, replicate, shard_batch

    mesh = make_mesh()
    print(f"mesh: {mesh.devices.size} device(s)")

    # Synthetic observation: the signal of a known parameter vector + noise.
    rng1 = np.random.default_rng(1)
    truth = synthetic_params(1, rng1)[0].astype(np.float32)
    obs = model.predict(truth) + rng1.normal(0, 5.0, 451)
    obs = jnp.asarray(obs, jnp.float32)
    noise_var = 25.0

    lo = jnp.asarray(PAR_RANGES[:, 0], jnp.float32)
    hi = jnp.asarray(PAR_RANGES[:, 1], jnp.float32)
    # The emulate→score chain is ONE fused device function: obs + noise
    # fold into the network's last layer and the (B, 451) signal block
    # never exists (ops/loglik.py; measured tiers in docs/PERF.md).
    # Inside a jitted scan, use the RAW function and let the walkers'
    # sharding propagate — a sharding-CONSTRAINED jit nested in the scan
    # forces per-step relayouts.
    from tpu21cmvae.ops.loglik import make_loglik

    loglik = make_loglik(
        model.config, model.normalizer, obs, noise_var, method="gram"
    )  # gram form at the default tier (bench_mcmc.py gates it)
    weights = replicate(model.params, mesh)

    def log_like(raw):
        return loglik(weights, raw)

    def mh_step(state, key):
        walkers, logp = state
        k1, k2 = jax.random.split(key)
        prop = walkers + 0.01 * (hi - lo) * jax.random.normal(
            k1, walkers.shape, walkers.dtype
        )
        prop = jnp.clip(prop, lo, hi)
        logp_prop = log_like(prop)
        accept = (
            jnp.log(jax.random.uniform(k2, (walkers.shape[0],))) < logp_prop - logp
        )
        walkers = jnp.where(accept[:, None], prop, walkers)
        logp = jnp.where(accept, logp_prop, logp)
        return (walkers, logp), jnp.mean(accept)

    @jax.jit
    def run_chain(state, keys):
        # the WHOLE chain is one device program — per-step host dispatch
        # would dominate wall time (dependent round trips); lax.scan
        # keeps the sampler on the device end to end
        return jax.lax.scan(mh_step, state, keys)

    rng = np.random.default_rng(0)
    walkers = shard_batch(
        jnp.asarray(synthetic_params(args.walkers, rng), jnp.float32), mesh
    )
    state = (walkers, log_like(walkers))

    print(f"running {args.steps} MH steps × {args.walkers} walkers...")
    keys = jax.random.split(jax.random.key(0), args.steps)
    state, rates = run_chain(state, keys)  # compile + run
    jax.block_until_ready(state)
    t0 = time.perf_counter()
    state, rates = run_chain(state, keys)
    jax.block_until_ready(state)
    dt = time.perf_counter() - t0
    evals = args.steps * args.walkers
    print(f"{evals:.2e} likelihood evaluations in {dt:.2f}s "
          f"→ {evals / dt:.3e} evals/s "
          f"(reference: ~25/s → speedup {evals / dt / 25:.1e}×)")

    post_mean = np.asarray(state[0]).mean(axis=0)
    for label, t, m in zip(model.par_labels, truth, post_mean):
        print(f"  {label:>7}: truth {t:10.4g}  posterior mean {m:10.4g}")


if __name__ == "__main__":
    main()
