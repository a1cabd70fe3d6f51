"""Hamiltonian Monte Carlo with the emulator as forward model — gradients
through the likelihood, entirely on device.

The reference supports ~25 likelihood evaluations/s with no gradients at
all (reference ``README.rst:11``); composing ∇logL by hand would mean
differentiating through Keras predict. Here the value AND per-row
gradient of the Gaussian log-likelihood come from ONE device function
(:func:`tpu21cmvae.ops.loglik.make_loglik_and_grad` — the analytic
gram backward, see docs/PERF.md), and a whole HMC
ensemble (leapfrog + Metropolis correction) runs as one ``lax.scan``
program per chain segment.

The forward model defaults to the SHIPPED converged checkpoint
(``pretrained/direct_synthetic.npz``, 0.159 % mean error) — the
fast-tier accuracy gates are calibrated on trained weights, and a
40-epoch toy model is exactly the random-init trap the bench gate
exists to avoid (bench.py docstring). ``--retrain`` forces the inline
toy training anyway.

This example builds the HMC kernel BY HAND to show the moving parts
(whitening, leapfrog, Metropolis correction). For production use prefer
the library samplers, which add dual-averaging step adaptation, an
ensemble-statistics metric, and — with ``sampler="chees"`` — adaptive
trajectory lengths (ChEES-HMC, docs/PERF.md)::

    model.sample_posterior(obs, noise_var, sampler="chees")

Usage:
    python examples/hmc_inference.py --walkers 4096 --steps 100 \
        --leapfrog 8
"""

from __future__ import annotations

import argparse
import os
import time

import jax
import jax.numpy as jnp
import numpy as np

from tpu21cmvae import DirectEmulator
from tpu21cmvae.data import synthetic_dataset
from tpu21cmvae.data.synthetic import PAR_RANGES, synthetic_params

PRETRAINED = os.path.join(
    os.path.dirname(os.path.dirname(os.path.abspath(__file__))),
    "pretrained", "direct_synthetic.npz",
)


def load_model(retrain: bool, train_epochs: int) -> DirectEmulator:
    if os.path.exists(PRETRAINED) and not retrain:
        print(f"loading shipped converged checkpoint {PRETRAINED}")
        return DirectEmulator.from_checkpoint(PRETRAINED)
    from tpu21cmvae.utils.config import TrainConfig

    print("training a toy forward model inline (pass no --retrain and "
          "keep pretrained/ for converged weights)...")
    data = synthetic_dataset(n_train=4096, n_val=512, n_test=512, seed=0)
    model = DirectEmulator(data)
    model.train(
        train_config=TrainConfig(epochs=train_epochs), device_loop=True
    )
    return model


def main():
    ap = argparse.ArgumentParser(description=__doc__)
    ap.add_argument("--walkers", type=int, default=4096)
    ap.add_argument("--steps", type=int, default=100)
    ap.add_argument("--leapfrog", type=int, default=8)
    ap.add_argument("--retrain", action="store_true",
                    help="train a toy model inline instead of loading "
                         "the shipped checkpoint")
    ap.add_argument("--train-epochs", type=int, default=40)
    args = ap.parse_args()

    model = load_model(args.retrain, args.train_epochs)

    rng = np.random.default_rng(1)
    truth = synthetic_params(1, rng)[0].astype(np.float32)
    obs = model.predict(truth) + rng.normal(0, 5.0, 451)
    obs = jnp.asarray(obs, jnp.float32)
    noise_var = 25.0

    lo = jnp.asarray(PAR_RANGES[:, 0], jnp.float32)
    hi = jnp.asarray(PAR_RANGES[:, 1], jnp.float32)
    span = hi - lo

    # HMC needs a smooth unbounded target: sample in a whitened y-space
    # with a sigmoid map into the prior box (the Jacobian term keeps the
    # flat box prior exact).
    def to_params(y):
        return lo + span * jax.nn.sigmoid(y)

    def log_jac(y):  # log |d params / d y| for the sigmoid map
        return jnp.sum(jax.nn.log_sigmoid(y) + jax.nn.log_sigmoid(-y), -1)

    # value AND per-row gradient in one device call: the analytic gram
    # backward (bench_mcmc.py grad table, docs/PERF.md) with the fast
    # backward tier. Gradient-tier error only costs acceptance rate:
    # leapfrog with a deterministic approximate force field stays
    # reversible and volume-preserving, and the accept step uses the
    # gated value.
    valgrad = model.loglik_and_grad_fn(
        obs, noise_var, grad_precision="default"
    )
    weights = model.params

    def logp_and_grad(y):
        ll, g_raw = valgrad(weights, to_params(y))
        s = jax.nn.sigmoid(y)
        lp = ll + log_jac(y)
        # chain rule through the box map: draw/dy = span·s·(1−s);
        # d log_jac/dy = 1 − 2s
        glp = g_raw * (span * s * (1.0 - s)) + (1.0 - 2.0 * s)
        return lp, glp

    eps = 0.01

    def hmc_step(state, key):
        y, lp, glp = state
        kp, ku = jax.random.split(key)
        p0 = jax.random.normal(kp, y.shape, y.dtype)
        # leapfrog: `leapfrog` value+gradient evaluations per step (the
        # initial gradient is carried in the chain state)
        p = p0 + 0.5 * eps * glp
        q = y
        for _ in range(args.leapfrog - 1):
            q = q + eps * p
            _, g = logp_and_grad(q)
            p = p + eps * g
        q = q + eps * p
        lp_new, g_new = logp_and_grad(q)
        p = p + 0.5 * eps * g_new
        dh = (lp_new - lp) - 0.5 * (
            jnp.sum(p**2, -1) - jnp.sum(p0**2, -1)
        )
        accept = jnp.log(jax.random.uniform(ku, (y.shape[0],))) < dh
        y = jnp.where(accept[:, None], q, y)
        lp = jnp.where(accept, lp_new, lp)
        glp = jnp.where(accept[:, None], g_new, glp)
        return (y, lp, glp), jnp.mean(accept)

    @jax.jit
    def run_chain(state, keys):
        return jax.lax.scan(hmc_step, state, keys)

    rng = np.random.default_rng(0)
    draws = synthetic_params(args.walkers, rng).astype(np.float32)
    # invert the sigmoid map to get starting y's inside the box
    frac = np.clip((draws - np.asarray(lo)) / np.asarray(span), 1e-4, 1 - 1e-4)
    y0 = jnp.asarray(np.log(frac / (1 - frac)), jnp.float32)
    state = (y0, *logp_and_grad(y0))

    keys = jax.random.split(jax.random.key(0), args.steps)
    print(f"running {args.steps} HMC steps × {args.walkers} walkers "
          f"({args.leapfrog} leapfrog each)...")
    state, rates = run_chain(state, keys)  # compile + run
    jax.block_until_ready(state)
    t0 = time.perf_counter()
    state, rates = run_chain(state, keys)
    jax.block_until_ready(state)
    dt = time.perf_counter() - t0
    # exactly `leapfrog` fused value+gradient evaluations per HMC step
    # (the Metropolis value rides along in the last one for free)
    evals = args.steps * args.walkers * args.leapfrog
    print(f"accept rate {np.asarray(rates).mean():.2f}; "
          f"{evals:.2e} value+gradient evaluations in {dt:.2f}s "
          f"→ {evals / dt:.3e} valgrad-evals/s")

    post = np.asarray(jax.device_get(to_params(state[0])))
    for label, t, m in zip(model.par_labels, truth, post.mean(axis=0)):
        print(f"  {label:>7}: truth {t:10.4g}  posterior mean {m:10.4g}")


if __name__ == "__main__":
    main()
