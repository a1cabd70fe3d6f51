"""Closed loop over resident batches: the bulk-emulation, MCMC-likelihood
and HMC value+gradient inner loops.

Traffic parameters: ``entry`` (``predict``, ``loglik`` or ``valgrad``),
``rows`` per call, ``distinct_batches`` drawn from the seed and cycled
through, ``rate_metric`` (the end-to-end metric the rows per second are
reported as) and, for a likelihood, ``observation`` (truth row, noise
variance and noise seed, fixed by the file).

Set-up loads the checkpoint through the package, draws the batches,
puts them on the device and calls the entry once per batch (compiling
or loading from the persistent cache). The window dispatches calls back
to back, at most ``distinct_batches`` in flight, until ``--seconds``
have passed, then waits for the last. The last answer of every batch
is compared with the plain reference once the window has closed.
"""

from __future__ import annotations

import collections
import time

import numpy as np

from benchmark import compare, stats, traffic
from benchmark.reference import common
from benchmark.trace import span

BLOCK_ROWS = 1 << 18  # rows per reference block


def observation(ref, weights64, mix: dict):
    """The mix's observed signal: the float64 reference at its truth row
    plus its seeded noise, rounded to float32."""
    truth, noise, noise_var = traffic.observation_rows(mix)
    signal = np.asarray(ref.forward(weights64, truth, np.matmul, np))[0]
    return (signal + noise).astype(np.float32), noise_var


def program_entry(model, config: dict, entry: str, obs, noise_var):
    opts = config.get("entry_options", {}).get(entry, {})
    if entry == "predict":
        return model.predict_fn(**opts)
    if entry == "loglik":
        return model.loglik_fn(obs, noise_var, **opts)
    if entry == "valgrad":
        return model.loglik_and_grad_fn(obs, noise_var, **opts)
    raise ValueError(f"unknown entry {entry!r}")


def reference_entry(ref, entry: str, obs, noise_var, matmul):
    """The reference's ``(weights, rows) → answer`` for an entry."""
    import jax
    import jax.numpy as jnp

    def predict(w, x):
        return ref.forward(w, x, matmul)

    def loglik(w, x):
        return common.loglik(ref.forward(w, x, matmul), obs, noise_var)

    def valgrad(w, x):
        val, vjp = jax.vjp(lambda r: loglik(w, r), x)
        return val, vjp(jnp.ones_like(val))[0]

    return jax.jit({"predict": predict, "loglik": loglik,
                    "valgrad": valgrad}[entry])


def compare_answers(entry: str, answers, batches, ref_fn, weights, n_bins):
    """The cell's numbers over every row of every kept answer."""
    gaps, dnorms, rnorms = [], [], []
    for out, x in zip(answers, batches):
        if out is None:  # a batch the window never reached
            continue
        for a in range(0, x.shape[0], BLOCK_ROWS):
            b = a + BLOCK_ROWS
            ref = ref_fn(weights, x[a:b])
            if entry == "predict":
                gaps.append(compare.signal_gap(out[a:b], ref))
            elif entry == "loglik":
                gaps.append(compare.loglik_gap(out[a:b], ref, n_bins))
            else:
                gaps.append(compare.loglik_gap(out[0][a:b], ref[0], n_bins))
                d, n = compare.grad_rel_rows(out[1][a:b], ref[1])
                dnorms.append(d)
                rnorms.append(n)
    key = "signal_gap" if entry == "predict" else "loglik_gap"
    numbers = {key: max(gaps)}
    if entry == "valgrad":
        numbers["grad_gap_q999"] = compare.grad_gap_q999(dnorms, rnorms)
    return numbers


def run(ctx) -> dict:
    import jax

    from tpu21cmvae.models import load_model

    cell, mix, config = ctx.cell, ctx.cell.traffic, ctx.cell.config
    entry, rows, k = mix["entry"], int(mix["rows"]), int(mix["distinct_batches"])
    device = ctx.devices[0]
    ref = cell.reference()
    weights = ref.load(ctx.checkpoint, config)
    obs, noise_var = (observation(ref, common.as_float64(weights), mix)
                      if "observation" in mix else (None, None))

    model = load_model(ctx.checkpoint)
    if ctx.control is None:
        fn, params = program_entry(model, config, entry, obs, noise_var), \
            model.params
    else:  # the reference at a lower precision, in the program's place
        fn = reference_entry(ref, entry, obs, noise_var,
                             common.MATMULS[ctx.control])
        params = jax.device_put(weights, device)
    if ctx.program_wrap is not None:
        fn = ctx.program_wrap(fn)

    rng = traffic.rng_for(ctx.seed)
    batches = [jax.device_put(traffic.prior_rows(rows, rng).astype(np.float32),
                              device) for _ in range(k)]
    for x in batches:  # compile (or load from the cache) and warm
        jax.block_until_ready(fn(params, x))

    answers = [None] * k
    inflight = collections.deque()
    calls = 0
    with ctx.recording():
        with span("window"):
            t0 = time.perf_counter()
            deadline = t0 + ctx.seconds
            while True:
                i = calls % k
                with span("dispatch"):
                    out = fn(params, batches[i])
                answers[i] = out
                inflight.append(out)
                calls += 1
                if len(inflight) >= k:
                    with span("block"):
                        jax.block_until_ready(inflight.popleft())
                if time.perf_counter() >= deadline:
                    break
            with span("block"):
                jax.block_until_ready(list(inflight))
            t1 = time.perf_counter()
    inflight.clear()
    memory_peak = ctx.memory_peak()

    ref_fn = reference_entry(ref, entry, obs, noise_var, common.matmul_f32)
    numbers = compare_answers(entry, answers, batches, ref_fn,
                              jax.device_put(weights, device), config["n_bins"])
    window = t1 - t0
    return {
        "t_window": t0,
        "window_s": window,
        "attempted": calls,
        "failed": 0,
        "e2e": {mix["rate_metric"]: stats.rate(calls * rows, window)},
        "numbers": numbers,
        "memory_peak_bytes": memory_peak,
        "work": {"entry": entry, "rows": calls * rows, "calls": calls,
                 "rows_per_s": calls * rows / window},
        "notes": [f"{calls} calls of {rows} rows over {window:.3f} s"],
    }
