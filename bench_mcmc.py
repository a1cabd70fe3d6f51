"""Benchmark: MCMC log-likelihood and value+gradient throughput on a GPU.

Prints ONE JSON line on stdout:
``{"metric": ..., "value": N, "unit": "loglik/s", "vs_baseline": N,
"device": {...}}``. Per-candidate tables go to stderr, and with
``--out PATH`` to a JSON file.

The MCMC inner loop scores a mega-batch of parameter draws against an
observed spectrum: ``-0.5·Σ((emulate(θ) − obs)²/σ²)`` per row. The
reference composes this from ~40 ms-per-signal ``predict`` calls ≈ 25
likelihood evaluations/s (reference ``README.rst:11``).

Forward candidates: method × tier —

* method ``direct`` (full network + residual reduction) or ``gram``
  (output layer collapsed to a quadratic form — the 451-wide output
  never exists; :func:`tpu21cmvae.ops.fold.gram_fold`);
* tier ``highest`` (exact f32), ``high`` or ``default`` (the backend's
  fast f32 dots; TF32 tensor-core arithmetic on an NVIDIA GPU).

Accuracy gate (two regimes, on the converged checkpoint — trained
weights are the hard cancellation regime): for every check row,

    |Δlog L| ≤ GATE_ATOL + GATE_RTOL · (max log L − log L)

against the exact-f32 direct path, evaluated on a far-field set (random
prior draws) AND a near-mode set (draws concentrated around the
observation's truth). Rationale: an MH acceptance decision compares two
proposals' log-likelihoods, so what must be accurate is the log L
*difference*; near the mode (depth → 0) the bound is 0.25 — a
deterministic, smooth perturbation of the log-density at that level
distorts the sampled posterior by ≤ e^±0.25, below MH's practical noise
floor — while in the tails errors proportional to the depth below the
mode cannot flip any decision that wasn't already marginal at the
1.5e-3 level (the same relative budget as bench.py's prediction gate).

Gradient table (``∇logL`` — the HMC/NUTS inner loop,
:func:`tpu21cmvae.ops.loglik.make_loglik_and_grad`): candidates cross
variant (autodiff / analytic gram backward) × value tier × backward
tier. Two gates apply:

* the VALUE output passes the same ΔlogL gate as the forward table —
  the Metropolis accept step consumes it, so it bounds posterior
  correctness;
* the GRADIENT passes a two-part bound on the per-row relative error
  ``rel = ‖Δg‖ / (‖g_ref‖ + rms‖g_ref‖)`` against the exact-f32
  autodiff reference, on far + near sets: the 99.9th percentile of
  ``rel`` ≤ GRAD_RTOL (bulk accuracy) AND max ``rel`` ≤ GRAD_MAX_REL
  (no garbage rows). Rationale: leapfrog with ANY deterministic
  approximate force field remains reversible and volume-preserving, so
  with a gated value in the accept step the posterior stays exact
  regardless of gradient error — the gate only needs to keep the
  acceptance-rate cost negligible. A max-over-rows bound at the bulk
  threshold is the wrong shape: precision-tier changes flip isolated
  ReLU masks on rows sitting at a kink — rows whose EXACT gradient is
  already set-valued — and such a row moves by O(1) no matter how
  accurate the matmuls are. The loose cap only rejects NaN/catastrophic
  candidates; the rms term keeps near-mode rows (where ‖g‖ → 0) from
  dominating.

Every candidate is timed (warm-up compile, then ``ITERS`` calls on a
resident device batch ending in ``block_until_ready``); the gate decides
which may be selected. Each line reports the achieved logical TFLOP/s:
the matmul FLOPs the algorithm needs per row (:func:`_flops_per_row`)
times the row rate. A candidate that raises fails the run. Runs only on
a GPU.
"""

from __future__ import annotations

import json
import os
import sys
import time

import jax
import jax.numpy as jnp
import numpy as np

BASELINE_LOGLIK_PER_SEC = 25.0  # reference: ~40 ms/signal, README.rst:11
BATCH = 1 << 20
ITERS = 20
GATE_ATOL = 0.25  # |dlogL| allowed at the posterior mode
GATE_RTOL = 1.5e-3  # per unit of depth below the mode
GRAD_RTOL = 1e-2  # 99.9th-pct bound on rel grad error — module docstring
GRAD_MAX_REL = 0.5  # hard per-row cap: rejects NaN/garbage, not kink rows
_CHECK = 1 << 16  # far-field rows used for the accuracy gate
_NEAR = 4096  # near-mode rows
NOISE_VAR = 25.0  # mK² — a plausible radiometer noise level

PRETRAINED = os.path.join(
    os.path.dirname(os.path.abspath(__file__)), "pretrained", "direct_synthetic.npz"
)


def loglik_gate_violation(got: np.ndarray, ref: np.ndarray) -> float:
    """Worst excess of |ΔlogL| over the depth-scaled allowance (≤0 ok)."""
    depth = ref.max() - ref
    return float((np.abs(got - ref) - (GATE_ATOL + GATE_RTOL * depth)).max())


def grad_gate_violation(got: np.ndarray, ref: np.ndarray) -> float:
    """Worst RELATIVE excess over the two-part gradient gate (≤0 ok):
    q99.9 of rel ≤ GRAD_RTOL and max rel ≤ GRAD_MAX_REL (see module
    docstring for why the bulk/cap split is the right shape)."""
    norm = np.linalg.norm(ref, axis=1)
    rms = np.sqrt(np.mean(norm**2))
    rel = np.linalg.norm(got - ref, axis=1) / (norm + rms)
    q999 = float(np.quantile(rel, 0.999))
    return max(q999 - GRAD_RTOL, float(rel.max()) - GRAD_MAX_REL)


def near_mode_draws(truth: np.ndarray, raw: np.ndarray, n: int, rng):
    """``n`` draws concentrated around ``truth`` (3e-4 of the prior span)
    — the regime a converged MCMC chain actually samples."""
    span = raw.max(0) - raw.min(0)
    near = truth[None, :] + 3e-4 * span[None, :] * rng.standard_normal(
        (n, raw.shape[1])
    )
    return np.clip(near, raw.min(0), raw.max(0)).astype(np.float32)


def _build():
    from tpu21cmvae.data.synthetic import synthetic_params
    from tpu21cmvae.models.direct import DirectEmulator

    model = DirectEmulator.from_checkpoint(PRETRAINED)
    rng = np.random.default_rng(0)
    raw = synthetic_params(BATCH, rng).astype(np.float32)
    # synthetic observation: the emulated signal of one draw plus noise
    truth = raw[0]
    obs = model.predict(truth) + rng.normal(0.0, NOISE_VAR**0.5, 451)
    near = near_mode_draws(truth, raw, _NEAR, rng)
    return model, raw, near, jnp.asarray(obs, jnp.float32)


def _flops_per_row(sizes, method: str, grad: str = "") -> int:
    """Logical matmul FLOPs per row. Forward: every layer (``direct``),
    or the hidden trunk plus the hidden×hidden gram head (``gram``).
    Value+gradient: the analytic backward adds one transposed matmul per
    trunk layer; autodiff is counted as twice its forward."""
    pairs = list(zip(sizes[:-1], sizes[1:]))
    if method == "direct":
        fwd = 2 * sum(a * b for a, b in pairs)
        trunk = fwd
    else:
        trunk = 2 * sum(a * b for a, b in pairs[:-1])
        fwd = trunk + 2 * sizes[-2] ** 2
    if grad == "analytic":
        return fwd + trunk
    if grad == "autodiff":
        return 2 * fwd
    return fwd


def _time_fn(fn, params, x) -> float:
    jax.block_until_ready(fn(params, x))  # compile + warm
    t0 = time.perf_counter()
    for _ in range(ITERS):
        out = fn(params, x)
    jax.block_until_ready(out)
    return (time.perf_counter() - t0) / ITERS


def _forward_candidates():
    return [
        (f"{method}-{tier}", dict(method=method, precision=tier))
        for method in ("direct", "gram")
        for tier in ("highest", "high", "default")
    ]


def _grad_candidates():
    """(name, kwargs) value+gradient candidates: variant × value tier ×
    backward tier (suffix ``/g<tier>`` where the backward tier differs
    from the value tier)."""
    return [
        ("gram-an-highest", dict(precision="highest",
                                 grad_precision="highest")),
        ("gram-an-high", dict(precision="high")),
        ("gram-an-high/gdefault", dict(precision="high",
                                       grad_precision="default")),
        ("gram-an-default", dict(precision="default")),
        # autodiff baselines (backward tier == value tier by construction);
        # direct-ad-highest is the contract row the speedup quotes
        ("direct-ad-highest", dict(method="direct", variant="autodiff",
                                   precision="highest")),
        ("direct-ad-high", dict(method="direct", variant="autodiff",
                                precision="high")),
        ("gram-ad-highest", dict(method="gram", variant="autodiff",
                                 precision="highest")),
        ("gram-ad-high", dict(method="gram", variant="autodiff",
                              precision="high")),
    ]


def main(out_path=None):
    from tpu21cmvae.ops.loglik import make_loglik, make_loglik_and_grad
    from tpu21cmvae.utils.compile_cache import enable_compile_cache
    from tpu21cmvae.utils.profiling import gpu_card_info

    enable_compile_cache()
    dev = jax.devices()[0]
    if dev.platform != "gpu":
        sys.exit(f"bench_mcmc: needs a GPU; JAX found {dev.platform}")
    device = {"platform": dev.platform, "kind": dev.device_kind,
              "count": len(jax.devices())}
    card = gpu_card_info()
    print(f"bench_mcmc: {device} | nvidia-smi: {card}", file=sys.stderr)

    model, raw, near, obs = _build()
    x = jnp.asarray(raw)
    xnear = jnp.asarray(near)
    params = model.params
    sizes = model.config.mlp().sizes

    def build_ll(**kw):
        return jax.jit(make_loglik(model.config, model.normalizer, obs,
                                   NOISE_VAR, **kw))

    def build_vg(**kw):
        return jax.jit(make_loglik_and_grad(model.config, model.normalizer,
                                            obs, NOISE_VAR, **kw))

    contract = build_vg(method="direct", variant="autodiff",
                        precision="highest")
    ref_far = [np.asarray(a) for a in contract(params, x[:_CHECK])]
    ref_near = [np.asarray(a) for a in contract(params, xnear)]

    rows, best_name, best_dt = [], None, float("inf")
    for name, kw in _forward_candidates():
        fn = build_ll(**kw)
        viol = max(
            loglik_gate_violation(np.asarray(fn(params, x[:_CHECK])),
                                  ref_far[0]),
            loglik_gate_violation(np.asarray(fn(params, xnear)),
                                  ref_near[0]),
        )
        dt = _time_fn(fn, params, x)
        ok = viol <= 0.0  # NaN-safe: NaN/Inf never passes
        tflops = BATCH / dt * _flops_per_row(sizes, kw["method"]) / 1e12
        rows.append({"candidate": name, "gate_margin": -viol,
                     "gate_passed": ok, "mloglik_per_s": BATCH / dt / 1e6,
                     "logical_tflops": tflops})
        print(f"bench_mcmc: {name} gate {'ok' if ok else 'REJECTED'} "
              f"(margin {-viol:.3e}), {BATCH / dt / 1e6:.2f}M loglik/s, "
              f"{tflops:.1f} logical TFLOP/s", file=sys.stderr)
        if ok and dt < best_dt:
            best_name, best_dt = name, dt

    grad_rows, gbest_name, gbest_dt = [], None, float("inf")
    for name, kw in _grad_candidates():
        fn = build_vg(**kw)
        vf, gf = fn(params, x[:_CHECK])
        vn, gn = fn(params, xnear)
        v_viol = max(loglik_gate_violation(np.asarray(vf), ref_far[0]),
                     loglik_gate_violation(np.asarray(vn), ref_near[0]))
        g_viol = max(grad_gate_violation(np.asarray(gf), ref_far[1]),
                     grad_gate_violation(np.asarray(gn), ref_near[1]))
        dt = _time_fn(fn, params, x)
        ok = v_viol <= 0.0 and g_viol <= 0.0
        method = kw.get("method", "gram")
        variant = kw.get("variant", "analytic")
        tflops = (BATCH / dt * _flops_per_row(sizes, method, variant)
                  / 1e12)
        grad_rows.append({
            "candidate": name, "value_margin": -v_viol,
            "grad_margin": -g_viol, "gate_passed": ok,
            "mvalgrad_per_s": BATCH / dt / 1e6, "logical_tflops": tflops,
        })
        print(f"bench_mcmc: grad {name} gates {'ok' if ok else 'REJECTED'} "
              f"(value {-v_viol:.3e}, grad {-g_viol:.3e}), "
              f"{BATCH / dt / 1e6:.2f}M valgrad/s, "
              f"{tflops:.1f} logical TFLOP/s", file=sys.stderr)
        if ok and dt < gbest_dt:
            gbest_name, gbest_dt = name, dt

    if best_name is None or gbest_name is None:
        sys.exit("bench_mcmc: no forward or no gradient candidate passed "
                 "its accuracy gate")
    lps = BATCH / best_dt
    print(f"bench_mcmc: grad selected {gbest_name}, "
          f"{BATCH / gbest_dt / 1e6:.2f}M valgrad/s", file=sys.stderr)
    headline = {
        "metric": f"loglik_per_sec_batched[{best_name}]",
        "value": lps,
        "unit": "loglik/s",
        "vs_baseline": lps / BASELINE_LOGLIK_PER_SEC,
        "device": device,
    }
    if out_path:
        report = {
            "selected": headline,
            "candidates": rows,
            "grad_selected": {
                "metric": f"valgrad_per_sec_batched[{gbest_name}]",
                "value": BATCH / gbest_dt, "unit": "valgrad/s",
            },
            "grad_candidates": grad_rows,
            "card": card,
            "batch": BATCH,
            "gate": (
                f"value: |dlogL| <= {GATE_ATOL} + {GATE_RTOL}*depth, far + "
                f"near sets; grad rel = ||dg||/(||g_ref||+rms): q99.9 <= "
                f"{GRAD_RTOL}, max <= {GRAD_MAX_REL}"
            ),
        }
        with open(out_path, "w") as f:
            json.dump(report, f, indent=1)
    print(json.dumps(headline), flush=True)


if __name__ == "__main__":
    import argparse

    ap = argparse.ArgumentParser()
    ap.add_argument("--out", default=None,
                    help="write full candidate tables (forward + grad) "
                         "as JSON to this path")
    main(ap.parse_args().out)
