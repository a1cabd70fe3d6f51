"""Drive the emulator's main path once on an NVIDIA GPU and check it.

Usage::

    python chip_smoke.py               # one GPU: every phase below
    python chip_smoke.py --four-gpus   # only the 4-GPU mesh phase

Phases, each through the public API at the flagship's full width
(7→288→352→288→224→451, ``pretrained/direct_synthetic.npz``), each
compared with a plain reference — float64 NumPy on the host, or the same
plain JAX function at ``Precision.HIGHEST`` on the host CPU backend of
this process — and each printing its numbers beside their tolerance:

* ``device`` — JAX's first device is a GPU; its kind, the device count
  and the card's name and power limit (``nvidia-smi``);
* ``predict`` — ``predict_fn()`` over 2²⁰ resident rows; HIGHEST within
  2e-5 of each row's amplitude of a float64 forward; the fast tiers'
  deviation printed beside ``bench.py``'s 1.5e-3 gate; golden test
  error ≤ 0.20 %; the compiled program's memory analysis;
* ``likelihood`` — ``loglik_fn`` and ``loglik_and_grad_fn`` over 2²⁰
  walkers against ``method="direct"`` autodiff on the CPU backend, held
  to ``bench_mcmc.py``'s gates;
* ``train`` — 3 epochs of the published recipe (``device_loop=True``):
  finite, falling, first epoch within 1e-3 of the CPU backend's;
* ``sample`` — MH and HMC posteriors: finite log-posteriors, acceptance
  strictly between 0 and 1;
* ``serve`` — ``/predict`` and ``/loglik`` answers of an in-process HTTP
  server match the in-process model;
* ``deploy`` — the program exported with the default platforms
  (cpu, cuda) runs on the card within 5e-5 mK of ``predict``; where
  ``jax.export`` can serialize (the ``flatbuffers`` package), also the
  CLI's artifact file round trip and ``verify``'s deploy check.

A failing phase raises: the script then exits non-zero and never prints
its last line, ``{"ok": true, "device": {...}}``. It never falls back to
the CPU. Each phase is a function of its sizes; ``main()`` fixes the
full sizes and ``tests/test_chip_smoke.py`` runs them small on the CPU.
"""

from __future__ import annotations

import argparse
import dataclasses
import json
import os
import tempfile
import threading
import time
import urllib.request

import numpy as np

ROOT = os.path.dirname(os.path.abspath(__file__))
PRETRAINED = os.path.join(ROOT, "pretrained", "direct_synthetic.npz")
PRETRAINED_NATIVE = os.path.join(ROOT, "pretrained", "direct_synthetic_bf16.npz")

NOISE_VAR = 25.0  # mK², as bench_mcmc.py
PREDICT_REL_TO_AMP = 2e-5  # HIGHEST vs the float64 forward
GOLDEN_MEAN_PCT = 0.20  # the shipped-checkpoint regime (pretrained/)
TRAIN_FIRST_EPOCH_RTOL = 1e-3
SERVE_REL_TO_AMP = 1e-5  # same program, other batch padding
SERVE_LOGLIK_RTOL = 1e-5
DEPLOY_ATOL_MK = 5e-5  # verify.check_deploy_artifact's bound


class PhaseFailed(RuntimeError):
    """A phase's result is outside its tolerance."""


def _check(phase: str, what: str, value: float, tol: float) -> None:
    """Print ``value`` beside ``tol`` and raise unless value ≤ tol
    (NaN never passes)."""
    ok = bool(value <= tol)
    print(f"[{phase}] {what} = {value:.3e} (tol {tol:.1e}) "
          f"{'ok' if ok else 'FAIL'}", flush=True)
    if not ok:
        raise PhaseFailed(f"{phase}: {what} = {value!r} exceeds {tol!r}")


def _require(phase: str, cond: bool, msg: str) -> None:
    print(f"[{phase}] {msg}: {'ok' if cond else 'FAIL'}", flush=True)
    if not cond:
        raise PhaseFailed(f"{phase}: {msg}")


def numpy_forward(model, raw) -> np.ndarray:
    """The emulator's forward in float64 NumPy, written from the
    reference's definition (``preprocess.py:49-110``, ``emulator.py:
    12-48``, ``preprocess.py:27-46``) — independent of the JAX code."""
    norm = model.normalizer
    x = np.asarray(raw, np.float64).copy()
    x[x[:, 2] == 0.0, 2] = 1e-6
    x[:, :3] = np.log10(x[:, :3])
    lo = np.asarray(norm.par_min, np.float64)
    hi = np.asarray(norm.par_max, np.float64)
    h = 2.0 * (x - lo) / (hi - lo) - 1.0
    for i, layer in enumerate(model.params):
        h = h @ np.asarray(layer["w"], np.float64) + np.asarray(
            layer["b"], np.float64)
        if i < len(model.params) - 1:
            h = np.maximum(h, 0.0)
    return (h * float(norm.signal_std)
            + np.asarray(norm.signal_mean, np.float64))


def _rel_to_amp(got, ref) -> float:
    amp = np.abs(ref).max(axis=1, keepdims=True)
    return float((np.abs(np.asarray(got, np.float64) - ref) / amp).max())


def _on_cpu(tree):
    import jax

    return jax.device_put(tree, jax.devices("cpu")[0])


# -- phases -----------------------------------------------------------------


def phase_device(platform: str = "gpu") -> dict:
    """JAX's devices, and the card as ``nvidia-smi`` names it."""
    import jax

    devs = jax.devices()
    dev = devs[0]
    print(f"[device] platform={dev.platform} kind={dev.device_kind} "
          f"count={len(devs)}", flush=True)
    if dev.platform != platform:
        raise PhaseFailed(
            f"device: JAX found {dev.platform!r}, not a {platform!r} device"
        )
    from tpu21cmvae.utils.profiling import gpu_card_info

    print(f"[device] nvidia-smi: {gpu_card_info()}", flush=True)
    return {"platform": dev.platform, "kind": dev.device_kind,
            "count": len(devs)}


def phase_predict(model, native, golden, n_rows: int, n_check: int) -> dict:
    import jax.numpy as jnp

    from bench import GATE_REL_TO_AMP, golden_error_pct
    from tpu21cmvae.data.synthetic import synthetic_params

    raw = synthetic_params(n_rows, np.random.default_rng(0)).astype(np.float32)
    raw[:2, 2] = 0.0  # the fx == 0 clamp rows
    x = jnp.asarray(raw)  # resident on the device
    compiled = model.predict_fn().lower(model.params, x).compile()
    print(f"[predict] memory_analysis({n_rows} rows): "
          f"{compiled.memory_analysis()}", flush=True)
    out = np.asarray(compiled(model.params, x))
    _require("predict", out.shape == (n_rows, model.config.n_bins)
             and bool(np.isfinite(out).all()),
             f"{out.shape} output, all finite")
    ref = numpy_forward(model, raw[:n_check])
    worst = {"highest": _rel_to_amp(out[:n_check], ref)}
    _check("predict", f"HIGHEST max |Δ|/amp over {n_check} rows vs float64",
           worst["highest"], PREDICT_REL_TO_AMP)
    for tier in ("high", "default"):
        got = model.predict_fn(precision=tier)(model.params, x[:n_check])
        worst[tier] = _rel_to_amp(got, ref)
        print(f"[predict] {tier.upper()} max |Δ|/amp = {worst[tier]:.3e} "
              f"(bench.py gate {GATE_REL_TO_AMP:.1e}; not gated here)",
              flush=True)
    got = native.predict_fn(precision="native")(native.params, x[:n_check])
    worst["native"] = _rel_to_amp(got, numpy_forward(native, raw[:n_check]))
    print(f"[predict] tier-native checkpoint at {native.native_precision!r}"
          f" max |Δ|/amp vs its float64 forward = {worst['native']:.3e} "
          f"(bench.py gate {GATE_REL_TO_AMP:.1e}; not gated here)",
          flush=True)
    mean_pct, _ = golden_error_pct(model, golden)
    _check("predict", f"golden mean relative test error % "
           f"({len(golden.par_test)} signals, HIGHEST)",
           mean_pct, GOLDEN_MEAN_PCT)
    return {"worst": worst, "golden_mean_pct": mean_pct}


def phase_likelihood(model, obs, truth, n_walkers: int, n_near: int) -> dict:
    import jax

    from bench_mcmc import (
        grad_gate_violation,
        loglik_gate_violation,
        near_mode_draws,
    )
    from tpu21cmvae.data.synthetic import synthetic_params
    from tpu21cmvae.ops.loglik import make_loglik_and_grad

    rng = np.random.default_rng(1)
    far = synthetic_params(n_walkers, rng).astype(np.float32)
    near = near_mode_draws(np.asarray(truth, np.float32), far, n_near, rng)
    sets = {"far": far, "near": near}

    with jax.default_device(jax.devices("cpu")[0]):
        ref_fn = jax.jit(make_loglik_and_grad(
            model.config, _on_cpu(model.normalizer), np.asarray(obs),
            NOISE_VAR, method="direct", variant="autodiff",
            precision="highest",
        ))
        cpu_params = _on_cpu(model.params)
        ref = {k: [np.asarray(a) for a in ref_fn(cpu_params, _on_cpu(v))]
               for k, v in sets.items()}

    tiers = {
        "HIGHEST": (
            model.loglik_fn(obs, NOISE_VAR, precision="highest"),
            model.loglik_and_grad_fn(obs, NOISE_VAR, precision="highest",
                                     grad_precision="highest"),
        ),
        "default tier": (model.loglik_fn(obs, NOISE_VAR),
                         model.loglik_and_grad_fn(obs, NOISE_VAR)),
    }
    out = {}
    for tier, (ll, vg) in tiers.items():
        viol = {"loglik": [], "valgrad value": [], "gradient": []}
        for k, v in sets.items():
            val = np.asarray(ll(model.params, v))
            vg_val, vg_grad = (np.asarray(a) for a in vg(model.params, v))
            _require("likelihood", bool(np.isfinite(val).all()
                                        and np.isfinite(vg_grad).all()),
                     f"{tier} {k}: {len(v)} rows finite")
            viol["loglik"].append(loglik_gate_violation(val, ref[k][0]))
            viol["valgrad value"].append(
                loglik_gate_violation(vg_val, ref[k][0]))
            viol["gradient"].append(grad_gate_violation(vg_grad, ref[k][1]))
        out[tier] = {name: max(v) for name, v in viol.items()}
        for name, v in out[tier].items():
            what = (f"{tier} {name} worst excess over bench_mcmc's gate "
                    "(far + near)")
            if tier == "HIGHEST":
                _check("likelihood", what, v, 0.0)
            else:
                print(f"[likelihood] {what} = {v:.3e} (tol 0; not gated "
                      "here)", flush=True)
    return out


def phase_train(golden, epochs: int) -> dict:
    import jax

    from tpu21cmvae.models.direct import DirectEmulator
    from tpu21cmvae.utils.config import DIRECT_TRAIN_DEFAULT

    cfg = dataclasses.replace(DIRECT_TRAIN_DEFAULT, epochs=epochs)
    em = DirectEmulator(golden, seed=0)
    loss, _ = em.train(train_config=cfg, device_loop=True)
    with jax.default_device(jax.devices("cpu")[0]):
        em_cpu = DirectEmulator(golden, seed=0)
        cpu_loss, _ = em_cpu.train(
            train_config=dataclasses.replace(cfg, epochs=1),
            device_loop=True,
        )
    loss = [float(v) for v in loss]
    print(f"[train] per-epoch loss {loss}; CPU backend epoch 1 "
          f"{float(cpu_loss[0])}", flush=True)
    _require("train", len(loss) == epochs and bool(np.isfinite(loss).all()),
             f"{epochs} finite epoch losses")
    _require("train", loss[-1] < loss[0], "loss falls")
    rel = abs(loss[0] - float(cpu_loss[0])) / abs(float(cpu_loss[0]))
    _check("train", "first-epoch loss relative to the CPU backend", rel,
           TRAIN_FIRST_EPOCH_RTOL)
    return {"loss": loss, "cpu_first": float(cpu_loss[0])}


def phase_sample(model, obs, n_walkers: int, n_steps: int,
                 n_warmup: int) -> dict:
    out = {}
    for sampler in ("mh", "hmc"):
        res = model.sample_posterior(
            obs, NOISE_VAR, sampler=sampler, n_walkers=n_walkers,
            n_steps=n_steps, n_warmup=n_warmup, seed=0,
        )
        acc = float(np.mean(res.accept_rate))
        print(f"[sample] {sampler}: {n_walkers} walkers x {n_steps} steps, "
              f"mean acceptance {acc:.3f}, median log-posterior "
              f"{float(np.median(res.logp)):.2f}", flush=True)
        _require("sample", bool(np.isfinite(res.logp).all()),
                 f"{sampler} log-posteriors finite")
        _require("sample", 0.0 < acc < 1.0,
                 f"{sampler} acceptance strictly inside (0, 1)")
        out[sampler] = acc
    return out


def _post(url: str, payload: dict) -> dict:
    req = urllib.request.Request(
        url, data=json.dumps(payload).encode(),
        headers={"Content-Type": "application/json"},
    )
    with urllib.request.urlopen(req, timeout=600) as r:
        return json.loads(r.read())


def phase_serve(model, obs, batches=(1, 256, 1024)) -> dict:
    from tpu21cmvae.data.synthetic import synthetic_params
    from tpu21cmvae.serve import make_server

    server = make_server(model, port=0)
    thread = threading.Thread(target=server.serve_forever, daemon=True)
    thread.start()
    base = "http://127.0.0.1:%d" % server.server_address[1]
    out = {}
    try:
        rng = np.random.default_rng(2)
        for b in batches:
            rows = synthetic_params(b, rng).astype(np.float32)
            got = np.asarray(_post(base + "/predict",
                                   {"params": rows.tolist()})["signals"])
            want = np.atleast_2d(model.predict(rows)).astype(np.float64)
            out[f"predict[{b}]"] = _rel_to_amp(got, want)
            _check("serve", f"/predict batch {b} max |Δ|/amp vs in-process",
                   out[f"predict[{b}]"], SERVE_REL_TO_AMP)
        rows = synthetic_params(64, rng).astype(np.float32)
        got = np.asarray(_post(base + "/loglik", {
            "params": rows.tolist(), "obs": np.asarray(obs).tolist(),
            "noise_var": NOISE_VAR,
        })["loglik"])
        want = np.asarray(model.loglik_fn(obs, NOISE_VAR)(model.params, rows))
        out["loglik"] = float((np.abs(got - want) / np.abs(want)).max())
        _check("serve", "/loglik 64 rows max relative |Δ| vs in-process",
               out["loglik"], SERVE_LOGLIK_RTOL)
    finally:
        server.shutdown()
        server.server_close()
        thread.join(timeout=30)
    _require("serve", not thread.is_alive(), "server thread stopped")
    return out


def phase_deploy(model, golden, ckpt_path: str, n_rows: int) -> dict:
    """The exported program (default platforms) runs on this device and
    matches ``predict``. Where ``jax.export`` can serialize (it needs the
    ``flatbuffers`` package), also the CLI's artifact file round trip and
    ``verify``'s deploy check."""
    import importlib.util

    import jax

    from tpu21cmvae import deploy

    here = jax.export.default_export_platform()
    exported = deploy.export_predict(model)
    _require("deploy", tuple(exported.platforms) == deploy.DEFAULT_PLATFORMS
             and here in exported.platforms,
             f"export with default platforms {exported.platforms} "
             f"includes {here!r}")
    raw = np.asarray(golden.par_test[:n_rows], np.float32)
    want = model.predict(raw)
    out = {"exported_max_abs_mk": float(
        np.abs(np.asarray(exported.call(raw)) - want).max())}
    _check("deploy", f"exported program vs predict max |Δ| mK over "
           f"{len(raw)} rows", out["exported_max_abs_mk"], DEPLOY_ATOL_MK)
    if importlib.util.find_spec("flatbuffers") is None:
        print("[deploy] artifact file round trip and verify's deploy "
              "check: not run — jax.export serialization needs the "
              "flatbuffers package, which this installation lacks",
              flush=True)
        return out

    from tpu21cmvae.__main__ import main as cli
    from tpu21cmvae.verify import check_deploy_artifact

    with tempfile.TemporaryDirectory() as d:
        path = os.path.join(d, "emulator.bin")
        rc = cli(["export-artifact", ckpt_path, "--out", path])
        fn = deploy.load_artifact(path)
    _require("deploy", rc in (None, 0)
             and fn.platforms == deploy.DEFAULT_PLATFORMS,
             f"CLI export-artifact with default platforms -> {fn.platforms}")
    out["artifact_max_abs_mk"] = float(np.abs(fn(raw) - want).max())
    _check("deploy", f"artifact file vs predict max |Δ| mK over {len(raw)} "
           "rows", out["artifact_max_abs_mk"], DEPLOY_ATOL_MK)
    check = check_deploy_artifact(golden, model)
    print(f"[deploy] verify {check.name}: {check.status} — {check.detail}",
          flush=True)
    _require("deploy", check.status == "PASS", "verify deploy check")
    return out


def phase_four_gpus(model, golden, obs, n_devices: int, n_rows: int,
                    n_walkers: int, n_steps: int) -> dict:
    """The data mesh over ``n_devices``: sharded predict, one DP train
    step and an MH chain, each against its one-device twin."""
    import jax
    import jax.numpy as jnp

    from tpu21cmvae.data.synthetic import synthetic_params
    from tpu21cmvae.ops.transforms import par_transform, preproc
    from tpu21cmvae.parallel import (
        ShardedEmulator,
        make_dp_train_step,
        make_mesh,
        replicate,
        shard_batch,
    )
    from tpu21cmvae.sampling import sample_mh
    from tpu21cmvae.train.adam import adam_init
    from tpu21cmvae.utils.config import DIRECT_TRAIN_DEFAULT

    devs = jax.devices()
    _require("four_gpus", len(devs) >= n_devices,
             f"{len(devs)} devices for a {n_devices}-device mesh")
    mesh = make_mesh(devs[:n_devices])
    one = make_mesh(devs[:1])
    out = {}

    raw = synthetic_params(n_rows, np.random.default_rng(3)).astype(np.float32)
    got = ShardedEmulator.for_model(model, mesh=mesh)(raw)
    want = np.asarray(model.predict_fn()(model.params,
                                         jax.device_put(raw, devs[0])))
    out["predict"] = _rel_to_amp(got, want.astype(np.float64))
    _check("four_gpus", f"sharded predict ({n_rows} rows) max |Δ|/amp vs "
           "one device", out["predict"], PREDICT_REL_TO_AMP)

    bs = DIRECT_TRAIN_DEFAULT.batch_size
    bx = par_transform(jnp.asarray(golden.par_train[:bs], jnp.float32),
                       model.normalizer)
    by = preproc(jnp.asarray(golden.signal_train[:bs], jnp.float32),
                 model.normalizer)
    lr = jnp.float32(DIRECT_TRAIN_DEFAULT.learning_rate)
    res = {}
    for name, m in (("mesh", mesh), ("one", one)):
        step = make_dp_train_step(model.loss_fn(), DIRECT_TRAIN_DEFAULT, m)
        res[name] = step(replicate(model.params, m),
                         replicate(adam_init(model.params), m), lr,
                         shard_batch(bx, m), shard_batch(by, m))
    (_, s_mesh, l_mesh), (_, s_one, l_one) = res["mesh"], res["one"]
    out["step_loss"] = abs(float(l_mesh) - float(l_one)) / abs(float(l_one))
    _check("four_gpus", "DP step loss relative to one device",
           out["step_loss"], 1e-5)
    # Adam's first moment after one step is (1 − β₁)·gradient: compare
    # the all-reduced gradient itself (the updated weights are ±lr·sign(g)
    # and flip wherever a gradient entry is rounding-level)
    g_mesh = jax.tree_util.tree_leaves(s_mesh.mu)
    g_one = jax.tree_util.tree_leaves(s_one.mu)
    out["step_grad"] = max(
        float(np.abs(np.asarray(a) - np.asarray(b)).max()
              / np.abs(np.asarray(b)).max())
        for a, b in zip(g_mesh, g_one)
    )
    _check("four_gpus", "DP step gradient max |Δ| / max |g| vs one device",
           out["step_grad"], 1e-4)

    ll = model.loglik_fn(obs, NOISE_VAR)
    kw = dict(n_walkers=n_walkers, n_steps=n_steps, n_warmup=n_steps,
              seed=0)
    chain_mesh = sample_mh(ll, replicate(model.params, mesh), mesh=mesh, **kw)
    chain_one = sample_mh(ll, model.params, **kw)
    acc = float(np.mean(chain_mesh.accept_rate))
    _require("four_gpus", bool(np.isfinite(chain_mesh.logp).all())
             and 0.0 < acc < 1.0,
             f"sharded MH finite, acceptance {acc:.3f} inside (0, 1)")
    sd = chain_one.final.std(axis=0)
    out["mh_mean"] = float((np.abs(chain_mesh.final.mean(axis=0)
                                   - chain_one.final.mean(axis=0)) / sd).max())
    _check("four_gpus", "sharded MH posterior mean |Δ| / posterior sd vs "
           "one device", out["mh_mean"], 0.1)
    return out


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--four-gpus", action="store_true",
                    help="run only the 4-GPU mesh phase")
    args = ap.parse_args(argv)

    from bench import golden_split
    from tpu21cmvae.models.direct import DirectEmulator
    from tpu21cmvae.utils.compile_cache import enable_compile_cache

    device = phase_device()
    enable_compile_cache()
    model = DirectEmulator.from_checkpoint(PRETRAINED)
    golden = golden_split()
    obs = np.asarray(golden.signal_test[0], np.float32)
    if args.four_gpus:
        phases = [("four_gpus", lambda: phase_four_gpus(
            model, golden, obs, n_devices=4, n_rows=1 << 20,
            n_walkers=4096, n_steps=200))]
    else:
        native = DirectEmulator.from_checkpoint(PRETRAINED_NATIVE)
        phases = [
            ("predict", lambda: phase_predict(
                model, native, golden, n_rows=1 << 20, n_check=4096)),
            ("likelihood", lambda: phase_likelihood(
                model, obs, golden.par_test[0], n_walkers=1 << 20,
                n_near=4096)),
            ("train", lambda: phase_train(golden, epochs=3)),
            ("sample", lambda: phase_sample(
                model, obs, n_walkers=4096, n_steps=300, n_warmup=200)),
            ("serve", lambda: phase_serve(model, obs)),
            ("deploy", lambda: phase_deploy(
                model, golden, PRETRAINED, n_rows=1024)),
        ]
    for name, run in phases:
        t0 = time.perf_counter()
        run()
        print(f"[{name}] passed in {time.perf_counter() - t0:.1f} s "
              "(compilation included)", flush=True)
    print(json.dumps({"ok": True, "device": device}), flush=True)
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
