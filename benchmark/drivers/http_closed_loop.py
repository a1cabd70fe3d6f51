"""Closed-loop clients of the served emulator: samplers calling the
package's HTTP server (``tpu21cmvae.serve.make_server``, what
``python -m tpu21cmvae serve`` starts) from other processes.

Traffic parameters: ``endpoint``, ``clients`` (child processes, each
with one request in flight), the size mix (``single_row_share``,
``multi_rows_min``, ``multi_rows_max``, ``cycle``), ``sample_share`` of
requests whose answers are compared, ``latency_metric`` and
``percentile``.

Set-up loads the checkpoint through the package, builds the server in
this process, compiles every batch bucket a request of the mix can hit
(``warmup(up_to=multi_rows_max)``), serves from a thread, and starts
the clients, each of which sends one warm-up request of the smallest
and the largest size. The window opens when every client is ready and
closes at its deadline; requests in flight then finish and count.
"""

from __future__ import annotations

import json
import os
import subprocess
import sys
import threading
import time

import numpy as np

from benchmark import compare, stats
from benchmark.reference import common
from benchmark.trace import span

CLIENT = os.path.join(os.path.dirname(os.path.dirname(os.path.abspath(
    __file__))), "http_client.py")


class _Served:
    """What the server serves: the package's model, or the reference in
    its place (the control), with the ``predict_fn``/``params``/``config``
    the server reads."""

    def __init__(self, model, fn, params):
        self.config = model.config
        self.params = params
        self._fn = fn

    def predict_fn(self):
        return self._fn


def _served(ctx, model, ref, weights):
    import jax

    if ctx.control is None:
        fn, params = model.predict_fn(), model.params
    else:
        matmul = common.MATMULS[ctx.control]
        fn = jax.jit(lambda w, x: ref.forward(w, x, matmul))
        params = weights
    if ctx.program_wrap is not None:
        fn = ctx.program_wrap(fn)
    if ctx.control is None and ctx.program_wrap is None:
        return model
    return _Served(model, fn, params)


def run(ctx) -> dict:
    from tpu21cmvae.models import load_model
    from tpu21cmvae.serve import make_server

    cell, mix, config = ctx.cell, ctx.cell.traffic, ctx.cell.config
    device = ctx.devices[0]
    ref = cell.reference()
    weights = ref.load(ctx.checkpoint, config)
    model = load_model(ctx.checkpoint)
    server = make_server(_served(ctx, model, ref, weights),
                         host="127.0.0.1", port=0)
    service = server.service
    service.warmup(up_to=int(mix["multi_rows_max"]))
    service_predict = service.predict

    def predict(params):
        with span("service_predict"):
            return service_predict(params)

    service.predict = predict
    thread = threading.Thread(target=server.serve_forever,
                              kwargs={"poll_interval": 0.05})
    thread.start()
    clients = []
    try:
        port = server.server_address[1]
        for c in range(int(mix["clients"])):
            args = {"port": port, "seed": ctx.seed, "client": c, "mix": mix}
            clients.append(subprocess.Popen(
                [sys.executable, CLIENT, json.dumps(args)],
                stdin=subprocess.PIPE, stdout=subprocess.PIPE, text=True))
        for proc in clients:
            if proc.stdout.readline().strip() != "ready":
                raise RuntimeError("a client failed to start")
        results = []
        with ctx.recording():
            with span("window"):
                t0 = time.perf_counter()
                deadline = time.monotonic() + ctx.seconds
                for proc in clients:
                    proc.stdin.write(f"{deadline!r}\n")
                    proc.stdin.close()
                with span("serve_http"):
                    for proc in clients:
                        out = proc.stdout.read()
                        proc.wait(timeout=300)
                        if proc.returncode != 0:
                            raise RuntimeError(
                                f"client exited {proc.returncode}")
                        results.append(json.loads(out))
                t1 = time.perf_counter()
    finally:
        for proc in clients:
            if proc.poll() is None:
                proc.kill()
            proc.wait()
        server.shutdown()
        server.server_close()
        thread.join(timeout=60)
    memory_peak = ctx.memory_peak()

    latencies = [x for r in results for x in r["latencies_ms"]]
    attempted = sum(r["attempted"] for r in results)
    failed = sum(r["failed"] for r in results)
    samples = [s for r in results for s in r["samples"]]
    numbers, bad_shape = _compare(samples, ref, weights, device,
                                  config["n_bins"])
    window = t1 - t0
    q = float(mix["percentile"])
    return {
        "t_window": t0,
        "window_s": window,
        "attempted": attempted,
        "failed": failed + bad_shape,
        "e2e": {mix["latency_metric"]: stats.percentile(latencies, q)
                if latencies else float("inf")},
        "numbers": numbers,
        "memory_peak_bytes": memory_peak,
        "work": {"entry": "serve", "requests": attempted - failed,
                 "rows_per_s": None},
        "notes": [
            f"{attempted} requests ({failed} failed) from {len(results)} "
            f"clients over {window:.3f} s; median "
            f"{stats.percentile(latencies, 50):.3f} ms, p{q:g} "
            f"{stats.percentile(latencies, q):.3f} ms; client time between "
            "requests (ms): " + ", ".join(
                f"{r['client_gap_ms']:.3f}" for r in results),
            f"{len(samples)} answers compared, "
            f"{sum(len(s[0]) for s in samples)} rows",
        ] + [f"failed request: {e}" for r in results for e in r["errors"]],
    }


def _compare(samples, ref, weights, device, n_bins):
    """Widest signal gap over the sampled answers, and how many answers
    came back with the wrong shape."""
    import jax

    if not samples:
        return {"signal_gap": float("nan")}, 0
    rows = np.concatenate([np.asarray(s[0], np.float32) for s in samples])
    bad = sum(np.shape(s[1]) != (len(s[0]), n_bins) for s in samples)
    if bad:
        return {"signal_gap": float("inf")}, bad
    got = np.concatenate([np.asarray(s[1], np.float32) for s in samples])
    fwd = jax.jit(lambda w, x: ref.forward(w, x))
    want = fwd(jax.device_put(weights, device), jax.device_put(rows, device))
    return {"signal_gap": compare.signal_gap(jax.numpy.asarray(got), want)}, 0
