"""Run one cell of the benchmark and print its result line.

    python3 benchmark/run.py --workload <cell> --seed <n> --seconds <s> \
        --trace <0|1>

The cell is an entry of ``workloads`` in ``BENCHMARK.json``; its
configuration, traffic mix and checks are found by name
(:mod:`benchmark.spec`). The run loads the cell's checkpoint through the
package under test, draws its inputs from ``--seed``, warms every shape
its traffic uses, measures for ``--seconds`` and compares what the
timed path produced with the plain reference. With ``--trace 0`` the
result carries the cell's end-to-end metrics, with ``--trace 1`` its
per-layer metrics, read from a profiler trace of the window.

The last line on standard output is one JSON object: ``correct``,
``attempted``, ``failed``, ``metrics``, ``device``, with ``--trace 1``
``breakdown``, and last ``checks`` (each compared number and its
limit), which are also the last lines on standard error. A run that
finds no GPU, or fewer than the cell's chips, exits non-zero and prints
no result.
"""

from __future__ import annotations

import time

T_START = time.perf_counter()

import argparse  # noqa: E402
import contextlib  # noqa: E402
import dataclasses  # noqa: E402
import json  # noqa: E402
import os  # noqa: E402
import shutil  # noqa: E402
import sys  # noqa: E402

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
if ROOT not in sys.path:
    sys.path.insert(0, ROOT)

from benchmark import card, compare, spec  # noqa: E402
from benchmark import trace as tracing  # noqa: E402

PEAKS = os.path.join(spec.BENCH_DIR, "peaks.json")
OUT_DIR = os.path.join(ROOT, ".bench_out")


class NoDevice(RuntimeError):
    """The machine lacks the accelerator the cell needs."""


@dataclasses.dataclass
class RunContext:
    """What a driver gets: the cell, the run's arguments, the devices,
    and the hooks a control run or a fault test sets."""

    cell: spec.Cell
    seed: int
    seconds: float
    devices: list
    checkpoint: str
    trace_dir: str | None = None
    control: str | None = None  # a reference matmul in the program's place
    program_wrap: object = None  # fn → fn, wraps the timed entry

    def recording(self):
        if self.trace_dir is None:
            return contextlib.nullcontext()
        return tracing.recording(self.trace_dir)

    def memory_peak(self) -> int:
        peaks = [(d.memory_stats() or {}).get("peak_bytes_in_use", 0)
                 for d in self.devices]
        return int(max(peaks))


@dataclasses.dataclass
class RunRecord:
    """What a per-layer metric reader gets."""

    config: dict
    work: dict
    trace: tracing.TraceSummary | None
    peak: dict
    chips: int


def configure_jax():
    """The persistent compilation cache: ``$JAX_COMPILATION_CACHE_DIR``
    where set, else the fixed ``<checkout>/.jax_cache``; every program
    is kept, however quickly it compiled."""
    import jax

    cache = os.environ.get("JAX_COMPILATION_CACHE_DIR") or os.path.join(
        ROOT, ".jax_cache")
    jax.config.update("jax_compilation_cache_dir", cache)
    jax.config.update("jax_persistent_cache_min_compile_time_secs", 0.0)
    jax.config.update("jax_persistent_cache_min_entry_size_bytes", 0)
    return cache


def accelerator(chips: int, allow_cpu: bool = False) -> list:
    import jax

    devices = jax.devices()
    platform = devices[0].platform
    if platform != "gpu" and not allow_cpu:
        raise NoDevice(f"JAX found no GPU (platform {platform!r})")
    if len(devices) < chips:
        raise NoDevice(f"the cell needs {chips} chips; JAX found "
                       f"{len(devices)}")
    return devices[:chips]


def peak_for(kind: str, peaks_path: str = PEAKS) -> dict:
    with open(peaks_path) as f:
        table = json.load(f)["devices"]
    if kind not in table:
        raise NoDevice(f"no published peaks for device {kind!r} in "
                       f"{peaks_path}")
    return table[kind]


def run_cell(cell: spec.Cell, seed: int, seconds: float, traced: bool,
             *, allow_cpu: bool = False, control: str | None = None,
             program_wrap=None, log=print) -> dict:
    """Run the cell once; returns the result object (not yet printed)."""
    import jax

    devices = accelerator(cell.chips, allow_cpu)
    kind = devices[0].device_kind
    peak = peak_for(kind) if not allow_cpu else {}
    trace_dir = os.path.join(OUT_DIR, "trace-" + cell.name) if traced else None
    ctx = RunContext(cell=cell, seed=seed, seconds=seconds, devices=devices,
                     checkpoint=cell.checkpoint_path(ROOT),
                     trace_dir=trace_dir, control=control,
                     program_wrap=program_wrap)
    log(f"device: {kind} x{len(devices)}; card (name, power limit): "
        f"{card.card_info()}")
    with card.ClockSampler() as clocks:
        out = cell.driver().run(ctx)
    for note in out["notes"]:
        log(note)
    log(f"card during the run: {clocks.summary}")

    e2e_values = dict(out["e2e"])
    e2e_values["setup_s"] = out["t_window"] - T_START
    result = {"correct": False, "attempted": out["attempted"],
              "failed": out["failed"]}
    device = {"platform": devices[0].platform, "kind": kind,
              "count": jax.device_count(),
              "memory_peak_bytes": out["memory_peak_bytes"]}
    if traced:
        summary = tracing.reduce_trace(tracing.find_xplane(trace_dir))
        shutil.rmtree(trace_dir, ignore_errors=True)
        record = RunRecord(config=cell.config, work=out["work"],
                           trace=summary, peak=peak, chips=cell.chips)
        metrics = {}
        for m in cell.per_layer:
            value = spec.metric_reader(m["name"], cell.bench_dir).read(record)
            if value is not None:
                metrics[m["name"]] = {"value": value, "unit": m["unit"]}
        device["busy_s"] = summary.busy_s
        device["window_s"] = summary.window_s
        result["metrics"] = metrics
        result["device"] = device
        result["breakdown"] = {"device_ops": summary.device_ops,
                               "idle_gaps": summary.idle_gaps}
        if summary.unclassified:
            log("kernels no rule classifies: "
                + ", ".join(summary.unclassified))
        limit = card.card_info()
        for name, m in metrics.items():
            log(f"{name} = {m['value']!r} {m['unit']} (card: {limit})")
    else:
        result["metrics"] = {
            m["name"]: {"value": e2e_values[m["name"]], "unit": m["unit"]}
            for m in cell.end_to_end}
        result["device"] = device
    correct, checks = compare.judge(out["numbers"], cell.checks)
    result["correct"] = bool(correct and out["failed"] == 0)
    result["checks"] = checks
    return result


def print_result(result: dict) -> None:
    for name, c in result["checks"].items():
        print(f"check {name}: {c['value']!r} (limit {c['limit']!r})",
              file=sys.stderr)
    print(f"check failed answers: {result['failed']} (limit 0)",
          file=sys.stderr, flush=True)
    print(json.dumps(result), flush=True)


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = ap.parse_args(argv)
    try:
        cell = spec.Cell(spec.load_benchmark(ROOT), args.workload)
        accelerator(cell.chips)  # before the cache is configured
        configure_jax()
        result = run_cell(cell, args.seed, args.seconds, bool(args.trace),
                          log=lambda s: print(s, file=sys.stderr, flush=True))
    except (NoDevice, spec.SpecError) as e:
        print(f"run.py: {e}", file=sys.stderr)
        return 2
    print_result(result)
    return 0


if __name__ == "__main__":
    sys.exit(main())
