"""Helpers of the benchmark's CPU tests."""

import json
import os
import shutil
import sys

ROOT = os.path.dirname(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))))
if ROOT not in sys.path:
    sys.path.insert(0, ROOT)

SMALL = {
    "resident_batches": {"rows": 512, "distinct_batches": 2},
    "http_closed_loop": {"clients": 2, "sample_share": 1.0},
}


def copy_benchmark(dest):
    """The benchmark directory (without its checkpoints, which are read
    from the checkout) under ``dest``; returns its path."""
    from benchmark import spec

    bench_dir = os.path.join(str(dest), "benchmark")
    shutil.copytree(spec.BENCH_DIR, bench_dir, ignore=shutil.ignore_patterns(
        "checkpoints", "__pycache__"))
    return bench_dir


def shrink_traffic(bench_dir):
    """Cut every traffic mix under ``bench_dir`` to a few hundred rows or
    two clients."""
    traffic_dir = os.path.join(bench_dir, "traffic")
    for name in os.listdir(traffic_dir):
        path = os.path.join(traffic_dir, name)
        with open(path) as f:
            mix = json.load(f)
        mix.update(SMALL[mix["driver"]])
        with open(path, "w") as f:
            json.dump(mix, f)


SERVE_CELL = {"name": "direct.serve-predict", "config": "direct-21cmvae",
              "traffic": "serve-predict", "chips": 1,
              "why": "closed-loop HTTP clients of the served emulator"}


def add_serve_cell(bench, bench_dir):
    """``bench`` with a cell of the serving driver, added as files and an
    entry: the driver is kept for a cell that BENCHMARK.json does not
    hold yet (see PERF.md, Open questions)."""
    with open(os.path.join(bench_dir, "workloads",
                           SERVE_CELL["name"] + ".json"), "w") as f:
        json.dump({"checks": {"signal_gap": {"limit": 1e-5}}}, f)
    bench = json.loads(json.dumps(bench))
    bench["workloads"].append(SERVE_CELL)
    return bench
