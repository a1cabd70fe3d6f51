"""Finds everything a cell needs by the names in ``BENCHMARK.json``.

A cell (``workloads`` entry) names a configuration and a traffic mix;
each lives in a file of its own under this directory:

* ``configs/<config>.json`` — the model configuration as it is run;
* ``traffic/<traffic>.json`` — the traffic mix: which driver runs it and
  its parameters;
* ``workloads/<cell>.json`` — the cell's correctness checks and limits;
* ``drivers/<driver>.py`` — code shared by every mix of one kind;
* ``reference/<family>.py`` — the plain reference of a model family;
* ``metrics/<metric>.py`` — the reader of a per-layer metric, or
  ``metrics/<quantity>.py`` for every ``<quantity>.<cell kind>`` split.

Adding a cell, a configuration or a metric therefore adds files and an
entry in ``BENCHMARK.json``; no code here changes.
"""

from __future__ import annotations

import importlib.util
import json
import os
import re

BENCH_DIR = os.path.dirname(os.path.abspath(__file__))
ROOT = os.path.dirname(BENCH_DIR)

NAME_RE = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}$")
UNIT_RE = re.compile(r"^[A-Za-z0-9_/%.-]{1,16}$")


class SpecError(ValueError):
    """A name or a file the benchmark needs is missing or malformed."""


def check_name(name: str, what: str) -> str:
    if not isinstance(name, str) or not NAME_RE.match(name):
        raise SpecError(f"{what} {name!r} is not a valid name")
    return name


def load_benchmark(root: str = ROOT) -> dict:
    path = os.path.join(root, "BENCHMARK.json")
    try:
        with open(path) as f:
            return json.load(f)
    except OSError as e:
        raise SpecError(f"no BENCHMARK.json at {root}: {e}") from None


def load_data(kind: str, name: str, bench_dir: str = BENCH_DIR) -> dict:
    """``<bench_dir>/<kind>/<name>.json`` as a dict."""
    check_name(name, kind)
    path = os.path.join(bench_dir, kind, name + ".json")
    try:
        with open(path) as f:
            return json.load(f)
    except OSError:
        raise SpecError(f"no {kind} file {path}") from None


def load_code(kind: str, name: str, bench_dir: str = BENCH_DIR):
    """The module ``<bench_dir>/<kind>/<name>.py``. Names may hold dots,
    so the file is loaded by path."""
    check_name(name, kind)
    path = os.path.join(bench_dir, kind, name + ".py")
    if not os.path.isfile(path):
        raise SpecError(f"no {kind} module {path}")
    spec = importlib.util.spec_from_file_location(
        f"benchmark_{kind}_{name.replace('.', '_').replace('-', '_')}", path)
    module = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(module)
    return module


def metric_reader(name: str, bench_dir: str = BENCH_DIR):
    """Reader of a per-layer metric: ``metrics/<name>.py``, else the
    shared reader of its quantity, ``metrics/<name before the first
    dot>.py``."""
    for candidate in (name, name.split(".")[0]):
        path = os.path.join(bench_dir, "metrics", candidate + ".py")
        if os.path.isfile(path):
            return load_code("metrics", candidate, bench_dir)
    raise SpecError(f"no reader for metric {name!r}")


def _applies(metric: dict, cell: str) -> bool:
    return "workloads" not in metric or cell in metric["workloads"]


class Cell:
    """One ``workloads`` entry with its configuration, traffic mix,
    checks, and the metrics it reports."""

    def __init__(self, bench: dict, name: str, bench_dir: str = BENCH_DIR):
        entries = {w["name"]: w for w in bench.get("workloads", [])}
        if name not in entries:
            raise SpecError(
                f"unknown workload {name!r}; BENCHMARK.json has "
                f"{sorted(entries)}")
        entry = entries[name]
        self.name = name
        self.chips = int(entry["chips"])
        if entry["config"] not in {c["name"] for c in bench.get("configs",
                                                                 [])}:
            raise SpecError(f"cell {name!r} names unknown config "
                            f"{entry['config']!r}")
        self.config = load_data("configs", entry["config"], bench_dir)
        self.traffic = load_data("traffic", entry["traffic"], bench_dir)
        self.checks = load_data("workloads", name, bench_dir)["checks"]
        self.end_to_end = [m for m in bench.get("end_to_end", [])
                           if _applies(m, name)]
        self.per_layer = [m for m in bench.get("per_layer", [])
                          if _applies(m, name)]
        self.bench_dir = bench_dir

    def driver(self):
        return load_code("drivers", self.traffic["driver"], self.bench_dir)

    def reference(self):
        return load_code("reference", self.config["family"], self.bench_dir)

    def checkpoint_path(self, root: str = ROOT) -> str:
        return os.path.join(root, self.config["checkpoint"])
