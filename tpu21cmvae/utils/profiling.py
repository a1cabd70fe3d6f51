"""Profiling, tracing, and timing utilities.

The reference has no profiling story at all — only a wall-clock claim in
the README (reference ``README.rst:11``; SURVEY.md §5). Here the
framework exposes first-class hooks around ``jax.profiler``:

* :func:`trace` — capture a TensorBoard/XProf device trace of any code
  region (kernel timelines, HBM transfers, fusion boundaries);
* :func:`annotate` — name host-side regions so they show up inside the
  trace;
* :func:`benchmark` — dispatch-disciplined timing (compile/warmup
  excluded, ``block_until_ready`` on every sample) with throughput
  derivation — the methodology ``bench.py`` uses;
* :func:`device_memory_stats` — live HBM usage per device;
* :func:`debug_guard` — opt-in NaN checking for CI runs (the functional
  replacement for race/sanitizer tooling: pure JAX has no data races,
  the failure mode worth trapping is numerical — SURVEY.md §5).
"""

from __future__ import annotations

import contextlib
import dataclasses
import statistics
import subprocess
import time
from typing import Callable, List, Optional

import jax


@contextlib.contextmanager
def trace(logdir: str, create_perfetto_link: bool = False):
    """Capture a device trace for the enclosed region.

    View with TensorBoard's profile plugin or Perfetto. Wraps
    ``jax.profiler.trace``; remember to ``block_until_ready`` inside the
    region so async dispatch does not escape the capture.
    """
    with jax.profiler.trace(logdir, create_perfetto_link=create_perfetto_link):
        yield


def annotate(name: str):
    """Named host region that appears on the trace timeline
    (``jax.profiler.TraceAnnotation``). Usable as a context manager."""
    return jax.profiler.TraceAnnotation(name)


@dataclasses.dataclass
class BenchmarkResult:
    """Timing distribution for one callable (seconds per call)."""

    name: str
    times_s: List[float]
    items_per_call: Optional[int] = None

    @property
    def mean_s(self) -> float:
        return statistics.fmean(self.times_s)

    @property
    def min_s(self) -> float:
        return min(self.times_s)

    @property
    def std_s(self) -> float:
        return statistics.pstdev(self.times_s) if len(self.times_s) > 1 else 0.0

    @property
    def items_per_sec(self) -> Optional[float]:
        if self.items_per_call is None:
            return None
        return self.items_per_call / self.mean_s

    def summary(self) -> str:
        s = (
            f"{self.name}: {self.mean_s * 1e3:.3f} ms/call "
            f"(min {self.min_s * 1e3:.3f}, std {self.std_s * 1e3:.3f}, "
            f"n={len(self.times_s)})"
        )
        if self.items_per_call is not None:
            s += f", {self.items_per_sec:.1f} items/s"
        return s


def benchmark(
    fn: Callable,
    *args,
    iters: int = 20,
    warmup: int = 2,
    items_per_call: Optional[int] = None,
    name: Optional[str] = None,
) -> BenchmarkResult:
    """Time ``fn(*args)`` with correct async-dispatch discipline.

    ``warmup`` calls run first (compile + cache warm, excluded from the
    stats); every timed sample ends in ``jax.block_until_ready`` so the
    measurement covers actual device execution, not dispatch. Throughput
    is derived from ``items_per_call`` (e.g. the batch size).
    """
    for _ in range(warmup):
        jax.block_until_ready(fn(*args))
    times = []
    for _ in range(iters):
        t0 = time.perf_counter()
        jax.block_until_ready(fn(*args))
        times.append(time.perf_counter() - t0)
    return BenchmarkResult(
        name=name or getattr(fn, "__name__", "fn"),
        times_s=times,
        items_per_call=items_per_call,
    )


def device_memory_stats(device=None) -> Optional[dict]:
    """Live memory stats for a device (HBM bytes in use / limit), or
    ``None`` when the backend does not expose them (CPU)."""
    if device is None:
        device = jax.devices()[0]
    stats = getattr(device, "memory_stats", None)
    return stats() if callable(stats) else None


@contextlib.contextmanager
def debug_guard(nans: bool = True, infs: bool = False):
    """Opt-in numerical tripwire: raise on NaN (and optionally Inf)
    produced by any jitted computation inside the region. Costs extra
    device→host syncs — CI/debug only, never in the hot path."""
    prev_nan = jax.config.jax_debug_nans
    prev_inf = jax.config.jax_debug_infs
    try:
        jax.config.update("jax_debug_nans", nans)
        jax.config.update("jax_debug_infs", infs)
        yield
    finally:
        jax.config.update("jax_debug_nans", prev_nan)
        jax.config.update("jax_debug_infs", prev_inf)


def gpu_card_info() -> str:
    """Name and power limit of each NVIDIA card, one line per card, as
    ``nvidia-smi --query-gpu=name,power.limit --format=csv,noheader``
    prints them — the two facts every timing on a GPU must carry (a card
    set below its maximum power runs slower under load). Runs
    ``nvidia-smi`` as a child process, which never touches JAX; raises
    when it is missing or fails."""
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60, check=True,
    )
    return out.stdout.strip()


# -- FLOP accounting -------------------------------------------------------


def _pad128(d: int) -> int:
    return -(-int(d) // 128) * 128


def matmul_flops_per_row(sizes, skip_first: bool = True):
    """``(logical, padded)`` matmul FLOPs per batch row for a dense
    chain of ``sizes``. ``padded`` rounds both dims of every weight up
    to a multiple of 128 (the tile granularity the tuner's cost model
    charges). ``skip_first`` drops a skinny first layer, which runs as
    broadcast multiply-adds (``ops/mlp.py::skinny_dense``)."""
    pairs = list(zip(sizes[:-1], sizes[1:]))
    if skip_first and pairs and sizes[0] <= 8:
        pairs = pairs[1:]
    logical = 2 * sum(a * b for a, b in pairs)
    padded = 2 * sum(_pad128(a) * _pad128(b) for a, b in pairs)
    return logical, padded
