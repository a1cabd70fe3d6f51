"""Recording a window under the profiler, and reducing the trace to the
numbers the per-layer metrics read.

The reduction works on the profiler's ``.xplane.pb`` through
``jax.profiler.ProfileData``:

* device planes are those named ``/device:GPU:<n>``; every event on
  their lines (one line per CUDA stream) is a kernel or copy;
* busy time is the union of those events' intervals inside the
  benchmark's ``bench.window`` span, averaged over the devices; the
  idle share is 1 − busy ÷ window;
* matrix-product kernels are told apart by name (cuBLAS / cuBLASLt
  ``*gemm*``/``*xmma*``/``nvjet*``, CUTLASS, Triton ``*gemm*``/``*dot*`` fusions);
  the names of kernels no rule claims are listed;
* each idle gap on a device is attributed to the benchmark's host span
  (``bench.*``) that overlaps it most, or to ``none``.
"""

from __future__ import annotations

import contextlib
import dataclasses
import glob
import os
import re
import shutil

WINDOW_SPAN = "bench.window"
SPAN_PREFIX = "bench."
MATMUL_RE = re.compile(
    r"gemm|xmma|nvjet|cutlass|cublas|matmul|\bdot|_dot|mma_", re.IGNORECASE)
# XLA's own fusions that hold no matrix product
ELEMENTWISE_RE = re.compile(
    r"^(loop|input)_[a-z_]*fusion(_\d+)?$|^wrapped_|^copy|^memcpy|^memset|"
    r"^transpose|^reduce|^broadcast|^concatenate|^convert|^select",
    re.IGNORECASE)
TOP = 10


def span(name: str):
    """A host span on the profiler's clock (a no-op when not tracing)."""
    import jax

    return jax.profiler.TraceAnnotation(SPAN_PREFIX + name)


@contextlib.contextmanager
def recording(log_dir: str):
    """Trace the enclosed region into ``log_dir`` with the Python
    function tracer off (it would slow every host call)."""
    import jax

    shutil.rmtree(log_dir, ignore_errors=True)
    opts = jax.profiler.ProfileOptions()
    opts.python_tracer_level = 0
    with jax.profiler.trace(log_dir, profiler_options=opts):
        yield


def find_xplane(log_dir: str) -> str:
    found = sorted(glob.glob(os.path.join(
        log_dir, "plugins", "profile", "*", "*.xplane.pb")))
    if not found:
        raise FileNotFoundError(f"no trace under {log_dir}")
    return found[-1]


def is_matmul(kernel: str) -> bool:
    return bool(MATMUL_RE.search(kernel))


def is_known(kernel: str) -> bool:
    return is_matmul(kernel) or bool(ELEMENTWISE_RE.search(kernel))


@dataclasses.dataclass
class TraceSummary:
    window_s: float
    busy_s: float  # mean over devices
    matmul_s: float  # mean over devices
    n_devices: int
    device_ops: list  # [[kernel, seconds], …] most time first
    idle_gaps: list  # [[host span, seconds], …] longest first
    unclassified: list  # kernel names no rule claims

    @property
    def idle_share(self) -> float:
        return 1.0 - self.busy_s / self.window_s


def _union(intervals):
    merged = []
    for a, b in sorted(intervals):
        if merged and a <= merged[-1][1]:
            merged[-1][1] = max(merged[-1][1], b)
        else:
            merged.append([a, b])
    return merged


def _clip(a, b, lo, hi):
    return max(a, lo), min(b, hi)


def reduce_trace(path: str) -> TraceSummary:
    from jax.profiler import ProfileData

    pd = ProfileData.from_file(path)
    devices, spans, window = [], [], None
    for plane in pd.planes:
        if plane.name.startswith("/device:GPU"):
            events = [(ev.start_ns, ev.start_ns + ev.duration_ns, ev.name)
                      for line in plane.lines for ev in line.events]
            devices.append(events)
        elif plane.name.startswith("/host"):
            for line in plane.lines:
                for ev in line.events:
                    if not ev.name.startswith(SPAN_PREFIX):
                        continue
                    iv = (ev.start_ns, ev.start_ns + ev.duration_ns)
                    if ev.name == WINDOW_SPAN:
                        window = iv if window is None else (
                            min(window[0], iv[0]), max(window[1], iv[1]))
                    else:
                        spans.append((*iv, ev.name[len(SPAN_PREFIX):]))
    if not devices:
        raise ValueError(f"{path}: no GPU plane in the trace")
    if window is None:  # a trace without the window span: its whole extent
        starts = [a for evs in devices for a, _, _ in evs]
        ends = [b for evs in devices for _, b, _ in evs]
        window = (min(starts), max(ends))
    lo, hi = window
    busy = matmul = 0.0
    per_kernel, gaps, unknown = {}, [], set()
    for events in devices:
        clipped = []
        for a, b, name in events:
            a, b = _clip(a, b, lo, hi)
            if b <= a:
                continue
            clipped.append((a, b))
            per_kernel[name] = per_kernel.get(name, 0.0) + (b - a)
            if is_matmul(name):
                matmul += b - a
            elif not is_known(name):
                unknown.add(name)
        merged = _union(clipped)
        busy += sum(b - a for a, b in merged)
        edges = [lo] + [x for iv in merged for x in iv] + [hi]
        for a, b in zip(edges[0::2], edges[1::2]):
            if b > a:
                gaps.append((b - a, _attribute(a, b, spans)))
    n = len(devices)
    ns = 1e-9
    device_ops = sorted(per_kernel.items(), key=lambda kv: -kv[1])[:TOP]
    return TraceSummary(
        window_s=(hi - lo) * ns,
        busy_s=busy / n * ns,
        matmul_s=matmul / n * ns,
        n_devices=n,
        device_ops=[[k, v / n * ns] for k, v in device_ops],
        idle_gaps=[[name, g * ns] for g, name in sorted(gaps, reverse=True)
                   [:TOP]],
        unclassified=sorted(unknown),
    )


def _attribute(a, b, spans) -> str:
    """The span that overlaps ``[a, b)`` most; of equal overlaps, the
    shortest (the innermost of nested spans)."""
    best, key = "none", (0.0, 0.0)
    for s, e, name in spans:
        overlap = min(b, e) - max(a, s)
        if overlap > 0 and (overlap, s - e) > key:
            best, key = name, (overlap, s - e)
    return best
