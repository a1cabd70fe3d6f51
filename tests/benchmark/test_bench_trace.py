"""The reduction from a profiler trace to busy time, idle share, matrix
product kernel time and the breakdown, on a small trace recorded on an
NVIDIA H100 (3 direct-emulator forwards and one value+gradient call of
8,192 rows inside the harness's ``bench.window`` span) and on
hand-made intervals."""

import os

import pytest

import bench_helpers  # noqa: F401  (puts the checkout on sys.path)
from benchmark import trace

TRACE = os.path.join(os.path.dirname(os.path.abspath(__file__)), "data",
                     "h100_small.xplane.pb")


@pytest.fixture(scope="module")
def events():
    """Device events and the window span, read without the reduction."""
    from jax.profiler import ProfileData

    pd = ProfileData.from_file(TRACE)
    dev, window = [], None
    for plane in pd.planes:
        for line in plane.lines:
            for ev in line.events:
                if plane.name.startswith("/device:GPU"):
                    dev.append((ev.start_ns, ev.start_ns + ev.duration_ns,
                                ev.name))
                elif ev.name == trace.WINDOW_SPAN:
                    window = (ev.start_ns, ev.start_ns + ev.duration_ns)
    return dev, window


@pytest.fixture(scope="module")
def summary():
    return trace.reduce_trace(TRACE)


def test_busy_is_the_union_of_device_intervals(events, summary):
    dev, (lo, hi) = events
    # sweep over every nanosecond edge: covered length, counted once
    edges = sorted({x for a, b, _ in dev for x in (max(a, lo), min(b, hi))})
    covered = 0.0
    for a, b in zip(edges, edges[1:]):
        mid = (a + b) / 2
        if any(s <= mid < e for s, e, _ in dev):
            covered += b - a
    assert summary.busy_s == pytest.approx(covered * 1e-9, rel=1e-9)
    assert summary.window_s == pytest.approx((hi - lo) * 1e-9)
    assert 0.0 < summary.busy_s < summary.window_s
    assert summary.idle_share == pytest.approx(
        1 - summary.busy_s / summary.window_s)


def test_matmul_kernels_found_by_name(events, summary):
    dev, (lo, hi) = events
    gemm = sum(min(b, hi) - max(a, lo) for a, b, n in dev
               if ("gemm" in n or "xmma" in n) and min(b, hi) > max(a, lo))
    assert gemm > 0
    assert summary.matmul_s == pytest.approx(gemm * 1e-9, rel=1e-9)
    assert summary.matmul_s <= summary.busy_s
    assert summary.unclassified == []


def test_breakdown_is_bounded_and_ordered(summary):
    ops, gaps = summary.device_ops, summary.idle_gaps
    assert 0 < len(ops) <= 10 and 0 < len(gaps) <= 10
    assert [s for _, s in ops] == sorted((s for _, s in ops), reverse=True)
    assert trace.is_matmul(ops[0][0])
    assert {name for name, _ in gaps} <= {"dispatch", "block", "none"}


@pytest.mark.parametrize("name,matmul", [
    ("sm80_xmma_gemm_f32f32_f32f32_f32_nn_n_tilesize64x64x8", True),
    ("void cutlass::Kernel2<cutlass_80_simt_sgemm_256x128_8x4_nn_align1>",
     True),
    ("nvjet_tst_128x64_64x4_1x2_h_bz_TNT", True),
    ("triton_gemm_dot_fusion", True),
    ("loop_maximum_fusion_2", False),
    ("input_reduce_select_fusion", False),
    ("MemcpyD2H", False),
])
def test_kernel_classification(name, matmul):
    assert trace.is_matmul(name) is matmul
    assert trace.is_known(name)


def test_union_and_gap_attribution_by_hand():
    assert trace._union([(5, 7), (0, 2), (1, 3), (7, 9)]) == [[0, 3], [5, 9]]
    spans = [(0, 100, "serve_http"), (10, 20, "service_predict")]
    assert trace._attribute(12, 18, spans) == "service_predict"
    assert trace._attribute(30, 60, spans) == "serve_http"
    assert trace._attribute(200, 300, spans) == "none"
