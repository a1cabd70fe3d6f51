"""Fixtures of the benchmark's CPU tests."""

import pytest

import bench_helpers


@pytest.fixture(scope="session")
def small_bench(tmp_path_factory):
    """``(BENCHMARK.json as a dict, benchmark dir)`` with every traffic
    mix cut to a size a test run holds, and a cell of the serving
    driver."""
    from benchmark import spec

    bench_dir = bench_helpers.copy_benchmark(
        tmp_path_factory.mktemp("bench"))
    bench_helpers.shrink_traffic(bench_dir)
    bench = spec.load_benchmark(bench_helpers.ROOT)
    return bench_helpers.add_serve_cell(bench, bench_dir), bench_dir
