"""The comparison that decides ``correct``, shown to fail.

Each cell runs end to end on the CPU at a size a test run holds,
skipping only the harness's look for a GPU: sound, it is correct; with
its control (the plain reference at three bfloat16 passes in the
program's place) or with the timed path broken underneath, it is not.
The faults are the ones these cells can have: an answer altered where
it is produced, and half of each batch left out (its rows answered with
the other half's answers).
"""

import jax
import jax.numpy as jnp
import pytest

import bench_helpers
from benchmark import run, spec

CELLS = [w["name"] for w in spec.load_benchmark(spec.ROOT)["workloads"]] + [
    bench_helpers.SERVE_CELL["name"]]


def altered(fn):
    def broken(params, x):
        return jax.tree.map(lambda a: a.at[0].multiply(1.001), fn(params, x))

    return broken


def half_left_out(fn):
    def broken(params, x):
        h = x.shape[0] // 2
        return jax.tree.map(lambda a: jnp.concatenate([a[:h], a[:h]]),
                            fn(params, x))

    return broken


def _run(small_bench, name, **kw):
    bench, bench_dir = small_bench
    cell = spec.Cell(bench, name, bench_dir)
    seconds = 0.5 if cell.traffic["driver"] == "http_closed_loop" else 0.2
    return run.run_cell(cell, 2**31 + 99, seconds, False, allow_cpu=True,
                        log=lambda s: None, **kw)


@pytest.mark.parametrize("name", CELLS)
def test_sound_run_is_correct(small_bench, name):
    result = _run(small_bench, name)
    assert result["correct"], result["checks"]
    assert result["attempted"] > 0 and result["failed"] == 0
    assert list(result)[-1] == "checks"


@pytest.mark.parametrize("name", CELLS)
def test_control_at_lower_precision_is_not_correct(small_bench, name):
    result = _run(small_bench, name, control="bf16x3")
    assert not result["correct"], result["checks"]


@pytest.mark.parametrize("fault", [altered, half_left_out],
                         ids=["answer-altered", "half-batch-left-out"])
@pytest.mark.parametrize("name", CELLS)
def test_broken_timed_path_is_not_correct(small_bench, name, fault):
    result = _run(small_bench, name, program_wrap=fault)
    assert not result["correct"], result["checks"]


def test_run_refuses_a_cpu_and_prints_no_result(capsys):
    rc = run.main(["--workload", CELLS[0], "--seed", "1", "--seconds", "1"])
    out, err = capsys.readouterr()
    assert rc != 0 and out == ""
    assert "no GPU" in err
