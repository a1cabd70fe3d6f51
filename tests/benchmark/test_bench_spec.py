"""BENCHMARK.json and the files it names: every one loads, every name and
unit keeps to the allowed characters, and a cell, a configuration or a
per-layer metric is added by adding files alone."""

import json
import os

import pytest

import bench_helpers  # noqa: F401  (puts the checkout on sys.path)
from benchmark import spec
from benchmark.reference import common

BENCH = spec.load_benchmark(spec.ROOT)


def _names(kind):
    return sorted(f[:-5] for f in os.listdir(os.path.join(spec.BENCH_DIR,
                                                          kind))
                  if f.endswith(".json"))


def test_benchmark_json_keys_and_names():
    assert set(BENCH) == {"command", "paths", "run_seconds", "configs",
                          "workloads", "end_to_end", "per_layer"}
    assert 1 <= BENCH["run_seconds"] <= 51
    names = [x["name"] for k in ("configs", "workloads", "end_to_end",
                                 "per_layer") for x in BENCH[k]]
    assert len(names) == len(set(names))
    for name in names:
        assert spec.NAME_RE.match(name), name
    for m in BENCH["end_to_end"] + BENCH["per_layer"]:
        assert spec.UNIT_RE.match(m["unit"]), m["unit"]
        assert m["better"] in ("lower", "higher")
    for p in BENCH["paths"]:
        assert os.path.isdir(os.path.join(spec.ROOT, p))


def test_every_cell_reports_setup_and_its_metrics():
    e2e = {m["name"]: m for m in BENCH["end_to_end"]}
    assert e2e["setup_s"]["bound"] <= 0.25
    for w in BENCH["workloads"]:
        cell = spec.Cell(BENCH, w["name"])
        names = [m["name"] for m in cell.end_to_end]
        assert "setup_s" in names and len(names) >= 2
        assert cell.per_layer, w["name"]
        assert w["chips"] == 1
    cells = {w["name"] for w in BENCH["workloads"]}
    for m in BENCH["per_layer"]:
        assert m["moves"] in e2e
        assert set(m["workloads"]) <= cells
        for c in m["workloads"]:
            moved = e2e[m["moves"]]
            assert "workloads" not in moved or c in moved["workloads"]
        spec.metric_reader(m["name"])  # a reader exists


@pytest.mark.parametrize("name", _names("configs"))
def test_config_files_load_and_match_their_checkpoint(name):
    config = spec.load_data("configs", name)
    assert config["name"] == name
    assert config["reduced"] == []
    ref = spec.load_code("reference", config["family"])
    weights = ref.load(os.path.join(spec.ROOT, config["checkpoint"]), config)
    assert weights["norm"]["mean"].shape == (config["n_bins"],)
    entry = [c for c in BENCH["configs"] if c["name"] == name][0]
    assert entry["file"] == f"benchmark/configs/{name}.json"


@pytest.mark.parametrize("name", _names("traffic"))
def test_traffic_files_load(name):
    mix = spec.load_data("traffic", name)
    spec.load_code("drivers", mix["driver"])
    assert len(mix["why"]) <= 200


@pytest.mark.parametrize("name", _names("workloads"))
def test_workload_files_name_a_cell_and_limits(name):
    checks = spec.load_data("workloads", name)["checks"]
    assert name in {w["name"] for w in BENCH["workloads"]}
    for check, limit in checks.items():
        assert spec.NAME_RE.match(check)
        assert 0 < float(limit["limit"]) < 1


def test_cell_config_and_metric_added_as_files_only(tmp_path):
    bench_dir = bench_helpers.copy_benchmark(tmp_path)
    bench = json.loads(json.dumps(BENCH))
    config = spec.load_data("configs", "direct-21cmvae")
    config["name"] = "direct-copy"
    with open(os.path.join(bench_dir, "configs", "direct-copy.json"),
              "w") as f:
        json.dump(config, f)
    mix = spec.load_data("traffic", "emulate")
    mix["rows"] = 4096
    with open(os.path.join(bench_dir, "traffic", "emulate-small.json"),
              "w") as f:
        json.dump(mix, f)
    with open(os.path.join(bench_dir, "workloads", "copy.emulate-small.json"),
              "w") as f:
        json.dump({"checks": {"signal_gap": {"limit": 1e-5}}}, f)
    with open(os.path.join(bench_dir, "metrics", "rows_done.py"), "w") as f:
        f.write("def read(run):\n    return run.work.get('rows')\n")
    bench["configs"].append({"name": "direct-copy", "source": "x",
                             "file": "benchmark/configs/direct-copy.json",
                             "reduced": [], "why": "x"})
    bench["workloads"].append({"name": "copy.emulate-small",
                               "config": "direct-copy",
                               "traffic": "emulate-small", "chips": 1,
                               "why": "x"})
    bench["per_layer"].append({"name": "rows_done.emulate", "unit": "rows",
                               "better": "higher",
                               "source": "program_counter", "layer": "x",
                               "moves": "signals_per_s",
                               "workloads": ["copy.emulate-small"]})
    cell = spec.Cell(bench, "copy.emulate-small", bench_dir)
    assert cell.config["name"] == "direct-copy"
    assert cell.traffic["rows"] == 4096
    assert [m["name"] for m in cell.per_layer] == ["rows_done.emulate"]
    reader = spec.metric_reader("rows_done.emulate", bench_dir)

    class Run:
        work = {"rows": 7}

    assert reader.read(Run()) == 7
    assert cell.driver().__name__.endswith("resident_batches")
    with pytest.raises(spec.SpecError):
        spec.Cell(bench, "no.such-cell", bench_dir)


def test_bf16x3_matmul_is_three_passes_not_exact():
    import jax
    import jax.numpy as jnp
    import numpy as np

    rng = np.random.default_rng(0)
    a = jnp.asarray(rng.normal(size=(64, 96)), jnp.float32)
    b = jnp.asarray(rng.normal(size=(96, 32)), jnp.float32)
    exact = np.asarray(a, np.float64) @ np.asarray(b, np.float64)
    err3 = np.abs(np.asarray(common.matmul_bf16x3(a, b)) - exact).max()
    err1 = np.abs(np.asarray(jnp.matmul(a.astype(jnp.bfloat16),
                                        b.astype(jnp.bfloat16),
                                        preferred_element_type=jnp.float32))
                  - exact).max()
    err32 = np.abs(np.asarray(common.matmul_f32(a, b)) - exact).max()
    assert err32 < err3 < err1 / 20
    # the same three passes inside a compiled program
    jitted = np.asarray(jax.jit(common.matmul_bf16x3)(a, b))
    assert np.abs(jitted - exact).max() < err1 / 20


@pytest.mark.parametrize("name", _names("configs"))
def test_reference_forward_matches_the_package_model(name):
    import jax.numpy as jnp
    import numpy as np

    from benchmark import traffic
    from tpu21cmvae.models import load_model

    config = spec.load_data("configs", name)
    path = os.path.join(spec.ROOT, config["checkpoint"])
    ref = spec.load_code("reference", config["family"])
    rows = jnp.asarray(traffic.prior_rows(256, traffic.rng_for(11)),
                       jnp.float32)
    want = np.asarray(ref.forward(ref.load(path, config), rows))
    model = load_model(path)
    got = np.asarray(model.predict_fn()(model.params, rows))
    gap = np.max(np.abs(got - want).max(1) / np.abs(want).max(1))
    assert gap < 1e-5
