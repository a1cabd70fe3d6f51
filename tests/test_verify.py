"""The one-command verification battery, exercised offline.

Golden-number checks need the real dataset + pretrained artifacts and
report SKIP here; structural checks (batched-vs-single, band masking)
run on the synthetic dataset so the battery itself stays tested. The
whole point (VERDICT round 1, item 8): the moment any environment has
``dataset_21cmVAE.h5``, ``python -m tpu21cmvae verify`` checks the
0.34 %/0.29 % contract (reference ``tests/test_emulator.py:72-80``) in
one shot.
"""

import json

import numpy as np
import pytest

from tpu21cmvae.verify import (
    Check,
    check_band_mask,
    check_batched_vs_single,
    format_report,
    run_verification,
    write_report,
)


@pytest.fixture(scope="module")
def report(splits):
    return run_verification(splits, quick_epochs=5,
                            dataset_label="synthetic")


def test_structural_checks_pass(report):
    by_name = {c["name"]: c for c in report["checks"]}
    assert by_name["batched_vs_single"]["status"] == "PASS"
    assert by_name["band_mask_consistency"]["status"] == "PASS"
    assert by_name["direct_golden"]["status"] == "SKIP"
    assert by_name["ae_golden"]["status"] == "SKIP"
    assert report["ok"]  # skips are not failures
    assert by_name["inference_stack"]["status"] == "PASS"
    assert by_name["deploy_artifact"]["status"] == "PASS"
    assert report["fail"] == 0 and report["pass"] == 4 and report["skip"] == 2


def test_report_roundtrip(report, tmp_path):
    path = write_report(report, str(tmp_path / "report.json"))
    loaded = json.loads(open(path).read())
    assert loaded == report
    text = format_report(report)
    assert "batched_vs_single" in text and "4 passed" in text


def test_failure_detected(splits):
    """A broken model must turn a check into FAIL, not crash the battery."""

    class Broken:
        frequencies = np.linspace(40, 120, splits.n_bins)

        def predict(self, par):
            out = np.zeros((np.atleast_2d(par).shape[0], splits.n_bins))
            # batched path disagrees with single-row path
            out += 1.0 if out.shape[0] > 1 else 0.0
            return out[0] if np.asarray(par).ndim == 1 else out

    check = check_batched_vs_single(splits, Broken())
    assert check.status == "FAIL"
    # band-mask consistency is model-independent — still passes
    assert check_band_mask(splits, Broken()).status == "PASS"


def test_crash_is_fail_not_exception(splits):
    from tpu21cmvae.verify import _run

    def boom() -> Check:
        raise RuntimeError("kaput")

    c = _run("boom", boom)
    assert c.status == "FAIL" and "kaput" in c.detail


def test_cli_verify_smoke(capsys):
    """CLI smoke: synthetic data, writes a report, exits clean."""
    import tempfile

    from tpu21cmvae.__main__ import main

    with tempfile.TemporaryDirectory() as d:
        main(["verify", "--out", f"{d}/r.json"])
        out = capsys.readouterr().out
        assert "verification report" in out
        loaded = json.loads(open(f"{d}/r.json").read())
        assert loaded["ok"]


def test_deploy_check_asks_for_this_backends_platform(splits, normalizer,
                                                      monkeypatch):
    """The deploy check passes where the artifact serves (the CPU here,
    lowered by default for cpu + cuda) and fails for a platform the
    artifact was not lowered for — it never asks for one named host."""
    import jax

    from tpu21cmvae.models.direct import DirectEmulator
    from tpu21cmvae.utils.config import DirectEmulatorConfig
    from tpu21cmvae.verify import check_deploy_artifact

    model = DirectEmulator(normalizer=normalizer,
                           config=DirectEmulatorConfig(hidden_dims=(16,)))
    assert check_deploy_artifact(splits, model).status == "PASS"
    monkeypatch.setattr(jax.export, "default_export_platform",
                        lambda: "rocm")
    assert check_deploy_artifact(splits, model).status == "FAIL"
