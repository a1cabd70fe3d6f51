"""One-command accuracy-contract verification battery.

The reference's headline contract — mean 0.34 % / median 0.29 % relative
RMSE (0.54 / 0.50 mK absolute) for the direct emulator on the 21cmGEM
test split, 0.39 %/0.35 % for the AE pipeline, 0.33 %/0.29 % pure
reconstruction (reference ``tests/test_emulator.py:55-113``;
``README.rst:11``; Table 1 of Bye et al. 2022) — can only be checked
where the ~300 MB real dataset exists, which offline CI does not have.
This module packages the whole battery behind one call so that ANY
environment with the data verifies the contract in one shot:

    python -m tpu21cmvae verify --dataset /path/dataset_21cmVAE.h5 \
        --direct-h5 /path/emulator.h5 --keras-dir /path/ae_models

Checks that need a missing artifact are reported SKIP (not FAIL); checks
that run assert the golden numbers. Structural checks (batched-vs-single
parity, band-mask consistency) run against any dataset, including the
synthetic surrogate, so the battery itself is exercised in offline CI
(tests/test_verify.py).
"""

from __future__ import annotations

import dataclasses
import json
import os
from typing import Callable, List, Optional

import numpy as np

# Golden numbers: reference tests/test_emulator.py:72-80 (direct; atol
# 1e-2), :88-113 (AE pipeline + reconstruction), :61-62 (max < 2 %);
# 50–100 MHz band mean 0.496 mK (sample_notebook.ipynb cell 6 output).
GOLDEN_ATOL = 1e-2
DIRECT_GOLDEN = {"rel_mean": 0.34, "rel_median": 0.29,
                 "abs_mean": 0.54, "abs_median": 0.50}
DIRECT_BAND_GOLDEN = {"band_abs_mean_50_100": 0.496}
AE_GOLDEN = {"rel_mean": 0.39, "rel_median": 0.35}
AE_RECON_GOLDEN = {"recon_rel_mean": 0.33, "recon_rel_median": 0.29}


@dataclasses.dataclass
class Check:
    name: str
    status: str  # "PASS" | "FAIL" | "SKIP"
    detail: str = ""
    values: dict = dataclasses.field(default_factory=dict)


def _stats(err: np.ndarray) -> dict:
    return {
        "mean": float(err.mean()),
        "median": float(np.median(err)),
        "max": float(err.max()),
    }


def _assert_close(got: dict, golden: dict, atol: float) -> List[str]:
    """Return the list of golden-number violations (empty == pass)."""
    bad = []
    for key, want in golden.items():
        have = got[key]
        if not np.isclose(have, want, atol=atol):
            bad.append(f"{key}: got {have:.4f}, want {want} ± {atol}")
    return bad


def _run(name: str, fn: Callable[[], Check]) -> Check:
    try:
        return fn()
    except Exception as e:  # a crashed check is a failure, not a crash
        return Check(name, "FAIL", f"{type(e).__name__}: {e}")


def check_direct_golden(data, direct_h5: Optional[str], model=None) -> Check:
    """``model``: a DirectEmulator already built from ``direct_h5``
    (avoids a second h5 load + predict compile)."""
    name = "direct_golden"
    if not (direct_h5 and os.path.exists(direct_h5)):
        return Check(name, "SKIP", "pretrained emulator.h5 not provided")
    if model is None:
        from tpu21cmvae.models.direct import DirectEmulator

        model = DirectEmulator.from_keras_h5(direct_h5, data)
    # predict the test split ONCE; all error statistics derive from it
    from tpu21cmvae.utils.metrics import error

    pred = model.predict(data.par_test)
    nu = model.frequencies
    rel = error(data.signal_test, pred, relative=True)
    ab = error(data.signal_test, pred, relative=False)
    band = error(data.signal_test, pred, relative=False, nu_arr=nu,
                 flow=50.0, fhigh=100.0)
    got = {
        "rel_mean": rel.mean(), "rel_median": np.median(rel),
        "abs_mean": ab.mean(), "abs_median": np.median(ab),
        "rel_max": rel.max(),
        "band_abs_mean_50_100": band.mean(),
    }
    bad = _assert_close(got, {**DIRECT_GOLDEN, **DIRECT_BAND_GOLDEN},
                        GOLDEN_ATOL)
    if got["rel_max"] >= 2.0:  # reference tests/test_emulator.py:61-62
        bad.append(f"rel_max: got {got['rel_max']:.4f}, want < 2.0")
    return Check(
        name,
        "FAIL" if bad else "PASS",
        "; ".join(bad) or "matches Table 1 golden numbers",
        {k: float(v) for k, v in got.items()},
    )


def check_ae_golden(data, keras_dir: Optional[str]) -> Check:
    name = "ae_golden"
    needed = ("ae_emulator.h5", "encoder.h5", "decoder.h5")
    if not (keras_dir and all(
            os.path.exists(os.path.join(keras_dir, f)) for f in needed)):
        return Check(name, "SKIP", "pretrained AE h5 trio not provided")
    from tpu21cmvae.models.autoencoder import AutoEncoderEmulator

    model = AutoEncoderEmulator.from_keras_h5(
        os.path.join(keras_dir, "ae_emulator.h5"),
        os.path.join(keras_dir, "encoder.h5"),
        os.path.join(keras_dir, "decoder.h5"),
        data=data,
    )
    rel = model.test_error(relative=True)
    rec = model.test_error(use_autoencoder=True, relative=True)
    got = {
        "rel_mean": rel.mean(), "rel_median": np.median(rel),
        "rel_max": rel.max(),
        "recon_rel_mean": rec.mean(), "recon_rel_median": np.median(rec),
    }
    bad = _assert_close(got, {**AE_GOLDEN, **AE_RECON_GOLDEN}, GOLDEN_ATOL)
    if got["rel_max"] >= 5.0:  # reference tests/test_emulator.py:88-95
        bad.append(f"rel_max: got {got['rel_max']:.4f}, want < 5.0")
    return Check(
        name,
        "FAIL" if bad else "PASS",
        "; ".join(bad) or "matches golden AE numbers",
        {k: float(v) for k, v in got.items()},
    )


def check_batched_vs_single(data, model) -> Check:
    """Batched predict == row-by-row predict (reference
    ``tests/test_emulator.py:55-69``, atol 5e-5) — weight-independent."""
    name = "batched_vs_single"
    batched = model.predict(data.par_test[:10])
    if batched.shape != (10, data.n_bins):
        return Check(name, "FAIL",
                     f"batched shape {batched.shape} != (10, {data.n_bins})")
    worst = max(
        float(np.abs(batched[i] - model.predict(data.par_test[i])).max())
        for i in range(10)
    )
    ok = worst <= 5e-5
    return Check(
        name, "PASS" if ok else "FAIL",
        f"max |batched − single| = {worst:.2e} (limit 5e-5)",
        {"max_abs_diff": worst},
    )


def check_band_mask(data, model) -> Check:
    """Band-restricted error == error on manually masked bins — guards
    the two reference band bugs (``emulator.py:168,177-182``) staying
    fixed in the public path."""
    name = "band_mask_consistency"
    from tpu21cmvae.utils.metrics import band_mask, error

    pred = model.predict(data.par_test[:50])
    true = np.asarray(data.signal_test[:50])
    nu = np.asarray(model.frequencies)
    got = error(true, pred, relative=False, nu_arr=nu, flow=50.0, fhigh=100.0)
    mask = band_mask(nu, 50.0, 100.0)
    want = np.sqrt(np.mean((pred[:, mask] - true[:, mask]) ** 2, axis=1))
    worst = float(np.abs(got - want).max())
    # flow=0 must be honored as a bound, not falsy-ignored
    zero_low = error(true, pred, relative=False, nu_arr=nu, flow=0.0)
    full = error(true, pred, relative=False)
    honored = np.allclose(
        zero_low,
        np.sqrt(np.mean((pred[:, nu >= 0.0] - true[:, nu >= 0.0]) ** 2,
                        axis=1)),
    ) and zero_low.shape == full.shape
    ok = worst < 1e-6 and honored
    return Check(
        name, "PASS" if ok else "FAIL",
        f"max band-mask deviation {worst:.2e}; flow=0 honored: {honored}",
        {"max_abs_diff": worst},
    )


def check_inference_stack(data, model) -> Check:
    """The posterior-inference path end to end ON THIS DEVICE: observe
    a known parameter vector through the model's own forward + noise,
    run the on-device MH chain (`sample_posterior`), and assert the
    machinery holds — the chain concentrates at the observation's
    likelihood level, diagnostics are finite, and acceptance is
    neither stuck nor saturated. Statistical exactness is pinned by
    the analytic-target unit tests; this check proves the same
    programs compile and behave on the verification device."""
    name = "inference_stack"
    rng = np.random.default_rng(3)
    truth = np.asarray(data.par_test[0], np.float32)
    obs = model.predict(truth) + rng.normal(0.0, 5.0, data.n_bins)
    par = np.asarray(data.par_train, np.float64)
    lo, hi = par.min(0), par.max(0)
    lo[:3] = np.maximum(lo[:3], 1e-6)
    bounds = np.stack([lo, hi], axis=1)
    res = model.sample_posterior(
        obs, 25.0, sampler="mh", bounds=bounds, n_walkers=256,
        n_steps=150, n_warmup=200, thin=10, seed=0,
    )
    loglik = model.loglik_fn(obs, 25.0)
    lp_truth = float(np.asarray(loglik(model.params, truth[None, :]))[0])
    lp_post = float(res.logp.mean())
    acc = float(np.mean(res.accept_rate))
    ess_min = float(res.ess().min())
    # model checking discriminates on THIS device: a 40 mK ripple the
    # signal family cannot span must jump the posterior predictive
    # quadratic form by ~tens of dof and localize in bin_z (the
    # comparison uses the same draws, so it is robust to how far this
    # short chain converged — PERF.md's unconverged-chain caveat)
    gof = model.goodness_of_fit(obs, 25.0, res)
    nu = np.asarray(model.frequencies, np.float64)
    ripple = 40.0 * np.sin(2 * np.pi * (nu - nu.min()) / 10.0)
    gof_bad = model.goodness_of_fit(
        np.asarray(obs, np.float64) + ripple, 25.0, res
    )
    z_clean = float(np.abs(gof.bin_z).max())
    z_bad = float(np.abs(gof_bad.bin_z).max())
    gof_ok = (
        float(np.mean(gof_bad.q) - np.mean(gof.q)) > 10.0 * gof.dof
        and gof_bad.p_value < 1e-3
        and z_bad > z_clean + 3.0
    )
    # the posterior sits at the truth's likelihood level (a stuck or
    # diverged chain is hundreds-to-thousands of nats below)
    ok = (
        lp_post > lp_truth - 50.0
        and 0.02 < acc < 0.98
        and ess_min > 20.0
        and np.isfinite(res.rhat()).all()
        and gof_ok
    )
    return Check(
        name, "PASS" if ok else "FAIL",
        f"posterior mean logp {lp_post:.1f} vs truth {lp_truth:.1f} "
        f"(need > truth−50); accept {acc:.2f}; min ESS {ess_min:.0f}; "
        f"gof ripple detection {'ok' if gof_ok else 'FAILED'} "
        f"(bin-z {z_clean:.1f} → {z_bad:.1f})",
        {"lp_post": lp_post, "lp_truth": lp_truth, "accept": acc,
         "ess_min": ess_min, "gof_p_clean": float(gof.p_value),
         "gof_p_ripple": float(gof_bad.p_value),
         "gof_binz_clean": z_clean, "gof_binz_ripple": z_bad},
    )


def check_deploy_artifact(data, model) -> Check:
    """The deployment path end to end ON THIS DEVICE: export the model
    as a self-contained StableHLO artifact (:mod:`tpu21cmvae.deploy`),
    reload it from disk, and assert the replay matches the in-process
    predict (measured bit-exact; asserted at the reference's own
    batched-vs-single tolerance) and that the single-row squeeze
    convention survives (reference ``emulator.py:404-407``)."""
    name = "deploy_artifact"
    import tempfile

    import jax

    from tpu21cmvae import deploy

    with tempfile.TemporaryDirectory() as d:
        fn = deploy.load_artifact(
            deploy.save_predict_artifact(model, os.path.join(d, "em.bin"))
        )
    raw = np.asarray(data.par_test[:10], np.float32)
    worst = float(np.abs(fn(raw) - model.predict(raw)).max())
    row = fn(raw[0])
    squeezed = row.shape == (data.n_bins,)
    # the artifact must be lowered for the platform this process serves on
    ok = (worst <= 5e-5 and squeezed
          and jax.export.default_export_platform() in fn.platforms)
    return Check(
        name, "PASS" if ok else "FAIL",
        f"max |artifact − predict| = {worst:.2e} (limit 5e-5); "
        f"single-row squeeze: {squeezed}; platforms {fn.platforms}",
        {"max_abs_diff": worst},
    )


def run_verification(
    data,
    *,
    direct_h5: Optional[str] = None,
    keras_dir: Optional[str] = None,
    quick_epochs: int = 20,
    dataset_label: str = "",
) -> dict:
    """Run the full battery; returns a JSON-serializable report dict.

    ``data``: a DataSplits (real 21cmGEM or synthetic). Structural checks
    always run (on the pretrained direct model when ``direct_h5`` is
    given, else on a quickly trained throwaway); golden-number checks run
    only when their artifacts are provided.
    """
    from tpu21cmvae.models.direct import DirectEmulator

    if direct_h5 and os.path.exists(direct_h5):
        probe = DirectEmulator.from_keras_h5(direct_h5, data)
        golden_model = probe  # reuse: one h5 load, one predict compile
    else:
        from tpu21cmvae.utils.config import TrainConfig

        probe = DirectEmulator(data)
        probe.train(
            train_config=TrainConfig(epochs=quick_epochs,
                                     early_stop_patience=None),
            device_loop=True,
        )
        golden_model = None

    checks = [
        _run("direct_golden",
             lambda: check_direct_golden(data, direct_h5, golden_model)),
        _run("ae_golden", lambda: check_ae_golden(data, keras_dir)),
        _run("batched_vs_single",
             lambda: check_batched_vs_single(data, probe)),
        _run("band_mask_consistency", lambda: check_band_mask(data, probe)),
        _run("inference_stack", lambda: check_inference_stack(data, probe)),
        _run("deploy_artifact", lambda: check_deploy_artifact(data, probe)),
    ]
    counts = {s: sum(c.status == s for c in checks)
              for s in ("PASS", "FAIL", "SKIP")}
    return {
        "dataset": dataset_label,
        "checks": [dataclasses.asdict(c) for c in checks],
        **{k.lower(): v for k, v in counts.items()},
        "ok": counts["FAIL"] == 0,
    }


def format_report(report: dict) -> str:
    lines = [f"verification report — dataset: {report['dataset'] or '?'}"]
    for c in report["checks"]:
        lines.append(f"  [{c['status']:4}] {c['name']}: {c['detail']}")
        for k, v in c["values"].items():
            lines.append(f"           {k} = {v:.6g}")
    lines.append(
        f"{report['pass']} passed, {report['fail']} failed, "
        f"{report['skip']} skipped"
    )
    return "\n".join(lines)


def write_report(report: dict, path: str) -> str:
    from tpu21cmvae.utils.io import atomic_write

    with atomic_write(path) as f:  # binary write-then-rename
        f.write(json.dumps(report, indent=2).encode())
    return path
