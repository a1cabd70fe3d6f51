"""The accuracy gates and FLOP counts the benches (and ``chip_smoke.py``)
judge every candidate by."""

import os
import shutil
import subprocess
import sys

import numpy as np
import pytest

_ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
if _ROOT not in sys.path:
    sys.path.insert(0, _ROOT)

import bench_mcmc  # noqa: E402


def test_loglik_gate_scales_with_depth_and_rejects_nan():
    ref = np.array([0.0, -10.0, -1000.0])
    # at the mode only the absolute allowance; deep rows get 1.5e-3/unit
    ok = ref + np.array([0.24, 0.25, 1.7])
    assert bench_mcmc.loglik_gate_violation(ok, ref) <= 0.0
    assert bench_mcmc.loglik_gate_violation(ref + [0.3, 0, 0], ref) > 0.0
    assert not (bench_mcmc.loglik_gate_violation(
        np.array([np.nan, -10.0, -1000.0]), ref) <= 0.0)


def test_grad_gate_tolerates_one_kink_row_but_not_garbage():
    rng = np.random.default_rng(0)
    ref = rng.normal(size=(4096, 7))
    got = ref + 1e-4 * rng.normal(size=ref.shape)
    assert bench_mcmc.grad_gate_violation(got, ref) <= 0.0
    kink = got.copy()
    kink[17] += 0.3 * np.linalg.norm(ref[17])  # one set-valued ReLU row
    assert bench_mcmc.grad_gate_violation(kink, ref) <= 0.0
    bad = got.copy()
    bad[5] = np.nan
    assert not (bench_mcmc.grad_gate_violation(bad, ref) <= 0.0)


def test_flops_per_row_counts():
    sizes = (7, 288, 352, 288, 224, 451)
    direct = bench_mcmc._flops_per_row(sizes, "direct")
    assert direct == 2 * sum(a * b for a, b in zip(sizes[:-1], sizes[1:]))
    gram = bench_mcmc._flops_per_row(sizes, "gram")
    trunk = gram - 2 * 224 * 224
    assert gram < direct
    assert bench_mcmc._flops_per_row(sizes, "gram", "analytic") == (
        gram + trunk)
    assert bench_mcmc._flops_per_row(sizes, "direct", "autodiff") == (
        2 * direct)


def test_gpu_card_info_reads_nvidia_smi_or_raises():
    from tpu21cmvae.utils.profiling import gpu_card_info

    if shutil.which("nvidia-smi") is None:
        with pytest.raises((OSError, subprocess.SubprocessError)):
            gpu_card_info()
    else:
        assert gpu_card_info().strip()
