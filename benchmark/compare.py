"""The numbers that decide ``correct``: gaps between what the timed path
produced and the plain reference, row by row.

* ``signal_gap`` — the widest gap of a signal, as a share of that row's
  amplitude: ``max_rows max_bins |Δ| / max_bins |ref|``.
* ``loglik_gap`` — the widest gap of a log-likelihood, as a share of its
  size: ``max_rows |ΔlogL| / (|logL_ref| + n_bins)``; ``n_bins`` (twice
  the −logL of a perfect fit to pure noise) keeps a row near the mode
  from dividing by almost nothing.
* ``grad_gap_q999`` — the 99.9th percentile over rows of
  ``‖Δg‖ / (‖g_ref‖ + rms_rows ‖g_ref‖)``. Not the widest gap: a row
  whose pre-activation sits within rounding of a ReLU kink has a
  set-valued gradient, and two exact float32 summation orders pick
  different sides of it, so the widest gap of sound runs swings with
  the few such rows a seed draws. The value's ``loglik_gap`` still
  holds every row.

A number that is not finite fails its limit.
"""

from __future__ import annotations

import math

import jax.numpy as jnp
import numpy as np


def signal_gap(got, ref):
    amp = jnp.max(jnp.abs(ref), axis=1)
    return float(jnp.max(jnp.max(jnp.abs(got - ref), axis=1) / amp))


def loglik_gap(got, ref, n_bins: int):
    return float(jnp.max(jnp.abs(got - ref) / (jnp.abs(ref) + n_bins)))


def grad_rel_rows(got, ref):
    """Per-row ``‖Δg‖``, ``‖g_ref‖`` (host arrays); the rms over all rows
    of a run is taken once every block is in (:func:`grad_gap_q999`)."""
    return (np.asarray(jnp.linalg.norm(got - ref, axis=1)),
            np.asarray(jnp.linalg.norm(ref, axis=1)))


def grad_gap_q999(diff_norms, ref_norms) -> float:
    d = np.concatenate(diff_norms)
    n = np.concatenate(ref_norms)
    rms = math.sqrt(float(np.mean(n.astype(np.float64) ** 2)))
    return float(np.quantile(d / (n + rms), 0.999))


def judge(numbers: dict, checks: dict):
    """``(correct, lines)``: each number against its limit, in the order
    of the cell's checks. A check the run did not compute fails."""
    ok, out = True, {}
    for name, spec in checks.items():
        value = numbers.get(name, float("nan"))
        limit = float(spec["limit"])
        passed = math.isfinite(value) and value <= limit
        ok = ok and passed
        out[name] = {"value": value, "limit": limit}
    return ok, out
