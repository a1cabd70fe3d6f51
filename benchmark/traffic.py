"""The general traffic generator: what every mix draws from its seed.

* :func:`prior_rows` — parameter rows from the 21cmGEM-shaped prior
  (copied from the package's ``data/synthetic.py::synthetic_params`` so
  the yardstick cannot move with the program): f*, V_c, f_X
  log-uniform, the rest uniform, and 5 % of rows with f_X = 0, which
  exercises the log clamp of the parameter transform.
* :func:`request_sizes` — one cycle of request sizes of a serving mix:
  the same multiset for every seed, in an order drawn from the seed.
* :func:`observation_rows` — the fixed truth row and noise of a
  likelihood mix, from its traffic file (never from ``--seed``, so
  every seed scores against the same compiled observation).

No JAX here: the load-generating client processes import this module.
"""

from __future__ import annotations

import math

import numpy as np

# [fstar, Vc, fx, tau, alpha, nu_min, Rmfp] — Bye et al. 2022's 21cmGEM
# ranges; columns 0-2 log-uniform
PAR_RANGES = np.array([
    [1e-4, 0.5],
    [4.2, 100.0],
    [1e-4, 1000.0],
    [0.04, 0.09],
    [1.0, 1.5],
    [0.1, 3.0],
    [10.0, 50.0],
])
FX_ZERO_FRACTION = 0.05
N_PARAMS = 7


def rng_for(seed: int, *stream: int) -> np.random.Generator:
    """Generator for ``--seed`` (any whole number, negative or beyond 64
    bits included) and an optional stream index (e.g. a client)."""
    return np.random.default_rng([int(seed) % (1 << 64), *stream])


def prior_rows(n: int, rng: np.random.Generator) -> np.ndarray:
    """``n`` prior draws, float64 (n, 7)."""
    lo, hi = PAR_RANGES[:, 0], PAR_RANGES[:, 1]
    u = rng.uniform(size=(n, N_PARAMS))
    pars = lo + u * (hi - lo)
    for c in range(3):
        pars[:, c] = 10 ** (
            np.log10(lo[c]) + u[:, c] * (np.log10(hi[c]) - np.log10(lo[c])))
    zero = rng.uniform(size=n) < FX_ZERO_FRACTION
    pars[zero, 2] = 0.0
    return pars


def request_sizes(mix: dict) -> list:
    """One cycle of ``mix["cycle"]`` request sizes: a share
    ``single_row_share`` of 1-row requests, the rest log-uniform
    integers from ``multi_rows_min`` to ``multi_rows_max`` (the floor of
    a log-uniform draw on [min, max + 1)) at even quantiles. Every seed
    gets this same multiset."""
    n = int(mix["cycle"])
    n_single = round(n * float(mix["single_row_share"]))
    lo = math.log(mix["multi_rows_min"])
    hi = math.log(mix["multi_rows_max"] + 1)
    n_multi = n - n_single
    multi = [int(math.exp(lo + (k + 0.5) / n_multi * (hi - lo)))
             for k in range(n_multi)]
    return [1] * n_single + multi


def shuffled_sizes(mix: dict, rng: np.random.Generator) -> list:
    sizes = request_sizes(mix)
    return [sizes[i] for i in rng.permutation(len(sizes))]


def observation_rows(mix: dict):
    """``(truth (1, 7) float64, noise (n_bins,) float64, noise_var)`` of
    a likelihood mix."""
    obs = mix["observation"]
    truth = np.asarray(obs["truth"], np.float64)[None, :]
    rng = np.random.default_rng(int(obs["noise_seed"]))
    noise_var = float(obs["noise_var"])
    noise = rng.normal(0.0, math.sqrt(noise_var), int(obs["n_bins"]))
    return truth, noise, noise_var
