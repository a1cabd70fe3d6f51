"""Plain reference of the direct emulator of 21cmVAE (Bye et al. 2022,
arXiv:2107.05581, Sec. 2): parameters → dense MLP (ReLU hidden, linear
out) → signal.

Checkpoint layout (leaves in order): signal mean (n_bins,), signal std
(), log-parameter min (7,), max (7,), then ``b, w`` of each layer.
"""

from __future__ import annotations

import jax.numpy as jnp

from benchmark.reference import common


def load(path: str, config: dict):
    leaves, _ = common.read_npz(path)
    sizes = (config["n_params"], *config["hidden_dims"], config["n_bins"])
    return {
        "norm": common.normalizer_from(
            leaves[:4], config["n_bins"], config["n_params"]),
        "layers": common.layers_from(leaves[4:], sizes),
    }


def forward(weights, raw, matmul=common.matmul_f32, xp=jnp):
    x = common.par_transform(raw, weights["norm"], xp)
    y = common.dense_chain(weights["layers"], x, matmul, xp)
    return common.unpreproc(y, weights["norm"])
