"""Plain reference of the autoencoder-based emulator of 21cmVAE (Bye et
al. 2022, arXiv:2107.05581, App. A): parameters → emulator MLP → latent
(linear) → decoder MLP (ReLU hidden, linear out) → signal. The encoder
is not on the emulation path.

Checkpoint layout (leaves in order): decoder ``b, w`` per layer,
emulator ``b, w`` per layer, encoder ``b, w`` per layer, then signal
mean (n_bins,), signal std (), log-parameter min (7,), max (7,).
"""

from __future__ import annotations

import jax.numpy as jnp

from benchmark.reference import common


def load(path: str, config: dict):
    leaves, _ = common.read_npz(path)
    n_dec = 2 * (len(config["dec_hidden_dims"]) + 1)
    n_em = 2 * (len(config["em_hidden_dims"]) + 1)
    n_enc = 2 * (len(config["enc_hidden_dims"]) + 1)
    latent = config["latent_dim"]
    dec = common.layers_from(
        leaves[:n_dec], (latent, *config["dec_hidden_dims"], config["n_bins"]))
    em = common.layers_from(
        leaves[n_dec:n_dec + n_em],
        (config["n_params"], *config["em_hidden_dims"], latent))
    norm_at = n_dec + n_em + n_enc
    return {
        "norm": common.normalizer_from(
            leaves[norm_at:norm_at + 4], config["n_bins"], config["n_params"]),
        "em": em,
        "dec": dec,
    }


def forward(weights, raw, matmul=common.matmul_f32, xp=jnp):
    x = common.par_transform(raw, weights["norm"], xp)
    z = common.dense_chain(weights["em"], x, matmul, xp)
    y = common.dense_chain(weights["dec"], z, matmul, xp)
    return common.unpreproc(y, weights["norm"])
