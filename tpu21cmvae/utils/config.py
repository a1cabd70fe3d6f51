"""Frozen configuration dataclasses.

The reference has no config system — hyperparameters live in constructor
kwargs backed by module globals (reference ``emulator.py:195-204,521-525``)
and in notebook cells (``notebooks/Training.ipynb`` cells 4-5, 10-11).
Here every knob is an explicit, hashable, frozen dataclass; the reference's
values are the canonical presets.
"""

from __future__ import annotations

import dataclasses
from typing import Optional, Tuple


@dataclasses.dataclass(frozen=True)
class MLPConfig:
    """Architecture of one dense MLP (hidden activation + linear head)."""

    in_dim: int
    hidden_dims: Tuple[int, ...]
    out_dim: int
    activation: str = "relu"

    @property
    def sizes(self) -> Tuple[int, ...]:
        return (self.in_dim, *self.hidden_dims, self.out_dim)

    @property
    def weight_count(self) -> int:
        """Total trainable scalars (named to avoid colliding with the
        emulator configs' ``n_params`` = number of INPUT parameters)."""
        s = self.sizes
        return sum(s[i] * s[i + 1] + s[i + 1] for i in range(len(s) - 1))


@dataclasses.dataclass(frozen=True)
class DirectEmulatorConfig:
    """Flagship params→signal MLP: 7 → 288 → 352 → 288 → 224 → 451
    (371,907 params; reference ``emulator.py:196,303-309``)."""

    n_params: int = 7
    n_bins: int = 451
    hidden_dims: Tuple[int, ...] = (288, 352, 288, 224)
    activation: str = "relu"

    def mlp(self) -> MLPConfig:
        return MLPConfig(self.n_params, self.hidden_dims, self.n_bins, self.activation)


DIRECT_ALIGNED = DirectEmulatorConfig(
    hidden_dims=(256, 256, 128, 128, 128)
)
"""128-aligned flagship architecture: every hidden width is a multiple
of 128, so the tuner's padded FLOP count equals the logical one for the
hidden stack — 393,216 padded FLOPs/row vs the reference shape's
1,048,576 (2.7× less), at 191,939 weights. Found by throughput-aware
successive halving over :data:`tpu21cmvae.tuner.MXU_ALIGNED_SPACE`
(``scripts/train_aligned.py``); strong-retrained to 0.177 % mean f32
test error and bf16-native fine-tuned to 0.195 % at
``Precision.DEFAULT`` on the golden synthetic split — the
equal-accuracy-class aligned counterpart of the reference's laptop-era
288/352/288/224 (reference ``emulator.py:196``). Shipped as
``pretrained/direct_aligned_bf16.npz``."""


@dataclasses.dataclass(frozen=True)
class AutoEncoderConfig:
    """Autoencoder-based emulator architecture (reference
    ``emulator.py:521-525``; confirmed against the shipped h5 weights)."""

    n_params: int = 7
    n_bins: int = 451
    latent_dim: int = 9
    enc_hidden_dims: Tuple[int, ...] = (352,)
    dec_hidden_dims: Tuple[int, ...] = (32, 352)
    em_hidden_dims: Tuple[int, ...] = (352, 352, 352, 224)
    activation: str = "relu"

    def encoder(self) -> MLPConfig:
        return MLPConfig(self.n_bins, self.enc_hidden_dims, self.latent_dim, self.activation)

    def decoder(self) -> MLPConfig:
        return MLPConfig(self.latent_dim, self.dec_hidden_dims, self.n_bins, self.activation)

    def emulator(self) -> MLPConfig:
        return MLPConfig(self.n_params, self.em_hidden_dims, self.latent_dim, self.activation)


@dataclasses.dataclass(frozen=True)
class VAEConfig(AutoEncoderConfig):
    """Variational variant: encoder emits (mu, logvar); loss adds a KL term.

    The VAE is named by the reference repo ("21cmVAE", interpretable latent
    space per ``README.rst:11``) but has no code in the v3.1.0 snapshot —
    its ``AutoEncoder`` is deterministic (reference ``emulator.py:445-518``).

    ``beta`` scales the KL term (beta=1 is the classic ELBO). The
    reconstruction term here is the per-bin-averaged relative MSE
    (O(1e-4) once trained), so an un-scaled KL dominates and collapses
    the posterior. Measured sweep (synthetic set, 80 epochs): beta ≥ 0.1
    → 0/9 active latents, ~24 % error; beta=1e-3 → 3/9 active, ~2.8 %;
    beta=1e-4 with a 50-epoch warm-up → 9/9 active, ~1.2 %. The default
    pairs that small beta with a linear KL warm-up over
    ``kl_anneal_epochs`` epochs (0 disables annealing), the standard
    posterior-collapse mitigation.
    """

    beta: float = 1e-4
    kl_anneal_epochs: int = 50


@dataclasses.dataclass(frozen=True)
class TrainConfig:
    """One training run. Canonical values are the reference's recipe
    (``notebooks/Training.ipynb`` cells 4-5; batch size at
    reference ``emulator.py:372``)."""

    epochs: int = 350
    batch_size: int = 256
    learning_rate: float = 0.01
    # Adam moments — Keras defaults (epsilon=1e-7, not optax's 1e-8).
    beta_1: float = 0.9
    beta_2: float = 0.999
    epsilon: float = 1e-7
    # EarlyStopping(monitor=val_loss, ...) semantics.
    early_stop_patience: Optional[int] = 15
    early_stop_min_delta: float = 1e-10
    restore_best_weights: bool = True
    # ReduceLROnPlateau semantics.
    plateau_patience: Optional[int] = 5
    plateau_factor: float = 0.95
    plateau_min_delta: float = 5e-9
    plateau_min_lr: float = 1e-4
    seed: int = 0


# Canonical presets -------------------------------------------------------

DIRECT_TRAIN_DEFAULT = TrainConfig()
"""Direct-emulator recipe: Adam lr=0.01, 350 epochs, plateau factor 0.95
(``Training.ipynb`` cells 4-5)."""

DIRECT_TRAIN_STRONG = TrainConfig(early_stop_patience=30)
"""The reference recipe with doubled early-stopping patience. The
published patience of 15 with min_delta=1e-10 frequently fires while the
LR schedule is still working (measured: runs stop at ~50-60 of 350
epochs at ~0.5 % mean error); patience 30 trains 150-310 epochs and
reached 0.16-0.28 % mean relative error across seeds at reference scale
on the synthetic set — beyond the reference's published 0.34 %. Training
runs as one device program with ``device_loop=True``, so the longer
schedule is cheap."""

AE_TRAIN_DEFAULT = TrainConfig(
    epochs=250,
    learning_rate=1e-3,
    early_stop_min_delta=5e-10,
    plateau_factor=0.9,
)
"""Autoencoder stage recipe: Adam lr=1e-3, 250 epochs, plateau factor 0.9
(``Training.ipynb`` cells 10-11)."""

AE_EMULATOR_TRAIN_DEFAULT = TrainConfig(
    epochs=250,
    learning_rate=1e-2,
    early_stop_min_delta=5e-5,
    plateau_factor=0.9,
    plateau_min_delta=5e-3,
)
"""Params→latent stage recipe: Adam lr=1e-2, 250 epochs, looser deltas
(``Training.ipynb`` cells 10-11)."""

AE_TRAIN_STRONG = dataclasses.replace(AE_TRAIN_DEFAULT, early_stop_patience=30)
AE_EMULATOR_TRAIN_STRONG = dataclasses.replace(
    AE_EMULATOR_TRAIN_DEFAULT, early_stop_patience=30
)
"""Patience-30 variants of the AE-stage recipes (see
:data:`DIRECT_TRAIN_STRONG` for the rationale). Measured at reference
scale on the synthetic set: emulator 0.18 %/0.16 % mean/median and pure
reconstruction 0.12 %/0.11 % — beyond the reference's published
0.39 %/0.33 %."""
