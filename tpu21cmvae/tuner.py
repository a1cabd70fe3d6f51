"""Hyperparameter tuner: architecture search for the emulator families.

The reference advertises a tuner ("modules for hyperparameter tuning",
reference ``README.rst:13``) used in Bye et al. 2022 to find the
7→288→352→288→224→451 flagship architecture, but the file is gitignored
and absent from the v3.1.0 snapshot (reference ``.gitignore:14``). This
module restores the capability, designed for device throughput:

* random search over hidden-layer stacks (layer count × width choices),
  scored by mean relative validation error — the paper's figure of merit
  (reference ``emulator.py:53-54``);
* short-budget trials with early stopping; every trial runs the same
  jit-compiled epoch loop, and architectures with identical layer shapes
  hit XLA's compilation cache, so the search is dominated by step time,
  not retracing;
* width choices default to multiples of 32, matching the granularity
  the reference's published architectures use (288/352/224…). The cost
  model charges matmuls at a 128-wide tile granularity — a 288-wide
  layer multiplies as 384, a 224 as 256 (``utils/profiling.py::
  matmul_flops_per_row``), so :data:`MXU_ALIGNED_SPACE` searches
  128-multiples only, and every trial records its padded cost. That
  granularity comes from an earlier accelerator and is not yet
  calibrated on a GPU (ROADMAP D4);
* throughput-aware selection: :meth:`TuneResult.best_efficient` picks
  the cheapest padded trial within an accuracy slack of the best —
  val error stays the primary objective, padding the tiebreak;
* deterministic: one root seed fans out per-trial init/shuffle keys.

``tune_direct`` searches the params→signal MLP; ``tune_autoencoder``
searches (latent_dim, encoder/decoder stacks) for the AE family;
``retrain_best`` then trains the winner with the full reference recipe.
"""

from __future__ import annotations

import dataclasses
import functools
import time
from typing import Callable, List, Optional, Tuple

import numpy as np

from tpu21cmvae.data.dataset import DataSplits
from tpu21cmvae.utils.config import (
    AutoEncoderConfig,
    DirectEmulatorConfig,
    TrainConfig,
    VAEConfig,
)
from tpu21cmvae.utils.metrics import error

#: Short-budget trial recipe: the reference training recipe
#: (Training.ipynb cells 4-5) cut down for search throughput.
TRIAL_TRAIN_DEFAULT = TrainConfig(
    epochs=80,
    early_stop_patience=10,
    plateau_patience=4,
)


@dataclasses.dataclass(frozen=True)
class SearchSpace:
    """Architecture search space for a dense MLP stack."""

    min_layers: int = 2
    max_layers: int = 5
    width_choices: Tuple[int, ...] = (64, 96, 128, 160, 192, 224, 256, 288, 320, 352)

    def sample(self, rng: np.random.Generator) -> Tuple[int, ...]:
        n = int(rng.integers(self.min_layers, self.max_layers + 1))
        return tuple(int(w) for w in rng.choice(self.width_choices, size=n))


#: 128-aligned search space: every hidden width is a multiple of the
#: cost model's 128-wide tile, so padded cost == logical cost for the
#: hidden stack (the 451-bin output pads to 512 regardless — fixed by
#: the physics). The aligned counterpart of the reference's
#: laptop-era 288/352/288/224 shape (reference ``emulator.py:196``).
MXU_ALIGNED_SPACE = SearchSpace(
    min_layers=3, max_layers=5, width_choices=(128, 256, 384)
)


@dataclasses.dataclass(frozen=True)
class LatentSearchSpace(SearchSpace):
    """AE search space: hidden stacks plus the latent bottleneck width."""

    min_layers: int = 1
    max_layers: int = 3
    latent_choices: Tuple[int, ...] = (5, 7, 9, 11, 13)

    def sample_latent(self, rng: np.random.Generator) -> int:
        return int(rng.choice(self.latent_choices))


@dataclasses.dataclass(frozen=True)
class VAESearchSpace(LatentSearchSpace):
    """VAE search space: latent/hidden widths plus the KL weight β (the
    measured posterior-collapse cliff sits between 1e-3 and 1e-1 —
    ``utils/config.py::VAEConfig``)."""

    beta_choices: Tuple[float, ...] = (1e-5, 1e-4, 1e-3)

    def sample_beta(self, rng: np.random.Generator) -> float:
        return float(rng.choice(self.beta_choices))


@dataclasses.dataclass
class Trial:
    """One evaluated architecture."""

    config: object  # DirectEmulatorConfig or AutoEncoderConfig
    val_error: float  # mean relative RMSE (%) on the validation split
    val_loss: float
    epochs_ran: int
    wall_time_s: float
    # total trainable scalars — named like MLPConfig.weight_count to avoid
    # colliding with the configs' n_params (= number of INPUT parameters)
    weight_count: int

    @property
    def padded_flops_per_row(self) -> float:
        """Padded matmul FLOPs per batch row for this architecture's
        forward (both weight-tile dims rounded up to 128; the skinny
        first layer runs as broadcast multiply-adds and is skipped) —
        the throughput cost :meth:`TuneResult.best_efficient` ranks by.
        0.0 for configs without a single ``mlp()`` chain (AE/VAE trials
        span three stacks; extend when they need the ranking)."""
        from tpu21cmvae.utils.profiling import matmul_flops_per_row

        mlp = getattr(self.config, "mlp", None)
        if mlp is None:
            return 0.0
        return float(matmul_flops_per_row(mlp().sizes)[1])

    def describe(self) -> str:
        return (
            f"{self.config!r}: val_err={self.val_error:.4f}% "
            f"({self.weight_count} weights, {self.epochs_ran} epochs, "
            f"{self.wall_time_s:.1f}s)"
        )


@dataclasses.dataclass
class TuneResult:
    """All trials, best first."""

    trials: List[Trial]

    @property
    def best(self) -> Trial:
        return self.trials[0]

    def best_efficient(self, slack: float = 0.10) -> Trial:
        """Throughput-aware selection: among trials whose validation
        error is within ``slack`` (relative) of the best, return the
        one with the LOWEST padded cost (ties → better error).
        Accuracy stays the primary objective; the padded cost — which
        differs by ~30 % between the reference's 288/352/288/224 stack
        and an aligned one of equal logical size — breaks the near-ties
        that pure val-error ranking decided by noise. Falls back to :attr:`best`
        when no trial records a cost (AE/VAE trials)."""
        if not 0.0 <= slack:
            raise ValueError(f"slack must be >= 0; got {slack}")
        finite = [t for t in self.trials if np.isfinite(t.val_error)]
        if not finite:
            return self.best
        cutoff = finite[0].val_error * (1.0 + slack)
        pool = [t for t in finite if t.val_error <= cutoff
                and t.padded_flops_per_row > 0.0]
        if not pool:
            return self.best
        return min(pool, key=lambda t: (t.padded_flops_per_row,
                                        t.val_error))

    def leaderboard(self, k: int = 10) -> str:
        return "\n".join(t.describe() for t in self.trials[:k])


def _run_trials(
    n_trials: int,
    sample_config: Callable[[np.random.Generator], object],
    evaluate: Callable[[object, int], Tuple[float, float, int, int]],
    seed: int,
    verbose: bool,
) -> TuneResult:
    rng = np.random.default_rng(seed)
    trials: List[Trial] = []
    seen = set()
    for i in range(n_trials):
        # resample on duplicates (configs are frozen dataclasses →
        # hashable); a small space can exhaust — stop loudly, not short
        cfg = sample_config(rng)
        attempts = 1
        while cfg in seen and attempts < 50:
            cfg = sample_config(rng)
            attempts += 1
        if cfg in seen:
            if verbose:
                print(
                    f"[tune] search space exhausted after {len(trials)} "
                    f"unique architectures; stopping early", flush=True
                )
            break
        seen.add(cfg)
        t0 = time.perf_counter()
        val_error, val_loss, epochs_ran, weight_count = evaluate(cfg, seed + i + 1)
        trial = Trial(
            config=cfg,
            val_error=val_error,
            val_loss=val_loss,
            epochs_ran=epochs_ran,
            wall_time_s=time.perf_counter() - t0,
            weight_count=weight_count,
        )
        trials.append(trial)
        if verbose:
            print(f"[tune {i + 1}/{n_trials}] {trial.describe()}", flush=True)
    # diverged trials (NaN val_error) sort last, never win
    trials.sort(key=lambda t: (not np.isfinite(t.val_error), t.val_error))
    return TuneResult(trials)


def _prep(data: DataSplits):
    """Transform the splits ONCE for a whole search (the reference
    re-preprocesses per call, ``preprocess.py:88-101``)."""
    from tpu21cmvae.ops.transforms import Normalizer, par_transform, preproc

    norm = Normalizer.from_data(data.par_train, data.signal_train)
    return (
        norm,
        par_transform(np.asarray(data.par_train, np.float32), norm),
        preproc(np.asarray(data.signal_train, np.float32), norm),
        par_transform(np.asarray(data.par_val, np.float32), norm),
        preproc(np.asarray(data.signal_val, np.float32), norm),
    )


def _loss_cache(make):
    """Loss-closure cache keyed on the (hashable) loss hyperparameters —
    activation, and for the VAE also (beta, anneal). Trials reuse ONE
    function object per key, so the train loops' jitted-program factories
    (keyed on loss identity — ``train/scan.py``) and jax's jit cache hit
    across trials and SHA rungs: same-shape candidates compile zero new
    programs (``tests/test_retrace.py``)."""
    cache = {}

    def get(*key):
        if key not in cache:
            cache[key] = make(*key)
        return cache[key]

    return get


# Module-level loss factories shared by every tune_* function: one
# closure per (hyperparameters, normalization constants) across ALL
# searches in a process, so the loss-identity-keyed program caches hit
# across separate tune_* calls too, not just across rungs of one call.

@functools.lru_cache(maxsize=64)
def _em_mse_loss(act):
    """Stage-B params→latent loss (plain MSE; normalizer-independent)."""
    from tpu21cmvae.ops.losses import mse
    from tpu21cmvae.ops.mlp import mlp_apply

    def em_loss(p, bx, by):
        return mse(by, mlp_apply(p, bx, act))

    return em_loss


# bounded: each closure pins its captured scaled_mean device buffer, so
# a long-lived process tuning across many datasets must not grow forever.
# Eviction here is REAL since the train factories moved their program
# caches onto the closure itself (train/loop.py::_WeakFnCache): dropping
# a closure from this dict frees its compiled programs and constants too
# (tests/test_retrace.py::test_dropped_loss_closure_frees_factory_entries).
_REL_LOSS_CACHE_CAP = 32
_REL_LOSS_CACHE: dict = {}


def _rel_cache_put(key, fn):
    _REL_LOSS_CACHE[key] = fn
    if len(_REL_LOSS_CACHE) > _REL_LOSS_CACHE_CAP:
        _REL_LOSS_CACHE.pop(next(iter(_REL_LOSS_CACHE)))  # evict oldest


def _direct_rel_loss(act, sm):
    """Direct-emulator relative-MSE loss, cached per (act, scaled_mean)."""
    key = ("direct", act, np.asarray(sm).tobytes())
    if key not in _REL_LOSS_CACHE:
        from tpu21cmvae.ops.losses import relative_mse
        from tpu21cmvae.ops.mlp import mlp_apply

        def loss_fn(p, bx, by):
            return relative_mse(by, mlp_apply(p, bx, act), sm)

        _rel_cache_put(key, loss_fn)
    return _REL_LOSS_CACHE[key]


def _ae_rel_loss(act, sm):
    """Autoencoder reconstruction relative-MSE loss, cached likewise."""
    key = ("ae", act, np.asarray(sm).tobytes())
    if key not in _REL_LOSS_CACHE:
        from tpu21cmvae.ops.losses import relative_mse
        from tpu21cmvae.ops.mlp import mlp_apply

        def ae_loss(p, bx, by):
            rec = mlp_apply(p["dec"], mlp_apply(p["enc"], bx, act), act)
            return relative_mse(by, rec, sm)

        _rel_cache_put(key, ae_loss)
    return _REL_LOSS_CACHE[key]


def tune_direct(
    data: DataSplits,
    n_trials: int = 20,
    space: SearchSpace = SearchSpace(),
    train_config: TrainConfig = TRIAL_TRAIN_DEFAULT,
    seed: int = 0,
    verbose: bool = False,
    device_loop: bool = False,
) -> TuneResult:
    """Random search over direct-emulator hidden stacks.

    Scores each architecture by mean relative RMSE (%) on the validation
    split — the paper's figure of merit (Eq. 1; reference
    ``emulator.py:133-134``), computed on real-unit (mK) predictions.
    """
    import jax

    from tpu21cmvae.ops.mlp import init_mlp, mlp_apply
    from tpu21cmvae.ops.transforms import unpreproc
    from tpu21cmvae.train.loop import fit
    from tpu21cmvae.train.scan import fit_scan

    fitter = fit_scan if device_loop else fit
    norm, x_train, y_train, x_val, y_val = _prep(data)
    sm = norm.scaled_mean
    signal_val = np.asarray(data.signal_val)

    def get_loss(act):
        return _direct_rel_loss(act, sm)

    def sample(rng):
        return DirectEmulatorConfig(
            n_params=data.n_params, n_bins=data.n_bins,
            hidden_dims=space.sample(rng),
        )

    def evaluate(cfg, trial_seed):
        # same init key as DirectEmulator(data, config=cfg, seed=trial_seed)
        params = init_mlp(jax.random.key(trial_seed), cfg.mlp().sizes)
        cfg_train = dataclasses.replace(train_config, seed=trial_seed)
        params, _, hist = fitter(
            params, get_loss(cfg.activation), x_train, y_train, x_val,
            y_val, cfg_train,
        )
        pred = unpreproc(mlp_apply(params, x_val, cfg.activation), norm)
        val_err = float(np.mean(error(signal_val, np.asarray(pred))))
        return (
            val_err,
            float(min(hist.val_loss)),
            len(hist.val_loss),
            cfg.mlp().weight_count,
        )

    return _run_trials(n_trials, sample, evaluate, seed, verbose)


def tune_autoencoder(
    data: DataSplits,
    n_trials: int = 20,
    space: LatentSearchSpace = LatentSearchSpace(),
    em_space: SearchSpace = SearchSpace(),
    ae_train_config: Optional[TrainConfig] = None,
    em_train_config: Optional[TrainConfig] = None,
    seed: int = 0,
    verbose: bool = False,
    device_loop: bool = False,
) -> TuneResult:
    """Random search for the AE-based emulator: latent width, encoder /
    decoder stacks, and the params→latent stack (reference architecture
    at ``emulator.py:521-525``). Scored end-to-end (params → decoder →
    mK) on the validation split."""
    import jax

    from tpu21cmvae.ops.mlp import init_mlp, mlp_apply
    from tpu21cmvae.ops.transforms import unpreproc
    from tpu21cmvae.train.loop import fit
    from tpu21cmvae.train.scan import fit_scan

    fitter = fit_scan if device_loop else fit
    short = dataclasses.replace(
        TRIAL_TRAIN_DEFAULT, learning_rate=1e-3, plateau_factor=0.9
    )
    ae_cfg_t = ae_train_config or short
    em_cfg_t = em_train_config or dataclasses.replace(short, learning_rate=1e-2)

    norm, x_train, y_train, x_val, y_val = _prep(data)
    sm = norm.scaled_mean
    signal_val = np.asarray(data.signal_val)

    def get_ae_loss(act):
        return _ae_rel_loss(act, sm)

    get_em_loss = _em_mse_loss

    def sample(rng):
        return AutoEncoderConfig(
            n_params=data.n_params,
            n_bins=data.n_bins,
            latent_dim=space.sample_latent(rng),
            enc_hidden_dims=space.sample(rng),
            dec_hidden_dims=space.sample(rng),
            em_hidden_dims=em_space.sample(rng),
        )

    def evaluate(cfg, trial_seed):
        act = cfg.activation
        # same init keys as AutoEncoderEmulator(..., seed=trial_seed)
        k_enc, k_dec = jax.random.split(jax.random.key(trial_seed))
        ae_params = {
            "enc": init_mlp(k_enc, cfg.encoder().sizes),
            "dec": init_mlp(k_dec, cfg.decoder().sizes),
        }
        em_params = init_mlp(
            jax.random.key(trial_seed + 1), cfg.emulator().sizes
        )
        ae_params, _, _ = fitter(
            ae_params, get_ae_loss(act), y_train, y_train, y_val, y_val,
            dataclasses.replace(ae_cfg_t, seed=trial_seed),
        )
        # stage B: frozen-encoder latents as labels (emulator.py:753-754)
        z_train = mlp_apply(ae_params["enc"], y_train, act)
        z_val = mlp_apply(ae_params["enc"], y_val, act)
        em_params, _, em_hist = fitter(
            em_params, get_em_loss(act), x_train, z_train, x_val, z_val,
            dataclasses.replace(em_cfg_t, seed=trial_seed),
        )
        pred = unpreproc(
            mlp_apply(ae_params["dec"], mlp_apply(em_params, x_val, act), act),
            norm,
        )
        val_err = float(np.mean(error(signal_val, np.asarray(pred))))
        n_par = (
            cfg.encoder().weight_count
            + cfg.decoder().weight_count
            + cfg.emulator().weight_count
        )
        return val_err, float(min(em_hist.val_loss)), len(em_hist.val_loss), n_par

    return _run_trials(n_trials, sample, evaluate, seed, verbose)


def retrain_best(
    result: TuneResult,
    data: DataSplits,
    train_config: Optional[TrainConfig] = None,
    seed: int = 0,
    n_seeds: int = 1,
    mesh=None,
):
    """Train the winning architecture with the full reference recipe
    (350-epoch direct / 250-epoch AE defaults) and return the model.

    ``n_seeds > 1`` (direct family) trains that many init/shuffle-seed
    replicas as ONE vmapped whole-run program
    (:func:`tpu21cmvae.train.scan.fit_scan_stack` — seed-to-seed spread
    is real: 0.16-0.28 % across seeds 0-2 at the strong recipe,
    docs/PERF.md) and returns the replica with the best validation loss;
    ``mesh=`` shards the seed axis over devices."""
    cfg = result.best.config
    if isinstance(cfg, DirectEmulatorConfig):
        from tpu21cmvae.models.direct import DirectEmulator

        if n_seeds > 1:
            from tpu21cmvae.models.ensemble import DeepEnsemble

            ens = DeepEnsemble.train(
                data, n_members=n_seeds, config=cfg,
                train_config=train_config,
                seeds=[seed + i for i in range(n_seeds)],
                parallel=True, mesh=mesh,
            )
            return min(ens.members,
                       key=lambda m: min(m.history.val_loss))
        model = DirectEmulator(data, config=cfg, seed=seed)
        model.train(train_config=train_config)
        return model
    # VAEConfig subclasses AutoEncoderConfig — check the subclass first
    if isinstance(cfg, VAEConfig):
        from tpu21cmvae.models.vae import VAEEmulator

        model = VAEEmulator(data, config=cfg, seed=seed)
        model.train(vae_train_config=train_config, em_train_config=train_config)
        return model
    from tpu21cmvae.models.autoencoder import AutoEncoderEmulator

    model = AutoEncoderEmulator(data, config=cfg, seed=seed)
    # one recipe supplied → apply to both stages; None keeps the defaults
    model.train(ae_train_config=train_config, em_train_config=train_config)
    return model


def tune_direct_halving(
    data: DataSplits,
    n_initial: int = 16,
    rungs: int = 3,
    eta: int = 2,
    rung_epochs: int = 20,
    space: SearchSpace = SearchSpace(),
    train_config: TrainConfig = TRIAL_TRAIN_DEFAULT,
    seed: int = 0,
    verbose: bool = False,
    device_loop: bool = False,
) -> TuneResult:
    """Successive-halving architecture search for the direct emulator.

    Classic synchronous SHA: start ``n_initial`` random architectures,
    train each ``rung_epochs`` epochs, keep the best ``1/eta`` fraction,
    and CONTINUE the survivors (parameters and Adam moments carry over
    between rungs — no retraining from scratch) for another rung, for
    ``rungs`` rounds. Spends most of the budget on promising
    architectures, unlike plain random search which trains every sample
    to the full trial budget.

    Scores by mean relative validation error (%); returns a
    :class:`TuneResult` whose trials carry each survivor's total epochs.
    """
    import jax

    from tpu21cmvae.ops.mlp import init_mlp, mlp_apply
    from tpu21cmvae.ops.transforms import unpreproc
    from tpu21cmvae.train.loop import fit
    from tpu21cmvae.train.scan import fit_scan

    fitter = fit_scan if device_loop else fit

    rng = np.random.default_rng(seed)
    norm, x_train, y_train, x_val, y_val = _prep(data)
    sm = norm.scaled_mean

    # disable the monitors inside a rung: SHA's rung boundary is the
    # early-stopping mechanism; the LR schedule still applies per-rung
    rung_cfg = dataclasses.replace(
        train_config,
        epochs=rung_epochs,
        early_stop_patience=None,
    )

    # sample unique architectures; an attempts bound (not a seen-count
    # check) terminates when the space has fewer than n_initial uniques —
    # then proceed with however many were found
    seen, configs = set(), []
    attempts = 0
    while len(configs) < n_initial and attempts < n_initial * 50:
        attempts += 1
        dims = space.sample(rng)
        if dims not in seen:
            seen.add(dims)
            configs.append(
                DirectEmulatorConfig(
                    n_params=data.n_params, n_bins=data.n_bins, hidden_dims=dims
                )
            )

    def get_loss(act):
        return _direct_rel_loss(act, sm)

    survivors = []
    for k, cfg in enumerate(configs):
        params = init_mlp(jax.random.key(seed + k + 1), cfg.mlp().sizes)
        survivors.append(
            {"cfg": cfg, "params": params, "opt": None, "epochs": 0, "t0": time.perf_counter()}
        )

    for rung in range(rungs):
        for s in survivors:
            s["params"], s["opt"], hist = fitter(
                s["params"], get_loss(s["cfg"].activation), x_train, y_train,
                x_val, y_val, rung_cfg, opt_state=s["opt"],
            )
            s["epochs"] += len(hist.loss)
            pred = unpreproc(
                mlp_apply(s["params"], x_val, s["cfg"].activation), norm
            )
            s["val_err"] = float(
                np.mean(error(np.asarray(data.signal_val), np.asarray(pred)))
            )
        survivors.sort(key=lambda s: (not np.isfinite(s["val_err"]), s["val_err"]))
        if verbose:
            print(
                f"[sha rung {rung + 1}/{rungs}] best "
                f"{survivors[0]['val_err']:.4f}% "
                f"{survivors[0]['cfg'].hidden_dims} "
                f"({len(survivors)} candidates)",
                flush=True,
            )
        if rung < rungs - 1:
            survivors = survivors[: max(1, len(survivors) // eta)]

    trials = [
        Trial(
            config=s["cfg"],
            val_error=s["val_err"],
            val_loss=float("nan"),
            epochs_ran=s["epochs"],
            wall_time_s=time.perf_counter() - s["t0"],
            weight_count=s["cfg"].mlp().weight_count,
        )
        for s in survivors
    ]
    trials.sort(key=lambda t: (not np.isfinite(t.val_error), t.val_error))
    return TuneResult(trials)


def tune_autoencoder_halving(
    data: DataSplits,
    n_initial: int = 16,
    rungs: int = 3,
    eta: int = 2,
    rung_epochs: int = 20,
    space: LatentSearchSpace = LatentSearchSpace(),
    em_space: SearchSpace = SearchSpace(),
    seed: int = 0,
    verbose: bool = False,
    device_loop: bool = False,
) -> TuneResult:
    """Successive-halving search for the AE-based emulator.

    Each rung continues BOTH stages of every surviving candidate:
    ``rung_epochs`` more autoencoder epochs (Adam state carried), then a
    re-encode of the (moving) latent targets and ``rung_epochs`` more
    params→latent epochs (its Adam state carried too — Adam adapts to
    the target drift between rungs). Scored end-to-end in mK on the
    validation split.
    """
    import jax

    from tpu21cmvae.models.autoencoder import AutoEncoder
    from tpu21cmvae.ops.mlp import init_mlp, mlp_apply
    from tpu21cmvae.ops.transforms import unpreproc
    from tpu21cmvae.train.loop import fit
    from tpu21cmvae.train.scan import fit_scan

    fitter = fit_scan if device_loop else fit
    rng = np.random.default_rng(seed)
    norm, x_train, y_train, x_val, y_val = _prep(data)
    sm = norm.scaled_mean

    ae_cfg = TrainConfig(
        epochs=rung_epochs, learning_rate=1e-3,
        early_stop_patience=None, plateau_factor=0.9,
    )
    em_cfg = TrainConfig(
        epochs=rung_epochs, learning_rate=1e-2,
        early_stop_patience=None, plateau_factor=0.9,
    )

    seen, survivors = set(), []
    attempts = 0
    while len(survivors) < n_initial and attempts < n_initial * 50:
        attempts += 1
        cfg = AutoEncoderConfig(
            n_params=data.n_params,
            n_bins=data.n_bins,
            latent_dim=space.sample_latent(rng),
            enc_hidden_dims=space.sample(rng),
            dec_hidden_dims=space.sample(rng),
            em_hidden_dims=em_space.sample(rng),
        )
        if cfg in seen:
            continue
        seen.add(cfg)
        k = len(survivors)
        ae = AutoEncoder(cfg, seed=seed + k + 1)
        survivors.append({
            "cfg": cfg,
            "ae": ae.params,
            "em": init_mlp(jax.random.key(seed - k - 1), cfg.emulator().sizes),
            "ae_opt": None,
            "em_opt": None,
            "epochs": 0,
            "t0": time.perf_counter(),
        })

    def get_ae_loss(act):
        return _ae_rel_loss(act, sm)

    get_em_loss = _em_mse_loss

    for rung in range(rungs):
        for s in survivors:
            act = s["cfg"].activation
            s["ae"], s["ae_opt"], _ = fitter(
                s["ae"], get_ae_loss(act), y_train, y_train, y_val, y_val,
                ae_cfg, opt_state=s["ae_opt"],
            )
            z_train = mlp_apply(s["ae"]["enc"], y_train, act)
            z_val = mlp_apply(s["ae"]["enc"], y_val, act)

            s["em"], s["em_opt"], hist = fitter(
                s["em"], get_em_loss(act), x_train, z_train, x_val, z_val,
                em_cfg, opt_state=s["em_opt"],
            )
            s["epochs"] += 2 * rung_epochs
            pred = unpreproc(
                mlp_apply(s["ae"]["dec"], mlp_apply(s["em"], x_val, act), act),
                norm,
            )
            s["val_err"] = float(
                np.mean(error(np.asarray(data.signal_val), np.asarray(pred)))
            )
        survivors.sort(key=lambda s: (not np.isfinite(s["val_err"]), s["val_err"]))
        if verbose:
            print(
                f"[ae-sha rung {rung + 1}/{rungs}] best "
                f"{survivors[0]['val_err']:.4f}% latent "
                f"{survivors[0]['cfg'].latent_dim} ({len(survivors)} candidates)",
                flush=True,
            )
        if rung < rungs - 1:
            survivors = survivors[: max(1, len(survivors) // eta)]

    trials = [
        Trial(
            config=s["cfg"],
            val_error=s["val_err"],
            val_loss=float("nan"),
            epochs_ran=s["epochs"],
            wall_time_s=time.perf_counter() - s["t0"],
            weight_count=(
                s["cfg"].encoder().weight_count
                + s["cfg"].decoder().weight_count
                + s["cfg"].emulator().weight_count
            ),
        )
        for s in survivors
    ]
    trials.sort(key=lambda t: (not np.isfinite(t.val_error), t.val_error))
    return TuneResult(trials)


def _vae_weight_count(cfg: VAEConfig) -> int:
    """Trainable scalars of the full VAE emulator: trunk + two latent
    heads (mu, logvar) + decoder + params→latent MLP. Differs from the
    deterministic AE count — the VAE encoder ends in TWO linear heads
    (:class:`tpu21cmvae.models.vae.VAE`)."""
    trunk_sizes = (cfg.n_bins, *cfg.enc_hidden_dims)
    trunk = sum(
        trunk_sizes[i] * trunk_sizes[i + 1] + trunk_sizes[i + 1]
        for i in range(len(trunk_sizes) - 1)
    )
    heads = 2 * (trunk_sizes[-1] * cfg.latent_dim + cfg.latent_dim)
    return (
        trunk
        + heads
        + cfg.decoder().weight_count
        + cfg.emulator().weight_count
    )


def _make_vae_losses(sm):
    """Cached stochastic VAE stage-A losses keyed on (activation, beta,
    anneal): β-ELBO with linear KL warm-up, matching
    ``VAEEmulator.train`` (``models/vae.py``)."""
    import jax.numpy as jnp

    from tpu21cmvae.models.vae import VAE
    from tpu21cmvae.ops.losses import kl_divergence, relative_mse

    def make(act, beta, anneal):
        # methods-only carrier: VAE.apply reads the activation from the
        # config and everything else from the params pytree
        carrier = VAE(VAEConfig(activation=act))

        def vae_loss(p, bx, by, key, epoch):
            recon, mu, logvar = carrier.apply(p, bx, key)
            scale = (
                jnp.minimum(1.0, (epoch + 1.0) / anneal) if anneal > 0 else 1.0
            )
            return relative_mse(by, recon, sm) + (beta * scale) * kl_divergence(
                mu, logvar
            )

        return vae_loss

    return _loss_cache(make)


def tune_vae(
    data: DataSplits,
    n_trials: int = 20,
    space: VAESearchSpace = VAESearchSpace(),
    em_space: SearchSpace = SearchSpace(),
    vae_train_config: Optional[TrainConfig] = None,
    em_train_config: Optional[TrainConfig] = None,
    kl_anneal_epochs: int = 20,
    seed: int = 0,
    verbose: bool = False,
    device_loop: bool = False,
) -> TuneResult:
    """Random search for the VAE-based emulator: latent width, trunk /
    decoder / params→latent stacks, AND the KL weight β. Scored
    end-to-end (params → z_mean emulator → decoder → mK) on the
    validation split — the same figure of merit as the other families,
    so β trades reconstruction fidelity against latent regularity on
    equal footing."""
    import jax

    from tpu21cmvae.models.vae import VAE
    from tpu21cmvae.ops.mlp import init_mlp, mlp_apply
    from tpu21cmvae.ops.transforms import unpreproc
    from tpu21cmvae.train.loop import fit
    from tpu21cmvae.train.scan import fit_scan

    fitter = fit_scan if device_loop else fit
    short = dataclasses.replace(
        TRIAL_TRAIN_DEFAULT, learning_rate=1e-3, plateau_factor=0.9
    )
    vae_cfg_t = vae_train_config or short
    em_cfg_t = em_train_config or dataclasses.replace(short, learning_rate=1e-2)

    norm, x_train, y_train, x_val, y_val = _prep(data)
    sm = norm.scaled_mean
    signal_val = np.asarray(data.signal_val)
    get_vae_loss = _make_vae_losses(sm)

    get_em_loss = _em_mse_loss

    def sample(rng):
        return VAEConfig(
            n_params=data.n_params,
            n_bins=data.n_bins,
            latent_dim=space.sample_latent(rng),
            enc_hidden_dims=space.sample(rng),
            dec_hidden_dims=space.sample(rng),
            em_hidden_dims=em_space.sample(rng),
            beta=space.sample_beta(rng),
            kl_anneal_epochs=kl_anneal_epochs,
        )

    def evaluate(cfg, trial_seed):
        act = cfg.activation
        # same init keys as VAEEmulator(..., seed=trial_seed)
        vae_params = VAE(cfg, seed=trial_seed).params
        em_params = init_mlp(
            jax.random.key(trial_seed + 1), cfg.emulator().sizes
        )
        vae_params, _, _ = fitter(
            vae_params,
            get_vae_loss(act, cfg.beta, int(cfg.kl_anneal_epochs)),
            y_train, y_train, y_val, y_val,
            dataclasses.replace(vae_cfg_t, seed=trial_seed),
            stochastic=True, pass_epoch=True,
        )
        carrier = VAE(cfg, params=vae_params)
        z_train, _ = carrier.encode(vae_params, y_train)
        z_val, _ = carrier.encode(vae_params, y_val)
        em_params, _, em_hist = fitter(
            em_params, get_em_loss(act), x_train, z_train, x_val, z_val,
            dataclasses.replace(em_cfg_t, seed=trial_seed),
        )
        pred = unpreproc(
            carrier.decode(vae_params, mlp_apply(em_params, x_val, act)), norm
        )
        val_err = float(np.mean(error(signal_val, np.asarray(pred))))
        return (
            val_err,
            float(min(em_hist.val_loss)),
            len(em_hist.val_loss),
            _vae_weight_count(cfg),
        )

    return _run_trials(n_trials, sample, evaluate, seed, verbose)


def tune_vae_halving(
    data: DataSplits,
    n_initial: int = 16,
    rungs: int = 3,
    eta: int = 2,
    rung_epochs: int = 20,
    space: VAESearchSpace = VAESearchSpace(),
    em_space: SearchSpace = SearchSpace(),
    seed: int = 0,
    verbose: bool = False,
    device_loop: bool = False,
) -> TuneResult:
    """Successive-halving search for the VAE-based emulator.

    Each rung continues BOTH stages of every survivor (VAE epochs with
    Adam state carried, then re-encoded z_mean targets and more
    params→latent epochs). Within-rung KL annealing is disabled (full β
    from the first epoch): the warm-up schedule is epoch-indexed per
    call and would restart every rung, silently under-weighting the KL
    term for short rungs — candidates instead compete at their final-β
    objective from the start.
    """
    import jax

    from tpu21cmvae.models.vae import VAE
    from tpu21cmvae.ops.mlp import init_mlp, mlp_apply
    from tpu21cmvae.ops.transforms import unpreproc
    from tpu21cmvae.train.loop import fit
    from tpu21cmvae.train.scan import fit_scan

    fitter = fit_scan if device_loop else fit
    rng = np.random.default_rng(seed)
    norm, x_train, y_train, x_val, y_val = _prep(data)
    sm = norm.scaled_mean
    get_vae_loss = _make_vae_losses(sm)

    get_em_loss = _em_mse_loss

    vae_cfg = TrainConfig(
        epochs=rung_epochs, learning_rate=1e-3,
        early_stop_patience=None, plateau_factor=0.9,
    )
    em_cfg = TrainConfig(
        epochs=rung_epochs, learning_rate=1e-2,
        early_stop_patience=None, plateau_factor=0.9,
    )

    seen, survivors = set(), []
    attempts = 0
    while len(survivors) < n_initial and attempts < n_initial * 50:
        attempts += 1
        cfg = VAEConfig(
            n_params=data.n_params,
            n_bins=data.n_bins,
            latent_dim=space.sample_latent(rng),
            enc_hidden_dims=space.sample(rng),
            dec_hidden_dims=space.sample(rng),
            em_hidden_dims=em_space.sample(rng),
            beta=space.sample_beta(rng),
            kl_anneal_epochs=0,  # see docstring: no within-rung warm-up
        )
        if cfg in seen:
            continue
        seen.add(cfg)
        k = len(survivors)
        survivors.append({
            "cfg": cfg,
            "vae": VAE(cfg, seed=seed + k + 1).params,
            "em": init_mlp(jax.random.key(seed - k - 1), cfg.emulator().sizes),
            "vae_opt": None,
            "em_opt": None,
            "epochs": 0,
            "t0": time.perf_counter(),
        })

    for rung in range(rungs):
        for s in survivors:
            cfg = s["cfg"]
            act = cfg.activation
            s["vae"], s["vae_opt"], _ = fitter(
                s["vae"], get_vae_loss(act, cfg.beta, 0),
                y_train, y_train, y_val, y_val,
                dataclasses.replace(vae_cfg, seed=seed),
                opt_state=s["vae_opt"], stochastic=True, pass_epoch=True,
            )
            carrier = VAE(cfg, params=s["vae"])
            z_train, _ = carrier.encode(s["vae"], y_train)
            z_val, _ = carrier.encode(s["vae"], y_val)
            s["em"], s["em_opt"], _ = fitter(
                s["em"], get_em_loss(act), x_train, z_train, x_val, z_val,
                dataclasses.replace(em_cfg, seed=seed),
                opt_state=s["em_opt"],
            )
            s["epochs"] += 2 * rung_epochs
            pred = unpreproc(
                carrier.decode(s["vae"], mlp_apply(s["em"], x_val, act)), norm
            )
            s["val_err"] = float(
                np.mean(error(np.asarray(data.signal_val), np.asarray(pred)))
            )
        survivors.sort(key=lambda s: (not np.isfinite(s["val_err"]), s["val_err"]))
        if verbose:
            print(
                f"[vae-sha rung {rung + 1}/{rungs}] best "
                f"{survivors[0]['val_err']:.4f}% latent "
                f"{survivors[0]['cfg'].latent_dim} beta "
                f"{survivors[0]['cfg'].beta:g} ({len(survivors)} candidates)",
                flush=True,
            )
        if rung < rungs - 1:
            survivors = survivors[: max(1, len(survivors) // eta)]

    trials = [
        Trial(
            config=s["cfg"],
            val_error=s["val_err"],
            val_loss=float("nan"),
            epochs_ran=s["epochs"],
            wall_time_s=time.perf_counter() - s["t0"],
            weight_count=_vae_weight_count(s["cfg"]),
        )
        for s in survivors
    ]
    trials.sort(key=lambda t: (not np.isfinite(t.val_error), t.val_error))
    return TuneResult(trials)
