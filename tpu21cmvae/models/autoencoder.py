"""Autoencoder-based emulator family.

Capability parity with the reference's ``AutoEncoder`` +
``AutoEncoderEmulator`` (reference ``emulator.py:445-518, 528-842``):
a deterministic signal autoencoder (451 → latent 9 → 451) trained on the
relative-MSE reconstruction loss, plus a params→latent MLP trained with
plain MSE against frozen-encoder latents, composed with the decoder for
prediction (Appendix A of Bye et al. 2022).

Design differences: encoder/decoder/emulator are three weight pytrees
with one pure apply each; both training stages run the jitted epoch loop;
prediction is a single fused device call; everything checkpoints with the
Normalizer bundled.
"""

from __future__ import annotations

import dataclasses
from typing import Optional, Tuple

import jax
import jax.numpy as jnp
import numpy as np

from tpu21cmvae.data.dataset import DataSplits
from tpu21cmvae.models.checkpoint import (
    load_checkpoint,
    save_checkpoint,
    unflatten_like,
)
from tpu21cmvae.models.direct import _resolve_axes, PAR_LABELS
from tpu21cmvae.models.io_keras import load_keras_mlp
from tpu21cmvae.ops.losses import mse, relative_mse
from tpu21cmvae.ops.mlp import init_mlp, mlp_apply, mlp_sizes
from tpu21cmvae.ops.transforms import (
    Normalizer,
    par_transform,
    preproc,
    resolve_normalizer,
    unpreproc,
)
from tpu21cmvae.train.loop import fit
from tpu21cmvae.utils.config import (
    AE_EMULATOR_TRAIN_DEFAULT,
    AE_TRAIN_DEFAULT,
    AutoEncoderConfig,
    TrainConfig,
)
from tpu21cmvae.utils.metrics import error


def _make_stage_runner(device_loop, verbose, checkpoint_dir,
                       checkpoint_every, resume):
    """One training-stage entry for the two-stage families: the host loop
    with per-stage checkpoint subdirectories, or the device-resident scan
    trainer (which has no host hooks)."""
    import os

    if device_loop:
        if checkpoint_dir is not None:
            raise ValueError(
                "device_loop=True runs without host hooks; drop "
                "checkpoint_dir or use the host loop."
            )
        from tpu21cmvae.train.scan import fit_scan

        def run_stage(stage, *args, **kw):
            return fit_scan(*args, **kw)

    else:

        def run_stage(stage, *args, **kw):
            return fit(
                *args,
                verbose=verbose,
                checkpoint_dir=(
                    os.path.join(checkpoint_dir, stage) if checkpoint_dir else None
                ),
                checkpoint_every=checkpoint_every,
                resume=resume,
                **kw,
            )

    return run_stage


class AutoEncoder:
    """Deterministic signal autoencoder: encoder ∘ decoder over
    standardized signals (reference ``emulator.py:445-518``)."""

    def __init__(
        self,
        config: AutoEncoderConfig = AutoEncoderConfig(),
        *,
        enc_params=None,
        dec_params=None,
        seed: int = 0,
    ):
        self.config = config
        k_enc, k_dec = jax.random.split(jax.random.key(seed))
        self.enc_params = enc_params if enc_params is not None else init_mlp(
            k_enc, config.encoder().sizes
        )
        self.dec_params = dec_params if dec_params is not None else init_mlp(
            k_dec, config.decoder().sizes
        )

    def encode(self, params, x):
        return mlp_apply(params["enc"], x, self.config.activation)

    def decode(self, params, z):
        return mlp_apply(params["dec"], z, self.config.activation)

    def apply(self, params, x):
        """Reconstruction = decode(encode(x)) (reference
        ``emulator.py:502-518``)."""
        return self.decode(params, self.encode(params, x))

    @property
    def params(self):
        return {"enc": self.enc_params, "dec": self.dec_params}

    @params.setter
    def params(self, value):
        self.enc_params = value["enc"]
        self.dec_params = value["dec"]


class AutoEncoderEmulator:
    """Two-stage autoencoder-based emulator (reference
    ``emulator.py:528-842``)."""

    par_labels = PAR_LABELS

    def __init__(
        self,
        data: Optional[DataSplits] = None,
        *,
        config: AutoEncoderConfig = AutoEncoderConfig(),
        normalizer: Optional[Normalizer] = None,
        enc_params=None,
        dec_params=None,
        em_params=None,
        redshifts=None,
        frequencies=None,
        seed: int = 0,
    ):
        normalizer = resolve_normalizer(data, normalizer)
        self.data = data
        self.config = config
        self.normalizer = normalizer
        self.redshifts, self.frequencies = _resolve_axes(redshifts, frequencies)
        self.autoencoder = AutoEncoder(
            config, enc_params=enc_params, dec_params=dec_params, seed=seed
        )
        self.em_params = em_params if em_params is not None else init_mlp(
            jax.random.key(seed + 1), config.emulator().sizes
        )
        self.history = None
        self._build_jits()

    # -- construction ------------------------------------------------------

    @classmethod
    def from_keras_h5(
        cls,
        emulator_path: str,
        encoder_path: str,
        decoder_path: str,
        data: Optional[DataSplits] = None,
        normalizer: Optional[Normalizer] = None,
        **kwargs,
    ) -> "AutoEncoderEmulator":
        """Import the reference's three pretrained h5 files
        (reference ``emulator.py:667-699``)."""
        em = load_keras_mlp(emulator_path)
        enc = load_keras_mlp(encoder_path)
        dec = load_keras_mlp(decoder_path)
        enc_sizes, dec_sizes, em_sizes = mlp_sizes(enc), mlp_sizes(dec), mlp_sizes(em)
        cfg = AutoEncoderConfig(
            n_params=em_sizes[0],
            n_bins=enc_sizes[0],
            latent_dim=enc_sizes[-1],
            enc_hidden_dims=tuple(enc_sizes[1:-1]),
            dec_hidden_dims=tuple(dec_sizes[1:-1]),
            em_hidden_dims=tuple(em_sizes[1:-1]),
        )
        return cls(
            data,
            config=cfg,
            normalizer=normalizer,
            enc_params=enc,
            dec_params=dec,
            em_params=em,
            **kwargs,
        )

    def save(self, path: str) -> str:
        meta = {
            "kind": "AutoEncoderEmulator",
            "n_params": self.config.n_params,
            "n_bins": self.config.n_bins,
            "latent_dim": self.config.latent_dim,
            "enc_hidden_dims": list(self.config.enc_hidden_dims),
            "dec_hidden_dims": list(self.config.dec_hidden_dims),
            "em_hidden_dims": list(self.config.em_hidden_dims),
            "activation": self.config.activation,
            "redshifts": [float(z) for z in self.redshifts],
        }
        tree = {
            "enc": self.autoencoder.enc_params,
            "dec": self.autoencoder.dec_params,
            "em": self.em_params,
            "normalizer": self.normalizer,
        }
        return save_checkpoint(path, tree, meta)

    @classmethod
    def from_checkpoint(cls, path: str, data: Optional[DataSplits] = None):
        leaves, meta = load_checkpoint(path)
        cfg = AutoEncoderConfig(
            n_params=meta["n_params"],
            n_bins=meta["n_bins"],
            latent_dim=meta["latent_dim"],
            enc_hidden_dims=tuple(meta["enc_hidden_dims"]),
            dec_hidden_dims=tuple(meta["dec_hidden_dims"]),
            em_hidden_dims=tuple(meta["em_hidden_dims"]),
            activation=meta.get("activation", "relu"),
        )
        template = {
            "enc": init_mlp(jax.random.key(0), cfg.encoder().sizes),
            "dec": init_mlp(jax.random.key(0), cfg.decoder().sizes),
            "em": init_mlp(jax.random.key(0), cfg.emulator().sizes),
            "normalizer": Normalizer.template(cfg.n_bins, cfg.n_params),
        }
        tree = unflatten_like(template, leaves, source=path)
        tree = jax.tree_util.tree_map(jnp.asarray, tree)
        return cls(
            data,
            config=cfg,
            normalizer=tree["normalizer"],
            enc_params=tree["enc"],
            dec_params=tree["dec"],
            em_params=tree["em"],
            redshifts=np.asarray(meta["redshifts"]) if "redshifts" in meta else None,
        )

    # -- inference ---------------------------------------------------------

    def _build_jits(self):
        norm = self.normalizer
        act = self.config.activation

        @jax.jit
        def predict(em_params, dec_params, raw_params):
            x = par_transform(raw_params, norm)
            z = mlp_apply(em_params, x, act)
            y = mlp_apply(dec_params, z, act)
            return unpreproc(y, norm)

        @jax.jit
        def reconstruct(enc_params, dec_params, signals):
            y = preproc(signals, norm)
            z = mlp_apply(enc_params, y, act)
            rec = mlp_apply(dec_params, z, act)
            return unpreproc(rec, norm)

        self._predict_jit = predict
        self._reconstruct_jit = reconstruct

    def predict_fn(self):
        """Pure jitted ``(weights, raw_params) → signals`` with weights
        packed as ``{"em": ..., "dec": ...}`` — the same contract
        :class:`~tpu21cmvae.parallel.inference.ShardedEmulator` consumes
        for mesh-sharded mega-batch inference."""
        inner = self._predict_jit

        @jax.jit
        def predict(weights, raw_params):
            return inner(weights["em"], weights["dec"], raw_params)

        return predict

    def loglik_fn(self, obs, noise_var=1.0, *, memo: bool = True):
        """Jitted Gaussian log-likelihood ``(weights, raw_params) → (B,)``
        against an observed signal, over the em→decoder pipeline — the
        MCMC inner loop for this family (see
        :func:`tpu21cmvae.ops.loglik.make_loglik_from_predict`; the
        direct family additionally offers gram/Pallas specializations).
        Value-identical calls return the same cached program object
        (:mod:`tpu21cmvae.models._memo`).
        """
        from tpu21cmvae.models._memo import memo_program, noise_key
        from tpu21cmvae.ops.loglik import make_loglik_from_predict

        return memo_program(
            self,
            ("loglik", np.asarray(obs, np.float32),
             noise_key(noise_var)),
            lambda: jax.jit(make_loglik_from_predict(
                self.predict_fn(), obs, noise_var
            )),
            memo=memo,
        )

    def loglik_and_grad_fn(self, obs, noise_var=1.0, *, memo: bool = True):
        """Jitted ``(weights, raw) → (logL, dlogL/draw)`` over the
        em→decoder pipeline (autodiff — the HMC inner loop for this
        family; the direct family has faster analytic/fused variants)."""
        from tpu21cmvae.models._memo import memo_program, noise_key
        from tpu21cmvae.ops.loglik import make_loglik_and_grad_from_predict

        return memo_program(
            self,
            ("valgrad", np.asarray(obs, np.float32),
             noise_key(noise_var)),
            lambda: jax.jit(make_loglik_and_grad_from_predict(
                self.predict_fn(), obs, noise_var
            )),
            memo=memo,
        )

    def loglik_multi_fn(self, obs_batch, noise_var=1.0, *,
                        memo: bool = True):
        """Jitted stacked-observation likelihood over the em→decoder
        pipeline — same contract as
        :meth:`DirectEmulator.loglik_multi_fn`."""
        from tpu21cmvae.models._memo import memo_program, noise_key
        from tpu21cmvae.ops.loglik import make_loglik_multi_from_predict

        return memo_program(
            self,
            ("multi", np.asarray(obs_batch, np.float32),
             noise_key(noise_var)),
            lambda: jax.jit(make_loglik_multi_from_predict(
                self.predict_fn(), obs_batch, noise_var
            )),
            memo=memo,
        )

    def marginalize_foreground(self, noise_var=1.0, *, n_terms: int = 5,
                               basis="linlog", prior_var=None,
                               nu_ref=None):
        """Foreground-marginalized noise model on this emulator's
        frequency axis — same contract as
        :meth:`DirectEmulator.marginalize_foreground`
        (:mod:`tpu21cmvae.foregrounds`)."""
        from tpu21cmvae.foregrounds import (
            foreground_basis,
            marginalize_foreground,
        )

        f = (foreground_basis(self.frequencies, n_terms, basis,
                              nu_ref=nu_ref)
             if isinstance(basis, str) else basis)
        return marginalize_foreground(
            f, noise_var, n_bins=int(self.frequencies.shape[0]),
            prior_var=prior_var,
        )

    def log_evidence_batch(self, obs_batch, noise_var=1.0, *,
                           bounds=None, method="auto",
                           khat_threshold=0.7, flow_kwargs=None,
                           final=None, final_kwargs=None, **kwargs):
        """Batched Laplace+IS evidence with automatic khat-triggered
        flow escalation — same contract as
        :meth:`DirectEmulator.log_evidence_batch`."""
        from tpu21cmvae.sampling import (
            laplace_evidence_multi_auto,
            valgrad_from_loglik,
        )

        obs_batch = np.atleast_2d(np.asarray(obs_batch, np.float32))
        return laplace_evidence_multi_auto(
            self.loglik_multi_fn(obs_batch, noise_var), self.params,
            obs_batch.shape[0], bounds=bounds,
            method=method, khat_threshold=khat_threshold,
            flow_kwargs=flow_kwargs, final=final,
            final_kwargs=final_kwargs,
            row_loglik=lambda i: self.loglik_fn(obs_batch[i], noise_var),
            row_valgrad=lambda i: self.loglik_and_grad_fn(
                obs_batch[i], noise_var
            ),
            rows_loglik=lambda idx: self.loglik_multi_fn(
                obs_batch[np.asarray(idx)], noise_var
            ),
            rows_valgrad=lambda idx: valgrad_from_loglik(
                self.loglik_multi_fn(obs_batch[np.asarray(idx)],
                                     noise_var)
            ),
            **kwargs,
        )

    def sample_posterior(
        self, obs, noise_var=1.0, *, sampler: str = "hmc", bounds=None,
        **kwargs,
    ):
        """On-device posterior sampling over this family's likelihood —
        same contract as :meth:`DirectEmulator.sample_posterior`
        (see :mod:`tpu21cmvae.sampling`)."""
        from tpu21cmvae.sampling import (
            sample_chees,
            sample_ensemble,
            sample_hmc,
            sample_mh,
            sample_to_ess,
        )

        if sampler == "mh":
            if "target_ess" in kwargs:
                return sample_to_ess(
                    self.loglik_fn(obs, noise_var), self.params,
                    bounds=bounds, **kwargs,
                )
            return sample_mh(
                self.loglik_fn(obs, noise_var), self.params,
                bounds=bounds, **kwargs,
            )
        if sampler == "ensemble":
            return sample_ensemble(
                self.loglik_fn(obs, noise_var), self.params,
                bounds=bounds, **kwargs,
            )
        if sampler == "pt":
            from tpu21cmvae.sampling import sample_pt

            return sample_pt(
                self.loglik_fn(obs, noise_var), self.params,
                bounds=bounds, **kwargs,
            )
        if sampler == "smc":
            from tpu21cmvae.sampling import sample_smc

            return sample_smc(
                self.loglik_fn(obs, noise_var), self.params,
                bounds=bounds, **kwargs,
            )
        if sampler not in ("hmc", "chees", "nuts"):
            raise ValueError(
                f"sampler must be 'mh', 'ensemble', 'hmc', 'chees', "
                f"'nuts', 'pt' or 'smc'; got {sampler!r}"
            )
        from tpu21cmvae.sampling import sample_nuts

        fn = {"chees": sample_chees, "nuts": sample_nuts,
              "hmc": sample_hmc}[sampler]
        return fn(
            self.loglik_and_grad_fn(obs, noise_var), self.params,
            bounds=bounds, **kwargs,
        )

    def log_evidence(
        self, obs, noise_var=1.0, *, bounds=None, method="nested",
        warm_start=True, **kwargs
    ):
        """Bayesian evidence for this family — same contract as
        :meth:`DirectEmulator.log_evidence` (``method="nested"``
        default via :func:`tpu21cmvae.nested.nested_sampling`;
        ``"laplace"`` quick look via
        :func:`tpu21cmvae.sampling.laplace_evidence`; ``"smc"``
        adaptive tempered SMC via
        :func:`tpu21cmvae.sampling.sample_smc`; ``"ladder"`` with
        the fit-seeded warm start via
        :func:`tpu21cmvae.sampling.log_evidence`)."""
        if method == "nested":
            from tpu21cmvae.nested import nested_sampling

            return nested_sampling(
                self.loglik_fn(obs, noise_var), self.params,
                bounds=bounds, **kwargs,
            )
        if method == "smc":
            from tpu21cmvae.sampling import sample_smc

            return sample_smc(
                self.loglik_fn(obs, noise_var), self.params,
                bounds=bounds, **kwargs,
            )
        if method == "laplace":
            from tpu21cmvae.sampling import laplace_evidence

            return laplace_evidence(
                self.loglik_fn(obs, noise_var), self.params,
                bounds=bounds, **kwargs,
            )
        if method == "flow":
            from tpu21cmvae.flows import evidence_with_flow

            return evidence_with_flow(
                self.loglik_fn(obs, noise_var),
                self.loglik_and_grad_fn(obs, noise_var),
                self.params, bounds=bounds, **kwargs,
            )
        if method != "ladder":
            raise ValueError(
                f"method must be 'nested', 'smc', 'laplace', 'flow' "
                f"or 'ladder'; got {method!r}"
            )
        from tpu21cmvae.sampling import log_evidence

        if warm_start and "x0" not in kwargs:
            # 500 polish steps from >=1024 starts is the measured
            # reliability floor for finding the dominant mode (200-step
            # fits miss it seed-to-seed by >100 nats; see the sampling package)
            fit = self.fit_params(
                obs, noise_var, bounds=bounds,
                n_starts=max(1024, kwargs.get("n_walkers", 256)),
                n_steps=500, seed=kwargs.get("seed", 0) + 101,
                log_prior=kwargs.get("log_prior"),
            )
            kwargs.setdefault("n_walkers", 256)
            kwargs["x0"] = fit.top(kwargs["n_walkers"])[0]
        return log_evidence(
            self.loglik_fn(obs, noise_var), self.params,
            bounds=bounds, **kwargs,
        )


    def goodness_of_fit(self, obs, noise_var=25.0, draws=None,
                        **kwargs):
        """Posterior predictive model check: did the assumed
        signal+noise family actually generate ``obs``? ``draws``:
        posterior draws or a :class:`~tpu21cmvae.sampling.SampleResult`
        (e.g. from :meth:`sample_posterior`). See
        :func:`tpu21cmvae.calibration.goodness_of_fit`."""
        from tpu21cmvae.calibration import goodness_of_fit

        return goodness_of_fit(self, obs, noise_var, draws, **kwargs)


    def goodness_of_fit_batch(self, obs_batch, noise_var=25.0,
                              draws=None, **kwargs):
        """Survey-scale posterior predictive checks — one batched
        predict for ALL observations. ``draws``: a
        :class:`~tpu21cmvae.sampling.BatchSampleResult` from
        :meth:`sample_posterior_batch` or a ``(O, B, n_params)``
        array. See :func:`tpu21cmvae.calibration.goodness_of_fit_batch`."""
        from tpu21cmvae.calibration import goodness_of_fit_batch

        return goodness_of_fit_batch(
            self, obs_batch, noise_var, draws, **kwargs
        )

    def sample_posterior_batch(
        self, obs_batch, noise_var=1.0, *, sampler: str = "mh",
        n_walkers: int = 256, bounds=None, **kwargs,
    ):
        """Posteriors for ``O`` observed spectra as ONE device program
        over this family's em→decoder likelihood — same contract as
        :meth:`DirectEmulator.sample_posterior_batch` (``n_walkers`` is
        per observation; MH/HMC only). Built on the generic
        stacked-observation likelihood
        (:func:`tpu21cmvae.ops.loglik.make_loglik_multi_from_predict`).
        """
        import numpy as np

        from tpu21cmvae.ops.loglik import (
            make_loglik_multi_from_predict,
            per_row_grad,
        )
        from tpu21cmvae.sampling import run_batched_chain

        obs_batch = np.atleast_2d(np.asarray(obs_batch, np.float32))
        base = make_loglik_multi_from_predict(
            self.predict_fn(), obs_batch, noise_var
        )
        return run_batched_chain(
            sampler, self.params, obs_batch.shape[0], n_walkers,
            loglik_builder=lambda: jax.jit(base),
            valgrad_builder=lambda: jax.jit(per_row_grad(base)),
            bounds=bounds, **kwargs,
        )

    def posterior_predictive(self, samples, **kwargs):
        """Signal-space credible bands from posterior samples — same
        contract as :meth:`DirectEmulator.posterior_predictive`
        (:func:`tpu21cmvae.sampling.posterior_predictive`)."""
        from tpu21cmvae.sampling import posterior_predictive

        return posterior_predictive(self.predict, samples, **kwargs)

    def fit_params(self, obs, noise_var=1.0, *, bounds=None, **kwargs):
        """Maximum-likelihood parameter fit against this family's
        likelihood — same contract as :meth:`DirectEmulator.fit_params`
        (:func:`tpu21cmvae.sampling.fit_map`)."""
        from tpu21cmvae.sampling import fit_map

        return fit_map(
            self.loglik_and_grad_fn(obs, noise_var), self.params,
            bounds=bounds, **kwargs,
        )

    def fit_advi(self, obs, noise_var=1.0, *, bounds=None, **kwargs):
        """Fast approximate posterior by full-rank Gaussian ADVI —
        same contract as :meth:`DirectEmulator.fit_advi`
        (:func:`tpu21cmvae.vi.fit_advi`)."""
        from tpu21cmvae.vi import fit_advi

        return fit_advi(
            self.loglik_and_grad_fn(obs, noise_var), self.params,
            bounds=bounds, **kwargs,
        )

    def fit_flow(self, obs, noise_var=1.0, *, bounds=None, **kwargs):
        """Normalizing-flow posterior fit — same contract as
        :meth:`DirectEmulator.fit_flow`
        (:func:`tpu21cmvae.flows.fit_flow`)."""
        from tpu21cmvae.flows import fit_flow

        return fit_flow(
            self.loglik_and_grad_fn(obs, noise_var), self.params,
            bounds=bounds, **kwargs,
        )

    def profile_likelihood(
        self, obs, noise_var, index, grid, *, bounds=None, **kwargs
    ):
        """Profile likelihood of parameter ``index`` — same contract
        as :meth:`DirectEmulator.profile_likelihood`
        (:func:`tpu21cmvae.sampling.profile_likelihood`)."""
        from tpu21cmvae.sampling import profile_likelihood

        return profile_likelihood(
            self.loglik_and_grad_fn(obs, noise_var), self.params, index, grid,
            bounds=bounds, **kwargs,
        )

    @property
    def params(self):
        """Weights pytree for :meth:`predict_fn` (emulator + decoder)."""
        return {"em": self.em_params, "dec": self.autoencoder.dec_params}

    def predict(self, params) -> np.ndarray:
        """par_transform → emulator → decoder → unpreproc in one device
        call (reference ``emulator.py:770-795``); squeezes a single row."""
        raw = jnp.atleast_2d(jnp.asarray(params, jnp.float32))
        pred = np.asarray(
            self._predict_jit(self.em_params, self.autoencoder.dec_params, raw)
        )
        return pred[0] if pred.shape[0] == 1 else pred

    def reconstruct(self, signals) -> np.ndarray:
        """Pure autoencoder round trip on raw (mK) signals."""
        sig = jnp.atleast_2d(jnp.asarray(signals, jnp.float32))
        rec = np.asarray(
            self._reconstruct_jit(
                self.autoencoder.enc_params, self.autoencoder.dec_params, sig
            )
        )
        return rec[0] if rec.shape[0] == 1 else rec

    # -- training ----------------------------------------------------------

    def train(
        self,
        epochs: Optional[int] = None,
        ae_train_config: Optional[TrainConfig] = None,
        em_train_config: Optional[TrainConfig] = None,
        verbose: bool = False,
        checkpoint_dir: Optional[str] = None,
        checkpoint_every: int = 10,
        resume: bool = False,
        device_loop: bool = False,
    ) -> Tuple[list, list, list, list]:
        """Stage A: autoencoder on standardized signals (relative-MSE);
        Stage B: params→latent MLP on frozen-encoder latents (MSE) —
        reference ``emulator.py:701-768``. Returns
        ``(ae_loss, ae_val_loss, loss, val_loss)``.

        ``checkpoint_dir``/``resume``: preemption-safe training; each
        stage checkpoints into its own subdirectory (``stage_ae`` /
        ``stage_em``) so a restarted job resumes inside whichever stage
        it was preempted in (stage A resumes as a no-op once complete)."""
        if self.data is None:
            raise ValueError("No dataset attached; construct with `data=`.")
        ae_cfg = ae_train_config or AE_TRAIN_DEFAULT
        em_cfg = em_train_config or AE_EMULATOR_TRAIN_DEFAULT
        if epochs is not None:
            ae_cfg = dataclasses.replace(ae_cfg, epochs=epochs)
            em_cfg = dataclasses.replace(em_cfg, epochs=epochs)

        norm = self.normalizer
        act = self.config.activation
        scaled_mean = norm.scaled_mean
        y_train = preproc(jnp.asarray(self.data.signal_train, jnp.float32), norm)
        y_val = preproc(jnp.asarray(self.data.signal_val, jnp.float32), norm)

        ae = self.autoencoder

        def ae_loss_fn(params, x, y):
            return relative_mse(y, ae.apply(params, x), scaled_mean)

        run_stage = _make_stage_runner(
            device_loop, verbose, checkpoint_dir, checkpoint_every, resume
        )
        ae_params, _, ae_hist = run_stage(
            "stage_ae", ae.params, ae_loss_fn, y_train, y_train, y_val, y_val,
            ae_cfg,
        )
        ae.params = ae_params

        # Stage B: freeze the encoder, use its latents as labels
        # (reference emulator.py:753-754).
        encode = jax.jit(lambda s: mlp_apply(ae_params["enc"], s, act))
        z_train = encode(y_train)
        z_val = encode(y_val)
        x_train = par_transform(jnp.asarray(self.data.par_train, jnp.float32), norm)
        x_val = par_transform(jnp.asarray(self.data.par_val, jnp.float32), norm)

        def em_loss_fn(params, x, y):
            return mse(y, mlp_apply(params, x, act))

        self.em_params, _, em_hist = run_stage(
            "stage_em", self.em_params, em_loss_fn, x_train, z_train, x_val,
            z_val, em_cfg,
        )
        self.history = {"autoencoder": ae_hist, "emulator": em_hist}
        return ae_hist.loss, ae_hist.val_loss, em_hist.loss, em_hist.val_loss

    # -- evaluation --------------------------------------------------------

    def test_error(
        self,
        use_autoencoder: bool = False,
        relative: bool = True,
        flow=None,
        fhigh=None,
    ) -> np.ndarray:
        """Test-set error of the emulator pipeline, or of the pure
        autoencoder reconstruction when ``use_autoencoder=True``
        (reference ``emulator.py:797-842``)."""
        if self.data is None:
            raise ValueError("No dataset attached; construct with `data=`.")
        if use_autoencoder:
            pred = self.reconstruct(self.data.signal_test)
        else:
            pred = self.predict(self.data.par_test)
        return error(
            self.data.signal_test,
            pred,
            relative=relative,
            nu_arr=self.frequencies,
            flow=flow,
            fhigh=fhigh,
        )
