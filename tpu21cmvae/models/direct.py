"""The flagship direct emulator: 7 astrophysical parameters → δT(z).

Capability parity with the reference's ``DirectEmulator``
(reference ``emulator.py:207-442``) redesigned as pure JAX functions:

* the model is a weights pytree + a single pure prediction function
  ``unpreproc ∘ mlp ∘ par_transform`` with all normalization constants
  folded in — jitted once, vmapped over the batch, shardable over a
  device mesh (SURVEY.md §3.3);
* ``save`` is implemented (reference raises ``NotImplementedError``,
  ``emulator.py:441-442``) and checkpoints bundle the Normalizer so
  inference needs no training data;
* training is the jit-compiled epoch loop of
  :mod:`tpu21cmvae.train.loop` with the reference's exact recipe as the
  default preset.
"""

from __future__ import annotations

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
from tpu21cmvae.models.io_keras import load_keras_mlp
from tpu21cmvae.ops.losses import relative_mse
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
    DIRECT_TRAIN_DEFAULT,
    DirectEmulatorConfig,
    TrainConfig,
)
from tpu21cmvae.utils.frequency import (
    default_redshifts,
    freq2redshift,
    redshift2freq,
)
from tpu21cmvae.utils.metrics import error

PAR_LABELS = ["fstar", "Vc", "fx", "tau", "alpha", "nu_min", "Rmfp"]


def _resolve_axes(redshifts, frequencies):
    """Reference axis logic (``emulator.py:311-317``): derive whichever of
    (redshifts, frequencies) is missing from the other."""
    if redshifts is None and frequencies is None:
        redshifts = default_redshifts()
    if frequencies is None and redshifts is not None:
        frequencies = redshift2freq(redshifts)
    elif redshifts is None and frequencies is not None:
        redshifts = freq2redshift(frequencies)
    return np.asarray(redshifts), np.asarray(frequencies)


class DirectEmulator:
    """Params → signal dense MLP emulator (the "21cmVAE" headline model:
    7 → 288 → 352 → 288 → 224 → 451, ReLU hidden, linear out)."""

    par_labels = PAR_LABELS

    def __init__(
        self,
        data: Optional[DataSplits] = None,
        *,
        config: DirectEmulatorConfig = DirectEmulatorConfig(),
        normalizer: Optional[Normalizer] = None,
        params=None,
        redshifts=None,
        frequencies=None,
        seed: int = 0,
    ):
        normalizer = resolve_normalizer(data, normalizer)
        self.data = data
        self.config = config
        self.normalizer = normalizer
        self.redshifts, self.frequencies = _resolve_axes(redshifts, frequencies)
        if params is None:
            params = init_mlp(jax.random.key(seed), config.mlp().sizes)
        self.params = params
        self.history = None
        # advisory inference tier this checkpoint was trained FOR
        # (e.g. "default" after bf16-native fine-tuning); None = the
        # contract path. Carried through save/from_checkpoint and
        # resolved by ``predict_fn(precision="native")``.
        self.native_precision: Optional[str] = None
        self._predict_jit = self._build_predict()

    # -- construction ------------------------------------------------------

    @classmethod
    def from_keras_h5(
        cls,
        path: str,
        data: Optional[DataSplits] = None,
        normalizer: Optional[Normalizer] = None,
        **kwargs,
    ) -> "DirectEmulator":
        """Import the reference's pretrained ``models/emulator.h5``
        (reference ``emulator.py:319-337``). The normalization constants
        are NOT in the h5 — supply the dataset or a Normalizer."""
        params = load_keras_mlp(path)
        sizes = mlp_sizes(params)
        cfg = DirectEmulatorConfig(
            n_params=sizes[0], n_bins=sizes[-1], hidden_dims=tuple(sizes[1:-1])
        )
        return cls(data, config=cfg, normalizer=normalizer, params=params, **kwargs)

    @classmethod
    def from_checkpoint(cls, path: str, data: Optional[DataSplits] = None) -> "DirectEmulator":
        """Restore a model saved with :meth:`save` — weights AND
        normalization constants, no training data needed."""
        leaves, meta = load_checkpoint(path)
        cfg = DirectEmulatorConfig(
            n_params=meta["n_params"],
            n_bins=meta["n_bins"],
            hidden_dims=tuple(meta["hidden_dims"]),
            activation=meta.get("activation", "relu"),
        )
        template = {
            "params": init_mlp(jax.random.key(0), cfg.mlp().sizes),
            "normalizer": Normalizer.template(meta["n_bins"], meta["n_params"]),
        }
        tree = unflatten_like(template, leaves, source=path)
        tree = jax.tree_util.tree_map(jnp.asarray, tree)
        model = cls(
            data,
            config=cfg,
            normalizer=tree["normalizer"],
            params=tree["params"],
            redshifts=np.asarray(meta["redshifts"]) if "redshifts" in meta else None,
        )
        model.native_precision = meta.get("native_precision")
        return model

    def save(self, path: str) -> str:
        """Save weights + normalizer + architecture metadata atomically."""
        meta = {
            "kind": "DirectEmulator",
            "n_params": self.config.n_params,
            "n_bins": self.config.n_bins,
            "hidden_dims": list(self.config.hidden_dims),
            "activation": self.config.activation,
            "redshifts": [float(z) for z in self.redshifts],
        }
        if self.native_precision is not None:
            meta["native_precision"] = str(self.native_precision)
        return save_checkpoint(
            path, {"params": self.params, "normalizer": self.normalizer}, meta
        )

    # -- inference ---------------------------------------------------------

    def _build_predict(self, precision=jax.lax.Precision.HIGHEST):
        norm = self.normalizer
        activation = self.config.activation

        @jax.jit
        def predict(params, raw_params):
            x = par_transform(raw_params, norm)
            y = mlp_apply(params, x, activation, precision=precision)
            return unpreproc(y, norm)

        return predict

    def predict_fn(self, precision=None):
        """The raw jitted pure function ``(weights, raw_params) → signals``
        — the building block for sharded mega-batch inference
        (:mod:`tpu21cmvae.parallel`) and benchmarking.

        ``precision``: matmul tier. Default (None) is the HIGHEST-precision
        contract path (exact f32 on every backend).
        ``jax.lax.Precision.HIGH`` and ``DEFAULT`` are the fast tiers;
        what they compute is the backend's choice (on an NVIDIA GPU, TF32
        tensor-core dots), so ``bench.py`` gates each against the
        contract path on the converged checkpoint (≤ 1.5e-3 relative to
        amplitude) and ``chip_smoke.py`` prints the measured deviation
        per tier. A TIER-NATIVE checkpoint — one fine-tuned with a fast
        forward in its loss (:meth:`loss_fn`) so the golden accuracy
        numbers hold AT that tier — records ``native_precision``, and
        ``precision="native"`` resolves to it (contract path when unset).
        """
        if precision == "native":
            precision = self.native_precision
        if precision is None:
            return self._predict_jit
        return self._build_predict(precision)

    def loglik_fn(
        self,
        obs,
        noise_var=1.0,
        *,
        method: str = "gram",
        precision=None,
        memo: bool = True,
    ):
        """Jitted Gaussian log-likelihood ``(weights, raw_params) → (B,)``
        against an observed signal — the MCMC inner loop as one device
        call (see :mod:`tpu21cmvae.ops.loglik`).

        ``method="gram"`` (default) collapses the output layer into a
        quadratic form; ``method="direct"`` evaluates the full network.
        Measured rates per method and tier are in docs/PERF.md.

        **Accuracy of the default tier** (``Precision.HIGH``): its
        arithmetic is the backend's. ``bench_mcmc.py`` holds a tier to
        |ΔlogL| ≤ 0.25 + 1.5e-3·depth against the exact path on the
        converged checkpoint; on an H100 the default runs TF32 and
        FAILS that gate (docs/PERF.md), so pass ``precision="contract"``
        (alias of ``"highest"``: exact-f32 matmuls) wherever the
        log-density values matter — evidence, likelihood ratios,
        posteriors that must match the exact likelihood.
        """
        from tpu21cmvae.models._memo import memo_program, noise_key
        from tpu21cmvae.ops.loglik import make_loglik

        return memo_program(
            self,
            ("loglik", np.asarray(obs, np.float32),
             noise_key(noise_var), method, str(precision)),
            lambda: jax.jit(
                make_loglik(
                    self.config,
                    self.normalizer,
                    obs,
                    noise_var,
                    method=method,
                    precision=precision,
                )
            ),
            memo=memo,
        )

    def loglik_and_grad_fn(
        self,
        obs,
        noise_var=1.0,
        *,
        method: str = "gram",
        precision=None,
        grad_precision=None,
        memo: bool = True,
    ):
        """Jitted ``(weights, raw_params) → (logL, dlogL/draw)`` — the
        HMC/NUTS inner loop as one device call (see
        :func:`tpu21cmvae.ops.loglik.make_loglik_and_grad` for variants,
        tiers, and the measured selection in docs/PERF.md). The default
        is the hand-written analytic gram backward; gradient tier errors
        only cost sampler acceptance rate, never posterior correctness
        (the accept step uses the gated value). Value-identical calls
        return the SAME cached program object
        (:mod:`tpu21cmvae.models._memo`), so repeated sampling on one
        observation reuses the compiled chain programs too."""
        from tpu21cmvae.models._memo import memo_program, noise_key
        from tpu21cmvae.ops.loglik import make_loglik_and_grad

        return memo_program(
            self,
            ("valgrad", np.asarray(obs, np.float32),
             noise_key(noise_var), method,
             str(precision), str(grad_precision)),
            lambda: jax.jit(
                make_loglik_and_grad(
                    self.config,
                    self.normalizer,
                    obs,
                    noise_var,
                    method=method,
                    precision=precision,
                    grad_precision=grad_precision,
                )
            ),
            memo=memo,
        )

    def loglik_multi_fn(self, obs_batch, noise_var=1.0, *, method="gram",
                        precision=None, memo: bool = True):
        """Jitted stacked-observation likelihood ``(weights,
        (O·W, 7)) → (O·W,)`` — ``O`` observations scored in one device
        call, observation-major rows (see
        :func:`tpu21cmvae.ops.loglik.make_loglik_multi`; the gram
        structure is shared across observations). Powers
        :meth:`sample_posterior_batch` and SBC
        (:mod:`tpu21cmvae.calibration`)."""
        from tpu21cmvae.models._memo import memo_program, noise_key
        from tpu21cmvae.ops.loglik import make_loglik_multi

        return memo_program(
            self,
            ("multi", np.asarray(obs_batch, np.float32),
             noise_key(noise_var), method, str(precision)),
            lambda: jax.jit(make_loglik_multi(
                self.config, self.normalizer, obs_batch, noise_var,
                method=method, precision=precision,
            )),
            memo=memo,
        )

    def marginalize_foreground(self, noise_var=1.0, *, n_terms: int = 5,
                               basis="linlog", prior_var=None,
                               nu_ref=None):
        """Foreground-marginalized noise model on this emulator's
        frequency axis (:mod:`tpu21cmvae.foregrounds`) — pass the
        result anywhere ``noise_var`` is accepted (``loglik_fn``,
        ``sample_*``, ``log_evidence``, ``fit_*`` …) to infer the 21-cm
        parameters with a linear foreground ``F·a`` integrated out of
        the likelihood EXACTLY. Zero per-sample cost in the default
        gram form: the projection folds into the output layer
        (docs/PERF.md). ``basis``: ``"linlog"`` (Hills et al. 2018),
        ``"powerlaw"`` (EDGES-style linearized, Bowman et al. 2018),
        ``"polynomial"`` (Legendre), or an explicit ``(n_bins, k)``
        design matrix. ``prior_var``: per-coefficient Gaussian prior
        variances; None = improper flat (then the likelihood is exactly
        invariant to any ``F·a`` added to the observation). Use the
        returned object's ``coeff_posterior(obs − predict(θ))`` to
        reconstruct the best-fit foreground afterwards."""
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
        self,
        obs_batch,
        noise_var=1.0,
        *,
        sampler: str = "mh",
        n_walkers: int = 256,
        bounds=None,
        method: str = "gram",
        precision=None,
        **kwargs,
    ):
        """Posteriors for ``O`` observed spectra as ONE device program —
        survey-scale inference. Walkers for every observation stack
        observation-major into one ``(O · n_walkers)`` batch, so each
        chain step is a single mega-batch likelihood call (the shape
        that fills the device; per-observation sequential runs waste it
        at small walker counts). ``n_walkers`` is PER OBSERVATION.
        Returns a :class:`~tpu21cmvae.sampling.BatchSampleResult`.

        ``sampler``: ``"mh"`` (default), ``"hmc"`` or ``"nuts"`` — the
        stretch move is refused here because its cross-walker pairing
        would propose across observations (valid but mixing-hostile),
        and ChEES adapts one shared trajectory. Each observation's
        walker slab adapts its OWN proposal scale / leapfrog step
        (``adapt_blocks=n_obs``, overridable), so heterogeneous
        posterior widths — per-sim noise levels, different data —
        don't force one compromise step; NUTS additionally estimates a
        per-observation ensemble METRIC (a pooled one would measure
        the between-observation spread of the posterior locations).
        ``kwargs`` forward to the sampler (``mesh=`` shards the stacked
        walker axis; keep ``O · n_walkers`` divisible by the mesh).
        """
        from tpu21cmvae.sampling import run_batched_chain

        obs_batch = np.atleast_2d(np.asarray(obs_batch, np.float32))

        def valgrad_builder():
            from tpu21cmvae.ops.loglik import make_loglik_and_grad_multi

            return jax.jit(make_loglik_and_grad_multi(
                self.config, self.normalizer, obs_batch, noise_var,
                method=method, precision=precision,
            ))

        return run_batched_chain(
            sampler, self.params, obs_batch.shape[0], n_walkers,
            loglik_builder=lambda: self.loglik_multi_fn(
                obs_batch, noise_var, method=method, precision=precision
            ),
            valgrad_builder=valgrad_builder,
            bounds=bounds, **kwargs,
        )

    def sample_posterior(
        self,
        obs,
        noise_var=1.0,
        *,
        sampler: str = "hmc",
        bounds=None,
        **kwargs,
    ):
        """Sample the posterior over the 7 astrophysical parameters given
        an observed spectrum — the reference's intended end use
        (reference ``README.rst:9-11``), which it leaves to external
        samplers at ~25 likelihood evaluations/s. Here the entire chain
        runs on device (:mod:`tpu21cmvae.sampling`): ``sampler="mh"``
        uses the gram likelihood, ``sampler="ensemble"``
        the affine-invariant stretch move (emcee's algorithm, no tuning
        knobs), ``sampler="hmc"`` (default) the analytic value+gradient
        path, with dual-averaging step adaptation, and
        ``sampler="chees"`` the same gradient kernel with the
        trajectory length ALSO adapted
        (:func:`~tpu21cmvae.sampling.sample_chees` — the
        accelerator-native NUTS replacement; use it when
        ``n_leapfrog`` tuning is in doubt). ``bounds``: (7, 2)
        prior box (defaults to the 21cmGEM-shaped ranges); remaining
        kwargs forward to :func:`~tpu21cmvae.sampling.sample_mh` /
        :func:`~tpu21cmvae.sampling.sample_ensemble` /
        :func:`~tpu21cmvae.sampling.sample_hmc`. Returns a
        :class:`~tpu21cmvae.sampling.SampleResult`.

        ``sampler="mh"`` with ``target_ess=N`` switches to
        :func:`~tpu21cmvae.sampling.sample_to_ess` — chunked chains
        that stop once the minimum per-parameter effective sample size
        reaches ``N`` ("give me N effective samples" instead of
        guessing ``n_steps``); the per-closure chain-program cache
        makes each continuation chunk one device call, no recompiles.

        On strongly multimodal posteriors the three single-temperature
        samplers can go metastable (stuck in one mode — check ``rhat``
        across independent seeds). Two robust options:
        ``sampler="pt"`` runs a parallel-tempering ladder
        (:func:`~tpu21cmvae.sampling.sample_pt` — replica exchange
        transports modes to the cold chain, recovering correct mode
        WEIGHTS), ``sampler="smc"`` anneals a particle population from
        the prior (:func:`~tpu21cmvae.sampling.sample_smc` —
        mode weights preserved by construction, the evidence comes out
        free in ``result.logz``), and :meth:`log_evidence`'s
        nested-sampling default explores modes in volume proportion
        (``result.posterior(n)`` for equal-weight draws).
        """
        from tpu21cmvae.sampling import (
            sample_ensemble,
            sample_hmc,
            sample_mh,
            sample_to_ess,
        )

        if sampler == "mh":
            if "target_ess" in kwargs:
                # "give me N effective samples": chunked MH with the
                # cached chain program — each chunk is one device call
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
        valgrad = self.loglik_and_grad_fn(
            obs, noise_var, grad_precision="default"
        )
        if sampler == "chees":
            from tpu21cmvae.sampling import sample_chees

            return sample_chees(
                valgrad, self.params, bounds=bounds, **kwargs
            )
        if sampler == "nuts":
            from tpu21cmvae.sampling import sample_nuts

            return sample_nuts(
                valgrad, self.params, bounds=bounds, **kwargs
            )
        return sample_hmc(valgrad, self.params, bounds=bounds, **kwargs)

    def log_evidence(
        self, obs, noise_var=1.0, *, bounds=None, method="nested",
        warm_start=True, **kwargs
    ):
        """Bayesian evidence ``log Z`` for this model given an observed
        spectrum — the model-comparison workflow 21-cm analyses run
        nested samplers (MultiNest/PolyChord) for, as one on-device
        program. Compare families by their ``logz`` under the same
        ``obs``/``bounds``.

        ``method="nested"`` (default) runs batched nested sampling
        (:func:`tpu21cmvae.nested.nested_sampling` — returns a
        :class:`~tpu21cmvae.nested.NestedResult` whose weighted dead
        points double as posterior samples). This is the robust path:
        measured seed-to-seed spread ~1 nat on real trained-emulator
        posteriors where the ladder method scatters by ~100
        (docs/PERF.md).

        ``method="ladder"`` runs parallel-tempering stepping-stone
        integration (:func:`tpu21cmvae.sampling.log_evidence`; returns
        an :class:`~tpu21cmvae.sampling.EvidenceResult`) — since the
        stretch-move kernel rewrite it converges on real emulator
        posteriors too (measured 0.2-nat seed spread; bias resolvable
        by raising ``n_rungs``/``n_steps`` and flagged by ``logz_err``
        / ``ladder_drift`` — ALWAYS check both). ``warm_start``
        (default True, ladder only) seeds every rung from a
        1024-start :meth:`fit_params`.

        ``method="smc"`` runs adaptive tempered Sequential Monte Carlo
        (:func:`tpu21cmvae.sampling.sample_smc`; returns an
        :class:`~tpu21cmvae.sampling.SMCResult` whose ``final`` doubles
        as posterior draws) — the self-scheduling anneal: no
        rung/β tuning, a replication-based ``logz_err``, and mode
        weights preserved by construction; measured within ~1 nat of
        nested on real emulator posteriors (docs/PERF.md).

        ``method="laplace"`` is the deterministic quick look
        (:func:`tpu21cmvae.sampling.laplace_evidence` — one multi-start
        MAP fit + one 7×7 Hessian, milliseconds): exact in the
        Gaussian-posterior limit, runs on the EXACT likelihood tier
        (a fast-tier near-mode value error of ~0.4 nats would bias
        ``logz`` directly), blind to multimodality — cross-check
        against ``"nested"`` when modes are suspected.

        ``method="flow"`` fits a normalizing flow to the posterior and
        importance-samples through it
        (:func:`tpu21cmvae.flows.evidence_with_flow`; returns a
        :class:`~tpu21cmvae.flows.FlowEvidenceResult`) — the estimator
        for CURVED/skewed unimodal posteriors, where the Laplace
        stage's ellipsoidal proposals measurably saturate at
        ``khat ≥ 0.7`` (docs/PERF.md). Pass ``flow=`` to reuse a
        :meth:`fit_flow` result; check ``khat < 0.7`` before trusting
        it, exactly as with ``"laplace"``."""
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
                self.loglik_fn(obs, noise_var, precision="contract"),
                self.params, bounds=bounds, **kwargs,
            )
        if method == "flow":
            from tpu21cmvae.flows import evidence_with_flow

            # same valgrad as fit_flow: the fit's gradient tier only
            # shapes the PROPOSAL (the IS weights use the contract-tier
            # value fn), so the fast backward tier is safe here
            return evidence_with_flow(
                self.loglik_fn(obs, noise_var, precision="contract"),
                self.loglik_and_grad_fn(
                    obs, noise_var, grad_precision="default",
                ),
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

    def log_evidence_batch(self, obs_batch, noise_var=1.0, *,
                           bounds=None, method="auto",
                           khat_threshold=0.7, flow_kwargs=None,
                           final=None, final_kwargs=None, **kwargs):
        """Survey-scale model comparison: adaptive Laplace+IS ``log Z``
        for a BATCH of observed spectra, every stage batched over
        observations (:func:`tpu21cmvae.sampling.laplace_evidence_multi`
        over the stacked gram likelihood at the exact tier — the gram
        trunk is shared across observations), with the khat
        escalation loop CLOSED: under the default ``method="auto"``,
        any row whose PSIS ``khat`` is not below ``khat_threshold``
        (0.7 — the Vehtari trust bound) is automatically re-estimated
        through a per-row normalizing-flow proposal, the estimator
        built for the curved posteriors where the Laplace stage's
        Student-t saturates (on the real 64-observation batch, 48 % of
        rows; docs/PERF.md). ``method="laplace"`` skips escalation,
        ``method="flow"`` escalates every row; ``flow_kwargs`` forward
        to the flow fit/IS sweep. ``final="nested"``/``"smc"`` settles
        rows that STILL fail after the flow attempt with a per-row
        definitive estimator (no importance weights — khat pathology
        does not apply; ~10 s/row, which is why it is the last stage,
        not the first): every row then ends trustworthy or definitively
        estimated. Returns a list of
        :class:`~tpu21cmvae.sampling.LaplaceResult`, one per row, each
        reporting ``method_used`` (and, when escalated, the full
        :class:`~tpu21cmvae.flows.FlowEvidenceResult` in
        ``escalation``)."""
        from tpu21cmvae.sampling import laplace_evidence_multi_auto

        obs_batch = np.atleast_2d(np.asarray(obs_batch, np.float32))
        # same valgrad as fit_flow: the fit's gradient tier only shapes
        # the flow PROPOSAL (IS weights use the contract-tier value fn)
        return laplace_evidence_multi_auto(
            self.loglik_multi_fn(obs_batch, noise_var,
                                 precision="contract"),
            self.params, obs_batch.shape[0], bounds=bounds,
            method=method, khat_threshold=khat_threshold,
            flow_kwargs=flow_kwargs, final=final,
            final_kwargs=final_kwargs,
            row_loglik=lambda i: self.loglik_fn(
                obs_batch[i], noise_var, precision="contract"
            ),
            row_valgrad=lambda i: self.loglik_and_grad_fn(
                obs_batch[i], noise_var, grad_precision="default",
            ),
            rows_loglik=lambda idx: self.loglik_multi_fn(
                obs_batch[np.asarray(idx)], noise_var,
                precision="contract",
            ),
            rows_valgrad=self._rows_valgrad(obs_batch, noise_var),
            **kwargs,
        )

    def _rows_valgrad(self, obs_batch, noise_var):
        """Stacked value+gradient builder over an observation subset —
        the batched flow escalation's fit path (the IS sweep still
        scores through the contract-tier value function)."""
        def build(idx):
            from tpu21cmvae.ops.loglik import make_loglik_and_grad_multi

            return jax.jit(make_loglik_and_grad_multi(
                self.config, self.normalizer,
                obs_batch[np.asarray(idx)], noise_var,
            ))

        return build

    def fit_params(self, obs, noise_var=1.0, *, bounds=None, **kwargs):
        """Maximum-likelihood fit of the 7 parameters to an observed
        spectrum: on-device multi-start Adam ascent over the fused
        value+gradient path (:func:`tpu21cmvae.sampling.fit_map` — the
        workflow reference users hand to scipy.optimize around 40 ms
        ``predict`` calls). ``bounds``: (7, 2) search box (defaults to
        the 21cmGEM-shaped ranges); kwargs forward to ``fit_map``.
        Returns a :class:`~tpu21cmvae.sampling.FitResult`; seed a
        sampler with ``sample_posterior(..., x0=result.params)`` for a
        warm-started posterior run.
        """
        from tpu21cmvae.sampling import fit_map

        valgrad = self.loglik_and_grad_fn(
            obs, noise_var, grad_precision="default"
        )
        return fit_map(valgrad, self.params, bounds=bounds, **kwargs)

    def profile_likelihood(
        self, obs, noise_var, index, grid, *, bounds=None, **kwargs
    ):
        """Profile likelihood of parameter ``index`` over ``grid`` —
        Wilks confidence intervals from batched constrained refits, the
        whole grid as ONE device program
        (:func:`tpu21cmvae.sampling.profile_likelihood`). Returns a
        :class:`~tpu21cmvae.sampling.ProfileResult`;
        ``result.interval(0.68)`` / ``.interval(0.95)``."""
        from tpu21cmvae.sampling import profile_likelihood

        valgrad = self.loglik_and_grad_fn(
            obs, noise_var, grad_precision="default"
        )
        return profile_likelihood(
            valgrad, self.params, index, grid, bounds=bounds, **kwargs
        )

    def fit_advi(self, obs, noise_var=1.0, *, bounds=None, **kwargs):
        """Fast approximate posterior by full-rank Gaussian ADVI over
        the fused value+gradient path
        (:func:`tpu21cmvae.vi.fit_advi`) — quick-look error bars and
        sampler warm starts in a fraction of a chain's wall time.
        Returns an :class:`~tpu21cmvae.vi.ADVIResult` (``.sample(n)``
        for iid draws, ``.mean()``/``.std()``); prefer the chain
        samplers when the posterior may be non-Gaussian — or
        :meth:`fit_flow`, which stays variational but drops the
        Gaussian shape restriction."""
        from tpu21cmvae.vi import fit_advi

        valgrad = self.loglik_and_grad_fn(
            obs, noise_var, grad_precision="default"
        )
        return fit_advi(valgrad, self.params, bounds=bounds, **kwargs)

    def fit_flow(self, obs, noise_var=1.0, *, bounds=None, **kwargs):
        """Normalizing-flow posterior fit
        (:func:`tpu21cmvae.flows.fit_flow`): :meth:`fit_advi`'s
        drop-in upgrade for non-Gaussian (curved, skewed) posteriors —
        a RealNVP coupling stack trained by reparameterized ELBO
        ascent over the same fused value+gradient path, still ONE
        ``lax.scan`` device program. Returns a
        :class:`~tpu21cmvae.flows.FlowResult` (``.sample(n)`` for iid
        draws, exact ``.log_q``). Feed it to
        ``log_evidence(method="flow", flow=...)`` for the
        curved-posterior evidence estimator whose ``khat`` the
        adaptive-t Laplace stage cannot reach (docs/PERF.md)."""
        from tpu21cmvae.flows import fit_flow

        valgrad = self.loglik_and_grad_fn(
            obs, noise_var, grad_precision="default"
        )
        return fit_flow(valgrad, self.params, bounds=bounds, **kwargs)

    def posterior_predictive(self, samples, **kwargs):
        """Signal-space credible bands implied by posterior parameter
        samples (``SampleResult.flat`` / ``NestedResult.posterior(n)``)
        — the reconstructed-signal plot 21-cm analyses publish. See
        :func:`tpu21cmvae.sampling.posterior_predictive` for the
        ``quantiles`` / ``noise_var`` options; returns a
        :class:`~tpu21cmvae.sampling.PredictiveBand`."""
        from tpu21cmvae.sampling import posterior_predictive

        return posterior_predictive(self.predict, samples, **kwargs)

    def fisher_fn(self, noise_var=1.0):
        """Jitted batched Fisher-matrix function ``(weights, thetas) →
        (n, 7, 7)`` (see :mod:`tpu21cmvae.ops.fisher`). Hold the result
        when scanning many fiducials — like :meth:`predict_fn` /
        :meth:`loglik_fn`, each build compiles its own program."""
        from tpu21cmvae.ops.fisher import make_fisher

        fisher = make_fisher(self.config, self.normalizer, noise_var)
        return jax.jit(jax.vmap(fisher, in_axes=(None, 0)))

    def fisher_forecast(self, theta, noise_var=1.0):
        """Fisher matrix and 1-σ marginalized forecast errors at raw
        fiducial parameter vector(s) (see :mod:`tpu21cmvae.ops.fisher`;
        Cramér–Rao bound for a Gaussian-noise global-signal experiment).

        Returns ``(F, sigma)``: shapes ``(7, 7), (7,)`` for a single
        fiducial or ``(n, 7, 7), (n, 7)`` for a batch. The compiled
        program is cached per noise spec (bounded LRU, 8 entries — same
        policy as the serve layer's likelihood cache), so calling this
        in a loop over fiducials does not retrace.
        """
        import collections

        from tpu21cmvae.models._memo import noise_key
        from tpu21cmvae.ops.fisher import forecast_errors

        nk = noise_key(noise_var)
        key = (
            (nk.shape, nk.tobytes()) if isinstance(nk, np.ndarray)
            else nk
        )
        if not hasattr(self, "_fisher_cache"):
            self._fisher_cache = collections.OrderedDict()
        fn = self._fisher_cache.get(key)
        if fn is None:
            fn = self._fisher_cache[key] = self.fisher_fn(noise_var)
            if len(self._fisher_cache) > 8:
                self._fisher_cache.popitem(last=False)
        else:
            self._fisher_cache.move_to_end(key)
        th = jnp.atleast_2d(jnp.asarray(theta, jnp.float32))
        F = fn(self.params, th)
        sig = forecast_errors(F)
        single = np.ndim(theta) == 1
        return (
            (np.asarray(F[0]), np.asarray(sig[0]))
            if single
            else (np.asarray(F), np.asarray(sig))
        )

    def predict(self, params) -> np.ndarray:
        """Emulate global signal(s) from raw astrophysical parameters.

        Accepts a single 7-vector or an (n, 7) batch; a single row is
        squeezed to shape (451,) (reference ``emulator.py:383-407``).
        """
        raw = jnp.atleast_2d(jnp.asarray(params, jnp.float32))
        pred = np.asarray(self._predict_jit(self.params, raw))
        return pred[0] if pred.shape[0] == 1 else pred

    # -- training ----------------------------------------------------------

    def loss_fn(self, precision=None):
        """Per-sample relative-MSE loss over the forward pass, with the
        amplitude constant folded (SURVEY.md §3.2).

        ``precision``: matmul tier of the TRAINING forward (default
        HIGHEST — the contract path). Passing
        ``jax.lax.Precision.DEFAULT`` trains *through* the backend's
        fast-tier forward (quantization-aware fine-tuning): the weights
        converge to a point whose fast forward — not its f32 forward —
        minimizes the loss, which is what makes a tier-native
        checkpoint competitive at inference (see
        ``scripts/finetune_bf16.py`` and docs/PERF.md)."""
        norm = self.normalizer
        activation = self.config.activation
        scaled_mean = norm.scaled_mean
        if precision is None:
            precision = jax.lax.Precision.HIGHEST

        def loss(params, x, y):
            return relative_mse(
                y,
                mlp_apply(params, x, activation, precision=precision),
                scaled_mean,
            )

        return loss

    def train(
        self,
        epochs: Optional[int] = None,
        train_config: Optional[TrainConfig] = None,
        verbose: bool = False,
        checkpoint_dir: Optional[str] = None,
        checkpoint_every: int = 10,
        resume: bool = False,
        epoch_callback=None,
        device_loop: bool = False,
        loss_precision=None,
    ) -> Tuple[list, list]:
        """Train on the attached dataset with the reference recipe
        (Adam lr=0.01, batch 256, EarlyStopping + ReduceLROnPlateau —
        ``Training.ipynb`` cells 4-5). Returns ``(loss, val_loss)`` per
        epoch, mirroring the reference's return (``emulator.py:379-381``);
        the full record lands in ``self.history``.

        ``checkpoint_dir``/``resume`` enable preemption-safe training:
        full state (weights, Adam moments, LR position, early-stopping
        monitor, history) checkpoints atomically every
        ``checkpoint_every`` epochs and a restarted job picks up where it
        left off (see :func:`tpu21cmvae.train.loop.fit`).

        ``device_loop=True`` runs the whole training as ONE XLA program
        (:func:`tpu21cmvae.train.scan.fit_scan`): callbacks execute on
        device and there are zero per-epoch host syncs — bit-compatible
        histories, much faster when dispatch latency matters. Mutually
        exclusive with checkpointing/callbacks/verbose.

        ``loss_precision``: matmul tier of the training forward (see
        :meth:`loss_fn`) — ``jax.lax.Precision.DEFAULT`` fine-tunes a
        tier-native bf16 checkpoint."""
        if self.data is None:
            raise ValueError("No dataset attached; construct with `data=`.")
        cfg = train_config or DIRECT_TRAIN_DEFAULT
        if epochs is not None:
            import dataclasses

            cfg = dataclasses.replace(cfg, epochs=epochs)
        norm = self.normalizer
        x_train = par_transform(jnp.asarray(self.data.par_train, jnp.float32), norm)
        x_val = par_transform(jnp.asarray(self.data.par_val, jnp.float32), norm)
        y_train = preproc(jnp.asarray(self.data.signal_train, jnp.float32), norm)
        y_val = preproc(jnp.asarray(self.data.signal_val, jnp.float32), norm)
        if device_loop:
            if checkpoint_dir is not None or epoch_callback is not None:
                raise ValueError(
                    "device_loop=True runs without host hooks; drop "
                    "checkpoint_dir/epoch_callback or use the host loop."
                )
            from tpu21cmvae.train.scan import fit_scan

            self.params, _, self.history = fit_scan(
                self.params, self.loss_fn(precision=loss_precision),
                x_train, y_train, x_val, y_val, cfg
            )
            return self.history.loss, self.history.val_loss
        self.params, _, self.history = fit(
            self.params,
            self.loss_fn(precision=loss_precision),
            x_train,
            y_train,
            x_val,
            y_val,
            cfg,
            verbose=verbose,
            checkpoint_dir=checkpoint_dir,
            checkpoint_every=checkpoint_every,
            resume=resume,
            epoch_callback=epoch_callback,
        )
        return self.history.loss, self.history.val_loss

    # -- evaluation --------------------------------------------------------

    def test_error(
        self, relative: bool = True, flow=None, fhigh=None
    ) -> np.ndarray:
        """Per-signal test-set error (reference ``emulator.py:409-439``)."""
        if self.data is None:
            raise ValueError("No dataset attached; construct with `data=`.")
        return error(
            self.data.signal_test,
            self.predict(self.data.par_test),
            relative=relative,
            nu_arr=self.frequencies,
            flow=flow,
            fhigh=fhigh,
        )
