"""Deep-ensemble emulation: predictive uncertainty from seed replicas.

The reference emulator is a point estimator — it reports test-set error
statistics (reference ``emulator.py:409-439``) but gives a user no
per-prediction uncertainty. The standard fix for deterministic nets is
a deep ensemble: train N replicas from different seeds and read the
spread. Design: the members' weight pytrees are STACKED along
a leading axis and the pure predict function is ``vmap``-ed over it, so
an N-member ensemble prediction is one device call of N-fold batched
matmuls (N=5 of the flagship is still <2 M params) — not
N sequential model calls.
"""

from __future__ import annotations

from typing import List, Optional, Sequence, Tuple

import jax
import jax.numpy as jnp
import numpy as np

from tpu21cmvae.data.dataset import DataSplits
from tpu21cmvae.models.direct import DirectEmulator
from tpu21cmvae.utils.config import DirectEmulatorConfig, TrainConfig
from tpu21cmvae.utils.metrics import error


class DeepEnsemble:
    """N independently trained :class:`DirectEmulator` replicas behind
    one vmapped prediction function."""

    def __init__(self, members: Sequence[DirectEmulator]):
        if not members:
            raise ValueError("ensemble needs at least one member")
        cfg = members[0].config
        for m in members[1:]:
            if m.config != cfg:
                raise ValueError(
                    "ensemble members must share one architecture; got "
                    f"{m.config} vs {cfg}"
                )
        # the vmapped predict closes over member 0's Normalizer, so every
        # member MUST share the same normalization constants — silently
        # mixing weights trained against different statistics would make
        # predictions and the advertised uncertainty wrong
        n0 = members[0].normalizer
        for i, m in enumerate(members[1:], start=1):
            same = jax.tree_util.tree_all(
                jax.tree_util.tree_map(
                    lambda a, b: jnp.allclose(a, b), n0, m.normalizer
                )
            )
            if not same:
                raise ValueError(
                    f"member {i}'s normalization constants differ from "
                    "member 0's — ensemble members must be trained "
                    "against the same training-set statistics"
                )
        self.members: List[DirectEmulator] = list(members)
        self.config = cfg
        self.normalizer = n0
        self.frequencies = members[0].frequencies
        self.redshifts = members[0].redshifts
        self.par_labels = members[0].par_labels
        # stack the weight pytrees: each leaf gains a leading member axis
        self.stacked_params = jax.tree_util.tree_map(
            lambda *leaves: jnp.stack(leaves), *(m.params for m in members)
        )
        base = members[0].predict_fn()
        self._vpredict = jax.jit(jax.vmap(base, in_axes=(0, None)))

    @property
    def params(self):
        """The stacked member weights — the pytree every inference
        function below takes as its first argument, so the ensemble
        plugs into :class:`~tpu21cmvae.parallel.inference.ShardedEmulator`,
        :class:`~tpu21cmvae.serve.EmulatorService` and the samplers
        exactly like a single model."""
        return self.stacked_params

    # -- construction ------------------------------------------------------

    @classmethod
    def train(
        cls,
        data: DataSplits,
        n_members: int = 5,
        config: DirectEmulatorConfig = DirectEmulatorConfig(),
        train_config: Optional[TrainConfig] = None,
        seeds: Optional[Sequence[int]] = None,
        device_loop: bool = True,
        verbose: bool = False,
        parallel: bool = False,
        mesh=None,
    ) -> "DeepEnsemble":
        """Train ``n_members`` replicas from different init/shuffle seeds
        (same data, same recipe — the deep-ensembles construction).

        ``parallel=True`` trains ALL members as one vmapped whole-run
        XLA program (:func:`tpu21cmvae.train.scan.fit_scan_stack`): the
        member axis rides every training matmul as a batched dim, so M
        members cost ~one member's wall instead of M sequential runs —
        and ``mesh=`` shards the member axis over devices (each chip
        trains its members locally, zero collectives). Members share one
        dataset, so their normalizers — and hence the loss closure — are
        identical; only init/shuffle seeds differ. Parity with the
        sequential path is pinned by ``tests/test_ensemble.py``."""
        seeds = list(seeds) if seeds is not None else list(range(n_members))
        if parallel:
            if not device_loop:
                raise ValueError("parallel=True requires device_loop=True")
            from tpu21cmvae.ops.transforms import par_transform, preproc
            from tpu21cmvae.train.scan import fit_scan_stack
            from tpu21cmvae.utils.config import DIRECT_TRAIN_DEFAULT

            members = [DirectEmulator(data, config=config, seed=s)
                       for s in seeds]
            norm = members[0].normalizer
            x = par_transform(jnp.asarray(data.par_train, jnp.float32), norm)
            xv = par_transform(jnp.asarray(data.par_val, jnp.float32), norm)
            y = preproc(jnp.asarray(data.signal_train, jnp.float32), norm)
            yv = preproc(jnp.asarray(data.signal_val, jnp.float32), norm)
            stacked = jax.tree_util.tree_map(
                lambda *ls: jnp.stack(ls), *[m.params for m in members]
            )
            stacked, _, hists = fit_scan_stack(
                stacked, members[0].loss_fn(), x, y, xv, yv,
                train_config or DIRECT_TRAIN_DEFAULT, seeds=seeds, mesh=mesh,
            )
            for i, m in enumerate(members):
                m.params = jax.tree_util.tree_map(
                    lambda leaf, i=i: leaf[i], stacked
                )
                m.history = hists[i]
            return cls(members)
        import dataclasses

        from tpu21cmvae.utils.config import DIRECT_TRAIN_DEFAULT

        members = []
        for s in seeds:
            m = DirectEmulator(data, config=config, seed=s)
            # the member seed drives the shuffle stream too (not just
            # init) — matches fit_scan_stack's per-member key schedule
            m.train(
                train_config=dataclasses.replace(
                    train_config or DIRECT_TRAIN_DEFAULT, seed=s
                ),
                device_loop=device_loop, verbose=verbose,
            )
            members.append(m)
        return cls(members)

    @classmethod
    def from_checkpoints(
        cls, paths: Sequence[str], data: Optional[DataSplits] = None
    ) -> "DeepEnsemble":
        return cls([DirectEmulator.from_checkpoint(p, data) for p in paths])

    def save(self, directory: str) -> List[str]:
        """One checkpoint per member: ``member_00.npz`` … (atomic)."""
        import os

        os.makedirs(directory, exist_ok=True)
        return [
            m.save(os.path.join(directory, f"member_{i:02d}.npz"))
            for i, m in enumerate(self.members)
        ]

    @classmethod
    def load(cls, directory: str, data: Optional[DataSplits] = None):
        import glob
        import os

        paths = sorted(glob.glob(os.path.join(directory, "member_*.npz")))
        if not paths:
            raise FileNotFoundError(f"no member_*.npz under {directory}")
        return cls.from_checkpoints(paths, data)

    # -- inference ---------------------------------------------------------

    def predict_fn(self, precision=None):
        """Jitted pure ``(stacked_weights, raw_params) → (B, n_bins)``
        ensemble-MEAN prediction — the hold-this-function twin of
        :meth:`predict`, shaped like ``DirectEmulator.predict_fn`` so
        mesh-sharded serving (``ShardedEmulator.for_model``) works on an
        ensemble unchanged. The member axis rides a ``vmap`` → one
        device call of member-batched matmuls, not N sequential calls."""
        base = self.members[0].predict_fn(precision=precision)
        vp = jax.vmap(base, in_axes=(0, None))

        def mean_predict(stacked, raw):
            return jnp.mean(vp(stacked, raw), axis=0)

        return jax.jit(mean_predict)

    def loglik_fn(
        self,
        obs,
        noise_var=1.0,
        *,
        method: str = "gram",
        precision=None,
        memo: bool = True,
    ):
        """Jitted MIXTURE log-likelihood ``(stacked_weights, raw) → (B,)``.

        Each member defines its own Gaussian likelihood
        ``p(obs | θ, member m)``; with a uniform prior over members the
        emulation (model) uncertainty marginalizes out as an equal-weight
        mixture::

            log p(obs | θ) = logsumexp_m log p(obs | θ, m) − log M

        — the inference-time counterpart of
        :meth:`predict_with_uncertainty`: where members disagree, the
        mixture is flatter than any single member's likelihood, so the
        posterior honestly widens by the emulation error instead of
        centering overconfidently on one replica's quirks. (The
        reference is a point estimator with no uncertainty channel at
        all — reference ``emulator.py:409-439`` only reports test-set
        statistics.)

        Implementation: the member axis rides a ``vmap`` over the
        single-model likelihood
        (:func:`tpu21cmvae.ops.loglik.make_loglik`), so an M-member
        mixture over a B-row batch is ONE device call of member-batched
        matmuls. Tier contract per member is as documented on
        :meth:`DirectEmulator.loglik_fn` (the default tier fails
        bench_mcmc.py's ΔlogL gate on an H100; ``precision="contract"`` for absolute
        log-density uses — the logsumexp is dominated by the best
        member, so member-level bounds carry through to the mixture).
        """
        from tpu21cmvae.models._memo import memo_program, noise_key
        from tpu21cmvae.ops.loglik import make_loglik

        def build():
            member = make_loglik(
                self.config, self.normalizer, obs, noise_var,
                method=method, precision=precision,
            )
            vll = jax.vmap(member, in_axes=(0, None))
            log_m = float(np.log(len(self.members)))

            def mixture(stacked, raw):
                return jax.scipy.special.logsumexp(
                    vll(stacked, raw), axis=0
                ) - log_m

            return jax.jit(mixture)

        return memo_program(
            self,
            ("loglik", np.asarray(obs, np.float32),
             noise_key(noise_var), method, str(precision)),
            build,
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
        """Jitted ``(stacked_weights, raw) → (logL, dlogL/draw)`` for the
        mixture likelihood — the HMC/MAP inner loop. The mixture
        gradient is the member-posterior-weighted sum of member
        gradients (exact: ∇ logsumexp_m l_m = Σ_m softmax(l_m) ∇l_m), so
        the hand-written analytic gram backward selected by the grad
        bench (docs/PERF.md) is reused per member under one ``vmap``."""
        from tpu21cmvae.models._memo import memo_program, noise_key
        from tpu21cmvae.ops.loglik import make_loglik_and_grad

        def build():
            member = make_loglik_and_grad(
                self.config, self.normalizer, obs, noise_var,
                method=method, precision=precision,
                grad_precision=grad_precision,
            )
            vvg = jax.vmap(member, in_axes=(0, None))
            log_m = float(np.log(len(self.members)))

            def mixture_vg(stacked, raw):
                lm, gm = vvg(stacked, raw)      # (M, B), (M, B, P)
                val = jax.scipy.special.logsumexp(lm, axis=0) - log_m
                w = jax.nn.softmax(lm, axis=0)  # member posterior at θ
                return val, jnp.sum(w[..., None] * gm, axis=0)

            return jax.jit(mixture_vg)

        return memo_program(
            self,
            ("valgrad", np.asarray(obs, np.float32),
             noise_key(noise_var), method,
             str(precision), str(grad_precision)),
            build,
            memo=memo,
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
        """Uncertainty-aware posterior sampling: the chain targets the
        MIXTURE likelihood (:meth:`loglik_fn`), so the returned credible
        regions include the emulation error the member spread measures —
        samplers, kwargs and the metastability caveat exactly as on
        :meth:`DirectEmulator.sample_posterior`."""
        from tpu21cmvae.sampling import (
            sample_ensemble,
            sample_hmc,
            sample_mh,
            sample_to_ess,
        )

        if sampler == "mh":
            if "target_ess" in kwargs:
                return sample_to_ess(
                    self.loglik_fn(obs, noise_var), self.stacked_params,
                    bounds=bounds, **kwargs,
                )
            return sample_mh(
                self.loglik_fn(obs, noise_var), self.stacked_params,
                bounds=bounds, **kwargs,
            )
        if sampler == "ensemble":
            return sample_ensemble(
                self.loglik_fn(obs, noise_var), self.stacked_params,
                bounds=bounds, **kwargs,
            )
        if sampler == "pt":
            from tpu21cmvae.sampling import sample_pt

            return sample_pt(
                self.loglik_fn(obs, noise_var), self.stacked_params,
                bounds=bounds, **kwargs,
            )
        if sampler == "smc":
            from tpu21cmvae.sampling import sample_smc

            return sample_smc(
                self.loglik_fn(obs, noise_var), self.stacked_params,
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
        if sampler in ("chees", "nuts"):
            from tpu21cmvae.sampling import sample_chees, sample_nuts

            fn = sample_chees if sampler == "chees" else sample_nuts
            return fn(
                valgrad, self.stacked_params, bounds=bounds, **kwargs
            )
        return sample_hmc(valgrad, self.stacked_params, bounds=bounds, **kwargs)

    def fit_params(self, obs, noise_var=1.0, *, bounds=None, **kwargs):
        """Maximum-likelihood fit of the parameters under the mixture
        likelihood (multi-start Adam ascent,
        :func:`tpu21cmvae.sampling.fit_map`) — see
        :meth:`DirectEmulator.fit_params`."""
        from tpu21cmvae.sampling import fit_map

        valgrad = self.loglik_and_grad_fn(
            obs, noise_var, grad_precision="default"
        )
        return fit_map(valgrad, self.stacked_params, bounds=bounds, **kwargs)

    def log_evidence(
        self, obs, noise_var=1.0, *, bounds=None, method="nested",
        warm_start=True, **kwargs
    ):
        """Bayesian evidence under the mixture likelihood — semantics,
        method choice and caveats as on
        :meth:`DirectEmulator.log_evidence`. Because the mixture reads
        ABSOLUTE log-densities, the member likelihood is built at the
        default gate-passing tier whose near-mode |ΔlogL| ≈ 0.43 is ~an
        order below nested sampling's own ~1-nat spread; pass
        ``precision="contract"`` through ``kwargs`` is not supported
        here — build via :meth:`loglik_fn` + ``nested_sampling`` directly
        for a contract-tier run."""
        if method == "nested":
            from tpu21cmvae.nested import nested_sampling

            return nested_sampling(
                self.loglik_fn(obs, noise_var), self.stacked_params,
                bounds=bounds, **kwargs,
            )
        if method == "smc":
            from tpu21cmvae.sampling import sample_smc

            return sample_smc(
                self.loglik_fn(obs, noise_var), self.stacked_params,
                bounds=bounds, **kwargs,
            )
        if method == "laplace":
            from tpu21cmvae.sampling import laplace_evidence

            return laplace_evidence(
                self.loglik_fn(obs, noise_var, precision="contract"),
                self.stacked_params, bounds=bounds, **kwargs,
            )
        if method == "flow":
            from tpu21cmvae.flows import evidence_with_flow

            # same valgrad selection as fit_flow (the fit's gradient
            # tier only shapes the proposal; IS weights stay contract)
            return evidence_with_flow(
                self.loglik_fn(obs, noise_var, precision="contract"),
                self.loglik_and_grad_fn(
                    obs, noise_var, grad_precision="default"
                ),
                self.stacked_params, bounds=bounds, **kwargs,
            )
        if method != "ladder":
            raise ValueError(
                f"method must be 'nested', 'smc', 'laplace', 'flow' "
                f"or 'ladder'; got {method!r}"
            )
        from tpu21cmvae.sampling import log_evidence

        if warm_start and "x0" not in kwargs:
            fit = self.fit_params(
                obs, noise_var, bounds=bounds,
                n_starts=max(1024, kwargs.get("n_walkers", 256)),
                n_steps=500, seed=kwargs.get("seed", 0) + 101,
                log_prior=kwargs.get("log_prior"),
            )
            kwargs.setdefault("n_walkers", 256)
            kwargs["x0"] = fit.top(kwargs["n_walkers"])[0]
        return log_evidence(
            self.loglik_fn(obs, noise_var), self.stacked_params,
            bounds=bounds, **kwargs,
        )

    def fit_advi(self, obs, noise_var=1.0, *, bounds=None, **kwargs):
        """Fast approximate posterior by full-rank Gaussian ADVI —
        same contract as :meth:`DirectEmulator.fit_advi`
        (:func:`tpu21cmvae.vi.fit_advi`)."""
        from tpu21cmvae.vi import fit_advi

        return fit_advi(
            self.loglik_and_grad_fn(obs, noise_var, grad_precision="default"),
            self.stacked_params, bounds=bounds, **kwargs,
        )

    def fit_flow(self, obs, noise_var=1.0, *, bounds=None, **kwargs):
        """Normalizing-flow posterior fit — same contract as
        :meth:`DirectEmulator.fit_flow`
        (:func:`tpu21cmvae.flows.fit_flow`)."""
        from tpu21cmvae.flows import fit_flow

        return fit_flow(
            self.loglik_and_grad_fn(obs, noise_var,
                                    grad_precision="default"),
            self.stacked_params, bounds=bounds, **kwargs,
        )

    def profile_likelihood(
        self, obs, noise_var, index, grid, *, bounds=None, **kwargs
    ):
        """Profile likelihood of parameter ``index`` — same contract
        as :meth:`DirectEmulator.profile_likelihood`
        (:func:`tpu21cmvae.sampling.profile_likelihood`)."""
        from tpu21cmvae.sampling import profile_likelihood

        return profile_likelihood(
            self.loglik_and_grad_fn(obs, noise_var, grad_precision="default"),
            self.stacked_params, index, grid,
            bounds=bounds, **kwargs,
        )

    def loglik_multi_fn(self, obs_batch, noise_var=1.0, *,
                        method: str = "gram", precision=None,
                        memo: bool = True):
        """Jitted stacked-observation MIXTURE likelihood — the member
        axis rides a vmap over the stacked-observation member
        likelihood; same row contract as
        :meth:`DirectEmulator.loglik_multi_fn`."""
        from tpu21cmvae.models._memo import memo_program, noise_key
        from tpu21cmvae.ops.loglik import make_loglik_multi

        def build():
            member = make_loglik_multi(
                self.config, self.normalizer, obs_batch, noise_var,
                method=method, precision=precision,
            )
            vll = jax.vmap(member, in_axes=(0, None))
            log_m = float(np.log(len(self.members)))

            def mixture(stacked, raw):
                return jax.scipy.special.logsumexp(
                    vll(stacked, raw), axis=0
                ) - log_m

            return jax.jit(mixture)

        return memo_program(
            self,
            ("multi", np.asarray(obs_batch, np.float32),
             noise_key(noise_var), method, str(precision)),
            build,
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
        """Batched Laplace+IS evidence under the member-mixture
        likelihood (exact tier — the mixture reads absolute
        log-densities), with automatic khat-triggered flow escalation —
        same contract as :meth:`DirectEmulator.log_evidence_batch`."""
        from tpu21cmvae.sampling import (
            laplace_evidence_multi_auto,
            valgrad_from_loglik,
        )

        obs_batch = np.atleast_2d(np.asarray(obs_batch, np.float32))
        return laplace_evidence_multi_auto(
            self.loglik_multi_fn(obs_batch, noise_var,
                                 precision="contract"),
            self.stacked_params, obs_batch.shape[0], bounds=bounds,
            method=method, khat_threshold=khat_threshold,
            flow_kwargs=flow_kwargs, final=final,
            final_kwargs=final_kwargs,
            row_loglik=lambda i: self.loglik_fn(
                obs_batch[i], noise_var, precision="contract"
            ),
            row_valgrad=lambda i: self.loglik_and_grad_fn(
                obs_batch[i], noise_var
            ),
            rows_loglik=lambda idx: self.loglik_multi_fn(
                obs_batch[np.asarray(idx)], noise_var,
                precision="contract",
            ),
            rows_valgrad=lambda idx: valgrad_from_loglik(
                self.loglik_multi_fn(obs_batch[np.asarray(idx)],
                                     noise_var, precision="contract")
            ),
            **kwargs,
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
        n_walkers: int = 256, bounds=None, method: str = "gram",
        precision=None, **kwargs,
    ):
        """Posteriors for ``O`` observed spectra under the member-
        MIXTURE likelihood as ONE device program — same contract as
        :meth:`DirectEmulator.sample_posterior_batch` (``n_walkers``
        per observation; MH/HMC only). The member axis rides a vmap
        over the stacked-observation likelihood, so each chain step is
        one (M·O·W)-row fused batch."""
        from tpu21cmvae.ops.loglik import (
            make_loglik_and_grad_multi,
            make_loglik_multi,
        )
        from tpu21cmvae.sampling import run_batched_chain

        obs_batch = np.atleast_2d(np.asarray(obs_batch, np.float32))
        log_m = float(np.log(len(self.members)))

        def loglik_builder():
            member = make_loglik_multi(
                self.config, self.normalizer, obs_batch, noise_var,
                method=method, precision=precision,
            )
            vll = jax.vmap(member, in_axes=(0, None))

            def mixture(stacked, raw):
                return jax.scipy.special.logsumexp(
                    vll(stacked, raw), axis=0
                ) - log_m

            return jax.jit(mixture)

        def valgrad_builder():
            member = make_loglik_and_grad_multi(
                self.config, self.normalizer, obs_batch, noise_var,
                method=method, precision=precision,
            )
            vvg = jax.vmap(member, in_axes=(0, None))

            def mixture_vg(stacked, raw):
                lm, gm = vvg(stacked, raw)
                val = jax.scipy.special.logsumexp(lm, axis=0) - log_m
                w = jax.nn.softmax(lm, axis=0)
                return val, jnp.sum(w[..., None] * gm, axis=0)

            return jax.jit(mixture_vg)

        return run_batched_chain(
            sampler, self.stacked_params, obs_batch.shape[0], n_walkers,
            loglik_builder=loglik_builder,
            valgrad_builder=valgrad_builder,
            bounds=bounds, **kwargs,
        )

    def member_predictions(self, params) -> np.ndarray:
        """(n_members, n, 451) raw member signals for a parameter batch."""
        raw = jnp.atleast_2d(jnp.asarray(params, jnp.float32))
        return np.asarray(self._vpredict(self.stacked_params, raw))

    def predict(self, params) -> np.ndarray:
        """Ensemble-mean signal(s); same squeeze convention as
        :meth:`DirectEmulator.predict`."""
        mean = self.member_predictions(params).mean(axis=0)
        return mean[0] if mean.shape[0] == 1 else mean

    def predict_with_uncertainty(
        self, params
    ) -> Tuple[np.ndarray, np.ndarray]:
        """(mean, std) over members, per frequency bin — an emulation
        error bar the reference cannot provide."""
        preds = self.member_predictions(params)
        mean, std = preds.mean(axis=0), preds.std(axis=0)
        if mean.shape[0] == 1:
            return mean[0], std[0]
        return mean, std

    def posterior_predictive(self, samples, **kwargs):
        """MIXTURE posterior predictive: every member's prediction for
        every posterior draw enters the pool, so the band carries the
        emulation uncertainty on top of the parameter uncertainty —
        consistent with the member-mixture likelihood the ensemble's
        samplers target. Same options as
        :meth:`DirectEmulator.posterior_predictive`."""
        from tpu21cmvae.sampling import posterior_predictive

        def pooled(raw):
            preds = self.member_predictions(raw)  # (M, n, 451)
            return preds.reshape(-1, preds.shape[-1])

        return posterior_predictive(pooled, samples, **kwargs)

    # -- evaluation --------------------------------------------------------

    def test_error(self, relative: bool = True, flow=None, fhigh=None):
        """Per-signal test error of the ensemble-mean prediction."""
        data = self.members[0].data
        if data is None:
            raise ValueError("No dataset attached; construct members with "
                             "`data=`.")
        return error(
            data.signal_test,
            self.predict(data.par_test),
            relative=relative,
            nu_arr=self.frequencies,
            flow=flow,
            fhigh=fhigh,
        )
