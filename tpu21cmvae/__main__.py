"""Command-line interface: ``python -m tpu21cmvae <command>``.

The reference has no CLI — every workflow lives in notebook cells
(SURVEY.md §1). These subcommands cover the full lifecycle headless:

    download   fetch the 21cmGEM dataset to the local cache
    train      train a model family (direct / ae / vae / ensemble) and
               save it
    evaluate   test-set error table for a saved model
    predict    emulate signals for parameter rows from a .npy/.csv file
    tune       architecture search
    export-h5  write a saved model's MLP weights as Keras-layout HDF5
    verify     accuracy-contract battery (golden numbers + structural
               checks) with a JSON report
    serve      saved model behind HTTP (JSON /predict + /loglik,
               bucketed batching, warm compiled programs)
    sample     on-device MH/ensemble/HMC posterior sampling for an
               observed spectrum; writes the chain as .npz
    fit        on-device multi-start maximum-likelihood parameter fit
               for an observed spectrum; writes results as .npz
    advi       fast approximate posterior (full-rank Gaussian ADVI
               over the analytic value+gradient path)
    profile    profile likelihood of one parameter with Wilks 68/95%
               confidence intervals (grid of constrained refits as
               one device program)
    evidence   on-device Bayesian evidence (stepping-stone over a
               parallel-tempering ladder) for model comparison
    sbc        simulation-based calibration: hundreds of posteriors as
               one stacked-observation chain program, rank-uniformity
               verdict for the whole sampler+likelihood stack
    gof        posterior predictive goodness-of-fit: did the assumed
               signal+noise model actually generate the observation?
               (exact chi^2 tail over a sampled chain, exit 1 on misfit)
"""

from __future__ import annotations

import argparse
import sys

import numpy as np


def _get_data(args):
    from tpu21cmvae.data import load_dataset, synthetic_dataset
    from tpu21cmvae.data.dataset import ensure_dataset

    if getattr(args, "dataset", None):
        return load_dataset(args.dataset)
    if getattr(args, "download", False):
        return ensure_dataset()
    print(
        "WARNING: no --dataset/--download given — using the built-in "
        "SYNTHETIC dataset. Results are not 21cmGEM numbers.",
        file=sys.stderr,
    )
    return synthetic_dataset(n_train=4096, n_val=512, n_test=512, seed=0)


def cmd_download(args):
    from tpu21cmvae.data.dataset import default_cache_path, download_dataset

    dest = args.out or default_cache_path()
    print(f"downloading to {dest} ...")
    download_dataset(dest)
    print("done")


def cmd_train(args):
    import dataclasses

    from tpu21cmvae import AutoEncoderEmulator, DirectEmulator, VAEEmulator
    from tpu21cmvae.utils.config import DIRECT_TRAIN_DEFAULT

    data = _get_data(args)
    if args.family == "ensemble":
        from tpu21cmvae.models.ensemble import DeepEnsemble

        cfg = DIRECT_TRAIN_DEFAULT
        if args.epochs:
            cfg = dataclasses.replace(cfg, epochs=args.epochs)
        model = DeepEnsemble.train(
            data, n_members=args.members, train_config=cfg, verbose=True
        )
    elif args.family == "direct":
        model = DirectEmulator(data)
        cfg = DIRECT_TRAIN_DEFAULT
        if args.epochs:
            cfg = dataclasses.replace(cfg, epochs=args.epochs)
        model.train(
            train_config=cfg,
            verbose=True,
            checkpoint_dir=args.checkpoint_dir,
            resume=args.checkpoint_dir is not None,
        )
    else:
        cls = AutoEncoderEmulator if args.family == "ae" else VAEEmulator
        model = cls(data)
        model.train(
            epochs=args.epochs,
            verbose=True,
            checkpoint_dir=args.checkpoint_dir,
            resume=args.checkpoint_dir is not None,
        )
    err = model.test_error()
    print(f"test error: mean {err.mean():.4f}% median {np.median(err):.4f}%")
    model.save(args.out)
    print(f"saved {args.out}")


def _load_model(path, data=None):
    from tpu21cmvae.models import load_model

    return load_model(path, data)


def cmd_evaluate(args):
    data = _get_data(args)
    model = _load_model(args.model, data)
    for relative, unit in ((True, "%"), (False, "mK")):
        err = model.test_error(relative=relative)
        print(
            f"{'relative' if relative else 'absolute'}: "
            f"mean {err.mean():.4f}{unit} median {np.median(err):.4f}{unit} "
            f"max {err.max():.4f}{unit}"
        )


def cmd_predict(args):
    model = _load_model(args.model)
    raw = (
        np.loadtxt(args.params, delimiter=",")
        if args.params.endswith(".csv")
        else np.load(args.params)
    )
    pred = model.predict(raw)
    np.save(args.out, pred)
    print(f"emulated {np.atleast_2d(pred).shape[0]} signal(s) → {args.out}")


def cmd_export_h5(args):
    from tpu21cmvae.models.io_keras import save_keras_mlp

    model = _load_model(args.model)
    act = model.config.activation
    if hasattr(model, "members"):  # DeepEnsemble: one h5 per member
        import os

        base, _ = os.path.splitext(args.out)
        for i, m in enumerate(model.members):
            path = f"{base}_member_{i:02d}.h5"
            save_keras_mlp(path, m.params, activation=act)
            print(f"wrote {path}")
    elif not hasattr(model, "params") or not isinstance(model.params, tuple):
        # two-stage families: export each stage MLP as its own file
        import os

        base, _ = os.path.splitext(args.out)
        parts = (
            {"em": model.em_params,
             "dec": model.autoencoder.dec_params,
             "enc": model.autoencoder.enc_params}
            if hasattr(model, "autoencoder")
            else {"em": model.em_params, "dec": model.vae.params["dec"]}
        )
        for name, params in parts.items():
            path = f"{base}_{name}.h5"
            save_keras_mlp(path, params, activation=act, name=name)
            print(f"wrote {path}")
    else:
        save_keras_mlp(args.out, model.params, activation=act)
        print(f"wrote {args.out}")


def cmd_export_artifact(args):
    import os

    from tpu21cmvae import deploy

    model = _load_model(args.model)
    platforms = tuple(
        p.strip() for p in args.platforms.split(",") if p.strip()
    )
    known = {"cpu", "tpu", "cuda", "rocm"}
    if not platforms or not set(platforms) <= known:
        bad = sorted(set(platforms) - known) or ["(empty)"]
        print(f"--platforms must be a comma-separated subset of "
              f"{sorted(known)}; got {','.join(bad)}", file=sys.stderr)
        return 2
    if args.obs is not None:
        from tpu21cmvae.serve import load_obs_specs

        specs = load_obs_specs(args.obs)
        if len(specs) != 1:
            print(f"--obs file must contain exactly one observation; got "
                  f"{len(specs)}", file=sys.stderr)
            return 2
        obs, noise_var = specs[0]
        if args.valgrad:
            path = deploy.save_valgrad_artifact(
                model, args.out, obs, noise_var, platforms=platforms
            )
            kind = "value+gradient"
        else:
            path = deploy.save_loglik_artifact(
                model, args.out, obs, noise_var, platforms=platforms
            )
            kind = "loglik"
    elif args.valgrad:
        print("--valgrad needs --obs (the likelihood is per-observation)",
              file=sys.stderr)
        return 2
    else:
        path = deploy.save_predict_artifact(
            model, args.out, platforms=platforms
        )
        kind = "predict"
    print(f"wrote {kind} artifact {path} "
          f"({os.path.getsize(path)} bytes, platforms {','.join(platforms)})")


def cmd_serve(args):
    from tpu21cmvae.serve import main as serve_main

    serve_main(args.model, args.host, args.port, args.warmup,
               warmup_obs=args.warmup_obs)


def _apply_noise_marginals(model, args, noise_var):
    """Wrap the observation's noise spec per the marginalization flags:
    --fg-terms -> foreground-marginalized (tpu21cmvae.foregrounds),
    --marginalize-noise-scale -> noise-level-marginalized on top
    (tpu21cmvae.noisescale); both compose exactly."""
    if getattr(args, "fg_terms", None) is not None:
        noise_var = model.marginalize_foreground(
            noise_var, n_terms=args.fg_terms, basis=args.fg_basis,
            prior_var=args.fg_prior_var,
        )
    if getattr(args, "marginalize_noise_scale", False):
        from tpu21cmvae.noisescale import marginalize_noise_scale

        noise_var = marginalize_noise_scale(
            noise_var, alpha=args.noise_alpha, beta=args.noise_beta,
        )
    return noise_var


def _add_fg_args(p):
    p.add_argument("--fg-terms", type=int, default=None, metavar="K",
                   help="marginalize a K-term linear foreground out of "
                        "the likelihood ANALYTICALLY (the joint "
                        "signal+foreground fit without the K extra "
                        "chain dimensions; zero per-sample cost in the "
                        "default gram likelihood — see "
                        "tpu21cmvae.foregrounds)")
    p.add_argument("--fg-basis",
                   choices=["linlog", "powerlaw", "polynomial"],
                   default="linlog",
                   help="foreground family: linlog (Hills et al. 2018 "
                        "damped log-polynomial, default), powerlaw "
                        "(EDGES-style linearized spectral index), or "
                        "polynomial (Legendre)")
    p.add_argument("--fg-prior-var", type=float, default=None,
                   help="Gaussian prior variance per foreground "
                        "coefficient (default: improper flat prior — "
                        "exact injection invariance; set a proper "
                        "prior for publishable Bayes factors)")
    p.add_argument("--marginalize-noise-scale", action="store_true",
                   help="treat --noise-var as the noise SHAPE only and "
                        "marginalize the absolute level sigma^2 out of "
                        "the likelihood analytically (Student-t form; "
                        "tpu21cmvae.noisescale) — composes with "
                        "--fg-terms")
    p.add_argument("--noise-alpha", type=float, default=None,
                   help="InvGamma prior alpha on the noise-level "
                        "multiplier (with --noise-beta; default: "
                        "Jeffreys p(sigma^2) ~ 1/sigma^2)")
    p.add_argument("--noise-beta", type=float, default=None,
                   help="InvGamma prior beta on the noise-level "
                        "multiplier")


def _build_prior(specs):
    """``--prior IDX:MEAN:SIGMA`` (repeatable) → GaussianBoxPrior over
    the default 21cmGEM-shaped box, or None when no specs were given."""
    if not specs:
        return None
    from tpu21cmvae.priors import GaussianBoxPrior

    constraints = {}
    for spec in specs:
        try:
            idx, mean, sigma = spec.split(":")
            constraints[int(idx)] = (float(mean), float(sigma))
        except ValueError:
            raise SystemExit(
                f"--prior expects IDX:MEAN:SIGMA (e.g. 3:0.054:0.006); "
                f"got {spec!r}"
            )
    return GaussianBoxPrior.for_params(constraints)


def cmd_sample(args):
    from tpu21cmvae.models import load_model
    from tpu21cmvae.serve import load_obs_specs

    model = load_model(args.model)
    specs = load_obs_specs(args.obs)
    if len(specs) != 1:
        print(f"--obs file must contain exactly one observation; got "
              f"{len(specs)}", file=sys.stderr)
        return 2
    obs, noise_var = specs[0]
    noise_var = _apply_noise_marginals(model, args, noise_var)
    if args.sampler == "smc":
        # the SMC anneal self-schedules: no steps/warmup/thin knobs
        kwargs = dict(n_particles=args.walkers, seed=args.seed)
    else:
        kwargs = dict(
            n_walkers=args.walkers, n_steps=args.steps,
            n_warmup=args.warmup, thin=args.thin, seed=args.seed,
        )
    prior = _build_prior(args.prior)
    if prior is not None:
        kwargs["log_prior"] = prior.log_prior
    if args.sampler == "hmc":
        kwargs["n_leapfrog"] = args.leapfrog
    elif args.sampler == "chees":
        if args.max_leapfrog is not None:
            kwargs["max_leapfrog"] = args.max_leapfrog
    elif args.sampler == "nuts":
        kwargs["max_depth"] = args.max_depth
    if args.sampler in ("hmc", "chees", "nuts"):
        kwargs["metric"] = args.metric
    elif args.sampler == "pt":
        kwargs["n_rungs"] = args.rungs
    if args.target_ess is not None:
        if args.sampler != "mh":
            print("--target-ess requires --sampler mh", file=sys.stderr)
            return 2
        kwargs["target_ess"] = args.target_ess
    res = model.sample_posterior(
        obs, noise_var, sampler=args.sampler, **kwargs
    )
    print(res.summary(getattr(model, "par_labels", None)))
    if args.sampler == "smc":
        np.savez_compressed(
            args.out, final=res.final, logp=res.logp, logz=res.logz,
            logz_err=res.logz_err, betas=res.betas,
            stage_ess=res.stage_ess, accept_rate=res.accept_rate,
        )
        print(f"wrote {args.out} (particles {res.final.shape}, "
              f"log Z = {res.logz:.4f})")
        return 0
    blob = dict(
        chain=res.chain, final=res.final, logp=res.logp,
        accept_rate=res.accept_rate, step_size=res.step_size,
    )
    if getattr(res, "trajectory_length", None):  # ChEES diagnostics
        blob["trajectory_length"] = res.trajectory_length
    if getattr(res, "swap_rate", None) is not None:  # PT diagnostics
        blob["swap_rate"] = res.swap_rate
        blob["betas"] = res.betas
        if res.swap_rate.min() < 0.05:
            print(f"WARNING: min per-edge swap rate "
                  f"{res.swap_rate.min():.3f} — the ladder barely "
                  f"transports; add --rungs or lower beta_min")
    if getattr(res, "mean_leapfrog", None):  # NUTS diagnostics
        blob["divergence_rate"] = res.divergence_rate
        blob["mean_leapfrog"] = res.mean_leapfrog
    np.savez_compressed(args.out, **blob)
    print(f"wrote {args.out} (chain {res.chain.shape}, "
          f"final {res.final.shape})")
    return 0


def cmd_fit(args):
    from tpu21cmvae.models import load_model
    from tpu21cmvae.serve import load_obs_specs

    model = load_model(args.model)
    specs = load_obs_specs(args.obs)
    if len(specs) != 1:
        print(f"--obs file must contain exactly one observation; got "
              f"{len(specs)}", file=sys.stderr)
        return 2
    obs, noise_var = specs[0]
    noise_var = _apply_noise_marginals(model, args, noise_var)
    prior = _build_prior(args.prior)
    res = model.fit_params(
        obs, noise_var, n_starts=args.starts, n_steps=args.steps,
        learning_rate=args.lr, seed=args.seed,
        log_prior=None if prior is None else prior.log_prior,
    )
    print(res.summary(getattr(model, "par_labels", None)))
    np.savez_compressed(
        args.out, params=res.params, logp=res.logp, best=res.best,
        best_logp=res.best_logp,
    )
    print(f"wrote {args.out} ({res.params.shape[0]} starts)")
    return 0


def cmd_advi(args):
    from tpu21cmvae.models import load_model
    from tpu21cmvae.serve import load_obs_specs

    model = load_model(args.model)
    specs = load_obs_specs(args.obs)
    if len(specs) != 1:
        print(f"--obs file must contain exactly one observation; got "
              f"{len(specs)}", file=sys.stderr)
        return 2
    obs, noise_var = specs[0]
    noise_var = _apply_noise_marginals(model, args, noise_var)
    prior = _build_prior(args.prior)
    res = model.fit_advi(
        obs, noise_var, n_steps=args.steps, n_mc=args.mc,
        learning_rate=args.lr, seed=args.seed,
        log_prior=None if prior is None else prior.log_prior,
    )
    labels = getattr(model, "par_labels",
                     [f"p{i}" for i in range(res.mu.shape[0])])
    mean, std = res.mean(), res.std()
    for lab, m, s in zip(labels, mean, std):
        print(f"  {lab:>8}: {m:12.6g} ± {s:.4g}")
    print(f"ELBO: first {res.elbo[0]:.4g} → last {res.elbo[-1]:.4g} "
          f"(tail std {res.elbo[-50:].std():.3g})")
    np.savez_compressed(
        args.out, mu=res.mu, chol=res.chol, elbo=res.elbo,
        samples=res.sample(args.samples, seed=args.seed),
        mean=mean, std=std,
    )
    print(f"wrote {args.out} ({args.samples} posterior draws)")
    return 0


def cmd_profile(args):
    from tpu21cmvae.models import load_model
    from tpu21cmvae.serve import load_obs_specs

    model = load_model(args.model)
    specs = load_obs_specs(args.obs)
    if len(specs) != 1:
        print(f"--obs file must contain exactly one observation; got "
              f"{len(specs)}", file=sys.stderr)
        return 2
    obs, noise_var = specs[0]
    noise_var = _apply_noise_marginals(model, args, noise_var)
    n_params = model.config.n_params
    if not 0 <= args.index < n_params:
        print(f"--index must be in [0, {n_params}); got {args.index}",
              file=sys.stderr)
        return 2
    from tpu21cmvae.data.synthetic import PAR_RANGES

    lo, hi = (float(PAR_RANGES[args.index, 0]),
              float(PAR_RANGES[args.index, 1]))
    grid = np.linspace(lo + 1e-6 * (hi - lo), hi - 1e-6 * (hi - lo),
                       args.points)
    res = model.profile_likelihood(
        obs, noise_var, args.index, grid, n_starts=args.starts,
        n_steps=args.steps, seed=args.seed,
    )
    labels = getattr(model, "par_labels", None)
    name = labels[args.index] if labels else f"p{args.index}"
    i68 = res.interval(0.68)
    i95 = res.interval(0.95)
    print(f"profile likelihood of {name}: peak at "
          f"{res.grid[res.logl.argmax()]:.6g}")
    print(f"  68% interval: [{i68[0]:.6g}, {i68[1]:.6g}]")
    print(f"  95% interval: [{i95[0]:.6g}, {i95[1]:.6g}]")
    if i95[0] == res.grid[0] or i95[1] == res.grid[-1]:
        print("  (an endpoint equals the grid edge: interval censored "
              "by the scanned range)")
    np.savez_compressed(
        args.out, index=res.index, grid=res.grid, logl=res.logl,
        params=res.params, interval68=i68, interval95=i95,
    )
    print(f"wrote {args.out}")
    return 0


def _cmd_evidence_batch(model, specs, args):
    """The `evidence` command on a MULTI-observation spec file: one
    batched Laplace+AMIS sweep with the khat escalation policy
    (``--method auto|laplace|flow`` + optional ``--final nested|smc``)
    — :meth:`DirectEmulator.log_evidence_batch`. All observations must
    share one noise spec (the stacked likelihood folds a single
    whitening into the shared trunk)."""
    if not specs:
        print("--obs file contains no observations", file=sys.stderr)
        return 2
    if args.method not in ("auto", "laplace", "flow"):
        print(f"--method {args.method} is per-observation only; a "
              "multi-observation spec runs the batched pipeline "
              "(--method auto|laplace|flow, optionally --final "
              "nested|smc for the still-failing rows)", file=sys.stderr)
        return 2
    nv0 = specs[0][1]
    for i, (_, nv) in enumerate(specs[1:], 1):
        if not np.array_equal(np.asarray(nv0), np.asarray(nv)):
            print(f"batched evidence needs ONE shared noise spec; "
                  f"observation {i} differs from observation 0 — run "
                  "per-observation `evidence` calls instead",
                  file=sys.stderr)
            return 2
    try:
        obs_batch = np.stack([o for o, _ in specs])
    except ValueError as e:
        print(f"observations do not stack into one batch ({e}); every "
              "row must have the same length", file=sys.stderr)
        return 2
    prior = _build_prior(args.prior)
    noise_var = _apply_noise_marginals(model, args, nv0)
    # the estimator-tuning flags reach the same stages they tune on the
    # per-observation path: --fit-starts/--fit-steps → the batched
    # Laplace ascent, --live/--mh-steps → each per-row final nested
    # run, --walkers → the final SMC particle count
    lap_kw = {}
    if args.fit_starts is not None:
        lap_kw["n_starts"] = args.fit_starts
    if args.fit_steps is not None:
        lap_kw["n_steps"] = args.fit_steps
    final_kwargs = None
    if args.final == "nested":
        final_kwargs = {"n_live": args.live, "n_mh": args.mh_steps}
        if prior is not None:
            # nested does exact volume bookkeeping through the
            # transform, not a density (the single-obs path wires the
            # same pair)
            final_kwargs["prior_transform"] = prior.prior_transform
    elif args.final == "smc":
        final_kwargs = {"n_particles": args.walkers * 8}
    res = model.log_evidence_batch(
        obs_batch, noise_var, method=args.method,
        final=args.final, final_kwargs=final_kwargs, seed=args.seed,
        log_prior=None if prior is None else prior.log_prior,
        **lap_kw,
    )
    rows = []
    print(f"{'row':>4} {'logz':>12} {'err':>8} {'khat':>6} method")
    for i, r in enumerate(res):
        k = f"{r.khat:.2f}" if np.isfinite(r.khat) else "—"
        print(f"{i:>4} {r.logz:>12.4f} {r.logz_err:>8.4f} {k:>6} "
              f"{r.method_used}")
        rows.append((r.logz, r.logz_err, r.khat))
    arr = np.asarray(rows)
    np.savez_compressed(
        args.out, logz=arr[:, 0], logz_err=arr[:, 1], khat=arr[:, 2],
        method_used=np.asarray([r.method_used for r in res]),
        map_params=np.stack([r.map_params for r in res]),
    )
    bad = [i for i, r in enumerate(res)
           if r.method_used in ("laplace", "flow")
           and not (r.khat < 0.7)]
    truncated = [i for i in bad if res[i].final_result is not None]
    bad = [i for i in bad if res[i].final_result is None]
    if truncated:
        print(f"WARNING: rows {truncated} ran the final nested stage "
              "but it TRUNCATED (logz would only be a lower bound, so "
              "it was not adopted) — raise --live or nested max_iters "
              "for these rows", file=sys.stderr)
    if bad:
        hint = ("rerun with --final nested" if args.final is None
                else "raise the flow/nested budgets for these rows")
        print(f"WARNING: rows {bad} end with khat >= 0.7 and no "
              f"definitive estimate — {hint}", file=sys.stderr)
    print(f"wrote {args.out} ({len(res)} evidences)")
    return 0


def cmd_evidence(args):
    from tpu21cmvae.models import load_model
    from tpu21cmvae.serve import load_obs_specs

    model = load_model(args.model)
    specs = load_obs_specs(args.obs)
    if len(specs) != 1:
        # multi-observation file → the survey-scale batched pipeline
        return _cmd_evidence_batch(model, specs, args)
    obs, noise_var = specs[0]
    if args.method == "auto":
        print("--method auto is the BATCHED escalation policy; a "
              "single-observation spec picks an explicit estimator "
              "(nested/smc/laplace/flow/ladder)", file=sys.stderr)
        return 2
    if args.final is not None:
        print("--final is the batched pipeline's definitive last "
              "stage; on a single observation just run "
              f"--method {args.final} directly", file=sys.stderr)
        return 2
    noise_var = _apply_noise_marginals(model, args, noise_var)
    prior = _build_prior(args.prior)
    if args.method == "nested":
        res = model.log_evidence(
            obs, noise_var, method="nested", n_live=args.live,
            n_mh=args.mh_steps, seed=args.seed,
            prior_transform=(
                None if prior is None else prior.prior_transform
            ),
        )
        print(res.summary())
        np.savez_compressed(
            args.out, logz=res.logz, logz_err=res.logz_err, h=res.h,
            samples=res.samples, logl=res.logl, log_w=res.log_w,
            posterior=res.posterior(4096, seed=args.seed),
        )
    elif args.method == "smc":
        res = model.log_evidence(
            obs, noise_var, method="smc", n_particles=args.walkers * 8,
            seed=args.seed,
            log_prior=None if prior is None else prior.log_prior,
        )
        print(f"SMC: log Z = {res.logz:.4f} +- {res.logz_err:.4f} "
              f"({res.n_stages} stages, mean mutation acceptance "
              f"{res.accept_rate.mean():.3f})")
        np.savez_compressed(
            args.out, logz=res.logz, logz_err=res.logz_err,
            betas=res.betas, stage_ess=res.stage_ess,
            accept_rate=res.accept_rate, posterior=res.final,
            logp=res.logp,
        )
    elif args.method == "laplace":
        kw = {}
        if args.fit_starts is not None:
            kw["n_starts"] = args.fit_starts
        if args.fit_steps is not None:
            kw["n_steps"] = args.fit_steps
        res = model.log_evidence(
            obs, noise_var, method="laplace", seed=args.seed,
            log_prior=None if prior is None else prior.log_prior, **kw,
        )
        print(res.summary(getattr(model, "par_labels", None)))
        np.savez_compressed(
            args.out, logz=res.logz, map_params=res.map_params,
            map_logp=res.map_logp, cov=res.cov, pd=res.pd,
            posterior=res.posterior(4096, seed=args.seed),
        )
    elif args.method == "flow":
        kw = {}
        if args.fit_steps is not None:
            kw["n_steps"] = args.fit_steps
        res = model.log_evidence(
            obs, noise_var, method="flow", seed=args.seed,
            log_prior=None if prior is None else prior.log_prior, **kw,
        )
        print(res.summary())
        np.savez_compressed(
            args.out, logz=res.logz, logz_err=res.logz_err,
            khat=res.khat, is_ess=res.is_ess,
            posterior=res.posterior(4096, seed=args.seed),
        )
    else:
        res = model.log_evidence(
            obs, noise_var, method="ladder", n_rungs=args.rungs,
            n_walkers=args.walkers, n_steps=args.steps,
            n_warmup=args.warmup, seed=args.seed,
            log_prior=None if prior is None else prior.log_prior,
        )
        print(res.summary())
        np.savez_compressed(
            args.out, logz=res.logz, logz_err=res.logz_err,
            ladder_drift=res.ladder_drift, rung_logz=res.rung_logz,
            betas=res.betas, accept_rate=res.accept_rate,
            swap_rate=res.swap_rate, posterior=res.posterior,
            logp=res.logp,
        )
    print(f"wrote {args.out} (log Z = {res.logz:.4f})")
    return 0


def cmd_sbc(args):
    from tpu21cmvae.calibration import sbc
    from tpu21cmvae.models import load_model

    model = load_model(args.model)
    res = sbc(
        model, n_sims=args.sims, n_walkers=args.walkers,
        n_steps=args.steps, n_warmup=args.warmup,
        noise_var=args.noise_var, seed=args.seed,
        prior=_build_prior(args.prior),
    )
    print(res.summary(getattr(model, "par_labels", None)))
    np.savez_compressed(
        args.out, ranks=res.ranks, pvalues=res.pvalues,
        thetas=res.thetas, n_posterior=res.n_posterior,
    )
    print(f"wrote {args.out}")
    return 0 if (res.pvalues > 0.005).all() else 1


def cmd_gof(args):
    from tpu21cmvae.calibration import goodness_of_fit
    from tpu21cmvae.models import load_model
    from tpu21cmvae.serve import load_obs_specs

    model = load_model(args.model)
    specs = load_obs_specs(args.obs)
    if len(specs) != 1:
        print(f"--obs file must contain exactly one observation; got "
              f"{len(specs)}", file=sys.stderr)
        return 2
    obs, noise_var = specs[0]
    noise_var = _apply_noise_marginals(model, args, noise_var)
    blob = np.load(args.chain)
    if "chain" in blob and blob["chain"].size:
        draws = blob["chain"].reshape(-1, blob["chain"].shape[-1])
    else:
        draws = blob["final"]
    try:
        res = goodness_of_fit(
            model, obs, noise_var, draws, max_draws=args.max_draws,
            seed=args.seed,
        )
    except ValueError as e:
        print(f"error: {e}", file=sys.stderr)
        return 2
    print(res.summary())
    worst = int(np.argmax(np.abs(res.bin_z)))
    print(f"worst bin: index {worst} "
          f"(z = {res.bin_z[worst]:+.2f})")
    return 0 if 0.01 < res.p_value < 0.99 else 1


def cmd_verify(args):
    from tpu21cmvae.verify import format_report, run_verification, write_report

    data = _get_data(args)
    label = args.dataset or ("downloaded" if args.download else "synthetic")
    report = run_verification(
        data,
        direct_h5=args.direct_h5,
        keras_dir=args.keras_dir,
        dataset_label=label,
    )
    print(format_report(report))
    if args.out:
        write_report(report, args.out)
        print(f"report written to {args.out}")
    if not report["ok"]:
        sys.exit(1)


def cmd_tune(args):
    from tpu21cmvae import tuner

    data = _get_data(args)
    if args.halving:
        fns = {
            "direct": tuner.tune_direct_halving,
            "ae": tuner.tune_autoencoder_halving,
            "vae": tuner.tune_vae_halving,
        }
        result = fns[args.family](data, n_initial=args.trials, verbose=True)
    else:
        fns = {
            "direct": tuner.tune_direct,
            "ae": tuner.tune_autoencoder,
            "vae": tuner.tune_vae,
        }
        result = fns[args.family](data, n_trials=args.trials, verbose=True)
    print(result.leaderboard())


def main(argv=None):
    ap = argparse.ArgumentParser(prog="tpu21cmvae", description=__doc__)
    sub = ap.add_subparsers(dest="command", required=True)

    p = sub.add_parser("download", help="fetch the 21cmGEM dataset")
    p.add_argument("--out")
    p.set_defaults(fn=cmd_download)

    p = sub.add_parser("train", help="train a model family")
    p.add_argument("family", choices=["direct", "ae", "vae", "ensemble"])
    p.add_argument("--dataset")
    p.add_argument("--download", action="store_true",
                   help="use the real dataset (fetch to cache if needed)")
    p.add_argument("--epochs", type=int)
    p.add_argument("--members", type=int, default=5,
                   help="replica count for family=ensemble")
    p.add_argument("--out", default="model.npz",
                   help="checkpoint path (a DIRECTORY for family=ensemble)")
    p.add_argument("--checkpoint-dir")
    p.set_defaults(fn=cmd_train)

    p = sub.add_parser("evaluate", help="test-set error of a saved model")
    p.add_argument("model",
                   help="checkpoint .npz, or a deep-ensemble directory")
    p.add_argument("--dataset")
    p.add_argument("--download", action="store_true")
    p.set_defaults(fn=cmd_evaluate)

    p = sub.add_parser("predict", help="emulate signals from parameter rows")
    p.add_argument("model")
    p.add_argument("params", help=".npy or .csv of (n, 7) parameter rows")
    p.add_argument("--out", default="signals.npy")
    p.set_defaults(fn=cmd_predict)

    p = sub.add_parser("export-h5",
                       help="export a saved model as Keras-layout HDF5")
    p.add_argument("model")
    p.add_argument("--out", default="model.h5")
    p.set_defaults(fn=cmd_export_h5)

    p = sub.add_parser(
        "export-artifact",
        help="export a self-contained StableHLO deployment artifact "
             "(jax.export; weights + normalization folded in, symbolic "
             "batch dim, replays on any JAX install without tpu21cmvae)",
    )
    p.add_argument("model")
    p.add_argument("--out", default="emulator.bin")
    p.add_argument("--obs", default=None, metavar="FILE",
                   help="single-observation spec file (same formats as "
                        "serve --warmup-obs) — export the fused "
                        "log-likelihood for it instead of predict")
    p.add_argument("--valgrad", action="store_true",
                   help="with --obs: export the fused value+gradient "
                        "likelihood (the HMC/NUTS inner loop for "
                        "external gradient-based samplers)")
    p.add_argument("--platforms", default="cpu,cuda",
                   help="comma-separated lowering targets (default "
                        "cpu,cuda — lowering needs no accelerator)")
    p.set_defaults(fn=cmd_export_artifact)

    p = sub.add_parser(
        "serve",
        help="serve a saved model over HTTP (JSON /predict + /loglik)",
    )
    p.add_argument("model")
    p.add_argument("--host", default="127.0.0.1")
    p.add_argument("--port", type=int, default=8765)
    p.add_argument("--warmup", type=int, default=1024,
                   help="precompile predict buckets up to this many rows")
    p.add_argument("--warmup-obs", default=None, metavar="FILE",
                   help="also precompile likelihood programs for the "
                        "(obs, noise_var) specs in FILE (.json or .npz "
                        "— see tpu21cmvae.serve.load_obs_specs), so the "
                        "first POST /loglik per observation is warm")
    p.set_defaults(fn=cmd_serve)

    p = sub.add_parser(
        "sample",
        help="on-device posterior sampling (MH/ensemble/HMC) for an "
             "observed spectrum",
    )
    p.add_argument("model",
                   help="checkpoint .npz, or a deep-ensemble directory "
                        "(chains then target the member-MIXTURE "
                        "likelihood: emulation uncertainty marginalized)")
    p.add_argument("--obs", required=True, metavar="FILE",
                   help="observation spec (.json or .npz with obs and "
                        "optional noise_var — serve.load_obs_specs "
                        "format, exactly one entry)")
    p.add_argument("--sampler",
                   choices=["hmc", "chees", "nuts", "mh", "ensemble",
                            "pt", "smc"],
                   default="hmc",
                   help="chees = HMC with adaptive trajectory length "
                        "(no --leapfrog tuning); nuts = batched "
                        "iterative No-U-Turn sampler (per-walker "
                        "trajectories, divergence diagnostics); pt = "
                        "parallel tempering (robust on multimodal "
                        "posteriors; --rungs tempered replicas); smc = "
                        "adaptive tempered SMC (--walkers particles, "
                        "self-scheduled anneal, log Z for free)")
    p.add_argument("--walkers", type=int, default=4096)
    p.add_argument("--steps", type=int, default=200)
    p.add_argument("--warmup", type=int, default=100)
    p.add_argument("--leapfrog", type=int, default=8)
    p.add_argument("--max-leapfrog", type=int, default=None,
                   help="with --sampler chees: cap on the adapted "
                        "per-iteration leapfrog count (default 128)")
    p.add_argument("--max-depth", type=int, default=6,
                   help="with --sampler nuts: tree-doubling cap "
                        "(max 2**depth - 1 leapfrogs per draw)")
    p.add_argument("--metric", choices=["auto", "dense", "diag"],
                   default="auto",
                   help="gradient samplers' ensemble mass matrix: "
                        "dense = cross-walker covariance square root "
                        "(whitens correlations), diag = per-dimension "
                        "std, auto = dense for nuts / diag for "
                        "hmc+chees (measured defaults)")
    p.add_argument("--rungs", type=int, default=32,
                   help="temperature-ladder size for --sampler pt")
    p.add_argument("--target-ess", type=float, default=None,
                   help="with --sampler mh: run chunks of --steps until "
                        "the minimum per-parameter ESS reaches this "
                        "(sample_to_ess)")
    p.add_argument("--thin", type=int, default=5)
    p.add_argument("--seed", type=int, default=0)
    p.add_argument("--prior", action="append", metavar="IDX:MEAN:SIGMA",
                   help="Gaussian prior on parameter IDX (repeatable; "
                        "e.g. --prior 3:0.054:0.006 for a Planck-style "
                        "tau constraint); unlisted parameters stay flat "
                        "over the box")
    p.add_argument("--out", default="chain.npz")
    _add_fg_args(p)
    p.set_defaults(fn=cmd_sample)

    p = sub.add_parser(
        "fit",
        help="on-device multi-start maximum-likelihood parameter fit "
             "for an observed spectrum",
    )
    p.add_argument("model")
    p.add_argument("--obs", required=True, metavar="FILE",
                   help="observation spec (.json or .npz — "
                        "serve.load_obs_specs format, exactly one entry)")
    p.add_argument("--starts", type=int, default=1024)
    p.add_argument("--steps", type=int, default=300)
    p.add_argument("--lr", type=float, default=0.05)
    p.add_argument("--seed", type=int, default=0)
    p.add_argument("--prior", action="append", metavar="IDX:MEAN:SIGMA",
                   help="Gaussian prior on parameter IDX (repeatable) — "
                        "the fit then maximizes logL + log pi (MAP)")
    p.add_argument("--out", default="fit.npz")
    _add_fg_args(p)
    p.set_defaults(fn=cmd_fit)

    p = sub.add_parser(
        "advi",
        help="fast approximate posterior by full-rank Gaussian ADVI "
             "over the fused value+gradient path (quick-look error "
             "bars; use `sample` for non-Gaussian posteriors)",
    )
    p.add_argument("model")
    p.add_argument("--obs", required=True, metavar="FILE",
                   help="observation spec (.json or .npz — "
                        "serve.load_obs_specs format, exactly one entry)")
    p.add_argument("--steps", type=int, default=600)
    p.add_argument("--mc", type=int, default=512,
                   help="Monte-Carlo draws per ELBO step")
    p.add_argument("--lr", type=float, default=0.05)
    p.add_argument("--samples", type=int, default=4096,
                   help="posterior draws saved to --out")
    p.add_argument("--seed", type=int, default=0)
    p.add_argument("--prior", action="append", metavar="IDX:MEAN:SIGMA",
                   help="Gaussian prior on parameter IDX (repeatable)")
    p.add_argument("--out", default="advi.npz")
    _add_fg_args(p)
    p.set_defaults(fn=cmd_advi)

    p = sub.add_parser(
        "profile",
        help="profile likelihood of one parameter (Wilks 68/95%% "
             "confidence intervals; the whole grid of constrained "
             "refits as one device program)",
    )
    p.add_argument("model")
    p.add_argument("--obs", required=True, metavar="FILE",
                   help="observation spec (.json or .npz — "
                        "serve.load_obs_specs format, exactly one entry)")
    p.add_argument("--index", type=int, required=True,
                   help="parameter index to profile (0-6; see "
                        "par_labels)")
    p.add_argument("--points", type=int, default=41,
                   help="grid points across the prior range")
    p.add_argument("--starts", type=int, default=256)
    p.add_argument("--steps", type=int, default=300)
    p.add_argument("--seed", type=int, default=0)
    p.add_argument("--out", default="profile.npz")
    _add_fg_args(p)
    p.set_defaults(fn=cmd_profile)

    p = sub.add_parser(
        "evidence",
        help="on-device Bayesian evidence (log Z) for an observed "
             "spectrum, for model comparison across families",
    )
    p.add_argument("model")
    p.add_argument("--obs", required=True, metavar="FILE",
                   help="observation spec (.json or .npz — "
                        "serve.load_obs_specs format, exactly one entry)")
    p.add_argument("--method",
                   choices=("nested", "smc", "laplace", "flow",
                            "ladder", "auto"),
                   default="nested",
                   help="nested sampling (robust default; measured "
                        "~0.04-nat seed spread on real posteriors), "
                        "smc (adaptive tempered Sequential Monte Carlo "
                        "— self-chosen anneal schedule, replication "
                        "logz_err, posterior particles for free), "
                        "laplace (deterministic Gaussian quick look — "
                        "exact-tier MAP + Hessian, unimodal only), "
                        "flow (normalizing-flow importance sampling — "
                        "for curved/skewed unimodal posteriors; trust "
                        "it when khat < 0.7), the PT stepping-stone "
                        "ladder (cross-check only — check its "
                        "drift/err diagnostics), or auto (MULTI-"
                        "observation spec files only: batched "
                        "Laplace+AMIS with khat-triggered per-row "
                        "flow escalation; add --final for a "
                        "definitive last stage)")
    p.add_argument("--final", choices=("nested", "smc"), default=None,
                   help="batched (multi-observation) runs: settle rows "
                        "still failing khat after the flow attempt "
                        "with a per-row definitive estimator")
    p.add_argument("--live", type=int, default=2048,
                   help="nested: number of live points")
    p.add_argument("--mh-steps", type=int, default=24,
                   help="nested: constrained-MH steps per replacement")
    p.add_argument("--rungs", type=int, default=32)
    p.add_argument("--walkers", type=int, default=256)
    p.add_argument("--steps", type=int, default=400)
    p.add_argument("--warmup", type=int, default=200)
    p.add_argument("--fit-starts", type=int, default=None,
                   help="laplace: MAP ascent starts (default 4096 — "
                        "the measured mode-finding reliability floor)")
    p.add_argument("--fit-steps", type=int, default=None,
                   help="laplace: MAP ascent steps (default 2000)")
    p.add_argument("--seed", type=int, default=0)
    p.add_argument("--prior", action="append", metavar="IDX:MEAN:SIGMA",
                   help="Gaussian prior on parameter IDX (repeatable); "
                        "log Z is then the evidence under that prior "
                        "(nested uses its unit-cube transform, the "
                        "ladder its log-density)")
    p.add_argument("--out", default="evidence.npz")
    _add_fg_args(p)
    p.set_defaults(fn=cmd_evidence)

    p = sub.add_parser(
        "sbc",
        help="simulation-based calibration of the sampler+likelihood "
             "stack against the model's own forward model (rank "
             "uniformity; exit 1 if any parameter rejects)",
    )
    p.add_argument("model")
    p.add_argument("--sims", type=int, default=128)
    p.add_argument("--walkers", type=int, default=64,
                   help="per simulation; sets the rank resolution")
    p.add_argument("--steps", type=int, default=300)
    p.add_argument("--warmup", type=int, default=400)
    p.add_argument("--noise-var", type=float, default=25.0)
    p.add_argument("--seed", type=int, default=0)
    p.add_argument("--prior", action="append", metavar="IDX:MEAN:SIGMA",
                   help="calibrate under a Gaussian prior (repeatable): "
                        "truths drawn from it, chains target L*pi")
    p.add_argument("--out", default="sbc.npz")
    p.set_defaults(fn=cmd_sbc)

    p = sub.add_parser(
        "gof",
        help="posterior predictive goodness-of-fit check of a sampled "
             "chain against its observation (exit 1 on misfit)",
    )
    p.add_argument("model", help="checkpoint .npz or ensemble directory")
    p.add_argument("--obs", required=True, metavar="FILE",
                   help="observation spec (same format as sample --obs)")
    p.add_argument("--chain", required=True, metavar="FILE",
                   help="chain .npz written by the sample command")
    p.add_argument("--max-draws", type=int, default=512)
    p.add_argument("--seed", type=int, default=0)
    _add_fg_args(p)
    p.set_defaults(fn=cmd_gof)

    p = sub.add_parser(
        "verify",
        help="run the accuracy-contract battery (golden numbers + "
             "batched-vs-single + band checks) and write a report",
    )
    p.add_argument("--dataset", help="path to dataset_21cmVAE.h5")
    p.add_argument("--download", action="store_true")
    p.add_argument("--direct-h5",
                   help="reference pretrained models/emulator.h5")
    p.add_argument("--keras-dir",
                   help="dir with ae_emulator.h5/encoder.h5/decoder.h5")
    p.add_argument("--out", help="write the JSON report here")
    p.set_defaults(fn=cmd_verify)

    p = sub.add_parser("tune", help="architecture search")
    p.add_argument("--family", choices=["direct", "ae", "vae"],
                   default="direct")
    p.add_argument("--trials", type=int, default=10,
                   help="random-search trials, or initial SHA candidates "
                        "with --halving")
    p.add_argument("--halving", action="store_true",
                   help="successive-halving search instead of random")
    p.add_argument("--dataset")
    p.add_argument("--download", action="store_true")
    p.set_defaults(fn=cmd_tune)

    args = ap.parse_args(argv)
    return args.fn(args)


if __name__ == "__main__":
    from tpu21cmvae.utils.compile_cache import enable_compile_cache

    enable_compile_cache()
    sys.exit(main())
