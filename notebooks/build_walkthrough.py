"""Author notebooks/walkthrough.ipynb programmatically.

Mirrors the reference's interactive surface (``sample_notebook.ipynb`` +
the training recipes of ``Training.ipynb``, SURVEY.md §2.1 item 15) as a
headless-executable notebook: it runs offline on the synthetic dataset
(switching to the real 21cmGEM data automatically when cached) and is
executed end-to-end in CI by tests/test_notebook.py.

Run ``python notebooks/build_walkthrough.py`` after editing the cell
sources below to regenerate the committed .ipynb.
"""

import os

import nbformat as nbf

MD_INTRO = """\
# tpu21cmvae walkthrough

The JAX counterpart of the reference's
[`sample_notebook.ipynb`](https://github.com/christianhbye/21cmVAE)
(reference `notebooks/sample_notebook.ipynb`; training recipes from
`notebooks/Training.ipynb`): load a pretrained emulator, predict global
21-cm signals, evaluate test error, train a custom model, and walk the
autoencoder + VAE families.

Everything below runs **offline** on the built-in synthetic dataset; if
the real 21cmGEM `dataset_21cmVAE.h5` is cached (see
`python -m tpu21cmvae download`), it is used automatically and the
printed errors are the paper's regime (mean 0.34 % for the shipped
weights — reference `README.rst:11`).
"""

CELL_SETUP = """\
import os

# CI executes this notebook headless on the CPU platform (pin the
# backend through the config, which wins as long as no device has been
# touched yet). Interactive runs keep whatever accelerator the
# environment provides.
if os.environ.get("TPU21CMVAE_NB_FAST"):
    import jax

    jax.config.update("jax_platforms", "cpu")

import matplotlib.pyplot as plt
import numpy as np

import tpu21cmvae as t
from tpu21cmvae.data import synthetic_dataset
from tpu21cmvae.data.dataset import default_cache_path, load_dataset

# resolve the repo root whether we run from notebooks/ or the root
ROOT = os.getcwd()
if not os.path.isdir(os.path.join(ROOT, "pretrained")):
    ROOT = os.path.dirname(ROOT)

if os.path.exists(default_cache_path()):
    data = load_dataset(default_cache_path())
    print("using the REAL 21cmGEM dataset")
else:
    data = synthetic_dataset(n_train=4096, n_val=512, n_test=512, seed=0)
    print("using the built-in synthetic dataset (offline)")
print(f"train/val/test: {len(data.par_train)}/{len(data.par_val)}/"
      f"{len(data.par_test)} signals, {data.n_bins} frequency bins")
"""

CELL_LOAD_PREDICT = """\
# Load a pretrained direct emulator and predict one signal
# (reference workflow: sample_notebook.ipynb cells 2-5)
model = t.DirectEmulator.from_checkpoint(
    os.path.join(ROOT, "pretrained", "direct_synthetic.npz"), data
)
signal = model.predict(data.par_test[0])

fig, ax = plt.subplots(figsize=(7, 4))
ax.plot(model.frequencies, signal, label="emulated")
ax.plot(model.frequencies, data.signal_test[0], "--", label="simulated")
ax.set_xlabel(r"$\\nu$ [MHz]")
ax.set_ylabel(r"$\\delta T_b$ [mK]")
ax.legend()
secax = ax.secondary_xaxis(
    "top",
    functions=(
        lambda nu: 1420.4057517667 / np.maximum(nu, 1e-6) - 1,
        lambda z: 1420.4057517667 / (1 + z),
    ),
)
secax.set_xlabel("redshift $z$")
plt.tight_layout()
plt.show()
"""

CELL_NATIVE_TIER = """\
# Tier-native checkpoint: the golden accuracy contract holds AT
# Precision.DEFAULT (the backend's fast matmuls) because the weights
# were fine-tuned WITH a fast forward in the loss
# (scripts/finetune_bf16.py) - 0.174 % mean golden test error. On CPU
# the DEFAULT tier is plain f32, so this cell just demonstrates the
# API; docs/PERF.md has the GPU rates.
bf16_path = os.path.join(ROOT, "pretrained", "direct_synthetic_bf16.npz")
if os.path.exists(bf16_path):
    native = t.DirectEmulator.from_checkpoint(bf16_path, data)
    print("native tier:", native.native_precision)
    fast_predict = native.predict_fn(precision="native")
    sig = np.asarray(fast_predict(native.params,
                                  data.par_test[:4].astype(np.float32)))
    print("native-tier predictions:", sig.shape)
    # the 128-aligned preset (DIRECT_ALIGNED) ships the same way:
    # pretrained/direct_aligned_bf16.npz - 2.7x fewer padded FLOPs
else:
    print("bf16-native checkpoint not present")
"""

CELL_TEST_ERROR = """\
# Test-set error (the paper's figure of merit, Eq. 1)
rel = model.test_error(relative=True)
ab = model.test_error(relative=False)
band = model.test_error(relative=False, flow=50.0, fhigh=100.0)
print(f"relative: mean {rel.mean():.3f}%  median {np.median(rel):.3f}%  "
      f"max {rel.max():.3f}%")
print(f"absolute: mean {ab.mean():.3f} mK  (50-100 MHz band: "
      f"{band.mean():.3f} mK)")

plt.figure(figsize=(6, 3.5))
plt.hist(rel, bins=40)
plt.xlabel("relative RMSE [%]")
plt.ylabel("test signals")
plt.tight_layout()
plt.show()
"""

CELL_TRAIN = """\
# Train a custom direct emulator (reference workflow: Training.ipynb
# cells 4-7; full recipe = utils.config.DIRECT_TRAIN_DEFAULT).
# device_loop=True compiles the WHOLE run as one XLA program.
from tpu21cmvae.utils.config import DirectEmulatorConfig, TrainConfig

# (CI executes this notebook on a CPU mesh and trims the epochs via
# TPU21CMVAE_NB_FAST; interactively you get the full run.)
EPOCHS = 10 if os.environ.get("TPU21CMVAE_NB_FAST") else 30

custom = t.DirectEmulator(data, config=DirectEmulatorConfig(hidden_dims=(96, 96)))
loss, val_loss = custom.train(
    train_config=TrainConfig(epochs=EPOCHS, early_stop_patience=None),
    device_loop=True,
)
print(f"custom model: mean rel err {custom.test_error().mean():.3f}%")

plt.figure(figsize=(6, 3.5))
plt.semilogy(loss, label="train")
plt.semilogy(val_loss, label="val")
plt.xlabel("epoch")
plt.ylabel("relative-MSE loss")
plt.legend()
plt.tight_layout()
plt.show()
"""

CELL_AE = """\
# The autoencoder-based family (reference sample_notebook.ipynb
# cells 10-19; Appendix A of Bye et al. 2022)
ae = t.AutoEncoderEmulator.from_checkpoint(
    os.path.join(ROOT, "pretrained", "ae_synthetic.npz"), data
)
pipe = ae.test_error(relative=True)
recon = ae.test_error(use_autoencoder=True, relative=True)
print(f"AE pipeline:        mean {pipe.mean():.3f}%  "
      f"median {np.median(pipe):.3f}%")
print(f"AE reconstruction:  mean {recon.mean():.3f}%  "
      f"median {np.median(recon):.3f}%")
"""

CELL_VAE = """\
# The variational family: latent traversal (the interpretability
# analysis of the 21cmVAE paper; absent from the reference's v3.1.0
# code snapshot -- SURVEY.md section 0)
vae = t.VAEEmulator.from_checkpoint(
    os.path.join(ROOT, "pretrained", "vae_synthetic.npz"), data
)
values = np.linspace(-2.0, 2.0, 7)
curves = vae.latent_traversal(dim=0, values=values,
                              base_params=data.par_test[0])

plt.figure(figsize=(7, 4))
for v, c in zip(values, curves):
    plt.plot(vae.frequencies, c, label=f"$z_0$={v:+.1f}")
plt.xlabel(r"$\\nu$ [MHz]")
plt.ylabel(r"$\\delta T_b$ [mK]")
plt.legend(ncol=2, fontsize=8)
plt.title("decoded signals along latent dimension 0")
plt.tight_layout()
plt.show()
"""

CELL_ENSEMBLE = """\
# Per-prediction uncertainty from the shipped deep ensemble (three
# seed replicas behind one vmapped device call -- an emulation error
# bar the reference's point-estimator API cannot provide)
from tpu21cmvae import DeepEnsemble

ens = DeepEnsemble.load(os.path.join(ROOT, "pretrained", "ensemble_direct"),
                        data)
mean_sig, sigma = ens.predict_with_uncertainty(data.par_test[0])
print(f"ensemble mean test error: {ens.test_error().mean():.3f}%  "
      f"(typical per-bin sigma {sigma.mean():.3f} mK)")

plt.figure(figsize=(7, 4))
plt.plot(ens.frequencies, mean_sig, label="ensemble mean")
plt.fill_between(ens.frequencies, mean_sig - 3 * sigma,
                 mean_sig + 3 * sigma, alpha=0.35,
                 label=r"$\\pm 3\\sigma$ emulation uncertainty")
plt.plot(ens.frequencies, data.signal_test[0], "--", lw=1,
         label="simulated")
plt.xlabel(r"$\\nu$ [MHz]")
plt.ylabel(r"$\\delta T_b$ [mK]")
plt.legend()
plt.tight_layout()
plt.show()
"""

CELL_SAMPLING = """\
# Posterior inference -- the emulator's intended end use (reference
# README.rst:9-11), which the reference leaves to external samplers at
# ~25 likelihood evaluations/s. Here the ENTIRE chain runs on device
# (tpu21cmvae/sampling/): observe a known signal + noise, then sample
# the 7 astrophysical parameters with adaptive Metropolis-Hastings.
# (Gradient-based samplers are one keyword away: sampler="hmc" rides
# the fused value+gradient kernel, sampler="chees" additionally adapts
# the trajectory length from ensemble statistics — ChEES-HMC, the
# accelerator-native NUTS replacement — and sampler="nuts" is the
# literal No-U-Turn sampler as a batched iterative tree, with
# divergence_rate / mean_leapfrog diagnostics; measured throughputs
# in docs/PERF.md.)
rng = np.random.default_rng(11)
truth = np.asarray(data.par_test[2], np.float32)
obs = model.predict(truth) + rng.normal(0, 5.0, data.n_bins)

par = np.asarray(data.par_train, np.float64)
lo, hi = par.min(0), par.max(0)
lo[:3] = np.maximum(lo[:3], 1e-6)  # log-columns need a positive box
bounds = np.stack([lo, hi], axis=1)

STEPS = 60 if os.environ.get("TPU21CMVAE_NB_FAST") else 300
res = model.sample_posterior(
    obs, noise_var=25.0, sampler="mh", bounds=bounds,
    n_walkers=512, n_steps=STEPS, n_warmup=STEPS, thin=10, seed=0,
)
print(res.summary(model.par_labels))
print("truth:", np.round(truth, 4).tolist())

# Convergence diagnostics (Vehtari et al. 2021 in full): rhat() is the
# RANK-NORMALIZED split-Rhat max-combined with its folded variant --
# chains that agree in mean/variance but differ in their TAILS read
# 1.000 under the plain statistic and are flagged here. ess() is the
# combined multi-chain bulk ESS (stuck walkers cannot fake it), and
# ess_tail() is the sample size your 5%/95% credible-interval
# endpoints actually rest on -- check it before quoting intervals.
print("rank-normalized split-Rhat:", np.round(res.rhat(), 2),
      " (1 = mixed)")
print("bulk ESS:", np.round(res.ess()).astype(int),
      " tail ESS:", np.round(res.ess_tail()).astype(int))

fig, axes = plt.subplots(1, 3, figsize=(10, 3))
for ax, dim in zip(axes, (3, 4, 6)):  # tau, alpha, Rmfp
    ax.hist(res.flat[:, dim], bins=30, density=True, alpha=0.7)
    ax.axvline(truth[dim], color="k", ls="--", label="truth")
    ax.set_xlabel(model.par_labels[dim])
axes[0].set_ylabel("posterior density")
axes[0].legend()
plt.tight_layout()
plt.show()
"""

CELL_FIT_EVIDENCE = """\
# The rest of the analysis pipeline, still without leaving the device:
# (1) fit_params -- multi-start maximum-likelihood fit (the
#     scipy.optimize loop reference users hand-roll), every restart in
#     one lax.scan over the fused value+gradient path;
# (2) sampler="ensemble" -- the Goodman & Weare stretch move (emcee's
#     algorithm), warm-started from the fit;
# (3) log_evidence -- Bayesian model comparison across families by
#     batched nested sampling (the MultiNest/PolyChord workflow as one
#     device program; measured ~0.04-nat seed spread with zero tuning;
#     the PT stepping-stone ladder is the cross-check -- docs/PERF.md).
FAST = bool(os.environ.get("TPU21CMVAE_NB_FAST"))
fit = model.fit_params(
    obs, 25.0, bounds=bounds,
    n_starts=256, n_steps=120 if FAST else 300, seed=0,
)
print(fit.summary(model.par_labels))

seeds, _ = fit.top(256)
res_ens = model.sample_posterior(
    obs, 25.0, sampler="ensemble", bounds=bounds,
    n_walkers=256, n_steps=80 if FAST else 300,
    n_warmup=40 if FAST else 100, thin=10, seed=1, x0=seeds,
)
print("ensemble accept rate:",
      round(float(res_ens.accept_rate.mean()), 2))

ev = model.log_evidence(
    obs, 25.0, bounds=bounds, n_live=256 if FAST else 1024,
    n_mh=8 if FAST else 24, seed=0,
)
print(ev.summary())

# Deterministic quick look: method="laplace" (MAP + Hessian, exact in
# the Gaussian limit). Its gap to the nested estimate IS a measurement
# of the posterior's non-Gaussianity.
lap = model.log_evidence(
    obs, 25.0, bounds=bounds, method="laplace",
    n_starts=256 if FAST else 4096, n_steps=300 if FAST else 2000,
    seed=0,
)
print(f"laplace quick look: log Z = {lap.logz:.2f} "
      f"(gap to nested {lap.logz - ev.logz:+.2f} nats)")

# Adaptive tempered SMC: the pocoMC-style anneal as one device program
# (self-chosen beta schedule, replication logz_err, posterior
# particles in .final; ~0.4 s WARM per evidence -- docs/PERF.md).
smc = model.log_evidence(
    obs, 25.0, bounds=bounds, method="smc",
    n_particles=512 if FAST else 2048, seed=0,
)
print(f"smc: log Z = {smc.logz:.2f} +- {smc.logz_err:.2f} "
      f"({smc.n_stages} adaptive stages, gap to nested "
      f"{smc.logz - ev.logz:+.2f} nats)")

# (4) fit_advi -- quick-look posterior: a full-rank Gaussian ADVI fit
#     over the same value+gradient path (iid draws, no chains to tune;
#     prefer the samplers when the posterior may be non-Gaussian);
# (5) compare_evidence -- ranked Bayes factors across families under
#     one shared budget, with a significance check.
import tpu21cmvae as t21

advi = model.fit_advi(obs, 25.0, bounds=bounds,
                      n_steps=120 if FAST else 600,
                      n_mc=128 if FAST else 512, seed=0, x0=fit.best)
for lab, m, s in zip(model.par_labels, advi.mean(), advi.std()):
    print(f"  {lab:>8}: {m:10.4g} ± {s:.3g}")

# (4b) fit_flow -- the non-Gaussian upgrade: a RealNVP normalizing
#      flow over the same value+gradient path (exact density both
#      ways). method="flow" importance-samples the evidence through
#      the fit; trust it when khat < 0.7 (flows.py).
flow = model.fit_flow(obs, 25.0, bounds=bounds,
                      n_steps=300 if FAST else 1500,
                      n_mc=128 if FAST else 256, seed=0, x0=fit.best)
fev = model.log_evidence(obs, 25.0, bounds=bounds, method="flow",
                         flow=flow, n_is=2048 if FAST else 16384,
                         seed=0)
print(fev.summary())
print(f"flow-IS gap to nested: {fev.logz - ev.logz:+.2f} nats")

comp = t21.compare_evidence(
    {"direct": model, "ae": ae}, obs, 25.0, bounds=bounds,
    n_live=256 if FAST else 1024, n_mh=8 if FAST else 24, seed=0,
)
print(comp.summary())

# Survey scale: model.log_evidence_batch(obs_batch) runs EVERY stage
# batched over observations, and
# its default method="auto" closes the reliability loop -- rows whose
# PSIS khat fails the 0.7 trust bound are automatically re-estimated
# through per-row flow proposals, and final="nested" settles whatever
# remains, so every row ends trustworthy or definitively estimated
# (per-row method_used on the record; measured end to end in
# docs/PERF.md). Same policy from the shell: point
# `python -m tpu21cmvae evidence --method auto --final nested` at a
# multi-observation spec file.
"""

CELL_PT = """\
# Multimodal posteriors: parallel tempering (sampler="pt"). Build a
# controlled two-mode target from the real likelihood -- the true mode
# plus a tau-mirrored replica down-weighted x4 (an 80/20 split). Every
# single-temperature chain freezes at its ~50/50 init split (walkers
# cannot cross a several-hundred-sigma barrier); the tempered ladder's
# replica exchange transports modes to the beta=1 chain, recovering the
# WEIGHTS. (ptemcee's design as one device program: tempered stretch
# moves per rung, an exact independence-sampler prior rung, geometric
# beta-ladder, likelihood-free swap sweeps -- sampling::sample_pt.)
import jax.numpy as jnp

from tpu21cmvae.sampling import sample_mh, sample_pt

TAU = 3
mirror_sum = float(bounds[TAU].sum())
base_ll = model.loglik_fn(obs, 25.0)


def two_mode_loglik(params, x):
    xm = x.at[:, TAU].set(mirror_sum - x[:, TAU])
    return jnp.logaddexp(jnp.log(0.8) + base_ll(params, x),
                         jnp.log(0.2) + base_ll(params, xm))


pt_kwargs = dict(
    n_walkers=64, n_steps=160 if FAST else 1000,
    n_warmup=80 if FAST else 400, thin=10, bounds=bounds, seed=0,
)
mh_2m = sample_mh(two_mode_loglik, model.params, **pt_kwargs)
pt_2m = sample_pt(two_mode_loglik, model.params,
                  n_rungs=16 if FAST else 32, **pt_kwargs)
mid_tau = 0.5 * mirror_sum
late = pt_2m.chain[pt_2m.chain.shape[0] // 2:].reshape(-1, 7)
print("true split 0.80 | plain MH:",
      round(float((mh_2m.flat[:, TAU] < mid_tau).mean()), 2),
      "(frozen at init) | PT:",
      round(float((late[:, TAU] < mid_tau).mean()), 2))
print("per-edge swap rates, min/median:",
      round(float(pt_2m.swap_rate.min()), 2),
      round(float(np.median(pt_2m.swap_rate)), 2))
"""

CELL_MIXTURE = """\
# Uncertainty-aware posteriors: the deep ensemble's inference stack
# targets the member-MIXTURE likelihood (logsumexp over the vmapped
# member likelihoods minus log M), so credible regions honestly widen
# by the emulation error the member spread measures -- compare the
# same observation under member 0 alone vs the 3-member mixture.
mix_kwargs = dict(
    sampler="mh", bounds=bounds, n_walkers=256,
    n_steps=60 if FAST else 300, n_warmup=60 if FAST else 150,
    thin=10, seed=2,
)
flat_member = ens.members[0].sample_posterior(obs, 25.0, **mix_kwargs).flat
flat_mix = ens.sample_posterior(obs, 25.0, **mix_kwargs).flat
ratio = flat_mix.std(0) / flat_member.std(0)
for lab, r in zip(ens.par_labels, ratio):
    print(f"{lab:>8}: mixture/member posterior width = {r:.2f}")
print("(ratios > 1: the posterior widened by the emulation error; "
      "near 1: members agree there, the data sets the width)")
"""

CELL_PRIOR_BAND = """\
# External constraints + the reconstructed signal. One prior spec
# (tpu21cmvae/priors.py) feeds the WHOLE stack: a smooth log-density
# for the chain samplers / fitter (log_prior=...) and a unit-cube
# transform for nested-sampling evidence (prior_transform=...) -- here
# a Planck-style Gaussian on the optical depth tau. Then
# posterior_predictive turns the flat chain into the per-bin credible
# band of the emulated signal -- the reconstruction plot 21-cm
# analyses publish.
from tpu21cmvae import GaussianBoxPrior

TAU = 3
prior = GaussianBoxPrior.for_params(
    {TAU: (float(truth[TAU]), 0.1 * float(truth[TAU]))}, bounds=bounds
)
res_con = model.sample_posterior(
    obs, 25.0, sampler="mh", bounds=bounds, n_walkers=256,
    n_steps=60 if FAST else 300, n_warmup=60 if FAST else 150,
    thin=10, seed=3, log_prior=prior.log_prior,
)
print(f"tau posterior std: flat prior {res.flat[:, TAU].std():.4f} -> "
      f"with the external constraint {res_con.flat[:, TAU].std():.4f}")

band = model.posterior_predictive(res_con.flat)
plt.figure(figsize=(7, 4))
plt.fill_between(model.frequencies, band.bands[0], band.bands[2],
                 alpha=0.35, label="68% credible band")
plt.plot(model.frequencies, band.bands[1], label="posterior median")
plt.plot(model.frequencies, model.predict(truth), "k--", lw=1,
         label="true signal")
plt.xlabel(r"$\\nu$ [MHz]")
plt.ylabel(r"$\\delta T_b$ [mK]")
plt.legend()
plt.title("posterior-predictive signal reconstruction")
plt.tight_layout()
plt.show()
"""

CELL_FOREGROUND = """\
# Foreground marginalization. Real measurements see the 21-cm trough
# UNDER a ~1e3-K galactic foreground; the standard pipeline samples K
# foreground coefficients jointly with the signal parameters. Here the
# linear foreground is integrated out ANALYTICALLY
# (tpu21cmvae/foregrounds.py): the marginal likelihood is still a
# quadratic form whose projected precision folds into the emulator's
# output layer -- zero per-sample cost in the default gram form
# (docs/PERF.md), and with the default flat coefficient prior the
# likelihood is EXACTLY invariant to any injected foreground.
from tpu21cmvae import linlog_basis

F = linlog_basis(model.frequencies, 5)
fg_true = F @ np.array([1500.0, -120.0, 40.0, -8.0, 2.0])
obs_fg = (model.predict(truth) + fg_true
          + rng.normal(0, 5.0, data.n_bins)).astype(np.float32)

mn = model.marginalize_foreground(25.0, basis=F)  # or n_terms=5
res_fg = model.sample_posterior(
    obs_fg, mn, sampler="mh", bounds=bounds, n_walkers=512,
    n_steps=60 if FAST else 300, n_warmup=60 if FAST else 300,
    thin=10, seed=5,
)
ll = model.loglik_fn(obs_fg, mn, precision="contract")(
    model.params, res_fg.flat
)
best = res_fg.flat[int(np.argmax(np.asarray(ll)))]
sig_hat = model.predict(best)
coeff, coeff_cov = mn.coeff_posterior(np.asarray(obs_fg, float) - sig_hat)
fg_hat = mn.reconstruct(coeff)
print("signal residual   (mean |mK|):",
      float(np.abs(sig_hat - model.predict(truth)).mean()))
print("foreground residual (mean |mK|):",
      float(np.abs(fg_hat - fg_true).mean()),
      " -- vs foreground amplitude", float(np.abs(fg_true).mean()))

fig, (a1, a2) = plt.subplots(1, 2, figsize=(10, 3.5))
a1.plot(model.frequencies, obs_fg, lw=0.8, label="observed (fg + signal)")
a1.plot(model.frequencies, fg_hat, "--", label="reconstructed foreground")
a1.set_xlabel(r"$\\nu$ [MHz]"); a1.set_ylabel("T [mK]"); a1.legend()
a2.plot(model.frequencies, model.predict(truth), "k--", label="true signal")
a2.plot(model.frequencies, sig_hat, label="recovered signal")
a2.set_xlabel(r"$\\nu$ [MHz]"); a2.legend()
a1.set_title("what the instrument sees"); a2.set_title("what the fit recovers")
plt.tight_layout()
plt.show()
"""

CELL_NOISESCALE = """\
# Noise-LEVEL marginalization. Radiometers know their noise SHAPE
# (radiometer-equation scaling across the band) far better than its
# absolute calibrated level; published analyses fit sigma as an extra
# chain dimension. Here sigma^2 is integrated out ANALYTICALLY
# (tpu21cmvae/noisescale.py): the Student-t-form marginal is a scalar
# post-transform of the quadratic form every likelihood backend already
# computes, so samplers/evidence/gradients inherit it at zero cost.
# Generate data at a TRUE level 2.5x the assumed shape -- the marginal
# must absorb the mismatch, and the sigma^2-posterior should read ~2.5.
from tpu21cmvae import marginalize_noise_scale

true_level = 2.5
obs_sc = (model.predict(truth)
          + rng.normal(0, np.sqrt(true_level * 25.0), data.n_bins)
          ).astype(np.float32)

sm = marginalize_noise_scale(25.0)  # Jeffreys prior on the level
res_sc = model.sample_posterior(
    obs_sc, sm, sampler="mh", bounds=bounds, n_walkers=512,
    n_steps=60 if FAST else 300, n_warmup=60 if FAST else 300,
    thin=10, seed=6,
)
lo_q, mid, hi_q = np.percentile(res_sc.flat, [16, 50, 84], axis=0)
inside = int(((truth >= lo_q) & (truth <= hi_q)).sum())
print(f"truth inside the 68% interval on {inside}/7 parameters")

# what noise level did the data prefer? (InvGamma posterior readout)
best_sc = res_sc.flat[int(np.argmax(np.asarray(
    model.loglik_fn(obs_sc, sm, precision="contract")(
        model.params, res_sc.flat))))]
a_post, b_post = sm.sigma2_posterior(
    np.asarray(obs_sc, float) - model.predict(best_sc))
print(f"posterior noise-level multiplier: {b_post / (a_post - 1):.2f} "
      f"(generated at {true_level})")
"""

CELL_GOF = """\
# Model checking. SBC (tests/test_calibration.py) certifies the
# SAMPLER; goodness_of_fit certifies the MODEL: did the assumed
# signal+noise family actually generate this observation? The whitened
# residual quadratic form is chi^2 EXACTLY given theta, so the
# posterior predictive p-value is one batched predict + an exact tail
# -- no replicate simulation (tpu21cmvae/calibration.py). Caveat an
# unconverged chain inflates q and reads as misfit -- check the
# split-Rhat printed above before believing a misfit verdict.
gof = model.goodness_of_fit(obs, 25.0, res)
print("clean observation:\\n ", gof.summary())

# corrupt the same observation with a ripple no smooth signal or
# foreground family spans -- the check localizes it in frequency
ripple = 12.0 * np.sin(
    2 * np.pi * (model.frequencies - model.frequencies.min()) / 10.0
)
res_bad = model.sample_posterior(          # same sizes -> the chain
    obs + ripple, 25.0, sampler="mh", bounds=bounds,  # program is
    n_walkers=512, n_steps=STEPS, n_warmup=STEPS,     # already compiled
    thin=10, seed=7,
)
gof_bad = model.goodness_of_fit(obs + ripple, 25.0, res_bad)
print("ripple-corrupted:\\n ", gof_bad.summary())

plt.figure(figsize=(7, 3))
plt.plot(model.frequencies, gof.bin_z, lw=0.8, label="clean")
plt.plot(model.frequencies, gof_bad.bin_z, lw=0.8, label="corrupted")
plt.xlabel(r"$\\nu$ [MHz]")
plt.ylabel("posterior predictive bin z")
plt.legend(); plt.title("where the model cannot reach the data")
plt.tight_layout(); plt.show()
"""

CELL_DEPLOY = """\
# Deployment. The reference deploys by shipping Keras h5 files that
# need the package + TensorFlow + the training data's normalization at
# load time (reference emulator.py:319-337). Here the whole fused chain
# -- par_transform -> MLP -> unpreproc, weights and normalization
# folded in -- exports as ONE self-contained StableHLO binary with a
# SYMBOLIC batch dimension, lowered for cpu AND cuda at once
# (tpu21cmvae/deploy.py). Any JAX install replays it: no tpu21cmvae,
# no checkpoint, no dataset.
import tempfile
from jax import export as jxe

art = os.path.join(tempfile.mkdtemp(), "emulator.bin")
t.save_predict_artifact(model, art)
print(f"artifact: {os.path.getsize(art):,} bytes "
      "(weights + normalization, cpu+cuda)")

replay = jxe.deserialize(bytearray(open(art, "rb").read()))
for n in (1, 64):            # one export serves every batch size
    got = np.asarray(replay.call(np.asarray(data.par_test[:n], np.float32)))
    ref = np.atleast_2d(model.predict(data.par_test[:n]))
    print(f"batch {n:3d}: replay == predict to "
          f"{np.abs(got - ref).max():.1e} mK")
"""

MD_OUTRO = """\
## Where to go next

- `examples/` — headless versions of every workflow here, plus
  MCMC-scale sharded inference (`examples/mcmc_inference.py`) and
  gradient-based HMC over the fused value+grad kernel
  (`examples/hmc_inference.py`).
- `python -m tpu21cmvae --help` — the full CLI (train / evaluate /
  predict / tune / export-h5 / verify / serve / sample / fit /
  evidence).
- `docs/MIGRATION.md` — the reference-API → tpu21cmvae mapping.
- `docs/PERF.md` — measured GPU throughput and precision tiers.
"""


def build() -> nbf.NotebookNode:
    nb = nbf.v4.new_notebook()
    nb.metadata["kernelspec"] = {
        "display_name": "Python 3", "language": "python", "name": "python3"
    }
    cells = [
        nbf.v4.new_markdown_cell(MD_INTRO),
        nbf.v4.new_code_cell(CELL_SETUP),
        nbf.v4.new_code_cell(CELL_LOAD_PREDICT),
        nbf.v4.new_code_cell(CELL_NATIVE_TIER),
        nbf.v4.new_code_cell(CELL_TEST_ERROR),
        nbf.v4.new_code_cell(CELL_TRAIN),
        nbf.v4.new_code_cell(CELL_AE),
        nbf.v4.new_code_cell(CELL_VAE),
        nbf.v4.new_code_cell(CELL_ENSEMBLE),
        nbf.v4.new_code_cell(CELL_SAMPLING),
        nbf.v4.new_code_cell(CELL_FIT_EVIDENCE),
        nbf.v4.new_code_cell(CELL_PT),
        nbf.v4.new_code_cell(CELL_PRIOR_BAND),
        nbf.v4.new_code_cell(CELL_FOREGROUND),
        nbf.v4.new_code_cell(CELL_NOISESCALE),
        nbf.v4.new_code_cell(CELL_GOF),
        nbf.v4.new_code_cell(CELL_MIXTURE),
        nbf.v4.new_code_cell(CELL_DEPLOY),
        nbf.v4.new_markdown_cell(MD_OUTRO),
    ]
    nb.cells = cells
    return nb


if __name__ == "__main__":
    out = os.path.join(os.path.dirname(os.path.abspath(__file__)),
                       "walkthrough.ipynb")
    nbf.write(build(), out)
    print(f"wrote {out}")
