"""tpu21cmvae — a JAX framework for global 21-cm signal emulation.

A ground-up rebuild of the capabilities of christianhbye/21cmVAE
(``VeryAccurateEmulator``, reference at ``/root/reference``): emulate the
global 21-cm brightness-temperature signal — 7 astrophysical parameters
→ a 451-bin δT(z) curve over z = 5–50 — with a direct dense-MLP emulator,
an autoencoder-based emulator, and a variational (VAE) emulator.

Unlike the TensorFlow/Keras reference, everything here is pure functional
JAX: preprocessing and models are pytrees + pure functions, training is a
jit-compiled ``lax.scan`` epoch loop, inference is a single fused device
call that is vmapped over MCMC-scale batches and sharded over a
``jax.sharding.Mesh``.

Design departures from the reference (deliberate):
  * No import-time I/O. The reference downloads a ~300 MB dataset from
    Zenodo and loads it into module globals at import
    (reference ``__init__.py:8-16``, ``emulator.py:198-204``). Here data
    loading is explicit: :func:`tpu21cmvae.data.load_dataset` /
    :func:`tpu21cmvae.data.download_dataset`.
  * Normalization statistics are computed once and carried as a
    :class:`~tpu21cmvae.ops.transforms.Normalizer` pytree instead of being
    recomputed from the training set on every call
    (reference ``preprocess.py:88-101``).
  * ``save`` is implemented (the reference raises ``NotImplementedError``,
    ``emulator.py:441-442``).

The package name is a valid Python identifier (module names cannot start
with a digit).
"""

__version__ = "0.1.0"

from tpu21cmvae.utils.frequency import (  # noqa: F401
    NU_0,
    freq2redshift,
    redshift2freq,
    default_redshifts,
    default_frequencies,
)
from tpu21cmvae.utils.metrics import band_mask, error, error_jnp  # noqa: F401
from tpu21cmvae.ops.transforms import (  # noqa: F401
    Normalizer,
    preproc,
    unpreproc,
    par_transform,
)
from tpu21cmvae.ops.loglik import make_loglik, make_loglik_and_grad  # noqa: F401
from tpu21cmvae.sampling import (  # noqa: F401
    BatchSampleResult,
    ChEESSampleResult,
    EvidenceComparison,
    EvidenceResult,
    FitResult,
    LaplaceResult,
    ProfileResult,
    PTSampleResult,
    PredictiveBand,
    SampleResult,
    compare_evidence,
    fit_map,
    laplace_evidence,
    laplace_evidence_multi,
    log_evidence,
    make_emcee_log_prob,
    posterior_predictive,
    profile_likelihood,
    sample_chees,
    sample_ensemble,
    sample_hmc,
    sample_mh,
    sample_nuts,
    sample_pt,
    sample_smc,
    sample_to_ess,
    SMCResult,
    WeightedPosterior,
    reweight,
)
from tpu21cmvae.nested import (  # noqa: F401
    NestedResult,
    nested_sampling,
    nested_sampling_batch,
)
from tpu21cmvae.vi import (  # noqa: F401
    ADVIResult,
    fit_advi,
    fit_advi_batch,
)
from tpu21cmvae.flows import (  # noqa: F401
    FlowEvidenceResult,
    FlowResult,
    evidence_with_flow,
    evidence_with_flow_batch,
    fit_flow,
    fit_flow_batch,
    flow_evidence,
    flow_evidence_batch,
)
from tpu21cmvae.foregrounds import (  # noqa: F401
    MarginalizedNoise,
    foreground_basis,
    linlog_basis,
    marginalize_foreground,
    polynomial_basis,
    powerlaw_basis,
)
from tpu21cmvae.noisescale import (  # noqa: F401
    ScaleMarginalNoise,
    marginalize_noise_scale,
)
from tpu21cmvae.priors import GaussianBoxPrior  # noqa: F401
from tpu21cmvae.deploy import (  # noqa: F401
    ExportedFn,
    export_loglik,
    export_predict,
    export_valgrad,
    load_artifact,
    save_artifact,
    save_loglik_artifact,
    save_predict_artifact,
    save_valgrad_artifact,
)
from tpu21cmvae.calibration import SBCResult, sbc  # noqa: F401
from tpu21cmvae.models.direct import DirectEmulator  # noqa: F401
from tpu21cmvae.models.autoencoder import AutoEncoder, AutoEncoderEmulator  # noqa: F401
from tpu21cmvae.models.vae import VAE, VAEEmulator  # noqa: F401
from tpu21cmvae.models.ensemble import DeepEnsemble  # noqa: F401
from tpu21cmvae.utils.config import (  # noqa: F401
    AE_EMULATOR_TRAIN_DEFAULT,
    AE_EMULATOR_TRAIN_STRONG,
    AE_TRAIN_DEFAULT,
    AE_TRAIN_STRONG,
    DIRECT_TRAIN_DEFAULT,
    DIRECT_TRAIN_STRONG,
    AutoEncoderConfig,
    DirectEmulatorConfig,
    TrainConfig,
    VAEConfig,
)

PAR_LABELS = ["fstar", "Vc", "fx", "tau", "alpha", "nu_min", "Rmfp"]
"""Names of the 7 astrophysical parameters, in input-column order
(reference ``emulator.py:293-301``)."""
