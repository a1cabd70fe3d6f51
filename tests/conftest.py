"""Test environment: force an 8-device virtual CPU platform.

Must run before anything imports jax — multi-device sharding tests run on
a virtual CPU mesh, so the suite needs no accelerator and never touches
one (``python chip_smoke.py`` drives the GPU).
"""

import os

# the suite always runs on the virtual CPU mesh: set the env AND the jax
# config (backends initialize lazily — updating the config before first
# device use wins)
os.environ["JAX_PLATFORMS"] = "cpu"
_flags = os.environ.get("XLA_FLAGS", "")
if "xla_force_host_platform_device_count" not in _flags:
    os.environ["XLA_FLAGS"] = (
        _flags + " --xla_force_host_platform_device_count=8"
    ).strip()

import jax  # noqa: E402

jax.config.update("jax_platforms", "cpu")

# opt-in numerical tripwire for CI (SURVEY.md §5: the functional
# replacement for sanitizer tooling): TPU21CMVAE_DEBUG_NANS=1 makes any
# NaN produced under jit raise instead of propagating
if os.environ.get("TPU21CMVAE_DEBUG_NANS") == "1":
    jax.config.update("jax_debug_nans", True)

import numpy as np  # noqa: E402
import pytest  # noqa: E402


@pytest.fixture(scope="session")
def splits():
    """Small synthetic dataset shared across the suite."""
    from tpu21cmvae.data import synthetic_dataset

    return synthetic_dataset(n_train=512, n_val=128, n_test=128, seed=7)


@pytest.fixture(scope="session")
def normalizer(splits):
    from tpu21cmvae.ops.transforms import Normalizer

    return Normalizer.from_data(splits.par_train, splits.signal_train)


@pytest.fixture(scope="session")
def rng():
    return np.random.default_rng(1234)


# -- test tiers (rounds 4-5) ----------------------------------------------
# Tier assignment is DERIVED from measured durations checked into
# ``tests/durations.json`` (round-4 VERDICT weak #6: the hand-pinned
# frozenset silently rotted). Rules:
#
# * a test whose recorded duration >= _SLOW_CUTOFF seconds is `slow`;
# * if EVERY recorded test of a module lands slow, the module's fastest
#   recorded test drops back to `fast` so the edit-loop tier keeps one
#   core-contract representative per module;
# * the notebook and the subprocess-spawning modules keep their own
#   markers by module name (their durations are irrelevant to tiering);
# * everything else (including tests NOT yet in the file) is `fast`.
#
# Refresh: ``python -m pytest tests/ --store-durations`` merges this
# run's measured call durations into the file (max over params; only
# tests that actually ran are updated — a partial run never erases
# other entries). The rot guard: any fast-tier test whose MEASURED
# duration exceeds _FAST_BUDGET is flagged in the terminal summary with
# a refresh instruction, so a new slow test cannot silently stay fast.
_DURATIONS_FILE = os.path.join(os.path.dirname(__file__), "durations.json")
_SLOW_CUTOFF = 1.0
_FAST_BUDGET = 2.0

# retired round-4 hand-pinned list (kept only to seed durations.json on
# first run if the file is ever lost; see _load_durations)
_SLOW_TESTS = frozenset([
    "test_calibration.py::test_batched_hmc_smoke",
    "test_calibration.py::test_batched_nuts_smoke",
    "test_calibration.py::test_batched_sampling_matches_per_obs",
    "test_calibration.py::test_ensemble_batched_mixture",
    "test_calibration.py::test_gof_batch_flags_the_corrupted_observation",
    "test_calibration.py::test_gof_calibrated_and_misfit_teeth",
    "test_calibration.py::test_gof_marginalized_foreground_and_refusals",
    "test_calibration.py::test_gof_rejects_batch_result_with_redirect",
    "test_calibration.py::test_loglik_and_grad_multi_matches_autodiff",
    "test_calibration.py::test_loglik_multi_matches_single",
    "test_calibration.py::test_sbc_calibrated_on_own_forward_model",
    "test_calibration.py::test_sbc_calibrated_under_marginalized_specs",
    "test_calibration.py::test_sbc_defaults_bounds_to_prior_box",
    "test_calibration.py::test_sbc_thin_zero_raises_friendly_error",
    "test_calibration.py::test_sbc_with_informative_prior",
    "test_calibration.py::test_two_stage_family_batched_sampling",
    "test_deploy.py::test_cli_export_artifact",
    "test_deploy.py::test_loglik_artifact_matches_fused_loglik",
    "test_deploy.py::test_predict_artifact_roundtrip",
    "test_deploy.py::test_two_stage_family_exports",
    "test_deploy.py::test_valgrad_artifact_matches_fused_valgrad",
    "test_ensemble.py::test_ensemble_evidence_smoke",
    "test_ensemble.py::test_ensemble_sampling_and_fit",
    "test_ensemble.py::test_ensemble_serves",
    "test_ensemble.py::test_mixture_loglik_is_logmeanexp",
    "test_ensemble.py::test_mixture_valgrad_matches_autodiff",
    "test_ensemble.py::test_parallel_training_matches_sequential",
    "test_ensemble.py::test_parallel_training_per_member_early_stop",
    "test_ensemble.py::test_vmapped_matches_members",
    "test_flows.py::test_batched_evidence_khat_escalation_closes_the_loop",
    "test_flows.py::test_fit_flow_beats_gaussian_on_curved_ridge",
    "test_flows.py::test_fit_flow_tracks_fresh_params_through_cache",
    "test_flows.py::test_flow_evidence_cache_keyed_on_architecture",
    "test_flows.py::test_flow_evidence_exact_and_lighter_tailed_than_t",
    "test_flows.py::test_flow_evidence_prior_convention",
    "test_flows.py::test_flow_init_is_identity_gaussian",
    "test_flows.py::test_flow_is_an_exact_density",
    "test_flows.py::test_model_level_flow_fit_and_evidence",
    "test_foregrounds.py::test_all_backends_agree",
    "test_foregrounds.py::test_cli_fg_flags",
    "test_foregrounds.py::test_flat_prior_is_injection_invariant",
    "test_foregrounds.py::test_matches_brute_force_marginal",
    "test_foregrounds.py::test_multi_observation_marginalized",
    "test_foregrounds.py::test_sampler_recovers_theta_under_foreground",
    "test_io_cli.py::test_cli_advi_and_profile",
    "test_io_cli.py::test_cli_evidence",
    "test_io_cli.py::test_cli_evidence_batch_auto",
    "test_io_cli.py::test_cli_fit",
    "test_io_cli.py::test_cli_gof",
    "test_io_cli.py::test_cli_prior_flag",
    "test_io_cli.py::test_cli_sample",
    "test_io_cli.py::test_cli_sbc",
    "test_io_cli.py::test_cli_train_evaluate_predict",
    "test_io_cli.py::test_cli_tune",
    "test_io_cli.py::test_export_h5_loads_in_tf_keras",
    "test_io_cli.py::test_keras_h5_matches_reference_layout",
    "test_io_cli.py::test_keras_loader_natural_order_fallback",
    "test_io_cli.py::test_load_model_dispatches_all_families",
    "test_loglik.py::test_analytic_gram_grad_matches_autodiff",
    "test_loglik.py::test_analytic_gram_grad_vs_contract",
    "test_loglik.py::test_contract_precision_alias",
    "test_loglik.py::test_fisher_matches_finite_difference",
    "test_loglik.py::test_fold_loglik_constants_exact",
    "test_loglik.py::test_grad_finite_difference",
    "test_loglik.py::test_gram_honors_activation",
    "test_loglik.py::test_loglik_and_grad_autodiff_matches_grad",
    "test_loglik.py::test_loglik_is_differentiable",
    "test_loglik.py::test_perbin_noise_variance",
    "test_loglik.py::test_single_row_and_model_entry",
    "test_loglik.py::test_two_stage_family_loglik",
    "test_loglik.py::test_xla_loglik_matches_composed",
    "test_metrics.py::test_error_jnp_matches_host_version",
    "test_mlp.py::test_forward_parity_with_numpy",
    "test_mlp.py::test_grad_flows",
    "test_mlp.py::test_shapes_and_param_count",
    "test_nested.py::test_amis_adaptation_lifts_ess_on_sharp_mode_wide_bulk",
    "test_nested.py::test_bimodal_unequal_mass",
    "test_nested.py::test_compare_evidence_prefers_generating_family",
    "test_nested.py::test_laplace_evidence_analytic_gaussian",
    "test_nested.py::test_laplace_evidence_multi_analytic",
    "test_nested.py::test_laplace_matches_nested_on_emulator",
    "test_nested.py::test_laplace_prior_normalization_convention",
    "test_nested.py::test_log_evidence_batch_matches_single",
    "test_nested.py::test_log_evidence_batch_two_stage_family",
    "test_nested.py::test_matches_analytic_gaussian",
    "test_nested.py::test_model_level_default_is_nested",
    "test_nested.py::test_seed_stability",
    "test_nested.py::test_sharp_high_dynamic_range",
    "test_nested.py::test_truncation_flag_and_guards",
    "test_noisescale.py::test_backend_parity",
    "test_noisescale.py::test_cli_scale_marginal",
    "test_noisescale.py::test_fisher_student_t_correction",
    "test_noisescale.py::test_multi_observation",
    "test_noisescale.py::test_sampler_end_to_end",
    "test_noisescale.py::test_valgrad_matches_autodiff",
    "test_notebook.py::test_notebook_executes_clean",
    "test_observability.py::test_history_exports",
    "test_observability.py::test_metrics_logger_streams_epochs",
    "test_observability.py::test_trace_writes_profile",
    "test_parallel.py::test_dp_fit_all_pad_batch_is_noop",
    "test_parallel.py::test_dp_fit_matches_single_device_fit",
    "test_parallel.py::test_dp_fit_scan_multichip",
    "test_parallel.py::test_dp_fit_scan_real_dataset_split_sizes",
    "test_parallel.py::test_dp_fit_uneven_splits_match_single_device",
    "test_parallel.py::test_dp_train_step_matches_single_device",
    "test_parallel.py::test_ensemble_member_sharded_training_matches_unsharded",
    "test_parallel.py::test_sharded_emulator_ae_and_vae_families",
    "test_parallel.py::test_sharded_emulator_warmup_precompiles",
    "test_parallel.py::test_sharded_emulator_wraps_loglik",
    "test_parallel.py::test_sharded_loglik_matches_single_device",
    "test_parallel.py::test_sharded_predict_pads_ragged_batches",
    "test_parallel_sampling.py::test_chees_sharded_moments",
    "test_parallel_sampling.py::test_fit_map_sharded",
    "test_parallel_sampling.py::test_hmc_sharded_moments",
    "test_parallel_sampling.py::test_ladder_evidence_sharded",
    "test_parallel_sampling.py::test_laplace_evidence_sharded",
    "test_parallel_sampling.py::test_mh_adapt_blocks_sharded",
    "test_parallel_sampling.py::test_mh_sharded_moments",
    "test_parallel_sampling.py::test_model_level_mesh_passthrough",
    "test_parallel_sampling.py::test_nested_evidence_sharded",
    "test_parallel_sampling.py::test_nuts_adapt_blocks_sharded",
    "test_parallel_sampling.py::test_nuts_sharded_moments",
    "test_parallel_sampling.py::test_pt_sharded_moments_and_evidence_free_swaps",
    "test_parallel_sampling.py::test_smc_sharded_evidence_and_moments",
    "test_parallel_sampling.py::test_stretch_sharded_moments",
    "test_pretrained.py::test_pretrained_direct_golden",
    "test_pretrained.py::test_pretrained_ensemble_golden",
    "test_pretrained.py::test_pretrained_vae_golden",
    "test_priors.py::test_fit_map_finds_the_map",
    "test_priors.py::test_hmc_targets_likelihood_times_prior",
    "test_priors.py::test_ladder_evidence_under_gaussian_prior",
    "test_priors.py::test_mh_targets_likelihood_times_prior",
    "test_priors.py::test_model_level_prior_passthrough",
    "test_priors.py::test_nested_evidence_under_gaussian_prior",
    "test_priors.py::test_prior_transform_gives_prior_samples",
    "test_priors.py::test_reweight_matches_analytic_conjugate",
    "test_priors.py::test_smc_evidence_under_gaussian_prior",
    "test_priors.py::test_stretch_targets_likelihood_times_prior",
    "test_properties.py::test_fold_constants_equals_transform_then_apply",
    "test_properties.py::test_par_transform_maps_training_range_to_unit_box",
    "test_properties.py::test_unpreproc_inverts_preproc",
    "test_resume.py::test_ae_two_stage_checkpoint_resume",
    "test_resume.py::test_checkpoint_files_written",
    "test_resume.py::test_checkpoint_rotation",
    "test_resume.py::test_model_train_checkpoint_kwargs",
    "test_resume.py::test_resume_after_completion_is_noop",
    "test_resume.py::test_resume_matches_uninterrupted_run",
    "test_resume.py::test_resume_with_early_stop_state",
    "test_resume.py::test_resume_without_checkpoint_trains_fresh",
    "test_retrace.py::test_dropped_loss_closure_frees_factory_entries",
    "test_retrace.py::test_fit_new_shape_does_retrace",
    "test_retrace.py::test_fit_scan_second_call_compiles_nothing",
    "test_retrace.py::test_fit_scan_seed_still_controls_run",
    "test_retrace.py::test_fit_second_call_compiles_nothing",
    "test_retrace.py::test_whitened_ascent_program_cached_on_valgrad",
    "test_review_fixes.py::test_dp_fit_forwards_pass_epoch",
    "test_review_fixes.py::test_eval_monitor_uses_final_epoch_objective",
    "test_review_fixes.py::test_fisher_forecast_cache_is_bounded",
    "test_review_fixes.py::test_retrain_best_ae_honors_config",
    "test_review_fixes.py::test_scan_no_improvement_keeps_last_params",
    "test_review_fixes.py::test_sharded_emulator_non_power_of_two_mesh",
    "test_review_fixes.py::test_vae_loss_fn_signature_matches_fit",
    "test_sampling.py::test_autocorr_time_matches_ess",
    "test_sampling.py::test_chain_program_cache_no_retrace",
    "test_sampling.py::test_chees_beats_fixed_trajectory_on_correlated_gaussian",
    "test_sampling.py::test_chees_exact_on_analytic_anisotropic_gaussian",
    "test_sampling.py::test_chees_model_entry_continuation_and_cache",
    "test_sampling.py::test_chees_posterior_concentrates_with_prior",
    "test_sampling.py::test_dense_metric_whitens_correlated_gaussian",
    "test_sampling.py::test_device_thinning_matches_full_chain",
    "test_sampling.py::test_diagnostics_on_real_run",
    "test_sampling.py::test_emcee_log_prob_adapter",
    "test_sampling.py::test_ensemble_exact_on_analytic_gaussian",
    "test_sampling.py::test_ensemble_posterior_concentrates",
    "test_sampling.py::test_ensemble_resume_and_model_entry",
    "test_sampling.py::test_ensemble_sampler_machinery",
    "test_sampling.py::test_fit_params_recovers_truth_and_seeds_sampler",
    "test_sampling.py::test_hmc_adapt_blocks_heterogeneous_widths",
    "test_sampling.py::test_hmc_exact_on_analytic_anisotropic_gaussian",
    "test_sampling.py::test_hmc_plain_path_still_exact",
    "test_sampling.py::test_hmc_sampler_adapts_and_moves",
    "test_sampling.py::test_log_evidence_matches_analytic_gaussian",
    "test_sampling.py::test_log_evidence_model_comparison",
    "test_sampling.py::test_mh_adapt_blocks_heterogeneous_widths",
    "test_sampling.py::test_mh_adaptation_converges_to_target",
    "test_sampling.py::test_mh_posterior_concentrates",
    "test_sampling.py::test_mh_sampler_machinery",
    "test_sampling.py::test_model_level_profile_likelihood",
    "test_sampling.py::test_model_level_pt",
    "test_sampling.py::test_model_level_target_ess",
    "test_sampling.py::test_model_sample_posterior_entry",
    "test_sampling.py::test_nuts_adapt_blocks_heterogeneous_geometry",
    "test_sampling.py::test_nuts_deep_trees_on_correlated_gaussian",
    "test_sampling.py::test_nuts_metric_auto_policy_and_dense_phase_cache_key",
    "test_sampling.py::test_tail_pathology_refused_where_plain_diagnostics_read_clean",
    "test_sampling.py::test_nuts_divergences_are_detected",
    "test_sampling.py::test_nuts_exact_on_analytic_anisotropic_gaussian",
    "test_sampling.py::test_nuts_model_entry_and_cache",
    "test_sampling.py::test_profile_likelihood_analytic_gaussian",
    "test_sampling.py::test_pt_recovers_mode_weights_where_mh_cannot",
    "test_sampling.py::test_review_regressions_pt_cache_and_ladder_and_to_ess",
    "test_sampling.py::test_sample_to_ess_reaches_target",
    "test_sampling.py::test_sampler_resume_from_state",
    "test_sampling.py::test_two_stage_families_sample_posterior",
    "test_scan_fit.py::test_ae_vae_device_loop",
    "test_scan_fit.py::test_scan_matches_fit_full_recipe",
    "test_scan_fit.py::test_scan_matches_fit_plain",
    "test_scan_fit.py::test_scan_matches_fit_with_early_stop",
    "test_scan_fit.py::test_scan_matches_fit_with_plateau",
    "test_scan_fit.py::test_scan_stochastic_loss",
    "test_scan_fit.py::test_tuner_device_loop",
    "test_serve.py::test_async_jobs_generalize_to_evidence_and_fit",
    "test_serve.py::test_async_sample_job_keeps_server_live",
    "test_serve.py::test_evidence_endpoint",
    "test_serve.py::test_fit_endpoint",
    "test_serve.py::test_foreground_marginalized_endpoints",
    "test_serve.py::test_health_answers_during_long_device_call",
    "test_serve.py::test_loglik_endpoint_and_program_cache",
    "test_serve.py::test_loglik_eviction_frees_chain_programs",
    "test_serve.py::test_predict_endpoint_matches_model",
    "test_serve.py::test_sample_endpoint_posterior_and_program_reuse",
    "test_serve.py::test_sample_service_reuses_chain_program",
    "test_serve.py::test_scale_marginal_endpoints",
    "test_serve.py::test_service_embeddable",
    "test_serve.py::test_warmed_loglik_entries_respect_lru_cap",
    "test_serve.py::test_warmup_loglik_first_request_is_warm",
    "test_smc.py::test_smc_agrees_with_nested_on_emulator_posterior",
    "test_smc.py::test_smc_gaussian_evidence_and_moments",
    "test_smc.py::test_smc_model_entry_and_summary",
    "test_smc.py::test_smc_program_cache_no_retrace",
    "test_smc.py::test_smc_recovers_mode_weights_and_bimodal_evidence",
    "test_tuner.py::test_retrain_best_direct",
    "test_tuner.py::test_retrain_best_multi_seed_picks_best_val",
    "test_tuner.py::test_retrain_best_vae",
    "test_tuner.py::test_tune_autoencoder_halving",
    "test_tuner.py::test_tune_autoencoder_runs",
    "test_tuner.py::test_tune_direct_halving",
    "test_tuner.py::test_tune_direct_halving_deterministic",
    "test_tuner.py::test_tune_direct_halving_device_loop",
    "test_tuner.py::test_tune_direct_ranks_trials",
    "test_tuner.py::test_tune_is_deterministic",
    "test_tuner.py::test_tune_vae_halving",
    "test_tuner.py::test_tune_vae_runs_and_ranks",
    "test_tuner.py::test_tune_vae_weight_count_exact",
    "test_verify.py::test_cli_verify_smoke",
    "test_verify.py::test_report_roundtrip",
    "test_verify.py::test_structural_checks_pass",
    "test_vi.py::test_advi_recovers_diagonal_gaussian",
    "test_vi.py::test_advi_with_prior_matches_conjugate",
    "test_vi.py::test_model_level_advi_concentrates",
])


def _short_id(nodeid):
    return nodeid.split("/")[-1].split("[")[0]


def _load_durations():
    import json

    try:
        with open(_DURATIONS_FILE) as fh:
            return {str(k): float(v) for k, v in json.load(fh).items()}
    except (OSError, ValueError):
        # seed from the retired hand-pinned list so a lost file degrades
        # to the round-4 assignment instead of an all-fast suite
        return {t: 2.0 for t in _SLOW_TESTS}


def pytest_addoption(parser):
    parser.addoption(
        "--store-durations",
        action="store_true",
        default=False,
        help="merge this run's measured per-test call durations into "
        "tests/durations.json (the tier-assignment source)",
    )


def pytest_collection_modifyitems(config, items):
    durations = _load_durations()
    config._t21_durations = durations
    # slow-by-measurement, with a per-module fastest-representative
    # demotion so every module keeps fast-tier coverage
    slow = {t for t, d in durations.items() if d >= _SLOW_CUTOFF}
    by_module = {}
    for t, d in durations.items():
        by_module.setdefault(t.split("::")[0], []).append((d, t))
    for module, entries in by_module.items():
        if all(t in slow for _, t in entries):
            slow.discard(min(entries)[1])
    for item in items:
        short = _short_id(item.nodeid)
        module = short.split("::")[0]
        if module == "test_notebook.py":
            item.add_marker(pytest.mark.notebook)
        if module == "test_multihost.py":
            item.add_marker(pytest.mark.distributed)
        if short in slow or module == "test_notebook.py":
            item.add_marker(pytest.mark.slow)
        if not any(m.name in ("slow", "notebook", "distributed")
                   for m in item.iter_markers()):
            item.add_marker(pytest.mark.fast)


def pytest_runtest_logreport(report):
    if report.when != "call":
        return
    measured = getattr(pytest_runtest_logreport, "_measured", None)
    if measured is None:
        measured = pytest_runtest_logreport._measured = {}
    short = _short_id(report.nodeid)
    measured[short] = max(measured.get(short, 0.0), report.duration)


def pytest_terminal_summary(terminalreporter, exitstatus, config):
    import json

    measured = getattr(pytest_runtest_logreport, "_measured", {})
    if not measured:
        return
    recorded = getattr(config, "_t21_durations", {})
    if config.getoption("--store-durations"):
        merged = dict(recorded)
        merged.update(measured)
        tmp = _DURATIONS_FILE + ".tmp"
        with open(tmp, "w") as fh:
            json.dump(dict(sorted(merged.items())), fh, indent=0,
                      sort_keys=True)
            fh.write("\n")
        os.replace(tmp, _DURATIONS_FILE)
        terminalreporter.write_line(
            f"[tiers] stored {len(measured)} measured durations into "
            f"{_DURATIONS_FILE}"
        )
        return
    # rot guard: a fast-tier test that measurably exceeds the budget
    # (either unlisted, or listed with a stale small duration)
    stale = sorted(
        short
        for short, d in measured.items()
        if d >= _FAST_BUDGET
        and recorded.get(short, 0.0) < _SLOW_CUTOFF
        and not short.startswith(("test_notebook.py", "test_multihost.py"))
    )
    if stale:
        terminalreporter.write_line(
            f"[tiers] WARNING: {len(stale)} fast-tier test(s) exceeded "
            f"the {_FAST_BUDGET:.0f}s fast budget this run — refresh "
            "tests/durations.json with `python -m pytest tests/ "
            "--store-durations`: " + ", ".join(stale[:8])
            + ("..." if len(stale) > 8 else "")
        )
