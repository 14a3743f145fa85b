"""Two-pass Bayesian outlier identification in torch
(ppcseq_tpu/pipeline/identify.py, VB and HMC branches; reference
R/methods.R:74-367).

`identify_outliers` runs:
  1. validation + threshold/draw-count math (R/methods.R:110-195)
  2. data prep: gene selection, indexing, design matrix, TMM exposure
     (R/methods.R:198-238), on the host
  3. PASS 1 "discovery": a fit (VB, or jittered HMC with an ADVI warm
     start) and the exact CI at the permissive threshold flag candidate
     outliers (R/methods.R:268-300)
  4. PASS 2 "test": a refit with those points masked out of the
     likelihood (truncation), then CIs at the user FP level
     (R/methods.R:320-342)
  5. merge into a per-transcript nested result (R/methods.R:344-365)

The fits and the posterior-predictive simulation run on one explicit
`device`; meshes and checkpoints are not ported yet.
"""

from __future__ import annotations

import functools
import os
from dataclasses import dataclass
from typing import Any

import numpy as np
import pandas as pd
import torch

from ppcseq_tpu_torch.data import ingest
from ppcseq_tpu_torch.formula.design import create_design_matrix, parse_formula
from ppcseq_tpu_torch.infer.advi import advi_sample, fit_advi, vb_iterative
from ppcseq_tpu_torch.infer.chains import chains_for_run, mcmc_iterations
from ppcseq_tpu_torch.infer.diagnostics import summarize
from ppcseq_tpu_torch.infer.hmc import run_hmc
from ppcseq_tpu_torch.infer.nuts import run_nuts
from ppcseq_tpu_torch.model import nb_model
from ppcseq_tpu_torch.norm.tmm import sample_scaling
from ppcseq_tpu_torch.ppc.rng import approximated_ci, exact_ci
from ppcseq_tpu_torch.utils import constants as K
from ppcseq_tpu_torch.utils.device import resolve_device, working_dtype
from ppcseq_tpu_torch.utils.log import breadcrumb, timed

def _not_ported(what: str, item: int) -> NotImplementedError:
    return NotImplementedError(f"{what} is not ported yet (ROADMAP.md, queue 1, item {item})")


@dataclass
class InferenceResult:
    """Per-(sample, checked-gene) results of one fit (reference do_inference)."""

    table: pd.DataFrame
    total_draws: int
    fit: Any = None
    counts_rng: np.ndarray | None = None  # [n_draws, S, K] with pass_fit


def _available_memory_bytes() -> float:
    try:
        with open("/proc/meminfo") as f:
            for line in f:
                if line.startswith("MemTotal:"):
                    return float(line.split()[1]) * 1024.0
    except OSError:
        pass
    return 16e9


def seed_generators(seed: int, device) -> tuple[torch.Generator, ...]:
    """Three independent generators (fit, draws, CI) on `device`, spawned
    from numpy.random.SeedSequence(seed)."""
    gens = []
    for child in np.random.SeedSequence(seed).spawn(3):
        g = torch.Generator(device=device)
        g.manual_seed(int(child.generate_state(1, np.uint64)[0]))
        gens.append(g)
    return tuple(gens)


def do_inference(
    my_df: pd.DataFrame,
    formula: str,
    sample: str,
    transcript: str,
    abundance: str,
    do_check: str,
    *,
    approximate_posterior_inference: bool,
    approximate_posterior_analysis: bool,
    X: np.ndarray,
    sorted_sample_names: list[str],
    exposure_by_sample: dict[str, float],
    adj_prob_theshold: float,
    how_many_posterior_draws: float,
    seed: int,
    to_exclude: pd.DataFrame | None = None,
    truncation_compensation: float = 1.0,
    pass_fit: bool = False,
    mcmc_sampler: str = "hmc",
    hmc_adapt_trajectory: bool = False,
    cores: int | None = None,
    device="cuda",
    dtype=torch.float32,
) -> InferenceResult:
    """One fit + CI extraction + outlier annotation (reference
    R/utilities.R:1321-1547): VB, or with approximate_posterior_inference
    False, jittered HMC (ChEES with hmc_adapt_trajectory) or NUTS from an
    ADVI warm start; NUTS takes its chain count from the draws and `cores`
    (default os.cpu_count()). `device` defaults to the card and must exist
    (utils/device.resolve_device)."""
    if not approximate_posterior_inference:
        _check_sampler(mcmc_sampler)
    device = resolve_device(device)
    if cores is None:
        cores = os.cpu_count() or 1
    breadcrumb("executing do_inference")
    md = ingest.build_model_data(
        my_df, sample, transcript, abundance, do_check,
        X, sorted_sample_names, exposure_by_sample,
        exclude=to_exclude,
    )
    data, dims = nb_model.prepare_data(
        md.counts, md.X, md.exposure_rate, md.n_check,
        exclude_mask=md.exclude_mask, device=device, dtype=dtype,
    )
    # delta-form likelihood baseline (float32-smooth evaluation)
    data = nb_model.with_baseline(data, dims)
    logp = functools.partial(nb_model.flat_logp(dims), data=data)
    init = nb_model.smart_init(data, dims)

    # If CI analysis is approximated, only ~1000 actual draws are needed
    # (reference R/utilities.R:1372)
    draws_practical = (
        K.APPROX_ANALYSIS_PRACTICAL_DRAWS
        if approximate_posterior_analysis
        else int(np.ceil(how_many_posterior_draws))
    )
    g_fit, g_draws, g_ci = seed_generators(seed, device)

    if approximate_posterior_inference:
        with timed("variational fit"):
            res = vb_iterative(
                logp, dims.dim, g_fit,
                max_iter=K.VB_MAX_ITER,
                tol_rel_obj=K.VB_TOL_REL_OBJ,  # hard-coded in reference R/utilities.R:1493
                init_mean=init,
                device=device,
                dtype=dtype,
            )
        thetas = advi_sample(res, g_draws, draws_practical)
        fit_info = {"method": "advi", "elbo": res.elbo, "iterations": res.iterations}
    else:
        with timed(f"{mcmc_sampler} fit"):
            res, fit_info = _mcmc_fit(logp, dims, init, draws_practical, g_fit, device, dtype,
                                      mcmc_sampler, hmc_adapt_trajectory, cores)
        thetas = res.draws.reshape(-1, dims.dim)

    return _finish_inference(
        thetas=thetas, fit=res if pass_fit else fit_info,
        md=md, data=data, dims=dims, my_df=my_df, formula=formula,
        sample=sample, transcript=transcript, abundance=abundance,
        do_check=do_check, X=X, sorted_sample_names=sorted_sample_names,
        approximate_posterior_analysis=approximate_posterior_analysis,
        adj_prob_theshold=adj_prob_theshold,
        how_many_posterior_draws=how_many_posterior_draws,
        truncation_compensation=truncation_compensation,
        pass_fit=pass_fit, generator=g_ci,
    )


def _check_sampler(mcmc_sampler: str) -> None:
    if mcmc_sampler not in ("hmc", "nuts"):
        raise ValueError(f"unknown mcmc_sampler {mcmc_sampler!r} (use 'hmc' or 'nuts')")


def _mcmc_fit(logp, dims, init, draws_practical, generator, device, dtype, mcmc_sampler,
              hmc_adapt_trajectory, cores):
    """ADVI warm start, then jittered HMC (ChEES with hmc_adapt_trajectory)
    with the divergence-retry ladder, or NUTS (identify.py:216-309 of the
    JAX package). Returns the sampler's result and the fit info."""
    # a quick meanfield fit supplies the initial point and the diagonal mass
    warm = fit_advi(
        logp, dims.dim, generator,
        init_mean=init, tol_rel_obj=0.01, learning_rate=0.3,
        eval_every=50, grad_samples=4, device=device, dtype=dtype,
    )
    inv_mass = torch.exp(2.0 * warm.log_sd)
    breadcrumb(f"executing {mcmc_sampler} fit")
    if mcmc_sampler == "hmc":
        chains = K.HMC_CHAINS
        per_chain = int(np.ceil(draws_practical / chains))
        # divergence-retry ladder (the MCMC analog of vb_iterative, reference
        # R/utilities.R:246-278): tighten target accept if more than 2% of
        # proposals diverge
        for ta in (0.8, 0.95, 0.99):
            res = run_hmc(
                logp, dims.dim, generator,
                num_chains=chains,
                num_warmup=K.HMC_WARMUP,
                num_draws=per_chain,
                num_leapfrog=K.HMC_LEAPFROG,
                target_accept=ta,
                init_theta=warm.mean,
                inv_mass=inv_mass,
                adapt_trajectory=hmc_adapt_trajectory,
                device=device,
                dtype=dtype,
            )
            if res.divergences.sum() <= 0.02 * chains * per_chain:
                break
            print(f"ppcseq says: {int(res.divergences.sum())} divergent "
                  f"transitions at target_accept={ta}; retrying tighter")
        fit_info = {
            "method": "hmc",
            "chains": chains,
            "divergences": res.divergences.tolist(),
            "step_size": res.step_size,
            "target_accept": ta,
        }
        if res.trajectory_length is not None:
            fit_info["trajectory_length"] = res.trajectory_length
    else:
        chains = chains_for_run(draws_practical, cores)
        res = run_nuts(
            logp, dims.dim, generator,
            num_chains=chains,
            num_warmup=K.MCMC_WARMUP,
            num_draws=mcmc_iterations(draws_practical, chains),
            init_theta=warm.mean,
            inv_mass_init=inv_mass,
            device=device,
            dtype=dtype,
        )
        fit_info = {
            "method": "nuts",
            "chains": chains,
            "divergences": res.divergences.tolist(),
            "step_size": res.step_size.tolist(),
        }
    # convergence diagnostics on the parameters that drive the calls (slope
    # block + the 6 hyperparameters); only these columns leave the device
    if res.draws.shape[1] >= 4:
        sel = np.r_[0:6, 6 + 2 * dims.G : 6 + 2 * dims.G + dims.n_check]
        d = summarize(res.draws[:, :, torch.as_tensor(sel, device=res.draws.device)].cpu().numpy())
        fit_info["rhat_max"] = d["rhat_max"]
        fit_info["ess_min"] = d["ess_min"]
    return res, fit_info


def _finish_inference(
    *, thetas, fit, md, data, dims, my_df, formula, sample, transcript,
    abundance, do_check, X, sorted_sample_names,
    approximate_posterior_analysis, adj_prob_theshold,
    how_many_posterior_draws, truncation_compensation, pass_fit, generator,
) -> InferenceResult:
    """CI extraction + PPC decision + outlier annotation, from posterior
    draws thetas[n, D] (the second half of reference R/utilities.R:1516-1544)."""
    lambda_log_draws, sigma_raw_draws = nb_model.extract_lambda_sigma_draws(thetas, data, dims)
    alpha1_draws = nb_model.extract_alpha_sub_1_draws(thetas, dims)
    slope_mean = torch.mean(alpha1_draws, dim=0).cpu().numpy()  # per checked gene

    counts_rng = None
    if approximate_posterior_analysis:
        with timed("CI extraction (approximated)"):
            ci = approximated_ci(
                generator, lambda_log_draws, sigma_raw_draws, data.exposure_rate,
                adj_prob_theshold, int(np.ceil(how_many_posterior_draws)),
                truncation_compensation,
            )
    else:
        # the simulated draws reach the host only with pass_fit
        with timed("CI extraction (exact)"):
            ci, counts_rng = exact_ci(
                generator, lambda_log_draws, sigma_raw_draws, data.exposure_rate,
                adj_prob_theshold, truncation_compensation, return_draws=pass_fit,
            )

    # Assemble the per-(S, checked G) table
    nc = dims.n_check
    check_df = my_df[my_df[do_check].astype(bool)][
        [transcript, sample, abundance, "S", "G"] + parse_formula(formula)
    ].copy()
    check_df = check_df[check_df["G"] < nc].reset_index(drop=True)
    s_idx = check_df["S"].to_numpy()
    g_idx = check_df["G"].to_numpy()
    check_df[".lower"] = ci["lower"][s_idx, g_idx]
    check_df[".upper"] = ci["upper"][s_idx, g_idx]
    check_df["mean"] = ci["mean"][s_idx, g_idx]
    check_df["sd"] = ci["sd"][s_idx, g_idx]

    # PPC decision (reference check_if_within_posterior, R/utilities.R:651-663)
    counts_vals = check_df[abundance].to_numpy()
    check_df["ppc"] = (counts_vals >= check_df[".lower"]) & (counts_vals <= check_df[".upper"])
    check_df["is higher than mean"] = (~check_df["ppc"]) & (counts_vals > check_df["mean"])

    # Slope = posterior mean of alpha_sub_1[G] (R/utilities.R:1531)
    check_df["slope"] = slope_mean[g_idx]

    # Deleterious annotation (reference add_deleterious_if_covariate_exists,
    # R/utilities.R:493-513): only when the design has a covariate
    if X.shape[1] > 1:
        pos_in_sorted = {name: i for i, name in enumerate(sorted_sample_names)}
        foi = np.asarray(X, dtype=np.float64)[:, 1]
        foi_by_s = foi[[pos_in_sorted[s] for s in md.sample_names]]
        is_group_right = foi_by_s[s_idx] > foi.mean()
        slope = check_df["slope"].to_numpy()
        is_group_high = ((slope > 0) & is_group_right) | ((slope < 0) & ~is_group_right)
        check_df["deleterious_outliers"] = (~check_df["ppc"]) & (
            check_df["is higher than mean"].to_numpy() == is_group_high
        )

    total_draws = int(dims.S * nc * how_many_posterior_draws)
    return InferenceResult(table=check_df, total_draws=total_draws, fit=fit, counts_rng=counts_rng)


def identify_outliers(
    data: pd.DataFrame,
    formula: str = "~ 1",
    sample: str = "sample",
    transcript: str = "transcript",
    abundance: str = "count",
    significance: str = "PValue",
    do_check: str = "do_check",
    scaling_factor: str | None = None,
    percent_false_positive_genes: float = 1.0,
    how_many_negative_controls: int = 500,
    approximate_posterior_inference: bool = True,
    approximate_posterior_analysis: bool | None = True,
    draws_after_tail: int = 10,
    save_generated_quantities: bool = False,
    additional_parameters_to_save: tuple[str, ...] = (),
    cores: int | None = None,
    pass_fit: bool = False,
    do_check_only_on_detrimental: bool | None = None,
    tol_rel_obj: float = 0.01,
    just_discovery: bool = False,
    seed: int | None = None,
    adj_prob_theshold_2: float | None = None,
    mcmc_sampler: str = "hmc",
    hmc_adapt_trajectory: bool = False,
    checkpoint_dir: str | None = None,
    mesh=None,
    device="cuda",
    dtype=torch.float32,
) -> pd.DataFrame:
    """Identify deleterious outlier observations per significant transcript.

    Mirrors ppcseq_tpu.identify_outliers (reference R/methods.R:74-98) and
    returns the same nested DataFrame: one row per checked transcript with
    [transcript, sample_wise_data, ppc_samples_failed,
    tot_deleterious_outliers*]. `device` takes the place of the JAX
    package's `mesh`: the fits and the CI simulation run there (float32 on
    CUDA; `dtype` is honoured on the CPU). approximate_posterior_inference=
    False runs the jittered-HMC sampler (`mcmc_sampler="hmc"`, 128 chains;
    ChEES trajectory adaptation with `hmc_adapt_trajectory=True`) or NUTS
    (`mcmc_sampler="nuts"`, chains from the draw count and `cores`, default
    os.cpu_count()), each from an ADVI warm start. `mesh`, `checkpoint_dir`,
    `additional_parameters_to_save` and `save_generated_quantities` raise
    NotImplementedError.
    """
    if not approximate_posterior_inference:
        _check_sampler(mcmc_sampler)
    if mesh is not None:
        raise _not_ported("mesh (pass device= instead)", 6)
    if checkpoint_dir is not None:
        raise _not_ported("checkpoint_dir", 5)
    if additional_parameters_to_save:
        raise _not_ported("additional_parameters_to_save", 5)
    device = resolve_device(device)
    dtype = working_dtype(device, dtype)
    if cores is None:
        cores = os.cpu_count() or 1
    if tol_rel_obj != 0.01:
        import warnings

        warnings.warn(
            "ppcseq says: tol_rel_obj is accepted for API parity but ignored — "
            f"the VB fit uses the reference's hard-coded {K.VB_TOL_REL_OBJ} "
            "(reference R/utilities.R:1491-1493; see docs/PARITY.md)"
        )
    if do_check_only_on_detrimental is None:
        do_check_only_on_detrimental = len(parse_formula(formula)) > 0
    if seed is None:
        seed = int(np.random.default_rng().integers(1, 1_000_000))

    # ---- validation (R/methods.R:110-153) --------------------------------
    ingest.check_columns_exist(data, [sample, transcript, abundance, significance])
    ingest.check_if_any_na(data, [sample, transcript, abundance, significance] + parse_formula(formula))

    if not data[do_check].astype(bool).any():
        import warnings

        warnings.warn("ppcseq says: there are no transcripts with the .do_check category. Empty result returned.")
        return pd.DataFrame(
            {transcript: [], "sample_wise_data": [], "ppc_samples_failed": [],
             "tot_deleterious_outliers": []}
        )

    if approximate_posterior_inference and save_generated_quantities:
        raise ValueError(
            "Variational Bayes does not support saving generated quantities, use sampling"
        )
    if save_generated_quantities:
        raise _not_ported("save_generated_quantities", 5)
    if not (0 <= percent_false_positive_genes <= 100) or np.isnan(percent_false_positive_genes):
        raise ValueError("percent_false_positive_genes must be between 0 and 100")
    if data[transcript].isna().any():
        raise ValueError("There are NAs in the .transcript. Please filter those records")
    ingest.check_integer_counts(data, abundance)

    # ---- thresholds and draw counts (R/methods.R:155-167) ----------------
    n_samples = data[sample].nunique()
    if adj_prob_theshold_2 is None:
        adj_prob_theshold_2 = (
            percent_false_positive_genes / 100 / n_samples
            * (2 if do_check_only_on_detrimental else 1)
        )
    adj_prob_theshold_1 = max(0.05, adj_prob_theshold_2 * 2)
    how_many_posterior_draws_1 = max(draws_after_tail / adj_prob_theshold_1, 1000)
    how_many_posterior_draws_2 = max(draws_after_tail / adj_prob_theshold_2, 1000)

    # auto-switch to approximated CI analysis (R/methods.R:169-195)
    if approximate_posterior_analysis is None:
        approximate_posterior_analysis = how_many_posterior_draws_2 > K.APPROX_ANALYSIS_DRAW_THRESHOLD
    if not approximate_posterior_analysis:
        intercept_b, slope_b = (
            K.MEM_REGRESSION_MCMC if not approximate_posterior_inference else K.MEM_REGRESSION_VB
        )
        required = intercept_b + how_many_posterior_draws_2 * slope_b
        if required > _available_memory_bytes():
            import warnings

            warnings.warn(
                "Not enough memory to analyse the posterior with full MCMC draws; "
                "approximate_posterior_analysis set to True"
            )
            approximate_posterior_analysis = True

    # ---- data prep (R/methods.R:198-238) ---------------------------------
    work = data.assign(do_check___=data[do_check].astype(bool))
    my_df = ingest.format_input(
        work, formula, sample, transcript, abundance, "do_check___",
        significance, how_many_negative_controls,
    )
    X, _x_names, x_rows = create_design_matrix(my_df, formula, sample)
    sorted_sample_names = list(x_rows[sample])

    if scaling_factor is not None:
        scal = (
            data[[sample, scaling_factor]]
            .drop_duplicates()
            .rename(columns={scaling_factor: "multiplier"})
        )
        scal["exposure_rate"] = -np.log(scal["multiplier"])
        scal["exposure_multiplier"] = np.exp(scal["exposure_rate"])
    else:
        scal = sample_scaling(my_df, sample, transcript, abundance)
    exposure_by_sample = dict(zip(scal[sample], scal["exposure_rate"]))

    common = dict(
        formula=formula, sample=sample, transcript=transcript, abundance=abundance,
        do_check="do_check___", X=X, sorted_sample_names=sorted_sample_names,
        exposure_by_sample=exposure_by_sample,
        approximate_posterior_inference=approximate_posterior_inference,
        pass_fit=pass_fit, mcmc_sampler=mcmc_sampler,
        hmc_adapt_trajectory=hmc_adapt_trajectory, cores=cores,
        # the reference reuses the same seed for both passes
        # (R/methods.R:284, 340-341)
        seed=seed, device=device, dtype=dtype,
    )

    # ---- PASS 1: discovery (R/methods.R:268-286) -------------------------
    with timed("pass 1 (discovery fit)"):
        res_discovery = do_inference(
            my_df,
            approximate_posterior_analysis=False,
            adj_prob_theshold=adj_prob_theshold_1,
            how_many_posterior_draws=how_many_posterior_draws_1,
            **common,
        )
    if just_discovery:
        return res_discovery.table

    # points to exclude in pass 2 (R/methods.R:292-300)
    disc = res_discovery.table
    if do_check_only_on_detrimental:
        to_exclude = disc.loc[disc["deleterious_outliers"], ["S", "G"]]
    else:
        to_exclude = disc.loc[~disc["ppc"], ["S", "G"]]
    to_exclude = to_exclude.drop_duplicates()

    # ---- PASS 2: test at the user FP level (R/methods.R:320-342) ---------
    with timed("pass 2 (truncated test fit)"):
        res_test = do_inference(
            my_df,
            approximate_posterior_analysis=approximate_posterior_analysis,
            adj_prob_theshold=adj_prob_theshold_2,
            how_many_posterior_draws=how_many_posterior_draws_2,
            to_exclude=to_exclude,
            truncation_compensation=K.TRUNCATION_COMPENSATION_PASS2,
            **common,
        )

    # ---- merge (reference merge_results, R/utilities.R:539-608) ----------
    result = merge_results(
        res_discovery.table, res_test.table, formula,
        transcript, abundance, sample,
        do_check_only_on_detrimental, scal.rename(columns={sample: "__sample__"}),
        sample_colname=sample,
    )
    result.attrs["total_draws"] = res_test.total_draws
    # provenance: which (sample, gene) cells pass 1 excluded from pass 2
    excl = to_exclude.merge(
        res_discovery.table[["S", "G", transcript, sample]].drop_duplicates(),
        on=["S", "G"], how="left",
    )
    result.attrs["pass1_excluded"] = excl.reset_index(drop=True)
    result.attrs["transcript_column"] = transcript
    result.attrs["abundance_column"] = abundance
    result.attrs["sample_column"] = sample
    result.attrs["formula"] = formula
    if approximate_posterior_inference:
        result.attrs["vb_iterations"] = tuple(
            f.iterations if pass_fit else f["iterations"]
            for f in (res_discovery.fit, res_test.fit)
        )
    if pass_fit:
        result.attrs["fit 1"] = res_discovery.fit
        result.attrs["fit 2"] = res_test.fit
    return result


def merge_results(
    disc: pd.DataFrame,
    test: pd.DataFrame,
    formula: str,
    transcript: str,
    abundance: str,
    sample: str,
    do_check_only_on_detrimental: bool,
    sample_exposure: pd.DataFrame,
    sample_colname: str,
) -> pd.DataFrame:
    """Nest per-transcript results (reference R/utilities.R:539-608)."""
    covariates = parse_formula(formula)
    left = disc[["S", "G", transcript, abundance, sample] + covariates].copy()
    left["slope_before_outlier_filtering"] = disc["slope"]

    right_cols = ["S", "G", ".lower", ".upper"]
    right = test[right_cols].copy()
    right["slope_after_outlier_filtering"] = test["slope"]
    right["posterior_predictive_check_succeded"] = test["ppc"]
    if "deleterious_outliers" in test.columns:
        right["deleterious_outliers"] = test["deleterious_outliers"]
    if "generated quantities" in test.columns:
        right["generated quantities"] = test["generated quantities"]

    merged = left.merge(right, on=["S", "G"], how="left")
    exp_map = sample_exposure.set_index("__sample__")
    merged["exposure_rate"] = merged[sample].map(exp_map["exposure_rate"])
    merged["multiplier"] = merged[sample].map(exp_map["multiplier"])

    rows = []
    for name, grp in merged.groupby(transcript, sort=False):
        entry = {
            transcript: name,
            "sample_wise_data": grp.drop(columns=[transcript]).reset_index(drop=True),
            "ppc_samples_failed": int((~grp["posterior_predictive_check_succeded"]).sum()),
        }
        if do_check_only_on_detrimental:
            entry["tot_deleterious_outliers"] = int(grp["deleterious_outliers"].sum())
        rows.append(entry)
    return pd.DataFrame(rows)
