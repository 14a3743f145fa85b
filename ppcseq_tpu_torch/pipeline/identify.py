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
`device`. With a `mesh` (a torch.distributed DeviceMesh, every rank calling
with the same arguments) the fits run sharded: a `genes` axis splits the
model data and the per-gene parameters (VB, jittered HMC and NUTS on each
rank's local state, parallel/sharding.py), a `chains` axis the chain batch
of the MCMC fits. The draws that the CIs need are then gathered to every
rank, which computes the same table from the same seed. Each pass can be
checkpointed and resumed (utils/checkpoint.py); with a mesh the global rank
0 writes the checkpoint.
"""

from __future__ import annotations

import functools
import json
import os
import warnings
from dataclasses import dataclass, field, replace
from typing import Any

import numpy as np
import pandas as pd
import torch

from ppcseq_tpu_torch.data import ingest
from ppcseq_tpu_torch.formula.design import create_design_matrix, parse_formula
from ppcseq_tpu_torch.infer import graphs
from ppcseq_tpu_torch.infer.advi import advi_sample, fit_advi, vb_iterative
from ppcseq_tpu_torch.infer.chains import chains_for_run, mcmc_iterations
from ppcseq_tpu_torch.infer.diagnostics import summarize
from ppcseq_tpu_torch.infer.hmc import run_hmc
from ppcseq_tpu_torch.infer.nuts import run_nuts
from ppcseq_tpu_torch.model import nb_model
from ppcseq_tpu_torch.model.params import SCALAR_NAMES
from ppcseq_tpu_torch.norm.tmm import sample_scaling
from ppcseq_tpu_torch.parallel import sharding
from ppcseq_tpu_torch.ppc.rng import approximated_ci, exact_ci
from ppcseq_tpu_torch.utils import checkpoint as ckpt
from ppcseq_tpu_torch.utils import constants as K
from ppcseq_tpu_torch.utils.device import resolve_device
from ppcseq_tpu_torch.utils.log import timed


@dataclass
class InferenceResult:
    """Per-(sample, checked-gene) results of one fit (reference do_inference)."""

    table: pd.DataFrame
    total_draws: int
    fit: Any = None
    # [n_draws, S, K] with pass_fit or save_generated_quantities
    counts_rng: np.ndarray | None = None
    # constrained draws by name (reference additional_parameters_to_save,
    # R/methods.R:90)
    additional_parameters: dict[str, np.ndarray] = field(default_factory=dict)
    vb_iterations: int | None = None  # ADVI steps of a VB fit


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
    save_generated_quantities: bool = False,
    additional_parameters_to_save: tuple[str, ...] = (),
    mcmc_sampler: str = "hmc",
    hmc_adapt_trajectory: bool = False,
    cores: int | None = None,
    tol_rel_obj: float = 0.01,
    mesh=None,
    device="cuda",
    dtype=torch.float32,
) -> InferenceResult:
    """One fit + CI extraction + outlier annotation (reference
    R/utilities.R:1321-1547): VB, or with approximate_posterior_inference
    False, jittered HMC (ChEES with hmc_adapt_trajectory) or NUTS from an
    ADVI warm start; NUTS takes its chain count from the draws and `cores`
    (default os.cpu_count()). `device` defaults to the card and must exist
    (utils/device.resolve_device).

    `tol_rel_obj` is taken as JAX's do_inference takes it (identify.py:87,
    209, 226 of the JAX package): the VB fit keeps the reference's
    hard-coded K.VB_TOL_REL_OBJ (R/utilities.R:1491-1493) and the MCMC
    branch's ADVI warm start its 0.01, whatever the argument;
    identify_outliers passes its own on and warns when it is not 0.01.

    `mesh` (identify.py:122-182 of the JAX package):
    - a `genes` axis: the gene count is padded to a multiple of the axis,
      each rank holds its genes of the model data and of the per-gene
      parameters, and every fit (VB, the ADVI warm start, jittered HMC,
      NUTS at 4 chains, as JAX's identify.py:567-586) runs on the local
      state, the map_rect analog inside the product;
    - a `chains` axis alone: the MCMC fits split their chain batch (the ADVI
      warm start runs whole on every rank); a VB fit runs whole on every
      rank, with a warning;
    - both: gene-sharded with the chain batch split too.
    """
    if not approximate_posterior_inference:
        _check_sampler(mcmc_sampler)
    device = resolve_device(device)
    axes = _mesh_axes(mesh, device)
    mesh_genes, mesh_chains = "genes" in axes, "chains" in axes
    if mesh_chains and not mesh_genes and approximate_posterior_inference:
        warnings.warn(
            "mesh with a 'chains' axis has no effect on the variational fit "
            "(it is a single small optimization): the fits will run whole on every "
            "rank. Use a 'genes' axis to shard VB, or "
            "approximate_posterior_inference=False for chain-sharded MCMC.",
            stacklevel=3,
        )
    if mesh_genes and not approximate_posterior_inference and hmc_adapt_trajectory:
        raise ValueError(
            "hmc_adapt_trajectory is not supported with a 'genes' mesh axis "
            "(the trajectory-adaptive runner is flat-state only)")
    if cores is None:
        cores = os.cpu_count() or 1
    with timed("model data"):
        with timed("build model data"):
            md = ingest.build_model_data(
                my_df, sample, transcript, abundance, do_check,
                X, sorted_sample_names, exposure_by_sample,
                exclude=to_exclude,
            )
        # a gene-sharded fit pads G to a multiple of the axis and prepares
        # on the host: smart_init and the baseline need every gene, the card
        # only the rank's own
        pad_to = sharding.pad_genes(md.counts.shape[1], axes["genes"]) if mesh_genes else None
        with timed("prepare data"):
            data, dims = nb_model.prepare_data(
                md.counts, md.X, md.exposure_rate, md.n_check,
                exclude_mask=md.exclude_mask, pad_genes_to=pad_to,
                device="cpu" if mesh_genes else device, dtype=dtype,
            )
        # delta-form likelihood baseline (float32-smooth evaluation)
        with timed("baseline"):
            data = nb_model.with_baseline(data, dims)
        with timed("smart init"):
            init = nb_model.smart_init(data, dims)

    # If CI analysis is approximated, only ~1000 actual draws are needed
    # (reference R/utilities.R:1372)
    draws_practical = (
        K.APPROX_ANALYSIS_PRACTICAL_DRAWS
        if approximate_posterior_analysis
        else int(np.ceil(how_many_posterior_draws))
    )
    g_fit, g_draws, g_ci = seed_generators(seed, device)
    # the posterior columns the CIs read: every coordinate when the caller
    # keeps parameter draws, else the checked block alone (what a sharded
    # fit gathers to every rank)
    cols = None if additional_parameters_to_save else _checked_cols(dims)

    layout = None if mesh is None else sharding.Layout.from_mesh(mesh, dims)
    shard = None if layout is None else layout.genes
    if shard is not None:  # the rank's genes, on the card
        data = sharding.shard_data(data, shard, device)
    logp = nb_model.flat_logp(dims)
    if approximate_posterior_inference:
        with timed("variational fit") as span:
            res = vb_iterative(
                _density(logp, shard), dims.dim, g_fit,
                data=data,
                max_iter=K.VB_MAX_ITER,
                tol_rel_obj=K.VB_TOL_REL_OBJ,  # hard-coded in reference R/utilities.R:1493
                init_mean=init,
                layout=layout,
                device=device,
                dtype=dtype,
            )
            span.set(attempts=res.attempts)
        fit_info = {"method": "advi", "elbo": res.elbo, "iterations": res.iterations}
        vb_iterations = res.iterations
    else:
        with timed(f"{mcmc_sampler} fit") as span:
            res, fit_info = _mcmc_fit(logp, data, dims, init, draws_practical, g_fit, device,
                                      dtype, mcmc_sampler, hmc_adapt_trajectory, cores, layout)
            if mcmc_sampler == "hmc":
                span.set(rungs=fit_info["rungs"])
        vb_iterations = None
    with timed("posterior draws"):
        if approximate_posterior_inference:
            thetas = advi_sample(res, g_draws, draws_practical, layout=layout, dim=dims.dim)
        else:
            thetas = res.draws
        if layout is None or (approximate_posterior_inference and shard is None):
            cols = None  # the whole vector is at hand
        else:  # the draws' columns that the CIs read, from every rank
            thetas = layout.gather(thetas, cols)
        thetas = thetas.reshape(-1, thetas.shape[-1])
    if mesh is not None:
        fit_info["mesh"] = dict(axes)

    result = _finish_inference(
        thetas=thetas, fit=res if pass_fit else fit_info,
        md=md, data=data, dims=dims if cols is None else _checked_dims(dims),
        my_df=my_df, formula=formula,
        sample=sample, transcript=transcript, abundance=abundance,
        do_check=do_check, X=X, sorted_sample_names=sorted_sample_names,
        approximate_posterior_analysis=approximate_posterior_analysis,
        adj_prob_theshold=adj_prob_theshold,
        how_many_posterior_draws=how_many_posterior_draws,
        truncation_compensation=truncation_compensation,
        save_generated_quantities=save_generated_quantities,
        additional_parameters_to_save=additional_parameters_to_save,
        pass_fit=pass_fit, generator=g_ci,
    )
    result.vb_iterations = vb_iterations
    return result


def _mesh_axes(mesh, device) -> dict:
    """{axis: size} of a mesh, after checking its axes and its device type."""
    if mesh is None:
        return {}
    axes = sharding.mesh_axes(mesh)
    if not ({"genes", "chains"} & set(axes)) or set(axes) - {"genes", "chains"}:
        raise ValueError(
            f"mesh axes {tuple(axes)} unknown: name them 'genes' and/or 'chains'")
    if torch.device(mesh.device_type).type != torch.device(device).type:
        raise ValueError(f"the mesh is on {mesh.device_type} but device is {device}: "
                         "the fits run on the mesh's own devices")
    return axes


def _density(logp, shard):
    """flat_logp(dims)'s f(theta, data) for the fits, bound to a gene shard
    under one: unbound, its identity is the key of the fits' CUDA graphs
    (infer/graphs.py), with the data an operand."""
    return logp if shard is None else functools.partial(logp, shard=shard)


def _checked_cols(dims) -> np.ndarray:
    """Global flat indices of the checked block: the scalars, intercept and
    sigma_raw of the checked genes, alpha_sub_1 and alpha_2."""
    n, G, K = len(SCALAR_NAMES), dims.G, dims.n_check
    return np.r_[0:n, n:n + K, n + G:n + G + K, n + 2 * G:dims.dim]


def _checked_dims(dims):
    """The dims of a vector of `_checked_cols` coordinates: the checked
    genes alone."""
    return replace(dims, G=dims.n_check, G_unpadded=min(dims.G_unpadded, dims.n_check))


def _chains_over(chains: int, layout) -> int:
    """The chain count rounded up to a multiple of a chains axis."""
    n = 1 if layout is None else layout.chains_size
    return -(-chains // n) * n


def _check_sampler(mcmc_sampler: str) -> None:
    if mcmc_sampler not in ("hmc", "nuts"):
        raise ValueError(f"unknown mcmc_sampler {mcmc_sampler!r} (use 'hmc' or 'nuts')")


def _diagnostics(res, dims, layout, fit_info):
    """Convergence diagnostics on the parameters that drive the calls (the
    6 hyperparameters + the slope block), gathered from every rank; only
    these columns leave the device."""
    if res.draws.shape[1] < 4:
        return
    n, G = len(SCALAR_NAMES), dims.G
    sel = np.r_[0:n, n + 2 * G:n + 2 * G + dims.n_check]
    if layout is None:
        block = res.draws[:, :, torch.as_tensor(sel, device=res.draws.device)]
    else:
        block = layout.gather(res.draws, sel)
    d = summarize(block.cpu().numpy())
    fit_info["rhat_max"] = d["rhat_max"]
    fit_info["ess_min"] = d["ess_min"]


def _mcmc_fit(logp, data, dims, init, draws_practical, generator, device, dtype, mcmc_sampler,
              hmc_adapt_trajectory, cores, layout=None):
    """ADVI warm start, then jittered HMC (ChEES with hmc_adapt_trajectory)
    with the divergence-retry ladder, or NUTS (identify.py:216-309 and
    468-612 of the JAX package). `logp` is nb_model.flat_logp(dims) and
    `data` the model data, the rank's genes of it under a gene `layout`;
    the fits then run on the local state and the samplers split their chain
    batch over a chains axis (the warm start runs whole on every chain
    rank). Returns the sampler's result and the fit info."""
    mesh = None if layout is None else layout.mesh
    shard = None if layout is None else layout.genes
    # a quick meanfield fit supplies the initial point and the diagonal mass
    with timed("warm start"):
        warm = fit_advi(
            _density(logp, shard), dims.dim, generator, data=data,
            init_mean=init, tol_rel_obj=0.01, learning_rate=0.3,
            eval_every=50, grad_samples=4, layout=layout, device=device, dtype=dtype,
        )
    inv_mass = torch.exp(2.0 * warm.log_sd)
    common = dict(data=data, dims=dims, mesh=mesh, init_theta=warm.mean, device=device,
                  dtype=dtype)
    if mcmc_sampler == "hmc":
        chains = _chains_over(K.HMC_CHAINS, layout)
        per_chain = int(np.ceil(draws_practical / chains))
        # divergence-retry ladder (the MCMC analog of vb_iterative, reference
        # R/utilities.R:246-278): tighten target accept if more than 2% of
        # proposals diverge
        for rungs, ta in enumerate((0.8, 0.95, 0.99), 1):
            with timed("ladder rung", target_accept=ta) as rung:
                res = run_hmc(
                    logp, dims.dim, generator,
                    num_chains=chains,
                    num_warmup=K.HMC_WARMUP,
                    num_draws=per_chain,
                    num_leapfrog=K.HMC_LEAPFROG,
                    target_accept=ta,
                    inv_mass=inv_mass,
                    adapt_trajectory=hmc_adapt_trajectory,
                    **common,
                )
                divergences = int(res.divergences.sum())
                rung.set(divergences=divergences)
            if divergences <= 0.02 * chains * per_chain:
                break
            print(f"ppcseq says: {divergences} divergent "
                  f"transitions at target_accept={ta}; retrying tighter")
        fit_info = {
            "method": "hmc",
            "chains": chains,
            "divergences": res.divergences.tolist(),
            "step_size": res.step_size,
            "target_accept": ta,
            "rungs": rungs,
        }
        if res.trajectory_length is not None:
            fit_info["trajectory_length"] = res.trajectory_length
    else:
        # gene-sharded NUTS runs 4 chains, as JAX's (identify.py:567-586)
        chains = _chains_over(4 if shard is not None else chains_for_run(draws_practical, cores),
                              layout)
        res = run_nuts(
            logp, dims.dim, generator,
            num_chains=chains,
            num_warmup=K.MCMC_WARMUP,
            num_draws=mcmc_iterations(draws_practical, chains),
            inv_mass_init=inv_mass,
            **common,
        )
        fit_info = {
            "method": "nuts",
            "chains": chains,
            "divergences": res.divergences.tolist(),
            "step_size": res.step_size.tolist(),
        }
    _diagnostics(res, dims, layout, fit_info)
    return res, fit_info


def _finish_inference(
    *, thetas, fit, md, data, dims, my_df, formula, sample, transcript,
    abundance, do_check, X, sorted_sample_names,
    approximate_posterior_analysis, adj_prob_theshold,
    how_many_posterior_draws, truncation_compensation,
    save_generated_quantities, additional_parameters_to_save, pass_fit, generator,
) -> InferenceResult:
    """CI extraction + PPC decision + outlier annotation, from posterior
    draws thetas[n, D] (the second half of reference R/utilities.R:1516-1544)."""
    lambda_log_draws, sigma_raw_draws = nb_model.extract_lambda_sigma_draws(thetas, data, dims)
    alpha1_draws = nb_model.extract_alpha_sub_1_draws(thetas, dims)
    slope_mean = torch.mean(alpha1_draws, dim=0).cpu().numpy()  # per checked gene

    # Extra constrained-parameter draws the user asked to keep (reference
    # additional_parameters_to_save, R/methods.R:90, R/utilities.R:1506-1510)
    additional: dict[str, np.ndarray] = {}
    if additional_parameters_to_save:
        constrained = nb_model.unpack(thetas, dims)[0]
        derived = {
            "sigma": lambda: torch.exp(constrained["sigma_raw"]) ** -1,
            "lambda_log_param": lambda: lambda_log_draws,
            "counts_rng": lambda: None,  # handled by save_generated_quantities
        }
        for name in additional_parameters_to_save:
            if name in constrained:
                additional[name] = constrained[name].cpu().numpy()
            elif name in derived:
                v = derived[name]()
                if v is not None:
                    additional[name] = v.cpu().numpy()
            else:
                raise ValueError(
                    f"unknown parameter {name!r}; available: "
                    f"{sorted(constrained.keys() | derived.keys())}"
                )

    counts_rng = None
    if approximate_posterior_analysis:
        with timed("CI extraction (approximated)"):
            ci = approximated_ci(
                generator, lambda_log_draws, sigma_raw_draws, data.exposure_rate,
                adj_prob_theshold, int(np.ceil(how_many_posterior_draws)),
                truncation_compensation,
            )
    else:
        # the simulated draws reach the host only with pass_fit or
        # save_generated_quantities
        with timed("CI extraction (exact)"):
            ci, counts_rng = exact_ci(
                generator, lambda_log_draws, sigma_raw_draws, data.exposure_rate,
                adj_prob_theshold, truncation_compensation,
                return_draws=save_generated_quantities or pass_fit,
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

    if save_generated_quantities:
        if counts_rng is None:
            raise ValueError("generated quantities require the exact CI path")
        gq = [
            pd.DataFrame({".draw": np.arange(counts_rng.shape[0]) + 1,
                          ".value": counts_rng[:, s, g]})
            for s, g in zip(s_idx, g_idx)
        ]
        check_df["generated quantities"] = gq

    total_draws = int(dims.S * nc * how_many_posterior_draws)
    return InferenceResult(table=check_df, total_draws=total_draws, fit=fit,
                           counts_rng=counts_rng, additional_parameters=additional)


def _root_span(fn):
    """fn inside the root span `identify_outliers`, then the samplers'
    cached CUDA graphs dropped (infer/graphs.py, span `release graphs`), so
    that their memory pools do not outlive the call. While spans are
    recorded (utils/log.py) the root carries the call's graph captures,
    replays and likelihood kernel launches by kernel (graphs.counters_since:
    replays' booked launches included)."""

    @functools.wraps(fn)
    def wrapper(*args, **kwargs):
        with timed("identify_outliers") as root:
            before = graphs.counters() if root.recording else None
            try:
                return fn(*args, **kwargs)
            finally:
                with timed("release graphs"):
                    graphs.release()
                if before is not None:
                    root.set(**graphs.counters_since(before))

    return wrapper


@_root_span
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
    tot_deleterious_outliers*]. The fits and the CI simulation run on
    `device` in `dtype`, on the card as on the CPU (float64 runs the
    likelihood's float64 forms there).
    approximate_posterior_inference=
    False runs the jittered-HMC sampler (`mcmc_sampler="hmc"`, 128 chains;
    ChEES trajectory adaptation with `hmc_adapt_trajectory=True`) or NUTS
    (`mcmc_sampler="nuts"`, chains from the draw count and `cores`, default
    os.cpu_count()), each from an ADVI warm start. `checkpoint_dir` persists
    each pass's table and resumes a pass whose configuration (data, device
    type, dtype, thresholds, draws, flags, seed) is unchanged;
    `additional_parameters_to_save` puts pass 2's constrained draws by name
    in `attrs["additional_parameters"]`; `save_generated_quantities` (MCMC
    with the exact CI) adds each point's simulated counts as a
    "generated quantities" frame. `mesh`, a torch.distributed DeviceMesh
    with a `genes` and/or a `chains` axis on `device`'s type
    (parallel/multihost.py builds one), shards the fits (do_inference);
    every rank calls with the same arguments and returns the same table.
    """
    with timed("argument checks"):
        if not approximate_posterior_inference:
            _check_sampler(mcmc_sampler)
        device = resolve_device(device)
        _mesh_axes(mesh, device)
        if cores is None:
            cores = os.cpu_count() or 1
        if tol_rel_obj != 0.01:
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
            warnings.warn("ppcseq says: there are no transcripts with the .do_check category. Empty result returned.")
            return pd.DataFrame(
                {transcript: [], "sample_wise_data": [], "ppc_samples_failed": [],
                 "tot_deleterious_outliers": []}
            )

        if approximate_posterior_inference and save_generated_quantities:
            raise ValueError(
                "Variational Bayes does not support saving generated quantities, use sampling"
            )
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
                warnings.warn(
                    "Not enough memory to analyse the posterior with full MCMC draws; "
                    "approximate_posterior_analysis set to True"
                )
                approximate_posterior_analysis = True

    # ---- data prep (R/methods.R:198-238) ---------------------------------
    with timed("format input") as span:
        work = data.assign(do_check___=data[do_check].astype(bool))
        my_df = ingest.format_input(
            work, formula, sample, transcript, abundance, "do_check___",
            significance, how_many_negative_controls, span=span,
        )
    with timed("design matrix and scaling"):
        with timed("design matrix"):
            X, _x_names, x_rows = create_design_matrix(my_df, formula, sample)
            sorted_sample_names = list(x_rows[sample])

        with timed("sample scaling"):
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
        hmc_adapt_trajectory=hmc_adapt_trajectory, cores=cores, tol_rel_obj=tol_rel_obj,
        # the reference reuses the same seed for both passes
        # (R/methods.R:284, 340-341)
        seed=seed, mesh=mesh, device=device, dtype=dtype,
    )

    # the mesh, the device type and the dtype change the computation (gene
    # padding, chain counts, kernels vs plain versions, f32 vs f64
    # densities): they invalidate checkpoints like any other config change
    base_cfg = dict(
        formula=formula, approx_inf=approximate_posterior_inference,
        seed=seed, sampler=mcmc_sampler, adapt_trajectory=hmc_adapt_trajectory,
        mesh=sharding.mesh_desc(mesh), device=device.type, dtype=str(dtype),
    )

    # ---- PASS 1: discovery (R/methods.R:268-286) -------------------------
    # a checkpoint stores the table, not the fit object: with pass_fit a
    # resume would hand back no fit
    resumable1 = bool(checkpoint_dir) and not pass_fit
    fp1 = ckpt.config_fingerprint(
        my_df, which="pass1", thr=adj_prob_theshold_1,
        draws=how_many_posterior_draws_1, **base_cfg,
    ) if resumable1 else ""
    res_discovery = _resume(checkpoint_dir, "pass1", fp1) if resumable1 else None
    if res_discovery is None:
        with timed("pass 1 (discovery fit)"):
            res_discovery = do_inference(
                my_df,
                approximate_posterior_analysis=False,
                adj_prob_theshold=adj_prob_theshold_1,
                how_many_posterior_draws=how_many_posterior_draws_1,
                **common,
            )
        if resumable1:
            _save(checkpoint_dir, "pass1", res_discovery, fp1, mesh)
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
    # resume is only sound when no unserialized outputs were requested
    resumable2 = bool(checkpoint_dir) and not (
        pass_fit or save_generated_quantities or additional_parameters_to_save
    )
    fp2 = ckpt.config_fingerprint(
        my_df, which="pass2", thr=adj_prob_theshold_2,
        draws=how_many_posterior_draws_2,
        approx_analysis=approximate_posterior_analysis,
        excluded=sorted(map(tuple, to_exclude.to_numpy().tolist())),
        **base_cfg,
    ) if resumable2 else ""
    res_test = _resume(checkpoint_dir, "pass2", fp2) if resumable2 else None
    if res_test is None:
        with timed("pass 2 (truncated test fit)"):
            res_test = do_inference(
                my_df,
                approximate_posterior_analysis=approximate_posterior_analysis,
                adj_prob_theshold=adj_prob_theshold_2,
                how_many_posterior_draws=how_many_posterior_draws_2,
                to_exclude=to_exclude,
                truncation_compensation=K.TRUNCATION_COMPENSATION_PASS2,
                save_generated_quantities=save_generated_quantities,
                additional_parameters_to_save=tuple(additional_parameters_to_save),
                **common,
            )
        if resumable2:
            _save(checkpoint_dir, "pass2", res_test, fp2, mesh)

    # ---- merge (reference merge_results, R/utilities.R:539-608) ----------
    with timed("merge"):
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
            result.attrs["vb_iterations"] = (res_discovery.vb_iterations, res_test.vb_iterations)
        if res_test.additional_parameters:
            result.attrs["additional_parameters"] = res_test.additional_parameters
        if pass_fit:
            result.attrs["fit 1"] = res_discovery.fit
            result.attrs["fit 2"] = res_test.fit
    return result


def _save(checkpoint_dir: str, name: str, res: InferenceResult, fingerprint: str,
          mesh=None) -> None:
    """Persist one pass's table with what a resume needs beside it; under a
    mesh the global rank 0 writes it and every rank waits for it."""
    extra = {"total_draws": res.total_draws}
    if res.vb_iterations is not None:
        extra["vb_iterations"] = res.vb_iterations
    if mesh is None:
        ckpt.save_pass(checkpoint_dir, name, res.table, fingerprint, extra=extra)
        return
    import torch.distributed as dist

    if dist.get_rank() == 0:
        ckpt.save_pass(checkpoint_dir, name, res.table, fingerprint, extra=extra)
    dist.barrier()


def _resume(checkpoint_dir: str, name: str, fingerprint: str) -> InferenceResult | None:
    """The pass's checkpoint as an InferenceResult (no fit object), or None
    when there is none for this fingerprint."""
    table = ckpt.load_pass(checkpoint_dir, name, fingerprint)
    if table is None:
        return None
    with open(os.path.join(checkpoint_dir, "meta.json")) as f:
        meta = json.load(f)[name]
    return InferenceResult(table=table, total_draws=int(meta["total_draws"]),
                           vb_iterations=meta.get("vb_iterations"))


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
