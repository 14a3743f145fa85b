"""Simulation-based calibration (SBC) of the port's inference path: the
JAX package's suite (tests/test_calibration.py) on the port, for
tests/test_torch_calibration.py and chip_smoke.py.

Talts et al. 2018: draw parameters from the model's own prior, simulate
counts from the likelihood, fit with ADVI and then jittered HMC (as
pipeline/identify.py's MCMC branch does), and rank each true quantity among
the chains' final draws; with a correct density and sampler the ranks are
uniform on {0..N_CHAINS}. The constants, the prior simulation and the bars
are the JAX suite's, which explains each choice (the non-centered
parametrization, held-out predictive cells through `exclude_mask`, the
exact Gamma-Poisson simulation, the seed scan that keeps counts within
int32). The fits and the predictive draws use the port's own random
streams, so ranks are compared with the JAX suite's statistically, not
draw for draw.
"""

from __future__ import annotations

import time

import numpy as np
import scipy.stats
import torch

from ppcseq_tpu_torch.infer.advi import fit_advi
from ppcseq_tpu_torch.infer.hmc import run_hmc
from ppcseq_tpu_torch.model import nb_model
from ppcseq_tpu_torch.ops.nb import nb2_log_rng
from ppcseq_tpu_torch.utils.constants import LAMBDA_MU_MU
from ppcseq_tpu_torch.utils.device import resolve_device

S, G, N_CHECK = 10, 14, 5
N_REP = 20
SEED_BASE = 18_000  # scanned: max prior-predictive count 8.1e7 << int32
N_CHAINS = 64  # L = 64 -> ranks in {0..64}
N_BINS = 5  # 65 rank values / 5 bins = 13 per bin
HOLD_S = (1, 6)  # sample rows held out of the likelihood per checked gene
NUM_WARMUP, NUM_DRAWS, NUM_LEAPFROG = 600, 40, 32
NAMES = ("alpha_sub_1", "intercept", "predictive")
# replications at once on the card: each is an eager loop that the host's
# launches pace, so processes overlap on the one card
WORKERS = 6


def design():
    """(X[S, 2], exposure[S], exclude[S, G]) shared by every replication."""
    rng0 = np.random.default_rng(0)
    group = (np.arange(S) >= S // 2).astype(float)
    X = np.column_stack([np.ones(S), group])
    exposure = rng0.normal(0.0, 0.2, size=S)
    exclude = np.zeros((S, G), dtype=bool)
    for s in HOLD_S:
        exclude[s, :N_CHECK] = True
    return X, exposure, exclude


def prior_sim(rng, X, exposure):
    """One draw from the model's exact prior + likelihood (stan:210-258)."""
    lam_mu = rng.normal(LAMBDA_MU_MU, 2.0)
    lam_sig = abs(rng.normal(0.0, 2.0))  # exp-transformed ~ half-N(0,2)
    lam_skew = rng.normal(0.0, 1.0)
    sig_slope = -abs(rng.normal(0.0, 2.0))  # constrained negative
    sig_int = rng.normal(0.0, 2.0)
    sig_sig = abs(rng.normal(0.0, 2.0))
    # skew_normal(xi, omega, alpha) via the delta representation
    delta = lam_skew / np.sqrt(1.0 + lam_skew**2)
    u0, v = np.abs(rng.normal(size=G)), rng.normal(size=G)
    z = delta * u0 + np.sqrt(1.0 - delta**2) * v
    # double lambda_mu_mu shift, exactly as the joint density (stan:219)
    intercept = (lam_mu + LAMBDA_MU_MU) + lam_sig * z
    sigma_raw = rng.normal(sig_slope * intercept + sig_int, sig_sig)
    alpha1 = rng.laplace(0.0, 1.0, size=N_CHECK)
    alpha = np.zeros((2, G))
    alpha[0] = intercept
    alpha[1, :N_CHECK] = alpha1
    mu = np.exp(exposure[:, None] + X @ alpha)
    phi = np.broadcast_to(np.exp(-sigma_raw), mu.shape)
    counts = rng.poisson(rng.gamma(phi, mu / phi))
    truth = {"intercept": intercept, "alpha_sub_1": alpha1}
    return counts, truth


def tie_uniforms(rep: int) -> np.ndarray:
    """[len(HOLD_S), N_CHECK] uniforms that break replication rep's
    predictive ties: the slice of the JAX suite's one shared stream
    (default_rng(777), N_CHECK per held-out row, replication by
    replication) that it reads there."""
    return np.random.default_rng(777).random((N_REP, len(HOLD_S), N_CHECK))[rep]


def replication(rep: int, *, dtype=torch.float64, likelihood: str = "plain", device="cuda",
                num_warmup: int = NUM_WARMUP, num_draws: int = NUM_DRAWS,
                num_leapfrog: int = NUM_LEAPFROG) -> dict:
    """Replication rep of the suite: simulate, fit (ADVI warm start, then
    N_CHAINS chains of jittered HMC on the non-centered parametrization
    through flat_logp(dims, likelihood)), and rank the truth among the
    chains' final draws. Returns the ranks by name (predictive: one per
    held-out cell), the wall in seconds (the card synchronized) and what
    the fit reported."""
    device = resolve_device(device)
    X, exposure, exclude = design()
    rng = np.random.default_rng(SEED_BASE + rep)
    counts, truth = prior_sim(rng, X, exposure)
    if counts.max() >= np.iinfo(np.int32).max:
        raise ValueError(f"replication {rep}: a prior-predictive count passes int32")
    sync = torch.cuda.synchronize if torch.device(device).type == "cuda" else (lambda: None)
    sync()
    t0 = time.perf_counter()
    data, dims = nb_model.prepare_data(counts, X, exposure, N_CHECK, exclude_mask=exclude,
                                       non_centered=True, device=device, dtype=dtype)
    data = nb_model.with_baseline(data, dims)
    logp = nb_model.flat_logp(dims, likelihood)
    init = nb_model.smart_init(data, dims)
    gen = torch.Generator(device=device).manual_seed(rep)
    warm = fit_advi(logp, dims.dim, gen, data=data, init_mean=init, tol_rel_obj=0.01,
                    learning_rate=0.3, eval_every=50, grad_samples=4, device=device, dtype=dtype)
    res = run_hmc(logp, dims.dim, gen, data=data, num_chains=N_CHAINS, num_warmup=num_warmup,
                  num_draws=num_draws, num_leapfrog=num_leapfrog, init_theta=warm.mean,
                  inv_mass=torch.exp(2.0 * warm.log_sd), device=device, dtype=dtype)
    # final draw of each chain: N_CHAINS near-independent posterior samples
    thetas = res.draws[:, -1, :].double()
    con, _ = nb_model.unpack(thetas, dims)
    ranks = {}
    for name in ("alpha_sub_1", "intercept"):
        d = con[name][:, :N_CHECK].cpu().numpy()
        ranks[name] = (d < truth[name][:N_CHECK][None, :]).sum(axis=0)
    # held-out predictive ranks (the counts_rng machinery, stan:259-266),
    # the Gamma and the Poisson drawn in float64. A chain whose draw gives
    # no finite mean or dispersion (a fit gone to NaN) has no predictive
    # draw: it counts as above the truth, as its NaN parameters compare
    # false above
    eta = nb_model.lambda_log(con, data, dims) + data.exposure_rate.double()[None, :, None]
    phi = torch.exp(-con["sigma_raw"])[:, None, :]
    ok = torch.isfinite(torch.exp(eta)) & torch.isfinite(phi)
    yrep = nb2_log_rng(gen, torch.where(ok, eta, 0.0), torch.where(ok, phi, 1.0))
    yrep = torch.where(ok, yrep, torch.iinfo(torch.int64).max)
    yrep = yrep[:, :, :N_CHECK].cpu().numpy()  # [L, S, K]
    ties = tie_uniforms(rep)
    pred = []
    for h, s in enumerate(HOLD_S):
        y = counts[s, :N_CHECK]
        less = (yrep[:, s, :] < y[None, :]).sum(axis=0)
        eq = (yrep[:, s, :] == y[None, :]).sum(axis=0)
        # discrete ties broken uniformly (standard SBC practice)
        pred.append(less + (ties[h] * (eq + 1)).astype(int))
    ranks["predictive"] = np.concatenate(pred)
    sync()
    return dict(
        rep=rep, ranks=ranks, wall_s=time.perf_counter() - t0,
        advi_iterations=warm.iterations, step_size=res.step_size,
        divergences=int(res.divergences.sum()), accept_mean=float(res.accept_prob.mean()),
        num_leapfrog=res.num_leapfrog, max_count=int(counts.max()),
        draws_finite=bool(torch.isfinite(res.draws).all()),
        held_out_like_mask=data.like_mask[list(HOLD_S), :N_CHECK].cpu().numpy(),
    )


def chi2(r):
    """(chi-square statistic, bin counts) of ranks r over N_BINS bins."""
    edges = np.linspace(0, N_CHAINS + 1, N_BINS + 1)
    obs, _ = np.histogram(r, bins=edges)
    exp = len(r) / N_BINS
    return float(((obs - exp) ** 2 / exp).sum()), obs


def chi2_bar() -> float:
    """The JAX suite's bar: p ~ 1e-4 at nominal df, doubled for the
    positive correlation of ranks pooled within a replication."""
    return float(scipy.stats.chi2.isf(1e-4, df=N_BINS - 1) * 2.0)


def extreme_share(r) -> float:
    """The share of ranks at 0 or N_CHAINS (truth outside every draw)."""
    r = np.asarray(r)
    return float(np.mean((r == 0) | (r == N_CHAINS)))


def pooled(reps: list[dict]) -> dict:
    """The ranks of several replications, concatenated by name in
    replication order, and their statistics against the suite's bars."""
    ranks = {k: np.concatenate([r["ranks"][k] for r in reps]) for k in NAMES}
    stats = {}
    for k in NAMES:
        c2, obs = chi2(ranks[k])
        stats[k] = dict(chi2=c2, bins=obs.tolist(), extreme=extreme_share(ranks[k]))
    return dict(ranks=ranks, stats=stats, bar=chi2_bar(), n_rep=len(reps),
                wall_s=[r["wall_s"] for r in reps])


def _replication_on_the_card(job):
    rep, dtype, likelihood = job
    torch.set_num_threads(1)
    return replication(rep, dtype=dtype, likelihood=likelihood, device="cuda")


def suite(dtype=torch.float64, likelihood: str = "plain", n_rep: int = N_REP) -> dict:
    """Every replication on the card, pooled (the JAX suite's module
    fixture). The replications are independent (each seeds its own
    generators from its index), so they run WORKERS at a time in spawned
    processes; `suite_wall_s` is the whole suite's wall."""
    import multiprocessing

    from ppcseq_tpu_torch.ops import nb_kernel

    resolve_device("cuda")
    nb_kernel.build_all()  # once, before the workers load the libraries
    t0 = time.perf_counter()
    with multiprocessing.get_context("spawn").Pool(min(WORKERS, n_rep)) as pool:
        reps = pool.map(_replication_on_the_card,
                        [(rep, dtype, likelihood) for rep in range(n_rep)], chunksize=1)
    return dict(pooled(reps), suite_wall_s=time.perf_counter() - t0, workers=WORKERS,
                step_size=[r["step_size"] for r in reps],
                divergences=[r["divergences"] for r in reps],
                advi_iterations=[r["advi_iterations"] for r in reps])


def passes(result: dict) -> bool:
    """Whether pooled ranks meet both of the suite's bars."""
    st = result["stats"]
    return (all(st[k]["chi2"] < result["bar"] for k in NAMES)
            and all(st[k]["extreme"] < 0.15 for k in ("predictive", "alpha_sub_1")))
