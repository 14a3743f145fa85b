"""Smoke run of the PyTorch + CUDA port on one NVIDIA GPU.

    python3 chip_smoke.py

Phases (each prints lines starting with "phase <name>"; any failure raises,
so the exit code is non-zero):
  1. probe   library, compiler and card versions
  2. build   nvcc-build the three kernel sources from csrc/, in parallel
             (timed)
  3. host    the native host runtime (ppcseq_tpu_torch/_native.py: the C++
             pivot and TMM, built with the host compiler; build seconds and
             whether it was built already), then TMM at phase cli's 50,000 x
             100 cohort on this host: the native factors against the NumPy
             version's (rtol 1e-12), each timed, with the host CPU's model
             name (lscpu) and core count
  4. kernel  the five kernels (K1-K5) against their plain torch versions on
             the card, in float32, at (B, S, G) = (1, 21, 515) and
             (128, 21, 515) on the bundled cohort (15 checked genes + 500
             controls) and (8, 100, 50000) on the synthetic scale cohort;
             K1 and K2 also value-only at (100, 21, 515) (the ELBO) and at
             (1, 100, 600) (the ADVI step of the 50k cohort's checked genes
             + 500 controls); K1 at the command line's 50k batch shapes, the
             ADVI step (1, 100, 50000) with gradients and the ELBO
             (100, 100, 50000) value-only (its plain versions run in chunks
             of rows of B there, to bound memory), and at phase mesh's
             genes=2 shard of it, (1, 100, 25000) and (100, 100, 25000).
             Value rtol 2e-5, gradient |d|/(1+|g|) < 1e-4; for K3's
             gradients, where the plain version itself is further than
             1e-4 from its float64 evaluation, the tolerance of
             tests/test_nb_kernel.py and a bound on the kernel's own error
             against float64 (_GRAD_FALLBACK). K5 is one gradient call of
             the stable form: its value and gradients in one launch.
             Exactly zero gradients for a masked gene. Per row:
             device_us (device time per call: torch.profiler over many
             back-to-back calls, or CUDA events around them where two
             profiler sessions record no kernel; device_us_source says
             which), cuda_kernels_per_call (1 for K1-K5),
             layout (nb_kernel.layout's T, BY, SY, SC), call_ms (median
             CUDA events around one call: what a caller waits), plain_ms,
             and bytes, ops, bound_us, bound_by, share_of_bound
             (= bound_us / device_us) from nb_kernel.work() on this run's
             branch shares.
  4b. forms  the "analytic" and "fused" likelihood forms (masked_likelihood
             with the closed-form gradients of ops/nb_grad; torch ops, no
             kernel of their own) in float32 at (1, 21, 515), (128, 21, 515)
             and (8, 100, 50000), with and without a baseline: value
             against masked_likelihood in float64 (rtol 2e-5), gradients
             against likelihood_grads in float32 (|d|/(1+|g|) < 1e-4) and
             their error against float64; ms of a value + gradient call and
             of a no_grad value, beside "plain" (masked_likelihood under
             autograd).
  5. hmc     jittered HMC at full width: (a) bench.py's configuration
             (bundled cohort, no baseline, so flat_logp(dims) runs K2; ADVI
             warm start, 128 chains, warmup 30, L=48, 83 draws per chain;
             divergences <= 2%); (b) scripts/bench_scale.py's (50,000 x 100
             synthetic cohort with a baseline, 8 chains, warmup 100, L=32,
             125 draws per chain) once through "pallas" (K5 at every
             gradient, K4 in the ADVI warm start's no_grad ELBO) and once
             through "pallas_fused" (K3), each row with the device's busy
             share over a short profiled window of leapfrogs after it; the
             adapted step size must be >= 1e-2 (the float64 log joint and
             energies). Then the log joint at 8 draws of each (b) run
             through K1, K2, K3 and K4, against each route's plain version
             in float64. (c) ChEES trajectory adaptation at (a)'s
             configuration (L=48 the cap; divergences <= 2%).
  6. nuts    NUTS at scripts/baseline_cpu.py's full width: the bundled
             cohort, no baseline (K2), D = 1051, 4 chains, warmup 150,
             NUTS_DRAWS draws per chain, max_depth 10, from the ADVI warm
             start's mean and variances as the pipeline's NUTS branch
             starts; divergences <= 2%, rhat_max < 1.1; the row has the
             chains' own and the lockstep leapfrogs, the host syncs, the
             mean tree depth and the device's busy share over a short
             profiled window. nuts-tree: the same run (generator, warm
             start) with the model's tree as run_nuts's prototype
             (smart_init(as_tree=True), dims=, tree_logp(dims)), cut to
             NUTS_TREE_DRAWS draws: after tree_to_theta its draws must be
             the flat run's first NUTS_TREE_DRAWS draws bit for bit
             (SHA-256 of the bytes).
  6b. sbc1   replication 0 of the SBC suite (ppcseq_tpu_torch/utils/sbc.py,
             tests/test_torch_calibration.py) at its full constants in
             float64 through "plain": S=10, G=14, 64 chains, warmup 600, 40
             draws, L=32; its wall and ranks (finite draws, ranks in
             {0..64}, held-out cells out of the likelihood).
  7. e2e     identify_outliers on the bundled data: the reference's 3-gene
             case on both VB CI paths and on the HMC, ChEES and NUTS
             branches (calls must be SLC16A12 0, CYP1A1 1, ART3 0), and the
             15-gene README configuration (CYP1A1 and LYZ must be called).
  8. cli     the product surface: (1) the command line
             (ppcseq_tpu_torch.cli.main) on scripts/bench_pipeline_scale.py's
             50,000 x 100 synthetic cohort read from parquet (VB, the
             approximated CI, 49,900 controls: the fit covers every gene)
             with a checkpoint directory, then the same command again: the
             cold run must give 100 finite rows and flag at least half of
             the injected outlier cells, the resume must launch no kernel
             and write byte-identical CSVs; each row has the wall, the
             pipeline's stage times (utils/log), the peak device memory,
             the K1 launches and the VB iterations of each pass (host prep
             runs the native pivot and TMM). (2)
             `python -m ppcseq_tpu_torch` in a subprocess on the 15-gene
             README configuration with --json (and --plots where matplotlib
             is installed): CYP1A1 and LYZ called, one PNG per transcript.
             (3) the HMC branch on the 3-gene case with the exact CI,
             save_generated_quantities and additional_parameters_to_save:
             calls (0, 1, 0), a generated-quantities frame with values >= 0
             on every point, sigma = exp(-sigma_raw).
  9. mesh    identify_outliers(mesh=) and the sharded samplers, each run
             as ranks of `torch.distributed.run` (torchrun) on the one card
             (gloo between ranks on one card, each CUDA buffer staged
             through the host; NCCL for a world of one), every rank running
             `python3 chip_smoke.py --mesh-rank CASE`: (a) the command line
             (cli.main, as `-m ppcseq_tpu_torch` runs it) on phase cli's
             50,000 x 100 cohort with --mesh genes=2 (VB, the approximated
             CI): every rank launches K1 at (B, 100, 25000) only, one
             all-reduce per log-density evaluation, at least half the
             injected cells flagged, finite bounds, and at most 2 of the
             10,000 checked cells called otherwise than by the unsharded
             command on the same table (run in this process before it);
             (b) genes=1 under NCCL, the 3-gene case on VB; (c) chains=2,
             the 3-gene case on jittered HMC, divergences <= 2%; (b) and
             (c) give (0, 1, 0); (d) chains=2,genes=2 (4 ranks), the MCMC
             branch on synthetic_tidy(64 genes, 8 samples, 3 checked), each
             rank's gene range printed; (e) run_hmc_tree at genes=2 on
             bench_scale.py's 50,000 x 100 cohort after a gene-sharded ADVI
             warm start, 8 chains, warmup 100, L=32, 25 draws per chain,
             adapted step size >= 1e-2; (f) chains=2, the 3-gene case on
             ChEES (its chain statistics all-reduced), (0, 1, 0). Every
             rank's K1 launches are a path of the `kernels` line.
 10. dtype   the float64 path: identify_outliers(dtype=torch.float64) on
             the card, through the float64 forms of K1 and K2
             (csrc/nb_glm_fast64.cu). (a) Each form against its plain
             version (nb_fast in float64 on the card) at A (1, 21, 515), H
             (128, 21, 515), Z (8, 100, 50000) and V (1, 100, 50000) with
             gradients and W (100, 100, 50000) value-only: value rtol 1e-10,
             gradients |d|/(1+|g|) < 1e-10; rows as phase kernel's, the
             bound on the card's FP64 peak. (b) The 3-gene case at float64
             on both VB CI paths: (0, 1, 0), the float64 form of K1 the only
             kernel launched. (c) The 15-gene README configuration in
             float32 and in float64: both walls and the (transcript,
             sample) calls that differ; CYP1A1 and LYZ called in both. (d)
             Phase cli's 50k x 100 table at float64 once, with the command
             line's arguments (in the cli child, after phase cli): wall,
             peak device memory, launches, injected cells flagged (at least
             half) and the calls that differ from the command line's cold
             float32 run. (e) A short float64 HMC run of flat_logp(dims)
             without a baseline (the float64 form of K2 only). (b), (c) and
             (e) run in the parent after phase e2e, beside the children; (a)
             after the children have ended, with the card to itself.
Phases nuts, nuts-tree and sbc1, the e2e NUTS row and phase cli run in
five child processes of this script on the same card (`--child nuts`,
`--child nuts-tree`, `--child sbc1`, `--child e2e-nuts`, `--child cli`),
started after phases kernel and forms, beside the parent's phases hmc and
e2e;
phase mesh runs in a fourth (`--child mesh`), started when the cli child
has ended (both are mostly host work at 50k). The parent waits for them,
echoes their rows and fails if any failed. Each path runs with the kernel
launch counts of its process set to 0 just before it and read just after;
every kernel of the path must have launched. Then the card's name and
power limit, a JSON line describing the kernels (with each kernel's
launches on every path), and, last, {"ok": true, "device": {...}}.

With no CUDA device it exits non-zero at once and prints no result.
"""

from __future__ import annotations

import dataclasses
import json
import os
import re
import statistics
import sys
import time

import numpy as np

SOURCE_DIR = "ppcseq_tpu_torch/csrc/"


def _fail(msg: str) -> None:
    print(f"chip_smoke: {msg}", file=sys.stderr)
    sys.exit(1)


def _time_ms(fn, reps: int = 30, warmup: int = 3) -> float:
    """Median CUDA-event time of fn() in milliseconds, after warm-up."""
    import torch

    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    pairs = []
    for _ in range(reps):
        a, b = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        a.record()
        fn()
        b.record()
        pairs.append((a, b))
    torch.cuda.synchronize()
    return statistics.median(a.elapsed_time(b) for a, b in pairs)


def _device_us(fn, calls: int, sessions: int = 2):
    """(device µs per call, CUDA kernels per call, kernel records per call,
    source) of fn(), which launches each of its CUDA kernels once: under
    torch.profiler over `calls` back-to-back calls, the sum over the
    distinct kernels of each one's mean self device time. (The profiler may
    drop some kernel records, ~10% in one H100 run, so the records per call
    can fall below the kernels per call; a mean is robust to that.) In one
    H100 run a session recorded no kernel at all: then a fresh session is
    tried, and after `sessions` empty ones the time is read from CUDA
    events around the `calls` calls instead, the kernels per call from
    ops/nb_kernel's launch counts and the records per call as None. That
    time is an upper bound: where a kernel is shorter than the host's
    launch interval, it is the interval."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    from ppcseq_tpu_torch.ops import nb_kernel

    fn()
    torch.cuda.synchronize()
    for _ in range(sessions):
        with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
            for _ in range(calls):
                fn()
            torch.cuda.synchronize()
        kernels = [e for e in prof.key_averages() if e.device_type.name == "CUDA" and e.count]
        dev_us = sum(e.self_device_time_total / e.count for e in kernels)
        if dev_us > 0:
            return dev_us, len(kernels), sum(e.count for e in kernels) / calls, "torch.profiler"
        print(f"chip_smoke: torch.profiler recorded no device time over {calls} calls",
              file=sys.stderr, flush=True)
    launched = sum(nb_kernel.LAUNCHES.values())
    a, b = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    a.record()
    for _ in range(calls):
        fn()
    b.record()
    torch.cuda.synchronize()
    n_cuda = (sum(nb_kernel.LAUNCHES.values()) - launched) / calls
    return a.elapsed_time(b) * 1e3 / calls, n_cuda, None, "cuda events"


def _np(t):
    return t.double().cpu().numpy()


def _errors(got, want):
    """(max relative error of the value, max gradient |d|/(1+|g|), max
    absolute error) between two (value, dalpha, dlog_phi) tuples; the
    gradients may be absent."""
    g = [_np(t) for t in got]
    w = [_np(t) for t in want]
    value = float(np.max(np.abs(g[0] - w[0]) / np.abs(w[0])))
    grad = max((float(np.max(np.abs(a - b) / (1.0 + np.abs(b)))) for a, b in zip(g[1:], w[1:])),
               default=0.0)
    return value, grad, max(float(np.max(np.abs(a - b))) for a, b in zip(g, w))


def _within(got, want, rtol, atol):
    """Gradients within assert_allclose's |got - want| <= atol + rtol |want|."""
    return all(bool(np.all(np.abs(_np(a) - _np(b)) <= atol(_np(b)) + rtol * np.abs(_np(b))))
               for a, b in zip(got[1:], want[1:]))


# K3 computes the gradient at another d than its plain version (d0 + dlo).
# Where the plain float32 gradient is itself 1e-4 or more from float64 (so
# the strict limit is below what float32 resolves), its gradients are held
# instead at tests/test_nb_kernel.py's tolerances for it, (rtol,
# atol(want)), AND its own |d|/(1+|g|) from float64 may be at most the
# stated multiple of the plain version's (measured on the H100: 1.2x).
# Values have no such fallback: every kernel meets rtol 2e-5.
_GRAD_FALLBACK = {
    "nb_glm_fused": (2e-3, lambda w: 2e-3 * (1.0 + np.abs(w).max()), 2.0),
}


def _bundled_prep(counts_df, check_genes, controls):
    """Host prep of identify_outliers for one configuration: the model data
    arrays (ingest.ModelData)."""
    from ppcseq_tpu_torch.data import ingest
    from ppcseq_tpu_torch.formula.design import create_design_matrix
    from ppcseq_tpu_torch.norm.tmm import sample_scaling

    work = counts_df.assign(do_check___=counts_df.symbol.isin(check_genes))
    my_df = ingest.format_input(
        work, "~ Label", "sample", "symbol", "value", "do_check___", "PValue", controls
    )
    X, _, rows = create_design_matrix(my_df, "~ Label", "sample")
    scal = sample_scaling(my_df, "sample", "symbol", "value")
    return ingest.build_model_data(
        my_df, "sample", "symbol", "value", "do_check___", X,
        list(rows["sample"]), dict(zip(scal["sample"], scal["exposure_rate"])),
    )


def _kernel_case(counts, X, exposure, n_check, B, seed, device, dtype=None):
    """Model data on the card (float32 unless `dtype` says otherwise) with
    one fully masked gene and ~2% excluded points, and B parameter rows
    around the smart-init point."""
    import torch

    from ppcseq_tpu_torch.model import nb_model

    dtype = dtype or torch.float32
    rng = np.random.default_rng(seed)
    S, G = counts.shape
    exclude = rng.uniform(size=(S, G)) < 0.02
    masked_gene = G - 1
    exclude[:, masked_gene] = True
    data, dims = nb_model.prepare_data(
        counts, X, exposure, n_check, exclude_mask=exclude, device=device, dtype=dtype
    )
    data = nb_model.with_baseline(data, dims)
    theta0 = nb_model.smart_init(data, dims)
    theta = theta0[None, :] + 0.05 * rng.standard_normal((B, dims.dim))
    params, _ = nb_model.unpack(torch.as_tensor(theta, dtype=dtype, device=device), dims)
    alpha = nb_model.make_alpha(params, dims).contiguous()
    log_phi = (-params["sigma_raw"]).contiguous()
    return data, alpha, log_phi, masked_gene


PLAIN_CHUNK_POINTS = 5e7  # (b, s, g) points per call of a plain version


def _in_chunks(fn, a, p, rows):
    """fn(alpha, log_phi) -> tuple over the leading B, `rows` rows of B at a
    time (every output is per b)."""
    import torch

    if len(a) <= rows:
        return fn(a, p)
    parts = [fn(a[i:i + rows], p[i:i + rows]) for i in range(0, len(a), rows)]
    return tuple(torch.cat(ts) for ts in zip(*parts))


def _calls(data, alpha, log_phi, grads=True):
    """kernel name -> (kernel call, plain call), each returning
    (value,) or (value, dalpha, dlog_phi) for the given inputs. With
    grads=False, K1 and K2 run their value-only instantiation. K1's and K2's
    plain versions take at most PLAIN_CHUNK_POINTS points per call. On
    float64 inputs K1 and K2 are their float64 forms."""
    from ppcseq_tpu_torch.model import nb_model
    from ppcseq_tpu_torch.ops import nb_fast, nb_grad, nb_kernel

    S, G = data.counts.shape
    rows = max(1, int(PLAIN_CHUNK_POINTS // (S * G)))

    def tup(t):
        return t if isinstance(t, tuple) else (t,)

    def bind(d, a, p):
        return {
            "nb_glm_delta": (
                lambda: tup(nb_kernel.launch_delta(d.X, d.counts, d.like_mask, d.d0, a, d.alpha0,
                                                   p, d.sigma_raw0, want_grads=grads,
                                                   sp_d0=d.sp_d0, sig_neg_d0=d.sig_neg_d0,
                                                   y_sp0=d.y_sp0)),
                lambda: _in_chunks(lambda a_, p_: tup(nb_fast.glm_delta(
                    d.X, d.counts, d.like_mask, d.alpha0, d.sigma_raw0, d.d0, d.sp_d0,
                    d.sig_neg_d0, d.y_sp0, a_, p_, grads)), a, p, rows)),
            "nb_glm_plain": (
                lambda: tup(nb_kernel.launch_plain(d.X, d.exposure_rate, d.counts, d.like_mask,
                                                   a, p, want_grads=grads)),
                lambda: _in_chunks(lambda a_, p_: tup(nb_fast.glm_plain(
                    d.X, d.exposure_rate, d.counts, d.like_mask, a_, p_, grads)), a, p, rows)),
            "nb_glm_fused": (
                lambda: nb_kernel.launch_fused(d.X, d.counts, d.like_mask, d.d0, a, d.alpha0, p,
                                               d.sigma_raw0, want_grads=True),
                lambda: (nb_model.delta_likelihood(d, a, p), *nb_grad.likelihood_grads(
                    d.X, d.exposure_rate, d.counts, d.like_mask, a, p))),
            "nb_glm_stable_fwd": (
                lambda: (nb_kernel.launch_stable_fwd(d.X, d.exposure_rate, d.counts,
                                                     d.like_mask, a, p),),
                lambda: (nb_model.stable_likelihood(d, a, p),)),
            "nb_glm_stable_bwd": (
                lambda: nb_kernel.launch_stable_bwd(d.X, d.exposure_rate, d.counts, d.like_mask,
                                                    a, p),
                lambda: (nb_model.stable_likelihood(d, a, p), *nb_grad.likelihood_grads(
                    d.X, d.exposure_rate, d.counts, d.like_mask, a, p))),
        }

    d64 = dataclasses.replace(data, **{
        f.name: getattr(data, f.name).double() for f in dataclasses.fields(data)
        if f.name != "host" and getattr(data, f.name) is not None
        and getattr(data, f.name).is_floating_point()})
    return bind(data, alpha, log_phi), bind(d64, alpha.double(), log_phi.double())


def phase_kernel(counts_df, device):
    import torch

    from ppcseq_tpu_torch.ops import nb_kernel
    from ppcseq_tpu_torch.utils.synthetic import synthetic_cohort

    fifteen = sorted(counts_df.loc[counts_df.FDR < 0.01, "symbol"].unique())
    md = _bundled_prep(counts_df, fifteen, 500)
    bundled = (md.counts, md.X, md.exposure_rate, md.n_check)
    c600, X600, e600, _ = synthetic_cohort(n_genes=600, n_samples=100, n_check=100, seed=0)
    c50k, X50k, e50k, _ = synthetic_cohort(n_genes=50000, n_samples=100, n_check=100, seed=0)
    k12 = ["nb_glm_delta", "nb_glm_plain"]
    # (B, cohort, kernels (None: all five), gradients): the ADVI step, the
    # 100-sample value-only ELBO and the bench HMC on the bundled cohort; the
    # ADVI step of the 50k x 100 pipeline cohort (its checked genes + 500
    # controls); the scale HMC; the ADVI step and the ELBO of the command
    # line's 50k batch run (every gene in the fit), and both at phase mesh's
    # genes=2 shard of it
    z = (c50k, X50k, e50k, 100)
    shard = (np.ascontiguousarray(c50k[:, :25000]), X50k, e50k, 100)  # genes=2, rank 0
    cases = [(1, bundled, None, True), (100, bundled, k12, False), (128, bundled, None, True),
             (1, (c600, X600, e600, 100), k12, True), (8, z, None, True),
             (1, z, ["nb_glm_delta"], True), (100, z, ["nb_glm_delta"], False),
             (1, shard, ["nb_glm_delta"], True), (100, shard, ["nb_glm_delta"], False)]

    rows = []
    for B, (counts, X, exposure, n_check), names, grads in cases:
        data, alpha, log_phi, g_m = _kernel_case(counts, X, exposure, n_check, B, 7, device)
        S, G = data.counts.shape
        C = data.X.shape[1]
        shares = nb_kernel.branch_shares(data, alpha, log_phi)
        calls, calls64 = _calls(data, alpha, log_phi, grads)
        for name, (kern_fn, plain_fn) in calls.items():
            if names is not None and name not in names:
                continue
            kern, plain, plain64 = kern_fn(), plain_fn(), calls64[name][1]()
            torch.cuda.synchronize()
            val_rel, grad_err, mabs = _errors(kern, plain)
            k64 = _errors(kern, plain64)[:2]
            p64 = _errors(plain, plain64)[:2]
            value_ok = val_rel < 2e-5 and kern[0].dtype == plain[0].dtype == torch.float64
            grad_limit = "strict"
            if grad_err >= 1e-4:
                grad_limit = None
                if name in _GRAD_FALLBACK and p64[1] >= 1e-4:
                    g_rtol, g_atol, multiple = _GRAD_FALLBACK[name]
                    if _within(kern, plain, g_rtol, g_atol) and k64[1] <= multiple * p64[1]:
                        grad_limit = f"test_nb_kernel and <= {multiple}x plain vs f64"
            zero = len(kern) == 1 or bool((kern[1][:, :, g_m] == 0).all()
                                          and (kern[2][:, g_m] == 0).all())
            finite = all(bool(torch.isfinite(t).all()) for t in kern)
            ok = value_ok and grad_limit is not None and zero and finite
            t_k = _time_ms(kern_fn, reps=20)
            t_p = _time_ms(plain_fn, reps=10 if G > 1000 else 20)
            reps = 20 if G > 1000 else 200
            dev_us, n_cuda, n_records, dev_source = _device_us(kern_fn, reps)
            w = nb_kernel.work(name, B, S, C, G, want_grads=grads, shares=shares)
            lay = {k: v for k, v in nb_kernel.layout(name, B, S, C, G, grads).items()
                   if k in ("T", "BY", "SY", "SC")}
            row = dict(kernel=name, B=B, S=S, G=G, grads=grads, layout=lay,
                       value_dtype=str(kern[0].dtype), value_rel_err=val_rel,
                       grad_err=grad_err, max_abs_err=mabs,
                       kernel_vs_f64=k64, plain_vs_f64=p64,
                       grad_limit=grad_limit, masked_gene_zero_grad=zero,
                       finite=finite, device_us=dev_us, device_us_source=dev_source,
                       cuda_kernels_per_call=n_cuda,
                       kernel_records_per_call=n_records,
                       call_ms=t_k, plain_ms=t_p, bytes=w["bytes"], ops=w["ops"],
                       bound_us=w["bound_us"], bound_by=w["bound_by"],
                       share_of_bound=w["bound_us"] / dev_us,
                       kernel_points_per_s=B * S * G / (dev_us * 1e-6), branch_shares=shares)
            print("phase kernel " + json.dumps(row), flush=True)
            if not ok:
                raise AssertionError(f"{name} disagrees with its plain version at B={B}, S={S}, "
                                     f"G={G}: {row}")
            rows.append(row)
        del data, alpha, log_phi, calls, calls64
        torch.cuda.empty_cache()
    return rows


def phase_forms(counts_df, device):
    """(i) The "analytic" and "fused" likelihood forms (nb_model.
    analytic_likelihood, fused_likelihood: masked_likelihood with the
    closed-form gradients of ops/nb_grad, torch ops on the card, no kernel
    of their own) in float32 at A, H and Z, with and without a baseline,
    beside "plain" (masked_likelihood under autograd): the value against
    masked_likelihood in float64 (rtol 2e-5), the gradients against
    likelihood_grads in float32 (|d|/(1+|g|) < 1e-4, as phase kernel holds
    the kernels to their plain versions) and their error against float64
    recorded; ms = median CUDA events around one value + gradient call,
    value_ms around one no_grad value."""
    import torch

    from ppcseq_tpu_torch.model import nb_model
    from ppcseq_tpu_torch.ops import nb_grad
    from ppcseq_tpu_torch.utils.synthetic import synthetic_cohort

    fifteen = sorted(counts_df.loc[counts_df.FDR < 0.01, "symbol"].unique())
    md = _bundled_prep(counts_df, fifteen, 500)
    bundled = (md.counts, md.X, md.exposure_rate, md.n_check)
    z = synthetic_cohort(n_genes=50000, n_samples=100, n_check=100, seed=0)[:3] + (100,)
    forms = {"analytic": nb_model.analytic_likelihood, "fused": nb_model.fused_likelihood,
             "plain": nb_model.masked_likelihood}
    rows = []
    for shape, B, cohort in (("A", 1, bundled), ("H", 128, bundled), ("Z", 8, z)):
        base, alpha, log_phi, _ = _kernel_case(*cohort, B, 7, device)
        for baseline in (True, False):
            d = base if baseline else _strip_baseline(base)
            d64 = dataclasses.replace(d, **{
                f.name: getattr(d, f.name).double() for f in dataclasses.fields(d)
                if f.name != "host" and getattr(d, f.name) is not None
                and getattr(d, f.name).is_floating_point()})
            a64, p64 = alpha.double(), log_phi.double()
            want64 = (nb_model.masked_likelihood(d64, a64, p64),
                      *nb_grad.likelihood_grads(d64.X, d64.exposure_rate, d64.counts,
                                                d64.like_mask, a64, p64))
            closed32 = nb_grad.likelihood_grads(d.X, d.exposure_rate, d.counts, d.like_mask,
                                                alpha, log_phi)
            for name, fn in forms.items():
                def call(fn=fn, d=d):
                    a = alpha.detach().requires_grad_(True)
                    p = log_phi.detach().requires_grad_(True)
                    v = fn(d, a, p)
                    return (v.detach(), *torch.autograd.grad(v.sum(), (a, p)))

                got = call()
                torch.cuda.synchronize()
                value_rel, grad_vs_f64, _ = _errors(got, want64)
                grad_err = _errors((want64[0], *got[1:]), (want64[0], *closed32))[1]
                with torch.no_grad():
                    value_ms = _time_ms(lambda fn=fn, d=d: fn(d, alpha, log_phi), reps=10)
                row = dict(form=name, shape=shape, B=B, S=d.counts.shape[0],
                           G=d.counts.shape[1], baseline=baseline, value_rel_err_vs_f64=value_rel,
                           grad_err_vs_f32_closed_form=grad_err, grad_err_vs_f64=grad_vs_f64,
                           finite=all(bool(torch.isfinite(t).all()) for t in got),
                           ms=_time_ms(call, reps=10), value_ms=value_ms)
                print("phase forms " + json.dumps(row), flush=True)
                gated = name != "plain"  # "plain" is autograd: its gradient is beside them
                if not (row["finite"] and value_rel < 2e-5 and (grad_err < 1e-4 or not gated)):
                    raise AssertionError(f"form {name} disagrees at {shape}: {row}")
                rows.append(row)
        del base, alpha, log_phi
        torch.cuda.empty_cache()
    return rows


PATH_LAUNCHES: dict = {}  # path name -> kernel launch counts of its run


def _run_path(name, fn, expect):
    """Run fn() with the launch counts zeroed before and read after; every
    kernel in `expect` must have launched. Returns (result, counts)."""
    import torch

    from ppcseq_tpu_torch.ops import nb_kernel

    torch.cuda.synchronize()
    nb_kernel.reset_launches()
    out = fn()
    torch.cuda.synchronize()
    counts = dict(nb_kernel.LAUNCHES)
    PATH_LAUNCHES[name] = counts
    print(f"phase {name} launches " + json.dumps(counts), flush=True)
    missing = [k for k in expect if counts[k] <= 0]
    if missing:
        raise AssertionError(f"{name}: kernels {missing} never launched")
    return out, counts


def _warm_start(logp, data, dims, gen, device):
    """The pipeline's ADVI warm start (pipeline/identify._mcmc_fit)."""
    from ppcseq_tpu_torch.infer.advi import fit_advi
    from ppcseq_tpu_torch.model import nb_model

    return fit_advi(lambda th: logp(th, data), dims.dim, gen,
                    init_mean=nb_model.smart_init(data, dims), tol_rel_obj=0.01,
                    learning_rate=0.3, eval_every=50, grad_samples=4, device=device)


def _hmc_run(data, dims, likelihood, *, chains, warmup, draws, L, seed, device,
             adapt_trajectory=False):
    """ADVI warm start + run_hmc through flat_logp(dims, likelihood), timed."""
    import torch

    from ppcseq_tpu_torch.infer.hmc import run_hmc
    from ppcseq_tpu_torch.model import nb_model

    logp = nb_model.flat_logp(dims, likelihood)
    gen = torch.Generator(device=device).manual_seed(seed)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    warm = _warm_start(logp, data, dims, gen, device)
    torch.cuda.synchronize()
    t1 = time.perf_counter()
    res = run_hmc(logp, dims.dim, gen, data=data, num_chains=chains, num_warmup=warmup,
                  num_draws=draws, num_leapfrog=L, init_theta=warm.mean,
                  inv_mass=torch.exp(2.0 * warm.log_sd), adapt_trajectory=adapt_trajectory,
                  device=device)
    torch.cuda.synchronize()
    t2 = time.perf_counter()
    total = chains * draws
    row = dict(likelihood=likelihood, S=dims.S, G=dims.G, D=dims.dim, chains=chains,
               warmup=warmup, draws_per_chain=draws, L=L, advi_iterations=warm.iterations,
               warm_log_sd_quantiles=torch.quantile(
                   warm.log_sd.double().cpu(), torch.tensor([0.0, 0.5, 1.0], dtype=torch.float64)
               ).tolist(),
               advi_s=t1 - t0, hmc_s=t2 - t1, wall_s=t2 - t0,
               draws_per_s=total / (t2 - t0), hmc_draws_per_s=total / (t2 - t1),
               leapfrogs_per_s=res.num_leapfrog / (t2 - t1),
               leapfrog_steps=res.num_leapfrog, divergences=int(res.divergences.sum()),
               divergence_frac=float(res.divergences.sum()) / total,
               mean_accept=float(res.accept_prob.mean()), step_size=res.step_size,
               trajectory_length=res.trajectory_length,
               draws_finite=bool(torch.isfinite(res.draws).all()))
    return res, row


def _busy_window(data, dims, likelihood, device, window=None):
    """The device's busy share over a short run through flat_logp(dims,
    likelihood), by default HMC (8 chains, 4 + 4 iterations of 8
    leapfrogs), after one unprofiled run: the CUDA kernels' device time
    (torch.profiler, CUDA activity only) over the window's wall."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    from ppcseq_tpu_torch.infer.hmc import run_hmc
    from ppcseq_tpu_torch.model import nb_model

    logp = nb_model.flat_logp(dims, likelihood)
    gen = torch.Generator(device=device).manual_seed(2)
    init = nb_model.smart_init(data, dims)

    if window is None:
        def window():
            return run_hmc(logp, dims.dim, gen, data=data, num_chains=8, num_warmup=4,
                           num_draws=4, num_leapfrog=8, init_theta=init, device=device)

    window()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        res = window()
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
    busy = sum(e.self_device_time_total for e in prof.key_averages()
               if e.device_type.name == "CUDA") * 1e-6
    if busy <= 0:  # the session recorded no kernel (_device_us): not measured
        print("chip_smoke: torch.profiler recorded no device time in the busy window",
              file=sys.stderr, flush=True)
        busy = None
    return dict(window_leapfrogs=res.num_leapfrog, window_wall_s=wall, window_device_s=busy,
                device_busy_share=None if busy is None else busy / wall)


def _strip_baseline(data):
    return dataclasses.replace(data, alpha0=None, sigma_raw0=None, d0=None, sp_d0=None,
                               sig_neg_d0=None, y_sp0=None)


def _density_check(data, dims, thetas, device):
    """Log joint at thetas[n, D] through K1, K2, K3 and K4, each against its
    route's plain version in float64 (one draw at a time, to bound memory)
    and beside the plain version in float32."""
    import torch

    from ppcseq_tpu_torch.model import nb_model
    from ppcseq_tpu_torch.ops import nb_fast, nb_kernel

    bare = _strip_baseline(data)
    bare64 = nb_model.upload(data.host, device, torch.float64)
    base64 = nb_model.with_baseline(bare64, dims)

    def glm_delta(d, a, p):
        return nb_fast.glm_delta(d.X, d.counts, d.like_mask, d.alpha0, d.sigma_raw0, d.d0,
                                 d.sp_d0, d.sig_neg_d0, d.y_sp0, a, p, False)

    def glm_plain(d, a, p):
        return nb_fast.glm_plain(d.X, d.exposure_rate, d.counts, d.like_mask, a, p, False)

    # route -> (kernel entry, kernel its path must launch, plain version,
    #           f32 data, f64 data, relative tolerance of tests/test_nb_kernel.py)
    routes = {
        "K1 fast": (nb_kernel.nb_glm_likelihood_fast, "nb_glm_delta", glm_delta, data, base64,
                    2e-5),
        "K2 fast, no baseline": (nb_kernel.nb_glm_likelihood_fast, "nb_glm_plain", glm_plain,
                                 bare, bare64, 2e-5),
        "K3 pallas_fused": (nb_kernel.nb_glm_likelihood_fused, "nb_glm_fused",
                            nb_model.delta_likelihood, data, base64, 3e-4),
        "K4 pallas": (nb_kernel.nb_glm_likelihood, "nb_glm_stable_fwd",
                      nb_model.stable_likelihood, bare, bare64, 2e-4),
    }
    with torch.no_grad():
        for name, (entry, kernel, plain, d32, d64, rtol) in routes.items():
            t32 = thetas.float()
            got, _ = _run_path(f"hmc density {name}",
                               lambda: nb_model.log_joint(t32, d32, dims, likelihood_fn=entry),
                               [kernel])
            plain32 = torch.cat([nb_model.log_joint(t32[i:i + 1], d32, dims, likelihood_fn=plain)
                                 for i in range(len(t32))])
            want = torch.cat([nb_model.log_joint(thetas[i:i + 1].double(), d64, dims,
                                                 likelihood_fn=plain)
                              for i in range(len(thetas))])
            err = float(((got.double() - want).abs() / want.abs()).max())
            err_plain = float(((plain32.double() - want).abs() / want.abs()).max())
            print("phase hmc density " + json.dumps(dict(
                route=name, kernel_rel_err_vs_f64=err, plain_f32_rel_err_vs_f64=err_plain,
                rtol=rtol)), flush=True)
            if not (err < rtol and torch.isfinite(got).all()):
                raise AssertionError(f"density cross-check {name}: {err} >= {rtol}")


def phase_hmc(counts_df, device):
    import torch

    from ppcseq_tpu_torch.infer.diagnostics import summarize
    from ppcseq_tpu_torch.model import nb_model
    from ppcseq_tpu_torch.utils.synthetic import synthetic_cohort

    launches = {}
    # (a) bench.py:72-122: 15 FDR<0.01 genes + 500 controls, no baseline
    fifteen = sorted(counts_df.loc[counts_df.FDR < 0.01, "symbol"].unique())
    md = _bundled_prep(counts_df, fifteen, 500)
    data, dims = nb_model.prepare_data(md.counts, md.X, md.exposure_rate, md.n_check,
                                       device=device, dtype=torch.float32)
    (res, row), counts = _run_path(
        "hmc bench", lambda: _hmc_run(data, dims, "auto", chains=128, warmup=30, draws=83, L=48,
                                      seed=0, device=device), ["nb_glm_plain"])
    launches["nb_glm_plain"] = counts["nb_glm_plain"]
    sel = torch.as_tensor(np.r_[0:6, 6 + 2 * dims.G: 6 + 2 * dims.G + dims.n_check],
                          device=device)
    diag = summarize(res.draws[:, :, sel].cpu().numpy())
    row.update(config="bench.py", rhat_max=diag["rhat_max"], ess_min=diag["ess_min"],
               launches=counts)
    print("phase hmc " + json.dumps(row), flush=True)
    if not row["draws_finite"] or row["divergence_frac"] > 0.02:
        raise AssertionError(f"hmc bench: {row}")
    del res, data

    # (b) scripts/bench_scale.py:39-66: 50,000 x 100 with a baseline
    counts, X, exposure, _ = synthetic_cohort(50000, 100, n_check=100, seed=0)
    data, dims = nb_model.prepare_data(counts, X, exposure, 100, device=device,
                                       dtype=torch.float32)
    data = nb_model.with_baseline(data, dims)
    for likelihood, kernels in (("pallas", ["nb_glm_stable_fwd", "nb_glm_stable_bwd"]),
                                ("pallas_fused", ["nb_glm_fused"])):
        (res, row), counts = _run_path(
            f"hmc scale {likelihood}",
            lambda: _hmc_run(data, dims, likelihood, chains=8, warmup=100, draws=125,
                             L=32, seed=1, device=device), kernels)
        launches.update({k: counts[k] for k in kernels})
        row.update(config="bench_scale.py", launches=counts,
                   step_size_ok=row["step_size"] >= 1e-2,
                   **_busy_window(data, dims, likelihood, device))
        print("phase hmc " + json.dumps(row), flush=True)
        if not row["draws_finite"]:
            raise AssertionError(f"hmc scale {likelihood}: non-finite draws")
        if row["step_size"] < 1e-2:  # a float32 energy freezes it near 1e-4
            raise AssertionError(f"hmc scale {likelihood}: step size {row['step_size']} < 1e-2")
        _density_check(data, dims, res.draws[:, -1, :], device)
        del res
        torch.cuda.empty_cache()
    del data

    # (c) ChEES at (a)'s configuration: the trajectory length adapted, L the cap
    data, dims = nb_model.prepare_data(md.counts, md.X, md.exposure_rate, md.n_check,
                                       device=device, dtype=torch.float32)
    (res, row), counts = _run_path(
        "hmc chees", lambda: _hmc_run(data, dims, "auto", chains=128, warmup=30, draws=83, L=48,
                                      seed=3, device=device, adapt_trajectory=True),
        ["nb_glm_plain"])
    diag = summarize(res.draws[:, :, sel].cpu().numpy())
    row.update(config="bench.py, adapt_trajectory=True", rhat_max=diag["rhat_max"],
               ess_min=diag["ess_min"], launches=counts)
    print("phase hmc " + json.dumps(row), flush=True)
    if (not row["draws_finite"] or row["divergence_frac"] > 0.02
            or not row["trajectory_length"] > 0):
        raise AssertionError(f"hmc chees: {row}")
    return launches


NUTS_DRAWS = 100  # per chain, as scripts/baseline_cpu.py


def phase_nuts(counts_df, device):
    """NUTS at scripts/baseline_cpu.py's configuration, from the pipeline's
    ADVI warm start. Returns the launch counts of the run."""
    import torch

    from ppcseq_tpu_torch.infer.diagnostics import summarize
    from ppcseq_tpu_torch.infer.nuts import run_nuts
    from ppcseq_tpu_torch.model import nb_model

    fifteen = sorted(counts_df.loc[counts_df.FDR < 0.01, "symbol"].unique())
    md = _bundled_prep(counts_df, fifteen, 500)
    data, dims = nb_model.prepare_data(md.counts, md.X, md.exposure_rate, md.n_check,
                                       device=device, dtype=torch.float32)
    logp = nb_model.flat_logp(dims)
    chains, warmup = 4, 150

    def run():
        gen = torch.Generator(device=device).manual_seed(0)
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        warm = _warm_start(logp, data, dims, gen, device)
        torch.cuda.synchronize()
        t1 = time.perf_counter()
        res = run_nuts(logp, dims.dim, gen, data=data, num_chains=chains, num_warmup=warmup,
                       num_draws=NUTS_DRAWS, max_depth=10, init_theta=warm.mean,
                       inv_mass_init=torch.exp(2.0 * warm.log_sd), device=device)
        torch.cuda.synchronize()
        return res, t1 - t0, time.perf_counter() - t1

    (res, advi_s, nuts_s), counts = _run_path("nuts", run, ["nb_glm_plain"])
    DIGESTS["nuts"] = _digest(res.draws[:, :NUTS_TREE_DRAWS])
    sel = torch.as_tensor(np.r_[0:6, 6 + 2 * dims.G: 6 + 2 * dims.G + dims.n_check],
                          device=device)
    diag = summarize(res.draws[:, :, sel].cpu().numpy())
    total = chains * NUTS_DRAWS
    start = res.draws[0, -1].clone()
    adapted = torch.as_tensor(res.inv_mass.mean(axis=0), device=device)

    def window():  # 3 + 3 transitions from the run's last draw and mass
        return run_nuts(logp, dims.dim, torch.Generator(device=device).manual_seed(1),
                        data=data, num_chains=chains, num_warmup=3, num_draws=3, max_depth=10,
                        init_theta=start, init_jitter=0.0, inv_mass_init=adapted,
                        device=device)

    row = dict(config="scripts/baseline_cpu.py", S=dims.S, G=dims.G, D=dims.dim, chains=chains,
               warmup=warmup, draws_per_chain=NUTS_DRAWS, max_depth=10, advi_s=advi_s,
               nuts_s=nuts_s, wall_s=advi_s + nuts_s, draws_per_s=total / (advi_s + nuts_s),
               nuts_draws_per_s=total / nuts_s, leapfrog_steps=res.num_leapfrog,
               lockstep_leapfrog=res.lockstep_leapfrog,
               lockstep_ratio=res.lockstep_leapfrog / max(res.num_leapfrog, 1),
               batched_evals=res.num_evals, host_syncs=res.host_syncs,
               ms_per_batched_eval=nuts_s / res.num_evals * 1e3, mean_depth=res.mean_depth,
               divergences=int(res.divergences.sum()),
               divergence_frac=float(res.divergences.sum()) / total,
               mean_accept=float(res.accept_prob.mean()), step_size=res.step_size.tolist(),
               rhat_max=diag["rhat_max"], ess_min=diag["ess_min"],
               draws_finite=bool(torch.isfinite(res.draws).all()), launches=counts,
               **_busy_window(data, dims, "auto", device, window))
    print("phase nuts " + json.dumps(row), flush=True)
    if (not row["draws_finite"] or row["divergence_frac"] > 0.02 or not row["rhat_max"] < 1.1):
        raise AssertionError(f"nuts: {row}")
    return counts


NUTS_TREE_DRAWS = 50  # per chain: the first draws of phase nuts's run
DIGESTS: dict = {}  # run name -> SHA-256 of its flat draws' bytes


def _digest(draws) -> str:
    import hashlib

    return hashlib.sha256(draws.detach().contiguous().cpu().numpy().tobytes()).hexdigest()


def phase_nuts_tree(counts_df, device):
    """(ii) run_nuts with the model's tree as its prototype
    (smart_init(as_tree=True), dims=) through tree_logp(dims) at phase
    nuts's configuration and generator, cut to NUTS_TREE_DRAWS draws: after
    tree_to_theta its draws must be phase nuts's first NUTS_TREE_DRAWS
    draws bit for bit (the parent compares the two runs' digests)."""
    import torch

    from ppcseq_tpu_torch.infer.nuts import run_nuts
    from ppcseq_tpu_torch.model import nb_model, params

    fifteen = sorted(counts_df.loc[counts_df.FDR < 0.01, "symbol"].unique())
    md = _bundled_prep(counts_df, fifteen, 500)
    data, dims = nb_model.prepare_data(md.counts, md.X, md.exposure_rate, md.n_check,
                                       device=device, dtype=torch.float32)

    def run():
        gen = torch.Generator(device=device).manual_seed(0)
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        warm = _warm_start(nb_model.flat_logp(dims), data, dims, gen, device)
        res = run_nuts(nb_model.tree_logp(dims), nb_model.smart_init(data, dims, as_tree=True),
                       gen, data=data, dims=dims, num_chains=4, num_warmup=150,
                       num_draws=NUTS_TREE_DRAWS, max_depth=10, init_theta=warm.mean,
                       inv_mass_init=torch.exp(2.0 * warm.log_sd), device=device)
        torch.cuda.synchronize()
        return res, time.perf_counter() - t0

    (res, wall), counts = _run_path("nuts tree", run, ["nb_glm_plain"])
    DIGESTS["nuts tree"] = _digest(params.tree_to_theta(res.draws, dims))
    row = dict(prototype="smart_init(as_tree=True)", D=dims.dim, draws_per_chain=NUTS_TREE_DRAWS,
               wall_s=wall, leaves={k: list(v.shape) for k, v in res.draws.items()},
               inv_mass_leaves={k: list(v.shape) for k, v in res.inv_mass.items()},
               digest=DIGESTS["nuts tree"], launches=counts)
    print("phase nuts-tree " + json.dumps(row), flush=True)
    if set(res.draws) != params.model_tree_names(dims):
        raise AssertionError(f"nuts tree: the draws are not the model's tree: {row}")


def phase_sbc1(device):
    """(iii) Replication 0 of the SBC suite (utils/sbc.py) at its full
    constants, float64 through flat_logp(dims, "plain") as
    tests/test_torch_calibration.py's suite (a) runs it: its wall and ranks.
    It launches no kernel (the kernels take float32 only)."""
    import torch

    from ppcseq_tpu_torch.utils import sbc

    out = sbc.replication(0, dtype=torch.float64, likelihood="plain", device=device)
    ranks = {k: v.tolist() for k, v in out["ranks"].items()}
    row = dict(rep=0, chains=sbc.N_CHAINS, warmup=sbc.NUM_WARMUP, draws=sbc.NUM_DRAWS,
               L=sbc.NUM_LEAPFROG, wall_s=out["wall_s"], ranks=ranks,
               advi_iterations=out["advi_iterations"], step_size=out["step_size"],
               divergences=out["divergences"], accept_mean=out["accept_mean"],
               chain_leapfrogs=out["num_leapfrog"], max_count=out["max_count"],
               draws_finite=out["draws_finite"])
    print("phase sbc1 " + json.dumps(row), flush=True)
    in_range = all(0 <= r <= sbc.N_CHAINS for v in ranks.values() for r in v)
    if not (out["draws_finite"] and in_range and not out["held_out_like_mask"].any()):
        raise AssertionError(f"sbc1: {row}")


def phase_e2e(counts_df, device, nuts_only=False):
    """identify_outliers on the bundled data: every row of the plan but the
    NUTS one, or with nuts_only that one alone. Returns their K1 launches."""
    import torch

    from ppcseq_tpu_torch import identify_outliers

    common = dict(formula="~ Label", sample="sample", transcript="symbol",
                  abundance="value", significance="PValue", do_check="is_significant",
                  seed=42, device=device)
    three = counts_df.assign(is_significant=counts_df.symbol.isin(["SLC16A12", "CYP1A1", "ART3"]))
    fifteen = counts_df.assign(is_significant=counts_df.FDR < 0.01)
    three_kw = dict(percent_false_positive_genes=1, how_many_negative_controls=50)
    plan = [
        ("3-gene VB approx", three, dict(three_kw, approximate_posterior_analysis=True)),
        ("3-gene VB exact", three, dict(three_kw, approximate_posterior_analysis=False)),
        ("3-gene HMC approx", three, dict(three_kw, approximate_posterior_inference=False,
                                          mcmc_sampler="hmc", approximate_posterior_analysis=True,
                                          pass_fit=True)),
        ("3-gene HMC ChEES approx", three, dict(three_kw, approximate_posterior_inference=False,
                                                mcmc_sampler="hmc", hmc_adapt_trajectory=True,
                                                approximate_posterior_analysis=True,
                                                pass_fit=True)),
        (E2E_NUTS, three, dict(three_kw, approximate_posterior_inference=False,
                               mcmc_sampler="nuts", approximate_posterior_analysis=True,
                               pass_fit=True)),
        ("15-gene VB", fifteen, dict(percent_false_positive_genes=5)),
    ]
    launches = 0
    for name, df, kw in plan:
        if (name == E2E_NUTS) != nuts_only:
            continue
        t0 = time.perf_counter()
        res, counts = _run_path(f"e2e {name}", lambda: identify_outliers(df, **common, **kw),
                                ["nb_glm_delta"])
        wall = time.perf_counter() - t0
        launches += counts["nb_glm_delta"]
        calls = dict(zip(res.symbol, map(int, res.tot_deleterious_outliers)))
        bounds = np.concatenate([
            swd[[".lower", ".upper"]].to_numpy(np.float64).ravel() for swd in res.sample_wise_data
        ])
        row = dict(run=name, wall_s=wall, calls=calls, bounds_finite=bool(np.isfinite(bounds).all()))
        if "vb_iterations" in res.attrs:
            row["vb_iterations"] = list(res.attrs["vb_iterations"])
        else:
            fits = [res.attrs["fit 1"], res.attrs["fit 2"]]
            row.update(divergences=[int(f.divergences.sum()) for f in fits],
                       step_size=[np.asarray(f.step_size).tolist() for f in fits],
                       mean_accept=[float(f.accept_prob.mean()) for f in fits],
                       draws_finite=all(bool(torch.isfinite(f.draws).all()) for f in fits))
            if "ChEES" in name:
                row["trajectory_length"] = [f.trajectory_length for f in fits]
            if "NUTS" in name:
                row.update(chains=[f.draws.shape[0] for f in fits],
                           leapfrog_steps=[f.num_leapfrog for f in fits],
                           lockstep_leapfrog=[f.lockstep_leapfrog for f in fits],
                           host_syncs=[f.host_syncs for f in fits],
                           mean_depth=[f.mean_depth for f in fits])
        print("phase e2e " + json.dumps(row), flush=True)
        if not row["bounds_finite"] or not row.get("draws_finite", True):
            raise AssertionError(f"{name}: non-finite output")
        if name.startswith("3-gene") and calls != {"SLC16A12": 0, "CYP1A1": 1, "ART3": 0}:
            raise AssertionError(f"{name}: calls {calls} differ from the reference's (0, 1, 0)")
        if name.startswith("15-gene") and not (calls.get("CYP1A1", 0) >= 1 and calls.get("LYZ", 0) >= 1):
            raise AssertionError(f"{name}: CYP1A1 and LYZ must both be called, got {calls}")
    return launches


# scripts/bench_pipeline_scale.py's cohort and command: VB, the approximated
# CI, every gene in the fit (100 checked + 49,900 controls)
CLI_COHORT = dict(n_genes=50000, n_samples=100, n_check=100, outlier_frac=0.002, seed=0)
_STAGE_DONE = re.compile(r"done (.+) \(([0-9.]+)s\)$")
# the stages of utils/log that prepare the data on the host
HOST_PREP = ("format input", "design matrix and scaling", "model data")


def _cpu_model() -> str:
    import subprocess

    try:
        out = subprocess.run(["lscpu"], capture_output=True, text=True, timeout=30).stdout
    except OSError:
        return "not read (no lscpu)"
    names = [line.split(":", 1)[1].strip() for line in out.splitlines()
             if line.startswith("Model name:")]
    return names[0] if names else "not read"


def phase_host():
    """Phase host: build (or load) the native host runtime, then time TMM
    on phase cli's 50,000 x 100 cohort natively and in NumPy on this host,
    and hold the factors at rtol 1e-12."""
    from ppcseq_tpu_torch import _native
    from ppcseq_tpu_torch.norm import tmm
    from ppcseq_tpu_torch.utils.synthetic import synthetic_cohort

    _native.load()  # raises with the compiler's output if the build fails
    info = _native.BUILD_INFO
    print(f"phase host build: cached={info['cached']} seconds={info['seconds']:.3f} "
          f"compiler={_native.compiler()} library={info['path']}", flush=True)
    counts = synthetic_cohort(**CLI_COHORT)[0]
    mat = np.ascontiguousarray(counts.T, dtype=np.float64)  # [genes, samples]
    ref = int(np.argmax(np.median(mat, axis=0)))  # the highest median, as sample_scaling
    native_s = []
    for _ in range(3):
        t0 = time.perf_counter()
        f_native = tmm.tmm_norm_factors(mat, ref_column=ref)
        native_s.append(time.perf_counter() - t0)
    t0 = time.perf_counter()
    f_numpy = tmm.tmm_norm_factors(mat, ref_column=ref, use_native=False)
    numpy_s = time.perf_counter() - t0
    rel = float(np.max(np.abs(f_native - f_numpy) / np.abs(f_numpy)))
    row = dict(config="tmm_norm_factors at chip_smoke CLI_COHORT", genes=mat.shape[0],
               samples=mat.shape[1], ref_column=ref, native_s=native_s, numpy_s=numpy_s,
               max_rel_diff=rel, host_cpu=_cpu_model(), host_cores=os.cpu_count())
    print("phase host " + json.dumps(row), flush=True)
    if not rel <= 1e-12:
        raise AssertionError(f"host: native TMM {rel:.3e} from the NumPy version (rtol 1e-12)")


def _cli_main(argv):
    """ppcseq_tpu_torch.cli.main(argv) with the pipeline's stage breadcrumbs
    (utils/log) captured and the printed summary dropped: (wall s, stage ->
    [seconds of each time it ran])."""
    import contextlib
    import io

    from ppcseq_tpu_torch import cli
    from ppcseq_tpu_torch.utils import log

    err = io.StringIO()
    log.set_verbose(True)
    t0 = time.perf_counter()
    try:
        with contextlib.redirect_stderr(err), contextlib.redirect_stdout(io.StringIO()):
            if cli.main(argv) != 0:
                raise AssertionError(f"cli.main({argv}) failed")
    finally:
        log.set_verbose(False)
    wall = time.perf_counter() - t0
    stages: dict = {}
    for line in err.getvalue().splitlines():
        m = _STAGE_DONE.search(line)
        if m:
            stages.setdefault(m.group(1), []).append(float(m.group(2)))
    return wall, stages


def _cli_batch(device, tmp):
    """(1) of phase cli: the 50k batch run from a parquet table, then its
    resume from the checkpoint. Returns its K1 launches."""
    import filecmp

    import pandas as pd
    import torch

    from ppcseq_tpu_torch import _native
    from ppcseq_tpu_torch.utils.synthetic import synthetic_cohort, synthetic_tidy

    t0 = time.perf_counter()
    table = os.path.join(tmp, "cohort.parquet")
    synthetic_tidy(**CLI_COHORT).to_parquet(table)
    spiked = set(map(tuple, synthetic_cohort(**CLI_COHORT)[3]["outliers"]))
    setup_s = time.perf_counter() - t0
    ckpt = os.path.join(tmp, "checkpoint")

    def argv(out):
        return _cli_argv(table, out) + ["--checkpoint-dir", ckpt]

    k1 = 0
    outs = {}
    torch.cuda.init()  # the peak-memory counters exist once CUDA is initialized
    for run in ("cold", "resume"):
        outs[run] = os.path.join(tmp, run)
        torch.cuda.reset_peak_memory_stats(device)
        (wall, stages), counts = _run_path(f"cli 50k {run}", lambda: _cli_main(argv(outs[run])),
                                           ["nb_glm_delta"] if run == "cold" else [])
        k1 += counts["nb_glm_delta"]
        summary = pd.read_csv(os.path.join(outs[run], "result.csv"))
        flat = pd.read_csv(os.path.join(outs[run], "sample_wise_data.csv"))
        failed = flat[~flat["posterior_predictive_check_succeded"].astype(bool)]
        flagged = {(int(s[1:]), int(t[1:])) for s, t in zip(failed["sample"], failed["transcript"])}
        with open(os.path.join(ckpt, "meta.json")) as f:
            meta = json.load(f)
        host_prep = sum(sum(stages.get(k, [])) for k in HOST_PREP)
        row = dict(run=run, config="scripts/bench_pipeline_scale.py via cli.main",
                   genes=CLI_COHORT["n_genes"], samples=CLI_COHORT["n_samples"],
                   checked=CLI_COHORT["n_check"], wall_s=wall, stages_s=stages,
                   host_prep_s=host_prep, host_prep_share=host_prep / wall,
                   peak_device_bytes=torch.cuda.max_memory_allocated(device),
                   k1_launches=counts["nb_glm_delta"],
                   vb_iterations=[meta[p].get("vb_iterations") for p in ("pass1", "pass2")],
                   result_rows=len(summary), sample_rows=len(flat),
                   bounds_finite=bool(np.isfinite(flat[[".lower", ".upper"]].to_numpy()).all()),
                   deleterious_calls=int(summary["tot_deleterious_outliers"].sum()),
                   ppc_failed=int(summary["ppc_samples_failed"].sum()),
                   injected_outlier_cells=len(spiked), injected_cells_flagged=len(spiked & flagged),
                   native_library=_native.BUILD_INFO.get("path"))
        if run == "cold":
            row["table_setup_s"] = setup_s
        else:
            row["csvs_identical_to_cold"] = all(
                filecmp.cmp(os.path.join(outs["cold"], name), os.path.join(outs[run], name),
                            shallow=False)
                for name in ("result.csv", "sample_wise_data.csv"))
        print("phase cli " + json.dumps(row), flush=True)
        if row["result_rows"] != CLI_COHORT["n_check"] or not row["bounds_finite"]:
            raise AssertionError(f"cli 50k {run}: {row['result_rows']} rows, finite bounds "
                                 f"{row['bounds_finite']}")
        if row["native_library"] is None:
            raise AssertionError(f"cli 50k {run}: host prep never loaded the native library")
        if 2 * row["injected_cells_flagged"] < len(spiked):
            raise AssertionError(f"cli 50k {run}: {row['injected_cells_flagged']} of "
                                 f"{len(spiked)} injected cells flagged")
        if run == "resume" and (any(counts.values()) or not row["csvs_identical_to_cold"]):
            raise AssertionError(f"cli 50k resume: launches {counts}, CSVs identical "
                                 f"{row['csvs_identical_to_cold']}")
    return k1


def _cli_module(counts_df, tmp):
    """(2) of phase cli: `python -m ppcseq_tpu_torch` in a subprocess on the
    15-gene README configuration. Its kernel launches are counted in its own
    process and not read here."""
    import importlib.util
    import subprocess

    inp = os.path.join(tmp, "readme.csv")
    counts_df.assign(is_significant=counts_df.FDR < 0.01).to_csv(inp, index=False)
    out = os.path.join(tmp, "readme")
    plots = importlib.util.find_spec("matplotlib") is not None
    cmd = [sys.executable, "-m", "ppcseq_tpu_torch", inp, "-o", out, "--formula", "~ Label",
           "--sample", "sample", "--transcript", "symbol", "--abundance", "value",
           "--significance", "PValue", "--do-check", "is_significant",
           "--percent-false-positive-genes", "5", "--seed", "42", "--json"]
    if plots:
        cmd.append("--plots")
    t0 = time.perf_counter()
    proc = subprocess.run(cmd, cwd=os.path.dirname(os.path.abspath(__file__)),
                          capture_output=True, text=True, timeout=600)
    wall = time.perf_counter() - t0
    if proc.returncode != 0:
        raise AssertionError(f"python -m ppcseq_tpu_torch failed:\n{proc.stderr[-4000:]}")
    records = json.loads(proc.stdout.strip().splitlines()[-1])
    calls = {r["symbol"]: r["tot_deleterious_outliers"] for r in records}
    pngs = sorted(os.listdir(os.path.join(out, "plots"))) if plots else []
    row = dict(run="python -m ppcseq_tpu_torch", config="scripts/readme_run.py", wall_s=wall,
               plots=plots, pngs=len(pngs), transcripts=len(records), calls=calls)
    print("phase cli " + json.dumps(row), flush=True)
    if not (calls.get("CYP1A1", 0) >= 1 and calls.get("LYZ", 0) >= 1):
        raise AssertionError(f"python -m ppcseq_tpu_torch: CYP1A1 and LYZ must be called: {calls}")
    if plots and len(pngs) != len(records):
        raise AssertionError(f"python -m ppcseq_tpu_torch: {len(pngs)} plots for "
                             f"{len(records)} transcripts")


def _cli_mcmc_product(counts_df, device):
    """(3) of phase cli: the HMC branch with the exact CI, the generated
    quantities and extra parameter draws. Returns its K1 launches."""
    from ppcseq_tpu_torch import identify_outliers

    three = counts_df.assign(is_significant=counts_df.symbol.isin(["SLC16A12", "CYP1A1", "ART3"]))
    names = ("lambda_mu", "sigma_raw", "sigma")
    t0 = time.perf_counter()
    res, counts = _run_path("cli mcmc product", lambda: identify_outliers(
        three, formula="~ Label", sample="sample", transcript="symbol", abundance="value",
        significance="PValue", do_check="is_significant", percent_false_positive_genes=1,
        how_many_negative_controls=50, approximate_posterior_inference=False,
        mcmc_sampler="hmc", approximate_posterior_analysis=False,
        save_generated_quantities=True, additional_parameters_to_save=names, seed=42,
        device=device), ["nb_glm_delta"])
    wall = time.perf_counter() - t0
    calls = dict(zip(res.symbol, map(int, res.tot_deleterious_outliers)))
    extra = res.attrs["additional_parameters"]
    gq = [g for swd in res.sample_wise_data for g in swd["generated quantities"]]
    n_draws = extra["sigma_raw"].shape[0]
    row = dict(run="3-gene HMC exact, generated quantities", wall_s=wall, calls=calls,
               launches=counts, saved={k: list(v.shape) for k, v in extra.items()},
               gq_frames=len(gq), gq_draws=n_draws,
               gq_ok=all(len(g) == n_draws and bool((g[".value"] >= 0).all()) for g in gq),
               sigma_rel_err=float(np.max(np.abs(extra["sigma"] - np.exp(-extra["sigma_raw"]))
                                          / np.exp(-extra["sigma_raw"]))))
    print("phase cli " + json.dumps(row), flush=True)
    if calls != {"SLC16A12": 0, "CYP1A1": 1, "ART3": 0}:
        raise AssertionError(f"cli mcmc product: calls {calls} differ from (0, 1, 0)")
    if not (row["gq_ok"] and len(gq) == sum(len(s) for s in res.sample_wise_data)):
        raise AssertionError(f"cli mcmc product: generated quantities {row}")
    if row["sigma_rel_err"] > 1e-5 or extra["sigma_raw"].shape[1] != 53:
        raise AssertionError(f"cli mcmc product: saved parameters {row}")
    return counts["nb_glm_delta"]


def phase_cli(counts_df, device):
    """The product surface: the 50k command-line batch run and its resume,
    `python -m ppcseq_tpu_torch`, and the MCMC product options; then phase
    dtype's (d) on the same table. Returns the K1 launches of its in-process
    paths."""
    import tempfile

    with tempfile.TemporaryDirectory() as tmp:
        k1 = _cli_batch(device, tmp)
        _cli_module(counts_df, tmp)
        k1 += _cli_mcmc_product(counts_df, device)
        _dtype_50k(device, tmp)  # phase dtype (d), against the cold run's table
    return k1


# ---- phase dtype: the float64 path on the card ------------------------------

def phase_dtype_kernels(counts_df, device):
    """(a) of phase dtype: the float64 forms of K1 and K2 against their
    plain versions (nb_fast.glm_delta / glm_plain in float64 on the card) at
    A (1, 21, 515), H (128, 21, 515), Z (8, 100, 50000) and V (1, 100,
    50000) with gradients and W (100, 100, 50000) value-only: value rtol
    1e-10, gradients |d|/(1+|g|) < 1e-10, one launch of the form and no
    other kernel per call, float64 outputs, exactly zero gradients for the
    masked gene. Rows as phase kernel's, the bound on the card's FP64 peak.
    Returns the rows."""
    import torch

    from ppcseq_tpu_torch.ops import nb_kernel
    from ppcseq_tpu_torch.utils.synthetic import synthetic_cohort

    fifteen = sorted(counts_df.loc[counts_df.FDR < 0.01, "symbol"].unique())
    md = _bundled_prep(counts_df, fifteen, 500)
    bundled = (md.counts, md.X, md.exposure_rate, md.n_check)
    z = synthetic_cohort(n_genes=50000, n_samples=100, n_check=100, seed=0)[:3] + (100,)
    cases = [("A", 1, bundled, True), ("H", 128, bundled, True), ("Z", 8, z, True),
             ("V", 1, z, True), ("W", 100, z, False)]
    rows = []
    for shape, B, cohort, grads in cases:
        data, alpha, log_phi, g_m = _kernel_case(*cohort, B, 7, device, dtype=torch.float64)
        S, G = data.counts.shape
        C = data.X.shape[1]
        shares = nb_kernel.branch_shares(data, alpha, log_phi)
        calls = _calls(data, alpha, log_phi, grads)[0]
        for name in nb_kernel.F64_FORMS:
            kern_fn, plain_fn = calls[name[:-len("_f64")]]
            torch.cuda.synchronize()
            nb_kernel.reset_launches()
            kern = kern_fn()
            torch.cuda.synchronize()
            launched = {k: v for k, v in nb_kernel.LAUNCHES.items() if v}
            plain = plain_fn()
            val_rel, grad_err, mabs = _errors(kern, plain)
            zero = len(kern) == 1 or bool((kern[1][:, :, g_m] == 0).all()
                                          and (kern[2][:, g_m] == 0).all())
            finite = all(bool(torch.isfinite(t).all()) for t in kern)
            f64 = all(t.dtype == torch.float64 for t in kern)
            ok = (val_rel < 1e-10 and grad_err < 1e-10 and zero and finite and f64
                  and launched == {name: 1})
            t_k = _time_ms(kern_fn, reps=20)
            t_p = _time_ms(plain_fn, reps=3, warmup=1) if G > 1000 else _time_ms(plain_fn)
            dev_us, n_cuda, n_records, dev_source = _device_us(kern_fn, 20 if G > 1000 else 200)
            w = nb_kernel.work(name, B, S, C, G, want_grads=grads, shares=shares)
            row = dict(kernel=name, shape=shape, B=B, S=S, G=G, grads=grads,
                       value_rel_err=val_rel, grad_err=grad_err, max_abs_err=mabs,
                       launched=launched, float64_outputs=f64, masked_gene_zero_grad=zero,
                       finite=finite, device_us=dev_us, device_us_source=dev_source,
                       cuda_kernels_per_call=n_cuda, kernel_records_per_call=n_records,
                       call_ms=t_k, plain_ms=t_p, bytes=w["bytes"], ops=w["ops"],
                       bound_us=w["bound_us"], bound_by=w["bound_by"],
                       share_of_bound=w["bound_us"] / dev_us,
                       kernel_points_per_s=B * S * G / (dev_us * 1e-6), branch_shares=shares)
            print("phase dtype " + json.dumps(row), flush=True)
            if not ok:
                raise AssertionError(f"{name} disagrees with its plain version at {shape}: {row}")
            rows.append(row)
        del data, alpha, log_phi, calls
        torch.cuda.empty_cache()
    return rows


def _cells(res, transcript):
    """(sample, transcript) -> (ppc passed, deleterious) of an
    identify_outliers table, as _cell_calls reads them from the CSV."""
    return {(s, t): (bool(p), bool(d))
            for t, swd in zip(res[transcript], res.sample_wise_data)
            for s, p, d in zip(swd["sample"], swd["posterior_predictive_check_succeded"],
                               swd["deleterious_outliers"])}


def _differing(a, b):
    return sum(a[k] != b.get(k) for k in a) + sum(k not in a for k in b)


def phase_dtype_e2e(counts_df, device):
    """(b), (c) and (e) of phase dtype: the reference's 3-gene case at
    dtype=torch.float64 on both VB CI paths (calls (0, 1, 0), the float64
    form of K1 the only kernel launched); the 15-gene README configuration
    (seed 42) in float32 and in float64, with both walls and the
    (transcript, sample) calls that differ (CYP1A1 and LYZ called in both);
    a short float64 HMC run of flat_logp(dims) without a baseline on the
    same cohort (bench.py's 128 chains, cut to warmup 20, 10 draws, L=8),
    which launches the float64 form of K2 and no other kernel."""
    import torch

    from ppcseq_tpu_torch import identify_outliers
    from ppcseq_tpu_torch.infer.hmc import run_hmc
    from ppcseq_tpu_torch.model import nb_model

    f32, f64 = torch.float32, torch.float64
    common = dict(formula="~ Label", sample="sample", transcript="symbol",
                  abundance="value", significance="PValue", do_check="is_significant",
                  seed=42, device=device)
    three = counts_df.assign(is_significant=counts_df.symbol.isin(["SLC16A12", "CYP1A1", "ART3"]))
    for approx in (True, False):
        name = f"dtype 3-gene VB {'approx' if approx else 'exact'} float64"
        t0 = time.perf_counter()
        res, counts = _run_path(name, lambda: identify_outliers(
            three, **common, percent_false_positive_genes=1, how_many_negative_controls=50,
            approximate_posterior_analysis=approx, dtype=f64), ["nb_glm_delta_f64"])
        calls = dict(zip(res.symbol, map(int, res.tot_deleterious_outliers)))
        row = dict(run=name, wall_s=time.perf_counter() - t0, calls=calls,
                   vb_iterations=list(res.attrs["vb_iterations"]))
        print("phase dtype " + json.dumps(row), flush=True)
        if calls != {"SLC16A12": 0, "CYP1A1": 1, "ART3": 0}:
            raise AssertionError(f"{name}: calls {calls} differ from the reference's (0, 1, 0)")
        if {k for k, v in counts.items() if v} != {"nb_glm_delta_f64"}:
            raise AssertionError(f"{name}: launched {counts}")

    fifteen = counts_df.assign(is_significant=counts_df.FDR < 0.01)
    walls, cells, totals = {}, {}, {}
    for dtype, kernel in ((f32, "nb_glm_delta"), (f64, "nb_glm_delta_f64")):
        name = f"dtype 15-gene VB {str(dtype)[6:]}"
        t0 = time.perf_counter()
        res, counts = _run_path(name, lambda: identify_outliers(
            fifteen, **common, percent_false_positive_genes=5, dtype=dtype), [kernel])
        walls[dtype] = time.perf_counter() - t0
        cells[dtype] = _cells(res, "symbol")
        totals[dtype] = dict(zip(res.symbol, map(int, res.tot_deleterious_outliers)))
        if not (totals[dtype].get("CYP1A1", 0) >= 1 and totals[dtype].get("LYZ", 0) >= 1):
            raise AssertionError(f"{name}: CYP1A1 and LYZ must both be called: {totals[dtype]}")
    row = dict(run="dtype 15-gene VB float32 vs float64", config="scripts/readme_run.py",
               wall_s={"float32": walls[f32], "float64": walls[f64]}, cells=len(cells[f32]),
               cells_differing=_differing(cells[f32], cells[f64]),
               calls={"float32": totals[f32], "float64": totals[f64]})
    print("phase dtype " + json.dumps(row), flush=True)

    fifteen_genes = sorted(counts_df.loc[counts_df.FDR < 0.01, "symbol"].unique())
    md = _bundled_prep(counts_df, fifteen_genes, 500)
    data, dims = nb_model.prepare_data(md.counts, md.X, md.exposure_rate, md.n_check,
                                       device=device, dtype=f64)
    gen = torch.Generator(device=device).manual_seed(0)
    t0 = time.perf_counter()
    res, counts = _run_path("dtype hmc float64 no baseline", lambda: run_hmc(
        nb_model.flat_logp(dims), dims.dim, gen, data=data, num_chains=128, num_warmup=20,
        num_draws=10, num_leapfrog=8, init_theta=nb_model.smart_init(data, dims),
        device=device, dtype=f64), ["nb_glm_plain_f64"])
    row = dict(run="dtype hmc float64 no baseline", chains=128, warmup=20, draws=10, L=8,
               wall_s=time.perf_counter() - t0, draws_dtype=str(res.draws.dtype),
               draws_finite=bool(torch.isfinite(res.draws).all()),
               step_size=np.asarray(res.step_size).tolist(),
               mean_accept=float(res.accept_prob.mean()), launches=counts)
    print("phase dtype " + json.dumps(row), flush=True)
    if not row["draws_finite"] or res.draws.dtype != f64:
        raise AssertionError(f"dtype hmc float64: {row}")
    if {k for k, v in counts.items() if v} != {"nb_glm_plain_f64"}:
        raise AssertionError(f"dtype hmc float64: launched {counts}")


def _dtype_50k(device, tmp):
    """(d) of phase dtype, in the cli child after phase cli: phase cli's 50k
    x 100 table through identify_outliers(dtype=torch.float64) with the
    command line's arguments, once: its wall, peak device memory and
    launches (the float64 form of K1 only), the injected cells it flags and
    the (transcript, sample) calls that differ from the command line's cold
    float32 run in `tmp`."""
    import pandas as pd
    import torch

    from ppcseq_tpu_torch import identify_outliers
    from ppcseq_tpu_torch.utils.synthetic import synthetic_cohort

    df = pd.read_parquet(os.path.join(tmp, "cohort.parquet"))
    want, _ = _cell_calls(os.path.join(tmp, "cold"))
    spiked = set(map(tuple, synthetic_cohort(**CLI_COHORT)[3]["outliers"]))
    torch.cuda.reset_peak_memory_stats(device)
    t0 = time.perf_counter()
    res, counts = _run_path("dtype 50k float64", lambda: identify_outliers(
        df, formula="~ Label", sample="sample", transcript="transcript", abundance="count",
        significance="PValue", do_check="do_check", percent_false_positive_genes=1.0,
        how_many_negative_controls=CLI_COHORT["n_genes"] - CLI_COHORT["n_check"],
        draws_after_tail=10, seed=42, device=device, dtype=torch.float64),
        ["nb_glm_delta_f64"])
    wall = time.perf_counter() - t0
    got = _cells(res, "transcript")
    flagged = {(int(s[1:]), int(t[1:])) for (s, t), (ppc, _) in got.items() if not ppc}
    row = dict(run="dtype 50k float64", config="scripts/bench_pipeline_scale.py's arguments",
               wall_s=wall, peak_device_bytes=torch.cuda.max_memory_allocated(device),
               launches={k: v for k, v in counts.items() if v}, result_rows=len(res),
               cells=len(got), cells_differing_from_float32_cold=_differing(want, got),
               ppc_differing=sum(want[k][0] != got.get(k, (None,))[0] for k in want),
               deleterious_calls=int(res.tot_deleterious_outliers.sum()),
               injected_outlier_cells=len(spiked), injected_cells_flagged=len(spiked & flagged),
               vb_iterations=list(res.attrs["vb_iterations"]))
    print("phase dtype " + json.dumps(row), flush=True)
    if {k for k, v in counts.items() if v} != {"nb_glm_delta_f64"}:
        raise AssertionError(f"dtype 50k float64: launched {counts}")
    if len(res) != CLI_COHORT["n_check"] or 2 * row["injected_cells_flagged"] < len(spiked):
        raise AssertionError(f"dtype 50k float64: {row}")


# ---- phase mesh: ranks of torchrun on the one card ---------------------------

MESH_TIMEOUT_S = 600  # per torchrun call
MESH_DEVICE = "cuda"
# (e): bench_scale.py's cohort and sampler, 25 draws per chain
HMC50K = dict(n_genes=50000, n_samples=100, chains=8, warmup=100, draws=25, L=32)


def _three(counts_df):
    return counts_df.assign(is_significant=counts_df.symbol.isin(["SLC16A12", "CYP1A1", "ART3"]))


def _mesh_case_cli(args, device):
    """(a): cli.main with --mesh genes=2 (what `-m ppcseq_tpu_torch` runs)."""
    table, out = args
    wall, stages = _cli_main(_cli_argv(table, out) + ["--mesh", "genes=2",
                                                       "--device", MESH_DEVICE])
    return dict(cli_wall_s=wall, stages_s=stages)


def _mesh_case_identify(mesh_shape, names, kw):
    def case(args, device):
        import torch
        from torch.distributed.device_mesh import init_device_mesh

        from ppcseq_tpu_torch import identify_outliers, load_counts
        from ppcseq_tpu_torch.utils.synthetic import synthetic_tidy

        mesh = init_device_mesh(MESH_DEVICE, mesh_shape, mesh_dim_names=names)
        if kw.get("synthetic"):
            df = synthetic_tidy(n_genes=64, n_samples=8, n_check=3, seed=0)
            common = dict(formula="~ Label", how_many_negative_controls=40)
        else:
            df = _three(load_counts())
            common = dict(formula="~ Label", sample="sample", transcript="symbol",
                          abundance="value", significance="PValue", do_check="is_significant",
                          percent_false_positive_genes=1, how_many_negative_controls=50)
        opts = {k: v for k, v in kw.items() if k != "synthetic"}
        res = identify_outliers(df, mesh=mesh, seed=42, pass_fit=True, device=device,
                                **common, **opts)
        key = "symbol" if "symbol" in res.columns else "transcript"
        out = dict(calls=dict(zip(map(str, res[key]), map(int, res.tot_deleterious_outliers))))
        fits = [res.attrs["fit 1"], res.attrs["fit 2"]]
        if hasattr(fits[1], "draws"):
            out.update(divergences=[int(f.divergences.sum()) for f in fits],
                       transitions=[int(f.accept_prob.size) for f in fits],
                       draws_shape=list(fits[1].draws.shape), genes=fits[1].genes,
                       chains=fits[1].chains,
                       draws_finite=all(bool(torch.isfinite(f.draws).all()) for f in fits))
        return out
    return case


def _mesh_case_hmc50k(args, device):
    """(e): run_hmc_tree at genes=2 on bench_scale.py's cohort, after a
    gene-sharded ADVI warm start."""
    import functools

    import torch
    from torch.distributed.device_mesh import init_device_mesh

    from ppcseq_tpu_torch.infer.advi import fit_advi
    from ppcseq_tpu_torch.infer.hmc import run_hmc_tree
    from ppcseq_tpu_torch.model import nb_model
    from ppcseq_tpu_torch.parallel import sharding
    from ppcseq_tpu_torch.utils.synthetic import synthetic_cohort

    mesh = init_device_mesh(MESH_DEVICE, (2,), mesh_dim_names=("genes",))
    counts, X, exposure, _ = synthetic_cohort(HMC50K["n_genes"], HMC50K["n_samples"],
                                              n_check=100, seed=0)
    data, dims = nb_model.prepare_data(counts, X, exposure, 100, device="cpu",
                                       dtype=torch.float32)
    data = nb_model.with_baseline(data, dims)
    init = nb_model.smart_init(data, dims)
    layout = sharding.Layout.from_mesh(mesh, dims)
    local = sharding.shard_data(data, layout.genes, device)
    logp = nb_model.flat_logp(dims)
    gen = torch.Generator(device=device).manual_seed(1)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    warm = fit_advi(functools.partial(logp, data=local, shard=layout.genes), dims.dim, gen,
                    init_mean=init,
                    tol_rel_obj=0.01, learning_rate=0.3, eval_every=50, grad_samples=4,
                    layout=layout, device=device)
    torch.cuda.synchronize()
    t1 = time.perf_counter()
    res = run_hmc_tree(logp, dims.dim, gen, data=local, mesh=mesh, dims=dims,
                       num_chains=HMC50K["chains"],
                       num_warmup=HMC50K["warmup"], num_draws=HMC50K["draws"],
                       num_leapfrog=HMC50K["L"], init_theta=warm.mean,
                       inv_mass=torch.exp(2.0 * warm.log_sd), device=device)
    torch.cuda.synchronize()
    t2 = time.perf_counter()
    total = HMC50K["chains"] * HMC50K["draws"]
    return dict(advi_s=t1 - t0, hmc_s=t2 - t1, advi_iterations=warm.iterations,
                step_size=res.step_size, leapfrog_steps=res.num_leapfrog,
                divergences=int(res.divergences.sum()), draws_per_s=total / (t2 - t0),
                hmc_draws_per_s=total / (t2 - t1), genes=res.genes,
                draws_finite=bool(torch.isfinite(res.draws).all()))


MESH_CASES = {
    "cli50k": _mesh_case_cli,
    "nccl": _mesh_case_identify((1,), ("genes",), {}),
    "chains": _mesh_case_identify((2,), ("chains",), dict(
        approximate_posterior_inference=False, mcmc_sampler="hmc")),
    "2d": _mesh_case_identify((2, 2), ("chains", "genes"), dict(
        approximate_posterior_inference=False, mcmc_sampler="hmc", synthetic=True)),
    "hmc50k": _mesh_case_hmc50k,
    "chees": _mesh_case_identify((2,), ("chains",), dict(
        approximate_posterior_inference=False, mcmc_sampler="hmc", hmc_adapt_trajectory=True)),
}


def _mesh_rank(case, args):
    """One rank of a phase mesh run (`python3 chip_smoke.py --mesh-rank CASE
    OUT_DIR ...` under torchrun): the case with the launch and collective
    counts zeroed just before it and read just after, and K1's (B, S, G) of
    every launch, written to OUT_DIR/CASE-rankR.json."""
    import torch
    import torch.distributed as dist

    from ppcseq_tpu_torch.ops import nb_kernel
    from ppcseq_tpu_torch.parallel import multihost, sharding

    out_dir, args = args[0], args[1:]
    nb_kernel.build_all()  # built by the parent: loads
    multihost.initialize(MESH_DEVICE)
    device = torch.device(MESH_DEVICE, torch.cuda.current_device())
    shapes = set()
    launch = nb_kernel.launch_delta

    def counted(X, counts, mask, d0, alpha, *rest, **kw):
        shapes.add((int(alpha.shape[0]), int(counts.shape[0]), int(counts.shape[1])))
        return launch(X, counts, mask, d0, alpha, *rest, **kw)

    nb_kernel.launch_delta = counted
    torch.cuda.reset_peak_memory_stats(device)
    torch.cuda.synchronize()
    nb_kernel.reset_launches()
    sharding.reset_collectives()
    t0 = time.perf_counter()
    out = MESH_CASES[case](args, device)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    rec = dict(case=case, rank=dist.get_rank(), world=dist.get_world_size(),
               backend=str(dist.get_backend()), wall_s=wall, launches=dict(nb_kernel.LAUNCHES),
               k1_shapes=sorted(shapes), collectives=dict(sharding.COLLECTIVES),
               peak_device_bytes=torch.cuda.max_memory_allocated(device), **out)
    with open(os.path.join(out_dir, f"{case}-rank{rec['rank']}.json"), "w") as f:
        json.dump(rec, f)
    dist.barrier()
    dist.destroy_process_group()


def _torchrun(n, case, out_dir, *args):
    """Run `case` on n ranks of torchrun; returns each rank's record, and
    puts each rank's launch counts in PATH_LAUNCHES."""
    import subprocess

    cmd = [sys.executable, "-m", "torch.distributed.run", "--standalone", "--nproc-per-node",
           str(n), os.path.abspath(__file__), "--mesh-rank", case, out_dir, *args]
    t0 = time.perf_counter()
    proc = subprocess.run(cmd, cwd=os.path.dirname(os.path.abspath(__file__)),
                          capture_output=True, text=True, timeout=MESH_TIMEOUT_S)
    wall = time.perf_counter() - t0
    if proc.returncode != 0:
        raise AssertionError(f"mesh {case} failed (exit code {proc.returncode}):\n"
                             f"{proc.stdout[-3000:]}\n{proc.stderr[-6000:]}")
    recs = []
    for r in range(n):
        with open(os.path.join(out_dir, f"{case}-rank{r}.json")) as f:
            recs.append(json.load(f))
        PATH_LAUNCHES[f"mesh {case} rank {r}"] = recs[-1]["launches"]
        print(f"phase mesh {case} rank {r} launches " + json.dumps(recs[-1]["launches"]),
              flush=True)
        if recs[-1]["launches"]["nb_glm_delta"] <= 0:
            raise AssertionError(f"mesh {case}: rank {r} never launched K1")
    return recs, wall


def _per_rank(recs, *keys):
    return {k: [r[k] for r in recs] for k in keys}


def _collectives_row(recs):
    """All-reduces per log-density evaluation (= K1 launch), their bytes
    (those of the log-density all-reduces apart: one per ADVI step or
    leapfrog, and one per ELBO) and host ms, per rank."""
    rows = []
    for r in recs:
        c, k1 = r["collectives"], r["launches"]["nb_glm_delta"]
        rows.append(dict(all_reduce=c["all_reduce"], logp_all_reduce=c["logp"], k1_launches=k1,
                         logp_per_evaluation=c["logp"] / max(k1, 1),
                         bytes=c["bytes"],
                         bytes_per_all_reduce=c["bytes"] / max(c["all_reduce"], 1),
                         bytes_per_logp_all_reduce=c["logp_bytes"] / max(c["logp"], 1),
                         by_purpose={k: c[k] for k in ("logp", "sums", "chains", "check",
                                                       "gather")},
                         host_ms=c["seconds"] * 1e3,
                         host_ms_per_all_reduce=c["seconds"] * 1e3 / max(c["all_reduce"], 1)))
    return rows


def _cli_argv(table, out):
    return [table, "-o", out, "--formula", "~ Label", "--sample", "sample",
            "--transcript", "transcript", "--abundance", "count", "--significance", "PValue",
            "--do-check", "do_check",
            "--negative-controls", str(CLI_COHORT["n_genes"] - CLI_COHORT["n_check"]),
            "--seed", "42"]


def _cell_calls(out):
    """(sample, transcript) -> (ppc passed, deleterious) of a run's CSV."""
    import pandas as pd

    flat = pd.read_csv(os.path.join(out, "sample_wise_data.csv"))
    return {(s, t): (bool(p), bool(d)) for s, t, p, d in zip(
        flat["sample"], flat["transcript"], flat["posterior_predictive_check_succeded"],
        flat["deleterious_outliers"])}, flat


def _mesh_cli(tmp):
    """(a): the unsharded command in this process, then --mesh genes=2 on 2
    ranks. Returns the unsharded run's K1 launches."""
    import torch

    from ppcseq_tpu_torch.utils.synthetic import synthetic_cohort, synthetic_tidy

    table = os.path.join(tmp, "cohort.parquet")
    synthetic_tidy(**CLI_COHORT).to_parquet(table)
    spiked = set(map(tuple, synthetic_cohort(**CLI_COHORT)[3]["outliers"]))
    single, sharded = os.path.join(tmp, "single"), os.path.join(tmp, "genes2")
    (wall1, stages1), counts = _run_path("mesh cli50k unsharded",
                                         lambda: _cli_main(_cli_argv(table, single)
                                                           + ["--device", MESH_DEVICE]),
                                         ["nb_glm_delta"])
    recs, wall = _torchrun(2, "cli50k", tmp, table, sharded)
    want, _ = _cell_calls(single)
    got, flat = _cell_calls(sharded)
    failed = flat[~flat["posterior_predictive_check_succeded"].astype(bool)]
    flagged = {(int(s[1:]), int(t[1:])) for s, t in zip(failed["sample"], failed["transcript"])}
    differ = sum(got[k] != want[k] for k in want)
    bounds_finite = bool(np.isfinite(flat[[".lower", ".upper"]].to_numpy()).all())
    fit = "variational fit"
    row = dict(run="(a) cli 50k --mesh genes=2", config="scripts/bench_pipeline_scale.py via "
               "cli.main, 2 ranks of torchrun on one card", torchrun_wall_s=wall,
               **_per_rank(recs, "backend", "cli_wall_s", "peak_device_bytes", "k1_shapes"),
               fit_wall_s=[r["stages_s"].get(fit) for r in recs],
               host_prep_s=[sum(sum(r["stages_s"].get(k, [])) for k in HOST_PREP) for r in recs],
               stages_s=recs[0]["stages_s"], unsharded_wall_s=wall1,
               unsharded_fit_wall_s=stages1.get("variational fit"),
               collectives=_collectives_row(recs), checked_cells=len(want),
               cells_called_otherwise=differ, bounds_finite=bounds_finite,
               injected_outlier_cells=len(spiked), injected_cells_flagged=len(spiked & flagged))
    print("phase mesh " + json.dumps(row), flush=True)
    shard = (CLI_COHORT["n_samples"], CLI_COHORT["n_genes"] // 2)
    for r in recs:
        if {tuple(sh)[1:] for sh in r["k1_shapes"]} != {shard}:
            raise AssertionError(f"mesh cli50k rank {r['rank']}: K1 shapes {r['k1_shapes']}")
    for c in row["collectives"]:
        if c["logp_all_reduce"] != c["k1_launches"]:
            raise AssertionError(f"mesh cli50k: not one all-reduce per evaluation: {c}")
    if not bounds_finite or 2 * row["injected_cells_flagged"] < len(spiked) or differ > 2:
        raise AssertionError(f"mesh cli50k: {row}")
    torch.cuda.empty_cache()
    return counts["nb_glm_delta"]


def phase_mesh(counts_df, device):
    """The six mesh runs (a)-(f). Returns the K1 launches of all their
    ranks and of the unsharded reference run."""
    import tempfile

    with tempfile.TemporaryDirectory() as tmp:
        k1 = _mesh_cli(tmp)
        for case, n, label in (("nccl", 1, "(b) genes=1 NCCL, 3-gene VB"),
                               ("chains", 2, "(c) chains=2, 3-gene HMC"),
                               ("2d", 4, "(d) chains=2,genes=2, synthetic MCMC"),
                               ("hmc50k", 2, "(e) run_hmc_tree genes=2, 50k x 100"),
                               ("chees", 2, "(f) chains=2, 3-gene ChEES")):
            recs, wall = _torchrun(n, case, tmp)
            keys = [k for k in ("calls", "divergences", "transitions", "draws_shape", "genes",
                                "chains", "draws_finite", "step_size", "advi_iterations",
                                "advi_s", "hmc_s", "draws_per_s", "hmc_draws_per_s",
                                "leapfrog_steps") if k in recs[0]]
            row = dict(run=label, torchrun_wall_s=wall,
                       **_per_rank(recs, "backend", "wall_s", "peak_device_bytes", "k1_shapes",
                                   *keys),
                       collectives=_collectives_row(recs))
            print("phase mesh " + json.dumps(row), flush=True)
            for r in recs:
                if case in ("nccl", "chains", "chees") and r["calls"] != {
                        "SLC16A12": 0, "CYP1A1": 1, "ART3": 0}:
                    raise AssertionError(f"mesh {case}: calls {r['calls']} differ from (0, 1, 0)")
                if case == "nccl" and "nccl" not in r["backend"]:
                    raise AssertionError(f"mesh nccl: backend {r['backend']}")
                if case == "chains" and any(d > 0.02 * t for d, t in zip(r["divergences"],
                                                                        r["transitions"])):
                    raise AssertionError(f"mesh chains: divergences {r['divergences']}")
                if not r.get("draws_finite", True):
                    raise AssertionError(f"mesh {case}: non-finite draws")
                if case == "hmc50k" and r["step_size"] < 1e-2:
                    raise AssertionError(f"mesh hmc50k: step size {r['step_size']} < 1e-2")
                if case in ("nccl", "hmc50k"):
                    bad = [c for c in _collectives_row([r]) if c["logp_all_reduce"]
                           != c["k1_launches"]]
                    if bad:
                        raise AssertionError(f"mesh {case}: not one all-reduce per "
                                             f"evaluation: {bad}")
            k1 += sum(r["launches"]["nb_glm_delta"] for r in recs)
    return k1


# The two NUTS paths take most of the run (each batched evaluation is some
# 250 eager launches, and a leaf ends in a host sync), and phase cli's 50k
# runs are mostly host work: they run in child processes of this script on
# the same card, started once phase kernel has taken its device times alone,
# beside the parent's phases hmc and e2e.
E2E_NUTS = "3-gene NUTS approx"
CHILDREN = ("nuts", "e2e-nuts", "cli", "nuts-tree", "sbc1")
LATER_CHILD = ("mesh", "cli")  # started when the second has ended
CHILD_RESULT = "chip_smoke child result "


def _run_child(name, counts_df, device):
    """`python3 chip_smoke.py --child nuts|e2e-nuts|cli|nuts-tree|sbc1|mesh`:
    the phase, then one line with the launch counts of its paths, its K1
    launches and the digests of its draws."""
    k1 = 0
    if name == "nuts":
        phase_nuts(counts_df, device)
    elif name == "nuts-tree":
        phase_nuts_tree(counts_df, device)
    elif name == "sbc1":
        phase_sbc1(device)
    elif name == "cli":
        k1 = phase_cli(counts_df, device)
    elif name == "mesh":
        k1 = phase_mesh(counts_df, device)
    else:
        k1 = phase_e2e(counts_df, device, nuts_only=True)
    print(CHILD_RESULT + json.dumps({"paths": PATH_LAUNCHES, "k1_launches": k1,
                                     "digests": DIGESTS}), flush=True)


def _start_child(name):
    import subprocess
    import tempfile

    out = tempfile.TemporaryFile(mode="w+")
    proc = subprocess.Popen([sys.executable, os.path.abspath(__file__), "--child", name],
                            stdout=out, stderr=subprocess.STDOUT, text=True)
    return proc, out


def _start_children():
    """The children of CHILDREN now, and LATER_CHILD's first once its
    second has ended (from a thread; _finish_children joins it)."""
    import threading

    children = {name: _start_child(name) for name in CHILDREN}
    later, after = LATER_CHILD

    def start_later():
        children[after][0].wait()
        children[later] = _start_child(later)

    thread = threading.Thread(target=start_later, daemon=True)
    thread.start()
    return children, thread


def _finish_children(children, thread):
    """Wait for each child, echo its output, merge its paths' launch counts
    into PATH_LAUNCHES; fail if a child failed. Returns their K1 launches."""
    k1 = 0
    thread.join()
    for name, (proc, out) in children.items():
        rc = proc.wait()
        out.seek(0)
        lines = out.read().splitlines()
        results = [line for line in lines if line.startswith(CHILD_RESULT)]
        print("\n".join(line for line in lines if not line.startswith(CHILD_RESULT)), flush=True)
        if rc != 0 or len(results) != 1:
            raise AssertionError(f"child phase {name} failed (exit code {rc})")
        result = json.loads(results[0][len(CHILD_RESULT):])
        PATH_LAUNCHES.update(result["paths"])
        DIGESTS.update(result["digests"])
        k1 += result["k1_launches"]
    return k1


def main() -> None:
    import torch

    if not torch.cuda.is_available():
        _fail("torch.cuda.is_available() is False: this script needs an NVIDIA GPU")
    sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))
    from ppcseq_tpu_torch import load_counts
    from ppcseq_tpu_torch.ops import _build, nb_kernel
    from ppcseq_tpu_torch.utils.device import gpu_name_and_power_limit, probe

    t_start = time.perf_counter()
    device = torch.device("cuda", 0)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    if len(sys.argv) == 3 and sys.argv[1] == "--child":
        nb_kernel.build_all()  # built by the parent: loads
        _run_child(sys.argv[2], load_counts(), device)
        return
    if len(sys.argv) >= 4 and sys.argv[1] == "--mesh-rank":
        _mesh_rank(sys.argv[2], sys.argv[3:])
        return

    print("phase probe\n" + probe(), flush=True)

    t0 = time.perf_counter()
    nb_kernel.build_all()
    print(f"phase build {len(nb_kernel.SOURCES)} sources in parallel: "
          f"{time.perf_counter() - t0:.2f} s", flush=True)
    for source in nb_kernel.SOURCES:
        info = _build.BUILD_LOG[source]
        regs = [int(n) for n in re.findall(r"Used (\d+) registers", info["log"])]
        spills = sum(int(n) for n in re.findall(r"(\d+) bytes spill stores", info["log"]))
        print(f"phase build {source}: cached={info['cached']} kernels={len(regs)} "
              f"registers={min(regs, default=0)}-{max(regs, default=0)} "
              f"spill_store_bytes={spills}", flush=True)

    phase_host()
    counts_df = load_counts()
    kernel_rows = phase_kernel(counts_df, device)
    phase_forms(counts_df, device)
    children, thread = _start_children()
    try:
        hmc_launches = phase_hmc(counts_df, device)
        k1_launches = phase_e2e(counts_df, device)
        phase_dtype_e2e(counts_df, device)
        print(f"phase parent done in {time.perf_counter() - t_start:.1f} s", flush=True)
        k1_launches += _finish_children(children, thread)
        same = DIGESTS["nuts tree"] == DIGESTS["nuts"]
        print(f"phase nuts-tree bitwise equal to phase nuts's first {NUTS_TREE_DRAWS} draws: "
              f"{same}", flush=True)
        if not same:
            raise AssertionError(f"run_nuts over the model's tree drew other numbers: {DIGESTS}")
    finally:
        # on a failure, stop the children first: the thread waits for one
        for proc, _ in list(children.values()):
            if proc.poll() is None:
                proc.kill()
                proc.wait()
        thread.join()
        for proc, out in children.values():
            if proc.poll() is None:
                proc.kill()
                proc.wait()
            out.close()
    # (a) of phase dtype, with the card to itself again
    kernel_rows += phase_dtype_kernels(counts_df, device)
    print(f"phase done in {time.perf_counter() - t_start:.1f} s", flush=True)

    # each kernel's time at the shape its path gives it: K1 and its float64
    # form the ADVI step (1, 21, 515), K2 and its float64 form the bench HMC
    # (128, 21, 515), K3-K5 the scale HMC (8, 100, 50000). "ms" is the device
    # time per call; "call_ms" what a caller waits for one call (CUDA events
    # around it).
    shape_of = {"nb_glm_delta": (1, 515), "nb_glm_plain": (128, 515),
                "nb_glm_delta_f64": (1, 515), "nb_glm_plain_f64": (128, 515)}
    launches = dict(hmc_launches, nb_glm_delta=k1_launches)
    for name in nb_kernel.F64_FORMS:  # the paths of phase dtype
        launches[name] = sum(c.get(name, 0) for c in PATH_LAUNCHES.values())
    kernels = []
    for name, (source, replaces) in nb_kernel.KERNELS.items():
        B, G = shape_of.get(name, (8, 50000))
        row = next(r for r in kernel_rows
                   if r["kernel"] == name and r["B"] == B and r["G"] == G and r["grads"])
        kernels.append({
            "name": name, "route": "cuda", "source": SOURCE_DIR + source, "replaces": replaces,
            "launches": launches[name],
            "launches_by_path": {path: c[name] for path, c in PATH_LAUNCHES.items()
                                 if c.get(name)},
            "max_abs_err": max(r["max_abs_err"] for r in kernel_rows if r["kernel"] == name),
            "ms": row["device_us"] * 1e-3, "device_us": row["device_us"],
            "ms_source": row["device_us_source"],
            "call_ms": row["call_ms"], "plain_ms": row["plain_ms"],
            "bound_ms": row["bound_us"] * 1e-3, "bound_us": row["bound_us"],
            "bound_by": row["bound_by"], "share_of_bound": row["share_of_bound"],
            "library_ms": None,  # no single PyTorch call computes this function
        })
    print(gpu_name_and_power_limit(), flush=True)
    print(json.dumps({"kernels": kernels}), flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)


if __name__ == "__main__":
    main()
