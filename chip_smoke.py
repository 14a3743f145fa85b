"""Smoke run of the PyTorch + CUDA port on one NVIDIA GPU.

    python3 chip_smoke.py

Phases (each prints lines starting with "phase <name>"; any failure raises,
so the exit code is non-zero):
  1. probe   library, compiler and card versions
  2. build   nvcc-build the three kernel sources from csrc/, in parallel
             (timed)
  3. kernel  the five kernels (K1-K5) against their plain torch versions on
             the card, in float32, at (B, S, G) = (1, 21, 515) and
             (128, 21, 515) on the bundled cohort (15 checked genes + 500
             controls) and (8, 100, 50000) on the synthetic scale cohort;
             K1 and K2 also value-only at (100, 21, 515) (the ELBO) and at
             (1, 100, 600) (the 50k pipeline cohort's ADVI step).
             Value rtol 2e-5, gradient |d|/(1+|g|) < 1e-4; for K3's and
             K5's gradients, where the plain version itself is further than
             1e-4 from its float64 evaluation, the tolerance of
             tests/test_nb_kernel.py and a bound on the kernel's own error
             against float64 (_GRAD_FALLBACK).
             Exactly zero gradients for a masked gene. Per row:
             device_us (device time per call: torch.profiler over many
             back-to-back calls), cuda_kernels_per_call (1 for K1-K5),
             layout (K1-K4: nb_kernel.layout's T, BY, SY, SC), call_ms (median
             CUDA events around one call: what a caller waits), plain_ms,
             and bytes, ops, bound_us, bound_by, share_of_bound
             (= bound_us / device_us) from nb_kernel.work() on this run's
             branch shares.
  4. hmc     jittered HMC at full width: (a) bench.py's configuration
             (bundled cohort, no baseline, so flat_logp(dims) runs K2; ADVI
             warm start, 128 chains, warmup 30, L=48, 83 draws per chain;
             divergences <= 2%); (b) scripts/bench_scale.py's (50,000 x 100
             synthetic cohort with a baseline, 8 chains, warmup 100, L=32,
             125 draws per chain) once through "pallas" (K4+K5) and once
             through "pallas_fused" (K3), each row with the device's busy
             share over a short profiled window of leapfrogs after it. Then
             the log joint at 8 draws of each (b) run through K1, K2, K3 and
             K4, against each route's plain version in float64.
  5. e2e     identify_outliers on the bundled data: the reference's 3-gene
             case on both VB CI paths and on the HMC branch (calls must be
             SLC16A12 0, CYP1A1 1, ART3 0), and the 15-gene README
             configuration (CYP1A1 and LYZ must be called).
Each path runs with the kernel launch counts set to 0 just before it and
read just after; every kernel of the path must have launched. Then the
card's name and power limit, a JSON line describing the kernels (with
each kernel's launches on every path), and, last,
{"ok": true, "device": {...}}.

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


def _device_us(fn, calls: int):
    """(device µs per call, CUDA kernels per call, kernel records per call)
    of fn(), which launches each of its CUDA kernels once: under
    torch.profiler over `calls` back-to-back calls, the sum over the
    distinct kernels of each one's mean self device time. (The profiler may
    drop some kernel records, ~10% in one H100 run, so the records per call
    can fall below the kernels per call; a mean is robust to that.)"""
    import torch
    from torch.profiler import ProfilerActivity, profile

    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        for _ in range(calls):
            fn()
        torch.cuda.synchronize()
    kernels = [e for e in prof.key_averages() if e.device_type.name == "CUDA" and e.count]
    dev_us = sum(e.self_device_time_total / e.count for e in kernels)
    if dev_us <= 0:
        raise AssertionError("torch.profiler recorded no device time")
    return dev_us, len(kernels), sum(e.count for e in kernels) / calls


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


# K3 and K5 compute the gradient in another grouping than their plain
# version. Where the plain float32 gradient is itself 1e-4 or more from
# float64 (so the strict limit is below what float32 resolves), their
# gradients are held instead at tests/test_nb_kernel.py's tolerances for
# them, (rtol, atol(want)), AND their own |d|/(1+|g|) from float64 may be at
# most the stated multiple of the plain version's (measured on the H100: K3
# 1.2x, K5 3.2x). Values have no such fallback: every kernel meets rtol 2e-5.
_GRAD_FALLBACK = {
    "nb_glm_fused": (2e-3, lambda w: 2e-3 * (1.0 + np.abs(w).max()), 2.0),
    "nb_glm_stable_bwd": (3e-3, lambda w: 3e-2, 4.0),
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


def _kernel_case(counts, X, exposure, n_check, B, seed, device):
    """Model data on the card with one fully masked gene and ~2% excluded
    points, and B parameter rows around the smart-init point."""
    import torch

    from ppcseq_tpu_torch.model import nb_model

    rng = np.random.default_rng(seed)
    S, G = counts.shape
    exclude = rng.uniform(size=(S, G)) < 0.02
    masked_gene = G - 1
    exclude[:, masked_gene] = True
    data, dims = nb_model.prepare_data(
        counts, X, exposure, n_check, exclude_mask=exclude, device=device, dtype=torch.float32
    )
    data = nb_model.with_baseline(data, dims)
    theta0 = nb_model.smart_init(data, dims)
    theta = theta0[None, :] + 0.05 * rng.standard_normal((B, dims.dim))
    params, _ = nb_model.unpack(torch.as_tensor(theta, dtype=torch.float32, device=device), dims)
    alpha = nb_model.make_alpha(params, dims).contiguous()
    log_phi = (-params["sigma_raw"]).contiguous()
    return data, alpha, log_phi, masked_gene


def _calls(data, alpha, log_phi, grads=True):
    """kernel name -> (kernel call, plain call), each returning
    (value,) or (value, dalpha, dlog_phi) for the given inputs. With
    grads=False, K1 and K2 run their value-only instantiation."""
    from ppcseq_tpu_torch.model import nb_model
    from ppcseq_tpu_torch.ops import nb_fast, nb_grad, nb_kernel

    def tup(t):
        return t if isinstance(t, tuple) else (t,)

    def bind(d, a, p):
        return {
            "nb_glm_delta": (
                lambda: tup(nb_kernel.launch_delta(d.X, d.counts, d.like_mask, d.d0, a, d.alpha0,
                                                   p, d.sigma_raw0, want_grads=grads)),
                lambda: tup(nb_fast.glm_delta(d.X, d.counts, d.like_mask, d.alpha0, d.sigma_raw0,
                                              d.d0, d.sp_d0, d.sig_neg_d0, d.y_sp0, a, p,
                                              grads))),
            "nb_glm_plain": (
                lambda: tup(nb_kernel.launch_plain(d.X, d.exposure_rate, d.counts, d.like_mask,
                                                   a, p, want_grads=grads)),
                lambda: tup(nb_fast.glm_plain(d.X, d.exposure_rate, d.counts, d.like_mask, a, p,
                                              grads))),
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
                lambda: (None, *nb_kernel.launch_stable_bwd(d.X, d.exposure_rate, d.counts,
                                                            d.like_mask, a, p)),
                lambda: (None, *nb_grad.likelihood_grads(d.X, d.exposure_rate, d.counts,
                                                         d.like_mask, a, p))),
        }

    d64 = dataclasses.replace(data, **{
        f.name: getattr(data, f.name).double() for f in dataclasses.fields(data)
        if f.name != "host" and getattr(data, f.name) is not None
        and getattr(data, f.name).is_floating_point()})
    return bind(data, alpha, log_phi), bind(d64, alpha.double(), log_phi.double())


def _drop_none(t):
    return tuple(x for x in t if x is not None)


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
    # controls); the scale HMC
    cases = [(1, bundled, None, True), (100, bundled, k12, False), (128, bundled, None, True),
             (1, (c600, X600, e600, 100), k12, True), (8, (c50k, X50k, e50k, 100), None, True)]

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
            kern, plain = _drop_none(kern_fn()), _drop_none(plain_fn())
            plain64 = _drop_none(calls64[name][1]())
            torch.cuda.synchronize()
            has_value = name != "nb_glm_stable_bwd"
            if not has_value:  # compare gradients only: a dummy equal value
                kern, plain, plain64 = ((torch.ones(1),) + t for t in (kern, plain, plain64))
            val_rel, grad_err, mabs = _errors(kern, plain)
            k64 = _errors(kern, plain64)[:2]
            p64 = _errors(plain, plain64)[:2]
            value_ok = not has_value or val_rel < 2e-5
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
            dev_us, n_cuda, n_records = _device_us(kern_fn, reps)
            w = nb_kernel.work(name, B, S, C, G, want_grads=grads, shares=shares)
            lay = (None if name == "nb_glm_stable_bwd" else
                   {k: v for k, v in nb_kernel.layout(name, B, S, C, G, grads).items()
                    if k in ("T", "BY", "SY", "SC")})
            row = dict(kernel=name, B=B, S=S, G=G, grads=grads, layout=lay,
                       value_rel_err=val_rel if has_value else None,
                       grad_err=grad_err, max_abs_err=mabs,
                       kernel_vs_f64=k64, plain_vs_f64=p64,
                       grad_limit=grad_limit, masked_gene_zero_grad=zero,
                       finite=finite, device_us=dev_us, cuda_kernels_per_call=n_cuda,
                       kernel_records_per_call=n_records,
                       call_ms=t_k, plain_ms=t_p, bytes=w["bytes"], ops=w["ops"],
                       bound_us=w["bound_us"], bound_by=w["bound_by"],
                       share_of_bound=w["bound_us"] / dev_us,
                       kernel_points_per_s=B * S * G / (dev_us * 1e-6), branch_shares=shares)
            if name == "nb_glm_stable_bwd":  # K4 and K5 together, one gradient step
                fwd = calls["nb_glm_stable_fwd"][0]
                row["k4_plus_k5_ms"] = _time_ms(lambda: (fwd(), kern_fn()), reps=20)
                row["k4_plus_k5_device_us"] = _device_us(lambda: (fwd(), kern_fn()), reps)[0]
            print("phase kernel " + json.dumps(row), flush=True)
            if not ok:
                raise AssertionError(f"{name} disagrees with its plain version at B={B}, S={S}, "
                                     f"G={G}: {row}")
            rows.append(row)
        del data, alpha, log_phi, calls, calls64
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


def _hmc_run(data, dims, likelihood, *, chains, warmup, draws, L, seed, device):
    """ADVI warm start + run_hmc through flat_logp(dims, likelihood), timed."""
    import torch

    from ppcseq_tpu_torch.infer.advi import fit_advi
    from ppcseq_tpu_torch.infer.hmc import run_hmc
    from ppcseq_tpu_torch.model import nb_model

    logp = nb_model.flat_logp(dims, likelihood)
    gen = torch.Generator(device=device).manual_seed(seed)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    warm = fit_advi(lambda th: logp(th, data), dims.dim, gen,
                    init_mean=nb_model.smart_init(data, dims), tol_rel_obj=0.01,
                    learning_rate=0.3, eval_every=50, grad_samples=4, device=device)
    torch.cuda.synchronize()
    t1 = time.perf_counter()
    res = run_hmc(logp, dims.dim, gen, data=data, num_chains=chains, num_warmup=warmup,
                  num_draws=draws, num_leapfrog=L, init_theta=warm.mean,
                  inv_mass=torch.exp(2.0 * warm.log_sd), device=device)
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
               draws_finite=bool(torch.isfinite(res.draws).all()))
    return res, row


def _busy_window(data, dims, likelihood, device):
    """The device's busy share over a short HMC run through flat_logp(dims,
    likelihood) (8 chains, 4 + 4 iterations of 8 leapfrogs, after one
    unprofiled run): the CUDA kernels' device time (torch.profiler, CUDA
    activity only) over the window's wall."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    from ppcseq_tpu_torch.infer.hmc import run_hmc
    from ppcseq_tpu_torch.model import nb_model

    logp = nb_model.flat_logp(dims, likelihood)
    gen = torch.Generator(device=device).manual_seed(2)
    init = nb_model.smart_init(data, dims)

    def window():
        return run_hmc(logp, dims.dim, gen, data=data, num_chains=8, num_warmup=4, num_draws=4,
                       num_leapfrog=8, init_theta=init, device=device)

    window()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        res = window()
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
    busy = sum(e.self_device_time_total for e in prof.key_averages()
               if e.device_type.name == "CUDA") * 1e-6
    return dict(window_leapfrogs=res.num_leapfrog, window_wall_s=wall, window_device_s=busy,
                device_busy_share=busy / wall)


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
                   **_busy_window(data, dims, likelihood, device))
        print("phase hmc " + json.dumps(row), flush=True)
        if not row["draws_finite"]:
            raise AssertionError(f"hmc scale {likelihood}: non-finite draws")
        _density_check(data, dims, res.draws[:, -1, :], device)
        del res
        torch.cuda.empty_cache()
    return launches


def phase_e2e(counts_df, device):
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
        ("15-gene VB", fifteen, dict(percent_false_positive_genes=5)),
    ]
    launches = 0
    for name, df, kw in plan:
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
            row.update(hmc_divergences=[int(f.divergences.sum()) for f in fits],
                       hmc_step_size=[f.step_size for f in fits],
                       hmc_mean_accept=[float(f.accept_prob.mean()) for f in fits],
                       draws_finite=all(bool(torch.isfinite(f.draws).all()) for f in fits))
        print("phase e2e " + json.dumps(row), flush=True)
        if not row["bounds_finite"] or not row.get("draws_finite", True):
            raise AssertionError(f"{name}: non-finite output")
        if name.startswith("3-gene") and calls != {"SLC16A12": 0, "CYP1A1": 1, "ART3": 0}:
            raise AssertionError(f"{name}: calls {calls} differ from the reference's (0, 1, 0)")
        if name.startswith("15-gene") and not (calls.get("CYP1A1", 0) >= 1 and calls.get("LYZ", 0) >= 1):
            raise AssertionError(f"{name}: CYP1A1 and LYZ must both be called, got {calls}")
    return launches


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

    counts_df = load_counts()
    kernel_rows = phase_kernel(counts_df, device)
    hmc_launches = phase_hmc(counts_df, device)
    k1_launches = phase_e2e(counts_df, device)
    print(f"phase done in {time.perf_counter() - t_start:.1f} s", flush=True)

    # each kernel's time at the shape its path gives it: K1 the ADVI step
    # (1, 21, 515), K2 the bench HMC (128, 21, 515), K3-K5 the scale HMC
    # (8, 100, 50000). "ms" is the device time per call; "call_ms" what a
    # caller waits for one call (CUDA events around it).
    shape_of = {"nb_glm_delta": (1, 515), "nb_glm_plain": (128, 515)}
    launches = dict(hmc_launches, nb_glm_delta=k1_launches)
    kernels = []
    for name, (source, replaces) in nb_kernel.KERNELS.items():
        B, G = shape_of.get(name, (8, 50000))
        row = next(r for r in kernel_rows
                   if r["kernel"] == name and r["B"] == B and r["G"] == G and r["grads"])
        kernels.append({
            "name": name, "route": "cuda", "source": SOURCE_DIR + source, "replaces": replaces,
            "launches": launches[name],
            "launches_by_path": {path: c[name] for path, c in PATH_LAUNCHES.items() if c[name]},
            "max_abs_err": max(r["max_abs_err"] for r in kernel_rows if r["kernel"] == name),
            "ms": row["device_us"] * 1e-3, "device_us": row["device_us"],
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
