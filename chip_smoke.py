"""Smoke run of the PyTorch + CUDA port on one NVIDIA GPU.

    python3 chip_smoke.py

Phases (each prints one line; any failure raises, so the exit code is
non-zero):
  1. probe   library, compiler and card versions
  2. build   nvcc-build the likelihood kernel from csrc/ (timed)
  3. kernel  the kernel against its plain torch version on the card, in
             float32, at the pipeline's shapes: (B, S, G) = (1, 21, 515)
             and (100, 21, 515) on the bundled cohort (15 checked genes +
             500 controls), (1, 100, 50000) on the synthetic scale cohort.
             Value rtol 2e-5, gradient |d|/(1+|g|) < 1e-4, exactly zero
             gradients for a masked gene; median CUDA-event times.
  4. e2e     identify_outliers on the bundled data: the reference's 3-gene
             case on both CI paths (calls must be SLC16A12 0, CYP1A1 1,
             ART3 0) and the 15-gene README configuration twice (CYP1A1 and
             LYZ must be called), counting the kernel's launches.
Then the card's name and power limit, a JSON line describing the kernel,
and, last, {"ok": true, "device": {...}}.

With no CUDA device it exits non-zero at once and prints no result.
"""

from __future__ import annotations

import json
import os
import statistics
import sys
import time

import numpy as np


def _fail(msg: str) -> None:
    print(f"chip_smoke: {msg}", file=sys.stderr)
    sys.exit(1)


def _time_ms(fn, reps: int = 30, warmup: int = 5) -> float:
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


def _errors(got, want):
    """(max relative error of the value, max gradient |d|/(1+|g|), max
    absolute error) between two (value, dalpha, dlog_phi) tuples; the
    gradients may be absent."""
    g = [t.double().cpu().numpy() for t in got]
    w = [t.double().cpu().numpy() for t in want]
    value = float(np.max(np.abs(g[0] - w[0]) / np.abs(w[0])))
    grad = max((float(np.max(np.abs(a - b) / (1.0 + np.abs(b)))) for a, b in zip(g[1:], w[1:])),
               default=0.0)
    return value, grad, max(float(np.max(np.abs(a - b))) for a, b in zip(g, w))


def _bundled_prep(counts_df, check_genes, controls):
    """Host prep of identify_outliers for one configuration: (model data
    arrays, design, sorted sample names, exposure by sample)."""
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


def phase_kernel(counts_df, device):
    import torch

    from ppcseq_tpu_torch.ops import nb_fast, nb_kernel
    from ppcseq_tpu_torch.utils.synthetic import synthetic_cohort

    fifteen = sorted(counts_df.loc[counts_df.FDR < 0.01, "symbol"].unique())
    md = _bundled_prep(counts_df, fifteen, 500)
    bundled = (md.counts, md.X, md.exposure_rate, md.n_check)
    c50k, X50k, e50k, _ = synthetic_cohort(n_genes=50000, n_samples=100, n_check=100, seed=0)
    cases = [(1, bundled), (100, bundled), (1, (c50k, X50k, e50k, 100))]

    rows, max_abs = [], 0.0
    for B, (counts, X, exposure, n_check) in cases:
        data, alpha, log_phi, g_m = _kernel_case(counts, X, exposure, n_check, B, 7, device)
        S, G = data.counts.shape
        kargs = (data.X, data.counts, data.like_mask, data.d0, alpha, data.alpha0,
                 log_phi, data.sigma_raw0)
        pargs = (data.X, data.counts, data.like_mask, data.alpha0, data.sigma_raw0,
                 data.d0, data.sp_d0, data.sig_neg_d0, data.y_sp0, alpha, log_phi)
        kern = nb_kernel.launch(*kargs, want_grads=True)
        kern_v = nb_kernel.launch(*kargs, want_grads=False)
        plain = nb_fast.glm_delta(*pargs, want_grads=True)
        # the plain version in float64 on the same (float32-rounded) inputs:
        # how far each float32 evaluation is from exact
        plain64 = nb_fast.glm_delta(*(t.double() if t.is_floating_point() else t for t in pargs),
                                    want_grads=True)
        torch.cuda.synchronize()
        val_rel, grad_err, mabs = _errors(kern, plain)
        val_only_rel, _, mabs_v = _errors((kern_v,), plain[:1])
        max_abs = max(max_abs, mabs, mabs_v)
        vs64 = dict(zip(
            ("kernel_value_rel_err_vs_f64", "kernel_grad_err_vs_f64"), _errors(kern, plain64)[:2]
        ))
        vs64.update(zip(
            ("plain_value_rel_err_vs_f64", "plain_grad_err_vs_f64"), _errors(plain, plain64)[:2]
        ))
        zero_masked = bool((kern[1][:, :, g_m] == 0).all() and (kern[2][:, g_m] == 0).all())
        finite = all(bool(torch.isfinite(t).all()) for t in kern)
        ok = val_rel < 2e-5 and val_only_rel < 2e-5 and grad_err < 1e-4 and zero_masked and finite

        t_k = _time_ms(lambda: nb_kernel.launch(*kargs, want_grads=True))
        t_kv = _time_ms(lambda: nb_kernel.launch(*kargs, want_grads=False))
        t_p = _time_ms(lambda: nb_fast.glm_delta(*pargs, want_grads=True))
        t_pv = _time_ms(lambda: nb_fast.glm_delta(*pargs, want_grads=False))
        row = dict(B=B, S=S, G=G, value_rel_err=val_rel, value_only_rel_err=val_only_rel,
                   grad_err=grad_err, **vs64, masked_gene_zero_grad=zero_masked, finite=finite,
                   kernel_ms=t_k, kernel_value_only_ms=t_kv, plain_ms=t_p,
                   plain_value_only_ms=t_pv,
                   kernel_points_per_s=B * S * G / (t_k * 1e-3))
        print("phase kernel " + json.dumps(row), flush=True)
        if not ok:
            raise AssertionError(f"kernel disagrees with its plain version at B={B}, S={S}, G={G}")
        rows.append(row)
    return rows, max_abs


def phase_e2e(counts_df, device):
    import torch

    from ppcseq_tpu_torch import identify_outliers
    from ppcseq_tpu_torch.ops import nb_kernel

    common = dict(formula="~ Label", sample="sample", transcript="symbol",
                  abundance="value", significance="PValue", do_check="is_significant",
                  seed=42, device=device)
    runs = []
    three = counts_df.assign(is_significant=counts_df.symbol.isin(["SLC16A12", "CYP1A1", "ART3"]))
    fifteen = counts_df.assign(is_significant=counts_df.FDR < 0.01)
    plan = [
        ("3-gene approx", three, dict(percent_false_positive_genes=1, how_many_negative_controls=50,
                                      approximate_posterior_analysis=True)),
        ("3-gene exact", three, dict(percent_false_positive_genes=1, how_many_negative_controls=50,
                                     approximate_posterior_analysis=False)),
        ("15-gene cold", fifteen, dict(percent_false_positive_genes=5)),
        ("15-gene warm", fifteen, dict(percent_false_positive_genes=5)),
    ]
    nb_kernel.LAUNCHES = 0
    for name, df, kw in plan:
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        res = identify_outliers(df, **common, **kw)
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        calls = dict(zip(res.symbol, map(int, res.tot_deleterious_outliers)))
        bounds = np.concatenate([
            swd[[".lower", ".upper"]].to_numpy(np.float64).ravel() for swd in res.sample_wise_data
        ])
        row = dict(run=name, wall_s=wall, vb_iterations=list(res.attrs["vb_iterations"]),
                   calls=calls, bounds_finite=bool(np.isfinite(bounds).all()))
        print("phase e2e " + json.dumps(row), flush=True)
        if not row["bounds_finite"]:
            raise AssertionError(f"{name}: non-finite credible-interval bounds")
        if name.startswith("3-gene") and calls != {"SLC16A12": 0, "CYP1A1": 1, "ART3": 0}:
            raise AssertionError(f"{name}: calls {calls} differ from the reference's (0, 1, 0)")
        if name.startswith("15-gene") and not (calls.get("CYP1A1", 0) >= 1 and calls.get("LYZ", 0) >= 1):
            raise AssertionError(f"{name}: CYP1A1 and LYZ must both be called, got {calls}")
        runs.append(row)
    launches = nb_kernel.LAUNCHES
    print(f"phase e2e launches nb_glm_delta={launches}", flush=True)
    if launches <= 0:
        raise AssertionError("the main path never launched the likelihood kernel")
    return runs, launches


def main() -> None:
    import torch

    if not torch.cuda.is_available():
        _fail("torch.cuda.is_available() is False: this script needs an NVIDIA GPU")
    sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))
    from ppcseq_tpu_torch import load_counts
    from ppcseq_tpu_torch.ops import _build, nb_kernel
    from ppcseq_tpu_torch.utils.device import gpu_name_and_power_limit, probe

    device = torch.device("cuda", 0)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False

    print("phase probe\n" + probe(), flush=True)

    t0 = time.perf_counter()
    nb_kernel._launcher()
    info = _build.BUILD_LOG[nb_kernel.SOURCE]
    ptxas = " | ".join(l.strip() for l in info["log"].splitlines() if "registers" in l or "spill" in l)
    print(f"phase build {nb_kernel.SOURCE}: {time.perf_counter() - t0:.2f} s "
          f"(cached={info['cached']}) {ptxas}", flush=True)

    counts_df = load_counts()
    rows, max_abs = phase_kernel(counts_df, device)
    _, launches = phase_e2e(counts_df, device)

    main_row = rows[0]  # (1, 21, 515): the shape of each ADVI step's call
    kernels = {"kernels": [{
        "name": "nb_glm_delta",
        "route": "cuda",
        "source": "ppcseq_tpu_torch/csrc/nb_glm_delta.cu",
        "replaces": "ppcseq_tpu/ops/nb_kernel.py:487",
        "launches": launches,
        "max_abs_err": max_abs,
        "ms": main_row["kernel_ms"],
        "plain_ms": main_row["plain_ms"],
    }]}
    print(gpu_name_and_power_limit(), flush=True)
    print(json.dumps(kernels), flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)


if __name__ == "__main__":
    main()
