"""Command-line interface: run the outlier identification on a table file
(the counterpart of ppcseq_tpu/cli.py, with the same flags, defaults and
outputs, plus `--device`).

Reads a tidy CSV/TSV/parquet table, runs `identify_outliers` on one device
(the card unless `--device cpu` is given; without a card the default run
fails), writes:

- `<out>/result.csv` — one row per checked transcript with
  `ppc_samples_failed` / `tot_deleterious_outliers`
- `<out>/sample_wise_data.csv` — the flattened nested tables (one row per
  sample x transcript, with CIs, PPC flags, deleterious calls)
- `<out>/plots/<transcript>.png` — credible-interval plots (with --plots)

Usage:
  python -m ppcseq_tpu_torch input.csv --formula "~ Label" --sample sample \
      --transcript symbol --abundance value --significance PValue \
      --do-check is_significant -o results/ --device cuda

Sharded over several processes (`--mesh`, one process per rank; with a
mesh only rank 0 prints and writes the outputs):
  torchrun --nproc-per-node 4 -m ppcseq_tpu_torch input.csv ... \
      --mesh chains=2,genes=2 --device cpu
"""

from __future__ import annotations

import argparse
import os
import sys

import torch


def build_parser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser(
        prog="ppcseq_tpu_torch",
        description="Posterior-predictive-check outlier detection for RNA-seq DE tables "
                    "(PyTorch + CUDA)",
    )
    p.add_argument("input", help="tidy table (csv/tsv/parquet): sample x transcript x count + covariates")
    p.add_argument("-o", "--output", default="ppcseq_results", help="output directory")
    p.add_argument("--formula", default="~ 1", help='model formula, e.g. "~ Label"')
    p.add_argument("--sample", default="sample", help="sample-id column")
    p.add_argument("--transcript", default="transcript", help="transcript/gene column")
    p.add_argument("--abundance", default="count", help="integer count column")
    p.add_argument("--significance", default="PValue", help="significance column (for control selection)")
    p.add_argument("--do-check", default="do_check", help="boolean column marking transcripts to check")
    p.add_argument("--scaling-factor", default=None, help="optional custom scaling-factor column (skips TMM)")
    p.add_argument("--percent-false-positive-genes", type=float, default=1.0)
    p.add_argument("--negative-controls", type=int, default=500, dest="how_many_negative_controls")
    p.add_argument("--draws-after-tail", type=int, default=10)
    p.add_argument("--full-posterior", action="store_true",
                   help="use MCMC sampling (see --mcmc-sampler; default jittered HMC) "
                        "instead of the default ADVI variational fit")
    p.add_argument("--mcmc-sampler", choices=("hmc", "nuts"), default="hmc",
                   help="sampler for --full-posterior: 'hmc' (jittered-trajectory "
                        "HMC, 128 chains in one batch) or 'nuts' (dynamic-tree "
                        "sampler, chains in lockstep)")
    p.add_argument("--full-ci", action="store_true",
                   help="exact CI extraction instead of the approximated path")
    p.add_argument("--hmc-adapt-trajectory", action="store_true",
                   help="opt-in SNAPER/ChEES trajectory-length adaptation for "
                        "--full-posterior HMC")
    p.add_argument("--seed", type=int, default=None)
    p.add_argument("--cores", type=int, default=None)
    p.add_argument("--device", default="cuda",
                   help="torch device the fits and the CI simulation run on "
                        "(default: the card; 'cpu' runs the kernels' plain versions)")
    p.add_argument("--mesh", default=None, metavar="AXES",
                   help="mesh spec, e.g. 'genes=4' or 'chains=2,genes=2': both passes' "
                        "fits run sharded over that many processes, launched with "
                        "torchrun --nproc-per-node N (the axis product). Axis names: "
                        "'genes' (gene-data-parallel model state) and/or 'chains' "
                        "(split MCMC chain batch)")
    p.add_argument("--checkpoint-dir", default=None,
                   help="persist per-pass fits; a rerun with identical config resumes")
    p.add_argument("--plots", action="store_true", help="write per-transcript CI plots")
    p.add_argument("--json", action="store_true", help="print the summary as JSON to stdout")
    return p


def parse_mesh_spec(spec: str | None, device: str = "cuda"):
    """'genes=2' / 'chains=2,genes=2' -> a DeviceMesh over the processes
    that torchrun started (parallel/multihost.initialize), on `device`'s
    type; the axes in the spec's order. A bad spec is a SystemExit."""
    if spec is None:
        return None
    axes: dict[str, int] = {}
    for part in spec.split(","):
        name, _, count = part.partition("=")
        name = name.strip()
        if name not in ("genes", "chains") or not count.strip().isdigit():
            raise SystemExit(
                f"--mesh: bad axis {part!r} (want e.g. 'genes=4' or 'chains=2,genes=4')")
        if name in axes:
            raise SystemExit(f"--mesh: duplicate axis {name!r}")
        if int(count) < 1:
            raise SystemExit(f"--mesh: axis {name!r} needs at least 1 process, got {count}")
        axes[name] = int(count)
    n = 1
    for size in axes.values():
        n *= size
    world = os.environ.get("WORLD_SIZE")
    if world is None and n > 1:
        raise SystemExit(f"--mesh {spec} needs {n} processes: launch with "
                         f"torchrun --nproc-per-node {n} -m ppcseq_tpu_torch ...")
    if world is not None and int(world) != n:
        raise SystemExit(f"--mesh {spec} needs {n} processes, but WORLD_SIZE is {world}")

    from torch.distributed.device_mesh import init_device_mesh

    from ppcseq_tpu_torch.parallel import multihost

    dev = torch.device(device).type
    if world is None:  # one process, not started by torchrun
        multihost.initialize(dev, init_method=f"tcp://127.0.0.1:{_free_port()}")
    else:
        multihost.initialize(dev)
    return init_device_mesh(dev, tuple(axes.values()), mesh_dim_names=tuple(axes))


def _free_port() -> int:
    import socket

    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def _read_table(path: str):
    import pandas as pd

    if path.endswith((".parquet", ".pq")):
        return pd.read_parquet(path)
    sep = "\t" if path.endswith((".tsv", ".txt")) else ","
    return pd.read_csv(path, sep=sep)


def main(argv=None) -> int:
    args = build_parser().parse_args(argv)
    import pandas as pd

    from ppcseq_tpu_torch import identify_outliers
    from ppcseq_tpu_torch.utils.log import timed

    import torch.distributed as dist

    owns_group = args.mesh is not None and not dist.is_initialized()
    mesh = parse_mesh_spec(args.mesh, args.device)
    with timed("read table"):
        df = _read_table(args.input)
    result = identify_outliers(
        df,
        formula=args.formula,
        sample=args.sample,
        transcript=args.transcript,
        abundance=args.abundance,
        significance=args.significance,
        do_check=args.do_check,
        scaling_factor=args.scaling_factor,
        percent_false_positive_genes=args.percent_false_positive_genes,
        how_many_negative_controls=args.how_many_negative_controls,
        approximate_posterior_inference=not args.full_posterior,
        approximate_posterior_analysis=not args.full_ci,
        mcmc_sampler=args.mcmc_sampler,
        hmc_adapt_trajectory=args.hmc_adapt_trajectory,
        draws_after_tail=args.draws_after_tail,
        seed=args.seed,
        cores=args.cores,
        checkpoint_dir=args.checkpoint_dir,
        mesh=mesh,
        device=args.device,
    )
    if mesh is not None:
        rank = dist.get_rank()
        if owns_group:
            dist.destroy_process_group()
        if rank != 0:  # every rank holds the same result; rank 0 writes it
            return 0

    with timed("write results"):
        os.makedirs(args.output, exist_ok=True)
        summary_cols = [c for c in result.columns if c != "sample_wise_data"]
        summary = result[summary_cols]
        summary.to_csv(os.path.join(args.output, "result.csv"), index=False)

        if len(result):
            flat = pd.concat(
                [
                    swd.assign(**{args.transcript: name})
                    for name, swd in zip(result[args.transcript], result["sample_wise_data"])
                ],
                ignore_index=True,
            )
            flat.to_csv(os.path.join(args.output, "sample_wise_data.csv"), index=False)

    if args.plots and len(result):
        import matplotlib.pyplot as plt

        from ppcseq_tpu_torch import plot_credible_intervals

        plot_dir = os.path.join(args.output, "plots")
        os.makedirs(plot_dir, exist_ok=True)
        with_plots = plot_credible_intervals(result)
        for name, fig in zip(with_plots[args.transcript], with_plots["plot"]):
            safe = "".join(ch if ch.isalnum() or ch in "-._" else "_" for ch in str(name))
            fig.savefig(os.path.join(plot_dir, f"{safe}.png"), dpi=150)
            plt.close(fig)

    if args.json:
        print(summary.to_json(orient="records"))
    else:
        print(summary.to_string(index=False))
    return 0


if __name__ == "__main__":
    sys.exit(main())
