"""ppcseq_tpu_torch — the PyTorch + CUDA port of ppcseq_tpu.

Posterior-predictive-check outlier detection for bulk RNA-seq: the
hierarchical negative-binomial GLM fitted by meanfield ADVI, jittered
HMC (optionally with ChEES trajectory adaptation) or NUTS, on-device
posterior-predictive credible intervals, and the two-pass truncation-refit
procedure, with the model's likelihood as hand-written CUDA kernels for
Hopper (csrc/*.cu, wrapped in ops/nb_kernel.py). ppcseq_tpu (JAX) is the
reference it is tested against; this package imports no JAX. Every entry point runs on
the card (`device="cuda"`) unless the caller passes another device.
"""

from ppcseq_tpu_torch.data.datasets import load_counts
from ppcseq_tpu_torch.pipeline.identify import identify_outliers

__version__ = "0.1.0"

__all__ = ["identify_outliers", "load_counts"]


def __getattr__(name):
    # Lazy secondary API, as the JAX package's: samplers, variational fits,
    # diagnostics.
    if name == "run_hmc":
        from ppcseq_tpu_torch.infer.hmc import run_hmc

        return run_hmc
    if name == "run_nuts":
        from ppcseq_tpu_torch.infer.nuts import run_nuts

        return run_nuts
    if name in ("fit_advi", "vb_iterative"):
        from ppcseq_tpu_torch.infer import advi

        return getattr(advi, name)
    if name in ("split_rhat", "ess"):
        from ppcseq_tpu_torch.infer import diagnostics

        return getattr(diagnostics, name)
    raise AttributeError(f"module 'ppcseq_tpu_torch' has no attribute {name!r}")
