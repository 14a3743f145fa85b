"""ppcseq_tpu_torch — the PyTorch + CUDA port of ppcseq_tpu.

Posterior-predictive-check outlier detection for bulk RNA-seq: the
hierarchical negative-binomial GLM fitted by meanfield ADVI or jittered
HMC, on-device posterior-predictive credible intervals, and the two-pass
truncation-refit procedure, with the model's likelihood as hand-written
CUDA kernels for Hopper (csrc/*.cu, wrapped in ops/nb_kernel.py). ppcseq_tpu (JAX) is the reference it is
tested against; this package imports no JAX.
"""

from ppcseq_tpu_torch.data.datasets import load_counts
from ppcseq_tpu_torch.pipeline.identify import identify_outliers

__version__ = "0.1.0"

__all__ = ["identify_outliers", "load_counts"]
