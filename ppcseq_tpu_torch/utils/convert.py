"""State carried across from the JAX package, as NumPy arrays.

The parity tests build model inputs (and optimizer states) with
ppcseq_tpu and hand them to the port through these functions, so both
packages compute on identical inputs. Nothing here imports JAX: every
field is read with `np.asarray`, which works on JAX arrays and NumPy
arrays alike. θ is a plain vector in both packages, in the same
`_offsets` layout; JAX's tree state (a dict of leaves, model/params.py)
comes across through `theta_from_tree`, and a gene shard's local vector
from the global one through `local_theta`. Unlike the port's entry points,
these helpers default to the CPU (and float64): they serve the CPU parity
tests, where the JAX package runs.
"""

from __future__ import annotations

from dataclasses import replace

import numpy as np
import torch

from ppcseq_tpu_torch.infer.advi import AdamState
from ppcseq_tpu_torch.model.nb_model import ModelData, ModelDims, upload
from ppcseq_tpu_torch.model.params import tree_to_theta

_BASELINE = ("alpha0", "sigma_raw0", "d0", "sp_d0", "sig_neg_d0", "y_sp0")


def model_from_arrays(jax_data, jax_dims, device="cpu", dtype=torch.float64):
    """(ModelData, ModelDims) of the port from a ppcseq_tpu ModelData and
    ModelDims, on `device` in `dtype`."""
    dims = ModelDims(
        S=int(jax_dims.S), G=int(jax_dims.G), C=int(jax_dims.C),
        n_check=int(jax_dims.n_check), G_unpadded=int(jax_dims.G_unpadded),
        non_centered=bool(getattr(jax_dims, "non_centered", False)),
    )
    data = upload(
        {k: np.asarray(getattr(jax_data, k))
         for k in ("counts", "X", "exposure_rate", "like_mask", "gene_mask")},
        device, dtype,
    )
    baseline = {
        k: torch.as_tensor(np.array(getattr(jax_data, k)), dtype=dtype, device=device)
        for k in _BASELINE if getattr(jax_data, k, None) is not None
    }
    return (replace(data, **baseline) if baseline else data), dims


def advi_state_from_arrays(m, log_s, mu_m, mu_s, nu_m, nu_s, count,
                           device="cpu", dtype=torch.float64):
    """ADVI parameters and Adam state from NumPy arrays (e.g. an optax
    ScaleByAdamState's mu/nu/count for the m and log_s leaves)."""
    t = lambda a: torch.as_tensor(np.array(a), dtype=dtype, device=device)  # noqa: E731
    params = {"m": t(m), "log_s": t(log_s)}
    state = AdamState(
        mu={"m": t(mu_m), "log_s": t(mu_s)},
        nu={"m": t(nu_m), "log_s": t(nu_s)},
        count=int(np.asarray(count)),
    )
    return params, state


def theta_from_tree(tree: dict, dims: ModelDims, device="cpu", dtype=torch.float64):
    """The global flat vector [..., D] of a tree state: a dict of arrays by
    leaf name (JAX's unconstrained pytree, leaves with any common leading
    axes)."""
    leaves = {k: torch.as_tensor(np.array(v), dtype=dtype, device=device)
              for k, v in tree.items()}
    return tree_to_theta(leaves, dims)


def local_theta(theta, shard):
    """A gene shard's local vector (parallel/sharding.GeneShard) from the
    global one theta[..., D]."""
    return theta[..., torch.as_tensor(shard.cols, device=theta.device)]
