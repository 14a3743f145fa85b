"""The unconstrained parameters by name, and the flat-vector bridge
(ppcseq_tpu/model/params.py).

Leaves (all unconstrained; nb_model gives their constrained meaning):
  lambda_mu, lambda_sigma, lambda_skew, sigma_slope, sigma_intercept,
  sigma_sigma                                 -> scalars (one per batch row)
  intercept, sigma_raw                        -> [G]
  alpha_sub_1                                 -> [K]
  alpha_2                                     -> [C-2, K] (present iff C > 2)

The samplers' state is one flat vector in every case: 6 scalars, then
intercept[G], sigma_raw[G], alpha_sub_1[K] and alpha_2 (JAX's `_offsets`
layout). A gene shard holds the same layout with G replaced by its own
gene count (parallel/sharding.py), so the per-gene leaves of a rank are
contiguous and the scalars and the checked-gene blocks sit at both ends.
The JAX package needed a dict pytree for that, so that GSPMD could carry a
`genes` sharding on the per-gene leaves, and with it the pytree vector
algebra (`tree_add` ... `tree_isfinite_all`); a torch state that is split
by hand needs neither, so that algebra is not ported. A tree here is a
dict of views into a flat vector, with any leading batch axes.
"""

from __future__ import annotations

import torch

SCALAR_NAMES = (
    "lambda_mu",
    "lambda_sigma",
    "lambda_skew",
    "sigma_slope",
    "sigma_intercept",
    "sigma_sigma",
)
GENE_NAMES = ("intercept", "sigma_raw")


def offsets(dims) -> dict:
    """name -> (lo, hi) in the flat vector of `dims` (G, n_check, C)."""
    o = {}
    pos = 0
    for name, size in [(n, 1) for n in SCALAR_NAMES] + [
        ("intercept", dims.G),
        ("sigma_raw", dims.G),
        ("alpha_sub_1", dims.n_check),
        ("alpha_2", dims.n_alpha2),
    ]:
        o[name] = (pos, pos + size)
        pos += size
    return o


def theta_to_tree(theta: torch.Tensor, dims) -> dict:
    """theta[..., D] -> dict of views: scalars [...], vectors [..., n]."""
    o = offsets(dims)
    tree = {n: theta[..., o[n][0]] for n in SCALAR_NAMES}
    for n in ("intercept", "sigma_raw", "alpha_sub_1"):
        tree[n] = theta[..., o[n][0]:o[n][1]]
    if dims.C > 2:
        lo, hi = o["alpha_2"]
        tree["alpha_2"] = theta[..., lo:hi].reshape(theta.shape[:-1] + (dims.C - 2, dims.n_check))
    return tree


def tree_to_theta(tree: dict, dims) -> torch.Tensor:
    """The inverse of theta_to_tree: a dict of leaves with common leading
    axes -> theta[..., D]."""
    batch = tree["intercept"].shape[:-1]
    parts = [tree[n].reshape(batch + (1,)) for n in SCALAR_NAMES]
    parts += [tree["intercept"], tree["sigma_raw"], tree["alpha_sub_1"]]
    if dims.C > 2:
        parts.append(tree["alpha_2"].reshape(batch + (-1,)))
    return torch.cat(parts, dim=-1)


def zeros_tree(dims, dtype=torch.float32, device="cpu") -> dict:
    """A tree of zeros for `dims`, without a batch axis."""
    return theta_to_tree(torch.zeros(dims.dim, dtype=dtype, device=device), dims)
