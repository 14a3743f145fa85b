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

`state_spec` is the samplers' bridge to a state of another structure, as
JAX's samplers take "an int D, an example array, or a pytree": a
`StateSpec` flattens such a state to [..., D] and back, keeping any
leading batch axes. Its leaves are ordered as `jax.tree.leaves` orders a
dict (sorted keys, depth first), so a flat vector here is JAX's
`ravel_pytree` of the same tree. The model's own tree, given with its dims,
keeps the layout above instead (`theta_to_tree`/`tree_to_theta`).
"""

from __future__ import annotations

from dataclasses import dataclass, replace

import numpy as np
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


@dataclass(frozen=True)
class StateSpec:
    """The flat layout of a sampler state: `leaves` is ((path, shape), ...)
    in flattening order, a path being the tuple of dict keys down to the
    leaf (() for a state that is one tensor). With `dims` the state is the
    model's tree, laid out by tree_to_theta (a gene shard's by its local
    dims); `flat` marks a state that is a [D] vector already, whose
    flatten and unflatten hand the tensor back as it is."""

    leaves: tuple
    dim: int
    dims: object = None
    flat: bool = False

    @property
    def structured(self) -> bool:
        return not self.flat

    def localized(self, local_dims) -> "StateSpec":
        """The spec of a gene shard's local state (the model's tree only)."""
        return self if self.dims is None else replace(self, dims=local_dims,
                                                      dim=local_dims.dim)

    def flatten(self, state, dtype=None, device=None) -> torch.Tensor:
        """state (leaves with common leading batch axes) -> [..., D]. A
        tensor or array given for a dict state is taken as flat already."""
        if self.flat or (self.leaves[0][0] and not isinstance(state, dict)):
            return torch.as_tensor(state, dtype=dtype, device=device)
        if self.dims is not None:
            tree = tree_map(lambda x: torch.as_tensor(x, dtype=dtype, device=device), state)
            return tree_to_theta(tree, self.dims)
        parts = []
        for path, shape in self.leaves:
            x = torch.as_tensor(_get(state, path), dtype=dtype, device=device)
            parts.append(x.reshape(x.shape[:x.dim() - len(shape)] + (-1,)))
        return torch.cat(parts, dim=-1)

    def unflatten(self, x):
        """[..., D] -> the state's structure, leaves [..., *shape] (views
        of x where it is a tensor; NumPy leaves from a NumPy x)."""
        if self.flat:
            return x
        if isinstance(x, np.ndarray):
            return tree_map(lambda t: t.numpy(), self.unflatten(torch.from_numpy(x)))
        batch = tuple(x.shape[:-1])
        if self.dims is not None:
            return theta_to_tree(x, self.dims)
        out, pos = {}, 0
        for path, shape in self.leaves:
            size = int(np.prod(shape, dtype=np.int64))
            leaf = x[..., pos:pos + size].reshape(batch + tuple(shape))
            pos += size
            if not path:
                return leaf
            node = out
            for key in path[:-1]:
                node = node.setdefault(key, {})
            node[path[-1]] = leaf
        return out

    def bind(self, log_density):
        """A density of the flat state [B, D] from one of this structure:
        the samplers' batched form of JAX's vmapped pytree density. The
        arguments after the state pass through; a gene `shard=` keyword
        unflattens in the shard's local layout."""
        if self.flat:
            return log_density

        def flat_density(theta, *args, **kwargs):
            shard = kwargs.get("shard")
            spec = self if shard is None else self.localized(shard.local_dims)
            return log_density(spec.unflatten(theta), *args, **kwargs)

        return flat_density


def tree_map(fn, tree):
    """fn on every leaf of a (nested) dict; a non-dict is a leaf."""
    if isinstance(tree, dict):
        return {k: tree_map(fn, v) for k, v in tree.items()}
    return fn(tree)


def _get(tree, path):
    for key in path:
        tree = tree[key]
    return tree


def _leaves(proto, path=()):
    if isinstance(proto, dict):
        if not proto:
            raise ValueError(f"an empty dict at {path or 'the root'} of the state prototype")
        return [leaf for key in sorted(proto) for leaf in _leaves(proto[key], path + (key,))]
    return [(path, tuple(np.shape(proto)))]


def model_tree_names(dims) -> set:
    """The keys of the model's tree for `dims`."""
    names = set(SCALAR_NAMES) | {"intercept", "sigma_raw", "alpha_sub_1"}
    return names | {"alpha_2"} if dims.C > 2 else names


def state_spec(prototype, dims=None) -> StateSpec:
    """The StateSpec of a prototype: an int D (the flat [D] state), an
    example tensor or array of any shape, or a dict of those (nested dicts
    too). With `dims`, a dict whose keys are the model tree's
    (model_tree_names) is the model's tree and keeps the model's flat
    layout; any other prototype ignores `dims`."""
    if isinstance(prototype, (int, np.integer)) and not isinstance(prototype, bool):
        return StateSpec(leaves=(((), (int(prototype),)),), dim=int(prototype), flat=True)
    if isinstance(prototype, dict) and dims is not None and set(prototype) == model_tree_names(dims):
        leaves = tuple(_leaves(prototype))
        size = sum(int(np.prod(s, dtype=np.int64)) for _, s in leaves)
        if size != dims.dim:
            raise ValueError(f"the model tree prototype has {size} coordinates; dims say "
                             f"{dims.dim}")
        return StateSpec(leaves=leaves, dim=dims.dim, dims=dims)
    leaves = tuple(_leaves(prototype))
    size = sum(int(np.prod(s, dtype=np.int64)) for _, s in leaves)
    return StateSpec(leaves=leaves, dim=size, flat=leaves[0][1] == (size,) and not leaves[0][0])
