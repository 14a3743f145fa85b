"""Gene and chain sharding over a torch.distributed DeviceMesh
(ppcseq_tpu/parallel/sharding.py).

The reference fans the likelihood out over threads and MPI ranks inside
every fit (map_rect, inst/stan/negBinomial_MPI.stan:226-240). JAX
annotates arrays with NamedShardings and lets GSPMD insert the psums. Here
every rank of the mesh runs the same program (SPMD) on its own slice, and
the collectives are explicit:

- `genes` axis: a rank holds the contiguous gene range [g0, g1) of the
  model data (`shard_data`) and of the per-gene parameters. Its state is a
  flat vector in the global layout with G replaced by its own gene count:
  [6 scalars, intercept[g0:g1], sigma_raw[g0:g1], alpha_sub_1[K],
  alpha_2]. The scalars and the checked-gene blocks are replicated: every
  rank holds them, and they stay bitwise equal because every rank applies
  the same updates to them from the same all-reduced values.
- `chains` axis: a rank runs its own contiguous slice of the chain batch.

`Layout` carries both and does every reduction a fit needs:
- `reduce`: a rank's local log density (nb_model.log_joint(shard=)) and its
  gradient become the global ones in ONE all-reduce over the genes group:
  the values, the gradient of every replicated coordinate, and any extra
  scalars, packed in one float64 buffer. Gene-coordinate gradients need
  nothing from the other ranks. (JAX's contract: one all-reduce per value
  and gradient, tests/test_sharding_guards.py:97-125.)
- `sums`: per-chain sums over the whole state (the ELBO entropy, the
  kinetic energy, NUTS's U-turn dot products), the replicated part added
  once and the gene parts of every rank all-reduced, several sums in one
  all-reduce.
- `chain_sums`, `chain_means`, `chain_counts`, `all`: decisions and
  statistics over the global chain batch, all-reduced over the chains group, so every rank takes every
  branch alike (a rank that branched alone would deadlock the others).
- `gather`: columns of the draws from every rank, as a sum of zero-filled
  buffers.

Only all_reduce is used, gathers included: gloo's CUDA support covers
all_reduce but not every collective. Under gloo a CUDA buffer is staged
through the host (two ranks on one card cannot use NCCL); NCCL reduces on
the card. `COLLECTIVES` counts the all-reduces by purpose, their bytes and
the host seconds spent in them; `reset_collectives()` zeroes it.

CUDA graphs (infer/graphs.py) hold the all-reduces of an NCCL group, as
JAX's compiled programs hold their psums: `Layout.capturable` and
`Layout.all_capturable` say where. Under a capture `all_reduce` does no host
work (no clock, no host copy, no count): it logs the all-reduce for the
Region that holds it (`recording`), and every replay of the Region books it
in COLLECTIVES (`book`), so a run through graphs counts what its eager run
counts, the seconds apart. NCCL cannot set up a communicator during a
capture: a group's first all-reduce is an eager one, which every Region's
warm-up runs before its capture. NCCL refuses an all-reduce over two ranks
or more inside a conditional (IF) node's body, so an all-reduce sits at a
graph's top level: `all_reduce` raises inside a body's capture
(`conditional_body`). A step that decides on the device whether its bodies
run therefore splits each reduction in two halves around the all-reduce
(`reduce_local` / `reduce_finish`, `sums_local` / `sums_finish`), a body
packing the buffer and a later one unpacking it.

Without a mesh nothing here runs: the samplers' default reductions are
the single-device code, bit for bit.

Padding: JAX pads each gene shard to whole 128-lane tiles when that costs
at most 15% more genes (identify.py:138-150), a rule of the TPU's vector
unit. The CUDA kernels' layouts (ops/nb_kernel.layout) need no padding, so
`pad_genes` pads only to a multiple of the genes axis. Padded genes carry
the log joint's standard-normal pseudo-prior.
"""

from __future__ import annotations

import contextlib
import math
import time
from dataclasses import dataclass, replace
from functools import cached_property

import numpy as np
import torch

from ppcseq_tpu_torch.model.nb_model import ModelData, ModelDims

F64 = torch.float64
N_SCALARS = 6

# all-reduces (and their bytes) in all and by purpose, and their host seconds; an
# "_idle" kind is a graph's all-reduce at a step whose bodies did not use it
# (nuts.CapturedTree): it sums a stale buffer that nothing reads
_KINDS = ("logp", "sums", "chains", "check", "gather", "logp_idle", "sums_idle", "chains_idle")
COLLECTIVES = {"all_reduce": 0, "bytes": 0, "seconds": 0.0,
               **{k: 0 for k in _KINDS}, **{f"{k}_bytes": 0 for k in _KINDS}}


def reset_collectives() -> None:
    for k in COLLECTIVES:
        COLLECTIVES[k] = 0.0 if k == "seconds" else 0


def _stages_through_host(group) -> bool:
    import torch.distributed as dist

    return "nccl" not in str(dist.get_backend(group))


_captured = None  # the all-reduces of the capture under way ({COLLECTIVES key: count})
_body = None  # the conditional body whose capture is under way (graphs.when)


@contextlib.contextmanager
def recording():
    """A log of the all-reduces that a CUDA graph captures inside the block,
    in COLLECTIVES' keys (the seconds apart), for the Region that holds
    them."""
    global _captured
    before, _captured = _captured, {}
    try:
        yield _captured
    finally:
        _captured = before


@contextlib.contextmanager
def conditional_body(name: str):
    """Mark the block as the capture of the conditional body `name`, inside
    which all_reduce raises."""
    global _body
    before, _body = _body, name
    try:
        yield
    finally:
        _body = before


def _tally(into: dict, kind: str, nbytes: int, times: int = 1) -> None:
    for k, v in (("all_reduce", 1), ("bytes", nbytes), (kind, 1), (f"{kind}_bytes", nbytes)):
        into[k] = into.get(k, 0) + v * times


def split_idle(counts: dict) -> tuple[dict, dict]:
    """All-reduces by kind (COLLECTIVES' keys, nonzero ones) as (those that
    did work, their totals without the idle ones; the idle ones)."""
    idle = {k: v for k, v in counts.items() if "_idle" in k and v}
    working = {k: v for k, v in counts.items() if k not in idle}
    for total, suffix in (("all_reduce", "_idle"), ("bytes", "_idle_bytes")):
        working[total] = working.get(total, 0) - sum(v for k, v in idle.items()
                                                     if k.endswith(suffix))
    return {k: v for k, v in working.items() if v}, idle


def book_all_reduce(kind: str, nbytes: int, times: int) -> None:
    """Add `times` all-reduces of `nbytes` under `kind` to COLLECTIVES: a
    graph's all-reduce that its caller counts on the device."""
    _tally(COLLECTIVES, kind, nbytes, times)


def book(counts: dict, times: int) -> None:
    """Add `times` x `counts` (a recording's, or any COLLECTIVES keys but
    the seconds) to COLLECTIVES: the all-reduces of a graph replayed
    `times` times."""
    for k, v in counts.items():
        COLLECTIVES[k] += v * times


def all_reduce(buf: torch.Tensor, group, kind: str) -> torch.Tensor:
    """Sum `buf` over `group` in place (counted under `kind`); a CUDA buffer
    goes through the host when the group's backend is gloo. Under a CUDA
    graph capture (an NCCL group: Layout.capturable) the all-reduce becomes
    part of the graph and is logged for its Region (`recording`), not
    counted. Inside a conditional body's capture it raises: NCCL refuses
    it there over two ranks or more."""
    import torch.distributed as dist

    if _body is not None:
        raise RuntimeError(f"an all-reduce ({kind}) inside {_body}: a collective must sit at the "
                           "CUDA graph's top level, not in a conditional node's body")
    nbytes = buf.numel() * buf.element_size()
    if buf.is_cuda and torch.cuda.is_current_stream_capturing():
        if _captured is None:
            raise RuntimeError("an all-reduce under a CUDA graph capture that is not a Region's")
        dist.all_reduce(buf, group=group)
        _tally(_captured, kind, nbytes)
        return buf
    t0 = time.perf_counter()
    if buf.is_cuda and _stages_through_host(group):
        host = buf.cpu()
        dist.all_reduce(host, group=group)
        buf.copy_(host)
    else:
        dist.all_reduce(buf, group=group)
    COLLECTIVES["seconds"] += time.perf_counter() - t0
    _tally(COLLECTIVES, kind, nbytes)
    return buf


def _nccl_on(group, device) -> bool:
    """Whether a graph on `device` can hold `group`'s all-reduces: an NCCL
    group on a CUDA device (gloo stages a CUDA buffer through the host,
    which no capture can hold)."""
    return torch.device(device).type == "cuda" and not _stages_through_host(group)


def _nccl_on(group, device) -> bool:
    """Whether a graph on `device` can hold `group`'s all-reduces: an NCCL
    group on a CUDA device (gloo stages a CUDA buffer through the host,
    which no capture can hold)."""
    return torch.device(device).type == "cuda" and not _stages_through_host(group)


def pad_genes(G: int, n: int) -> int:
    """G rounded up to a multiple of the genes axis size n."""
    return -(-int(G) // int(n)) * int(n)


def mesh_axes(mesh) -> dict:
    """{axis name: size} of a DeviceMesh; TypeError for anything else."""
    names = getattr(mesh, "mesh_dim_names", None)
    if names is None or not hasattr(mesh, "get_group"):
        raise TypeError("mesh must be a torch.distributed DeviceMesh with named axes "
                        f"('genes' and/or 'chains'), not {type(mesh).__name__}")
    return {name: int(mesh.size(i)) for i, name in enumerate(names)}


def mesh_desc(mesh):
    """((axis, size), ...) of a mesh, None without one (the checkpoint
    fingerprint's mesh, as JAX's mesh_desc)."""
    return None if mesh is None else tuple(mesh_axes(mesh).items())


def _axis(mesh, name):
    """(rank, size, group) of this process on a mesh axis."""
    sub = mesh if len(mesh.mesh_dim_names) == 1 else mesh[name]
    return sub.get_local_rank(), sub.size(), sub.get_group()


@dataclass(frozen=True, eq=False)
class GeneShard:
    """A rank's contiguous gene range of the (padded) global dims, and the
    process group of the genes axis (None: no collective, e.g. one process
    computing every shard in turn)."""

    dims: ModelDims
    rank: int = 0
    size: int = 1
    group: object = None

    def __post_init__(self):
        if self.dims.G % self.size:
            raise ValueError(f"G = {self.dims.G} is not a multiple of the genes axis "
                             f"({self.size}): pad it with pad_genes")

    @property
    def G_local(self) -> int:
        return self.dims.G // self.size

    @property
    def g0(self) -> int:
        return self.rank * self.G_local

    @property
    def g1(self) -> int:
        return self.g0 + self.G_local

    @property
    def checked(self) -> tuple[int, int]:
        """The checked genes of this shard as a range of alpha_sub_1."""
        K = self.dims.n_check
        return min(self.g0, K), min(self.g1, K)

    @cached_property
    def local_dims(self) -> ModelDims:
        """The dims of the local flat vector: G is the shard's gene count."""
        return replace(self.dims, G=self.G_local)

    @property
    def dim(self) -> int:
        return self.local_dims.dim

    @cached_property
    def cols(self) -> np.ndarray:
        """The global flat index of each local coordinate."""
        G, D = self.dims.G, self.dims.dim
        return np.concatenate([np.arange(N_SCALARS),
                               N_SCALARS + np.arange(self.g0, self.g1),
                               N_SCALARS + G + np.arange(self.g0, self.g1),
                               np.arange(N_SCALARS + 2 * G, D)])

    @property
    def gene_block(self) -> tuple[int, int]:
        """The local coordinates of the per-gene leaves, [lo, hi)."""
        return N_SCALARS, N_SCALARS + 2 * self.G_local


def shard_data(data: ModelData, shard: GeneShard, device=None) -> ModelData:
    """The shard's genes of every [..., G] field (counts, like_mask,
    gene_mask and the baseline, host copies included), on `device` (the
    data's own by default); X and the exposure stay whole."""
    dev = data.device if device is None else torch.device(device)
    g0, g1 = shard.g0, shard.g1
    fields = {}
    for name in ("counts", "like_mask", "gene_mask", "alpha0", "sigma_raw0", "d0", "sp_d0",
                 "sig_neg_d0", "y_sp0"):
        t = getattr(data, name)
        fields[name] = None if t is None else t[..., g0:g1].to(dev).contiguous()
    host = dict(data.host)
    for name in ("counts", "like_mask", "gene_mask"):
        if name in host:
            host[name] = np.ascontiguousarray(host[name][..., g0:g1])
    return replace(data, X=data.X.to(dev), exposure_rate=data.exposure_rate.to(dev), host=host,
                   **fields)


def local_value_and_grad(local_density, theta):
    """(lp, gradient) of a rank's local density at theta, by autograd:
    nothing reduced."""
    with torch.enable_grad():
        t = theta.detach().requires_grad_(True)
        lp = local_density(t)
        (g,) = torch.autograd.grad(lp.sum(), t)
    return lp.detach(), g


class _Global(torch.autograd.Function):
    """The global log density from a rank's local one: the forward
    evaluates the local value and gradient and reduces both in one
    all-reduce; the backward hands back the reduced gradient."""

    @staticmethod
    def forward(ctx, theta, local_density, layout):
        lp, g, _ = layout.reduce(*local_value_and_grad(local_density, theta))
        ctx.save_for_backward(g)
        return lp

    @staticmethod
    def backward(ctx, grad_lp):
        (g,) = ctx.saved_tensors
        return grad_lp.unsqueeze(-1).to(g.dtype) * g, None, None


@dataclass(eq=False)
class Layout:
    """Where a rank sits in a sharded fit: its gene shard (None: the whole
    state, no gene collective) and its chain slice."""

    genes: GeneShard | None = None
    chains_rank: int = 0
    chains_size: int = 1
    chains_group: object = None
    mesh: object = None

    @classmethod
    def from_mesh(cls, mesh, dims: ModelDims | None = None) -> "Layout":
        axes = mesh_axes(mesh)
        unknown = set(axes) - {"genes", "chains"}
        if unknown:
            raise ValueError(f"mesh axes {tuple(axes)} unknown: name them 'genes' and/or "
                             "'chains'")
        genes = None
        if "genes" in axes:
            if dims is None:
                raise ValueError("a mesh with a 'genes' axis needs the model dims (dims=)")
            rank, size, group = _axis(mesh, "genes")
            genes = GeneShard(dims, rank, size, group)
        out = cls(genes=genes, mesh=mesh)
        if "chains" in axes:
            out.chains_rank, out.chains_size, out.chains_group = _axis(mesh, "chains")
        return out

    # ---- the state ---------------------------------------------------------

    @property
    def gene_collectives(self) -> bool:
        return self.genes is not None and self.genes.group is not None

    @property
    def chain_collectives(self) -> bool:
        return self.chains_group is not None

    def key(self):
        """What a cached graph of this layout's collectives depends on: the
        gene shard and the groups, equal for every Layout of one mesh and
        dims (from_mesh makes a new Layout per run)."""
        g = self.genes
        shard = None if g is None else (g.dims, g.rank, g.size, g.group)
        return shard, self.chains_rank, self.chains_size, self.chains_group

    def capturable(self, device) -> bool:
        """Whether a CUDA graph on `device` can hold the collectives of a
        fit's step (an ADVI step or ELBO, a leapfrog): those over the genes
        group, which must then be NCCL's on a CUDA device (gloo stages a
        CUDA buffer through the host, which no capture can hold). The chain
        collectives run between the steps, eagerly. A sampler takes its
        graph route by this predicate alone (NUTS by all_capturable)."""
        return not self.gene_collectives or _nccl_on(self.genes.group, device)

    def all_capturable(self, device) -> bool:
        """Whether a CUDA graph on `device` can hold every collective of a
        fit, those over the chains group too: NUTS's stride, whose tree
        steps reduce over the genes and decide over the chains on the
        device."""
        return self.capturable(device) and (not self.chain_collectives
                                            or _nccl_on(self.chains_group, device))

    def local(self, x):
        """The local coordinates of a global vector x[..., D]; x itself if
        it is local already (or there is no gene shard)."""
        x = torch.as_tensor(x)
        if self.genes is None or x.shape[-1] == self.genes.dim:
            return x
        if x.shape[-1] != self.genes.dims.dim:
            raise ValueError(f"expected {self.genes.dims.dim} global or {self.genes.dim} "
                             f"local coordinates, got {x.shape[-1]}")
        return x[..., torch.as_tensor(self.genes.cols, device=x.device)]

    def chain_range(self, n_chains: int) -> tuple[int, int]:
        if n_chains % self.chains_size:
            raise ValueError(f"{n_chains} chains do not split over a chains axis of "
                             f"{self.chains_size}")
        per = n_chains // self.chains_size
        return self.chains_rank * per, (self.chains_rank + 1) * per

    # ---- the log density ---------------------------------------------------

    def reduce(self, lp, g=None, extra=()):
        """(lp, g, extra) summed over the genes group in one all-reduce:
        lp [B], the replicated columns of g [B, D_local] and the scalars of
        `extra`. Identity without gene collectives."""
        if not self.gene_collectives:
            return lp, g, tuple(extra)
        buf = all_reduce(self.reduce_local(lp, g, extra), self.genes.group, "logp")
        return self.reduce_finish(buf, lp, g)

    def reduce_local(self, lp, g=None, extra=()):
        """reduce's first half: the float64 buffer that its all-reduce sums,
        [lp, g's replicated columns, extra]."""
        lo, hi = self.genes.gene_block
        parts = [lp.to(F64).reshape(-1)]
        if g is not None:
            parts += [g[..., :lo].to(F64).reshape(-1), g[..., hi:].to(F64).reshape(-1)]
        parts += [torch.as_tensor(e, dtype=F64, device=lp.device).reshape(1) for e in extra]
        return torch.cat(parts)

    def reduce_finish(self, buf, lp, g=None):
        """reduce's second half: (lp, g, extra) from the summed buffer, lp in
        the shape and dtype of the local one and g the local gradient with
        its replicated columns replaced; extra is the rest of the buffer."""
        lo, hi = self.genes.gene_block
        n = lp.numel()
        lp_out = buf[:n].reshape(lp.shape).to(lp.dtype)
        pos = n
        if g is not None:
            g = g.clone()
            head, tail = g[..., :lo], g[..., hi:]
            g[..., :lo] = buf[pos:pos + head.numel()].reshape(head.shape).to(g.dtype)
            pos += head.numel()
            g[..., hi:] = buf[pos:pos + tail.numel()].reshape(tail.shape).to(g.dtype)
            pos += tail.numel()
        return lp_out, g, tuple(buf[pos:])

    def density(self, local_density):
        """theta_local[B, D_local] -> global lp [B], differentiable: the
        gradient is the global one at the local coordinates. One all-reduce
        per call, value and gradient together under grad mode, the value
        alone under no_grad."""
        if not self.gene_collectives:
            return local_density

        def f(theta):
            if torch.is_grad_enabled():
                return _Global.apply(theta, local_density, self)
            return self.reduce(local_density(theta))[0]

        return f

    # ---- reductions over the state and the chains --------------------------

    def sums(self, xs):
        """[sum over the last axis of x, in float64, for x in xs]: over the
        whole (global) state; one all-reduce for all of them."""
        if not self.gene_collectives:
            return [torch.sum(x, dim=-1, dtype=F64) for x in xs]
        rep, gene = self.sums_local(xs)
        buf = all_reduce(gene, self.genes.group, "sums")
        return self.sums_finish(rep, buf, [x.shape[:-1] for x in xs])

    def sums_local(self, xs):
        """sums' first half: (the replicated coordinates' sums, which the
        rank keeps, and the gene coordinates' sums, which the all-reduce
        sums), each one flat float64 vector of the sums in order; without
        gene collectives (the whole sums, None)."""
        if not self.gene_collectives:
            return torch.cat([torch.sum(x, dim=-1, dtype=F64).reshape(-1) for x in xs]), None
        lo, hi = self.genes.gene_block
        rep = [torch.sum(x[..., :lo], dim=-1, dtype=F64) + torch.sum(x[..., hi:], dim=-1,
                                                                     dtype=F64) for x in xs]
        gene = [torch.sum(x[..., lo:hi], dim=-1, dtype=F64) for x in xs]
        return (torch.cat([t.reshape(-1) for t in rep]),
                torch.cat([t.reshape(-1) for t in gene]))

    def sums_finish(self, rep, buf, shapes):
        """sums' second half: the sums of the given shapes from the kept
        part and the summed gene part (None: no gene collectives), each at
        least as long as the shapes' elements."""
        out, pos = [], 0
        for shape in shapes:
            n = math.prod(shape)
            part = rep[pos:pos + n].reshape(shape)
            out.append(part if buf is None else part + buf[pos:pos + n].reshape(shape))
            pos += n
        return out

    def dot(self, a, b):
        return self.sums([a * b])[0]

    def chain_sums(self, xs):
        """[x summed over its leading (chain) axis, for x in xs] over the
        global chain batch: one all-reduce for all of them."""
        sums = [torch.sum(x, dim=0) for x in xs]
        if not self.chain_collectives:
            return sums
        buf = all_reduce(torch.cat([t.reshape(-1).to(F64) for t in sums]), self.chains_group,
                         "chains")
        out, pos = [], 0
        for t in sums:
            out.append(buf[pos:pos + t.numel()].reshape(t.shape).to(t.dtype))
            pos += t.numel()
        return out

    def chain_means(self, xs):
        """[x averaged over its leading (chain) axis, for x in xs] over the
        global chain batch: one all-reduce for all of them."""
        if not self.chain_collectives:
            return [torch.mean(x, dim=0) for x in xs]
        n = xs[0].shape[0] * self.chains_size
        return [t / n for t in self.chain_sums(xs)]

    def chains_mean(self, x):
        """Mean of x[chains_local] over the global chain batch."""
        return self.chain_means([x])[0]

    def chain_counts(self, masks):
        """[how many chains of the global batch have m set, for m in masks],
        one float64 tensor on the device: one all-reduce over the chains
        group. Without one every rank holds every chain (under a genes-only
        mesh each rank's flags come from all-reduced sums, so the ranks
        agree), and the counts are the local ones."""
        counts = torch.stack([m.sum(dtype=F64) for m in masks])
        if not self.chain_collectives:
            return counts
        return all_reduce(counts, self.chains_group, "chains")

    def all(self, flag: bool, device) -> bool:
        """A rank-local flag, true on every rank of the fit."""
        if not (self.gene_collectives or self.chain_collectives):
            return bool(flag)
        buf = torch.tensor([0.0 if flag else 1.0], dtype=F64, device=device)
        for group in (self.genes.group if self.gene_collectives else None, self.chains_group):
            if group is not None:
                all_reduce(buf, group, "check")
        return bool(buf[0] == 0)

    # ---- gathers (sums of zero-filled buffers) -----------------------------

    def gather_chains(self, x):
        """x[chains_local, ...] -> [chains_global, ...] on every rank."""
        if not self.chain_collectives:
            return x
        c = x.shape[0]
        buf = torch.zeros((c * self.chains_size,) + tuple(x.shape[1:]), dtype=x.dtype,
                          device=x.device)
        buf[self.chains_rank * c:(self.chains_rank + 1) * c] = x
        return all_reduce(buf, self.chains_group, "gather")

    def gather(self, x, cols=None):
        """The global columns `cols` (all by default) of x[..., D_local]
        from every gene shard, and with a leading chain axis from every
        chain slice: [..., len(cols)] on every rank, bitwise the owners'
        values."""
        if self.genes is None:
            out = x if cols is None else x[..., torch.as_tensor(cols, device=x.device)]
        else:
            D = self.genes.dims.dim
            cols = np.arange(D) if cols is None else np.asarray(cols)
            where = np.full(D, -1)
            where[self.genes.cols] = np.arange(self.genes.dim)
            lo, hi = N_SCALARS, N_SCALARS + 2 * self.genes.dims.G
            gene_col = (cols >= lo) & (cols < hi)
            own = (where[cols] >= 0) & (gene_col | (self.genes.rank == 0))
            if not self.gene_collectives:
                out = x[..., torch.as_tensor(where[cols], device=x.device)]
            else:
                out = torch.zeros(x.shape[:-1] + (len(cols),), dtype=x.dtype, device=x.device)
                dst = torch.as_tensor(np.flatnonzero(own), device=x.device)
                src = torch.as_tensor(where[cols][own], device=x.device)
                out[..., dst] = x[..., src]
                out = all_reduce(out, self.genes.group, "gather")
        return self.gather_chains(out) if x.dim() == 3 else out
