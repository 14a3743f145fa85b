"""Multi-chain NUTS on a flat [chains, D] state, in torch
(ppcseq_tpu/infer/nuts.py). A structured state (JAX's pytree prototype)
runs as its flat vector (model/params.state_spec).

Multinomial NUTS (Hoffman & Gelman 2014; Betancourt 2017) with the
generalized U-turn criterion, built iteratively with O(max_depth) momentum
checkpoints (Phan et al., arXiv:1912.11554), and Stan's windowed warmup:
dual-averaged step size (target accept 0.8) and a diagonal Welford mass
matrix over expanding windows (init 75, term 50, base window 25), each
window's end restarting the dual averaging at the current step size.

JAX vmaps a per-chain while_loop. Here the chains run in lockstep:
- the trajectory loop runs over depth while any chain is still building;
- inside it the subtree loop runs over leaves while any chain is still
  active in that subtree. Every active chain is at the same leaf index;
  its checkpoint slot range comes from a device table (`ckpt_table`) at a
  device leaf counter, and the U-turn test covers all max_depth + 1 slots,
  masked to that range, as JAX's scan does: one tensor op over [chains,
  slots, D];
- each chain keeps its own direction, step size and inverse mass, as
  device tensors;
- a chain that is done is still evaluated in the batched log density (one
  launch for all chains), but its state never changes.
Each chain's own leapfrogs (`num_leapfrog`) are counted apart from the
lockstep ones (`lockstep_leapfrog`, leaf steps x chains): their ratio is
what the lockstep costs.

The transition's state lives in fixed-shape buffers (`_Tree`), and its
steps (a doubling's begin, a leaf, its end) read and write only them, its
uniforms included: a transition draws all of them at its start
(`draws.tree_uniforms`), and the steps read them at device counters (the
doubling, the leaf). Who decides which step runs next:
- on a CUDA device, without a mesh or under one whose groups are all
  NCCL's (infer/graphs.py), the device (`CapturedTree`, the counterpart
  of the while_loops JAX compiles in _build_nuts_runners, GSPMD's psums
  inside under a mesh): a captured stride of STRIDE tree steps, each step
  JAX's cond/body pair once, its begin, leaf and end conditional nodes
  on flags computed on the device; the host replays strides and reads
  one word per stride (the transition is done), and the device counts
  the bodies it ran, for the counters, the kernel launches and the
  all-reduces. NCCL refuses an all-reduce over two ranks or more inside
  a conditional node's body, so under a mesh the leaf and the end are
  split at their reductions into parts, each a conditional node, the
  all-reduces between them at the graph's top level (_mesh_step);
- on the CPU, over gloo and inside graphs.disabled(), the host: it reads
  "any chain still building" before each doubling and "any chain still
  active" before each leaf but the first (a collective over the chains
  axis under a mesh), one host sync each, and calls the same steps, and
  the same parts, eagerly. This is the reference that the device-decided
  run is held against bit for bit.
NUTSResult.host_syncs counts the reads either way. The step-size search's
step is captured too. The capture is cached per (density, data
structure, chains, D, dtype, device, max_depth, stride, mesh layout), the
data an operand.

The log density, the energies and every quantity derived from energy
differences (multinomial weights, accept statistics, the divergence test)
are float64; the state, momenta and gradients are in the state's dtype.
The random numbers come from a `draws` object (infer/hmc.GeneratorDraws by
default), which a test can replace to replay another random stream.

`run_nuts(mesh=, dims=)` shards the chains over a `chains` mesh axis, the
genes over a `genes` axis, or both (nuts.py:528-560 of the JAX package;
parallel/sharding.py). Every energy and U-turn dot product is then summed
over the global state, one all-reduce per leaf for all of a leaf's dots;
every "any chain still active" decision is taken over the global chain
batch. Each chain adapts its own step size and mass, so no adaptation
statistic crosses chains.
"""

from __future__ import annotations

import functools
import math
from dataclasses import dataclass
from typing import NamedTuple

import numpy as np
import torch

from ppcseq_tpu_torch.infer import graphs
from ppcseq_tpu_torch.infer.hmc import (_SINGLE, GeneratorDraws, LayoutDraws, finite,
                                        layout_grad_fn, leapfrog, sampler_density, sampler_spec,
                                        structured_draws)
from ppcseq_tpu_torch.parallel import sharding
from ppcseq_tpu_torch.parallel.sharding import all_reduce, local_value_and_grad
from ppcseq_tpu_torch.utils.device import resolve_device

MAX_DELTA_ENERGY = 1000.0  # Stan's divergence threshold
F64 = torch.float64


def _energy(logp, r, inv_mass, layout=_SINGLE):
    """-logp + 0.5 r' M^-1 r per chain, in float64."""
    return -logp.to(F64) + 0.5 * layout.sums([r * (inv_mass * r)])[0]


def _turning_products(r_sum, r_first, r_last, inv_mass):
    """The generalized U-turn's two products rho * M^-1 r, each to be
    summed over the last axis."""
    return r_sum * (inv_mass * r_first), r_sum * (inv_mass * r_last)


def _turned(to_first, to_last):
    """The U-turn test from the two products' sums."""
    return (to_first <= 0) | (to_last <= 0)


def _is_turning(r_sum, r_first, r_last, inv_mass, layout=_SINGLE):
    """Generalized U-turn: rho against the velocities at both subtree ends.
    Reduces over the last axis; the others broadcast."""
    return _turned(*layout.sums(_turning_products(r_sum, r_first, r_last, inv_mass)))


def _leaf_to_ckpt(i: int) -> tuple[int, int]:
    """Checkpoint slot range (lo, hi) of leaf i (0-based) of a subtree."""
    idx_max = bin(i >> 1).count("1")
    n, t = i, 0
    while n & 1:
        n, t = n >> 1, t + 1
    return idx_max - t + 1, idx_max


def ckpt_table(max_depth: int, device) -> tuple[torch.Tensor, torch.Tensor]:
    """(lo, hi), int64 tensors on `device`: _leaf_to_ckpt(i) of every leaf i
    of a subtree of at most 2^max_depth leaves (at least WARMUP_RUNS + 1
    entries: room for a capture's warm-up of both leaf parities)."""
    n = max(1 << max_depth, graphs.WARMUP_RUNS + 1)
    lo, hi = zip(*(_leaf_to_ckpt(i) for i in range(n)))
    return (torch.tensor(lo, dtype=torch.int64, device=device),
            torch.tensor(hi, dtype=torch.int64, device=device))


def _inf_for_nan(delta):
    return torch.nan_to_num(delta, nan=math.inf, posinf=math.inf, neginf=-math.inf)


def _where(mask, a, b):
    """Per-chain select: mask [chains] against [chains] or [chains, ...]."""
    return torch.where(mask.view(mask.shape + (1,) * (a.dim() - 1)), a, b)


def _assign(bufs: dict, **new) -> None:
    """Copy each new value into its buffer (all computed before the first
    copy, so a value may read any buffer)."""
    for k, v in new.items():
        bufs[k].copy_(v)


class _Counters:
    """Lockstep bookkeeping of one run: batched gradient evaluations, leaf
    steps (each one batched leapfrog over all chains), host syncs, and the
    sum of the chains' tree depths over their transitions."""

    def __init__(self, layout=_SINGLE):
        self.layout = layout
        self.evals = 0
        self.leaf_steps = 0
        self.host_syncs = 0
        self.depth_sum = 0  # a device tensor once a transition has run
        self.transitions = 0


class _Tree:
    """One lockstep NUTS transition of every chain in fixed-shape buffers:
    JAX's _TrajCarry (`traj`, nuts.py:181-198) and _SubtreeCarry (`sub`,
    :92-107) per chain, the transition's inputs (inverse mass, step size,
    initial energy), its uniforms `u` and the device counters that index
    them: the doubling `d` and the subtree's leaf `sub["leaf"]`. A
    transition is `start`, then per doubling the steps `begin`, a `leaf`
    per tree leaf (even or odd, by the leaf's parity) and `end`, in the
    order `run` decides on the host; the run's step-size search is
    `start_search` and eight `search` steps (_find_eps). A step reads and
    writes only these buffers and reads no host value that changes between
    its calls: the counters are device tensors, and a leaf reads its
    checkpoint slot range from the device table `ckpt` and its uniform
    from row 2^d - 1 + leaf. So a capture of the steps (CapturedTree) runs
    the eager steps' operations on the same shapes.

    A leaf and an end are split at their reductions over the genes axis
    (none without one): a leaf is `leaf_a` (the leapfrog up to its
    density), the all-reduce of the density (`reduced[0]`), `leaf_b` (the
    second half step and the leaf's dot products), the all-reduce of the
    dots (`reduced[1]`) and `leaf_c` (the rest); an end is `end_a` (its
    U-turn products), their all-reduce (`reduced[0]` again) and `end_b`.
    What a part hands the next lies in `work`. A CapturedTree under a mesh
    puts each part in a conditional node and the all-reduces between
    them, at its graph's top level, on the same buffers, in the same order:
    so its run sums what this run sums, element for element. Under a genes
    axis `density` is the rank's local log density (theta -> lp, float64,
    as nb_model's)."""

    def __init__(self, grad_fn, z, max_depth: int, layout=_SINGLE, density=None):
        C, D = z.shape
        K = max_depth + 1
        dev = z.device
        kw = dict(dtype=z.dtype, device=dev)

        def f64(*shape):
            return torch.zeros(shape or (C,), dtype=F64, device=dev)

        def flags():
            return torch.zeros(C, dtype=torch.bool, device=dev)

        def counts():
            return torch.zeros(C, dtype=torch.int64, device=dev)

        self.grad_fn, self.layout, self.max_depth = grad_fn, layout, max_depth
        self.density = density
        self.inv_mass = torch.ones((C, D), **kw)
        self.eps = torch.zeros((C, 1), **kw)
        self.energy0 = f64()
        # tree_uniforms's rows, at least one per doubling and two leaves
        # (a capture's warm-up runs doubling 0 with both leaf parities), and
        # 2^max_depth leaves: a whole subtree of depth max_depth fits
        rows = max(max_depth, 1)
        self.u = {"direction": torch.zeros((rows, C), **kw),
                  "leaf": torch.zeros((max(1 << max_depth, 2), C), **kw),
                  "merge": torch.zeros((rows, C), **kw)}
        self.d = torch.zeros(1, dtype=torch.int64, device=dev)
        self.first_leaf = torch.tensor([(1 << k) - 1 for k in range(K)], device=dev)
        self.ckpt = ckpt_table(max_depth, dev)
        self.slots = torch.arange(K, device=dev)
        # the first z (the run's start) makes a capture's warm-up evaluate there
        self.traj = {k: z.clone() for k in ("zl", "zr", "z_prop")}
        self.traj.update({k: torch.zeros_like(z) for k in ("rl", "rr", "gl", "gr", "g_prop",
                                                           "r_sum")})
        self.traj.update(logp_prop=f64(), log_weight=f64(), sum_accept=f64(), turning=flags(),
                         diverging=flags(), building=flags(), depth=counts(), num_steps=counts())
        self.sub = {k: z.clone() for k in ("z", "z_prop")}
        self.sub.update({k: torch.zeros_like(z) for k in ("r", "g", "g_prop", "r_sum")})
        self.sub.update(logp_prop=f64(), log_weight=f64(), sum_accept=f64(), turning=flags(),
                        diverging=flags(), go_right=flags(), active=flags(), live=flags(),
                        steps=counts(), eps=torch.zeros((C, 1), **kw),
                        leaf=torch.zeros(1, dtype=torch.int64, device=dev),
                        r_ckpts=torch.zeros((C, K, D), **kw),
                        r_sum_ckpts=torch.zeros((C, K, D), **kw))
        # the parts' hand-over: the leaf's point, momenta, gradient and log
        # density, and the sums (whole, or their replicated part) of a
        # leaf's 1 + 2K or an end's 2 dot products per chain
        self.work = dict(z=torch.zeros_like(z), r=torch.zeros_like(z), g=torch.zeros_like(z),
                         lp=f64(), sums=f64(C * (1 + 2 * K)))
        if layout.gene_collectives:  # the genes all-reduces' buffers (Layout.reduce_local)
            lo, hi = layout.genes.gene_block
            self.reduced = (f64(C * (1 + lo + D - hi)), f64(C * (1 + 2 * K)))
        self.steps = {"begin": self.begin, "even": functools.partial(self.leaf, False),
                      "odd": functools.partial(self.leaf, True), "end": self.end,
                      "search": self.search}

    def _u(self, what, row):
        """The uniforms [chains] of u[what] at the device index row[1]."""
        return torch.index_select(self.u[what], 0, row)[0]

    def _reduce(self, j: int, kind: str) -> None:
        """The all-reduce of reduced[j] over the genes group, if any."""
        if self.layout.gene_collectives:
            all_reduce(self.reduced[j], self.layout.genes.group, kind)

    def _sums_local(self, xs, j: int) -> None:
        """Layout.sums' first half of xs: the sums (or their replicated
        part) into work["sums"], their gene part into reduced[j]."""
        rep, gene = self.layout.sums_local(xs)
        self.work["sums"][:rep.numel()].copy_(rep)
        if gene is not None:
            self.reduced[j][:gene.numel()].copy_(gene)

    def _sums(self, shapes, j: int):
        """Layout.sums' second half: the sums, of these shapes, that
        _sums_local packed, reduced[j] all-reduced since."""
        gene = self.reduced[j] if self.layout.gene_collectives else None
        return self.layout.sums_finish(self.work["sums"], gene, shapes)

    def start_search(self, z, logp, grad, inv_mass, r):
        """The step-size search's start (nuts.py:119-131): z, its gradient
        and momenta r in the trajectory's left end, their energy, and the
        step size 0.1 for every chain."""
        self.inv_mass.copy_(inv_mass)
        _assign(self.traj, zl=z, rl=r, gl=grad)
        self.energy0.copy_(_energy(logp, r, self.inv_mass, self.layout))
        self.eps.fill_(0.1)

    def search(self):
        """One step of the search: a leapfrog of each chain's step size from
        the start, the step doubled where the energy error is below
        log(1 / 0.8) (a first-step accept above 0.8), halved elsewhere."""
        t = self.traj
        _, r1, _, lp1 = leapfrog(t["zl"], t["rl"], t["gl"], self.eps, self.inv_mass, self.grad_fn)
        delta = torch.nan_to_num(self.energy0 - _energy(lp1, r1, self.inv_mass, self.layout),
                                 nan=-math.inf, posinf=math.inf, neginf=-math.inf)
        self.eps.copy_(torch.where(delta.view(-1, 1) > math.log(0.8), self.eps * 2.0,
                                   self.eps * 0.5))

    def start(self, z, logp, grad, eps, inv_mass, r0, u):
        """A transition's inputs, its uniforms u (draws.tree_uniforms) and
        JAX's trajectory init (nuts.py:203-219) from momenta r0, at
        doubling 0."""
        self.inv_mass.copy_(inv_mass)
        self.eps.copy_(eps.to(z.dtype).view(-1, 1))
        self.energy0.copy_(_energy(logp, r0, self.inv_mass, self.layout))
        for k, v in u.items():
            self.u[k][:len(v)].copy_(v)
        self.d.zero_()
        t = self.traj
        _assign(t, zl=z, zr=z, z_prop=z, rl=r0, rr=r0, r_sum=r0, gl=grad, gr=grad, g_prop=grad,
                logp_prop=logp)
        for k in ("log_weight", "sum_accept", "turning", "diverging", "depth", "num_steps"):
            t[k].zero_()  # log_weight 0: the initial point's exp(-(H0 - H0))
        t["building"].fill_(True)

    def begin(self):
        """Doubling d's subtree from the trajectory's end that its direction
        uniform picks: the signed step and JAX's _SubtreeCarry init
        (nuts.py:225-233, 167-177), its checkpoints zero, for the chains
        still building (`active`)."""
        t, s = self.traj, self.sub
        go_right = self._u("direction", self.d) < 0.5
        z0 = _where(go_right, t["zr"], t["zl"])
        g0 = _where(go_right, t["gr"], t["gl"])
        _assign(s, go_right=go_right, active=t["building"], live=t["building"],
                eps=torch.where(go_right.view(-1, 1), self.eps, -self.eps), z=z0,
                r=_where(go_right, t["rr"], t["rl"]), g=g0, z_prop=z0, g_prop=g0)
        s["logp_prop"].fill_(-math.inf)
        s["log_weight"].fill_(-math.inf)
        for k in ("r_sum", "sum_accept", "turning", "diverging", "steps", "leaf", "r_ckpts",
                  "r_sum_ckpts"):
            s[k].zero_()

    def leaf(self, odd: bool):
        """One batched leapfrog and JAX's subtree body (nuts.py:118-165) for
        the chains still building the subtree; its parts and all-reduces in
        order."""
        self.leaf_a()
        self._reduce(0, "logp")
        self.leaf_b(odd)
        self._reduce(1, "sums")
        self.leaf_c(odd)

    def leaf_a(self):
        """The leaf's leapfrog up to its density: the half step of the
        momenta, the drift, and the log density and gradient at the new
        point (hmc.leapfrog's order of operations), under a genes axis the
        rank's local ones packed into reduced[0] (Layout.reduce_local)."""
        s, w = self.sub, self.work
        r_half = s["r"] + 0.5 * s["eps"] * s["g"]
        z1 = s["z"] + s["eps"] * (r_half * self.inv_mass)
        if self.layout.gene_collectives:
            lp, g = local_value_and_grad(self.density, z1)
            self.reduced[0].copy_(self.layout.reduce_local(lp, g))
            _assign(w, z=z1, r=r_half, g=g)
        else:
            lp, g = self.grad_fn(z1)
            _assign(w, z=z1, r=r_half, lp=lp, g=g)

    def leaf_b(self, odd: bool):
        """The leaf's global log density and gradient (under a genes axis
        from reduced[0], as the layout's density gives them), the second
        half step, and the leaf's dot products packed for one reduction:
        its kinetic energy and, at an odd leaf, the U-turn tests against
        every one of the max_depth + 1 checkpoint slots."""
        s, w, inv_mass = self.sub, self.work, self.inv_mass
        if self.layout.gene_collectives:
            lp, g, _ = self.layout.reduce_finish(self.reduced[0], w["lp"], w["g"])
            _assign(w, **dict(zip(("lp", "g"), finite(lp, g, w["z"]))))
        r1 = w["r"] + 0.5 * s["eps"] * w["g"]
        xs = [r1 * (inv_mass * r1)]
        if odd:
            rj = s["r_ckpts"]
            block_sum = (s["r_sum"] + r1)[:, None, :] - s["r_sum_ckpts"] + rj
            xs += _turning_products(block_sum, rj, r1[:, None, :], inv_mass[:, None, :])
        w["r"].copy_(r1)
        self._sums_local(xs, 1)

    def leaf_c(self, odd: bool):
        """The rest of the leaf for the chains still building the subtree
        (m); no other chain's state changes. An odd leaf's U-turn tests
        count where lo <= j <= hi (JAX's masked scan); an even leaf writes
        slot hi, a one-hot select. (lo, hi) come from the device table at
        the leaf counter, which the leaf advances; `live` is m after the
        leaf."""
        s, w = self.sub, self.work
        C, K = s["r_ckpts"].shape[:2]
        m = s["active"] & ~s["turning"] & ~s["diverging"]
        z1, r1, g1, lp1 = w["z"], w["r"], w["g"], w["lp"]
        r_sum1 = s["r_sum"] + r1
        lo, hi = (torch.index_select(t, 0, s["leaf"]) for t in self.ckpt)
        ckpts = {}
        if odd:
            kin, to_first, to_last = self._sums([(C,), (C, K), (C, K)], 1)
            in_range = (self.slots >= lo) & (self.slots <= hi)
            turned = torch.any(_turned(to_first, to_last) & in_range, dim=1)
        else:
            (kin,) = self._sums([(C,)], 1)
            write = (m[:, None] & (self.slots == hi))[:, :, None]
            ckpts = dict(r_ckpts=torch.where(write, r1[:, None, :], s["r_ckpts"]),
                         r_sum_ckpts=torch.where(write, r_sum1[:, None, :], s["r_sum_ckpts"]))
            turned = torch.zeros_like(m)
        delta = _inf_for_nan((-lp1.to(F64) + 0.5 * kin) - self.energy0)
        log_w = -delta
        accept = torch.exp(log_w).clamp_(max=1.0)
        new_total = torch.logaddexp(s["log_weight"], log_w)
        u = self._u("leaf", torch.index_select(self.first_leaf, 0, self.d) + s["leaf"])
        take = (u < torch.exp(log_w - new_total)) & m
        turning = torch.where(m, turned, s["turning"])
        diverging = torch.where(m, delta > MAX_DELTA_ENERGY, s["diverging"])
        _assign(s, z_prop=_where(take, z1, s["z_prop"]),
                logp_prop=torch.where(take, lp1, s["logp_prop"]),
                g_prop=_where(take, g1, s["g_prop"]),
                z=_where(m, z1, s["z"]), r=_where(m, r1, s["r"]), g=_where(m, g1, s["g"]),
                log_weight=torch.where(m, new_total, s["log_weight"]),
                r_sum=_where(m, r_sum1, s["r_sum"]), turning=turning, diverging=diverging,
                sum_accept=torch.where(m, s["sum_accept"] + accept, s["sum_accept"]),
                steps=s["steps"] + m, leaf=s["leaf"] + 1,
                live=s["active"] & ~turning & ~diverging, **ckpts)

    def end(self):
        """The subtree's merge into the trajectory and the next doubling:
        its parts and all-reduce in order."""
        self.end_a()
        self._reduce(0, "sums")
        self.end_b()

    def _ends(self, keys):
        """The merged trajectory's ends ({k + "l", k + "r"} for k in keys)
        and momentum sum, for the chains that were building."""
        t, s, b = self.traj, self.sub, self.traj["building"]
        right, left = b & s["go_right"], b & ~s["go_right"]
        ends = {}
        for k in keys:
            ends[k + "l"] = _where(left, s[k], t[k + "l"])
            ends[k + "r"] = _where(right, s[k], t[k + "r"])
        return ends, t["r_sum"] + s["r_sum"]

    def end_a(self):
        """The trajectory's U-turn products over the merged ends, packed for
        their reduction."""
        ends, r_sum_new = self._ends("r")
        self._sums_local(_turning_products(r_sum_new, ends["rl"], ends["rr"], self.inv_mass), 0)

    def end_b(self):
        """The subtree's merge into the trajectory (biased progressive
        sampling, Stan/Betancourt) and the trajectory's U-turn test
        (nuts.py:236-263), for the chains that were building; then the
        next doubling (d + 1)."""
        t, s, b = self.traj, self.sub, self.traj["building"]
        C = b.shape[0]
        ends, r_sum_new = self._ends("zrg")
        p_new = torch.clamp(torch.exp(s["log_weight"] - t["log_weight"]), max=1.0)
        take = (self._u("merge", self.d) < p_new) & ~s["turning"] & ~s["diverging"] & b
        turned = s["turning"] | _turned(*self._sums([(C,), (C,)], 0))
        turning = torch.where(b, turned, t["turning"])
        diverging = torch.where(b, s["diverging"], t["diverging"])
        _assign(t, **ends, z_prop=_where(take, s["z_prop"], t["z_prop"]),
                logp_prop=torch.where(take, s["logp_prop"], t["logp_prop"]),
                g_prop=_where(take, s["g_prop"], t["g_prop"]),
                r_sum=_where(b, r_sum_new, t["r_sum"]), turning=turning, diverging=diverging,
                log_weight=torch.where(b, torch.logaddexp(t["log_weight"], s["log_weight"]),
                                       t["log_weight"]),
                sum_accept=torch.where(b, t["sum_accept"] + s["sum_accept"], t["sum_accept"]),
                num_steps=t["num_steps"] + torch.where(b, s["steps"], 0),
                depth=t["depth"] + b.to(torch.int64), building=~turning & ~diverging)
        self.d.add_(1)

    def _any(self, counters, j: int) -> bool:
        """Whether any chain of the global batch is still building (j = 0)
        or still active in the subtree (j = 1): a host read, of the counts
        of both (Layout.chain_counts: one all-reduce) under a chains axis."""
        counters.host_syncs += 1
        masks = [self.traj["building"], self.sub["live"]]
        if not self.layout.chain_collectives:
            return bool(masks[j].any())
        return bool(self.layout.chain_counts(masks)[j] > 0)

    def run(self, counters):
        """The transition's doublings and leaves after `start`, decided on
        the host (nuts.py:221-265, :110-178): a doubling while any chain is
        building, a leaf while any chain is active in the subtree (at leaf
        0 every chain of `active` is: the check before the doubling)."""
        for d in range(self.max_depth):
            if not self._any(counters, 0):
                break
            self.begin()
            for i in range(1 << d):
                if i > 0 and not self._any(counters, 1):
                    break
                self.leaf(i % 2 == 1)
                counters.evals += 1
                counters.leaf_steps += 1
            self.end()

    def result(self):
        """(z, logp, grad, stats) of the transition, copied out of the
        buffers; stats accept_prob, diverging, num_steps and depth, each
        [chains]."""
        t = self.traj
        stats = {"accept_prob": t["sum_accept"] / torch.clamp(t["num_steps"], min=1),
                 "diverging": t["diverging"].clone(), "num_steps": t["num_steps"].clone(),
                 "depth": t["depth"].clone()}
        return t["z_prop"].clone(), t["logp_prop"].clone(), t["g_prop"].clone(), stats


STRIDE = 16  # tree steps per replay of CapturedTree's stride (PERF.md §6)
_BODIES = ("begin", "even", "odd", "end")
_COUNTS_BYTES = 2 * 8  # Layout.chain_counts of building and live, float64


class CapturedTree(_Tree):
    """_Tree whose transitions the device decides: the counterpart of the
    while_loops that JAX compiles in _build_nuts_runners. One CUDA graph
    (graphs.Region) holds a stride of `stride` tree steps; a step is JAX's
    cond/body pair once, four conditional nodes side by side (graphs.when),
    each on a flag that the step computes on the device just before it:
    - begin, if no subtree is open, d < max_depth and any chain is
      building;
    - the even or the odd leaf (by the leaf counter's parity), if a
      subtree is open, the leaf is below 2^d and it is leaf 0 or any chain
      is still active;
    - end (then d + 1), if a subtree is open and its leaves are done (leaf
      2^d, or no chain active).
    So a step runs at most one leaf, every step before the transition is
    done runs one, and a step after it changes nothing. The step then
    writes `status`: the transition is done (no subtree open, and d =
    max_depth or no chain building), and how many times each body ran.
    Under a mesh the step is _mesh_step. `run` replays strides until the
    host reads done, one read per stride, and books what the device
    counted. The step-size search's step is captured as a region of its
    own (its all-reduces, under a genes axis, at its top level). The
    density reads a static copy of the run's data (the rank's shard), which
    `load` refills."""

    def __init__(self, log_density, data, z, max_depth: int, stride: int = STRIDE,
                 layout=_SINGLE):
        self.data = graphs.static_operand(data)
        super().__init__(layout_grad_fn(log_density, self.data, layout), z, max_depth, layout,
                         _local_density(log_density, self.data, layout))
        dev = z.device
        self.stride = stride
        self.on_mesh = bool(layout.gene_collectives or layout.chain_collectives)
        self.in_subtree = torch.zeros((), dtype=torch.bool, device=dev)
        self.n_leaves = torch.tensor([1 << k for k in range(max_depth + 1)], device=dev)
        # done, then the runs of each body since the transition's start, then
        # (under a mesh) the steps whose chain counts the host-decided run reads
        self.status = torch.zeros(1 + len(_BODIES) + self.on_mesh, dtype=torch.int64, device=dev)
        ran = {name: self.status[j + 1:j + 2] for j, name in enumerate(_BODIES)}

        def body(fn, name=None, opens=None):
            """fn, then whether a subtree is open where fn opens or closes
            one, and the run of the body `name` where fn completes it."""
            def run():
                fn()
                if opens is not None:
                    self.in_subtree.fill_(opens)
                if name is not None:
                    ran[name].add_(1)
            return run

        step = self.steps
        self.bodies = {"begin": body(step["begin"], "begin", True),
                       "even": body(step["even"], "even"), "odd": body(step["odd"], "odd"),
                       "end": body(step["end"], "end", False)}
        self.parts = {"end_a": self.end_a, "leaf_a": self.leaf_a,
                      "end_b": body(self.end_b, "end", False),
                      "even_b": functools.partial(self.leaf_b, False),
                      "odd_b": functools.partial(self.leaf_b, True),
                      "even_c": body(functools.partial(self.leaf_c, False), "even"),
                      "odd_c": body(functools.partial(self.leaf_c, True), "odd")}
        self.body_launches = {}
        self.steps = dict(step, search=graphs.Region(self.search, dev, "NUTS search").replay)
        self._stride = graphs.Region(self._strided, dev, f"NUTS stride of {stride}",
                                     warmup=self._warm, books=False)

    def load(self, data):
        if data is not None:
            graphs.load_operand(self.data, data)

    def _rewind(self):
        """Doubling 0, leaf 0, no subtree open, no chain building."""
        for t in (self.d, self.sub["leaf"], self.in_subtree, self.status,
                  self.traj["building"]):
            t.zero_()

    def _warm(self):
        """The stride's warm-up: each body once from the rewound state
        (doubling 0, both leaf parities; its parts and all-reduces in order
        under a mesh), recording its launches, then one step, which runs no
        body."""
        self._rewind()
        for name, fn in self.bodies.items():
            self.body_launches[name] = graphs.launches_of(fn)
        self._rewind()
        self._step()

    def _step(self):
        """One tree step (the class docstring's four flags, each computed
        on the device just before its body), then the done flag."""
        if self.on_mesh:
            return self._mesh_step()
        t, s, d, i = self.traj, self.sub, self.d, self.sub["leaf"]
        open_ = self.in_subtree
        graphs.when((~open_ & (d < self.max_depth) & t["building"].any()).reshape(()),
                    self.bodies["begin"])
        n = torch.index_select(self.n_leaves, 0, d)
        leaf = (open_ & (i < n) & ((i == 0) | s["live"].any())).reshape(())
        odd = (i % 2 == 1).reshape(())
        graphs.when(leaf & ~odd, self.bodies["even"])
        graphs.when(leaf & odd, self.bodies["odd"])
        graphs.when((open_ & ((i == n) | ~s["live"].any())).reshape(()), self.bodies["end"])
        done = ~open_ & ((d == self.max_depth) | ~t["building"].any())
        self.status[:1].copy_(done)

    def _mesh_step(self):
        """One tree step under a mesh: the end, or the begin and leaf 0, or
        a leaf, or nothing once the transition is done, by flags computed
        on the device from one all-reduce of the chains' counts at the
        step's start (Layout.chain_counts; local under a genes-only mesh).
        The bodies' parts are conditional nodes; between them, at the
        graph's top level, the genes all-reduces: reduced[0] after the
        leaf's density or the end's products (part a), reduced[1] after the
        leaf's products (part b). So every step makes the same all-reduces
        in the same order on every rank, as NCCL needs; one that no part
        used sums a stale buffer that no part reads. `status` gets the
        done flag of the step's start and counts the steps whose chain
        counts _Tree.run would read: before a doubling below max_depth,
        before a leaf after the first, until the transition is done."""
        t, s, d, i = self.traj, self.sub, self.d, self.sub["leaf"]
        open_ = self.in_subtree
        building, live = self.layout.chain_counts([t["building"], s["live"]]) > 0
        n = torch.index_select(self.n_leaves, 0, d)
        end = (open_ & ((i == n) | ~live)).reshape(())
        begin = (~open_ & (d < self.max_depth) & building).reshape(())
        leaf = begin | (open_ & ~end)
        odd = leaf & open_ & (i % 2 == 1).reshape(())
        even = leaf & ~odd
        read = ~self.status[:1].bool() & torch.where(open_, i < n, d < self.max_depth)
        self.status[-1:].add_(read)
        self.status[:1].copy_(~open_ & ~begin)
        part = self.parts
        graphs.when(end, part["end_a"])
        graphs.when(begin, self.bodies["begin"])
        graphs.when(leaf, part["leaf_a"])
        self._top_reduce(0, leaf | end, "logp")
        graphs.when(end, part["end_b"])
        graphs.when(even, part["even_b"])
        graphs.when(odd, part["odd_b"])
        self._top_reduce(1, leaf, "sums")
        graphs.when(even, part["even_c"])
        graphs.when(odd, part["odd_c"])

    def _top_reduce(self, j: int, used, kind: str) -> None:
        """The step's all-reduce of reduced[j] over the genes group, if any:
        in a capture always (a node of the graph's top level), eagerly (the
        warm-up, a test's stand-in for the graph) where a part used it."""
        capturing = used.is_cuda and torch.cuda.is_current_stream_capturing()
        if self.layout.gene_collectives and (capturing or bool(used)):
            self._reduce(j, kind)

    def _strided(self):
        for _ in range(self.stride):
            self._step()

    def start(self, *args):
        super().start(*args)
        self.in_subtree.zero_()
        self.status.zero_()

    def run(self, counters):
        """Replay strides until the transition is done, reading `status`
        once per stride; book the bodies' launches, the all-reduces and the
        leaves the device ran."""
        strides = 0
        while True:
            self._stride.replay()
            strides += 1
            done, *ran = self.status.tolist()
            counters.host_syncs += 1
            if done:
                break
        for name, times in zip(_BODIES, ran):
            graphs.book(self.body_launches[name], times)
        if self.on_mesh:
            self._book_all_reduces(strides * self.stride, *ran)
        leaves = ran[1] + ran[2]
        counters.evals += leaves
        counters.leaf_steps += leaves

    def _book_all_reduces(self, steps: int, begins, evens, odds, ends, read) -> None:
        """The all-reduces of `steps` replayed mesh steps, each under the
        kind of the part that used it (the chain counts where _Tree.run
        reads them; reduced[0] after a leaf's density ("logp") or an end's
        products ("sums"); reduced[1] after a leaf's products), the rest
        under the kind's idle one."""
        leaves = evens + odds
        slots = []
        if self.layout.chain_collectives:
            slots.append((_COUNTS_BYTES, "chains", {"chains": read}))
        if self.layout.gene_collectives:
            nbytes = [b.numel() * b.element_size() for b in self.reduced]
            slots += [(nbytes[0], "logp", {"logp": leaves, "sums": ends}),
                      (nbytes[1], "sums", {"sums": leaves})]
        for nbytes, idle, used in slots:
            for kind, times in used.items():
                sharding.book_all_reduce(kind, nbytes, times)
            sharding.book_all_reduce(f"{idle}_idle", nbytes, steps - sum(used.values()))


def _local_density(log_density, data, layout):
    """The rank's local log density theta -> lp under gene collectives
    (flat_logp(dims)'s `f(theta, data, shard)` on its shard), else None."""
    if not layout.gene_collectives:
        return None
    return functools.partial(log_density, data=data, shard=layout.genes)


def _transition_tree(log_density, data, grad_fn, z, max_depth, layout, device):
    """The run's _Tree: the device-decided CapturedTree on the card where a
    graph can hold every collective of its steps (Layout.all_capturable:
    no mesh, or NCCL groups on a CUDA device; cached, graphs.cached; STRIDE
    steps per replay), else the eager, host-decided one (the CPU, a gloo
    mesh, graphs.disabled())."""
    if not (graphs.enabled(device) and layout.all_capturable(device)):
        return _Tree(grad_fn, z, max_depth, layout, _local_density(log_density, data, layout))
    key = (log_density, graphs.operand_key(data), tuple(z.shape), z.dtype, z.device, max_depth,
           STRIDE, layout.key())
    tree = graphs.cached("nuts", key, lambda: CapturedTree(log_density, data, z, max_depth,
                                                           STRIDE, layout))
    tree.load(data)
    return tree


def _nuts_transition(grad_fn, z, logp, grad, eps, inv_mass, max_depth, draws, counters=None,
                     tree=None):
    """One NUTS draw for every chain (nuts.py:201-275): z[chains, D],
    logp[chains] (float64), grad[chains, D], eps[chains], inv_mass[chains, D].
    Returns (z, logp, grad, stats) with stats accept_prob, diverging,
    num_steps and depth, each [chains]. `tree` (a _Tree of these shapes and
    max_depth; a new eager one by default) holds the state and runs the
    transition (`run`) from its momenta and uniforms, drawn here first."""
    counters = counters or _Counters()
    tree = tree or _Tree(grad_fn, z, max_depth, counters.layout)
    r0 = draws.momentum(z.shape) / torch.sqrt(inv_mass)
    tree.start(z, logp, grad, eps, inv_mass, r0, draws.tree_uniforms(z.shape[0], tree.max_depth))
    tree.run(counters)
    counters.transitions += z.shape[0]
    counters.depth_sum = counters.depth_sum + tree.traj["depth"].sum()
    return tree.result()


# ----------------------------------------------------------------------------
# Warmup adaptation (Stan-style)
# ----------------------------------------------------------------------------


class DualAveragingState(NamedTuple):
    """Per-chain [chains] float64 tensors, and the shared update count."""

    log_eps: torch.Tensor
    log_eps_avg: torch.Tensor
    h_sum: torch.Tensor
    mu: torch.Tensor
    count: int


def _da_init(eps0):
    log_eps = torch.log(eps0.to(F64))
    return DualAveragingState(log_eps=log_eps, log_eps_avg=log_eps.clone(),
                              h_sum=torch.zeros_like(log_eps), mu=torch.log(10.0 * eps0.to(F64)),
                              count=0)


def _da_update(state: DualAveragingState, accept_prob, target=0.8):
    gamma, t0, kappa = 0.05, 10.0, 0.75
    count = state.count + 1
    w = 1.0 / (count + t0)
    h_sum = (1 - w) * state.h_sum + w * (target - accept_prob)
    log_eps = state.mu - math.sqrt(count) / gamma * h_sum
    eta = float(count) ** (-kappa)
    log_eps_avg = eta * log_eps + (1 - eta) * state.log_eps_avg
    return DualAveragingState(log_eps, log_eps_avg, h_sum, state.mu, count)


class WelfordState(NamedTuple):
    count: int
    mean: torch.Tensor  # [chains, D]
    m2: torch.Tensor


def _welford_init(proto):
    return WelfordState(0, torch.zeros_like(proto), torch.zeros_like(proto))


def _welford_update(state: WelfordState, x):
    count = state.count + 1
    delta = x - state.mean
    mean = state.mean + delta / count
    m2 = state.m2 + delta * (x - mean)
    return WelfordState(count, mean, m2)


def _welford_variance(state: WelfordState):
    """Stan's estimate regularized toward unity, its weights computed in
    float32 as nuts.py:335 does."""
    n = np.float32(state.count)
    shrink = float(n / (n + np.float32(5.0)))
    prior = float(np.float32(1e-3) * (np.float32(5.0) / (n + np.float32(5.0))))
    return (shrink * (state.m2 / max(float(n) - 1.0, 1.0)) + prior).to(state.m2.dtype)


def build_warmup_schedule(num_warmup, init_buffer=75, term_buffer=50, base_window=25):
    """Stan's windowed schedule: iteration indices where a metric window closes."""
    if num_warmup < 20:
        return [], 0, 0
    if init_buffer + term_buffer + base_window > num_warmup:
        init_buffer = int(0.15 * num_warmup)
        term_buffer = int(0.10 * num_warmup)
        base_window = num_warmup - init_buffer - term_buffer
    ends = []
    pos = init_buffer
    w = base_window
    while pos + w <= num_warmup - term_buffer:
        if pos + 2 * w > num_warmup - term_buffer:
            w = num_warmup - term_buffer - pos
        ends.append(pos + w)
        pos += w
        w *= 2
    return ends, init_buffer, term_buffer


def _find_eps(tree, z, lp, g, mass0, draws, counters):
    """The reasonable-epsilon search of nuts.py:407-420, per chain: eight
    doublings or halvings from 0.1 towards a first-step accept of 0.8, one
    momentum draw for all eight, each a step of `tree`; clipped to [1e-6,
    10]."""
    tree.start_search(z, lp, g, mass0, draws.momentum(z.shape) / torch.sqrt(mass0))
    for _ in range(8):
        tree.steps["search"]()
        counters.evals += 1
    return torch.clamp(tree.eps.view(-1), 1e-6, 10.0)


@dataclass
class NUTSResult:
    draws: torch.Tensor | dict  # [chains, num_draws, D] on the device, or the state's tree
    accept_prob: np.ndarray  # [chains, num_draws]
    divergences: np.ndarray  # [chains] count in the sampling phase
    step_size: np.ndarray  # [chains]
    inv_mass: np.ndarray | dict  # [chains, D], or the state's tree of [chains, ...] leaves
    num_leapfrog: int  # the chains' own leapfrog steps, warmup + sampling
    lockstep_leapfrog: int = 0  # leapfrogs computed: leaf steps x chains
    num_evals: int = 0  # batched log-density + gradient calls (B = chains each)
    host_syncs: int = 0  # device reads that decided the loops
    mean_depth: float = 0.0  # tree depth per chain and transition
    # a sharded run's draws and inv_mass are the rank's own: chains [c0, c1)
    # and, under a genes axis, genes [g0, g1) in its local layout
    chains: tuple[int, int] | None = None
    genes: tuple[int, int] | None = None


def run_nuts(
    log_density,
    prototype,
    generator: torch.Generator,
    *,
    data=None,
    num_chains: int = 4,
    num_warmup: int = 150,
    num_draws: int = 250,
    max_depth: int = 10,
    target_accept: float = 0.8,
    init_theta=None,
    init_scale: float = 2.0,
    init_jitter: float = 0.1,
    inv_mass_init=None,
    mesh=None,
    dims=None,
    device="cuda",
    dtype=torch.float32,
) -> NUTSResult:
    """Run multi-chain NUTS on the state `prototype` defines: an int D (a
    flat [D] state), an example tensor, or a dict of them
    (model/params.state_spec); returns the post-warmup draws [chains,
    num_draws, D], or the state's tree with leading [chains, num_draws]
    axes, and the inverse mass in the same structure.

    `log_density(theta[chains, D]) -> [chains]` (plus `data`, when given);
    a structured state reaches it as its tree with a leading [chains] axis
    on every leaf, and `init_theta` and `inv_mass_init` may be flat or in
    its structure. With `dims`, a dict whose keys are the model tree's is
    the model's tree, in the model's flat layout (tree_to_theta): the run
    draws the flat run's random numbers.
    Chains start at uniform(-init_scale, init_scale), or at init_theta
    jittered by init_jitter normals; the inverse mass starts at
    inv_mass_init (ones by default). `generator` (on `device`) drives every
    random number. `device` defaults to the card and must exist
    (utils/device.resolve_device).

    `mesh`: a DeviceMesh with a `chains` axis (the chain batch split over
    its ranks) and/or a `genes` axis. A `genes` axis needs `dims` and
    `data`, and `log_density` is then nb_model.flat_logp(dims): `f(theta,
    data, shard)` over a rank's local vector. init_theta and inv_mass_init
    may be global or local. Each rank returns its own chains' draws in its
    local layout and its inv_mass; accept_prob, divergences and step_size
    cover every chain. Under a `genes` axis the state is flat or the
    model's tree (hmc.sampler_spec).
    """
    spec = sampler_spec(prototype, dims, mesh, "run_nuts")
    device = resolve_device(device)
    D = spec.dim
    kw = dict(device=device, dtype=dtype)
    density = spec.bind(log_density)
    layout, data, grad_fn = sampler_density(density, data, mesh, dims, device, "run_nuts")
    shard = layout.genes
    if layout is _SINGLE:
        draws = GeneratorDraws(generator, device, dtype)
        n_local = num_chains
    else:
        draws = LayoutDraws(generator, device, dtype, layout, num_chains, D)
        n_local = draws.c1 - draws.c0
    d_local = D if shard is None else shard.dim
    if init_theta is None:
        z = (2.0 * init_scale) * draws.init_uniform((n_local, d_local)) - init_scale
    else:
        base = layout.local(spec.flatten(init_theta, **kw))
        z = base[None, :] + init_jitter * draws.momentum((n_local, d_local))
    mass0 = (torch.ones(d_local, **kw) if inv_mass_init is None
             else layout.local(spec.flatten(inv_mass_init, **kw)))
    inv_mass = mass0.expand(n_local, d_local).contiguous()

    counters = _Counters(layout)
    tree = _transition_tree(density, data, grad_fn, z, max_depth, layout, device)
    lp, g = grad_fn(z)
    counters.evals += 1
    steps = torch.zeros(n_local, dtype=torch.int64, device=device)  # each chain's leapfrogs

    # ---- warmup (nuts.py:401-456) ----
    schedule, metric_start, term_buffer = build_warmup_schedule(num_warmup)
    eps0 = _find_eps(tree, z, lp, g, inv_mass, draws, counters)
    da = _da_init(eps0)
    wf = _welford_init(z)
    for i in range(num_warmup):
        eps = torch.exp(da.log_eps)
        z, lp, g, stats = _nuts_transition(grad_fn, z, lp, g, eps, inv_mass, max_depth, draws,
                                           counters, tree)
        steps = steps + stats["num_steps"]
        da = _da_update(da, stats["accept_prob"], target_accept)
        if metric_start <= i < num_warmup - term_buffer:
            wf = _welford_update(wf, z)
        if i + 1 in schedule:  # a metric window closes
            inv_mass = _welford_variance(wf)
            da = _da_init(torch.exp(da.log_eps))
            wf = _welford_init(z)
    eps = torch.exp(da.log_eps_avg)

    # ---- sampling (nuts.py:458-468) ----
    out = torch.empty((num_draws, n_local, d_local), **kw)
    accepts, divs = [], []
    for k in range(num_draws):
        z, lp, g, stats = _nuts_transition(grad_fn, z, lp, g, eps, inv_mass, max_depth, draws,
                                           counters, tree)
        out[k] = z
        accepts.append(stats["accept_prob"])
        divs.append(stats["diverging"])
        steps = steps + stats["num_steps"]

    accept = torch.stack(accepts, dim=1) if accepts else torch.zeros((n_local, 0), device=device)
    div = (torch.stack(divs, dim=1) if divs
           else torch.zeros((n_local, 0), dtype=torch.bool, device=device))
    depth_sum, transitions = counters.depth_sum, counters.transitions
    if layout.chain_collectives:  # every chain's statistics on every rank
        accept = layout.gather_chains(accept)
        div = layout.gather_chains(div.to(torch.int32)).bool()
        eps = layout.gather_chains(eps)
        steps = layout.gather_chains(steps)
        depth_sum = layout.gather_chains(torch.as_tensor(depth_sum, dtype=F64,
                                                         device=device).reshape(1)).sum()
        transitions *= layout.chains_size
    genes = None if shard is None else (shard.g0, shard.g1)
    return NUTSResult(
        draws=structured_draws(spec, out.transpose(0, 1).contiguous(), genes),
        accept_prob=accept.cpu().numpy(),
        divergences=div.sum(dim=1).cpu().numpy(),
        step_size=eps.to(dtype).cpu().numpy(),
        inv_mass=structured_draws(spec, inv_mass.cpu().numpy(), genes),
        num_leapfrog=int(steps.sum()),
        lockstep_leapfrog=counters.leaf_steps * num_chains,
        num_evals=counters.evals,
        host_syncs=counters.host_syncs,
        mean_depth=float(depth_sum) / max(transitions, 1),
        chains=None if layout is _SINGLE else (draws.c0, draws.c1),
        genes=genes,
    )
