"""CUDA graphs of the samplers' step loops: the port's counterpart of
`jax.jit` over JAX's step programs (advi._get_advi_fns, hmc._build_runner,
_build_chees_warmup, _build_sampler) and of their caches (advi._FNS_CACHE,
hmc._RUNNER_CACHE).

A `Region` is a function of static tensors, captured once as a
`torch.cuda.CUDAGraph` and replayed: its caller copies new values into the
region's input buffers, replays it, and reads (or copies out) its outputs.
It is warmed up on a side stream of its device before the capture, as
PyTorch requires of autograd and of new streams: the likelihood kernels'
per-stream ticket (ops/nb_kernel._ticket) is allocated there, never inside
the capture. A capture that fails raises; nothing runs the step eagerly in
its place.

A region may branch on the device (`when`): a part of it captured as a
conditional (IF) node runs at a replay only where a device flag holds then,
as JAX's `lax.while_loop` and `lax.cond` decide on the device. One level of
such nodes, side by side, each on a flag that the region computes just
before it. Eagerly the host reads the flag. The port makes the IF nodes
itself (csrc/graph_cond.cu, through the CUDA runtime): torch 2.11 has no
Python call for them.

Kernel launch accounting: nb_kernel.LAUNCHES counts launches in Python, so
a replay would count nothing. A region records the launches of each kernel
its capture holds and adds them to LAUNCHES at every replay, so a run
through graphs counts what the same run counts eagerly. The launches of the
warm-up and of the capture itself go to STATS["build_launches"] instead. A
region that branches on the device books nothing itself: its caller counts
on the device how often each conditional body ran and books that (`book`).
The all-reduces a region holds (an NCCL group's, parallel/sharding.py) are
booked in sharding.COLLECTIVES the same way (a branching region's by its
caller, sharding.book_all_reduce), and those of its warm-up and capture go
to STATS["build_collectives"]. An all-reduce sits at a graph's top level:
NCCL refuses one over two ranks or more inside a conditional body, and
sharding.all_reduce raises while a body is being captured (`when` marks
it, under a real capture or a test's stand-in).

The cache (`cached`) keys an entry by what the caller passes: the density
function, the static configuration, the shapes, dtype and device. The model
data rides as an operand (`static_operand`): each entry holds buffers of
the data's tensors and every fit copies its data into them
(`load_operand`), as JAX passes data to a compiled program, so the
pipeline's two passes (other like_mask and baseline, same shapes) and
vb_iterative's retries replay one capture. Each slot holds one entry: a new
key drops the old entry and frees its graphs' memory pools. `release()`
drops every entry (identify_outliers does at its end). Each region's
warm-up and capture is a span `capture <name>` (utils/log.py), and
`counters()` / `counters_since()` give what identify_outliers's root span
records.

`enabled(device)` says where the samplers capture: on a CUDA device. The
CPU runs the loops eagerly, and so does every fit whose steps hold a
collective that no graph can hold (gloo stages it through the host); that
choice is made by the caller's layout (sharding.Layout.capturable), never
by catching a failure. `disabled()` runs them
eagerly on the card too: the reference that the card tests and
chip_smoke.py's phase graphs hold the graphs against, bit for bit.
"""

from __future__ import annotations

import contextlib
import dataclasses
import gc
import time

import torch

from ppcseq_tpu_torch.ops import nb_kernel
from ppcseq_tpu_torch.parallel import sharding
from ppcseq_tpu_torch.utils.log import timed

# eager runs of a region on the side stream before its capture (at least one:
# an NCCL communicator's first all-reduce cannot be captured)
WARMUP_RUNS = 2

STATS = {"captures": 0, "capture_s": 0.0, "replays": 0, "build_launches": {},
         "build_collectives": {}}

_CACHE: dict = {}  # slot -> (key, entry)
_STREAMS: dict = {}  # (device index, "side" or "body") -> a stream of warm-ups and captures
_capturing = None  # the Capture whose capture is under way (set by Region)
_eager = False  # set inside disabled()


def reset_stats() -> None:
    STATS.update(captures=0, capture_s=0.0, replays=0, build_launches={}, build_collectives={})


def enabled(device) -> bool:
    """Whether the samplers replay graphs on `device` (a CUDA device, outside
    disabled())."""
    return torch.device(device).type == "cuda" and not _eager


@contextlib.contextmanager
def disabled():
    """Run the samplers' loops eagerly on the card inside the block."""
    global _eager
    before, _eager = _eager, True
    try:
        yield
    finally:
        _eager = before


def _side_stream(device, kind="side"):
    index = torch.device(device).index
    if index is None:
        index = torch.cuda.current_device()
    if (index, kind) not in _STREAMS:
        _STREAMS[index, kind] = torch.cuda.Stream(device=index)
    return _STREAMS[index, kind]


def _body_stream(device):
    """The stream that captures the IF nodes' bodies on `device`."""
    return _side_stream(device, "body")


COND_SOURCE = "graph_cond.cu"  # csrc/: the IF nodes' C entries (ops/_build.py builds it)
_cond = None  # its loaded library


def _cond_lib():
    global _cond
    if _cond is None:
        import ctypes

        from ppcseq_tpu_torch.ops import _build

        (lib,) = _build.load_all([COND_SOURCE])
        lib.graph_if_begin.argtypes = [ctypes.c_void_p] * 3
        lib.graph_if_end.argtypes = [ctypes.c_void_p]
        lib.graph_cond_error.argtypes = [ctypes.c_int]
        lib.graph_cond_error.restype = ctypes.c_char_p
        _cond = lib
    return _cond


def _check(err: int, what: str) -> None:
    if err:
        raise RuntimeError(f"{what}: {_cond_lib().graph_cond_error(err).decode()}")


def _route(index, pool, begin):
    """Route the allocations of device `index` that the capture's pool
    takes: begin(index, pool) in place of the entry that serves it now,
    without a reference of its own to the pool (the graph holds one)."""
    torch._C._cuda_endAllocateToPool(index, pool)
    begin(index, pool)
    torch._C._cuda_releasePool(index, pool)


class CudaCapture:
    """A torch.cuda.CUDAGraph behind the three calls a Region makes, and the
    IF nodes (`if_node`) of its capture."""

    def __init__(self, device, name):
        self.device, self.name = torch.device(device), name
        self.graph = torch.cuda.CUDAGraph()
        self.pool = torch.cuda.graph_pool_handle()  # the graph's private memory pool

    def warmup(self, fn, runs):
        """fn() `runs` times on the side stream, ordered after the work the
        current stream has queued and before what it queues next."""
        stream, current = _side_stream(self.device), torch.cuda.current_stream(self.device)
        stream.wait_stream(current)
        with torch.cuda.stream(stream):
            for _ in range(runs):
                fn()
        current.wait_stream(stream)

    def capture(self, fn):
        try:
            with torch.cuda.graph(self.graph, pool=self.pool, stream=_side_stream(self.device)):
                return fn()
        except RuntimeError as e:
            raise RuntimeError(f"CUDA graph capture of the {self.name} failed: {e}") from e

    def if_node(self, pred, fn):
        """fn() captured as the body of an IF node on pred (csrc/graph_cond.cu)
        on a stream of its own. The graph's memory pool serves only its
        capture stream, so for the body it serves every stream (the body's
        and the autograd thread's, which runs the body's backward on it),
        then the capture stream again; the graph holds the pool as ever,
        and a block serves only the stream it was allocated on. The body's
        likelihood kernels take the capture stream's ticket."""
        lib, index = _cond_lib(), self.device.index
        if index is None:
            index = torch.cuda.current_device()
        parent, body = torch.cuda.current_stream(self.device), _body_stream(self.device)
        _check(lib.graph_if_begin(parent.cuda_stream, body.cuda_stream, pred.data_ptr()),
               f"an IF node of the {self.name}")
        _route(index, self.pool, torch._C._cuda_beginAllocateToPool)
        try:
            with (torch.cuda.stream(body), nb_kernel.ticket_of(parent),
                  sharding.conditional_body(f"an IF node's body of the {self.name}")):
                fn()
        finally:
            _route(index, self.pool, torch._C._cuda_beginAllocateCurrentStreamToPool)
            _check(lib.graph_if_end(body.cuda_stream), f"the IF node's body of the {self.name}")

    def replay(self):
        self.graph.replay()


Capture = CudaCapture  # what a Region captures with (a test may stand a stub in)


def when(pred, fn) -> None:
    """fn() where the one-element bool tensor `pred` holds True. Inside a
    Region's capture, an IF node of its graph whose body is fn's capture
    (CudaCapture.if_node): a replay runs the body or skips it by pred's
    value at that point of the replay. Otherwise (eagerly, on the CPU) the
    host reads pred; inside a Region's capture by a stand-in for the CUDA
    graph, fn runs as the body's capture would, no all-reduce allowed.
    Nothing catches a failure: a failed IF node raises, and so does the
    capture around it."""
    if pred.device.type == "cuda" and torch.cuda.is_current_stream_capturing():
        if _capturing is None:
            raise RuntimeError("graphs.when under a CUDA graph capture that is not a Region's")
        _capturing.if_node(pred, fn)
    elif bool(pred):
        with (contextlib.nullcontext() if _capturing is None else
              sharding.conditional_body(f"a conditional body of the {_capturing.name}")):
            fn()


def _counts() -> tuple[dict, dict]:
    """The kernel launches and the all-reduces counted so far (the
    collectives' seconds apart)."""
    return (dict(nb_kernel.LAUNCHES),
            {k: v for k, v in sharding.COLLECTIVES.items() if k != "seconds"})


def launches_of(fn) -> dict:
    """fn(), and the kernel launches it counted."""
    before = dict(nb_kernel.LAUNCHES)
    fn()
    return _diff(nb_kernel.LAUNCHES, before)


def counters() -> dict:
    """The graph counters of STATS (captures, replays) and
    nb_kernel.LAUNCHES by kernel, as they stand."""
    return {"captures": STATS["captures"], "replays": STATS["replays"],
            "launches": dict(nb_kernel.LAUNCHES)}


def counters_since(before: dict) -> dict:
    """What counters() grew by since `before`: the kernels' launches those
    that grew, replays' booked launches included."""
    now = counters()
    return {k: _diff(now[k], before[k]) if k == "launches" else now[k] - before[k] for k in now}


def book(launches: dict, times: int) -> None:
    """Add `times` x `launches` to nb_kernel.LAUNCHES: the launches of a
    conditional body that the device ran `times` times."""
    for k, v in launches.items():
        nb_kernel.LAUNCHES[k] += v * times


def _diff(after: dict, before: dict) -> dict:
    return {k: after[k] - before.get(k, 0) for k in after if after[k] != before.get(k, 0)}


def _merge(a: dict, b: dict) -> dict:
    return {k: a.get(k, 0) + b.get(k, 0) for k in {**a, **b}}


class Region:
    """fn() over static tensors, captured once and replayed. fn reads and
    writes only tensors that outlive the capture; `outputs` is what the
    capture returned (static: a replay overwrites it). `launches` holds the
    kernel launches one replay makes, `collectives` its all-reduces.

    `warmup` (default fn) is what runs eagerly before the capture: a region
    that branches on the device (`when`) warms each of its bodies up
    itself, since its own eager run may skip them. Such a region passes
    `books=False`: a replay books no launches or all-reduces (`launches`
    and `collectives` are empty), its caller books what the device ran
    (nuts.CapturedTree)."""

    def __init__(self, fn, device, name, warmup=None, books=True):
        global _capturing
        with timed(f"capture {name}"):
            before, seconds = _counts(), sharding.COLLECTIVES["seconds"]
            captured = {}
            t0 = time.perf_counter()
            self._graph = Capture(device, name)
            try:
                self._graph.warmup(warmup or fn, WARMUP_RUNS)
                warm = _counts()
                with sharding.recording() as captured:
                    _capturing = self._graph
                    try:
                        self.outputs = self._graph.capture(fn)
                    finally:
                        _capturing = None
                after = _counts()
                self.launches = _diff(after[0], warm[0]) if books else {}
                # an all-reduce that the capture holds is logged; one that ran
                # (a test's stand-in for the capture runs fn) was counted
                self.collectives = _merge(captured, _diff(after[1], warm[1])) if books else {}
            finally:
                now = _counts()
                for built, new in ((STATS["build_launches"], _diff(now[0], before[0])),
                                   (STATS["build_collectives"],
                                    _merge(_diff(now[1], before[1]), captured))):
                    for k, v in new.items():
                        built[k] = built.get(k, 0) + v
                nb_kernel.LAUNCHES.update(before[0])
                sharding.COLLECTIVES.update(before[1], seconds=seconds)
            STATS["captures"] += 1
            STATS["capture_s"] += time.perf_counter() - t0

    def replay(self, times: int = 1) -> None:
        for _ in range(times):
            self._graph.replay()
        book(self.launches, times)
        sharding.book(self.collectives, times)
        STATS["replays"] += times


# ---- the data operand ---------------------------------------------------------

def _parts(data):
    """(name, value) of a container operand (a dataclass's fields, a dict's
    items, a list's or tuple's entries), or None for a leaf."""
    if dataclasses.is_dataclass(data) and not isinstance(data, type):
        return [(f.name, getattr(data, f.name)) for f in dataclasses.fields(data)]
    if isinstance(data, dict):
        return list(data.items())
    if isinstance(data, (list, tuple)):
        return list(enumerate(data))
    return None


def operand_key(data):
    """The part of a cache key that a data operand gives: its structure and
    each tensor's shape, dtype and device. Other leaves enter by value where
    they are hashable; an unhashable one (ModelData.host's NumPy mirrors of
    the tensors) by its type alone, as a host-side value that a captured
    density must not read."""
    if isinstance(data, torch.Tensor):
        return ("tensor", tuple(data.shape), data.dtype, data.device)
    parts = _parts(data)
    if parts is None:
        try:
            hash(data)
        except TypeError:
            return ("host", type(data))
        return ("value", data)
    return (type(data), tuple((k, operand_key(v)) for k, v in parts))


def _tensors(data) -> list:
    if isinstance(data, torch.Tensor):
        return [data]
    return [t for _, v in (_parts(data) or ()) for t in _tensors(v)]


def static_operand(data):
    """A copy of `data` whose tensors are new buffers (clones)."""
    if isinstance(data, torch.Tensor):
        return data.clone()
    parts = _parts(data)
    if parts is None:
        return data
    new = {k: static_operand(v) for k, v in parts}
    if isinstance(data, dict):
        return dict(new)
    if isinstance(data, (list, tuple)):
        return type(data)(new[i] for i in range(len(new)))
    return dataclasses.replace(data, **new)


def load_operand(static, data) -> None:
    """Copy the tensors of `data` into those of `static` (same operand_key)."""
    for dst, src in zip(_tensors(static), _tensors(data), strict=True):
        dst.copy_(src)


# ---- the cache ----------------------------------------------------------------

def cached(slot: str, key, build):
    """The entry of `slot` for `key`: the cached one when its key is equal,
    else build() after the slot's old entry is dropped."""
    hit = _CACHE.get(slot)
    if hit is not None and hit[0] == key:
        return hit[1]
    release(slot)
    entry = build()
    _CACHE[slot] = (key, entry)
    return entry


def release(slot: str | None = None) -> None:
    """Drop the cached entries (of one slot, or all) and their graphs: the
    graphs' memory pools go back to the allocator. An entry may sit in a
    reference cycle (nuts.CapturedTree's steps are its own methods), so
    the garbage collector frees it here: a graph that holds NCCL's
    all-reduces must be gone before its process group is destroyed, which
    waits for it otherwise (four H100s, NCCL 2.28.9)."""
    slots = list(_CACHE) if slot is None else [slot] if slot in _CACHE else []
    for s in slots:
        del _CACHE[s]
    if slots:
        gc.collect()
        if torch.cuda.is_available():
            torch.cuda.empty_cache()
