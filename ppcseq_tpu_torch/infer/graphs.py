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

Kernel launch accounting: nb_kernel.LAUNCHES counts launches in Python, so
a replay would count nothing. A region records the launches of each kernel
its capture holds and adds them to LAUNCHES at every replay, so a run
through graphs counts what the same run counts eagerly. The launches of the
warm-up and of the capture itself go to STATS["build_launches"] instead.

The cache (`cached`) keys an entry by what the caller passes: the density
function, the static configuration, the shapes, dtype and device. The model
data rides as an operand (`static_operand`): each entry holds buffers of
the data's tensors and every fit copies its data into them
(`load_operand`), as JAX passes data to a compiled program, so the
pipeline's two passes (other like_mask and baseline, same shapes) and
vb_iterative's retries replay one capture. Each slot holds one entry: a new
key drops the old entry and frees its graphs' memory pools. `release()`
drops every entry (identify_outliers does at its end).

`enabled(device)` says where the samplers capture: on a CUDA device. The
CPU runs the loops eagerly, and so does every sharded fit (its all-reduce
goes through gloo, which stages through the host); that choice is made by
the caller's `layout`, never by catching a failure. `disabled()` runs them
eagerly on the card too: the reference that the card tests and
chip_smoke.py's phase graphs hold the graphs against, bit for bit.
"""

from __future__ import annotations

import contextlib
import dataclasses
import time

import torch

from ppcseq_tpu_torch.ops import nb_kernel

WARMUP_RUNS = 2  # eager runs of a region on the side stream before its capture

STATS = {"captures": 0, "capture_s": 0.0, "replays": 0, "build_launches": {}}

_CACHE: dict = {}  # slot -> (key, entry)
_STREAMS: dict = {}  # device index -> the side stream of warm-ups and captures
_eager = False  # set inside disabled()


def reset_stats() -> None:
    STATS.update(captures=0, capture_s=0.0, replays=0, build_launches={})


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


def _side_stream(device):
    index = torch.device(device).index
    if index is None:
        index = torch.cuda.current_device()
    if index not in _STREAMS:
        _STREAMS[index] = torch.cuda.Stream(device=index)
    return _STREAMS[index]


class CudaCapture:
    """A torch.cuda.CUDAGraph behind the three calls a Region makes."""

    def __init__(self, device, name):
        self.device, self.name = torch.device(device), name
        self.graph = torch.cuda.CUDAGraph()

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
            with torch.cuda.graph(self.graph, stream=_side_stream(self.device)):
                return fn()
        except RuntimeError as e:
            raise RuntimeError(f"CUDA graph capture of the {self.name} failed: {e}") from e

    def replay(self):
        self.graph.replay()


Capture = CudaCapture  # what a Region captures with (a test may stand a stub in)


def _diff(after: dict, before: dict) -> dict:
    return {k: after[k] - before.get(k, 0) for k in after if after[k] != before.get(k, 0)}


class Region:
    """fn() over static tensors, captured once and replayed. fn reads and
    writes only tensors that outlive the capture; `outputs` is what the
    capture returned (static: a replay overwrites it). `launches` holds the
    kernel launches one replay makes."""

    def __init__(self, fn, device, name):
        launches = nb_kernel.LAUNCHES
        before = dict(launches)
        t0 = time.perf_counter()
        self._graph = Capture(device, name)
        try:
            self._graph.warmup(fn, WARMUP_RUNS)
            warm = dict(launches)
            self.outputs = self._graph.capture(fn)
            self.launches = _diff(launches, warm)
        finally:
            built = STATS["build_launches"]
            for k, v in _diff(launches, before).items():
                built[k] = built.get(k, 0) + v
            launches.update(before)
        STATS["captures"] += 1
        STATS["capture_s"] += time.perf_counter() - t0

    def replay(self, times: int = 1) -> None:
        for _ in range(times):
            self._graph.replay()
        for k, v in self.launches.items():
            nb_kernel.LAUNCHES[k] += v * times
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
    graphs' memory pools go back to the allocator."""
    slots = list(_CACHE) if slot is None else [slot] if slot in _CACHE else []
    for s in slots:
        del _CACHE[s]
    if slots and torch.cuda.is_available():
        torch.cuda.empty_cache()
