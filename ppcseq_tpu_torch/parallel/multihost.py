"""Process-group start-up and mesh construction
(ppcseq_tpu/parallel/multihost.py).

The reference's only distributed mode is Stan's map_rect over MPI ranks
(SURVEY.md §5). Here every rank is one process: launch them with torchrun
(`torchrun --nproc-per-node N -m ppcseq_tpu_torch ... --mesh genes=N`),
which sets RANK, WORLD_SIZE, LOCAL_RANK and the rendezvous address, and
call `initialize()` then `pod_mesh()` or `gene_mesh()` in every rank. The
fits then take the mesh (`identify_outliers(mesh=...)`) and do their own
collectives (parallel/sharding.py).

Backends: NCCL when each rank has a card of its own; gloo on the CPU, and
for CUDA too when more ranks than cards share a host (NCCL refuses two
ranks on one card), as `cpu:gloo,cuda:gloo`.
"""

from __future__ import annotations

import os

import torch


def _backend(device_type: str) -> str:
    if device_type != "cuda":
        return "gloo"
    per_host = int(os.environ.get("LOCAL_WORLD_SIZE", os.environ.get("WORLD_SIZE", "1")))
    if per_host <= torch.cuda.device_count():
        return "cpu:gloo,cuda:nccl"
    return "cpu:gloo,cuda:gloo"


def _mesh_device(device: str) -> str:
    """The mesh's device type; "cuda" without a card raises."""
    dev = torch.device(device).type
    if dev == "cuda" and not torch.cuda.is_available():
        raise RuntimeError("device cuda requested but torch.cuda.is_available() is False")
    return dev


def initialize(device: str = "cuda", init_method: str = "env://") -> None:
    """Bring up the default process group from torchrun's environment (a
    no-op when it is already up). On CUDA each rank takes card
    LOCAL_RANK % device_count. `device` is "cuda" (the default: it raises
    without a card, as every entry point of the port) or "cpu"."""
    import torch.distributed as dist

    dev = _mesh_device(device)
    if dev == "cuda":
        torch.cuda.set_device(int(os.environ.get("LOCAL_RANK", "0")) % torch.cuda.device_count())
    if dist.is_initialized():
        return
    dist.init_process_group(backend=_backend(dev), init_method=init_method,
                            rank=int(os.environ.get("RANK", "0")),
                            world_size=int(os.environ.get("WORLD_SIZE", "1")))


def pod_mesh(chains_axis: int | None = None, device: str = "cuda"):
    """2-D ("chains", "genes") mesh over every rank. `chains_axis` ranks
    (default: the ranks per host, LOCAL_WORLD_SIZE) form the chain axis,
    lowered until it divides the world; the rest shard genes."""
    import torch.distributed as dist
    from torch.distributed.device_mesh import init_device_mesh

    dev = _mesh_device(device)
    n = dist.get_world_size()
    if chains_axis is None:
        chains_axis = max(1, int(os.environ.get("LOCAL_WORLD_SIZE", "1")))
    chains_axis = max(1, min(chains_axis, n))
    while n % chains_axis:
        chains_axis -= 1
    return init_device_mesh(dev, (chains_axis, n // chains_axis),
                            mesh_dim_names=("chains", "genes"))


def gene_mesh(n_ranks: int | None = None, device: str = "cuda"):
    """1-D mesh over the `genes` axis: every rank of the world
    (ppcseq_tpu/parallel/sharding.py:28-34's gene_mesh)."""
    import torch.distributed as dist
    from torch.distributed.device_mesh import init_device_mesh

    dev = _mesh_device(device)
    n = dist.get_world_size() if n_ranks is None else int(n_ranks)
    return init_device_mesh(dev, (n,), mesh_dim_names=("genes",))
