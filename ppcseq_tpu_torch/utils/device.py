"""Device policy, and an environment probe.

Policy: every array the model computes on lives on one explicit
`torch.device`, in the dtype the caller asked for, on the card as on the
CPU: float32 runs the likelihood kernels K1/K2, float64 their float64 forms
(ops/nb_kernel.py), and the CPU runs their plain versions in either, so the
parity tests can run the whole port in float64 against the JAX package.
"""

from __future__ import annotations

import importlib
import shutil
import subprocess

import torch


def resolve_device(device) -> torch.device:
    """`device` as a torch.device; a CUDA device must exist (no fallback)."""
    dev = torch.device(device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(f"device {dev} requested but torch.cuda.is_available() is False")
    return dev


def _version(module: str) -> str:
    try:
        return getattr(importlib.import_module(module), "__version__", "?")
    except ImportError:
        return "missing"


def _run(cmd: list[str]) -> str:
    if shutil.which(cmd[0]) is None:
        return "missing"
    try:
        out = subprocess.run(cmd, capture_output=True, text=True, timeout=30)
    except (OSError, subprocess.TimeoutExpired) as e:
        return f"failed ({e})"
    return (out.stdout or out.stderr).strip()


def nvcc_path() -> str | None:
    """The CUDA compiler: on PATH, else the toolkit's default location."""
    found = shutil.which("nvcc")
    if found:
        return found
    default = "/usr/local/cuda/bin/nvcc"
    return default if shutil.which(default) else None


def gpu_name_and_power_limit() -> str:
    """`name, power.limit` of each card as nvidia-smi prints them."""
    return _run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"])


def probe() -> str:
    """One line per fact: library versions, compiler, the card, and whether
    this torch has a call of its own for CUDA-graph IF nodes (the port makes
    them itself, infer/graphs.py)."""
    nvcc = nvcc_path()
    nvcc_v = _run([nvcc, "--version"]).splitlines()[-1] if nvcc else "missing"
    lines = [
        f"torch {torch.__version__} (cuda {torch.version.cuda}, "
        f"available={torch.cuda.is_available()}, devices={torch.cuda.device_count()})",
        f"triton {_version('triton')}",
        f"nvcc {nvcc_v}",
        f"numpy {_version('numpy')}",
        f"pandas {_version('pandas')}",
        f"pyarrow {_version('pyarrow')}",
        f"gpu {gpu_name_and_power_limit()}",
        "cuda graph conditional nodes (torch.cuda.CUDAGraph.begin_capture_to_if_node): "
        f"{hasattr(torch.cuda.CUDAGraph, 'begin_capture_to_if_node')}",
    ]
    return "\n".join(lines)
