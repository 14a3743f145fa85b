"""Build and load the port's CUDA kernels.

Each kernel source under csrc/ is compiled with nvcc into a shared library
with a plain C interface and loaded with ctypes. Libraries go to
`build/kernels/<source stem>-<hash>/` at the repository root (override with
PPCSEQ_TORCH_BUILD_DIR), keyed by a hash of the source and the flags, so a
changed source is rebuilt and an unchanged one is loaded as built. Nothing
here runs at import time.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import subprocess
import time
from pathlib import Path

from ppcseq_tpu_torch.utils.device import nvcc_path

CSRC = Path(__file__).resolve().parent.parent / "csrc"
NVCC_FLAGS = [
    "-gencode", "arch=compute_90a,code=sm_90a",
    "-O3", "-std=c++17",
    # no --use_fast_math: the delta form needs accurate expf/logf; no FMA
    # contraction: every product and sum rounds once, as in the plain torch
    # version the kernel is held against
    "--fmad=false",
    "-shared", "-Xcompiler", "-fPIC",
    "-Xptxas", "-v",
]

_LOADED: dict[str, ctypes.CDLL] = {}
BUILD_LOG: dict[str, dict] = {}  # source name -> {"seconds", "cached", "log"}


def build_dir() -> Path:
    env = os.environ.get("PPCSEQ_TORCH_BUILD_DIR")
    if env:
        return Path(env)
    return Path(__file__).resolve().parents[2] / "build" / "kernels"


def load(source: str) -> ctypes.CDLL:
    """Compile csrc/<source> if needed and return the loaded library."""
    if source in _LOADED:
        return _LOADED[source]
    src = CSRC / source
    text = src.read_bytes()
    key = hashlib.sha256(text + " ".join(NVCC_FLAGS).encode()).hexdigest()[:16]
    out_dir = build_dir() / f"{src.stem}-{key}"
    lib_path = out_dir / f"lib{src.stem}.so"
    t0 = time.perf_counter()
    log = ""
    cached = lib_path.exists()
    if not cached:
        nvcc = nvcc_path()
        if nvcc is None:
            raise RuntimeError(f"nvcc not found: cannot build {source}")
        out_dir.mkdir(parents=True, exist_ok=True)
        tmp = out_dir / f".{lib_path.name}.{os.getpid()}.tmp"
        proc = subprocess.run(
            [nvcc, *NVCC_FLAGS, "-o", str(tmp), str(src)],
            capture_output=True, text=True,
        )
        log = proc.stdout + proc.stderr
        if proc.returncode != 0:
            raise RuntimeError(f"nvcc failed for {source}:\n{log}")
        os.replace(tmp, lib_path)  # atomic: a concurrent build sees all or nothing
    lib = ctypes.CDLL(str(lib_path))
    BUILD_LOG[source] = {"seconds": time.perf_counter() - t0, "cached": cached, "log": log}
    _LOADED[source] = lib
    return lib
