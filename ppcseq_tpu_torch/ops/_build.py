"""Build and load the port's CUDA kernels.

Each kernel source under csrc/ is compiled with nvcc into a shared library
with a plain C interface and loaded with ctypes. Libraries go to
`build/kernels/<source stem>-<hash>/` at the repository root (the root
`build/` moves with PPCSEQ_TORCH_BUILD_DIR), keyed by a hash of the
source, the shared csrc/*.cuh headers and the flags, so a changed source
is rebuilt and an unchanged one is loaded as built. `load_all` starts one
nvcc per source, all at once. Nothing here runs at import time.
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
# source name -> {"seconds" (wall of its load_all call), "cached", "log"}
BUILD_LOG: dict[str, dict] = {}


def build_dir(kind: str = "kernels") -> Path:
    """Where built libraries of one kind go: `<root>/<kind>`, the root being
    PPCSEQ_TORCH_BUILD_DIR or `build/` at the repository root."""
    root = os.environ.get("PPCSEQ_TORCH_BUILD_DIR")
    return (Path(root) if root else Path(__file__).resolve().parents[2] / "build") / kind


def _lib_path(source: str) -> Path:
    """Where csrc/<source> builds to, keyed by the source, the shared
    headers and the flags."""
    src = CSRC / source
    h = hashlib.sha256(src.read_bytes())
    for header in sorted(CSRC.glob("*.cuh")):
        h.update(header.read_bytes())
    h.update(" ".join(NVCC_FLAGS).encode())
    return build_dir() / f"{src.stem}-{h.hexdigest()[:16]}" / f"lib{src.stem}.so"


def load_all(sources) -> list[ctypes.CDLL]:
    """Compile the sources that are not built yet, one nvcc each, all
    started together; return the loaded libraries in order."""
    t0 = time.perf_counter()
    todo = [s for s in dict.fromkeys(sources) if s not in _LOADED]
    procs = {}
    for source in todo:
        lib_path = _lib_path(source)
        if lib_path.exists():
            continue
        nvcc = nvcc_path()
        if nvcc is None:
            raise RuntimeError(f"nvcc not found: cannot build {source}")
        lib_path.parent.mkdir(parents=True, exist_ok=True)
        tmp = lib_path.parent / f".{lib_path.name}.{os.getpid()}.tmp"
        proc = subprocess.Popen(
            [nvcc, *NVCC_FLAGS, "-o", str(tmp), str(CSRC / source)],
            stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True,
        )
        procs[source] = (proc, tmp, lib_path)
    failed = []
    for source, (proc, tmp, lib_path) in procs.items():
        log = proc.communicate()[0]
        if proc.returncode != 0:
            failed.append(f"nvcc failed for {source}:\n{log}")
            continue
        os.replace(tmp, lib_path)  # atomic: a concurrent build sees all or nothing
        BUILD_LOG[source] = {"log": log, "cached": False}
    if failed:
        raise RuntimeError("\n".join(failed))
    for source in todo:
        _LOADED[source] = ctypes.CDLL(str(_lib_path(source)))
        entry = BUILD_LOG.setdefault(source, {"log": "", "cached": True})
        entry["seconds"] = time.perf_counter() - t0
    return [_LOADED[s] for s in sources]
