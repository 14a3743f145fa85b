"""Build and load the port's native host runtime (native/ppcseq_native.cpp).

The dense pivot of the tidy table (`pivot_counts`), the TMM norm factors
(`tmm_norm_factors`) and R's type-7 quantile of a sorted array
(`quantile7_sorted`), in C++ and called through ctypes, as the JAX
package's `_native` does. The library is built at first use with the host
C++ compiler (`CXX`, default `g++`) under native/Makefile's flags, into
`build/native/ppcseq_native-<hash>/libppcseq_native.so` (the root `build/`
as ops/_build.build_dir, PPCSEQ_TORCH_BUILD_DIR included). The hash keys
the source, the flags, the compiler's `--version` and what `-march=native`
resolves to on this host, so a changed source or another host's CPU is
rebuilt. A build writes a temporary file and renames it into place, so
processes that build at the same time (test workers, torchrun ranks) each
see the whole library or none.

There is no fallback: if the compiler is missing or the build or the load
fails, the call raises RuntimeError with the compiler's output. The NumPy
versions (`data.ingest._pivot_numpy`, `norm.tmm.tmm_norm_factors(...,
use_native=False)`) are the plain references the tests hold this against.
Nothing here runs at import time.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import subprocess
import time
from pathlib import Path

import numpy as np

from ppcseq_tpu_torch.ops._build import build_dir

SOURCE = Path(__file__).resolve().parent / "native" / "ppcseq_native.cpp"
# native/Makefile's CXXFLAGS, plus -shared
CXX_FLAGS = ["-O3", "-march=native", "-std=c++17", "-fPIC", "-Wall", "-shared"]

_LOADED: dict[Path, ctypes.CDLL] = {}
_COMPILER_ID: dict[str, str] = {}
# the last library loaded: {"path", "cached", "seconds" (build + load), "log"}
BUILD_INFO: dict = {}


def compiler() -> str:
    return os.environ.get("CXX", "g++")


def _compiler_id(cxx: str) -> str:
    """The compiler's `--version` and the target `-march=native` selects."""
    if cxx not in _COMPILER_ID:
        try:
            version = subprocess.run([cxx, "--version"], capture_output=True, text=True,
                                     timeout=60)
        except OSError as e:
            raise RuntimeError(f"host C++ compiler {cxx!r} cannot be run: {e}") from e
        if version.returncode != 0:
            raise RuntimeError(f"`{cxx} --version` failed:\n{version.stdout}{version.stderr}")
        # g++ prints the resolved -march and ISA flags; another compiler's
        # refusal is hashed as printed
        target = subprocess.run([cxx, "-march=native", "-Q", "--help=target"],
                                capture_output=True, text=True, timeout=60)
        _COMPILER_ID[cxx] = version.stdout + target.stdout + target.stderr
    return _COMPILER_ID[cxx]


def lib_path(cxx: str | None = None) -> Path:
    """Where the library built by `cxx` from the current source goes."""
    cxx = cxx or compiler()
    h = hashlib.sha256(SOURCE.read_bytes())
    h.update(" ".join(CXX_FLAGS).encode())
    h.update(_compiler_id(cxx).encode())
    return build_dir("native") / f"ppcseq_native-{h.hexdigest()[:16]}" / "libppcseq_native.so"


def _build(cxx: str, path: Path) -> str:
    path.parent.mkdir(parents=True, exist_ok=True)
    tmp = path.parent / f".{path.name}.{os.getpid()}.tmp"
    try:
        proc = subprocess.run([cxx, *CXX_FLAGS, "-o", str(tmp), str(SOURCE)],
                              capture_output=True, text=True, timeout=600)
    except OSError as e:
        raise RuntimeError(f"host C++ compiler {cxx!r} cannot be run: {e}") from e
    log = proc.stdout + proc.stderr
    if proc.returncode != 0:
        tmp.unlink(missing_ok=True)
        raise RuntimeError(f"building {SOURCE.name} with {cxx} failed:\n{log}")
    os.replace(tmp, path)  # atomic: a concurrent build sees all or nothing
    return log


def load() -> ctypes.CDLL:
    """The library for the current source and compiler, built if needed."""
    cxx = compiler()
    path = lib_path(cxx)
    lib = _LOADED.get(path)
    if lib is not None:
        return lib
    t0 = time.perf_counter()
    cached = path.exists()
    log = "" if cached else _build(cxx, path)
    try:
        lib = ctypes.CDLL(str(path))
    except OSError as e:
        raise RuntimeError(f"loading {path} failed: {e}\n{log}") from e
    i64p = ctypes.POINTER(ctypes.c_int64)
    f64p = ctypes.POINTER(ctypes.c_double)
    lib.pivot_counts.argtypes = [i64p, i64p, i64p, ctypes.c_int64, ctypes.c_int64, i64p]
    lib.pivot_counts.restype = None
    lib.tmm_norm_factors.argtypes = [f64p, ctypes.c_int64, ctypes.c_int64, ctypes.c_int64, f64p]
    lib.tmm_norm_factors.restype = None
    lib.quantile7_sorted.argtypes = [f64p, ctypes.c_int64, ctypes.c_double]
    lib.quantile7_sorted.restype = ctypes.c_double
    _LOADED[path] = lib
    BUILD_INFO.clear()
    BUILD_INFO.update(path=str(path), cached=cached, seconds=time.perf_counter() - t0, log=log)
    return lib


def _ptr(a: np.ndarray, ctype):
    return a.ctypes.data_as(ctypes.POINTER(ctype))


def pivot_counts(s_idx: np.ndarray, g_idx: np.ndarray, values: np.ndarray,
                 S: int, G: int) -> np.ndarray:
    """Dense [S, G] int64 from (s, g, value) triplets; cells not named are
    0, and a later triplet overwrites an earlier one on the same cell."""
    s = np.ascontiguousarray(s_idx, dtype=np.int64)
    g = np.ascontiguousarray(g_idx, dtype=np.int64)
    v = np.ascontiguousarray(values, dtype=np.int64)
    if not s.ndim == g.ndim == v.ndim == 1 or not len(s) == len(g) == len(v):
        raise ValueError(f"pivot_counts: index and value vectors of shapes "
                         f"{s.shape}, {g.shape}, {v.shape}")
    if len(v) and (s.min() < 0 or s.max() >= S or g.min() < 0 or g.max() >= G):
        raise ValueError(f"pivot_counts: an index lies outside [{S}, {G}]")
    out = np.zeros((S, G), dtype=np.int64)
    load().pivot_counts(_ptr(s, ctypes.c_int64), _ptr(g, ctypes.c_int64),
                        _ptr(v, ctypes.c_int64), len(v), G, _ptr(out, ctypes.c_int64))
    return out


def tmm_norm_factors(counts_genes_by_samples: np.ndarray, ref_column: int) -> np.ndarray:
    """TMM factors of a [genes, samples] matrix against one reference
    column, rescaled to multiply to one (edgeR .calcFactorTMM's defaults)."""
    x = np.ascontiguousarray(counts_genes_by_samples, dtype=np.float64)
    if x.ndim != 2 or x.shape[1] == 0:
        raise ValueError(f"tmm_norm_factors: a [genes, samples] matrix, got {x.shape}")
    n_genes, n_samples = x.shape
    if not 0 <= ref_column < n_samples:
        raise ValueError(f"tmm_norm_factors: ref_column {ref_column} of {n_samples} samples")
    out = np.zeros(n_samples, dtype=np.float64)
    load().tmm_norm_factors(_ptr(x, ctypes.c_double), n_genes, n_samples, int(ref_column),
                            _ptr(out, ctypes.c_double))
    return out


def quantile7_sorted(sorted_values: np.ndarray, p: float) -> float:
    """R's type-7 quantile (NumPy's "linear") of an ascending array; NaN
    when it is empty."""
    x = np.ascontiguousarray(sorted_values, dtype=np.float64)
    if x.ndim != 1 or not 0.0 <= p <= 1.0:
        raise ValueError(f"quantile7_sorted: a 1-D array and p in [0, 1], got {x.shape}, {p}")
    return float(load().quantile7_sorted(_ptr(x, ctypes.c_double), len(x), float(p)))
