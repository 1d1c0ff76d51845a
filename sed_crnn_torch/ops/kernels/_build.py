"""Build and load the port's CUDA kernels.

Each ``sed_crnn_torch/csrc/<name>.cu`` is compiled by ``nvcc`` for Hopper
(``sm_90a``) into a shared library with a plain C interface, which is loaded
with `ctypes`. The library lands in ``build/sed_crnn_torch/`` at the root of
the checkout, under a name that carries a hash of its source and of the
headers beside it (``csrc/*.cuh``), so an edited source is never served by
a stale library. Nothing is built when a module is imported: the first call
that needs a kernel builds it, and `build_all` builds every kernel at once
(one ``nvcc`` process per source, in parallel).
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import threading
import time
from pathlib import Path
from typing import Dict, Tuple

PACKAGE_DIR = Path(__file__).resolve().parents[2]
CSRC_DIR = PACKAGE_DIR / "csrc"
BUILD_DIR = PACKAGE_DIR.parent / "build" / "sed_crnn_torch"
KERNEL_SOURCES = ("gru_cluster", "gru_dwh", "gru_grid", "gru_warp", "gru_wide",
                  "logmel_cluster", "logmel_fft", "logmel_mixed")
NVCC_FLAGS = (
    "-gencode", "arch=compute_90a,code=sm_90a",
    "-std=c++17", "-O3", "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v",
)

_lock = threading.Lock()
_loaded: Dict[str, ctypes.CDLL] = {}
# Last build's ptxas report per kernel source (registers, spills, smem).
ptxas_reports: Dict[str, str] = {}


def _nvcc() -> str:
    """``nvcc`` from PATH, else from the toolkit under ``CUDA_HOME``."""
    found = shutil.which("nvcc")
    if found:
        return found
    cand = Path(os.environ.get("CUDA_HOME", "/usr/local/cuda")) / "bin" / "nvcc"
    if cand.exists():
        return str(cand)
    raise RuntimeError("nvcc not found: the CUDA kernels are built on a machine "
                       "with the CUDA toolkit")


def _library_path(name: str) -> Tuple[Path, Path]:
    """The source and its library, named by a hash of the source and of
    every header under ``csrc/`` (which the sources share)."""
    src = CSRC_DIR / f"{name}.cu"
    h = hashlib.sha256(src.read_bytes())
    for header in sorted(CSRC_DIR.glob("*.cuh")):
        h.update(header.read_bytes())
    return src, BUILD_DIR / f"lib{name}-{h.hexdigest()[:12]}.so"


def _start(name: str):
    """Start ``nvcc`` for one source; None when its library is already built."""
    src, lib = _library_path(name)
    if lib.exists():
        return None
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    tmp = lib.with_suffix(f".{os.getpid()}.tmp")
    cmd = [_nvcc(), *NVCC_FLAGS, "-o", str(tmp), str(src)]
    proc = subprocess.Popen(cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
    return proc, tmp, lib


def _finish(name: str, started) -> str:
    """Wait for one ``nvcc``; install its library, or return its error."""
    proc, tmp, lib = started
    out, _ = proc.communicate()
    ptxas_reports[name] = out
    if proc.returncode != 0:
        tmp.unlink(missing_ok=True)
        return f"nvcc failed for {name}.cu (exit {proc.returncode}):\n{out}"
    os.replace(tmp, lib)
    return ""


def build_all() -> float:
    """Build every kernel library that is missing, all ``nvcc`` runs started
    together and all waited for; returns the wall seconds spent."""
    t0 = time.perf_counter()
    with _lock:
        started = {n: _start(n) for n in KERNEL_SOURCES}
        errors = [_finish(n, s) for n, s in started.items() if s is not None]
    if any(errors):
        raise RuntimeError("\n".join(e for e in errors if e))
    return time.perf_counter() - t0


def load(name: str) -> ctypes.CDLL:
    """The loaded library for ``csrc/<name>.cu``, built on first use."""
    with _lock:
        if name in _loaded:
            return _loaded[name]
        started = _start(name)
        error = _finish(name, started) if started is not None else ""
        if error:
            raise RuntimeError(error)
        lib = ctypes.CDLL(str(_library_path(name)[1]))
        _loaded[name] = lib
        return lib
