"""Build and load the port's CUDA kernels at first use.

Each ``csrc/<name>.cu`` source is compiled by ``nvcc`` for ``sm_90a`` into
its own shared library with a plain C interface, under ``build/repro_torch/``
at the root of the checkout (listed in ``.gitignore``), and loaded with
``ctypes``.  Nothing is compiled when a module is imported: the first call
of a kernel builds it, and ``build_all`` builds every kernel at once, one
``nvcc`` process per source, all started together.

A library is rebuilt when it is older than its source or a header in
``csrc/``.  There is no fallback: a missing ``nvcc`` or a failed build raises.
"""
from __future__ import annotations

import ctypes
import functools
import os
import shutil
import subprocess
import time
from pathlib import Path
from typing import Dict, List, Sequence

__all__ = ["KERNEL_SOURCES", "BUILD_DIR", "nvcc_path", "build_all", "load"]

_PKG = Path(__file__).resolve().parent
# Kernel name -> its source, relative to this package.
KERNEL_SOURCES: Dict[str, Path] = {
    "mpmm_wgmma": _PKG / "mpmm" / "csrc" / "mpmm_wgmma.cu",
    "mpmm_splitk": _PKG / "mpmm" / "csrc" / "mpmm_splitk.cu",
    "conv_mpmm": _PKG / "mpmm" / "csrc" / "conv_mpmm.cu",
    "flash_fwd": _PKG / "flashattn" / "csrc" / "flash_fwd.cu",
    "flash_fwd_packed": _PKG / "flashattn" / "csrc" / "flash_fwd_packed.cu",
}
BUILD_DIR = _PKG.parents[2] / "build" / "repro_torch"
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
              "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v")


def nvcc_path() -> str:
    """The CUDA compiler: ``nvcc`` on PATH, else under ``$CUDA_HOME``."""
    found = shutil.which("nvcc")
    if found:
        return found
    home = os.environ.get("CUDA_HOME", "/usr/local/cuda")
    cand = Path(home) / "bin" / "nvcc"
    if cand.exists():
        return str(cand)
    raise RuntimeError("nvcc not found (neither on PATH nor under CUDA_HOME); "
                       "the port's CUDA kernels are built from source at "
                       "first use and need the CUDA toolkit")


def _lib_path(name: str) -> Path:
    return BUILD_DIR / f"lib{name}.so"


def _stale(name: str) -> bool:
    lib = _lib_path(name)
    if not lib.exists():
        return True
    src = KERNEL_SOURCES[name]
    deps = [src, *src.parent.glob("*.cuh")]
    return max(d.stat().st_mtime for d in deps) > lib.stat().st_mtime


def _start(name: str, nvcc: str) -> subprocess.Popen:
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    tmp = _lib_path(name).with_suffix(f".{os.getpid()}.tmp")
    cmd = [nvcc, *NVCC_FLAGS, "-o", str(tmp), str(KERNEL_SOURCES[name])]
    return subprocess.Popen(cmd, stdout=subprocess.PIPE,
                            stderr=subprocess.STDOUT, text=True)


def _finish(name: str, proc: subprocess.Popen) -> str:
    log, _ = proc.communicate()
    tmp = _lib_path(name).with_suffix(f".{os.getpid()}.tmp")
    if proc.returncode != 0:
        tmp.unlink(missing_ok=True)
        raise RuntimeError(f"nvcc failed on {KERNEL_SOURCES[name]} "
                           f"(exit {proc.returncode}):\n{log}")
    tmp.replace(_lib_path(name))  # atomic: a cut build leaves no library
    return log


def build_all(names: Sequence[str] = tuple(KERNEL_SOURCES)) -> Dict[str, object]:
    """Build the named kernels in parallel (one ``nvcc`` each).

    Returns ``{"seconds": wall time, "logs": {name: nvcc output}}``; kernels
    whose library is up to date are not rebuilt and have no log.
    """
    t0 = time.perf_counter()
    todo: List[str] = [n for n in names if _stale(n)]
    nvcc = nvcc_path() if todo else ""
    procs = {n: _start(n, nvcc) for n in todo}
    logs = {}
    try:
        for n, proc in procs.items():
            logs[n] = _finish(n, proc)
    finally:
        for proc in procs.values():
            if proc.poll() is None:
                proc.kill()
                proc.wait()
    return {"seconds": time.perf_counter() - t0, "logs": logs}


@functools.cache
def load(name: str) -> ctypes.CDLL:
    """The kernel's shared library, built first if missing or stale."""
    if name not in KERNEL_SOURCES:
        raise KeyError(f"unknown kernel {name!r}; known: {sorted(KERNEL_SOURCES)}")
    build_all([name])
    return ctypes.CDLL(str(_lib_path(name)))
