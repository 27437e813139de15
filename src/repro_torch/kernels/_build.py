"""Build and load the port's CUDA kernels at first use.

Each ``csrc/<name>.cu`` source is compiled by ``nvcc`` for ``sm_90a`` into
its own shared library with a plain C interface, under ``build/repro_torch/``
at the root of the checkout (listed in ``.gitignore``), and loaded with
``ctypes``.  Nothing is compiled when a module is imported: the first call
of a kernel builds it, and ``build_all`` builds every kernel at once, one
``nvcc`` process per source, all started together.

K1's tensor-core route and K2 are built as two libraries each, one per
part of the 16 weight formats (``FORMAT_PARTS``: w in {1, 2}, w in {4, 8}),
so that their 32 and 64 instantiations compile in parallel; the build names
each library's word lengths to ``csrc/mpmm_bits.cuh`` (``-DK1_BUILD_W<w>``)
and ``format_lib`` names the library that holds a format.

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
from typing import Dict, List, Sequence, Tuple

__all__ = ["KERNEL_SOURCES", "KERNEL_DEFINES", "FORMAT_PARTS", "BUILD_DIR",
           "nvcc_path", "format_lib", "build_all", "load"]

_PKG = Path(__file__).resolve().parent
_MPMM = _PKG / "mpmm" / "csrc"
# The sources built in parts, and each part's word lengths w.
FORMAT_PARTS: Dict[str, Tuple[int, ...]] = {"w12": (1, 2), "w48": (4, 8)}
_PARTED = ("mpmm_wgmma", "conv_mpmm")
# Library name -> its source, relative to this package.
KERNEL_SOURCES: Dict[str, Path] = {
    **{f"{base}_{part}": _MPMM / f"{base}.cu"
       for base in _PARTED for part in FORMAT_PARTS},
    "mpmm_splitk": _MPMM / "mpmm_splitk.cu",
    "flash_fwd": _PKG / "flashattn" / "csrc" / "flash_fwd.cu",
    "flash_fwd_packed": _PKG / "flashattn" / "csrc" / "flash_fwd_packed.cu",
}


def _word_lengths(ws: Sequence[int]) -> Tuple[str, ...]:
    return tuple(f"-DK1_BUILD_W{w}={int(w in ws)}" for w in (1, 2, 4, 8))


# Library name -> the preprocessor definitions of its build.
KERNEL_DEFINES: Dict[str, Tuple[str, ...]] = {
    "mpmm_splitk": _word_lengths((1, 2, 4, 8)),
    **{f"{base}_{part}": _word_lengths(ws)
       for base in _PARTED for part, ws in FORMAT_PARTS.items()}}
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


def format_lib(base: str, w_bits: int) -> str:
    """The library of ``base`` (``mpmm_wgmma`` or ``conv_mpmm``) that holds
    the formats of word length ``w_bits``."""
    part, = (p for p, ws in FORMAT_PARTS.items() if w_bits in ws)
    return f"{base}_{part}"


def _lib_path(name: str) -> Path:
    return BUILD_DIR / f"lib{name}.so"


def _stale(name: str) -> bool:
    lib = _lib_path(name)
    if not lib.exists():
        return True
    src = KERNEL_SOURCES[name]
    deps = [src, *src.parent.glob("*.cuh")]
    return max(d.stat().st_mtime for d in deps) > lib.stat().st_mtime


def _tmp(name: str, suffix: str) -> Path:
    return _lib_path(name).with_suffix(f".{os.getpid()}.{suffix}")


def _start(name: str, nvcc: str) -> subprocess.Popen:
    """One nvcc process, its output to a log file: a pipe would fill with
    ``-Xptxas -v`` lines and stall the compiler until it is read."""
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    cmd = [nvcc, *NVCC_FLAGS, *KERNEL_DEFINES.get(name, ()), "-o",
           str(_tmp(name, "tmp")), str(KERNEL_SOURCES[name])]
    with open(_tmp(name, "log"), "w") as log:
        return subprocess.Popen(cmd, stdout=log, stderr=subprocess.STDOUT)


def _finish(name: str, proc: subprocess.Popen) -> str:
    log_path = _tmp(name, "log")
    log = log_path.read_text()
    log_path.unlink()
    if proc.returncode != 0:
        _tmp(name, "tmp").unlink(missing_ok=True)
        raise RuntimeError(f"nvcc failed on {KERNEL_SOURCES[name]} "
                           f"(exit {proc.returncode}):\n{log}")
    _tmp(name, "tmp").replace(_lib_path(name))  # atomic: a cut build
    return log                                  # leaves no library


def build_all(names: Sequence[str] = tuple(KERNEL_SOURCES)) -> Dict[str, object]:
    """Build the named kernels in parallel (one ``nvcc`` each).

    Returns ``{"seconds": wall time, "logs": {name: nvcc output},
    "per_source": {name: seconds its nvcc took}}``; kernels whose library
    is up to date are not rebuilt and have no log.
    """
    t0 = time.perf_counter()
    todo: List[str] = [n for n in names if _stale(n)]
    nvcc = nvcc_path() if todo else ""
    procs = {n: _start(n, nvcc) for n in todo}
    logs, took = {}, {}
    try:
        while len(took) < len(procs):
            for n, proc in procs.items():
                if n not in took and proc.poll() is not None:
                    took[n] = time.perf_counter() - t0
                    logs[n] = _finish(n, proc)
            time.sleep(0.05)
    finally:
        for proc in procs.values():
            if proc.poll() is None:
                proc.kill()
                proc.wait()
    return {"seconds": time.perf_counter() - t0, "logs": logs,
            "per_source": took}


@functools.cache
def load(name: str) -> ctypes.CDLL:
    """The kernel's shared library, built first if missing or stale."""
    if name not in KERNEL_SOURCES:
        raise KeyError(f"unknown kernel {name!r}; known: {sorted(KERNEL_SOURCES)}")
    build_all([name])
    return ctypes.CDLL(str(_lib_path(name)))
