"""K1: the mixed-precision matmul kernel and its plain PyTorch version.

``mpmm_cuda`` wraps the hand-written CUDA kernel ``csrc/mpmm.cu``, which
replaces the Pallas TPU kernel ``repro.kernels.mpmm.kernel.mpmm_pallas``:

    y[M, N] = epilogue(gamma * ((a_biased @ W_int) + act_zero * colsum))

with ``a_biased`` int8 (M, K) and ``W_int`` decoded in the kernel from the
packed uint8 digit planes (P, ceil(K/f), N).  ``variant='st'`` shift-adds
the planes into one int32 accumulator, ``'sa'`` keeps one per plane and
combines them in the epilogue; both give the same integers.

``mpmm_torch`` is the plain version (the twin of the JAX package's
``ops._xla_impl``): one exact integer product against the recombined int8
weights, then ``epilogue.finish``.  The CPU tests hold it against the JAX
package, and ``chip_smoke.py`` holds the kernel against it on the card.

The wrapper checks device, dtype, shape and contiguity and raises on
anything the kernel does not take; it never falls back to the plain
version.  ``mpmm_cuda.launches`` counts the kernel's launches.
"""
from __future__ import annotations

import ctypes
import functools
from typing import Optional, Sequence

import torch

from repro_torch.core.packing import PlaneFormat
from repro_torch.kernels import _build
from repro_torch.kernels.mpmm import epilogue as _epi
from repro_torch.kernels.mpmm import ref as _ref
from repro_torch.kernels.mpmm.epilogue import EpilogueSpec

__all__ = ["TILE", "mpmm_cuda", "mpmm_torch", "epilogue_flags"]

# The kernel's fixed (bm, bk, bn) tile (csrc/mpmm_common.cuh BM, BK, BN).
TILE = (64, 32, 64)

# Epilogue flag bits, as csrc/mpmm_common.cuh defines them.
EPI_BN, EPI_RESIDUAL, EPI_RELU, RES_BF16, OUT_BF16 = 1, 2, 4, 8, 16
OUT_DTYPES = (torch.float32, torch.bfloat16)
VARIANTS = ("st", "sa")


def epilogue_flags(spec: Optional[EpilogueSpec],
                   residual: Optional[torch.Tensor], out_dtype) -> int:
    """The kernel's epilogue flag word for ``spec`` and the operand dtypes."""
    flags = 0
    if spec is not None:
        flags |= (EPI_BN if spec.bn else 0) | (EPI_RELU if spec.relu else 0)
        if spec.residual:
            flags |= EPI_RESIDUAL
            if residual.dtype == torch.bfloat16:
                flags |= RES_BF16
    if out_dtype == torch.bfloat16:
        flags |= OUT_BF16
    return flags


def check_operand(name: str, t: torch.Tensor, device: torch.device,
                  dtypes: Sequence[torch.dtype],
                  shape: Optional[Sequence[int]] = None) -> None:
    """Raise unless ``t`` is a contiguous tensor of an accepted dtype (and
    shape) on the kernel's CUDA device."""
    if not isinstance(t, torch.Tensor):
        raise TypeError(f"{name} must be a torch.Tensor, got {type(t)}")
    if t.device != device:
        raise ValueError(f"{name} is on {t.device}; the kernel runs on {device}")
    if t.dtype not in dtypes:
        raise TypeError(f"{name} has dtype {t.dtype}; the kernel takes "
                        f"{[str(d) for d in dtypes]}")
    if shape is not None and tuple(t.shape) != tuple(shape):
        raise ValueError(f"{name} has shape {tuple(t.shape)}, expected "
                         f"{tuple(shape)}")
    if not t.is_contiguous():
        raise ValueError(f"{name} must be contiguous")


def check_common(device: torch.device, planes: torch.Tensor, fmt: PlaneFormat,
                 gamma: torch.Tensor, colsum: torch.Tensor,
                 scale: Optional[torch.Tensor], shift: Optional[torch.Tensor],
                 variant: str, out_dtype) -> None:
    """Checks shared by both kernel wrappers (everything but the input)."""
    if device.type != "cuda":
        raise ValueError(f"the CUDA kernel needs CUDA tensors, got {device}; "
                         f"use impl='torch' (or 'auto') for CPU tensors")
    n = planes.shape[-1]
    check_operand("planes", planes, device, (torch.uint8,),
                  (fmt.planes, fmt.packed_k, n))
    check_operand("gamma", gamma, device, (torch.float32,))
    check_operand("colsum", colsum, device, (torch.int32,))
    for name, t in (("gamma", gamma), ("colsum", colsum), ("scale", scale),
                    ("shift", shift)):
        if t is not None and t.numel() != n:
            raise ValueError(f"{name} must hold N={n} values, got "
                             f"{tuple(t.shape)}")
    for name, t in (("scale", scale), ("shift", shift)):
        if t is not None:
            check_operand(name, t, device, (torch.float32,))
    if variant not in VARIANTS:
        raise ValueError(f"variant must be one of {VARIANTS}, got {variant!r}")
    if out_dtype not in OUT_DTYPES:
        raise TypeError(f"out_dtype must be one of {OUT_DTYPES}, got {out_dtype}")


def ptr(t: Optional[torch.Tensor]) -> Optional[int]:
    return None if t is None else t.data_ptr()


def raise_on_error(name: str, err: int) -> None:
    if err != 0:
        raise RuntimeError(f"{name} launch failed with CUDA error {err}")


@functools.cache
def _launcher():
    fn = _build.load("mpmm").mpmm_launch
    fn.argtypes = [ctypes.c_void_p] * 8 + [ctypes.c_int] * 10 + [ctypes.c_void_p]
    fn.restype = ctypes.c_int
    return fn


def mpmm_cuda(a_biased: torch.Tensor, planes: torch.Tensor,
              gamma: torch.Tensor, colsum: torch.Tensor, *,
              fmt: PlaneFormat, act_zero: int, variant: str = "st",
              out_dtype=torch.float32,
              epilogue: Optional[EpilogueSpec] = None,
              scale: Optional[torch.Tensor] = None,
              shift: Optional[torch.Tensor] = None,
              residual: Optional[torch.Tensor] = None) -> torch.Tensor:
    """Launch K1 on CUDA tensors -> (M, N) of ``out_dtype`` (f32 or bf16).

    a_biased int8 (M, K) with K == fmt.k_dim; planes uint8 (P, Kp, N);
    gamma f32 and colsum int32 with N values; scale/shift f32 with N values
    when ``epilogue.bn``; residual (M, N) f32 or bf16 when
    ``epilogue.residual``.  Ragged M, N and K are masked in the kernel.
    """
    _epi.validate_operands(epilogue, scale, shift, residual)
    out_dtype = _epi.resolve_out_dtype(epilogue, out_dtype)
    device = a_biased.device
    check_common(device, planes, fmt, gamma, colsum, scale, shift, variant,
                 out_dtype)
    m, kdim = a_biased.shape
    n = planes.shape[-1]
    if kdim != fmt.k_dim:
        raise ValueError(f"a_biased has K={kdim}, the format says "
                         f"{fmt.k_dim}")
    check_operand("a_biased", a_biased, device, (torch.int8,))
    if residual is not None:
        check_operand("residual", residual, device,
                      (torch.float32, torch.bfloat16), (m, n))
    out = torch.empty((m, n), dtype=out_dtype, device=device)
    if m == 0 or n == 0:
        return out
    with torch.cuda.device(device):
        stream = torch.cuda.current_stream(device).cuda_stream
        err = _launcher()(
            ptr(a_biased), ptr(planes), ptr(gamma), ptr(colsum), ptr(scale),
            ptr(shift), ptr(residual), ptr(out), m, n, kdim, fmt.packed_k,
            fmt.planes, fmt.k, fmt.w_bits, act_zero, int(variant == "sa"),
            epilogue_flags(epilogue, residual, out_dtype), stream)
    raise_on_error("mpmm_cuda", err)
    mpmm_cuda.launches += 1
    return out


mpmm_cuda.launches = 0


def mpmm_torch(a_biased: torch.Tensor, planes: torch.Tensor,
               gamma: torch.Tensor, colsum: torch.Tensor, *,
               fmt: PlaneFormat, act_zero: int, variant: str = "st",
               out_dtype=torch.float32,
               epilogue: Optional[EpilogueSpec] = None,
               scale: Optional[torch.Tensor] = None,
               shift: Optional[torch.Tensor] = None,
               residual: Optional[torch.Tensor] = None) -> torch.Tensor:
    """Plain version of K1 (twin of ``ops._xla_impl``): one exact integer
    product against the recombined weights, then the shared epilogue.
    ``variant`` does not change the integers, so it is accepted and unused."""
    del variant
    _epi.validate_operands(epilogue, scale, shift, residual)
    w8 = _ref.combined_int8_weights(planes, fmt)
    acc = _ref.int_matmul(a_biased, w8)
    return _epi.finish(acc, gamma, colsum, act_zero=act_zero, spec=epilogue,
                       scale=scale, shift=shift, residual=residual,
                       out_dtype=_epi.resolve_out_dtype(epilogue, out_dtype))
