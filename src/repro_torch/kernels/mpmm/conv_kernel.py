"""K2: the implicit-GEMM convolution kernel and its plain PyTorch version.

``conv_mpmm_cuda`` wraps the hand-written CUDA kernel ``csrc/conv_mpmm.cu``,
which replaces the Pallas TPU kernel
``repro.kernels.mpmm.conv_kernel.conv_mpmm_pallas``: an NHWC convolution as
implicit GEMM over the same packed digit planes the im2col path reads
(K = kh*kw*C in (kh, kw, C) order), with the input pre-padded with
``-act_zero`` and K1's fused epilogue.  The patch matrix never exists in
device memory.  C must be a multiple of 8//k (``ops.conv_implicit_feasible``).

``conv_mpmm_torch`` is the plain version (the twin of the JAX package's
``ops._xla_conv_impl``): a direct float64 convolution of the padded codes
against the recombined int8 weights, exact for these integer sums and
rounded back to int32, then ``epilogue.finish``.

``conv_mpmm_cuda.launches`` counts the kernel's launches.
"""
from __future__ import annotations

import ctypes
import functools
from typing import Optional, Tuple

import torch
import torch.nn.functional as F

from repro_torch.core.packing import PlaneFormat
from repro_torch.kernels import _build
from repro_torch.kernels.mpmm import epilogue as _epi
from repro_torch.kernels.mpmm import ref as _ref
from repro_torch.kernels.mpmm.epilogue import EpilogueSpec
from repro_torch.kernels.mpmm.kernel import (check_common, check_operand,
                                             epilogue_flags, ptr,
                                             raise_on_error)

__all__ = ["TILE", "conv_mpmm_cuda", "conv_mpmm_torch"]

# The kernel's fixed (bm, bk, bn) tile (csrc/mpmm_common.cuh BM, BK, BN).
TILE = (64, 32, 64)


@functools.cache
def _launcher():
    fn = _build.load("conv_mpmm").conv_mpmm_launch
    fn.argtypes = [ctypes.c_void_p] * 8 + [ctypes.c_int] * 17 + [ctypes.c_void_p]
    fn.restype = ctypes.c_int
    return fn


def conv_mpmm_cuda(x_padded: torch.Tensor, planes: torch.Tensor,
                   gamma: torch.Tensor, colsum: torch.Tensor, *,
                   fmt: PlaneFormat, act_zero: int, kh: int, kw: int,
                   stride: int, out_hw: Tuple[int, int], variant: str = "st",
                   out_dtype=torch.float32,
                   epilogue: Optional[EpilogueSpec] = None,
                   scale: Optional[torch.Tensor] = None,
                   shift: Optional[torch.Tensor] = None,
                   residual: Optional[torch.Tensor] = None) -> torch.Tensor:
    """Launch K2 on CUDA tensors -> (B, Ho, Wo, N) of ``out_dtype``.

    x_padded int8 (B, Hp, Wp, C), already carrying the conv's spatial
    padding filled with ``-act_zero``; ``out_hw`` = (Ho, Wo) of the original
    padding and stride; planes uint8 (P, kh*kw*C/f, N); residual
    (B, Ho, Wo, N) f32 or bf16 when ``epilogue.residual``.
    """
    _epi.validate_operands(epilogue, scale, shift, residual)
    out_dtype = _epi.resolve_out_dtype(epilogue, out_dtype)
    device = x_padded.device
    check_common(device, planes, fmt, gamma, colsum, scale, shift, variant,
                 out_dtype)
    check_operand("x_padded", x_padded, device, (torch.int8,))
    b, hp, wp, c = x_padded.shape
    ho, wo = out_hw
    n = planes.shape[-1]
    if c % fmt.digits_per_byte != 0:
        raise ValueError(
            f"implicit-GEMM conv needs C divisible by the packed "
            f"digits-per-byte: C={c}, 8//k={fmt.digits_per_byte}; route "
            f"this layer to the im2col dataflow")
    if fmt.k_dim != kh * kw * c:
        raise ValueError(f"format K={fmt.k_dim} != kh*kw*C={kh * kw * c}")
    if stride < 1 or (ho - 1) * stride + kh > hp or (wo - 1) * stride + kw > wp:
        raise ValueError(f"output {out_hw} at stride {stride} does not fit "
                         f"the padded input {(hp, wp)} with a {kh}x{kw} kernel")
    if residual is not None:
        check_operand("residual", residual, device,
                      (torch.float32, torch.bfloat16), (b, ho, wo, n))
    out = torch.empty((b, ho, wo, n), dtype=out_dtype, device=device)
    if out.numel() == 0:
        return out
    with torch.cuda.device(device):
        stream = torch.cuda.current_stream(device).cuda_stream
        err = _launcher()(
            ptr(x_padded), ptr(planes), ptr(gamma), ptr(colsum), ptr(scale),
            ptr(shift), ptr(residual), ptr(out), b, hp, wp, c, ho, wo, n, kh,
            kw, stride, fmt.packed_k, fmt.planes, fmt.k, fmt.w_bits, act_zero,
            int(variant == "sa"),
            epilogue_flags(epilogue, residual, out_dtype), stream)
    raise_on_error("conv_mpmm_cuda", err)
    conv_mpmm_cuda.launches += 1
    return out


conv_mpmm_cuda.launches = 0


def conv_mpmm_torch(a_biased: torch.Tensor, planes: torch.Tensor,
                    gamma: torch.Tensor, colsum: torch.Tensor, *,
                    fmt: PlaneFormat, act_zero: int, kh: int, kw: int,
                    stride: int = 1, padding: str = "SAME",
                    variant: str = "st", out_dtype=torch.float32,
                    epilogue: Optional[EpilogueSpec] = None,
                    scale: Optional[torch.Tensor] = None,
                    shift: Optional[torch.Tensor] = None,
                    residual: Optional[torch.Tensor] = None) -> torch.Tensor:
    """Plain version of K2 (twin of ``ops._xla_conv_impl``) on the unpadded
    biased codes (B, H, W, C) -> (B, Ho, Wo, N).

    The float64 convolution is exact for these integer sums whatever
    algorithm the backend picks (rounding to the nearest integer removes
    any transform error), so the accumulator matches K2's bitwise.
    """
    del variant
    _epi.validate_operands(epilogue, scale, shift, residual)
    c = a_biased.shape[-1]
    n = planes.shape[-1]
    w8 = _ref.combined_int8_weights(planes, fmt)              # (K, N)
    w_oihw = w8.reshape(kh, kw, c, n).permute(3, 2, 0, 1).to(torch.float64)
    xp = _ref.pad_spatial(a_biased, kh, kw, stride, padding, fill=-act_zero)
    acc = F.conv2d(xp.permute(0, 3, 1, 2).to(torch.float64), w_oihw,
                   stride=stride)
    acc = torch.round(acc).to(torch.int32).permute(0, 2, 3, 1).contiguous()
    return _epi.finish(acc, gamma, colsum, act_zero=act_zero, spec=epilogue,
                       scale=scale, shift=shift, residual=residual,
                       out_dtype=_epi.resolve_out_dtype(epilogue, out_dtype))
