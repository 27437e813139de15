"""Public mixed-precision-matmul API: weight prep and impl dispatch
(port of ``repro.kernels.mpmm.ops``).

Implementations, all bit-exact to ``ref.mpmm_ref`` / ``ref.conv_ref``:

  * ``cuda``:  the hand-written kernels -- K1 (``kernel.mpmm_cuda``) for the
               matmul and K2 (``conv_kernel.conv_mpmm_cuda``) for the
               implicit-GEMM conv.  CUDA tensors only; anything the kernel
               does not take raises.
  * ``torch``: the plain versions ``mpmm_torch`` / ``conv_mpmm_torch``,
               twins of the JAX package's ``xla`` implementations, on any
               device.
  * ``auto``:  ``cuda`` for CUDA tensors, ``torch`` for CPU tensors.

Each kernel picks its own tile: K1's tensor-core route runs the fixed
``kernel.TILE``, K2 the N tile ``conv_kernel.n_tile(N)`` (64 or 128) of
its ``conv_plan``.  The DSE autotuner waits for a Hopper cost model, so a
``tile``/``bn`` other than the one the kernel runs raises instead of
being ignored.
"""
from __future__ import annotations

import dataclasses
from typing import Optional, Tuple

import torch

from repro_torch.core import packing, quant
from repro_torch.core.packing import PlaneFormat
from repro_torch.kernels.mpmm import conv_kernel as _conv_kernel
from repro_torch.kernels.mpmm import epilogue as _epi
from repro_torch.kernels.mpmm import kernel as _kernel
from repro_torch.kernels.mpmm.epilogue import EpilogueSpec
from repro_torch.kernels.mpmm.ref import combined_int8_weights

__all__ = [
    "TileShape",
    "EpilogueSpec",
    "MpmmParams",
    "quantize_activations",
    "prepare_weights",
    "combined_int8_weights",
    "mpmm",
    "mpmm_acc",
    "mpmm_packed",
    "conv_mpmm",
    "conv_implicit_feasible",
]

IMPLS = ("auto", "cuda", "torch")


@dataclasses.dataclass(frozen=True)
class TileShape:
    """K1's tile (bm, bk, bn); the kernel takes only ``kernel.TILE``."""

    bm: int = _kernel.TILE[0]
    bk: int = _kernel.TILE[1]
    bn: int = _kernel.TILE[2]

    def as_tuple(self) -> Tuple[int, int, int]:
        return (self.bm, self.bk, self.bn)


@dataclasses.dataclass
class MpmmParams:
    """Deployed (packed) weights of one linear layer.

    planes: uint8 (P, ceil(K/(8//k)), N); colsum: int32 (1, N) column sums
    of the integer codes; gamma: f32 (1, N) = gamma_a * gamma_w.
    """

    planes: torch.Tensor
    colsum: torch.Tensor
    gamma: torch.Tensor
    fmt: PlaneFormat
    act_zero: int = 128


def quantize_activations(x: torch.Tensor, gamma_a: torch.Tensor,
                         a_bits: int = 8, signed: bool = False) -> torch.Tensor:
    """float -> int8 activation codes.

    Unsigned (default): codes u in [0, 2^a) stored biased (u - 2^{a-1}),
    paired with ``act_zero = 2^{a-1}``.  ``signed=True``: symmetric signed
    codes with ``act_zero = 0``.  The divide runs in f32 whatever ``x``'s
    dtype (JAX promotes bf16 / f32 to f32; torch would keep bf16), and the
    rounding is half to even, as ``jnp.round``.
    """
    half = 2 ** (a_bits - 1)
    g = torch.as_tensor(gamma_a, dtype=torch.float32, device=x.device)
    v = torch.round(x.to(torch.float32) / g)
    if signed:
        return torch.clamp(v, -half, half - 1).to(torch.int8)
    u = torch.clamp(v, 0, 2 * half - 1)
    return (u - half).to(torch.int8)


def prepare_weights(w: torch.Tensor, gamma_w: torch.Tensor, *, w_bits: int,
                    k: int, gamma_a: torch.Tensor, a_bits: int = 8,
                    channel_wise: bool = False) -> MpmmParams:
    """Pack trained FP weights (K, N) for deployment.

    gamma_w: scalar (per-tensor) or [N] (per-channel); gamma_a: scalar.
    """
    kdim, n = w.shape
    spec = quant.weight_spec(w_bits, channel_axis=-1 if channel_wise else None)
    w_int = quant.quantize_int(w, gamma_w, spec)
    fmt = PlaneFormat(w_bits=w_bits, k=k, k_dim=kdim)
    planes = packing.pack_planes(w_int, fmt, axis=-2)
    colsum = torch.sum(w_int, dim=0, dtype=torch.int32).reshape(1, n)
    gw = torch.as_tensor(gamma_w, dtype=torch.float32, device=w.device)
    ga = torch.as_tensor(gamma_a, dtype=torch.float32, device=w.device)
    gamma = (torch.broadcast_to(gw, (n,)) * ga).reshape(1, n)
    return MpmmParams(planes=planes, colsum=colsum, gamma=gamma, fmt=fmt,
                      act_zero=2 ** (a_bits - 1))


def _resolve_impl(impl: str, x: torch.Tensor) -> str:
    if impl not in IMPLS:
        raise ValueError(f"impl must be one of {IMPLS}, got {impl!r}")
    if impl == "auto":
        return "cuda" if x.is_cuda else "torch"
    return impl


def mpmm(a_biased: torch.Tensor, planes: torch.Tensor, gamma: torch.Tensor,
         colsum: torch.Tensor, scale: Optional[torch.Tensor] = None,
         shift: Optional[torch.Tensor] = None,
         residual: Optional[torch.Tensor] = None, *, fmt: PlaneFormat,
         act_zero: int = 128, tile: Optional[TileShape] = None,
         variant: str = "st", impl: str = "auto", out_dtype=torch.float32,
         epilogue: Optional[EpilogueSpec] = None) -> torch.Tensor:
    """y[..., N] = epilogue(gamma * ((a_biased + act_zero) @ W_int)).

    a_biased int8 (..., K); planes uint8 (P, Kp, N); gamma/colsum (1, N);
    scale/shift f32 (1, N) when ``epilogue.bn``; residual (..., N) with the
    leading shape of ``a_biased`` when ``epilogue.residual``.

    An expert bank (planes (E, P, Kp, N), gamma/colsum (E, 1, N)) takes
    a_biased (E, ..., K), expert e's rows against expert e's weights, and
    is ONE kernel call over all E experts (the reference's ``jax.vmap`` of
    its kernel over the expert axis) -> (E, ..., N).
    """
    _epi.validate_operands(epilogue, scale, shift, residual)
    if tile is not None and tile.as_tuple() != _kernel.TILE:
        raise ValueError(f"the mpmm kernel runs the fixed tile "
                         f"{_kernel.TILE}, got {tile.as_tuple()}")
    kdim = a_biased.shape[-1]
    n = planes.shape[-1]
    group = (planes.shape[0],) if planes.ndim == 4 else ()
    if group and a_biased.shape[0] != group[0]:
        raise ValueError(f"a bank of {group[0]} experts needs a_biased "
                         f"(E, ..., K), got {tuple(a_biased.shape)}")
    lead = a_biased.shape[:-1]
    a2 = a_biased.reshape(*group, -1, kdim).contiguous()
    res2 = (residual.reshape(*group, -1, n).contiguous()
            if residual is not None else None)
    fn = (_kernel.mpmm_cuda if _resolve_impl(impl, a_biased) == "cuda"
          else _kernel.mpmm_torch)
    out = fn(a2, planes, gamma, colsum, fmt=fmt, act_zero=act_zero,
             variant=variant, out_dtype=out_dtype, epilogue=epilogue,
             scale=scale, shift=shift, residual=res2)
    return out.reshape(*lead, n)


def mpmm_acc(a_biased: torch.Tensor, planes: torch.Tensor, *,
             fmt: PlaneFormat, variant: str = "st",
             impl: str = "auto") -> torch.Tensor:
    """The int32 accumulator ``a_biased @ W_int`` (..., N) alone: K1's
    accumulator-only mode on CUDA (``kernel.mpmm_cuda`` with an int32
    output), ``kernel.mpmm_torch_acc`` on the CPU.  A tensor-parallel row
    shard's partial product: the ranks' partials summed, then
    ``epilogue.finish`` with the whole gamma and colsum, is bitwise
    ``mpmm`` of the whole contraction.  An expert bank as in ``mpmm``."""
    kdim = a_biased.shape[-1]
    n = planes.shape[-1]
    group = (planes.shape[0],) if planes.ndim == 4 else ()
    if group and a_biased.shape[0] != group[0]:
        raise ValueError(f"a bank of {group[0]} experts needs a_biased "
                         f"(E, ..., K), got {tuple(a_biased.shape)}")
    lead = a_biased.shape[:-1]
    a2 = a_biased.reshape(*group, -1, kdim).contiguous()
    if _resolve_impl(impl, a_biased) == "cuda":
        out = _kernel.mpmm_cuda(a2, planes, None, None, fmt=fmt, act_zero=0,
                                variant=variant, out_dtype=_kernel.ACC_DTYPE)
    else:
        out = _kernel.mpmm_torch_acc(a2, planes, fmt=fmt)
    return out.reshape(*lead, n)


def conv_implicit_feasible(c_in: int, fmt: PlaneFormat) -> bool:
    """Whether the implicit-GEMM conv kernel can run this layer: each
    kernel position's C-slice must start at a byte of the packed K axis."""
    return c_in % fmt.digits_per_byte == 0


def conv_mpmm(a_biased: torch.Tensor, planes: torch.Tensor,
              gamma: torch.Tensor, colsum: torch.Tensor,
              scale: Optional[torch.Tensor] = None,
              shift: Optional[torch.Tensor] = None,
              residual: Optional[torch.Tensor] = None, *, fmt: PlaneFormat,
              act_zero: int = 128, kh: int, kw: int, stride: int = 1,
              padding: str = "SAME", bn: Optional[int] = None,
              variant: str = "st", impl: str = "auto",
              out_dtype=torch.float32,
              epilogue: Optional[EpilogueSpec] = None) -> torch.Tensor:
    """Implicit-GEMM convolution over packed planes -> (B, Ho, Wo, N).

    a_biased int8 (B, H, W, C) unpadded; planes uint8 (P, kh*kw*C/f, N);
    residual (B, Ho, Wo, N).  ``cuda`` launches K2, which pads in the
    kernel; ``torch`` runs the plain direct conv.
    """
    _epi.validate_operands(epilogue, scale, shift, residual)
    n = planes.shape[-1]
    if bn is not None and bn != _conv_kernel.n_tile(n):
        raise ValueError(f"the conv kernel runs the fixed N tile "
                         f"{_conv_kernel.n_tile(n)} at N={n}, got bn={bn}")
    if _resolve_impl(impl, a_biased) == "torch":
        return _conv_kernel.conv_mpmm_torch(
            a_biased, planes, gamma, colsum, fmt=fmt, act_zero=act_zero,
            kh=kh, kw=kw, stride=stride, padding=padding, variant=variant,
            out_dtype=out_dtype, epilogue=epilogue, scale=scale, shift=shift,
            residual=residual)
    return _conv_kernel.conv_mpmm_cuda(
        a_biased.contiguous(), planes, gamma, colsum, fmt=fmt,
        act_zero=act_zero, kh=kh, kw=kw, stride=stride, padding=padding,
        variant=variant, out_dtype=out_dtype, epilogue=epilogue, scale=scale,
        shift=shift,
        residual=residual.contiguous() if residual is not None else None)


def mpmm_packed(x: torch.Tensor, params: MpmmParams, gamma_a: torch.Tensor,
                *, a_bits: int = 8, tile: Optional[TileShape] = None,
                variant: str = "st", impl: str = "auto",
                out_dtype=torch.float32,
                epilogue: Optional[EpilogueSpec] = None,
                scale: Optional[torch.Tensor] = None,
                shift: Optional[torch.Tensor] = None,
                residual: Optional[torch.Tensor] = None) -> torch.Tensor:
    """Float in, float out: quantize activations, then ``mpmm``."""
    a = quantize_activations(x, gamma_a, a_bits)
    return mpmm(a, params.planes, params.gamma, params.colsum, scale, shift,
                residual, fmt=params.fmt, act_zero=params.act_zero, tile=tile,
                variant=variant, impl=impl, out_dtype=out_dtype,
                epilogue=epilogue)
