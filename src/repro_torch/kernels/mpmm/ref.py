"""Plain PyTorch oracle for the mixed-precision matmul (port of
``repro.kernels.mpmm.ref``).

The contract shared by every implementation:

    u_int[M,K] : unsigned activation codes stored as int8 biased by
                 ``act_zero`` (s = u - act_zero); act_zero = 2^{a-1} for
                 unsigned activations, 0 for signed ones.
    W_int[K,N] : signed weight codes stored as packed k-bit digit planes.
    y[M,N]     = gamma * (u_int @ W_int)
               = gamma * ((s @ W) + act_zero * colsum(W))

Integer products run in float64, which is exact for every sum these
shapes produce (|sum| < 2^53), on the CPU and on the card alike: torch's
int8 matmul on the CPU returns int8 and wraps, and the card has no
integer matmul outside the kernels.
"""
from __future__ import annotations

from typing import Optional, Sequence, Tuple

import torch
import torch.nn.functional as F

from repro_torch.core import packing
from repro_torch.core.packing import PlaneFormat
from repro_torch.kernels.mpmm import epilogue as _epilogue
from repro_torch.kernels.mpmm.epilogue import EpilogueSpec

__all__ = ["unpack_to_int", "combined_int8_weights",
           "int_matmul", "mpmm_ref_codes", "mpmm_ref", "same_pads",
           "pad_spatial", "gather_patches", "conv_patches_codes", "conv_ref"]


def unpack_to_int(packed: torch.Tensor, fmt: PlaneFormat) -> torch.Tensor:
    """Packed planes (P, K_packed, N) -> signed int32 weight codes (K, N)."""
    planes = packing.unpack_planes(packed, fmt, axis=-2)
    return packing.combine_planes(planes, fmt.k)


def combined_int8_weights(planes_u8: torch.Tensor,
                          fmt: PlaneFormat) -> torch.Tensor:
    """Packed digit planes (..., P, Kp, N) uint8 -> W_int (..., K, N) int8
    (leading axes: the experts of a bank).

    The planes are disjoint k-bit fields of the w_Q-bit two's-complement
    code (where k > w, one plane whose fields hold the code in their low
    w bits), so recombination is an OR of shifted fields, a mask to w bits
    and one sign extension from bit w - 1.  Port of
    ``repro.kernels.mpmm.ops.combined_int8_weights``, and bit-exact to it
    except at k = 8 with w < 8: there the reference returns the packed
    byte unextended (its one-plane, one-digit-a-byte shortcut), so its
    ``impl="xla"`` product is wrong, and this decode agrees with the codes
    and with ``repro``'s ``ref.mpmm_ref`` instead.
    """
    f = fmt.digits_per_byte
    k = fmt.k
    p32 = planes_u8.to(torch.int32)
    parts = [(p32 >> (k * i)) & ((1 << k) - 1) for i in range(f)]
    lead = planes_u8.shape[:-3]
    kp, n = planes_u8.shape[-2], planes_u8.shape[-1]
    # (..., P, Kp, f, N) -> (..., P, Kp*f, N): field index minor in a byte.
    dig = torch.stack(parts, dim=-2).reshape(*lead, fmt.planes, kp * f, n)
    del parts
    w = dig[..., 0, :, :]
    for p in range(1, fmt.planes):
        w = w | (dig[..., p, :, :] << (k * p))
    w = w[..., : fmt.k_dim, :] & 0xFF
    bits = fmt.w_bits if fmt.signed else 8
    w = w & ((1 << bits) - 1)
    w = torch.where(w >= (1 << (bits - 1)), w - (1 << bits), w)
    return w.to(torch.int8)


def int_matmul(a: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
    """Exact integer product (..., M, K) @ (..., K, N) -> int32, through
    float64."""
    return torch.matmul(a.to(torch.float64), w.to(torch.float64)).to(
        torch.int32)


def mpmm_ref_codes(a_biased: torch.Tensor, packed: torch.Tensor,
                   fmt: PlaneFormat, *, act_zero: int) -> torch.Tensor:
    """Integer accumulator int32[M, N] = u_int @ W_int."""
    u = a_biased.to(torch.int32) + act_zero
    return int_matmul(u, unpack_to_int(packed, fmt))


def mpmm_ref(a_biased: torch.Tensor, packed: torch.Tensor, fmt: PlaneFormat,
             gamma: torch.Tensor, *, act_zero: int,
             out_dtype=torch.float32,
             epilogue: Optional[EpilogueSpec] = None,
             scale: Optional[torch.Tensor] = None,
             shift: Optional[torch.Tensor] = None,
             residual: Optional[torch.Tensor] = None) -> torch.Tensor:
    """Dequantized output: epilogue(gamma * (u_int @ W_int))."""
    acc = mpmm_ref_codes(a_biased, packed, fmt, act_zero=act_zero)
    y = acc.to(torch.float32) * torch.as_tensor(gamma, dtype=torch.float32,
                                                device=acc.device)
    y = _epilogue.apply(y, epilogue, scale, shift, residual)
    return y.to(_epilogue.resolve_out_dtype(epilogue, out_dtype))


def same_pads(size: int, window: int, stride: int,
              padding: str) -> Tuple[int, int]:
    """(low, high) pads of one spatial dim, as ``lax.padtype_to_pads``:
    SAME puts the odd pixel on the high side (7x7/2 on 224 pads (2, 3))."""
    if padding == "VALID":
        return (0, 0)
    if padding != "SAME":
        raise ValueError(f"padding must be 'SAME' or 'VALID', got {padding!r}")
    out = -(-size // stride)
    total = max((out - 1) * stride + window - size, 0)
    return (total // 2, total - total // 2)


def pad_spatial(a: torch.Tensor, kh: int, kw: int, stride: int, padding: str,
                *, fill) -> torch.Tensor:
    """Apply a conv's spatial padding to (B, H, W, C), filled with ``fill``
    (for biased codes: ``-act_zero``, the code of a float zero)."""
    _, h, w, _ = a.shape
    ph = same_pads(h, kh, stride, padding)
    pw = same_pads(w, kw, stride, padding)
    if ph == (0, 0) and pw == (0, 0):
        return a
    return F.pad(a, (0, 0, pw[0], pw[1], ph[0], ph[1]), value=fill)


def conv_patches_codes(a_biased: torch.Tensor, kh: int, kw: int, stride: int,
                       padding: str, *, fill: int) -> torch.Tensor:
    """Codes (B, H, W, C) -> patches (B, Ho, Wo, kh*kw*C), features in
    (kh, kw, C) order to match the HWIO weight flattening."""
    ap = pad_spatial(a_biased, kh, kw, stride, padding, fill=fill)
    return gather_patches(ap, kh, kw, stride)


def gather_patches(ap: torch.Tensor, kh: int, kw: int,
                   stride: int) -> torch.Tensor:
    """Pre-padded (B, Hp, Wp, C) -> VALID patches (B, Ho, Wo, kh*kw*C) in
    (kh, kw, C) feature order; a pure gather, for codes or floats."""
    hp, wp = ap.shape[1], ap.shape[2]
    ho = (hp - kh) // stride + 1
    wo = (wp - kw) // stride + 1
    cols: Sequence[torch.Tensor] = [
        ap[:, i:i + (ho - 1) * stride + 1:stride,
           j:j + (wo - 1) * stride + 1:stride, :]
        for i in range(kh) for j in range(kw)]
    return torch.cat(cols, dim=-1)


def conv_ref(a_biased: torch.Tensor, packed: torch.Tensor, fmt: PlaneFormat,
             gamma: torch.Tensor, *, act_zero: int, kh: int, kw: int,
             stride: int = 1, padding: str = "SAME",
             out_dtype=torch.float32,
             epilogue: Optional[EpilogueSpec] = None,
             scale: Optional[torch.Tensor] = None,
             shift: Optional[torch.Tensor] = None,
             residual: Optional[torch.Tensor] = None) -> torch.Tensor:
    """Conv oracle: explicit patch gather + ``mpmm_ref`` -> (B, Ho, Wo, N)."""
    patches = conv_patches_codes(a_biased, kh, kw, stride, padding,
                                 fill=-act_zero)
    b, ho, wo, kdim = patches.shape
    n = packed.shape[-1]
    res2 = residual.reshape(-1, n) if residual is not None else None
    y = mpmm_ref(patches.reshape(-1, kdim), packed, fmt, gamma,
                 act_zero=act_zero, out_dtype=out_dtype, epilogue=epilogue,
                 scale=scale, shift=shift, residual=res2)
    return y.reshape(b, ho, wo, n)
