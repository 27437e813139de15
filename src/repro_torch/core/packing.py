"""Bit-plane decomposition and packed storage of quantized weights.

Port of ``repro.core.packing``.  A w_Q-bit signed weight is split into
``P = ceil(w_Q / k)`` two's-complement digit planes of ``k`` bits each
(lower planes unsigned, the top plane signed), and the planes are packed
``8 // k`` digits per byte along the contraction axis, field index minor
within a byte.  The packed bytes are byte-identical to the JAX package's.
"""
from __future__ import annotations

import dataclasses
import math
from typing import Tuple

import numpy as np
import torch

__all__ = [
    "PlaneFormat",
    "num_planes",
    "split_planes",
    "combine_planes",
    "pack_bits",
    "pack_planes",
    "unpack_planes",
    "plane_shift_weights",
    "packed_weight_bytes",
    "random_codes",
]


def num_planes(w_bits: int, k: int) -> int:
    return int(math.ceil(w_bits / k))


@dataclasses.dataclass(frozen=True)
class PlaneFormat:
    """Storage format of one weight tensor in packed bit-plane form.

    Attributes:
      w_bits: quantized word-length w_Q of the weights (1/2/4/8).
      k:      operand slice in bits (1/2/4/8).
      k_dim:  length of the contraction axis (pre-packing).
      signed: whether the top plane carries the two's-complement sign.
    """

    w_bits: int
    k: int
    k_dim: int
    signed: bool = True

    @property
    def planes(self) -> int:
        return num_planes(self.w_bits, self.k)

    @property
    def digits_per_byte(self) -> int:
        if 8 % self.k != 0:
            raise ValueError(f"operand slice k={self.k} must divide 8")
        return 8 // self.k

    @property
    def packed_k(self) -> int:
        return int(math.ceil(self.k_dim / self.digits_per_byte))

    @property
    def top_bits(self) -> int:
        """Bits of the top (signed) plane's field."""
        return self.w_bits - self.k * (self.planes - 1)


def split_planes(w_int: torch.Tensor, w_bits: int, k: int) -> torch.Tensor:
    """Signed integer codes (..., K, N) -> int32 digit planes (P, ..., K, N).

    Lower planes hold unsigned digits in [0, 2^k); the top plane is
    sign-extended over its ``w_bits - k*(P-1)`` bits.
    """
    p = num_planes(w_bits, k)
    u = w_int.to(torch.int32) & ((1 << w_bits) - 1)
    planes = []
    for i in range(p):
        digit = (u >> (k * i)) & ((1 << k) - 1)
        if i == p - 1:
            top_bits = w_bits - k * (p - 1)
            sign_bit = 1 << (top_bits - 1)
            digit = torch.where(digit >= sign_bit, digit - (1 << top_bits),
                                digit)
        planes.append(digit)
    return torch.stack(planes, dim=0)


def combine_planes(planes: torch.Tensor, k: int) -> torch.Tensor:
    """Inverse of :func:`split_planes`: sum_p plane_p * 2^{k p} (int32)."""
    p = planes.shape[0]
    weights = (2 ** (k * torch.arange(p, dtype=torch.int32,
                                      device=planes.device)))
    weights = weights.reshape((p,) + (1,) * (planes.ndim - 1))
    return torch.sum(planes.to(torch.int32) * weights, dim=0,
                     dtype=torch.int32)


def pack_bits(digits: torch.Tensor, k: int, axis: int = -2) -> torch.Tensor:
    """Pack k-bit unsigned digits along ``axis``, 8//k per byte (uint8).

    ``digits`` must be non-negative and < 2^k.  Pads the packed axis with
    zero digits when its length is not a multiple of 8//k.
    """
    f = 8 // k
    axis = axis % digits.ndim
    n = digits.shape[axis]
    pad = (-n) % f
    if pad:
        shape = list(digits.shape)
        shape[axis] = pad
        digits = torch.cat([digits, digits.new_zeros(shape)], dim=axis)
    new_shape = list(digits.shape)
    new_shape[axis] = digits.shape[axis] // f
    new_shape.insert(axis + 1, f)
    d = digits.reshape(new_shape).to(torch.int32)
    shifts = (k * torch.arange(f, dtype=torch.int32, device=digits.device))
    shifts = shifts.reshape((1,) * (axis + 1) + (f,)
                            + (1,) * (digits.ndim - axis - 1))
    packed = torch.sum(d << shifts, dim=axis + 1, dtype=torch.int32)
    return packed.to(torch.uint8)


def _unpack_bits(packed: torch.Tensor, k: int, k_dim: int,
                 axis: int = -2) -> torch.Tensor:
    """Unpack uint8 bytes into k-bit unsigned digits (int32) along ``axis``."""
    f = 8 // k
    axis = axis % packed.ndim
    p32 = packed.to(torch.int32)
    parts = [(p32 >> (k * i)) & ((1 << k) - 1) for i in range(f)]
    stacked = torch.stack(parts, dim=axis + 1)
    new_shape = list(packed.shape)
    new_shape[axis] = packed.shape[axis] * f
    out = stacked.reshape(new_shape)
    return out.narrow(axis, 0, k_dim)


def pack_planes(w_int: torch.Tensor, fmt: PlaneFormat,
                axis: int = -2) -> torch.Tensor:
    """Signed codes (..., K, N) -> packed uint8 planes (P, ..., ceil(K/f), N).

    The top plane's digits are stored as their raw two's-complement field
    and re-signed on unpack.
    """
    planes = split_planes(w_int, fmt.w_bits, fmt.k)
    top = planes[-1] & ((1 << fmt.top_bits) - 1)
    planes = torch.cat([planes[:-1], top[None]], dim=0)
    return pack_bits(planes, fmt.k, axis=axis % w_int.ndim + 1)


def unpack_planes(packed: torch.Tensor, fmt: PlaneFormat,
                  axis: int = -2) -> torch.Tensor:
    """Packed uint8 planes -> int8 digit planes (P, ..., K, N).

    Lower planes in [0, 2^k), top plane sign-extended.
    """
    digits = _unpack_bits(packed, fmt.k, fmt.k_dim,
                          axis=axis % (packed.ndim - 1) + 1)
    if fmt.signed:
        sign_bit = 1 << (fmt.top_bits - 1)
        top = digits[-1]
        top = torch.where(top >= sign_bit, top - (1 << fmt.top_bits), top)
        digits = torch.cat([digits[:-1], top[None]], dim=0)
    return digits.to(torch.int8)


def plane_shift_weights(fmt: PlaneFormat,
                        dtype=torch.int32) -> torch.Tensor:
    """2^{k p} combination weights for the Sum-Together adder tree."""
    return (2 ** (fmt.k * torch.arange(fmt.planes))).to(dtype)


def packed_weight_bytes(k_dim: int, n_dim: int, w_bits: int, k: int) -> int:
    """HBM bytes of one packed weight tensor (excluding the gamma scale)."""
    fmt = PlaneFormat(w_bits=w_bits, k=k, k_dim=k_dim)
    return fmt.planes * fmt.packed_k * n_dim


def random_codes(rng: np.random.Generator, shape: Tuple[int, ...],
                 w_bits: int) -> np.ndarray:
    """Uniform signed codes for tests/benchmarks."""
    lo, hi = -(2 ** (w_bits - 1)), 2 ** (w_bits - 1) - 1
    return rng.integers(lo, hi + 1, size=shape, dtype=np.int32)
