"""Mixed-precision decode KV cache: digit-plane packed low-bit K/V.

Port of ``repro.nn.kvcache``.  Each cached K or V row is quantized per
(token, head) on a dynamic asymmetric affine grid,

    scale = (max - min) / (2^bits - 1)      zero = min
    code  = clip(round((x - zero) / scale), 0, 2^bits - 1)

with ``scale``/``zero`` rounded to bf16 (their stored form) before the
codes are computed.  Codes are unsigned, split into ``P = ceil(bits / k)``
k-bit digit planes and packed ``8 // k`` digits per byte along head_dim,
digit index minor inside a byte.  The packed leaf is
``{"p": uint8 (P, ..., packed_d), "s": bf16 (...), "z": bf16 (...)}``.

Numeric contract (``tests/test_torch_kvcache.py`` against the JAX
package): packed bytes, codes and the bf16 scale/zero are bitwise equal,
and so is ``dequantize_kv`` to the JAX function jitted and op by op.  The
product ``code * scale`` is exact in f32 (a code below 2^8 times a bf16
scale's 8 significant bits), so XLA's contracted multiply-add and a
multiply then an add round once alike; ``torch.addcmul`` states that one
rounding.  Inside the port ``unpack_kv(pack_kv(x)) == qdq_kv(x)`` bitwise.
"""
from __future__ import annotations

import dataclasses
from typing import Dict

import torch

from repro_torch.core.packing import _unpack_bits, pack_bits
from repro_torch.core.plan import VALID_KV_BITS

__all__ = [
    "VALID_KV_BITS",
    "KVFormat",
    "quantize_kv",
    "dequantize_kv",
    "qdq_kv",
    "split_codes",
    "combine_codes",
    "pack_kv",
    "unpack_codes",
    "unpack_kv",
    "kv_token_bytes",
]

# bf16 scale + bf16 zero per (token, head)
SCALE_ZERO_BYTES = 4


@dataclasses.dataclass(frozen=True)
class KVFormat:
    """Storage format of one cached K or V tensor: ``bits`` (2/4/8), the
    digit-plane slice ``k`` (divides 8, <= bits) and head_dim ``d``."""

    bits: int
    k: int
    d: int

    def __post_init__(self):
        if self.bits not in VALID_KV_BITS:
            raise ValueError(f"kv bits must be in {VALID_KV_BITS}, "
                             f"got {self.bits}")
        if self.k not in (1, 2, 4, 8):
            raise ValueError(f"kv slice k={self.k} must divide 8")
        if self.k > self.bits:
            raise ValueError(f"kv slice k={self.k} exceeds bits={self.bits}")

    @property
    def planes(self) -> int:
        return -(-self.bits // self.k)

    @property
    def digits_per_byte(self) -> int:
        return 8 // self.k

    @property
    def packed_d(self) -> int:
        return -(-self.d // self.digits_per_byte)

    @property
    def levels(self) -> int:
        return (1 << self.bits) - 1


def quantize_kv(x: torch.Tensor, fmt: KVFormat):
    """(..., D) values -> (codes int32 (..., D), scale bf16, zero bf16)."""
    xf = x.to(torch.float32)
    mx = xf.amax(dim=-1)
    mn = xf.amin(dim=-1)
    scale = ((mx - mn) / fmt.levels).to(torch.bfloat16)
    zero = mn.to(torch.bfloat16)
    # A constant row has scale 0 and every code dequantizes to `zero`,
    # which is the row value: guard only the division.
    sf = torch.clamp_min(scale.to(torch.float32), 1e-20)
    codes = torch.clamp(
        torch.round((xf - zero.to(torch.float32)[..., None]) / sf[..., None]),
        0, fmt.levels).to(torch.int32)
    return codes, scale, zero


def dequantize_kv(codes: torch.Tensor, scale: torch.Tensor,
                  zero: torch.Tensor) -> torch.Tensor:
    """codes (..., D) + per-row scale/zero -> bf16 values (..., D); one
    rounding for ``codes * scale + zero``, as XLA's contracted form."""
    out = torch.addcmul(zero.to(torch.float32)[..., None],
                        codes.to(torch.float32),
                        scale.to(torch.float32)[..., None])
    return out.to(torch.bfloat16)


def qdq_kv(x: torch.Tensor, fmt: KVFormat) -> torch.Tensor:
    """Quantize-then-dequantize: what a packed cache row means, in bf16."""
    return dequantize_kv(*quantize_kv(x, fmt))


def split_codes(codes: torch.Tensor, fmt: KVFormat) -> torch.Tensor:
    """Unsigned codes (..., D) -> k-bit digit planes (P, ..., D) int32."""
    mask = (1 << fmt.k) - 1
    return torch.stack([(codes >> (fmt.k * i)) & mask
                        for i in range(fmt.planes)], dim=0)


def combine_codes(planes: torch.Tensor, fmt: KVFormat) -> torch.Tensor:
    """Inverse of :func:`split_codes` (exact integer recombination)."""
    w = (2 ** (fmt.k * torch.arange(fmt.planes, dtype=torch.int32,
                                    device=planes.device)))
    w = w.reshape((fmt.planes,) + (1,) * (planes.ndim - 1))
    return torch.sum(planes.to(torch.int32) * w, dim=0, dtype=torch.int32)


def pack_kv(x: torch.Tensor, fmt: KVFormat) -> Dict[str, torch.Tensor]:
    """(..., D) values -> the packed cache leaf dict (plane-major)."""
    codes, scale, zero = quantize_kv(x, fmt)
    digits = split_codes(codes, fmt)
    return {"p": pack_bits(digits, fmt.k, axis=-1), "s": scale, "z": zero}


def unpack_codes(packed: torch.Tensor, fmt: KVFormat) -> torch.Tensor:
    """uint8 planes (P, ..., packed_d) -> unsigned codes (..., D) int32."""
    digits = _unpack_bits(packed, fmt.k, fmt.d, axis=-1)
    return combine_codes(digits, fmt)


def unpack_kv(packed: Dict[str, torch.Tensor], fmt: KVFormat) -> torch.Tensor:
    """Packed leaf dict -> bf16 values; bitwise equal to ``qdq_kv``."""
    return dequantize_kv(unpack_codes(packed["p"], fmt), packed["s"],
                         packed["z"])


def kv_token_bytes(fmt: KVFormat, heads: int) -> int:
    """Cache bytes of ONE token of one packed K or V tensor."""
    return heads * (fmt.planes * fmt.packed_d + SCALE_ZERO_BYTES)
