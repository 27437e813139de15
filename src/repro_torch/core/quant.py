"""LSQ quantization, serve half (port of ``repro.core.quant``).

    v_int = round( clamp(v_FP / gamma, Q_n, Q_p) )
    v_quant = v_int * gamma

Activations are unsigned (Q_n = 0, Q_p = 2^b - 1); weights are signed
(Q_n = -2^{b-1}, Q_p = 2^{b-1} - 1).  ``init_step_size`` (LSQ's initial
step, which also sets the embedding table's serve step) is here; the
STE/LSQ training half is not ported yet.

Dtype note: JAX promotes ``bf16 / f32`` to f32, torch keeps bf16 when the
f32 operand is 0-d.  Every divide here therefore casts both operands to
f32 first, so the integer codes match the JAX package's.
"""
from __future__ import annotations

import dataclasses
from typing import Optional, Tuple

import torch

__all__ = ["QuantSpec", "qrange", "act_spec", "weight_spec",
           "init_step_size", "quantize_int", "dequantize"]


@dataclasses.dataclass(frozen=True)
class QuantSpec:
    """How one tensor is quantized.

    Attributes:
      bits:         word-length b.
      signed:       signed two's-complement range (weights) vs unsigned.
      channel_axis: axis for per-channel step sizes (None = per-tensor).
    """

    bits: int
    signed: bool
    channel_axis: Optional[int] = None

    def __post_init__(self):
        if self.bits < 1 or self.bits > 32:
            raise ValueError(f"unsupported word-length: {self.bits}")


def qrange(spec: QuantSpec) -> Tuple[int, int]:
    """(Q_n, Q_p) clamp bounds."""
    if spec.signed:
        return -(2 ** (spec.bits - 1)), 2 ** (spec.bits - 1) - 1
    return 0, 2 ** spec.bits - 1


def act_spec(bits: int = 8) -> QuantSpec:
    """Activations are unsigned, fixed 8 bit in the paper."""
    return QuantSpec(bits=bits, signed=False, channel_axis=None)


def weight_spec(bits: int, channel_axis: Optional[int] = None) -> QuantSpec:
    """Weights are signed; per-channel axis optional."""
    return QuantSpec(bits=bits, signed=True, channel_axis=channel_axis)


# Values of a per-tensor mean taken at a time in float64 (above it the sum
# runs slice by slice, each slice's partial sum in float64).
MEAN_SLICE_VALUES = 1 << 28


def init_step_size(v: torch.Tensor, spec: QuantSpec) -> torch.Tensor:
    """LSQ initialization: gamma = 2 * mean(|v|) / sqrt(Q_p), at least 1e-9.

    A 0-d f32 tensor (per-tensor) or a vector over ``channel_axis``.  The
    mean is taken in float64 and rounded once to f32; XLA's f32 tree sum
    can land one ulp away on large tensors.
    """
    _, qp = qrange(spec)
    qp = max(qp, 1)
    if spec.channel_axis is not None:
        axes = tuple(d for d in range(v.ndim)
                     if d != spec.channel_axis % v.ndim)
        mean_abs = v.to(torch.float64).abs().mean(dim=axes)
    elif v.numel() <= MEAN_SLICE_VALUES:
        mean_abs = v.to(torch.float64).abs().mean()
    else:  # a large table (a 256000 x 18432 embedding), slice by slice
        flat = v.reshape(-1)
        mean_abs = sum(
            flat[i:i + MEAN_SLICE_VALUES].to(torch.float64).abs().sum()
            for i in range(0, flat.numel(), MEAN_SLICE_VALUES)) / flat.numel()
    mean_abs = mean_abs.to(torch.float32)
    gamma = 2.0 * mean_abs / torch.sqrt(torch.tensor(float(qp),
                                                     device=v.device))
    return torch.clamp_min(gamma, 1e-9)


def _broadcast_gamma(gamma: torch.Tensor, v: torch.Tensor,
                     spec: QuantSpec) -> torch.Tensor:
    if spec.channel_axis is None:
        return gamma
    shape = [1] * v.ndim
    shape[spec.channel_axis % v.ndim] = v.shape[spec.channel_axis % v.ndim]
    return gamma.reshape(shape)


def quantize_int(v: torch.Tensor, gamma: torch.Tensor,
                 spec: QuantSpec) -> torch.Tensor:
    """Integer codes ``v_int`` in [Q_n, Q_p] (int32); round half to even."""
    qn, qp = qrange(spec)
    g = _broadcast_gamma(torch.as_tensor(gamma, dtype=torch.float32,
                                         device=v.device), v, spec)
    return torch.clamp(torch.round(v.to(torch.float32) / g), qn,
                       qp).to(torch.int32)


def dequantize(v_int: torch.Tensor, gamma: torch.Tensor,
               spec: QuantSpec) -> torch.Tensor:
    """v_quant = v_int * gamma (f32)."""
    vf = v_int.to(torch.float32)
    g = _broadcast_gamma(torch.as_tensor(gamma, dtype=torch.float32,
                                         device=vf.device), vf, spec)
    return vf * g
