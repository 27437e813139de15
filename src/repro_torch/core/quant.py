"""LSQ quantization (port of ``repro.core.quant``).

    v_int = round( clamp(v_FP / gamma, Q_n, Q_p) )
    v_quant = v_int * gamma

Activations are unsigned (Q_n = 0, Q_p = 2^b - 1); weights are signed
(Q_n = -2^{b-1}, Q_p = 2^{b-1} - 1).  ``init_step_size`` is LSQ's initial
step (it also sets the embedding table's serve step); ``quantize_int`` and
``dequantize`` are the serve half.

The training half is ``fake_quant``: Eq. 5 quant-dequant with LSQ
gradients, differentiable in ``v`` (straight through the round, exact
through the clamp) and in ``gamma`` (scaled by 1/sqrt(N * Q_p) through
``grad_scale``).  Its gradients match ``jax.grad`` of the reference: the
clamp is ``minimum(maximum(v, Q_n), Q_p)``, whose gradient splits 0.5/0.5
at a value equal to a bound as ``jnp.clip`` does (``torch.clamp`` would
pass 1 -- and after a ReLU many activations sit exactly at Q_n = 0).

Dtype note: JAX promotes ``bf16 / f32`` to f32, torch keeps bf16 when the
f32 operand is 0-d.  Every divide here therefore casts both operands to
f32 first, so the integer codes match the JAX package's.
"""
from __future__ import annotations

import dataclasses
import math
from typing import Optional, Tuple

import torch

__all__ = ["QuantSpec", "qrange", "act_spec", "weight_spec",
           "init_step_size", "grad_scale", "round_ste", "fake_quant",
           "quantize_int", "dequantize"]


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


def grad_scale(x: torch.Tensor, scale: torch.Tensor) -> torch.Tensor:
    """Forward ``x`` (as ``x * s + (x * (1 - s))`` rounds it, which is not
    always bitwise ``x``), backward the gradient times ``scale``."""
    return x * scale + (x * (1.0 - scale)).detach()


class _RoundSTE(torch.autograd.Function):
    """Round half to even; the gradient passes straight through."""

    @staticmethod
    def forward(ctx, x):
        return torch.round(x)

    @staticmethod
    def backward(ctx, g):
        return g


def round_ste(x: torch.Tensor) -> torch.Tensor:
    """Round-to-nearest-even with a straight-through (identity) gradient."""
    return _RoundSTE.apply(x)


def fake_quant(v: torch.Tensor, gamma: torch.Tensor, spec: QuantSpec, *,
               lead: int = 0, whole=None, spread=None) -> torch.Tensor:
    """Eq. 5 quant-dequant with LSQ gradients (the QAT forward), in v's
    dtype: an activation in bf16 divides, clips, rounds and multiplies in
    bf16 (8-bit codes are exact there), a weight in f32.

    Gamma's gradient is scaled by 1/sqrt(N * Q_p), N the values sharing
    one step; the scale is an f32 square root, as the reference takes it.

    ``lead`` leading axes of ``v`` index independent tensors, each with its
    own step: an expert bank, whose weight (E, K, N) and activations (E,
    M, K) take gamma (E,) -- or (E, N) channel-wise -- as the reference's
    ``jax.vmap`` over the experts gives, N counted per expert.

    ``whole``: the shape of the tensor whose values share the steps when
    ``v`` is one rank's shard of it (a tensor-parallel layer's columns or
    rows): N is counted over the whole, as on one device -- a shard's own
    count would make the step's gradient sqrt(M) times too large.

    ``spread``: a function (step, shape) -> the step broadcast to
    ``shape``, called once for each of the step's two uses (the division
    and the product), whose backward gives the use's whole gradient in
    the step's dtype (a row shard's activation step: summed over the
    ranks before it is rounded, ``nn.quantized``)."""
    qn, qp = qrange(spec)
    shape = tuple(v.shape) if whole is None else tuple(whole)
    n = math.prod(shape) // max(math.prod(shape[:lead]), 1)
    if spec.channel_axis is not None:
        n //= shape[spec.channel_axis % len(shape)]
    gs = 1.0 / torch.sqrt(torch.tensor(float(max(n, 1)) * float(max(qp, 1)),
                                       dtype=torch.float32, device=v.device))
    gamma = grad_scale(gamma, gs)
    g = _broadcast_gamma(gamma, v, spec, lead).to(v.dtype)
    g_div, g_mul = ((g, g) if spread is None
                    else (spread(g, v.shape), spread(g, v.shape)))
    vs = v / g_div
    bound = lambda b: torch.tensor(b, dtype=vs.dtype,  # noqa: E731
                                   device=vs.device)
    vc = torch.minimum(torch.maximum(vs, bound(qn)), bound(qp))
    return round_ste(vc) * g_mul


def _broadcast_gamma(gamma: torch.Tensor, v: torch.Tensor, spec: QuantSpec,
                     lead: int = 0) -> torch.Tensor:
    if spec.channel_axis is None and not lead:
        return gamma
    shape = list(v.shape[:lead]) + [1] * (v.ndim - lead)
    if spec.channel_axis is not None:
        ax = spec.channel_axis % v.ndim
        shape[ax] = v.shape[ax]
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
