"""Fused epilogue of the mixed-precision matmul (port of
``repro.kernels.mpmm.epilogue``).

The int32 accumulator leaves the GEMM straight into the post-processing
pipeline -- zero-point correction, dequant, BN, residual, ReLU, cast --
without a round trip through device memory.  ``finish`` here is the plain
PyTorch version; both CUDA kernels (``csrc/mpmm_common.cuh``) inline the
same ops in the same order.

Runtime operands: ``scale``/``shift`` f32 (1, N) (folded BN or a bias),
``residual`` (..., N) float, added after BN and before ReLU.

Numeric contract (held by the tests against the JAX package, and by
``chip_smoke.py`` between each kernel and its plain version):

* Packed bytes, int8 codes, colsum, gamma and int32 accumulators are
  bitwise equal.
* The f32 epilogue is bitwise equal.  Jitted XLA contracts
  ``y * scale + shift`` into one fused multiply-add, so this module uses
  ``torch.addcmul`` (one rounding, like ``fmaf``) and the CUDA kernels use
  ``__fmaf_rn``.  ``acc * gamma`` and ``+ residual`` are single roundings
  everywhere (``__fmul_rn``/``__fadd_rn`` in CUDA, so nvcc cannot fuse
  them).
* Per layer, a bf16 output is bitwise equal when the int8 inputs are.
* End to end, logits are held by a stated tolerance plus the rate of
  flipped classifier-input codes: the mean-pool's f32 sum order differs
  between frameworks, so a code can flip at a rounding boundary.
* ``pack_for_serve`` from float params: planes, colsum and gamma bitwise;
  folded-BN scale/shift to rtol 1e-6 (``rsqrt`` differs).
"""
from __future__ import annotations

import dataclasses
from typing import Any, Optional

import torch

__all__ = ["EpilogueSpec", "apply", "finish", "validate_operands",
           "resolve_out_dtype"]


@dataclasses.dataclass(frozen=True)
class EpilogueSpec:
    """Static description of the fused epilogue.

    Attributes:
      bn:        apply ``y * scale + shift`` (folded BN or bias).
      relu:      clamp at zero (after the residual add).
      residual:  add the shortcut tensor before the ReLU.
      out_dtype: optional output dtype override (None keeps the caller's).
    """

    bn: bool = False
    relu: bool = False
    residual: bool = False
    out_dtype: Optional[Any] = None


def resolve_out_dtype(spec: Optional[EpilogueSpec], default):
    """The one place the ``EpilogueSpec.out_dtype`` override is decided."""
    if spec is not None and spec.out_dtype is not None:
        return spec.out_dtype
    return default


def apply(y: torch.Tensor, spec: Optional[EpilogueSpec],
          scale: Optional[torch.Tensor] = None,
          shift: Optional[torch.Tensor] = None,
          residual: Optional[torch.Tensor] = None) -> torch.Tensor:
    """Post-dequant epilogue in f32 on the dequantized ``y`` (..., N)."""
    if spec is None:
        return y
    if spec.bn:
        # One rounding, as XLA's contracted y*scale+shift (see module doc).
        y = torch.addcmul(shift.to(torch.float32), y, scale.to(torch.float32))
    if spec.residual:
        y = y + residual.to(torch.float32)
    if spec.relu:
        y = torch.clamp_min(y, 0.0)
    return y


def finish(acc: torch.Tensor, gamma: torch.Tensor, colsum: torch.Tensor, *,
           act_zero: int, spec: Optional[EpilogueSpec],
           scale: Optional[torch.Tensor] = None,
           shift: Optional[torch.Tensor] = None,
           residual: Optional[torch.Tensor] = None,
           out_dtype) -> torch.Tensor:
    """int32 accumulator -> epilogued output: zero-point correction ->
    dequant -> BN/residual/ReLU -> cast.  ``gamma``/``colsum`` broadcast
    against ``acc``."""
    corrected = acc + act_zero * colsum.to(torch.int32)
    y = corrected.to(torch.float32) * gamma.to(torch.float32)
    y = apply(y, spec, scale, shift, residual)
    return y.to(resolve_out_dtype(spec, out_dtype))


def validate_operands(spec: Optional[EpilogueSpec],
                      scale: Optional[torch.Tensor],
                      shift: Optional[torch.Tensor],
                      residual: Optional[torch.Tensor]) -> None:
    if spec is None:
        if scale is not None or shift is not None or residual is not None:
            raise ValueError("epilogue operands given without an EpilogueSpec")
        return
    if spec.bn and (scale is None or shift is None):
        raise ValueError("EpilogueSpec.bn=True needs scale and shift")
    if not spec.bn and (scale is not None or shift is not None):
        raise ValueError("scale/shift given but EpilogueSpec.bn=False")
    if spec.residual != (residual is not None):
        raise ValueError("EpilogueSpec.residual mismatch with residual arg")
