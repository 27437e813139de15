"""Precision policy: which word-length each layer gets (paper Section IV-C).

Port of ``repro.core.precision``: activations 8 bit unsigned, first and
last layer weights pinned to ``boundary_bits``, inner layers at
``inner_bits``, operand slice ``k``.
"""
from __future__ import annotations

import dataclasses
from typing import Dict, Mapping

__all__ = ["PrecisionPolicy", "footprint_report",
           "VALID_WBITS", "VALID_SLICES"]

VALID_WBITS = (1, 2, 4, 8)
VALID_SLICES = (1, 2, 4, 8)


@dataclasses.dataclass(frozen=True)
class PrecisionPolicy:
    """Hashable, static quantization policy for one deployment.

    Attributes:
      a_bits:        activation word-length (paper: fixed 8).
      inner_bits:    inner-layer weight word-length w_Q.
      boundary_bits: first/last-layer weight word-length (paper: 8).
      k:             operand slice of the digit planes.
      channel_wise:  per-output-channel step sizes gamma_w.
      variant:       'st' (adder tree) or 'sa' (per-plane accumulators).
      quantize:      False = fp baseline.
    """

    a_bits: int = 8
    inner_bits: int = 8
    boundary_bits: int = 8
    k: int = 4
    channel_wise: bool = False
    variant: str = "st"
    quantize: bool = True

    def __post_init__(self):
        if self.quantize:
            if self.inner_bits not in VALID_WBITS:
                raise ValueError(f"inner_bits must be in {VALID_WBITS}")
            if self.boundary_bits not in VALID_WBITS:
                raise ValueError(f"boundary_bits must be in {VALID_WBITS}")
            if self.k not in VALID_SLICES:
                raise ValueError(f"operand slice k must be in {VALID_SLICES}")
        if self.variant not in ("st", "sa"):
            raise ValueError("variant must be 'st' or 'sa'")

    def bits_for(self, layer_class: str) -> int:
        """w_Q of a layer: 'inner' vs 'boundary' (first/last)."""
        return self.inner_bits if layer_class == "inner" else self.boundary_bits


def footprint_report(param_counts: Mapping[str, int],
                     policy: PrecisionPolicy) -> Dict[str, float]:
    """Packed parameter bytes at the policy's word-lengths vs fp32."""
    n_inner = int(param_counts.get("inner", 0))
    n_bound = int(param_counts.get("boundary", 0))
    fp_bytes = 4 * (n_inner + n_bound)
    if not policy.quantize:
        q_bytes = fp_bytes
    else:
        q_bytes = (n_inner * policy.inner_bits / 8
                   + n_bound * policy.boundary_bits / 8)
    return {
        "fp32_bytes": float(fp_bytes),
        "quant_bytes": float(q_bytes),
        "compression": fp_bytes / max(q_bytes, 1.0),
        "inner_params": float(n_inner),
        "boundary_params": float(n_bound),
    }
