"""Assigned input shapes (port of ``repro.configs.shapes``; one set, shared
by all the LM-family archs).

  train_4k     seq 4096   x global_batch 256   -> train_step
  prefill_32k  seq 32768  x global_batch 32    -> prefill (serve)
  decode_32k   cache 32768 x global_batch 128  -> serve_step (1 new token)
  long_500k    cache 524288 x global_batch 1   -> serve_step; SSM/hybrid only
"""
from __future__ import annotations

import dataclasses
from typing import Dict, Tuple

__all__ = ["ShapeSpec", "SHAPES", "applicable"]


@dataclasses.dataclass(frozen=True)
class ShapeSpec:
    name: str
    seq_len: int
    global_batch: int
    kind: str  # 'train' | 'prefill' | 'decode'


SHAPES: Dict[str, ShapeSpec] = {
    "train_4k": ShapeSpec("train_4k", 4_096, 256, "train"),
    "prefill_32k": ShapeSpec("prefill_32k", 32_768, 32, "prefill"),
    "decode_32k": ShapeSpec("decode_32k", 32_768, 128, "decode"),
    "long_500k": ShapeSpec("long_500k", 524_288, 1, "decode"),
}


def applicable(api, shape: ShapeSpec) -> Tuple[bool, str]:
    """(runs?, reason): long_500k needs sub-quadratic attention."""
    if shape.name == "long_500k" and not api.long_context_ok:
        return False, ("skipped: pure full-attention architecture — a 524k "
                       "KV cache/quadratic prefill has no sub-quadratic path")
    return True, ""
