"""int8 gradient compression with error feedback (port of
``repro.optim.compress``).

Each leaf of g + residual is quantized to int8 codes with one scale (max
|v| / 127) and dequantized; the quantization error is carried to the next
step.  As in the reference, it is applied to the gradients the step hands
to AdamW: on a training mesh those are the sums over the batch axes
(``launch.steps.make_train_step``), each leaf whole, with the residual
kept whole on every rank; the all-reduce itself moves f32.
"""
from __future__ import annotations

from typing import Any, Tuple

import torch

from repro_torch.tree import leaves, tree_map, unflatten

__all__ = ["compress_init", "compress_decompress"]


def compress_init(params) -> Any:
    """Residual (error-feedback) state: one f32 zero buffer per leaf."""
    return tree_map(lambda p: torch.zeros(p.shape, dtype=torch.float32,
                                          device=p.device), params)


def _qdq(g: torch.Tensor, res: torch.Tensor
         ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Quantize g + residual to int8 codes -> (dequantized, new residual)."""
    v = g.to(torch.float32) + res
    scale = torch.clamp_min(torch.max(torch.abs(v)), 1e-12) / 127.0
    codes = torch.clamp(torch.round(v / scale), -127, 127)  # int8 on a wire
    deq = codes * scale
    return deq, v - deq


@torch.no_grad()
def compress_decompress(grads, state):
    """tree -> (dequantized tree, new residual state)."""
    out = [_qdq(g, r) for g, r in zip(leaves(grads), leaves(state))]
    return (unflatten(grads, [o[0] for o in out]),
            unflatten(grads, [o[1] for o in out]))
