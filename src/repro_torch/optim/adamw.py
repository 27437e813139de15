"""AdamW over trees of tensors (port of ``repro.optim.adamw``): decoupled
weight decay on every leaf (the LSQ step sizes ``gw``/``ga`` included) and
a global-norm clip.

The LSQ gradient scale 1/sqrt(N * Q_p) is already applied inside
``core.quant.fake_quant``.  ``state_dtype=torch.bfloat16`` stores both
moments in bf16 (nemotron-4-340b's ``opt_dtype``); the arithmetic is f32
whatever the storage.
"""
from __future__ import annotations

from typing import Any, Dict, Tuple

import torch

from repro_torch.tree import leaves, tree_map, unflatten

__all__ = ["adamw_init", "adamw_update", "global_norm"]

# the reference's defaults, which every caller of it uses
B1, B2, EPS, WEIGHT_DECAY, MAX_NORM = 0.9, 0.95, 1e-8, 0.1, 1.0
_CHUNK = 1 << 24  # values of a leaf updated at a time


def adamw_init(params, state_dtype=torch.float32) -> Dict[str, Any]:
    """Zero moments in ``state_dtype`` beside every leaf, a 0-d int32
    step count on the parameters' device."""
    def zeros(t):
        return tree_map(lambda x: torch.zeros(x.shape, dtype=state_dtype,
                                              device=x.device), t)
    dev = leaves(params)[0].device
    return {"m": zeros(params), "v": zeros(params),
            "count": torch.zeros((), dtype=torch.int32, device=dev)}


def global_norm(grads) -> torch.Tensor:
    """sqrt of the sum over leaves of each leaf's sum of squares (f32),
    leaves added in order from zero, as the reference's Python ``sum``."""
    total = 0
    for g in leaves(grads):
        total = total + torch.sum(torch.square(g.to(torch.float32)))
    return torch.sqrt(total)


@torch.no_grad()
def adamw_update(grads, state, params, *, lr, donate: bool = False,
                 norm=None) -> Tuple[Any, Dict[str, Any]]:
    """-> (new params, new state): gradients clipped to global norm
    ``MAX_NORM``, bias-corrected moments (``B1``, ``B2``, ``EPS``),
    decoupled weight decay ``WEIGHT_DECAY``.  New tensors are returned
    and the inputs are not written, unless ``donate``: then each leaf's new
    parameter and moments are written into ``params``' and ``state``'s own
    tensors as soon as they are computed, and those tensors are returned
    (the same bits; a step then holds one train state, not two, as the
    reference's Trainer gets by donating its state to the jitted step).
    ``norm``: the gradients' global norm when ``grads`` are only a
    rank's blocks of them (FSDP), so the clip is the whole gradients'."""
    norm = global_norm(grads) if norm is None else norm
    scale = torch.clamp(MAX_NORM / (norm + 1e-12), max=1.0)
    count = state["count"] + 1
    c1 = 1.0 - B1 ** count.to(torch.float32)
    c2 = 1.0 - B2 ** count.to(torch.float32)

    def upd(g, m, v, p):
        g = g.to(torch.float32) * scale
        mf = B1 * m.to(torch.float32) + (1 - B1) * g
        vf = B2 * v.to(torch.float32) + (1 - B2) * g * g
        step = (mf / c1) / (torch.sqrt(vf / c2) + EPS)
        pf = p.to(torch.float32)
        new_p = pf - lr * (step + WEIGHT_DECAY * pf)
        return new_p.to(p.dtype), mf.to(m.dtype), vf.to(v.dtype)

    out = []
    for g, m, v, p in zip(leaves(grads), leaves(state["m"]),
                          leaves(state["v"]), leaves(params)):
        new = (p, m, v) if donate else tuple(
            torch.empty_like(t) for t in (p, m, v))
        flat = [t.view(-1) for t in (g, m, v, p)]
        dst = [t.view(-1) for t in new]
        # elementwise, so a slice at a time gives the same bits; it bounds
        # the f32 temporaries by _CHUNK (an embedding or head leaf of 1e9
        # values would hold several 4 GB ones at once)
        for i in range(0, flat[0].numel(), _CHUNK):
            for d, value in zip(dst, upd(*(t[i:i + _CHUNK] for t in flat))):
                d[i:i + _CHUNK] = value
        out.append(new)
    return (unflatten(params, [o[0] for o in out]),
            {"m": unflatten(params, [o[1] for o in out]),
             "v": unflatten(params, [o[2] for o in out]), "count": count})
