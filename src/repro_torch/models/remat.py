"""Layer rematerialization for the QAT forwards (the reference's
``jax.checkpoint``): a block runs under ``torch.utils.checkpoint``, which
keeps its inputs and recomputes the rest in the backward.  Recomputing
runs the same operations on the same values, so it changes no value and
no gradient."""
from __future__ import annotations

import functools

import torch
import torch.utils.checkpoint

__all__ = ["remat"]


def _mm_saveable(ctx, op, *args, **kwargs):
    """The 'dots' remat policy: keep the output of every 2-D matrix product
    (the projections, which have no batch axis), recompute the rest.  An
    expert bank's product is a batched one (``aten.bmm``, batched over the
    experts), and so are attention's: the reference computes the bank
    under ``jax.vmap``, a ``dot_general`` with a batch dimension, which
    ``dots_with_no_batch_dims_saveable`` does not save, so neither does
    this policy -- both recompute it."""
    from torch.utils.checkpoint import CheckpointPolicy
    return (CheckpointPolicy.MUST_SAVE if op is torch.ops.aten.mm.default
            else CheckpointPolicy.PREFER_RECOMPUTE)


def remat(cfg, fn, *args):
    """``fn(*args)``, under ``torch.utils.checkpoint`` when ``cfg.remat``
    and a gradient is being recorded; ``cfg.remat_policy`` ('full', the
    default where a config has none, or 'dots') says what is kept."""
    if not cfg.remat or not torch.is_grad_enabled():
        return fn(*args)
    kw = {}
    policy = getattr(cfg, "remat_policy", "full")
    if policy == "dots":
        from torch.utils.checkpoint import create_selective_checkpoint_contexts
        kw["context_fn"] = functools.partial(
            create_selective_checkpoint_contexts, _mm_saveable)
    elif policy != "full":
        raise ValueError(f"remat_policy must be 'full' or 'dots', got "
                         f"{policy!r}")
    return torch.utils.checkpoint.checkpoint(fn, *args, use_reentrant=False,
                                             **kw)
