"""Serve step functions (port of ``repro.launch.steps``, serve half).

Each closes over a ``ModelAPI`` and the kernel route ``impl`` and takes the
packed parameters explicitly, as the JAX package's step functions do for
``jax.jit``.  Nothing is compiled here: PyTorch runs them eagerly.  The
training step, the abstract state specs and the sharding/input helpers
(``input_specs``, ``input_axes``, ``batch_rules_for``) belong to the
multi-device and training items of ROADMAP Queue 1 and are not ported yet.
"""
from __future__ import annotations

from typing import Callable

__all__ = ["make_prefill_fn", "make_decode_fn", "make_verify_fn"]


def make_prefill_fn(api, *, impl: str = "auto") -> Callable:
    """prefill_fn(params, batch {"tokens": (B, S)[, "frames": (B, T, D)]})
    -> (logits (B, V), prefill cache); the frames go to archs that take
    them (``api.needs_frames``, whisper; zeros when absent)."""
    def prefill_fn(params, batch):
        kw = {"frames": batch.get("frames")} if api.needs_frames else {}
        return api.prefill(params, batch["tokens"], impl=impl, **kw)
    return prefill_fn


def make_decode_fn(api, *, impl: str = "auto") -> Callable:
    """decode_fn(params, cache, tokens (B, 1), length) -> (logits (B, V),
    cache); the cache is updated in place."""
    def decode_fn(params, cache, tokens, length):
        return api.decode_step(params, cache, tokens, length, impl=impl)
    return decode_fn


def make_verify_fn(api, *, impl: str = "auto",
                   attn_impl: str = "xla") -> Callable:
    """verify_fn(params, cache, tokens (B, T), length) -> (logits (B, T,
    V), cache): the batched multi-token step speculative decoding verifies
    drafted tokens with (``runtime/specdec.py``)."""
    def verify_fn(params, cache, tokens, length):
        return api.decode_steps(params, cache, tokens, length, impl=impl,
                                attn_impl=attn_impl)
    return verify_fn
