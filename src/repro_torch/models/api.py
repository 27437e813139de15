"""Uniform model API (port of ``repro.models.api``): specs, parameter init,
the plan namespace and, for LM families, prefill / decode and the cache
layout."""
from __future__ import annotations

import dataclasses
from typing import Any

import torch

from repro_torch.core.precision import PrecisionPolicy
from repro_torch.nn import param as nnp

__all__ = ["ModelAPI"]


@dataclasses.dataclass
class ModelAPI:
    """Bundles a config with its family module's functions."""

    name: str
    family: str
    cfg: Any
    mod: Any                     # the family module
    policy: PrecisionPolicy

    def specs(self, mode: str = "train"):
        return self.mod.specs(self.cfg, mode, self.policy)

    def init_params(self, generator: torch.Generator, mode: str = "train",
                    device="cuda"):
        """Random parameters on ``device``: CUDA by default, and raises
        without a card unless ``device="cpu"``."""
        return nnp.init_params(self.specs(mode), generator, device=device)

    def plan_layer_names(self):
        """Every layer name a ``PrecisionPlan`` may bind for this arch."""
        return self.mod.plan_layer_names(self.cfg)

    # --- LM families ----------------------------------------------------------

    def prefill(self, params, tokens, *, impl: str = "auto", **kw):
        return self.mod.prefill(self.cfg, params, tokens, self.policy,
                                impl=impl, **kw)

    def decode_step(self, params, cache, tokens, length: int, *,
                    impl: str = "auto"):
        return self.mod.decode_step(self.cfg, params, cache, tokens, length,
                                    self.policy, impl=impl)

    def decode_steps(self, params, cache, tokens, length: int, *,
                     impl: str = "auto", attn_impl: str = "xla"):
        """T-token cache extension (the speculative verify): logits (B, T,
        V) equal to T ``decode_step`` calls."""
        fn = getattr(self.mod, "decode_steps", None)
        if fn is None:
            raise NotImplementedError(
                f"{self.family} has no multi-token decode_steps")
        return fn(self.cfg, params, cache, tokens, length, self.policy,
                  impl=impl, attn_impl=attn_impl)

    def cache_specs(self, batch: int, max_len: int):
        return self.mod.cache_specs(self.cfg, batch, max_len,
                                    policy=self.policy)

    def kv_layer_names(self):
        """Cached-tensor names a plan may bind ``kv_bits`` to; empty for
        models with no decode KV cache."""
        fn = getattr(self.mod, "kv_layer_names", None)
        return fn(self.cfg) if fn is not None else []

    def kv_cache_workload(self):
        """{cached tensor name: (kv_heads, head_dim)}; empty without a KV
        cache."""
        fn = getattr(self.mod, "kv_cache_workload", None)
        return fn(self.cfg) if fn is not None else {}
