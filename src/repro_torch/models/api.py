"""Uniform model API (port of ``repro.models.api``): specs, parameter init,
the plan namespace, the workload the cost model and the planner read
(GEMMs, FLOPs, parameter counts) and, for LM families, prefill / decode
and the cache layout."""
from __future__ import annotations

import dataclasses
from typing import Any, Dict

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

    # --- analysis (DSE, planner, roofline) -----------------------------------

    def gemm_workload(self, tokens: int):
        """The model's GEMMs at ``tokens`` rows (a CNN: images)."""
        return self.mod.gemm_workload(self.cfg, tokens)

    def model_flops(self, *, tokens: int, step: str) -> float:
        return self.mod.model_flops(self.cfg, tokens=tokens, step=step)

    def active_params(self) -> int:
        return self.mod.active_params(self.cfg)

    def total_params(self) -> int:
        return self.mod.total_params(self.cfg)

    def param_class_counts(self, mode: str = "train") -> Dict[str, int]:
        """{'inner': n, 'boundary': n} weight counts for Table III."""
        def classify(path: str) -> str:
            p = path.lower()
            if "embed" in p or "head" in p or "norm" in p or "'fc'" in p \
                    or "stem" in p or "bn" in p or "ln" in p:
                return "boundary"
            if path.endswith("['w']"):
                return "inner"
            return "other"
        counts = nnp.count_params(self.specs(mode), classify)
        return {"inner": counts.get("inner", 0),
                "boundary": counts.get("boundary", 0)}

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
