"""Uniform model API (port of ``repro.models.api``), with what CNN serving
uses: specs, parameter init and the plan namespace."""
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
                    device="cpu"):
        return nnp.init_params(self.specs(mode), generator, device=device)

    def plan_layer_names(self):
        """Every layer name a ``PrecisionPlan`` may bind for this arch."""
        return self.mod.plan_layer_names(self.cfg)
