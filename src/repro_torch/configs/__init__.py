"""Architecture configs (port of ``repro.configs``): the ResNets and the
ten LM-family archs -- dense decoders (granite-8b/34b, yi-34b,
nemotron-4-340b), the VLM backbone (chameleon-34b), MoE (olmoe-1b-7b,
deepseek-v2-lite-16b, whose attention is MLA), the SSM (mamba2-1.3b), the
RG-LRU hybrid with local attention (recurrentgemma-9b) and the
encoder-decoder (whisper-base).

``get(name)`` returns a ``ModelAPI``; ``reduced=True`` gives the same
family at smoke-test scale.
"""
from __future__ import annotations

import importlib
from typing import Optional

from repro_torch.core.precision import PrecisionPolicy
from repro_torch.models.api import ModelAPI

RESNET_NAMES = ["resnet18", "resnet50", "resnet152"]
LM_NAMES = ["granite-34b", "granite-8b", "nemotron-4-340b", "yi-34b",
            "mamba2-1.3b", "chameleon-34b", "olmoe-1b-7b",
            "deepseek-v2-lite-16b", "whisper-base", "recurrentgemma-9b"]
ARCH_NAMES = RESNET_NAMES + LM_NAMES

_MODULES = {name: name.replace("-", "_").replace(".", "_")
            for name in RESNET_NAMES + LM_NAMES}


def get(name: str, *, policy: Optional[PrecisionPolicy] = None,
        reduced: bool = False) -> ModelAPI:
    """Build the ModelAPI for an architecture; unknown names raise KeyError."""
    if name not in _MODULES:
        raise KeyError(f"unknown arch {name!r}; known: {sorted(_MODULES)}")
    mod = importlib.import_module(f"repro_torch.configs.{_MODULES[name]}")
    return mod.build(policy=policy, reduced=reduced)
