"""Device placement shared by the port's entry points.

Entry points run on CUDA unless the caller asks for the CPU; asking for
CUDA where there is none raises instead of falling back.
"""
from __future__ import annotations

import torch

__all__ = ["resolve_device", "tree_to"]


def resolve_device(device="cuda") -> torch.device:
    """``device`` as a ``torch.device``; raises if it is CUDA and no card
    is available."""
    dev = torch.device(device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(f"device {device!r} requested but torch sees no "
                           f"CUDA device; pass device='cpu' to run the plain "
                           f"versions on the CPU")
    return dev


def tree_to(tree, device: torch.device):
    """Move every tensor of a tree of dicts, tuples and lists to ``device``."""
    if isinstance(tree, torch.Tensor):
        return tree.to(device)
    if isinstance(tree, dict):
        return {k: tree_to(v, device) for k, v in tree.items()}
    if isinstance(tree, (tuple, list)):
        return type(tree)(tree_to(v, device) for v in tree)
    return tree
