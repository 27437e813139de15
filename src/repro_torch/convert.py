"""Carry weights across from the JAX package, as numpy arrays.

``from_jax_serve_tree`` turns the output of
``repro.models.resnet.pack_for_serve`` (converted leaf by leaf to numpy)
into the port's packed serve tree on a device; ``from_jax_train_params``
does the same for the float QAT parameters and BN state, so that the
port's own ``pack_for_serve`` can be checked against the JAX one.  Both
keep the tree's structure (dicts, and the (scale, shift) tuples of folded
BN) and every value bit for bit.  This module imports no JAX: the caller
hands over numpy.
"""
from __future__ import annotations

from typing import Tuple

import numpy as np
import torch

from repro_torch.device import resolve_device

__all__ = ["from_numpy", "from_jax_serve_tree", "from_jax_train_params"]


def from_numpy(arr, device) -> torch.Tensor:
    """One numpy array -> tensor on ``device``, bit for bit (bfloat16
    arrays, which numpy knows only through ml_dtypes, go through f32)."""
    arr = np.asarray(arr)
    if arr.dtype.name == "bfloat16":
        return torch.from_numpy(arr.astype(np.float32)).to(
            device=device, dtype=torch.bfloat16)
    return torch.from_numpy(np.ascontiguousarray(arr)).to(device)


def _convert(tree, device):
    if isinstance(tree, dict):
        return {k: _convert(v, device) for k, v in tree.items()}
    if isinstance(tree, (tuple, list)):
        return type(tree)(_convert(v, device) for v in tree)
    return from_numpy(tree, device)


def from_jax_serve_tree(tree, device="cuda"):
    """Packed serve tree (numpy leaves) -> the port's tree on ``device``."""
    return _convert(tree, resolve_device(device))


def from_jax_train_params(params, state, device="cuda") -> Tuple[dict, dict]:
    """QAT params and BN state (numpy leaves) -> tensors on ``device``."""
    dev = resolve_device(device)
    return _convert(params, dev), _convert(state, dev)
