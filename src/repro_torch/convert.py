"""Carry weights across from the JAX package, as numpy arrays.

``from_jax_serve_tree`` turns the output of
``repro.models.resnet.pack_for_serve`` (converted leaf by leaf to numpy)
into the port's packed serve tree on a device; ``from_jax_train_params``
does the same for the float QAT parameters and BN state, so that the
port's own ``pack_for_serve`` can be checked against the JAX one.  Both
keep the tree's structure (dicts, and the (scale, shift) tuples of folded
BN) and every value bit for bit.

``from_jax_train_state`` carries a whole train state (parameters, AdamW
moments and counts) the same way.

``from_jax_lm_serve_tree`` and ``from_jax_lm_train_params`` do the same
for LM trees (``repro.runtime.serve.pack_for_serving`` output, and
``init_params`` trees), whose layer stack the JAX package keeps scanned:
one subtree with a leading depth axis, or under a depth-heterogeneous plan
one such subtree per format group ``g0``, ``g1``, ... in depth order, and
a dense prefix (deepseek's first layer) unrolled beside it as
``dense_layer_{i}``.  The port keeps one per-layer list, so the prefix
comes first and the stack is unstacked layer by layer after it; an expert
bank keeps its expert axis once the depth axis is sliced off.  The other
families' trees unstack the same way: mamba2's ``layers.{ln, ssm}``;
recurrentgemma's superblocks ``supers.{r1, r2, att}`` (lead ``n_super``)
interleave into model order, r1, r2, att of each superblock, and its
remainder ``rem_{i}`` follows; whisper's ``enc_layers`` and ``dec_layers``
become two lists.

This module imports no JAX: the caller hands over numpy.
"""
from __future__ import annotations

from typing import Tuple

import numpy as np
import torch

from repro_torch.device import resolve_device

__all__ = ["from_numpy", "from_jax_serve_tree", "from_jax_train_params",
           "from_jax_lm_serve_tree", "from_jax_lm_train_params",
           "from_jax_train_state"]


def from_numpy(arr, device) -> torch.Tensor:
    """One numpy array -> tensor on ``device``, bit for bit (bfloat16
    arrays, which numpy knows only through ml_dtypes, go through f32)."""
    arr = np.asarray(arr)
    if arr.dtype.name == "bfloat16":
        return torch.from_numpy(arr.astype(np.float32)).to(
            device=device, dtype=torch.bfloat16)
    # np.array keeps a 0-d array 0-d (np.ascontiguousarray makes it 1-d)
    return torch.from_numpy(np.array(arr, order="C")).to(device)


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


def _slice_lead(tree, i: int):
    if isinstance(tree, dict):
        return {k: _slice_lead(v, i) for k, v in tree.items()}
    return np.asarray(tree)[i]


def _lead_len(tree) -> int:
    if isinstance(tree, dict):
        for v in tree.values():
            n = _lead_len(v)
            if n:
                return n
        return 0
    arr = np.asarray(tree)
    return arr.shape[0] if arr.ndim else 0


def _unstack_layers(layers):
    """A scanned stack (or its ``g{j}`` groups) -> per-layer subtrees."""
    if isinstance(layers, dict) and "g0" in layers:
        groups = [layers[f"g{j}"] for j in range(len(layers))]
    else:
        groups = [layers]
    return [_slice_lead(g, i) for g in groups for i in range(_lead_len(g))]


def _convert_lm(tree, device):
    dev = resolve_device(device)
    if "supers" in tree:  # recurrentgemma: (R, R, A) superblocks + rest
        sup = tree["supers"]
        n = _lead_len(sup["r1"])
        layers = [_slice_lead(sup[k], j) for j in range(n)
                  for k in ("r1", "r2", "att")]
        rem = sorted((k for k in tree if k.startswith("rem_")),
                     key=lambda k: int(k.rsplit("_", 1)[1]))
        layers += [tree[k] for k in rem]
        out = {k: _convert(v, dev) for k, v in tree.items()
               if k != "supers" and k not in rem}
        out["layers"] = [_convert(lp, dev) for lp in layers]
        return out
    if "enc_layers" in tree:  # whisper: two stacks
        return {k: ([_convert(lp, dev) for lp in _unstack_layers(v)]
                    if k in ("enc_layers", "dec_layers") else _convert(v, dev))
                for k, v in tree.items()}
    prefix = sorted((k for k in tree if k.startswith("dense_layer_")),
                    key=lambda k: int(k.rsplit("_", 1)[1]))
    out = {k: _convert(v, dev) for k, v in tree.items()
           if k != "layers" and k not in prefix}
    out["layers"] = [_convert(tree[k], dev) for k in prefix] + [
        _convert(lp, dev) for lp in _unstack_layers(tree["layers"])]
    return out


def from_jax_lm_serve_tree(tree, device="cuda"):
    """Packed LM serve tree (numpy leaves) -> the port's tree on
    ``device``, the layer stack as a per-layer list."""
    return _convert_lm(tree, device)


def from_jax_lm_train_params(params, device="cuda"):
    """LM QAT parameters (numpy leaves) -> tensors on ``device``, the layer
    stack as a per-layer list."""
    return _convert_lm(params, device)


# the top-level keys of an LM's layer stack: the decoders' and mamba2's,
# recurrentgemma's superblocks, whisper's encoder
_LM_STACKS = ("layers", "supers", "enc_layers")


def from_jax_train_state(state, device="cuda"):
    """A train state ``{"params", "opt": {"m", "v", "count"}, "step"}``
    (numpy leaves, as ``repro.launch.steps.init_train_state`` makes it and
    its train step returns it) -> the port's on ``device``: an LM's layer
    stack (any of ``_LM_STACKS``, in the parameters and in both moments)
    as a per-layer list, a CNN's tree as it is."""
    dev = resolve_device(device)
    lm = any(k in state["params"] for k in _LM_STACKS)
    conv = ((lambda t: _convert_lm(t, dev)) if lm
            else (lambda t: _convert(t, dev)))
    opt = state["opt"]
    return {"params": conv(state["params"]),
            "opt": {"m": conv(opt["m"]), "v": conv(opt["v"]),
                    "count": from_numpy(opt["count"], dev)},
            "step": from_numpy(state["step"], dev)}
