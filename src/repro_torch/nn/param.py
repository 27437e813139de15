"""Parameter specification trees (port of ``repro.nn.param``).

A model is a nested dict of :class:`ParamSpec`; ``init_params`` turns it
into a dict of tensors from an explicit ``torch.Generator``.  The numbers
differ from the JAX package's ``jax.random`` ones for the same seed; tests
that compare the two packages make their inputs with numpy instead.
Tensors are drawn on the generator's device (a CUDA generator draws on the
card) and land on ``device``, CUDA unless the caller asks for the CPU.
"""
from __future__ import annotations

import dataclasses
import math
from typing import Any, Callable, Dict, Optional, Tuple

import torch

from repro_torch.device import resolve_device

__all__ = ["ParamSpec", "init_params", "is_spec", "QMARK", "strip_markers",
           "count_params"]

# Marker key identifying a quantized-linear subtree in spec trees; it
# carries the layer class and name and never materializes into params.
QMARK = "__q__"


@dataclasses.dataclass(frozen=True)
class ParamSpec:
    """One parameter tensor.

    init: 'normal' (fan-in scaled), 'embed' (unit normal), 'zeros', 'ones',
    'constant'.
    fan_in_axes: dims counted as fan-in for the scaled-normal init.
    """

    shape: Tuple[int, ...]
    dtype: Any = torch.float32
    axes: Tuple[Optional[str], ...] = ()
    init: str = "normal"
    const: float = 0.0
    fan_in_axes: Tuple[int, ...] = (0,)

    def __post_init__(self):
        if self.axes and len(self.axes) != len(self.shape):
            raise ValueError(f"axes {self.axes} vs shape {self.shape}")


def is_spec(x) -> bool:
    return isinstance(x, ParamSpec)


def strip_markers(tree):
    if isinstance(tree, dict):
        return {k: strip_markers(v) for k, v in tree.items() if k != QMARK}
    if isinstance(tree, list):
        return [strip_markers(v) for v in tree]
    return tree


def count_params(specs, classify: Optional[Callable[[str], str]] = None
                 ) -> Dict[str, int]:
    """Parameter counts, bucketed by ``classify(path)`` (else 'total');
    ``path`` is written as ``jax.tree_util.keystr`` writes it
    (``['layers'][0]['q']['w']``), so a classifier of the JAX package's
    paths reads the port's."""
    counts: Dict[str, int] = {}

    def walk(node, path):
        if is_spec(node):
            key = classify(path) if classify else "total"
            counts[key] = counts.get(key, 0) + math.prod(node.shape)
        elif isinstance(node, dict):
            for k in node:
                walk(node[k], f"{path}[{k!r}]")
        elif isinstance(node, (list, tuple)):
            for i, v in enumerate(node):
                walk(v, f"{path}[{i}]")
    walk(specs, "")
    return counts


def _materialize(spec: ParamSpec, gen: torch.Generator) -> torch.Tensor:
    if spec.init == "zeros":
        return torch.zeros(spec.shape, dtype=spec.dtype)
    if spec.init == "ones":
        return torch.ones(spec.shape, dtype=spec.dtype)
    if spec.init == "constant":
        return torch.full(spec.shape, spec.const, dtype=spec.dtype)
    if spec.init not in ("normal", "embed"):
        raise ValueError(f"unknown init {spec.init!r}")
    x = torch.randn(spec.shape, generator=gen, dtype=torch.float32,
                    device=gen.device)
    if spec.init == "embed":
        return x.to(spec.dtype)
    fan_in = 1
    for a in spec.fan_in_axes:
        if spec.shape:
            fan_in *= spec.shape[a % len(spec.shape)]
    std = 1.0 / math.sqrt(max(fan_in, 1))
    return (std * x).to(spec.dtype)


def init_params(specs, generator: torch.Generator, device="cuda"):
    """Materialize a spec tree into a tensor tree on ``device`` (CUDA by
    default; raises without a card unless ``device="cpu"``).

    Leaves are drawn in sorted-key order (lists in order), so a seed fixes
    every tensor.
    """
    dev = resolve_device(device)

    def walk(node):
        if is_spec(node):
            return _materialize(node, generator).to(dev)
        if isinstance(node, list):
            return [walk(n) for n in node]
        return {k: walk(node[k]) for k in sorted(node)}
    return walk(strip_markers(specs))
