"""Trees of tensors: nested dicts, lists and tuples with tensor leaves.

The port keeps parameters, optimizer moments and checkpoints in plain
trees, as the JAX package does with pytrees.  Dicts are walked in sorted
key order (``jax.tree.flatten``'s order), lists and tuples in order, and
a leaf's path is written as ``jax.tree_util.keystr`` writes it
(``['layers'][0]['attn']['q']['w']``), so a checkpoint's leaf names are the
same in both packages wherever their trees are.
"""
from __future__ import annotations

from typing import Any, Callable, Dict, List

__all__ = ["leaves", "tree_map", "flatten_with_paths", "unflatten"]


def _children(tree):
    if isinstance(tree, dict):
        return [(f"[{k!r}]", tree[k]) for k in sorted(tree)]
    if isinstance(tree, (list, tuple)):
        return [(f"[{i}]", v) for i, v in enumerate(tree)]
    return None


def flatten_with_paths(tree, prefix: str = "") -> Dict[str, Any]:
    """{path: leaf} in traversal order."""
    kids = _children(tree)
    if kids is None:
        return {prefix: tree}
    out: Dict[str, Any] = {}
    for key, sub in kids:
        out.update(flatten_with_paths(sub, prefix + key))
    return out


def leaves(tree) -> List[Any]:
    """The leaves in traversal order."""
    return list(flatten_with_paths(tree).values())


def unflatten(template, values: List[Any]):
    """A tree shaped like ``template`` holding ``values`` in traversal
    order."""
    it = iter(values)

    def build(node):
        if isinstance(node, dict):
            built = {k: build(node[k]) for k in sorted(node)}
            return {k: built[k] for k in node}
        if isinstance(node, (list, tuple)):
            return type(node)(build(v) for v in node)
        return next(it)
    return build(template)


def tree_map(fn: Callable, tree, *rest):
    """``fn`` over the leaves of ``tree`` and of the trees in ``rest``,
    which share its structure."""
    if isinstance(tree, dict):
        return {k: tree_map(fn, tree[k], *(r[k] for r in rest))
                for k in tree}
    if isinstance(tree, (list, tuple)):
        return type(tree)(tree_map(fn, v, *(r[i] for r in rest))
                          for i, v in enumerate(tree))
    return fn(tree, *rest)
