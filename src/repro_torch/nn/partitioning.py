"""Logical-axis -> mesh-axis rules (MaxText-style), train and serve sets
(port of ``repro.nn.partitioning``).

The production mesh is (pod, data, model) multi-pod or (data, model)
single-pod (``launch.mesh``).  Rules map each *logical* parameter /
activation axis onto zero or more mesh axes:

  train: FSDP over ('pod','data') on the 'embed' axis of weights +
         tensor-parallel over 'model' on heads/mlp/vocab/experts;
         batch over ('pod','data'); optional sequence-sharding of the
         residual stream over 'model' (activation memory relief).
  serve: pure TP over 'model' (weights fit device memory once quantized --
         the paper's packed planes), batch over ('pod','data').

A rule value may name axes that the current mesh lacks (e.g. 'pod' on the
single-pod mesh) -- those are dropped, so one rule set serves both meshes.
Duplicate mesh axes within one spec are dropped (first logical axis wins),
and trailing ``None`` entries are trimmed.

A spec is a tuple with the entries of ``repro``'s ``PartitionSpec``: per
tensor dimension ``None``, one mesh axis name, or a tuple of them.  A
``NamedSharding`` maps a spec onto a ``torch.distributed`` ``DeviceMesh``
as one placement per mesh dimension: ``Shard(dim)`` where a tensor
dimension names that mesh axis, else ``Replicate()``.

What runs: serving on a (data, model) mesh (``runtime.serve``).  Each rank
holds its own rows of the batch and, under ``SERVE_RULES``, its slice of
the packed tree (``shard_tree``): column-parallel q/gate/up and head over
'model', row-parallel o/down ('heads_packed', 'mlp_packed'), the embedding
on 'vocab', k/v and the norms whole; MLA's uk/uv by 'heads', its dkv and
``kv_norm`` whole; an MoE block's router columns and its expert banks on
'experts' (expert parallelism: whole experts a rank, so the banks'
'expert_mlp_packed' rows stay whole); the RG-LRU's ``('mlp', 'mlp')``
gates by rows (their gamma and colsum by columns); and every decode
cache on 'kv_seq'.  Two cuts are the arch's own
(``runtime.serve.local_params``): mamba2's fused ``in_xbc`` and conv keep
a rank's heads' x columns with B and C whole, and the RG-LRU's conv (on
'act_embed', whole under the rules) its channels; the fp baseline keeps
every weight's contraction axis whole (``nn.quantized.fp_serve_axes``).
Activations are replicated over
'model' by explicit collectives (``launch.mesh.all_reduce_model``,
``all_gather_model``), so ``constrain`` stays a no-op.  A 'pod' axis above
1 is described by these rules but not served.
"""
from __future__ import annotations

import contextlib
import dataclasses
import threading
from typing import Any, Dict, Optional, Sequence, Tuple, Union

__all__ = [
    "TRAIN_RULES",
    "SERVE_RULES",
    "TRAIN_RULES_SEQ",
    "NamedSharding",
    "axis_names",
    "axis_sizes",
    "axis_rules",
    "current_rules",
    "current_mesh",
    "logical_to_spec",
    "sharding_for",
    "replicated",
    "tree_shardings",
    "constrain",
    "require_serve_mesh",
    "shard_tree",
]

Rules = Dict[str, Union[None, str, Tuple[str, ...]]]
Spec = Tuple[Union[None, str, Tuple[str, ...]], ...]

TRAIN_RULES: Rules = {
    "batch": ("pod", "data"),
    "seq": None,
    "act_embed": None,
    "embed": ("pod", "data"),   # FSDP shard axis of 2-D weights
    "embed_packed": None,
    "mlp": "model",
    "heads": "model",
    "kv_heads": None,           # kv heads can be < TP degree (MQA)
    "head_dim": None,
    "qk_dim": None,
    "vocab": "model",
    "experts": "model",         # expert parallelism
    "expert_mlp": None,
    "layers": None,
    "kv_seq": None,            # decode-cache seq axis (train: unused)
    "plane": None,
    "state": None,
    "conv": None,
    "cap": None,
    "frames": None,
}

SERVE_RULES: Rules = {
    **TRAIN_RULES,
    "embed": None,              # no FSDP at serve: packed weights fit
    "batch": ("pod", "data"),
    # decode KV/state caches shard their sequence axis over the TP axis
    # (flash-decoding style).
    "kv_seq": "model",
    # Row-parallel packed planes (Megatron pattern): projections writing
    # into the residual stream (down, o) shard their contraction axis so
    # no serve weight is replicated.
    "mlp_packed": "model",
    "heads_packed": "model",
    "expert_mlp_packed": "model",   # dropped when 'experts' already owns it
}

# Sequence-sharded variant: residual stream S over model.
TRAIN_RULES_SEQ = {**TRAIN_RULES, "seq": "model"}

_local = threading.local()


def axis_names(mesh) -> Tuple[str, ...]:
    """A mesh's axis names: a ``DeviceMesh``'s ``mesh_dim_names``, or the
    ``axis_names`` of any mesh-like object."""
    names = getattr(mesh, "mesh_dim_names", None)
    if names is None:
        names = getattr(mesh, "axis_names")
    return tuple(names)


def axis_sizes(mesh) -> Dict[str, int]:
    """{axis name: size} of a mesh (``DeviceMesh.shape``, or a mesh-like
    object's ``devices.shape``)."""
    devices = getattr(mesh, "devices", None)
    shape = (tuple(devices.shape) if devices is not None
             else tuple(mesh.shape))
    return dict(zip(axis_names(mesh), shape))


def current_rules() -> Rules:
    return getattr(_local, "rules", TRAIN_RULES)


def current_mesh():
    return getattr(_local, "mesh", None)


@contextlib.contextmanager
def axis_rules(rules: Rules, mesh=None):
    """Install a logical->mesh rule set (and optionally the mesh) locally."""
    old_r = getattr(_local, "rules", None)
    old_m = getattr(_local, "mesh", None)
    _local.rules = rules
    _local.mesh = mesh
    try:
        yield
    finally:
        if old_r is None:
            del _local.rules
        else:
            _local.rules = old_r
        _local.mesh = old_m


def logical_to_spec(axes: Sequence[Optional[str]],
                    rules: Optional[Rules] = None, mesh=None) -> Spec:
    """Logical axis names -> spec under the rules and mesh."""
    rules = rules if rules is not None else current_rules()
    mesh_axes = set(axis_names(mesh)) if mesh is not None else None
    used = set()
    out = []
    for name in axes:
        entry = rules.get(name) if name is not None else None
        if entry is None:
            out.append(None)
            continue
        cand = (entry,) if isinstance(entry, str) else tuple(entry)
        picked = []
        for ax in cand:
            if mesh_axes is not None and ax not in mesh_axes:
                continue  # rule names an axis this mesh lacks (e.g. 'pod')
            if ax in used:
                continue  # first logical axis wins a mesh axis
            used.add(ax)
            picked.append(ax)
        if not picked:
            out.append(None)
        elif len(picked) == 1:
            out.append(picked[0])
        else:
            out.append(tuple(picked))
    while out and out[-1] is None:
        out.pop()
    return tuple(out)


@dataclasses.dataclass(frozen=True)
class NamedSharding:
    """A spec placed on a mesh."""

    mesh: Any
    spec: Spec

    @property
    def placements(self) -> tuple:
        """One ``torch.distributed.tensor`` placement per mesh dimension:
        ``Shard(d)`` where tensor dimension d names the mesh axis, else
        ``Replicate()``."""
        from torch.distributed.tensor import Replicate, Shard
        out = []
        for ax in axis_names(self.mesh):
            dims = [d for d, entry in enumerate(self.spec)
                    if entry == ax or (isinstance(entry, tuple)
                                       and ax in entry)]
            out.append(Shard(dims[0]) if dims else Replicate())
        return tuple(out)

    @property
    def is_fully_replicated(self) -> bool:
        sizes = axis_sizes(self.mesh)
        return all(sizes[ax] == 1 for entry in self.spec if entry is not None
                   for ax in ((entry,) if isinstance(entry, str) else entry))


def sharding_for(axes: Sequence[Optional[str]], mesh,
                 rules: Optional[Rules] = None) -> NamedSharding:
    return NamedSharding(mesh, logical_to_spec(axes, rules, mesh))


def replicated(mesh) -> NamedSharding:
    """Fully replicated placement -- boundary/embedding layers and packed
    CNN trees at serve time."""
    return NamedSharding(mesh, ())


def _is_axes(x) -> bool:
    return isinstance(x, tuple) and all(isinstance(a, (str, type(None)))
                                        for a in x)


def tree_shardings(axes_tree, mesh, rules: Optional[Rules] = None):
    """Logical-axes tree (dicts, lists and tuples; an axes tuple is a
    leaf) -> ``NamedSharding`` tree."""
    if _is_axes(axes_tree):
        return sharding_for(axes_tree, mesh, rules)
    if isinstance(axes_tree, dict):
        return {k: tree_shardings(v, mesh, rules)
                for k, v in axes_tree.items()}
    return type(axes_tree)(tree_shardings(v, mesh, rules) for v in axes_tree)


def require_serve_mesh(sizes: Dict[str, int]) -> None:
    """Raise unless the mesh (``sizes``: {axis: size}, ``axis_sizes(mesh)``)
    is one the port serves: 'data' and 'model' of any size, every other
    axis (the multi-pod 'pod') of size 1."""
    wide = {ax: n for ax, n in sizes.items()
            if ax not in ("data", "model") and n > 1}
    if wide:
        raise NotImplementedError(
            f"mesh axes {wide} > 1: the port serves (data, model) meshes; "
            f"a multi-pod serve mesh is not ported")


def constrain(x, axes: Sequence[Optional[str]]):
    """The sharding constraint by logical names: a no-op.  Each rank holds
    its own rows of every activation, replicated over 'model' by the
    explicit collectives of the tensor-parallel layers."""
    mesh = getattr(_local, "mesh", None)
    if mesh is not None:
        require_serve_mesh(axis_sizes(mesh))
    return x


def _coords(mesh) -> Dict[str, Tuple[int, int]]:
    """{mesh axis: (this rank's coordinate, size)}."""
    return {ax: ((mesh.get_local_rank(ax) if n > 1 else 0), n)
            for ax, n in axis_sizes(mesh).items()}


def shard_tree(tree, axes_tree, mesh, rules: Optional[Rules] = None):
    """This rank's slice of every leaf of ``tree`` (dicts and lists of
    tensors, leaf for leaf the logical ``axes_tree``) by its spec under
    ``rules`` (default ``SERVE_RULES``) at this rank's mesh coordinates:
    a dimension that names mesh axes is cut into equal blocks, rank
    order, the first named axis the major one, each slice a copy of its
    own (the whole leaf is not kept alive by it).  An uneven split raises
    naming the leaf and the axis.  Leaves whose spec names no axis of size
    above 1 are returned as they are."""
    rules = SERVE_RULES if rules is None else rules
    coords = _coords(mesh)

    def leaf(x, axes, path):
        spec = logical_to_spec(axes, rules, mesh)
        for dim, entry in enumerate(spec):
            if entry is None:
                continue
            names = (entry,) if isinstance(entry, str) else tuple(entry)
            idx, n = 0, 1
            for ax in names:
                r, size = coords[ax]
                idx, n = idx * size + r, n * size
            if n == 1:
                continue
            if x.shape[dim] % n:
                raise ValueError(
                    f"{path or '<root>'}: dimension {dim} ({axes[dim]!r}, "
                    f"{x.shape[dim]}) does not split evenly over mesh axes "
                    f"{names} of {n} ranks")
            per = x.shape[dim] // n
            x = x.narrow(dim, idx * per, per).clone()  # frees the whole
        return x

    def walk(t, a, path):
        if _is_axes(a):
            return leaf(t, a, path)
        if isinstance(a, dict):
            extra = sorted(set(t) - set(a))
            if extra:
                raise ValueError(f"{path or '<root>'}: leaves {extra} have "
                                 f"no logical axes to shard them by")
            return {k: walk(v, a[k], f"{path}.{k}" if path else str(k))
                    for k, v in t.items()}
        return type(t)(walk(x, ax, f"{path}[{i}]")
                       for i, (x, ax) in enumerate(zip(t, a)))

    return walk(tree, axes_tree, "")
