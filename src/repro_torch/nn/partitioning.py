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

And training on a (data, model) or (pod, data, model) mesh
(``runtime.train``, ``launch.steps.make_train_step``): under
``TRAIN_RULES`` each rank keeps its block of every leaf's 'embed'
dimension over ('pod', 'data') (FSDP) in the train state, parameters and
both moments alike (``shard_by``, by a tree of ``NamedSharding``s), and a
step gathers the parameters whole (``gather_by``, the inverse: the blocks
all-gathered in rank order, bit for bit).  ``fit_shardings`` keeps a leaf
whole where its dimension does not split evenly over the ranks (the
ResNets' 147-row stem), where the reference refuses the leaf.

A 'model' axis above 1 in training (tensor-parallel training of the
dense decoders, the ResNets, the MoE archs and whisper,
``TP_TRAIN_FAMILIES``): each rank keeps also its 'model' block of every
leaf the rules cut over 'model' (q, gate, up, MLA's uk/uv and the head by
columns, o and down by rows, the embedding by vocabulary rows, a conv by
output channels, the classifier by classes, the router by experts' columns
and each expert bank by whole experts), k/v, MLA's dkv, the norms and BN
whole; a step gathers only the FSDP blocks (``gather_by(..., axes=)``) and
keeps the 'model' shards.  The SSM and hybrid families raise
``NotImplementedError`` naming ROADMAP 16b (iv) (c)
(``require_train_mesh``).
"""
from __future__ import annotations

import contextlib
import dataclasses
import threading
from typing import Any, Dict, Optional, Sequence, Tuple, Union

import torch

from repro_torch.tree import leaves, unflatten

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
    "require_train_mesh",
    "shard_tree",
    "fit_shardings",
    "shard_by",
    "gather_by",
    "is_cut",
    "local_index",
    "TP_TRAIN_FAMILIES",
    "bucket",
    "BUCKET_BYTES",
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


# model families (``ModelAPI.family``) that train tensor-parallel over
# 'model' (ROADMAP 16b (iv) (a) and (b)), and the part of 16b (iv) the
# others wait for
TP_TRAIN_FAMILIES = ("dense", "vlm", "cnn", "moe", "audio")
TP_TRAIN_LATER = {"ssm": "(c)", "hybrid": "(c)"}


def require_train_mesh(sizes: Dict[str, int],
                       family: Optional[str] = None) -> None:
    """Raise unless the port trains ``family`` (a ``ModelAPI.family``;
    None: the mesh alone) on a mesh of ``sizes`` ({axis: size}): 'pod'
    and 'data' (the batch and FSDP axes) of any size; 'model' above 1
    (tensor-parallel) for the dense decoders, the ResNets, the MoE archs
    and whisper (``TP_TRAIN_FAMILIES``).  Any other family raises
    ``NotImplementedError`` naming the part of ROADMAP 16b (iv) it waits
    for."""
    m = sizes.get("model", 1)
    if m > 1 and family is not None and family not in TP_TRAIN_FAMILIES:
        part_ = TP_TRAIN_LATER.get(family, "(c)")
        raise NotImplementedError(
            f"a training mesh with a 'model' axis of {m}: tensor-parallel "
            f"training of the {family!r} family is not ported (ROADMAP "
            f"Queue 1, label 16b (iv) {part_}); train it on a (data, 1) or "
            f"(pod, data, 1) mesh")


def constrain(x, axes: Sequence[Optional[str]]):
    """The sharding constraint by logical names: a no-op.  Each rank holds
    its own rows of every activation, replicated over 'model' by the
    explicit collectives of the tensor-parallel layers.  The installed
    mesh must be one the port runs: a training mesh under rules that
    shard 'embed' (FSDP), a serving mesh otherwise."""
    mesh = getattr(_local, "mesh", None)
    if mesh is not None:
        if current_rules().get("embed") is not None:
            require_train_mesh(axis_sizes(mesh))
        else:
            require_serve_mesh(axis_sizes(mesh))
    return x


def _coords(mesh) -> Dict[str, Tuple[int, int]]:
    """{mesh axis: (this rank's coordinate, size)}."""
    return {ax: ((mesh.get_local_rank(ax) if n > 1 else 0), n)
            for ax, n in axis_sizes(mesh).items()}


def _entry_axes(entry) -> Tuple[str, ...]:
    return () if entry is None else (
        (entry,) if isinstance(entry, str) else tuple(entry))


def _blocks(shape, spec: Spec, coords, path: str = ""):
    """[(dim, block index, blocks)] of a leaf of ``shape`` under ``spec`` at
    the rank's ``coords``: each dimension that names mesh axes of size
    above 1, the first named axis the major one.  An uneven split raises
    naming the leaf and the axis."""
    out = []
    for dim, entry in enumerate(spec):
        names = _entry_axes(entry)
        idx, n = 0, 1
        for ax in names:
            r, size = coords[ax]
            idx, n = idx * size + r, n * size
        if n == 1:
            continue
        if shape[dim] % n:
            raise ValueError(
                f"{path or '<root>'}: dimension {dim} ({shape[dim]}) does "
                f"not split evenly over mesh axes {names} of {n} ranks")
        out.append((dim, idx, n))
    return out


def _only(spec: Spec, axes) -> Spec:
    """``spec`` with every mesh axis outside ``axes`` dropped (None: all
    kept); a dimension that names kept and dropped axes at once raises."""
    if axes is None:
        return spec
    out = []
    for entry in spec:
        names = _entry_axes(entry)
        kept = tuple(ax for ax in names if ax in axes)
        if kept and len(kept) != len(names):
            raise ValueError(f"spec entry {entry!r} mixes mesh axes {axes} "
                             f"with others")
        out.append(kept or None)
    return tuple(out)


def local_index(shape, sharding: "NamedSharding", path: str = "",
                axes=None) -> tuple:
    """This rank's block of a whole leaf of ``shape`` under ``sharding``, as
    a tuple of slices (numpy and torch indexing alike); ``axes``: cut only
    over these mesh axes (None: all)."""
    index = [slice(None)] * len(shape)
    for dim, idx, n in _blocks(shape, _only(sharding.spec, axes),
                               _coords(sharding.mesh), path):
        per = shape[dim] // n
        index[dim] = slice(idx * per, (idx + 1) * per)
    return tuple(index)


def shard_tree(tree, axes_tree, mesh, rules: Optional[Rules] = None):
    """This rank's slice of every leaf of ``tree`` (dicts and lists of
    tensors, leaf for leaf the logical ``axes_tree``) by its spec under
    ``rules`` (default ``SERVE_RULES``; ``TRAIN_RULES`` gives training's
    FSDP cut) at this rank's mesh coordinates:
    a dimension that names mesh axes is cut into equal blocks, rank
    order, the first named axis the major one, each slice a copy of its
    own (the whole leaf is not kept alive by it).  An uneven split raises
    naming the leaf and the axis.  Leaves whose spec names no axis of size
    above 1 are returned as they are."""
    rules = SERVE_RULES if rules is None else rules
    coords = _coords(mesh)

    def leaf(x, axes, path):
        spec = logical_to_spec(axes, rules, mesh)
        try:
            blocks = _blocks(x.shape, spec, coords, path)
        except ValueError as e:
            raise ValueError(f"{e} (logical axes {axes})") from None
        for dim, idx, n in blocks:
            per = x.shape[dim] // n
            x = x.narrow(dim, idx * per, per).clone()  # frees the whole
        return x

    return _walk2(tree, axes_tree, leaf, _is_axes)


def _walk2(tree, other, fn, is_leaf, path=""):
    """``fn(leaf, other's leaf, path)`` over ``tree`` and the tree
    ``other`` of its structure, whose leaves ``is_leaf`` tells."""
    if is_leaf(other):
        return fn(tree, other, path)
    if isinstance(other, dict):
        extra = sorted(set(tree) - set(other))
        if extra:
            raise ValueError(f"{path or '<root>'}: leaves {extra} have "
                             f"no logical axes to shard them by")
        return {k: _walk2(v, other[k], fn, is_leaf,
                          f"{path}.{k}" if path else str(k))
                for k, v in tree.items()}
    return type(tree)(_walk2(x, o, fn, is_leaf, f"{path}[{i}]")
                      for i, (x, o) in enumerate(zip(tree, other)))


def _is_sharding(x) -> bool:
    return isinstance(x, NamedSharding)


def fit_shardings(shardings, template):
    """``shardings`` (a ``NamedSharding`` tree) with every spec entry whose
    dimension of the ``template`` leaf (anything with a ``shape``) does
    not split evenly over its mesh axes set to ``None``: that dimension
    stays whole on every rank, as ``launch.steps.batch_rules_for``
    replicates a batch that does not split."""
    def fit(t, sh, path):
        sizes = axis_sizes(sh.mesh)
        spec = []
        for dim, entry in enumerate(sh.spec):
            n = 1
            for ax in _entry_axes(entry):
                n *= sizes.get(ax, 1)
            spec.append(entry if tuple(t.shape)[dim] % n == 0 else None)
        while spec and spec[-1] is None:
            spec.pop()
        return NamedSharding(sh.mesh, tuple(spec))
    return _walk2(template, shardings, fit, _is_sharding)


def shard_by(tree, shardings, axes=None):
    """This rank's block of every leaf of ``tree`` (tensors) by the
    ``NamedSharding`` tree ``shardings``, each a copy of its own; a leaf
    that no axis of size above 1 cuts is returned as it is.  ``axes``: cut
    only over these mesh axes (None: all), as a tensor-parallel step cuts
    its gradients, which hold the rank's 'model' blocks already, over the
    FSDP axes."""
    def cut(x, sh, path):
        index = local_index(tuple(x.shape), sh, path, axes)
        if all(i == slice(None) for i in index):
            return x
        return x[index].clone()
    return _walk2(tree, shardings, cut, _is_sharding)


# the bytes of other ranks' blocks that a collective over many leaves moves
# at once (a leaf larger than that moves alone)
BUCKET_BYTES = 32 << 20


def bucket(sizes, cap):
    """Consecutive index groups of ``sizes`` whose sums stay within
    ``cap`` (a size above it alone)."""
    out, cur, total = [], [], 0
    for i, n in enumerate(sizes):
        if cur and total + n > cap:
            out.append(cur)
            cur, total = [], 0
        cur.append(i)
        total += n
    return out + ([cur] if cur else [])


def gather_by(tree, shardings, axes=None):
    """The inverse of ``shard_by``: every leaf whole on every rank, its
    blocks all-gathered in rank order (``launch.mesh.all_gather_parts``),
    bit for bit; ``axes``: over these mesh axes only (None: all), so a
    tensor-parallel step gathers the FSDP blocks and keeps the rank's
    'model' shards.  Leaves cut along one dimension over the same mesh axes
    move together as bytes, in groups of whole leaves no larger than
    ``BUCKET_BYTES`` or the largest whole leaf, so a rank holds at most
    that many bytes of other ranks' blocks at a time.  Collective: every
    rank calls it with the same tree; a leaf stored whole is returned as
    it is."""
    from repro_torch.launch.mesh import all_gather_parts
    xs, shs = leaves(tree), leaves(shardings)
    if len(xs) != len(shs):
        raise ValueError(f"{len(xs)} leaves but {len(shs)} shardings")
    cuts = [_cut_dims(sh, axes) for sh in shs]
    out = list(xs)
    groups: Dict[tuple, list] = {}
    for i, cut in enumerate(cuts):
        if len(cut) == 1:  # moved with the leaves of its axes and dtype
            groups.setdefault((cut[0][1], xs[i].dtype), []).append(i)
        for dim, names in (cut if len(cut) > 1 else ()):
            out[i] = _cat(all_gather_parts(shs[i].mesh, out[i], names), dim)
    for (names, _), idx in groups.items():
        n_ranks = 1
        for ax in names:
            n_ranks *= axis_sizes(shs[idx[0]].mesh)[ax]
        blobs = [xs[i].contiguous().reshape(-1).view(torch.uint8)
                 for i in idx]
        cap = max(max(b.numel() for b in blobs) * n_ranks, BUCKET_BYTES)
        for group in bucket([b.numel() * n_ranks for b in blobs], cap):
            parts = all_gather_parts(shs[idx[0]].mesh, _cat(
                [blobs[j] for j in group], 0), names)
            off = 0
            for j in group:
                x, nb = xs[idx[j]], blobs[j].numel()
                blocks = [p[off:off + nb].view(x.dtype).reshape(x.shape)
                          for p in parts]
                out[idx[j]] = _cat(blocks, cuts[idx[j]][0][0])
                off += nb
    return unflatten(tree, out)


def _cut_dims(sharding, axes=None):
    """[(dim, the mesh axes of size above 1 that cut it)] of a spec (of
    ``axes`` only, where given)."""
    sizes = axis_sizes(sharding.mesh)
    out = []
    for dim, entry in enumerate(_only(sharding.spec, axes)):
        names = tuple(ax for ax in _entry_axes(entry) if sizes[ax] > 1)
        if names:
            out.append((dim, names))
    return out


def is_cut(sharding, axis: str) -> bool:
    """Whether mesh axis ``axis`` (of size above 1) cuts the leaf that
    ``sharding`` places: a tensor-parallel layer reads whether its leaf is
    a shard from here or from its shape, never from the rules alone
    (``fit_shardings`` keeps a leaf whole where its dimension does not
    split)."""
    return any(axis in names for _, names in _cut_dims(sharding))


def _cat(parts, dim):
    return parts[0] if len(parts) == 1 else torch.cat(parts, dim=dim)
