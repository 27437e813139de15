"""Production and serving meshes (port of ``repro.launch.mesh``), one
process a rank.

A mesh is a ``torch.distributed`` ``DeviceMesh`` with dim names ``("data",
"model")`` (or ``("pod", "data", "model")``) over the world of processes,
one rank a device: what a user of an 8-card node runs under ``torchrun``,
or ``spawn`` starts on one machine.  The world is NCCL on cards, gloo on
the CPU and wherever several ranks share one card (an explicit ``devices=``
list may map them so; NCCL refuses two ranks on one card).  Every
``init_process_group`` takes a timeout.

Each mesh carries what its rank needs beside the ``DeviceMesh``
(``mesh_info``): the rank's device, the world's backend and a gloo group
for host values.  ``gather_rows`` all-gathers rank-equal row blocks over
'data' (ranks that share a data coordinate hold the same rows), and
``shared_clock`` makes every rank read rank 0's clock, so schedulers take
the same decisions on every rank.  Tensor-parallel serving (a 'model' axis
above 1) has two collectives over 'model', both in rank order:
``all_reduce_model`` sums int32 partial accumulators exactly, and
``all_gather_model`` concatenates shards.  All three take the host route
where the backend is gloo and the tensor lies on a card (NCCL refuses
two ranks on one card, so such a world is gloo).

Data-parallel and FSDP training (a (data, 1) or (pod, data, 1) mesh,
``make_train_mesh``) has two more, over the batch axes ('pod', 'data'):
``all_gather_axes`` concatenates a leaf's FSDP blocks in rank order, and
``all_reduce_batch`` sums f32 gradients, gathered and then added in rank
order from a zero tensor, as ``launch.steps.make_train_step`` adds its
microbatches.  ``any_rank`` and ``broadcast_value`` are the host-side
agreements a training loop takes its decisions by, and ``barrier`` waits
for every rank.

Tensor-parallel training (a 'model' axis above 1 on a training mesh) has
five collectives over 'model' under autograd, each sum gathered and then
added in rank order from a zero f32 tensor: ``sum_model`` (a row shard's
partial product; backward the identity), ``copy_model`` (the identity;
backward that sum), ``gather_model`` (an all-gather along a dim; backward
the rank's block), ``cut_model`` (its inverse: the rank's block of a
whole tensor; backward the blocks' cotangents all-gathered, exact) and
``owned_model`` (one rank owns each element: the embedding's lookup and
the loss's label logit, exact).
``all_reduce_model`` stays int32-only, for serving.

Nothing here touches ``torch.distributed`` until a mesh is made.
"""
from __future__ import annotations

import dataclasses
import datetime
import os
import queue as queue_lib
import time
import traceback
from typing import Any, Callable, List, Optional, Sequence, Tuple

import torch

from repro_torch.nn import partitioning as part

__all__ = ["make_production_mesh", "make_local_mesh", "make_serve_mesh",
           "make_train_mesh", "parse_mesh_spec", "mesh_axes", "chips",
           "MeshInfo", "mesh_info", "local_device", "data_coords",
           "model_coords", "rank_of", "gather_rows", "all_reduce_model",
           "all_gather_model", "all_gather_parts", "all_gather_axes",
           "all_reduce_batch", "sum_model", "copy_model", "gather_model",
           "cut_model", "owned_model", "broadcast_value", "any_rank",
           "barrier", "DataRows", "shared_clock", "spawn", "INIT_TIMEOUT_S"]

INIT_TIMEOUT_S = 300.0  # every process-group init and collective


@dataclasses.dataclass(frozen=True)
class MeshInfo:
    """What a rank of a mesh needs beside the ``DeviceMesh``."""

    device: torch.device      # this rank's device
    backend: str              # the world's backend ('nccl' | 'gloo')
    host_group: Any = None    # gloo group for host values (None: the world)


def _dist():
    import torch.distributed as dist
    if not dist.is_available():
        raise RuntimeError("torch.distributed is not available in this "
                           "torch build; meshes need it")
    return dist


def _timeout(seconds: Optional[float] = None) -> datetime.timedelta:
    return datetime.timedelta(seconds=seconds or INIT_TIMEOUT_S)


def _ensure_world(backend: str) -> None:
    """The default process group: as it is when initialized; from the
    environment under ``torchrun`` (``WORLD_SIZE``, ``RANK``,
    ``MASTER_ADDR``/``PORT``); else a world of one."""
    dist = _dist()
    if dist.is_initialized():
        return
    if "WORLD_SIZE" in os.environ and "RANK" in os.environ:
        dist.init_process_group(backend, init_method="env://",
                                timeout=_timeout())
    else:
        dist.init_process_group(backend, store=dist.HashStore(), rank=0,
                                world_size=1, timeout=_timeout())


def _world_size() -> int:
    dist = _dist()
    if dist.is_initialized():
        return dist.get_world_size()
    return int(os.environ.get("WORLD_SIZE", "1"))


def _placement(world: int, device, devices: Optional[Sequence]
               ) -> Tuple[torch.device, str]:
    """(this rank's device, the world's backend).  Rank r serves on
    ``devices[r]`` when given, else on its card within its host
    (``LOCAL_RANK``, as ``torchrun`` and ``spawn`` set it) or the CPU.
    Gloo on the CPU and where several ranks share a card, else NCCL."""
    dist = _dist()
    rank = (dist.get_rank() if dist.is_initialized()
            else int(os.environ.get("RANK", "0")))
    if devices is not None:
        devs = [torch.device(d) for d in devices]
        if len(devs) != world:
            raise ValueError(f"devices= lists {len(devs)} devices for a "
                             f"world of {world} ranks")
        cards = [d for d in devs if d.type == "cuda"]
        shared = not cards or len(set(cards)) < len(cards)
        return devs[rank], "gloo" if shared else "nccl"
    dev = torch.device(device)
    if dev.type == "cpu":
        return dev, "gloo"
    if not torch.cuda.is_available():
        raise RuntimeError("a CUDA mesh was asked for but torch sees no "
                           "CUDA device; pass device='cpu'")
    local_world = int(os.environ.get("LOCAL_WORLD_SIZE", world))
    n_cards = torch.cuda.device_count()
    if local_world > n_cards:
        raise ValueError(
            f"{local_world} ranks on this host but {n_cards} card(s); pass "
            f"devices= to put several ranks on one card")
    local_rank = int(os.environ.get("LOCAL_RANK", rank))
    return torch.device("cuda", local_rank), "nccl"


def _make_mesh(shape: Tuple[int, ...], names: Tuple[str, ...], device,
               devices, world_expected: Optional[int] = None):
    dist = _dist()
    need = 1
    for n in shape:
        need *= n
    world = _world_size()
    if world_expected is not None and world != world_expected:
        raise ValueError(f"mesh {'x'.join(map(str, shape))} {names} needs a "
                         f"world of {world_expected} ranks, this one has "
                         f"{world}")
    if need != world:
        raise ValueError(
            f"mesh {'x'.join(map(str, shape))} {names} covers {need} ranks "
            f"but the world has {world}: start one process a rank "
            f"(launch.mesh.spawn, or torchrun --nproc-per-node {need})")
    dev, backend = _placement(world, device, devices)
    if dev.type == "cuda":  # before NCCL meets the card
        torch.cuda.set_device(dev)
        torch.cuda.init()
    _ensure_world(backend)
    backend = dist.get_backend()
    from torch.distributed.device_mesh import DeviceMesh
    mesh = DeviceMesh(dev.type, torch.arange(need).reshape(shape),
                      mesh_dim_names=names)
    host = (dist.new_group(backend="gloo", timeout=_timeout())
            if backend != "gloo" and world > 1 else None)
    mesh.repro_info = MeshInfo(device=dev, backend=backend, host_group=host)
    return mesh


def make_production_mesh(*, multi_pod: bool = False, device="cuda",
                         devices=None):
    """16x16 = 256 ranks a pod; ``multi_pod`` adds the 2-pod axis (512).
    Raises unless the world really has that many ranks."""
    shape = (2, 16, 16) if multi_pod else (16, 16)
    names = ("pod", "data", "model") if multi_pod else ("data", "model")
    return _make_mesh(shape, names, device, devices,
                      world_expected=512 if multi_pod else 256)


def make_local_mesh(*, device="cuda", devices=None):
    """A (world, 1) data-parallel mesh over every rank of the world."""
    return _make_mesh((_world_size(), 1), ("data", "model"), device, devices)


def make_train_mesh(shape: Tuple[int, ...] = None, *, device="cuda",
                    devices=None):
    """A training mesh over the world's ranks: ``shape`` (data, model) or
    (pod, data, model), default (world, 1); rank r sits at its row-major
    coordinates, so the ranks of one data row are consecutive.  A 'model'
    axis above 1 is tensor-parallel training, which ``make_train_step``
    and the ``Trainer`` take for the archs that have it
    (``nn.partitioning.require_train_mesh``)."""
    shape = tuple(shape) if shape is not None else (_world_size(), 1)
    names = (("data", "model") if len(shape) == 2
             else ("pod", "data", "model"))
    if len(shape) not in (2, 3):
        raise ValueError(f"a training mesh is (data, model) or (pod, data, "
                         f"model), got {shape}")
    part.require_train_mesh(dict(zip(names, shape)))
    return _make_mesh(shape, names, device, devices)


def parse_mesh_spec(spec: str) -> Tuple[int, int]:
    """'8x1' -> (data=8, model=1) (the serve-CLI ``--mesh`` format)."""
    try:
        d, m = (int(p) for p in spec.lower().split("x"))
    except ValueError:
        raise ValueError(f"mesh spec must be DATAxMODEL (e.g. '8x1'), "
                         f"got {spec!r}") from None
    if d < 1 or m < 1:
        raise ValueError(f"mesh axes must be >= 1, got {spec!r}")
    return d, m


def make_serve_mesh(data: Optional[int] = None, model: int = 1, *,
                    device="cuda", devices=None):
    """(data, model) serving mesh over the world's ranks (default: all of
    them data-parallel).  Rank r serves on ``devices[r]`` when given, else
    on its card (``device="cuda"``) or the CPU; rank r sits at (r // model,
    r % model), so the ranks of one data coordinate are consecutive.  The
    serving objects decide which archs a 'model' axis above 1 serves."""
    world = _world_size()
    if data is None:
        data = world // model
    if data < 1:
        raise ValueError(
            f"model axis {model} exceeds the world's {world} ranks (a "
            f"0x{model} mesh has no data shards)")
    part.require_serve_mesh({"data": data, "model": model})
    if data * model > world:
        raise ValueError(
            f"serve mesh {data}x{model} needs {data * model} ranks, the "
            f"world has {world} (spawn more: launch.serve --devices N, or "
            f"torchrun --nproc-per-node N)")
    return _make_mesh((data, model), ("data", "model"), device, devices)


def mesh_axes(mesh) -> tuple:
    return tuple(part.axis_sizes(mesh).items())


def chips(mesh) -> int:
    n = 1
    for size in part.axis_sizes(mesh).values():
        n *= size
    return n


def mesh_info(mesh) -> MeshInfo:
    info = getattr(mesh, "repro_info", None)
    if info is None:
        raise ValueError("mesh was not made by launch.mesh (no rank device "
                         "or backend recorded)")
    return info


def local_device(mesh) -> torch.device:
    """This rank's device on ``mesh``."""
    return mesh_info(mesh).device


def data_coords(mesh) -> Tuple[int, int]:
    """(this rank's coordinate on 'data', the axis' size)."""
    sizes = part.axis_sizes(mesh)
    n = sizes.get("data", 1)
    if n == 1:
        return 0, 1
    return mesh.get_local_rank("data"), n


def model_coords(mesh) -> Tuple[int, int]:
    """(this rank's coordinate on 'model', the axis' size); (0, 1) without
    a mesh."""
    sizes = part.axis_sizes(mesh) if mesh is not None else {}
    n = sizes.get("model", 1)
    if n == 1:
        return 0, 1
    return mesh.get_local_rank("model"), n


def _gather(mesh, axis: str, n: int, x: torch.Tensor) -> List[torch.Tensor]:
    """Every rank's ``x`` along mesh axis ``axis`` (size ``n``), in rank
    order, as tensors on ``x``'s device.  Moved as bytes, so any dtype;
    through the host where the backend is gloo and ``x`` lies on a card."""
    t = x.contiguous()
    if t.numel() == 0:
        return [t] * n
    dist = _dist()
    flat = t.reshape(-1).view(torch.uint8)
    via_host = mesh_info(mesh).backend == "gloo" and flat.is_cuda
    src = flat.cpu() if via_host else flat
    parts = [torch.empty_like(src) for _ in range(n)]
    group = mesh.get_group(axis)
    dist.all_gather(parts, src, group=group)
    me = dist.get_group_rank(group, dist.get_rank()) if via_host else -1
    # the rank's own part is ``x`` itself: no copy back to the card
    return [t if i == me else p.to(x.device).view(x.dtype).reshape(t.shape)
            for i, p in enumerate(parts)]


def gather_rows(mesh, x: torch.Tensor) -> torch.Tensor:
    """All-gather each rank's equal block of rows (dim 0) over 'data', in
    rank order."""
    _, n = data_coords(mesh)
    if n == 1:
        return x
    return torch.cat(_gather(mesh, "data", n, x))


def all_gather_model(mesh, x: torch.Tensor, dim: int) -> torch.Tensor:
    """Each 'model' rank's shard of a tensor, concatenated along ``dim`` in
    rank order: every model rank gets the same tensor, bit for bit."""
    _, n = model_coords(mesh)
    if n == 1:
        return x
    return torch.cat(_gather(mesh, "model", n, x), dim=dim)


def all_reduce_model(mesh, x: torch.Tensor) -> torch.Tensor:
    """The sum over the 'model' ranks of an int32 tensor: every rank's
    partial gathered, then added in rank order on each rank.  Exact:
    int32 addition wraps and is associative, so the sum is the one-device
    accumulator whatever the order."""
    if x.dtype != torch.int32:
        raise TypeError(f"all_reduce_model sums int32 accumulators, got "
                        f"{x.dtype}")
    _, n = model_coords(mesh)
    if n == 1:
        return x
    parts = _gather(mesh, "model", n, x)
    out = parts[0].clone()
    for p in parts[1:]:
        out += p
    return out


# --- tensor-parallel training: collectives over 'model' under autograd -------


def _sum_parts(parts, like: torch.Tensor) -> torch.Tensor:
    """``parts`` added in order into a zero f32 tensor, cast to ``like``'s
    dtype."""
    out = torch.zeros(like.shape, dtype=torch.float32, device=like.device)
    for p in parts:
        out.add_(p)
    return out.to(like.dtype)


def _model_sum(mesh, x: torch.Tensor) -> torch.Tensor:
    """Every 'model' rank's ``x`` gathered and added in rank order from
    zero in f32 (``all_reduce_batch``'s order), in ``x``'s dtype."""
    _, n = model_coords(mesh)
    return _sum_parts(_gather(mesh, "model", n, x), x)


class _SumModel(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, mesh):
        return _model_sum(mesh, x)

    @staticmethod
    def backward(ctx, g):
        return g, None


class _CopyModel(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, mesh):
        ctx.mesh = mesh
        return x.view_as(x)

    @staticmethod
    def backward(ctx, g):
        return _model_sum(ctx.mesh, g), None


class _GatherModel(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, mesh, dim):
        ctx.dim, ctx.block = dim, x.shape[dim]
        ctx.rank = model_coords(mesh)[0]
        return all_gather_model(mesh, x, dim)

    @staticmethod
    def backward(ctx, g):
        return g.narrow(ctx.dim, ctx.rank * ctx.block,
                        ctx.block).contiguous(), None, None


class _CutModel(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, mesh, dim):
        r, n = model_coords(mesh)
        ctx.mesh, ctx.dim = mesh, dim
        block = x.shape[dim] // n
        return x.narrow(dim, r * block, block).contiguous()

    @staticmethod
    def backward(ctx, g):
        return all_gather_model(ctx.mesh, g, ctx.dim), None, None


class _OwnedModel(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, mesh, owner):
        r, n = model_coords(mesh)
        ctx.save_for_backward(owner == r)
        parts = _gather(mesh, "model", n, x)
        out = parts[0]
        for i, p in enumerate(parts[1:], 1):
            out = torch.where(owner == i, p, out)
        return out

    @staticmethod
    def backward(ctx, g):
        mine, = ctx.saved_tensors
        return torch.where(mine, g, torch.zeros_like(g)), None, None


def sum_model(mesh, x: torch.Tensor) -> torch.Tensor:
    """(a) The sum over the 'model' ranks of a float tensor (a row shard's
    f32 partial product): gathered, added in rank order from zero in f32
    on every rank, so every rank gets the same bits.  Backward: the
    identity -- the sum's cotangent is whole on every rank, and so is each
    partial's."""
    return x if model_coords(mesh)[1] == 1 else _SumModel.apply(x, mesh)


def copy_model(mesh, x: torch.Tensor) -> torch.Tensor:
    """(b) The identity, whose backward is ``sum_model``'s sum: a tensor
    whole on every 'model' rank that each rank uses in part (the input of
    a column shard, a step size whose gradient each rank holds a share
    of), its partial cotangents summed in f32 in rank order and cast back
    to its dtype (Megatron's copy to the tensor-parallel region)."""
    return x if model_coords(mesh)[1] == 1 else _CopyModel.apply(x, mesh)


def gather_model(mesh, x: torch.Tensor, dim: int) -> torch.Tensor:
    """(c) ``all_gather_model`` along ``dim`` under autograd: backward
    keeps the rank's block of the cotangent.  Every consumer of the
    gathered tensor runs whole on every rank and hands back a whole
    cotangent (each column shard sums its partial input cotangents first,
    ``copy_model``), so a sum over the ranks here would count the gradient
    once a rank."""
    if model_coords(mesh)[1] == 1:
        return x
    return _GatherModel.apply(x, mesh, dim)


def cut_model(mesh, x: torch.Tensor, dim: int) -> torch.Tensor:
    """(d) The inverse of ``gather_model``: this rank's block along ``dim``
    of a tensor whole and the same on every 'model' rank, of which each
    rank uses its own block alone (an expert's gates, whisper's cross K/V
    by heads).  Backward: the blocks' cotangents all-gathered in rank
    order, the whole tensor's cotangent on every rank, exactly (each
    element has one rank that uses it; a sum would add zeros)."""
    r, m = model_coords(mesh)
    if m == 1:
        return x
    if x.shape[dim] % m:
        raise ValueError(f"dimension {dim} ({x.shape[dim]}) does not split "
                         f"over {m} 'model' ranks")
    return _CutModel.apply(x, mesh, dim)


def owned_model(mesh, x: torch.Tensor, owner: torch.Tensor) -> torch.Tensor:
    """(e) The sum over the 'model' ranks where exactly one rank owns each
    element (``owner``: the owning rank, broadcast against ``x``; the
    others hold zeros there): each element taken from its owner's ``x``,
    exactly (a -0.0 stays -0.0).  Backward: the cotangent where this rank
    owns the element, zero elsewhere."""
    if model_coords(mesh)[1] == 1:
        return x
    return _OwnedModel.apply(x, mesh, owner)


def rank_of(mesh) -> int:
    """This rank's place in the world (0 without a mesh)."""
    if mesh is None or chips(mesh) == 1:
        return 0
    return _dist().get_rank()


def all_gather_parts(mesh, x: torch.Tensor,
                     names: Sequence[str]) -> List[torch.Tensor]:
    """Every rank's ``x`` over the mesh axes ``names`` (the first the major
    one), in their row-major rank order: gathered over the minor axis
    first, then those copies over each major one."""
    parts = [x]
    sizes = part.axis_sizes(mesh)
    for ax in reversed(tuple(names)):
        n = sizes[ax]
        if n == 1:
            continue
        if len(parts) == 1:
            parts = _gather(mesh, ax, n, parts[0])
        else:
            got = _gather(mesh, ax, n, torch.stack(parts))
            parts = [p for block in got for p in block.unbind(0)]
    return parts


def all_gather_axes(mesh, x: torch.Tensor, dim: int,
                    names: Sequence[str]) -> torch.Tensor:
    """Each rank's block of a tensor over the mesh axes ``names``,
    concatenated along ``dim`` in rank order (the first name the major
    one): the whole tensor on every rank, bit for bit."""
    parts = all_gather_parts(mesh, x, names)
    return parts[0] if len(parts) == 1 else torch.cat(parts, dim=dim)


def all_reduce_batch(mesh, x: torch.Tensor,
                     names: Sequence[str] = ("pod", "data")) -> torch.Tensor:
    """The sum over the ranks of the mesh axes ``names`` of an f32 tensor:
    every rank's ``x`` gathered, then added in rank order into a zero
    tensor, as ``launch.steps.make_train_step`` adds its microbatches (so
    a -0.0 and the order of the additions are the one-device step's).
    Every rank gets the same bits; it holds at most one copy of ``x`` a
    rank at a time."""
    if x.dtype != torch.float32:
        raise TypeError(f"all_reduce_batch sums f32 gradients, got "
                        f"{x.dtype}")
    names = tuple(ax for ax in names if ax in part.axis_sizes(mesh))
    parts = all_gather_parts(mesh, x, names)
    if len(parts) == 1:
        return x
    out = torch.zeros(x.shape, dtype=torch.float32, device=x.device)
    for p in parts:
        out.add_(p)
    return out


class DataRows:
    """This rank's share of a batch on a data-parallel mesh: a global batch
    padded to a multiple of the 'data' size ``n``, rank r holding rows
    ``[r * B/n, (r + 1) * B/n)``.  Without a mesh (``n == 1``) every method
    is the identity."""

    def __init__(self, mesh=None):
        self.mesh = mesh
        self.rank, self.n = data_coords(mesh) if mesh is not None else (0, 1)

    def pad_to(self, b: int) -> int:
        """The smallest multiple of ``n`` at or above ``b``."""
        return -(-b // self.n) * self.n

    def local(self, x: torch.Tensor) -> torch.Tensor:
        """This rank's rows (dim 0) of a global (padded) batch."""
        if self.n == 1:
            return x
        if x.shape[0] % self.n:
            raise ValueError(f"a batch of {x.shape[0]} rows does not "
                             f"split over {self.n} data ranks; pad it to "
                             f"a multiple (DataRows.pad_to)")
        per = x.shape[0] // self.n
        return x[self.rank * per:(self.rank + 1) * per]

    def gather(self, x: torch.Tensor) -> torch.Tensor:
        """Every rank's rows, in rank order (``gather_rows``)."""
        return x if self.n == 1 else gather_rows(self.mesh, x)


def broadcast_value(mesh, value: float) -> float:
    """Rank 0's ``value`` on every rank of the mesh (a float64 through the
    host)."""
    if chips(mesh) == 1:
        return value
    dist = _dist()
    buf = torch.tensor([value], dtype=torch.float64)
    dist.broadcast(buf, src=0, group=mesh_info(mesh).host_group)
    return float(buf.item())


def any_rank(mesh, flag: bool) -> bool:
    """True on every rank where ``flag`` is true on any rank of the mesh
    (one max over the host group): a decision that every rank must take
    alike, such as stopping after a signal one rank received."""
    if mesh is None or chips(mesh) == 1:
        return bool(flag)
    dist = _dist()
    buf = torch.tensor([1 if flag else 0], dtype=torch.int32)
    dist.all_reduce(buf, op=dist.ReduceOp.MAX,
                    group=mesh_info(mesh).host_group)
    return bool(buf.item())


def barrier(mesh) -> None:
    """Wait until every rank of the mesh reaches this call (the host
    group)."""
    if mesh is None or chips(mesh) == 1:
        return
    _dist().barrier(group=mesh_info(mesh).host_group)


def shared_clock(clock: Callable[[], float], mesh) -> Callable[[], float]:
    """``clock`` as rank 0 reads it, on every rank (of a 'data' or a 'model'
    axis alike: their decisions must agree for their collectives to
    match): each call is one broadcast, so every rank must read it in the
    same order (SPMD)."""
    if mesh is None or chips(mesh) == 1:
        return clock

    def read() -> float:
        return broadcast_value(mesh, clock())
    read.__wrapped__ = clock
    return read


# --- local ranks -------------------------------------------------------------


def _child(rank: int, world: int, store: str, backend: str, timeout_s: float,
           fn: Callable, args: tuple, results) -> None:
    dist = _dist()
    os.environ.update(RANK=str(rank), WORLD_SIZE=str(world),
                      LOCAL_RANK=str(rank), LOCAL_WORLD_SIZE=str(world))
    try:
        dist.init_process_group(backend, init_method=f"file://{store}",
                                rank=rank, world_size=world,
                                timeout=_timeout(timeout_s))
        out = fn(rank, *args)
        results.put((rank, "ok", out))
    except BaseException:  # noqa: BLE001 -- reported to the parent
        results.put((rank, "error", traceback.format_exc()))
    finally:
        if dist.is_initialized():
            dist.destroy_process_group()


def spawn(fn: Callable, nprocs: int, args: tuple = (), *, store_dir: str,
          backend: str = "gloo", timeout_s: float = 600.0) -> List[Any]:
    """Run ``fn(rank, *args)`` in ``nprocs`` fresh processes joined in one
    world (a ``FileStore`` under ``store_dir``, so concurrent worlds never
    share a port) -> the ranks' return values in rank order.  ``fn`` must be
    importable by name and its values picklable.  A rank that raises, or a
    world that outlives ``timeout_s``, kills every rank and raises."""
    import torch.multiprocessing as mp
    os.makedirs(store_dir, exist_ok=True)
    store = os.path.join(store_dir, f"store.{os.getpid()}.{time.time_ns()}")
    ctx = mp.get_context("spawn")
    results = ctx.Queue()
    procs = [ctx.Process(target=_child,
                         args=(r, nprocs, store, backend, timeout_s, fn,
                               tuple(args), results), daemon=False)
             for r in range(nprocs)]
    for p in procs:
        p.start()
    got, errors = {}, []
    deadline = time.monotonic() + timeout_s
    try:
        while len(got) + len(errors) < nprocs:
            left = deadline - time.monotonic()
            if left <= 0:
                raise TimeoutError(f"{nprocs} ranks did not finish within "
                                   f"{timeout_s} s")
            try:
                rank, status, out = results.get(timeout=min(left, 1.0))
            except queue_lib.Empty:
                dead = [p for p in procs if p.exitcode not in (None, 0)]
                if dead and results.empty():
                    raise RuntimeError(
                        f"rank processes exited with codes "
                        f"{[p.exitcode for p in procs]} before reporting")
                continue
            if status == "ok":
                got[rank] = out
            else:
                errors.append(f"rank {rank}:\n{out}")
                break
        if errors:
            raise RuntimeError("a rank failed:\n" + "\n".join(errors))
        for p in procs:
            p.join(timeout=max(1.0, deadline - time.monotonic()))
        return [got[r] for r in range(nprocs)]
    finally:
        for p in procs:
            if p.is_alive():
                p.kill()
            p.join(timeout=10)
        try:
            os.remove(store)
        except OSError:
            pass
