"""Step functions (port of ``repro.launch.steps``): the QAT train step and
the serve steps.

Each closes over a ``ModelAPI`` and takes parameters explicitly, as the
JAX package's step functions do for ``jax.jit``; PyTorch runs them
eagerly.  ``make_train_step`` accumulates microbatch gradients in f32, in
order, and divides by their count, as the reference's ``lax.scan`` does;
on a CUDA device a step runs under ``torch.use_deterministic_algorithms``,
so that a restarted run repeats the uninterrupted one bit for bit (the
reference's restart contract).  That needs ``CUBLAS_WORKSPACE_CONFIG``
(``:4096:8``) in the environment before the process first calls cuBLAS:
``launch.train`` sets it, and without it torch raises at the step's first
product, naming the variable.  ``input_specs``, ``input_axes`` and
``batch_rules_for`` describe a cell's inputs and their logical axes for
``nn.partitioning``, and ``train_state_axes`` the train state's.

On a training mesh (``make_train_step(..., mesh=)``, a (data, 1) or (pod,
data, 1) mesh) the state holds each rank's FSDP blocks
(``train_state_shardings``) and the batch each rank's rows; a step gathers
the parameters whole, runs the rank's microbatches, sums the f32
gradients over the batch axes in rank order from zero
(``launch.mesh.all_reduce_batch``) and divides once, clips by the whole
gradients' norm and runs AdamW on the rank's blocks.  M is the global
``api.microbatches`` and n the ranks the batch is split over: where n
divides M rank r runs microbatches r M/n ... (r+1) M/n - 1 (M = n: bitwise
the one-device step; M > n: the f32 sums in another order); where M < n
and n is a multiple of M, each rank runs its B/n rows as one forward and
the sum is divided by n; any other n and M raise.  Where the batch is not
split (``batch_rules_for`` picked no axis) every rank runs the one-device
step on the whole batch.

On a mesh whose 'model' axis is above 1 (tensor-parallel training of the
dense decoders, the ResNets, the MoE archs and whisper) the state holds
each rank's 'model' blocks as well; the step gathers only the FSDP blocks
(over the mesh's other axes), so the forward runs over the rank's shards
(``models.transformer``, ``models.resnet``, ``models.whisper``), its
logits a ``nn.layers.VocabShard`` for the vocabulary-parallel
``cross_entropy``.
Every 'model' rank of a data row runs that row's batch; the clip's norm
sums each shard's squares over 'model' and takes a whole leaf once
(``_model_global_norm``).  The contract is against the one-device step on
the same global batch: the losses before any update and each leaf after
three steps within the bounds ``tests/test_torch_tensor_parallel_train.py``
and ``tests/test_torch_tensor_parallel_train_families.py`` state, whole
leaves bitwise equal across the 'model' ranks.
"""
from __future__ import annotations

import contextlib
from typing import Any, Callable, Dict

import torch

from repro_torch.configs.shapes import ShapeSpec
from repro_torch.launch import mesh as mesh_lib
from repro_torch.nn import layers as nnl
from repro_torch.nn import param as nnp
from repro_torch.nn import partitioning as part
from repro_torch.nn.partitioning import axis_sizes
from repro_torch.optim import (adamw_init, adamw_update, compress_decompress,
                               warmup_cosine)
from repro_torch.optim.adamw import global_norm
from repro_torch.tree import leaves, tree_map, unflatten

__all__ = ["cross_entropy", "deterministic", "value_and_grad",
           "make_train_step", "train_state_specs", "train_state_axes",
           "train_state_shardings", "microbatch_layout",
           "init_train_state",
           "make_prefill_fn", "make_decode_fn", "make_verify_fn",
           "batch_rules_for", "input_specs", "input_axes"]


def cross_entropy(logits, labels: torch.Tensor) -> torch.Tensor:
    """Mean token cross-entropy, in f32 whatever the logits' dtype.

    ``logits`` a ``nn.layers.VocabShard`` (a tensor-parallel rank's
    columns of the vocabulary): vocabulary-parallel, the same loss on
    every 'model' rank -- the max over the shards (exact), the f32 sums of
    exp gathered and added in rank order, the label's logit taken from
    the rank that owns it; columns past the real vocabulary (the table's
    padding) enter neither the max nor the sum, as one device's
    ``[:vocab]`` cut leaves them out.  Its backward is softmax - onehot
    over the rank's own columns (zero on the padding)."""
    if isinstance(logits, nnl.VocabShard):
        return _VocabParallelCE.apply(logits.logits, labels, logits.mesh,
                                      logits.start, logits.vocab)
    lf = logits.to(torch.float32)
    lse = torch.logsumexp(lf, dim=-1)
    ll = torch.gather(lf, -1, labels[..., None].to(torch.long))[..., 0]
    return torch.mean(lse - ll)


class _VocabParallelCE(torch.autograd.Function):
    """``cross_entropy`` over a ``VocabShard`` (its docstring).  The
    forward runs ``launch.mesh``'s collectives (no autograd inside a
    ``Function``); the backward is one device's ``logsumexp`` backward,
    exp(logits - lse) scaled, over the rank's columns, minus the label's
    share on its owner."""

    @staticmethod
    def forward(ctx, logits, labels, mesh, start, vocab):
        n = logits.shape[-1]
        lf = logits.to(torch.float32)
        cols = start + torch.arange(n, device=lf.device)
        lf = lf.masked_fill(cols >= vocab, float("-inf"))
        mx = mesh_lib.gather_model(mesh, lf.amax(dim=-1)[..., None],
                                   -1).amax(dim=-1)
        total = mesh_lib.sum_model(
            mesh, torch.exp(lf - mx[..., None]).sum(dim=-1))
        lse = mx + torch.log(total)
        labels = labels.to(torch.long)
        local = labels - start
        mine = (local >= 0) & (local < n)
        ll = torch.gather(lf, -1, local.clamp(0, n - 1)[..., None])[..., 0]
        ll = mesh_lib.owned_model(
            mesh, torch.where(mine, ll, torch.zeros_like(ll)),
            torch.div(labels, n, rounding_mode="floor"))
        ctx.save_for_backward(lf, lse, local, mine)
        ctx.dtype = logits.dtype
        return torch.mean(lse - ll)

    @staticmethod
    def backward(ctx, g):
        lf, lse, local, mine = ctx.saved_tensors
        c = g / lse.numel()
        grad = torch.exp(lf - lse[..., None]) * c
        hit = torch.where(mine, -c, torch.zeros_like(lse))
        grad.scatter_add_(-1, local.clamp(0, lf.shape[-1] - 1)[..., None],
                          hit[..., None])
        return grad.to(ctx.dtype), None, None, None, None


@contextlib.contextmanager
def deterministic(device: torch.device):
    """On a CUDA device: ``torch.use_deterministic_algorithms(True)`` for
    the block (it raises at an operation that has no deterministic form);
    nothing on the CPU."""
    if device.type != "cuda":
        yield
        return
    prev = (torch.are_deterministic_algorithms_enabled(),
            torch.is_deterministic_algorithms_warn_only_enabled())
    torch.use_deterministic_algorithms(True)
    try:
        yield
    finally:
        torch.use_deterministic_algorithms(prev[0], warn_only=prev[1])


def value_and_grad(loss_fn, params, *args):
    """``loss_fn(params, *args)`` -> (loss, gradient tree): every leaf
    differentiated (a leaf the loss does not reach, such as the CNN stem's
    unused ``ga``, gets zeros, as ``jax.grad`` gives)."""
    ps = leaves(params)
    live = [p.detach().requires_grad_(True) for p in ps]
    loss = loss_fn(unflatten(params, live), *args)
    grads = torch.autograd.grad(loss, live, allow_unused=True)
    return loss.detach(), unflatten(params, [
        g if g is not None else torch.zeros_like(p)
        for g, p in zip(grads, ps)])


def _batch_axes(mesh, rules) -> tuple:
    """The mesh axes of size above 1 that the batch is split over under
    ``rules`` (the 'batch' rule, as ``batch_rules_for`` left it), the
    major one first."""
    spec = part.logical_to_spec(("batch",), rules, mesh)
    names = () if not spec else (
        (spec[0],) if isinstance(spec[0], str) else tuple(spec[0]))
    sizes = axis_sizes(mesh)
    return tuple(ax for ax in names if sizes[ax] > 1)


def microbatch_layout(rows: int, microbatches: int, n: int):
    """(microbatches a rank runs, microbatches summed in all) of a global
    batch of ``rows`` in ``microbatches`` over ``n`` batch ranks: M/n of
    M where n divides M, one of n where M < n and n is a multiple of M.
    Any other layout raises, naming B, M and n."""
    m = max(microbatches, 1)
    if n == 1 or m % n == 0:
        k, total = m // n, m
    elif n % m == 0:
        k, total = 1, n
    else:
        raise ValueError(
            f"a global batch of B = {rows} rows in M = {m} microbatches "
            f"does not lay out over n = {n} batch ranks: n must divide M, "
            f"or be a multiple of it")
    if rows % (n * k):
        raise ValueError(f"a global batch of B = {rows} rows does not split "
                         f"into {n * k} equal blocks (M = {m} microbatches "
                         f"over n = {n} batch ranks)")
    return k, total


def _sum_over_batch(mesh, grads, axes, total):
    """The gradients summed over the batch ranks (f32, from zero, in rank
    order: ``launch.mesh.all_reduce_batch``) and divided by ``total``.
    Consecutive leaves go as one flat f32 tensor of at most
    ``nn.partitioning.BUCKET_BYTES`` or the largest leaf (the sum is
    elementwise, so the bits are a leaf's own); each rank's own gradients
    are freed as their sums replace them."""
    flat = leaves(grads)
    sizes = [g.numel() for g in flat]
    for group in part.bucket(sizes, max(max(sizes),
                                        part.BUCKET_BYTES // 4)):
        parts = [flat[i].to(torch.float32).reshape(-1) for i in group]
        shapes = [flat[i].shape for i in group]
        for i in group:
            flat[i] = None
        summed = mesh_lib.all_reduce_batch(
            mesh, parts[0] if len(parts) == 1 else torch.cat(parts),
            axes).div_(total)
        del parts
        off = 0
        for i, shape in zip(group, shapes):
            n = sizes[i]
            flat[i] = summed[off:off + n].view(shape)
            off += n
    return unflatten(grads, flat)


def _model_global_norm(mesh, grads, shardings) -> torch.Tensor:
    """``global_norm`` of gradients whose leaves a tensor-parallel rank
    holds as 'model' shards or whole: each leaf's f32 sum of squares, a
    shard's summed over the 'model' ranks (``sum_model``, rank order from
    zero), a whole leaf's taken once (not once a rank), the leaves added
    in order from zero -- the same norm, so the same clip, on every
    rank."""
    sq = torch.stack([torch.sum(torch.square(g.to(torch.float32)))
                      for g in leaves(grads)])
    summed = mesh_lib.sum_model(mesh, sq)
    total = 0
    for i, sh in enumerate(leaves(shardings)):
        total = total + (summed[i] if part.is_cut(sh, "model") else sq[i])
    return torch.sqrt(total)


def make_train_step(api, *, peak_lr: float = 3e-4, total_steps: int = 10_000,
                    grad_compression: bool = False,
                    donate: bool = False, mesh=None,
                    rules=None) -> Callable:
    """train_step(state, batch) -> (new state, metrics {loss, lr,
    grad_norm}), with ``api.microbatches``-way gradient accumulation.

    ``batch`` holds tensors on the state's device: ``tokens`` (B, S) and
    ``labels`` (B, S) for an LM, or images (B, H, W, 3) as ``tokens`` and
    labels (B,) for a CNN.  ``grad_compression``: int8 quantize-dequantize
    of the gradients with error feedback carried in ``state["gc"]``.
    ``donate``: AdamW writes the new parameters and moments into
    ``state``'s own tensors (``optim.adamw_update``), as the reference's
    Trainer donates the state to its jitted step; the caller's ``state``
    then holds the new values.

    ``mesh``: a training mesh (``launch.mesh.make_train_mesh``; a 'model'
    axis above 1 trains tensor-parallel, for the families
    ``nn.partitioning.require_train_mesh`` takes).  ``state`` then holds
    the rank's blocks by ``train_state_shardings(api, mesh, rules)``
    (``rules`` default ``TRAIN_RULES``; ``state["gc"]``, when compressing,
    is whole on every rank) and ``batch`` the rank's rows
    (``data.pipeline.SyntheticLM.sharded_batch_at``); the metrics are the
    whole batch's, the same on every rank (see the module's docstring for
    the layout)."""
    mb = max(api.microbatches, 1)
    n, axes, fsdp, tp = 1, (), None, {}
    if mesh is not None:
        part.require_train_mesh(axis_sizes(mesh), api.family)
        rules = part.TRAIN_RULES if rules is None else rules
        axes = _batch_axes(mesh, rules)
        for ax in axes:
            n *= axis_sizes(mesh)[ax]
        param_sh = train_state_shardings(api, mesh, rules)["params"]
        if axis_sizes(mesh).get("model", 1) > 1:
            if grad_compression:
                raise NotImplementedError(
                    "grad_compression on a tensor-parallel mesh: its error "
                    "feedback is kept whole, the gradients are 'model' "
                    "shards; not ported")
            tp = {"mesh": mesh}
            fsdp = tuple(ax for ax in part.axis_names(mesh)
                         if ax != "model")

    def loss_fn(params, tokens, labels, frames):
        kw = {"frames": frames} if api.needs_frames else {}
        logits = api.forward(params, tokens, mode="train", **kw, **tp)
        return cross_entropy(logits, labels)

    def local_grads(params, tokens, labels, frames, k, divide):
        """(losses, gradients) of ``k`` microbatches over these rows:
        summed in f32 from zero in order and divided by ``k`` if
        ``divide``; one microbatch's gradients as they are."""
        if k == 1:
            loss, grads = value_and_grad(loss_fn, params, tokens, labels,
                                         frames)
            return [loss], grads
        n_rows = tokens.shape[0] // k
        grads = tree_map(lambda p: torch.zeros(
            p.shape, dtype=torch.float32, device=p.device), params)
        losses = []
        for i in range(k):
            sl = slice(i * n_rows, (i + 1) * n_rows)
            loss, g = value_and_grad(
                loss_fn, params, tokens[sl], labels[sl],
                frames[sl] if frames is not None else None)
            for acc, gi in zip(leaves(grads), leaves(g)):
                acc.add_(gi.to(torch.float32))
            losses.append(loss)
            del g
        if divide:
            for g in leaves(grads):  # in place: the sums are ours
                g.div_(k)
        return losses, grads

    def train_step(state, batch):
        tokens, labels = batch["tokens"], batch["labels"]
        frames = batch.get("frames")
        k, total = microbatch_layout(tokens.shape[0] * n, mb, n)
        with deterministic(tokens.device):
            params = (state["params"] if mesh is None
                      else part.gather_by(state["params"], param_sh, fsdp))
            losses, grads = local_grads(params, tokens, labels, frames, k,
                                        n == 1)
            del params
            loss = torch.stack(losses)
            if n > 1:
                grads = _sum_over_batch(mesh, grads, axes, total)
                loss = mesh_lib.all_gather_axes(mesh, loss, 0, axes)
            new_state = {}
            if grad_compression:
                grads, new_state["gc"] = compress_decompress(grads,
                                                             state["gc"])
            lr = warmup_cosine(state["step"], peak_lr=peak_lr,
                               total=total_steps)
            norm = (global_norm(grads) if not tp
                    else _model_global_norm(mesh, grads, param_sh))
            if mesh is not None:
                grads = part.shard_by(grads, param_sh, fsdp)
            new_state["params"], new_state["opt"] = adamw_update(
                grads, state["opt"], state["params"], lr=lr, donate=donate,
                norm=norm)
        new_state["step"] = state["step"] + 1
        metrics = {"loss": torch.mean(loss), "lr": lr, "grad_norm": norm}
        return new_state, metrics

    return train_step


def train_state_specs(api) -> Dict[str, Any]:
    """The train state's shapes and dtypes as ``ParamSpec`` leaves (no
    allocation): the template a checkpoint restores into."""
    params = nnp.strip_markers(api.specs("train"))
    mom = lambda t: tree_map(  # noqa: E731
        lambda s: nnp.ParamSpec(shape=s.shape, dtype=api.opt_dtype), t)
    scalar = nnp.ParamSpec(shape=(), dtype=torch.int32)
    return {"params": params,
            "opt": {"m": mom(params), "v": mom(params), "count": scalar},
            "step": scalar}


def train_state_axes(api) -> Dict[str, Any]:
    """The train state's logical axes (the reference's tree): the
    parameters' ``param_axes("train")`` for them and both moments, ``()``
    for the counts."""
    axes = api.param_axes("train")
    return {"params": axes,
            "opt": {"m": axes, "v": axes, "count": ()},
            "step": ()}


def train_state_shardings(api, mesh, rules=None) -> Dict[str, Any]:
    """The train state's ``NamedSharding`` tree on a training mesh under
    ``rules`` (default ``TRAIN_RULES``: FSDP of 'embed' over ('pod',
    'data')), a leaf kept whole where its dimension does not split
    (``nn.partitioning.fit_shardings``)."""
    rules = part.TRAIN_RULES if rules is None else rules
    return part.fit_shardings(
        part.tree_shardings(train_state_axes(api), mesh, rules),
        train_state_specs(api))


def init_train_state(api, generator: torch.Generator, device="cuda"):
    """Random parameters from ``generator`` on ``device`` (CUDA by default;
    raises without a card unless ``device="cpu"``), zero moments in
    ``api.opt_dtype``, step 0."""
    params = api.init_params(generator, "train", device=device)
    return {"params": params,
            "opt": adamw_init(params, state_dtype=api.opt_dtype),
            "step": torch.zeros((), dtype=torch.int32,
                                device=leaves(params)[0].device)}


def _tp(mesh) -> Dict[str, Any]:
    """The model call's ``mesh`` argument: the mesh where its 'model' axis
    is above 1 (tensor-parallel serving), else none (a data-parallel rank
    runs the one-device model over its rows)."""
    if mesh is None or axis_sizes(mesh).get("model", 1) == 1:
        return {}
    return {"mesh": mesh}


def make_prefill_fn(api, *, impl: str = "auto", mesh=None) -> Callable:
    """prefill_fn(params, batch {"tokens": (B, S)[, "frames": (B, T, D)]})
    -> (logits (B, V), prefill cache); the frames go to archs that take
    them (``api.needs_frames``, whisper; zeros when absent).  ``mesh``:
    tensor-parallel over its 'model' axis where that is above 1."""
    tp = _tp(mesh)

    def prefill_fn(params, batch):
        kw = {"frames": batch.get("frames")} if api.needs_frames else {}
        return api.prefill(params, batch["tokens"], impl=impl, **kw, **tp)
    return prefill_fn


def make_decode_fn(api, *, impl: str = "auto", mesh=None) -> Callable:
    """decode_fn(params, cache, tokens (B, 1), length) -> (logits (B, V),
    cache); the cache is updated in place."""
    tp = _tp(mesh)

    def decode_fn(params, cache, tokens, length):
        return api.decode_step(params, cache, tokens, length, impl=impl,
                               **tp)
    return decode_fn


def make_verify_fn(api, *, impl: str = "auto", attn_impl: str = "xla",
                   mesh=None) -> Callable:
    """verify_fn(params, cache, tokens (B, T), length) -> (logits (B, T,
    V), cache): the batched multi-token step speculative decoding verifies
    drafted tokens with (``runtime/specdec.py``)."""
    tp = _tp(mesh)

    def verify_fn(params, cache, tokens, length):
        return api.decode_steps(params, cache, tokens, length, impl=impl,
                                attn_impl=attn_impl, **tp)
    return verify_fn


# --- inputs -------------------------------------------------------------------


def batch_rules_for(rules: Dict, global_batch: int, mesh) -> Dict:
    """Shrink the 'batch' rule until it divides the global batch (the
    long_500k batch=1 cell replicates instead of sharding)."""
    entry = rules.get("batch")
    cand = (entry,) if isinstance(entry, str) else tuple(entry or ())
    sizes = axis_sizes(mesh)
    picked = []
    div = 1
    for ax in cand:
        s = sizes.get(ax)
        if s and global_batch % (div * s) == 0:
            picked.append(ax)
            div *= s
    new = dict(rules)
    new["batch"] = tuple(picked) if picked else None
    return new


def input_specs(api, shape: ShapeSpec) -> Dict[str, Any]:
    """``ParamSpec`` stand-ins (shape and dtype) for every model input of
    this cell; a decode cell's cache is ``api.cache_specs``' tree."""
    b, s = shape.global_batch, shape.seq_len
    i32 = torch.int32
    spec = nnp.ParamSpec
    frames = ({"frames": spec(shape=(b, api.cfg.n_audio, api.cfg.d_model))}
              if api.needs_frames else {})
    if shape.kind == "train":
        return {"tokens": spec(shape=(b, s), dtype=i32),
                "labels": spec(shape=(b, s), dtype=i32), **frames}
    if shape.kind == "prefill":
        return {"tokens": spec(shape=(b, s), dtype=i32), **frames}
    # decode: one new token against a cache of seq_len
    return {"tokens": spec(shape=(b, 1), dtype=i32),
            "cache": api.cache_specs(b, s),
            "length": spec(shape=(), dtype=i32)}


def input_axes(api, shape: ShapeSpec) -> Dict[str, Any]:
    """Logical axes matching ``input_specs``."""
    frames = ({"frames": ("batch", "frames", "act_embed")}
              if api.needs_frames else {})
    if shape.kind == "train":
        return {"tokens": ("batch", "seq"), "labels": ("batch", "seq"),
                **frames}
    if shape.kind == "prefill":
        return {"tokens": ("batch", "seq"), **frames}
    return {"tokens": ("batch", None), "cache": api.cache_axes(),
            "length": ()}
