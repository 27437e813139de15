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
``nn.partitioning``; ``train_state_axes`` waits for multi-device training
(ROADMAP 16b (iii)).
"""
from __future__ import annotations

import contextlib
from typing import Any, Callable, Dict

import torch

from repro_torch.configs.shapes import ShapeSpec

from repro_torch.nn import param as nnp
from repro_torch.nn.partitioning import axis_sizes
from repro_torch.optim import (adamw_init, adamw_update, compress_decompress,
                               warmup_cosine)
from repro_torch.optim.adamw import global_norm
from repro_torch.tree import leaves, tree_map, unflatten

__all__ = ["cross_entropy", "deterministic", "value_and_grad",
           "make_train_step", "train_state_specs", "init_train_state",
           "make_prefill_fn", "make_decode_fn", "make_verify_fn",
           "batch_rules_for", "input_specs", "input_axes"]


def cross_entropy(logits: torch.Tensor, labels: torch.Tensor) -> torch.Tensor:
    """Mean token cross-entropy, in f32 whatever the logits' dtype."""
    lf = logits.to(torch.float32)
    lse = torch.logsumexp(lf, dim=-1)
    ll = torch.gather(lf, -1, labels[..., None].to(torch.long))[..., 0]
    return torch.mean(lse - ll)


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


def make_train_step(api, *, peak_lr: float = 3e-4, total_steps: int = 10_000,
                    grad_compression: bool = False,
                    donate: bool = False) -> Callable:
    """train_step(state, batch) -> (new state, metrics {loss, lr,
    grad_norm}), with ``api.microbatches``-way gradient accumulation.

    ``batch`` holds tensors on the state's device: ``tokens`` (B, S) and
    ``labels`` (B, S) for an LM, or images (B, H, W, 3) as ``tokens`` and
    labels (B,) for a CNN.  ``grad_compression``: int8 quantize-dequantize
    of the gradients with error feedback carried in ``state["gc"]``.
    ``donate``: AdamW writes the new parameters and moments into
    ``state``'s own tensors (``optim.adamw_update``), as the reference's
    Trainer donates the state to its jitted step; the caller's ``state``
    then holds the new values."""
    mb = max(api.microbatches, 1)

    def loss_fn(params, tokens, labels, frames):
        kw = {"frames": frames} if api.needs_frames else {}
        logits = api.forward(params, tokens, mode="train", **kw)
        return cross_entropy(logits, labels)

    def train_step(state, batch):
        params = state["params"]
        tokens, labels = batch["tokens"], batch["labels"]
        frames = batch.get("frames")
        b = tokens.shape[0]
        if b % mb:
            raise ValueError(f"batch {b} is not a multiple of {mb} "
                             f"microbatches")
        with deterministic(tokens.device):
            if mb == 1:
                loss, grads = value_and_grad(loss_fn, params, tokens,
                                              labels, frames)
                losses = [loss]
            else:
                n = b // mb
                grads = tree_map(lambda p: torch.zeros(
                    p.shape, dtype=torch.float32, device=p.device), params)
                losses = []
                for i in range(mb):
                    sl = slice(i * n, (i + 1) * n)
                    loss, g = value_and_grad(
                        loss_fn, params, tokens[sl], labels[sl],
                        frames[sl] if frames is not None else None)
                    for acc, gi in zip(leaves(grads), leaves(g)):
                        acc.add_(gi.to(torch.float32))
                    losses.append(loss)
                    del g
                for g in leaves(grads):  # in place: the sums are ours
                    g.div_(mb)
            new_state = {}
            if grad_compression:
                grads, new_state["gc"] = compress_decompress(grads,
                                                             state["gc"])
            lr = warmup_cosine(state["step"], peak_lr=peak_lr,
                               total=total_steps)
            new_params, new_opt = adamw_update(grads, state["opt"], params,
                                               lr=lr, donate=donate)
            metrics = {"loss": torch.mean(torch.stack(losses)), "lr": lr,
                       "grad_norm": global_norm(grads)}
        new_state.update({"params": new_params, "opt": new_opt,
                          "step": state["step"] + 1})
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
