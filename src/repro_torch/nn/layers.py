"""Common layers (port of ``repro.nn.layers``): norms, the embedding and its
int8 serve form, rotary position embeddings and the MLP activations.

Norms and rotary run in f32 and cast back to the input's dtype, as in the
JAX package.  ``rsqrt``, ``sin``/``cos`` and ``silu`` are not bitwise equal
between the two frameworks, so the LM is held to the JAX package by
tolerance.  The causal depthwise conv of the SSM and RG-LRU blocks keeps
the reference's two forms: the prefill's four bf16 multiply-adds in order,
and the decode step's one bf16 product-sum over the window.

Under autograd three pieces take the JAX package's gradient rather than
torch's: ``gelu`` (its primitives' transposes in bf16, ``_Gelu``),
``softplus`` (``jax.nn.softplus``'s derivative, exp(x - softplus(x)))
and the conv's taps and bias, whose gradients are bf16 sums over (B, S)
added in the order XLA's CPU compiler adds them (``xla_sum``); torch
adds a bf16 sum in f32 and rounds once, and 75-85% of those gradients'
elements come out different.
"""
from __future__ import annotations

import dataclasses
from typing import Dict, Tuple

import torch
import torch.nn.functional as F

from repro_torch.core import quant
from repro_torch.core.precision import PrecisionPolicy
from repro_torch.launch import mesh as mesh_lib
from repro_torch.nn.param import ParamSpec

__all__ = [
    "rmsnorm_spec", "rmsnorm_apply",
    "layernorm_spec", "layernorm_apply",
    "pad_vocab", "embed_spec", "embed_apply", "VocabShard",
    "embed_serve_spec",
    "embed_serve_apply",
    "pack_embed",
    "rotary_cache", "apply_rotary",
    "squared_relu", "swiglu_combine", "gelu", "softplus",
    "conv1d_spec", "causal_conv1d", "causal_conv1d_step", "xla_sum",
]


def rmsnorm_spec(dim: int) -> Dict[str, ParamSpec]:
    return {"scale": ParamSpec(shape=(dim,), axes=("act_embed",),
                               init="ones")}


def _mean_square(xf: torch.Tensor) -> torch.Tensor:
    """Mean of squares over the last axis, keeping it.  On a CUDA device
    the sum runs in two stages of fixed shape (32 partial sums a row, then
    their sum): torch's reduction kernel lays its threads out by the
    number of rows, so one stage would round a row differently in a call
    of 8 rows than of 4 or 20, and a row must give the same bits whatever
    the batch (a speculative verify's B*T rows against a decode step's B,
    a request alone or coalesced).  On the CPU ``torch.mean`` already sums
    each row alone."""
    d = xf.shape[-1]
    sq = xf * xf
    if not xf.is_cuda or d % 32:
        return torch.mean(sq, dim=-1, keepdim=True)
    part = sq.reshape(*sq.shape[:-1], 32, d // 32).sum(dim=-1)
    return part.sum(dim=-1, keepdim=True) / d


def rmsnorm_apply(p, x: torch.Tensor, eps: float = 1e-6) -> torch.Tensor:
    xf = x.to(torch.float32)
    var = _mean_square(xf)
    y = xf * torch.rsqrt(var + eps) * p["scale"].to(torch.float32)
    return y.to(x.dtype)


def layernorm_spec(dim: int) -> Dict[str, ParamSpec]:
    return {"scale": ParamSpec(shape=(dim,), axes=("act_embed",),
                               init="ones"),
            "bias": ParamSpec(shape=(dim,), axes=("act_embed",),
                              init="zeros")}


def layernorm_apply(p, x: torch.Tensor, eps: float = 1e-5) -> torch.Tensor:
    xf = x.to(torch.float32)
    mu = torch.mean(xf, dim=-1, keepdim=True)
    var = torch.var(xf, dim=-1, keepdim=True, unbiased=False)
    y = (xf - mu) * torch.rsqrt(var + eps)
    y = y * p["scale"].to(torch.float32) + p["bias"].to(torch.float32)
    return y.to(x.dtype)


# --- embeddings -----------------------------------------------------------------


def pad_vocab(v: int, mult: int = 256) -> int:
    """The embedding table's vocab padded to a multiple of ``mult``; logits
    are cut back to the true vocab at the head."""
    return -(-v // mult) * mult


def embed_spec(vocab: int, dim: int) -> Dict[str, ParamSpec]:
    return {"table": ParamSpec(shape=(vocab, dim), axes=("vocab", "embed"),
                               init="embed")}


def embed_apply(p, ids: torch.Tensor, mesh=None) -> torch.Tensor:
    """The float table's rows in bf16 (the QAT forward; the table is not
    quantized in training).  ``mesh``: the table is this rank's block of
    the (padded) vocabulary's rows on the mesh's 'model' axis: the rank
    looks up the ids in its block, zeros elsewhere, and the rows are taken
    from their owning rank (``launch.mesh.owned_model``: the one-device
    rows exactly); the backward adds into the rank's own rows only."""
    r, m = mesh_lib.model_coords(mesh)
    if m == 1:
        return F.embedding(ids, p["table"]).to(torch.bfloat16)
    rows = p["table"].shape[0]
    local = ids - r * rows
    hit = (local >= 0) & (local < rows)
    got = F.embedding(local.clamp(0, rows - 1),
                      p["table"]).to(torch.bfloat16)
    got = torch.where(hit[..., None], got, torch.zeros_like(got))
    return mesh_lib.owned_model(mesh, got,
                                torch.div(ids, rows,
                                          rounding_mode="floor")[..., None])


@dataclasses.dataclass(frozen=True)
class VocabShard:
    """A tensor-parallel rank's block of logits over a vocabulary split on
    the mesh's 'model' axis (the training head, the ResNet classifier):
    ``logits`` (..., n) are columns ``[start, start + n)`` of the whole,
    whose first ``vocab`` columns are real (the rest the table's padding,
    ``pad_vocab``).  The vocabulary-parallel loss
    (``launch.steps.cross_entropy``) takes it as it is."""

    logits: torch.Tensor
    mesh: object
    start: int
    vocab: int


def embed_serve_spec(vocab: int, dim: int,
                     policy: PrecisionPolicy) -> Dict[str, ParamSpec]:
    """Boundary class: int8 codes and a per-tensor step."""
    if not policy.quantize:
        return {"table": ParamSpec(shape=(vocab, dim), dtype=torch.bfloat16,
                                   axes=("vocab", "embed"), init="embed")}
    return {"codes": ParamSpec(shape=(vocab, dim), dtype=torch.int8,
                               axes=("vocab", "embed"), init="zeros"),
            "gamma": ParamSpec(shape=(), axes=(), init="constant",
                               const=0.02)}


def embed_serve_apply(p, ids: torch.Tensor, compute_dtype=torch.bfloat16,
                      mesh=None) -> torch.Tensor:
    """The int8 codes of ``ids`` times the step, in ``compute_dtype``.  On
    a mesh whose 'model' axis is above 1 the rank holds a block of the
    (padded) vocabulary's rows: it looks up the ids in its block, zeros
    elsewhere, and the codes are summed over 'model' as int32 -- one
    addend is nonzero, so every rank gets the one-device codes exactly.
    The fp baseline's bf16 table is looked up the same way, its rows' bit
    patterns (int16, widened) summed as int32: the owner's bits, exactly."""
    r, m = mesh_lib.model_coords(mesh)
    key = "table" if "table" in p else "codes"
    if m > 1:
        rows = p[key].shape[0]
        local = ids - r * rows
        hit = (local >= 0) & (local < rows)
        got = p[key][local.clamp(0, rows - 1)]
        if key == "table":
            got = got.to(torch.bfloat16).view(torch.int16)
        got = mesh_lib.all_reduce_model(
            mesh, torch.where(hit[..., None], got.to(torch.int32), 0))
        if key == "table":
            return got.to(torch.int16).view(torch.bfloat16).to(compute_dtype)
        codes = got
    elif key == "table":
        return p["table"][ids].to(compute_dtype)
    else:
        codes = p["codes"][ids]
    return (codes.to(torch.float32) * p["gamma"]).to(compute_dtype)


def pack_embed(p, policy: PrecisionPolicy):
    """Float table -> int8 codes and the LSQ-initialized step."""
    if not policy.quantize:
        return {"table": p["table"].to(torch.bfloat16)}
    spec = quant.weight_spec(8)
    table = p["table"].to(torch.float32)
    gamma = quant.init_step_size(table, spec)
    # row slices of about 2^28 values keep the quantize temporaries small
    rows = max(1, (1 << 28) // max(1, table.shape[-1]))
    codes = torch.cat([quant.quantize_int(table[i:i + rows], gamma,
                                          spec).to(torch.int8)
                       for i in range(0, max(table.shape[0], 1), rows)])
    return {"codes": codes, "gamma": gamma}


# --- rotary embeddings ---------------------------------------------------------


def rotary_cache(positions: torch.Tensor, dim: int, base: float = 10000.0
                 ) -> Tuple[torch.Tensor, torch.Tensor]:
    """(sin, cos) of shape positions.shape + (dim / 2,), in f32."""
    exps = torch.arange(0, dim, 2, dtype=torch.float32,
                        device=positions.device) / dim
    inv = 1.0 / torch.pow(torch.tensor(base, dtype=torch.float32,
                                       device=positions.device), exps)
    ang = positions.to(torch.float32)[..., None] * inv
    return torch.sin(ang), torch.cos(ang)


def apply_rotary(x: torch.Tensor, sin: torch.Tensor,
                 cos: torch.Tensor) -> torch.Tensor:
    """x (..., S, H, D); sin/cos (..., S, D/2), broadcast over heads."""
    x1, x2 = torch.chunk(x.to(torch.float32), 2, dim=-1)
    s, c = sin[..., None, :], cos[..., None, :]
    return torch.cat([x1 * c - x2 * s, x2 * c + x1 * s], dim=-1).to(x.dtype)


# --- activations ---------------------------------------------------------------


def squared_relu(x: torch.Tensor) -> torch.Tensor:
    """Nemotron-4's activation: relu(x)^2."""
    r = torch.clamp_min(x, 0)
    return r * r


class _Gelu(torch.autograd.Function):
    """jax.nn.gelu(approximate=True), forward and backward, each operation
    in x's dtype and rounded there as JAX's primitives and their
    transposes round them: x * cdf, cdf = 0.5 (1 + tanh(u)), u = c (x +
    k x^3).  Its gradient is (ct cdf + ct_v) + ct_v k (3 x^2), ct_v = c
    ((a + a t)), a = (x ct 0.5)(1 - t), the three terms of x added in that
    order; torch's backward of the same forward differs in about 59% of
    bf16 gradients."""

    @staticmethod
    def _parts(x):
        c = lambda v: torch.tensor(v, dtype=x.dtype, device=x.device)  # noqa
        t = torch.tanh(c(0.7978845608028654)
                       * (x + c(0.044715) * (x * x * x)))
        return c, t, c(0.5) * (c(1.0) + t)

    @staticmethod
    def forward(ctx, x):
        ctx.save_for_backward(x)
        return x * _Gelu._parts(x)[2]

    @staticmethod
    def backward(ctx, g):
        (x,) = ctx.saved_tensors
        c, t, cdf = _Gelu._parts(x)
        a = ((x * g) * c(0.5)) * (c(1.0) - t)
        ct_v = (a + a * t) * c(0.7978845608028654)
        return ((g * cdf + ct_v)
                + (ct_v * c(0.044715)) * (c(3.0) * (x * x)))


def gelu(x: torch.Tensor) -> torch.Tensor:
    """jax.nn.gelu(approximate=True) as the JAX package computes it: each
    operation in x's dtype and rounded there, the constants rounded to it
    first (``F.gelu`` rounds once from f32 and differs in about half of
    bf16 outputs); its gradient too (``_Gelu``)."""
    return _Gelu.apply(x)


class _Softplus(torch.autograd.Function):
    """jax.nn.softplus, ``logaddexp(x, 0)``: max(x, 0) + log1p(exp(-|x|)),
    and its derivative as ``logaddexp``'s jvp gives it, exp(x - out) (an
    infinite x or out taken as 0).  Torch's own backward of the forward
    would differ at x = 0 (``clamp_min`` passes 1 there) and in the last
    bit elsewhere."""

    @staticmethod
    def forward(ctx, x):
        out = torch.clamp_min(x, 0) + torch.log1p(torch.exp(-x.abs()))
        ctx.save_for_backward(x, out)
        return out

    @staticmethod
    def backward(ctx, g):
        x, out = ctx.saved_tensors
        fin = lambda t: torch.where(t == float("inf"),  # noqa: E731
                                    torch.zeros_like(t), t)
        return g * torch.exp(fin(x) - fin(out))


def softplus(x: torch.Tensor) -> torch.Tensor:
    """jax.nn.softplus: max(x, 0) + log1p(exp(-|x|)), with JAX's
    derivative (``_Softplus``)."""
    return _Softplus.apply(x)


def swiglu_combine(gate: torch.Tensor, up: torch.Tensor) -> torch.Tensor:
    return F.silu(gate.to(torch.float32)).to(gate.dtype) * up



# --- causal depthwise conv (mamba2, recurrentgemma) ----------------------------


def conv1d_spec(channels: int, width: int = 4) -> Dict[str, ParamSpec]:
    return {
        "w": ParamSpec(shape=(width, channels), axes=("conv", "act_embed"),
                       init="normal", fan_in_axes=(0,)),
        "b": ParamSpec(shape=(channels,), axes=("act_embed",), init="zeros"),
    }


# XLA's CPU compiler reduces a dimension longer than this in windows of it
XLA_REDUCE_WINDOW = 32


def _sequential(t: torch.Tensor) -> torch.Tensor:
    """t[0] + t[1] + ... over axis 0, one add at a time in t's dtype."""
    acc = t[0]
    for i in range(1, t.shape[0]):
        acc = acc + t[i]
    return acc


def xla_sum(t: torch.Tensor, dims) -> torch.Tensor:
    """Sum over ``dims`` in t's dtype, added as XLA's CPU compiler adds a
    bf16 reduction (equal to ``jax.lax.reduce`` of bf16 operands):
    where a reduced dimension is longer than XLA_REDUCE_WINDOW, each
    reduced dimension n is cut into windows of min(n, 32) (zero-padded
    'SAME': half the pad low, the rest high), each window's values added
    one at a time in row-major order, and the window sums reduced again
    the same way; else the reduced values are added one at a time in
    row-major order."""
    dims = tuple(sorted(d % t.ndim for d in dims))
    if not any(t.shape[d] > XLA_REDUCE_WINDOW for d in dims):
        rest = [a for a in range(t.ndim) if a not in dims]
        t = t.permute(list(dims) + rest)
        return _sequential(t.reshape((-1,) + t.shape[len(dims):]))
    for d in dims:
        n = t.shape[d]
        pad = (-n) % min(n, XLA_REDUCE_WINDOW)
        if pad:
            lo, hi = list(t.shape), list(t.shape)
            lo[d], hi[d] = pad // 2, pad - pad // 2
            t = torch.cat([t.new_zeros(lo), t, t.new_zeros(hi)], dim=d)
    shape, windows = [], []
    for d, n in enumerate(t.shape):
        if d in dims:
            w = min(n, XLA_REDUCE_WINDOW)
            windows.append(len(shape) + 1)
            shape += [n // w, w]
        else:
            shape.append(n)
    t = t.reshape(shape)
    t = t.permute(windows + [a for a in range(len(shape))
                             if a not in windows])
    return xla_sum(_sequential(t.reshape((-1,) + t.shape[len(windows):])),
                   dims)


class _Broadcast(torch.autograd.Function):
    """A (C,) vector broadcast over the leading axes of ``shape``; its
    gradient is the bf16 sum over them that XLA adds (``xla_sum``)."""

    @staticmethod
    def forward(ctx, v, shape):
        return v.expand(shape)

    @staticmethod
    def backward(ctx, g):
        return xla_sum(g, tuple(range(g.ndim - 1))), None


def causal_conv1d(p, x: torch.Tensor) -> torch.Tensor:
    """x (B, S, C) -> the depthwise causal conv of width W, left-padded:
    W multiply-adds in x's dtype, in tap order, each rounded as the
    reference's unrolled loop rounds them.  Each tap's and the bias's
    gradient is summed over (B, S) as XLA sums the reference's
    (``_Broadcast``)."""
    w = p["w"].to(x.dtype)  # (W, C)
    width, s = w.shape[0], x.shape[1]
    xp = F.pad(x, (0, 0, width - 1, 0))
    out = torch.zeros_like(x)
    for i in range(width):
        out = out + xp[:, i:i + s, :] * _Broadcast.apply(w[i], x.shape)
    return out + _Broadcast.apply(p["b"].to(x.dtype), x.shape)


def causal_conv1d_step(p, cache: torch.Tensor, x_t: torch.Tensor
                       ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Decode step: cache (B, W-1, C) past inputs, x_t (B, C) -> (the
    shifted cache, y (B, C)).  y is the reference's one product-sum over
    the window in f32, rounded once to x's dtype; the sum runs tap by tap
    as elementwise operations, so a row's bits do not depend on the batch
    (a batched product would pick its kernel by the shape on a card)."""
    w = p["w"].to(x_t.dtype)
    window = torch.cat([cache, x_t[:, None, :]], dim=1)  # (B, W, C)
    wf, xf = w.to(torch.float32), window.to(torch.float32)
    acc = xf[:, 0] * wf[0]
    for i in range(1, w.shape[0]):
        acc = acc + xf[:, i] * wf[i]
    y = acc.to(x_t.dtype) + p["b"].to(x_t.dtype)
    return window[:, 1:, :], y
