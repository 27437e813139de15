"""Common layers (port of ``repro.nn.layers``): norms, the embedding and its
int8 serve form, rotary position embeddings and the MLP activations.

Norms and rotary run in f32 and cast back to the input's dtype, as in the
JAX package.  ``rsqrt``, ``sin``/``cos`` and ``silu`` are not bitwise equal
between the two frameworks, so the LM is held to the JAX package by
tolerance.  The causal depthwise conv of the SSM and RG-LRU blocks keeps
the reference's two forms: the prefill's four bf16 multiply-adds in order,
and the decode step's one bf16 product-sum over the window.
"""
from __future__ import annotations

from typing import Dict, Tuple

import torch
import torch.nn.functional as F

from repro_torch.core import quant
from repro_torch.core.precision import PrecisionPolicy
from repro_torch.nn.param import ParamSpec

__all__ = [
    "rmsnorm_spec", "rmsnorm_apply",
    "layernorm_spec", "layernorm_apply",
    "pad_vocab", "embed_spec", "embed_apply", "embed_serve_spec",
    "embed_serve_apply",
    "pack_embed",
    "rotary_cache", "apply_rotary",
    "squared_relu", "swiglu_combine", "gelu", "softplus",
    "conv1d_spec", "causal_conv1d", "causal_conv1d_step",
]


def rmsnorm_spec(dim: int) -> Dict[str, ParamSpec]:
    return {"scale": ParamSpec(shape=(dim,), init="ones")}


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
    return {"scale": ParamSpec(shape=(dim,), init="ones"),
            "bias": ParamSpec(shape=(dim,), init="zeros")}


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
    return {"table": ParamSpec(shape=(vocab, dim), init="embed")}


def embed_apply(p, ids: torch.Tensor) -> torch.Tensor:
    """The float table's rows in bf16 (the QAT forward; the table is not
    quantized in training)."""
    return F.embedding(ids, p["table"]).to(torch.bfloat16)


def embed_serve_spec(vocab: int, dim: int,
                     policy: PrecisionPolicy) -> Dict[str, ParamSpec]:
    """Boundary class: int8 codes and a per-tensor step."""
    if not policy.quantize:
        return {"table": ParamSpec(shape=(vocab, dim), dtype=torch.bfloat16,
                                   init="embed")}
    return {"codes": ParamSpec(shape=(vocab, dim), dtype=torch.int8,
                               init="zeros"),
            "gamma": ParamSpec(shape=(), init="constant", const=0.02)}


def embed_serve_apply(p, ids: torch.Tensor,
                      compute_dtype=torch.bfloat16) -> torch.Tensor:
    if "table" in p:
        return p["table"][ids].to(compute_dtype)
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


def gelu(x: torch.Tensor) -> torch.Tensor:
    """jax.nn.gelu(approximate=True) as the JAX package computes it: each
    operation in x's dtype and rounded there, the constants rounded to it
    first (``F.gelu`` rounds once from f32 and differs in about half of
    bf16 outputs)."""
    c = lambda v: torch.tensor(v, dtype=x.dtype, device=x.device)  # noqa
    inner = x + c(0.044715) * (x * x * x)
    cdf = c(0.5) * (c(1.0) + torch.tanh(c(0.7978845608028654) * inner))
    return x * cdf


def softplus(x: torch.Tensor) -> torch.Tensor:
    """jax.nn.softplus: max(x, 0) + log1p(exp(-|x|))."""
    return torch.clamp_min(x, 0) + torch.log1p(torch.exp(-x.abs()))


def swiglu_combine(gate: torch.Tensor, up: torch.Tensor) -> torch.Tensor:
    return F.silu(gate.to(torch.float32)).to(gate.dtype) * up



# --- causal depthwise conv (mamba2, recurrentgemma) ----------------------------


def conv1d_spec(channels: int, width: int = 4) -> Dict[str, ParamSpec]:
    return {
        "w": ParamSpec(shape=(width, channels), init="normal",
                       fan_in_axes=(0,)),
        "b": ParamSpec(shape=(channels,), init="zeros"),
    }


def causal_conv1d(p, x: torch.Tensor) -> torch.Tensor:
    """x (B, S, C) -> the depthwise causal conv of width W, left-padded:
    W multiply-adds in x's dtype, in tap order, each rounded as the
    reference's unrolled loop rounds them."""
    w = p["w"].to(x.dtype)  # (W, C)
    width, s = w.shape[0], x.shape[1]
    xp = F.pad(x, (0, 0, width - 1, 0))
    out = torch.zeros_like(x)
    for i in range(width):
        out = out + xp[:, i:i + s, :] * w[i]
    return out + p["b"].to(x.dtype)


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
