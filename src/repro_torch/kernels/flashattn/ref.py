"""Materialized-softmax oracles for flash attention (port of
``repro.kernels.flashattn.ref``).

Everything runs in f32 on the device of its inputs; the f32 products need
``torch.backends.cuda.matmul.allow_tf32 = False`` on a card (PyTorch's
default), or TF32 would keep only about three decimal digits.
"""
from __future__ import annotations

from typing import Optional

import torch

from repro_torch.nn import kvcache

__all__ = ["NEG_INF", "attention_ref", "attention_qdq_ref",
           "attention_packed_ref", "expand_kv_heads"]

NEG_INF = -1e30


def attention_ref(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, *,
                  causal: bool = True, window: Optional[int] = None,
                  q_offset: int = 0,
                  softmax_scale: Optional[float] = None) -> torch.Tensor:
    """q (B, Sq, H, D), k/v (B, Sk, H, D) -> (B, Sq, H, D) in q's dtype."""
    _, sq, _, d = q.shape
    sk = k.shape[1]
    scale = softmax_scale if softmax_scale is not None else d ** -0.5
    s = torch.einsum("bqhd,bkhd->bhqk", q.to(torch.float32) * scale,
                     k.to(torch.float32))
    q_pos = q_offset + torch.arange(sq, device=q.device)
    kv_pos = torch.arange(sk, device=q.device)
    mask = torch.ones((sq, sk), dtype=torch.bool, device=q.device)
    if causal:
        mask &= kv_pos[None, :] <= q_pos[:, None]
    if window is not None:
        mask &= kv_pos[None, :] > q_pos[:, None] - window
    s = torch.where(mask[None, None], s, torch.full_like(s, NEG_INF))
    p = torch.softmax(s, dim=-1)
    o = torch.einsum("bhqk,bkhd->bqhd", p, v.to(torch.float32))
    return o.to(q.dtype)


def expand_kv_heads(x: torch.Tensor, h: int, axis: int = 2) -> torch.Tensor:
    """Repeat each KV head over its group of ``h // KV`` query heads."""
    kvh = x.shape[axis]
    if kvh == h:
        return x
    return torch.repeat_interleave(x, h // kvh, dim=axis)


def attention_qdq_ref(q, k, v, fmt_k, fmt_v, *, causal: bool = True,
                      window: Optional[int] = None, q_offset: int = 0,
                      softmax_scale: Optional[float] = None) -> torch.Tensor:
    """What a low-bit cache means: K/V through ``qdq_kv`` (a None format
    keeps that tensor), then ``attention_ref`` on the bf16 values.
    k/v are (B, Sk, KV, D)."""
    kd = kvcache.qdq_kv(k, fmt_k) if fmt_k is not None else k
    vd = kvcache.qdq_kv(v, fmt_v) if fmt_v is not None else v
    h = q.shape[2]
    return attention_ref(q, expand_kv_heads(kd, h), expand_kv_heads(vd, h),
                         causal=causal, window=window, q_offset=q_offset,
                         softmax_scale=softmax_scale)


def attention_packed_ref(q, kq, vq, fmt_k, fmt_v, *, causal: bool = True,
                         window: Optional[int] = None, q_offset: int = 0,
                         softmax_scale: Optional[float] = None) -> torch.Tensor:
    """Packed leaves -> ``unpack_kv`` (bitwise ``qdq_kv``) -> the
    materialized reference."""
    kd = kvcache.unpack_kv(kq, fmt_k)
    vd = kvcache.unpack_kv(vq, fmt_v)
    h = q.shape[2]
    return attention_ref(q, expand_kv_heads(kd, h), expand_kv_heads(vd, h),
                         causal=causal, window=window, q_offset=q_offset,
                         softmax_scale=softmax_scale)
