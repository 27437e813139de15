"""GQA flash attention over K3 / K4 (port of ``repro.kernels.flashattn.ops``).

``flash_attention`` (bf16 or f32 K/V) and ``flash_attention_packed`` (the
packed digit-plane cache leaves of ``nn.kvcache.pack_kv``) keep the
reference wrapper's semantics exactly: the query and key blocks are
``min(block, largest power of two <= S)``; a ragged Sk is padded with zero
rows to a multiple of its block, and then the call is made causal whatever
was asked (the padded rows sit at positions >= Sk and are hidden from every
real query row only by the causal mask).  Nothing is copied here: the padding
goes to the kernel as ``pad_k`` zero rows, a ragged Sq is masked in the
kernel, and GQA is an index in the kernel instead of the reference's gather.

``impl``: 'cuda' launches the kernel (CUDA tensors only), 'torch' runs its
plain version, 'auto' picks 'cuda' for CUDA tensors and 'torch' for CPU ones.
The reference's ``block_q`` changes nothing here (query rows are independent
and a ragged Sq is masked), so it is not taken.
"""
from __future__ import annotations

from typing import Dict, Optional

import torch

from repro_torch.kernels.flashattn import kernel as _kernel

__all__ = ["flash_attention", "flash_attention_packed", "IMPLS"]

IMPLS = ("auto", "cuda", "torch")


def _round_pow2(n: int) -> int:
    p = 1
    while p * 2 <= n:
        p *= 2
    return p


def _pad_k(sk: int, block_k: int) -> int:
    return (-sk) % min(block_k, _round_pow2(sk))


def _use_cuda(impl: str, q: torch.Tensor) -> bool:
    if impl not in IMPLS:
        raise ValueError(f"impl must be one of {IMPLS}, got {impl!r}")
    return impl == "cuda" or (impl == "auto" and q.is_cuda)


def flash_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, *,
                    causal: bool = True, window: Optional[int] = None,
                    q_offset: int = 0, softmax_scale: Optional[float] = None,
                    block_k: int = 256, impl: str = "auto") -> torch.Tensor:
    """q (B, Sq, H, D); k, v (B, Sk, KV, D), KV dividing H -> (B, Sq, H, D)."""
    pad_k = _pad_k(k.shape[1], block_k)
    fn = (_kernel.flash_fwd_cuda if _use_cuda(impl, q)
          else _kernel.flash_fwd_torch)
    return fn(q, k, v, causal=causal or pad_k > 0, window=window,
              q_offset=q_offset, softmax_scale=softmax_scale, pad_k=pad_k)


def flash_attention_packed(q: torch.Tensor, kq: Dict[str, torch.Tensor],
                           vq: Dict[str, torch.Tensor], fmt_k, fmt_v, *,
                           causal: bool = True, window: Optional[int] = None,
                           q_offset: int = 0,
                           softmax_scale: Optional[float] = None,
                           block_k: int = 256,
                           impl: str = "auto") -> torch.Tensor:
    """Flash attention reading K/V straight from packed cache leaves
    ``{"p": (P, B, Sk, KV, pd) uint8, "s"/"z": (B, Sk, KV) bf16}``."""
    d = q.shape[-1]
    if fmt_k.d != d or fmt_v.d != d:
        raise ValueError(f"cache formats {fmt_k}, {fmt_v} vs head_dim {d}")
    sk = kq["s"].shape[1]
    pad_k = _pad_k(sk, block_k)
    fn = (_kernel.flash_fwd_packed_cuda if _use_cuda(impl, q)
          else _kernel.flash_fwd_packed_torch)
    return fn(q, kq["p"], kq["s"], kq["z"], vq["p"], vq["s"], vq["z"],
              k_slice=fmt_k.k, v_slice=fmt_v.k, causal=causal or pad_k > 0,
              window=window, q_offset=q_offset, softmax_scale=softmax_scale,
              pad_k=pad_k)
