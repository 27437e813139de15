"""K3 and K4: the flash-attention forward kernels and their plain versions.

``flash_fwd_cuda`` wraps ``csrc/flash_fwd.cu``, which replaces the Pallas
TPU kernel ``repro.kernels.flashattn.kernel.flash_fwd``; and
``flash_fwd_packed_cuda`` wraps ``csrc/flash_fwd_packed.cu``, which
replaces ``flash_fwd_packed``.  Both compute causal / windowed GQA
attention with an online softmax in f32:

    O[b, i, h] = sum_j softmax_j(q_i . k_j * scale) v_j,  j in J(i)

over the keys ``j < Sk + pad_k`` that the masks leave to query row ``i``
(absolute position ``q_offset + i``): ``j <= q_offset + i`` when causal,
``j > q_offset + i - window`` with a window.  Keys ``Sk .. Sk + pad_k - 1``
are zero rows: they stand for the reference wrapper's padding of K/V to
its block, which ``ops`` passes on as ``pad_k`` instead of copying.
Masked scores take the finite ``NEG_INF = -1e30`` (a fully masked tile is
wiped later by ``alpha = 0``; ``-inf`` would give NaN), and the output is
``acc / max(l, 1e-30)``, as in the reference.

Layouts are the public ones, so nothing is transposed or gathered: q and
out (B, Sq, H, D); K3's k/v (B, Sk, KV, D); K4's planes (P, B, Sk, KV,
packed_d) uint8 and scale/zero (B, Sk, KV) bf16, the cache leaf layout of
``nn.kvcache.pack_kv``.  Query head h reads KV head ``h // (H // KV)``.

K4 reads K and V as unsigned k-bit digit planes with a per-(token, head)
affine grid and never forms dequantized K/V:

    score = s_k * (q . code_k) + z_k * sum(q)
    PV    = sum_j (p_j s_v,j) code_v,j + sum_j p_j z_v,j

The plain versions ``flash_fwd_torch`` / ``flash_fwd_packed_torch``
compute the same functions with a materialized softmax in f32 on any
device (TF32 must be off on a card, PyTorch's default).  The CPU tests hold
them against the JAX package; ``chip_smoke.py`` holds each kernel against
its plain version on the card.  The wrappers check device, dtype, shape
and contiguity and raise on anything the kernel does not take; the
launch counters are ``flash_fwd_cuda.launches`` and
``flash_fwd_packed_cuda.launches``.
"""
from __future__ import annotations

import ctypes
import functools
from typing import Optional

import torch
import torch.nn.functional as F

from repro_torch.core.packing import _unpack_bits
from repro_torch.kernels import _build
from repro_torch.kernels.mpmm.kernel import check_operand, ptr, raise_on_error

__all__ = ["NEG_INF", "HEAD_DIMS", "PACKED_HEAD_DIMS", "flash_fwd_cuda", "flash_fwd_torch",
           "flash_fwd_packed_cuda", "flash_fwd_packed_torch"]

NEG_INF = -1e30
HEAD_DIMS = (64, 128, 192, 256)  # head_dim values K3 is built for
PACKED_HEAD_DIMS = (64, 128, 192)  # and K4
BF16_ONLY_DIMS = (192, 256)  # too wide for an f32 q tile in shared memory
IO_DTYPES = (torch.float32, torch.bfloat16)


# --- plain versions -----------------------------------------------------------


def _mask(sq: int, sk: int, *, causal: bool, window: Optional[int],
          q_offset: int, device) -> torch.Tensor:
    q_pos = q_offset + torch.arange(sq, device=device)
    kv_pos = torch.arange(sk, device=device)
    mask = torch.ones((sq, sk), dtype=torch.bool, device=device)
    if causal:
        mask &= kv_pos[None, :] <= q_pos[:, None]
    if window is not None:
        mask &= kv_pos[None, :] > q_pos[:, None] - window
    return mask


def _softmax_rows(s: torch.Tensor, mask: torch.Tensor):
    """Masked scores (..., Sq, Sk) -> (p unnormalized, l row sums)."""
    s = torch.where(mask, s, torch.full_like(s, NEG_INF))
    p = torch.exp(s - s.amax(dim=-1, keepdim=True))
    return p, p.sum(dim=-1)


def _finish(pv: torch.Tensor, l: torch.Tensor, out_shape, dtype):
    """pv (B, KV, G, Sq, D) / max(l, 1e-30) -> (B, Sq, H, D) in ``dtype``."""
    o = pv / torch.clamp_min(l, 1e-30)[..., None]
    return o.permute(0, 3, 1, 2, 4).reshape(out_shape).to(dtype)


def flash_fwd_torch(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, *,
                    causal: bool = True, window: Optional[int] = None,
                    q_offset: int = 0, softmax_scale: Optional[float] = None,
                    pad_k: int = 0) -> torch.Tensor:
    """Plain version of K3: q (B, Sq, H, D), k/v (B, Sk, KV, D) -> like q."""
    b, sq, h, d = q.shape
    kvh = k.shape[2]
    scale = softmax_scale if softmax_scale is not None else d ** -0.5
    qf = (q.to(torch.float32) * scale).reshape(b, sq, kvh, h // kvh, d)
    kf = F.pad(k.to(torch.float32), (0, 0, 0, 0, 0, pad_k))
    vf = F.pad(v.to(torch.float32), (0, 0, 0, 0, 0, pad_k))
    s = torch.einsum("bqkgd,bskd->bkgqs", qf, kf)
    p, l = _softmax_rows(s, _mask(sq, kf.shape[1], causal=causal,
                                  window=window, q_offset=q_offset,
                                  device=q.device))
    pv = torch.einsum("bkgqs,bskd->bkgqd", p, vf)
    return _finish(pv, l, q.shape, q.dtype)


def _codes(planes: torch.Tensor, k_slice: int, d: int) -> torch.Tensor:
    """Digit planes (P, B, S, KV, packed_d) -> unsigned codes (B, S, KV, D)
    as f32 (exact: codes are below 2^8)."""
    digits = _unpack_bits(planes, k_slice, d, axis=-1)
    codes = digits[0]
    for p in range(1, digits.shape[0]):
        codes = codes | (digits[p] << (k_slice * p))
    return codes.to(torch.float32)


def _per_row(t: torch.Tensor, pad_k: int) -> torch.Tensor:
    """Scale or zero (B, Sk, KV) -> f32 (B, KV, 1, 1, Sk + pad_k)."""
    t = F.pad(t.to(torch.float32), (0, 0, 0, pad_k))
    return t.permute(0, 2, 1)[:, :, None, None, :]


def flash_fwd_packed_torch(q: torch.Tensor, kp: torch.Tensor,
                           ks: torch.Tensor, kz: torch.Tensor,
                           vp: torch.Tensor, vs: torch.Tensor,
                           vz: torch.Tensor, *, k_slice: int, v_slice: int,
                           causal: bool = True, window: Optional[int] = None,
                           q_offset: int = 0,
                           softmax_scale: Optional[float] = None,
                           pad_k: int = 0) -> torch.Tensor:
    """Plain version of K4 on the cache leaf layout -> like q."""
    b, sq, h, d = q.shape
    kvh = ks.shape[2]
    scale = softmax_scale if softmax_scale is not None else d ** -0.5
    qf = (q.to(torch.float32) * scale).reshape(b, sq, kvh, h // kvh, d)
    kc = F.pad(_codes(kp, k_slice, d), (0, 0, 0, 0, 0, pad_k))
    vc = F.pad(_codes(vp, v_slice, d), (0, 0, 0, 0, 0, pad_k))
    q_sum = qf.sum(dim=-1).permute(0, 2, 3, 1)[..., None]  # (B, KV, G, Sq, 1)
    s = (torch.einsum("bqkgd,bskd->bkgqs", qf, kc) * _per_row(ks, pad_k)
         + q_sum * _per_row(kz, pad_k))
    p, l = _softmax_rows(s, _mask(sq, kc.shape[1], causal=causal,
                                  window=window, q_offset=q_offset,
                                  device=q.device))
    pv = (torch.einsum("bkgqs,bskd->bkgqd", p * _per_row(vs, pad_k), vc)
          + (p * _per_row(vz, pad_k)).sum(dim=-1, keepdim=True))
    return _finish(pv, l, q.shape, q.dtype)


# --- CUDA wrappers ------------------------------------------------------------


def _check_attention(q: torch.Tensor, kvh: int, sk: int, window, q_offset,
                     pad_k, head_dims=HEAD_DIMS) -> torch.device:
    device = q.device
    if device.type != "cuda":
        raise ValueError(f"the CUDA kernel needs CUDA tensors, got {device}; "
                         f"use impl='torch' (or 'auto') for CPU tensors")
    check_operand("q", q, device, IO_DTYPES)
    if q.ndim != 4:
        raise ValueError(f"q must be (B, Sq, H, D), got {tuple(q.shape)}")
    h, d = q.shape[2], q.shape[3]
    if d not in head_dims:
        raise ValueError(f"head_dim {d} not in the kernel's {head_dims}")
    if d in BF16_ONLY_DIMS and q.dtype != torch.bfloat16:
        raise TypeError(f"head_dim {d} takes bf16 q/k/v only, got {q.dtype}")
    if kvh < 1 or h % kvh:
        raise ValueError(f"{kvh} KV heads do not divide {h} query heads")
    if window is not None and window < 1:
        raise ValueError(f"window must be >= 1, got {window}")
    if q_offset < 0 or pad_k < 0 or sk < 1:
        raise ValueError(f"need q_offset >= 0, pad_k >= 0 and Sk >= 1; got "
                         f"{q_offset}, {pad_k}, {sk}")
    return device


def _check_aligned(**tensors: torch.Tensor) -> None:
    """The kernels copy rows in 16-byte chunks (cp.async)."""
    for name, t in tensors.items():
        if t.data_ptr() % 16:
            raise ValueError(f"{name} must start on a 16-byte boundary")


def _scale(softmax_scale: Optional[float], d: int) -> float:
    return softmax_scale if softmax_scale is not None else d ** -0.5


@functools.cache
def _launcher_fwd():
    fn = _build.load("flash_fwd").flash_fwd_launch
    fn.argtypes = ([ctypes.c_void_p] * 4 + [ctypes.c_int] * 10
                   + [ctypes.c_float, ctypes.c_int, ctypes.c_void_p])
    fn.restype = ctypes.c_int
    return fn


def flash_fwd_cuda(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, *,
                   causal: bool = True, window: Optional[int] = None,
                   q_offset: int = 0, softmax_scale: Optional[float] = None,
                   pad_k: int = 0) -> torch.Tensor:
    """Launch K3 on CUDA tensors: q (B, Sq, H, D), k/v (B, Sk, KV, D) of
    q's dtype (f32 or bf16; bf16 only at D 192 and 256), D in
    ``HEAD_DIMS`` -> (B, Sq, H, D)."""
    b, sq, h, d = q.shape
    sk, kvh = k.shape[1], k.shape[2]
    device = _check_attention(q, kvh, sk, window, q_offset, pad_k)
    for name, t in (("k", k), ("v", v)):
        check_operand(name, t, device, (q.dtype,), (b, sk, kvh, d))
    _check_aligned(q=q, k=k, v=v)
    out = torch.empty_like(q)
    if out.numel() == 0:
        return out
    with torch.cuda.device(device):
        stream = torch.cuda.current_stream(device).cuda_stream
        err = _launcher_fwd()(
            ptr(q), ptr(k), ptr(v), ptr(out), b, h, kvh, sq, sk, sk + pad_k,
            d, q_offset, int(causal), window or 0, _scale(softmax_scale, d),
            int(q.dtype == torch.bfloat16), stream)
    raise_on_error("flash_fwd_cuda", err)
    flash_fwd_cuda.launches += 1
    return out


flash_fwd_cuda.launches = 0


@functools.cache
def _launcher_packed():
    fn = _build.load("flash_fwd_packed").flash_fwd_packed_launch
    fn.argtypes = ([ctypes.c_void_p] * 8 + [ctypes.c_int] * 14
                   + [ctypes.c_float, ctypes.c_int, ctypes.c_void_p])
    fn.restype = ctypes.c_int
    return fn


def flash_fwd_packed_cuda(q: torch.Tensor, kp: torch.Tensor,
                          ks: torch.Tensor, kz: torch.Tensor,
                          vp: torch.Tensor, vs: torch.Tensor,
                          vz: torch.Tensor, *, k_slice: int, v_slice: int,
                          causal: bool = True, window: Optional[int] = None,
                          q_offset: int = 0,
                          softmax_scale: Optional[float] = None,
                          pad_k: int = 0) -> torch.Tensor:
    """Launch K4 on CUDA tensors: q (B, Sq, H, D) f32 or bf16 (bf16 only
    at D 192), D in ``PACKED_HEAD_DIMS``; planes
    (P, B, Sk, KV, ceil(D / (8 // slice))) uint8; scale/zero (B, Sk, KV)
    bf16 -> (B, Sq, H, D) of q's dtype."""
    b, sq, h, d = q.shape
    sk, kvh = ks.shape[1], ks.shape[2]
    device = _check_attention(q, kvh, sk, window, q_offset, pad_k,
                              PACKED_HEAD_DIMS)
    for name, planes, sl in (("kp", kp, k_slice), ("vp", vp, v_slice)):
        if sl not in (1, 2, 4, 8):
            raise ValueError(f"{name}: digit slice {sl} must divide 8")
        check_operand(name, planes, device, (torch.uint8,),
                      (planes.shape[0], b, sk, kvh, -(-d // (8 // sl))))
        if not 1 <= planes.shape[0] * sl <= 8:
            raise ValueError(f"{name}: {planes.shape[0]} planes of {sl} bits "
                             f"exceed 8-bit codes")
    for name, t in (("ks", ks), ("kz", kz), ("vs", vs), ("vz", vz)):
        check_operand(name, t, device, (torch.bfloat16,), (b, sk, kvh))
    _check_aligned(q=q, kp=kp, vp=vp)
    out = torch.empty_like(q)
    if out.numel() == 0:
        return out
    with torch.cuda.device(device):
        stream = torch.cuda.current_stream(device).cuda_stream
        err = _launcher_packed()(
            ptr(q), ptr(kp), ptr(ks), ptr(kz), ptr(vp), ptr(vs), ptr(vz),
            ptr(out), b, h, kvh, sq, sk, sk + pad_k, d, kp.shape[0], k_slice,
            vp.shape[0], v_slice, q_offset, int(causal), window or 0,
            _scale(softmax_scale, d), int(q.dtype == torch.bfloat16), stream)
    raise_on_error("flash_fwd_packed_cuda", err)
    flash_fwd_packed_cuda.launches += 1
    return out


flash_fwd_packed_cuda.launches = 0
