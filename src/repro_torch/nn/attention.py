"""GQA attention (port of ``repro.nn.attention``).

The QAT training forward is ``gqa_prefill(serve=False)``: fake-quant
projections and ``chunked_attention`` under autograd.  Serve prefill runs
the flash kernels: K4 (``flash_attention_packed``) when the layer's K and V
are both cached in packed digit planes, else K3 (``flash_attention``) on
bf16 K/V -- the fp cache and the 'qdq' store, whose K/V hold the
quantization-grid values.  ``attn_impl='xla'`` keeps the
reference's other route, ``chunked_attention``, a plain online softmax in
torch.  Decode has no kernel in the reference: ``decode_attention`` (fp
cache) and ``decode_attention_streamed`` (kv-quantizing plans, either
store) are plain torch with bf16 operands widened to f32 and f32 products
(TF32 must be off on a card, PyTorch's default).  A packed cache streams in
chunks and is dequantized one chunk at a time, so packed and qdq decode run
the same arithmetic on the same values and agree bitwise.

``impl`` routes every kernel of a call: 'auto' (CUDA tensors to the kernels,
CPU tensors to their plain versions), 'cuda' or 'torch'.  The GQA block is
the causal, rotary one the dense LMs use; ``gqa_verify`` extends the decode
cache by T tokens at once, the verify step of speculative decoding.

MLA (DeepSeek-V2's multi-head latent attention, ``mla_*``) caches one
compressed latent ``c_kv`` (rank ``kv_lora``) and one shared rotary key per
token, and expands them to per-head K and V through the ``uk``/``uv``
projections (K1) at every call -- at decode over the whole ``Smax`` cache,
as the reference does.  Its attention has no kernel in the reference (qk
192 = 128 + 64 against v 128): prefill is ``chunked_attention`` and decode
``decode_attention``, in torch.  On a card the prefill runs one batch row
at a time, so that a row's bits do not depend on the batch (cuBLAS picks
its kernel by the batch count too); decode's products are the fixed-order
form already.  On a tensor-parallel mesh an MLA rank holds its heads'
columns of q, uk and uv and its heads' rows of o, dkv and ``kv_norm``
whole; its latent cache is its ``kv_seq`` block, all-gathered at each
decode step (``mla_verify``).

The GQA block takes the reference's other options: ``causal=False`` and
``rope=False`` (whisper's encoder and decoder), ``window=`` (recurrentgemma's
local attention, on K3 in serve mode with ``attn_impl='flash'`` as the
reference reaches its Pallas kernel there) and ``names=``, the family's map
from projection to plan-layer name (``GQA_NAMES`` by default).

On a data-parallel mesh every rank runs these single-device branches over
its own rows (``runtime.serve``), which is what the reference's
``shard_map``'d flash path computes with batch over 'data'.  With a 'model'
axis above 1 (``mesh=``, tensor-parallel serving of the GQA block) the rank
holds the q columns of its heads ``[r H/M, (r + 1) H/M)``, k and v whole,
and the o rows of its heads.  Prefill runs K3 or K4 over its local heads
with only the KV heads they map to -- the reference's ``(off +
arange(h_l)) // group`` -- so each head's output is the one-device head's,
bitwise (each block of K3/K4 computes one head).  Torch attention
(``attn_impl='xla'``, MLA's prefill, whisper's cross attention) runs at
the one-device shape, the rank's heads zero-padded to all H
(``sharded_heads_attention``).  The decode cache holds the rank's block
of the sequence (``kv_seq`` over 'model'): a new position is written on
the rank that owns it, and decode is split-sequence: q of every head is
all-gathered, each rank scores its own positions (its K block never
moves), the scores and the V blocks are all-gathered, and every rank runs
the one-device decode routine from the scores on over the whole row,
then keeps its heads for o.  Decode outputs are the one-device outputs
bitwise wherever the cache length (rounded up to a multiple of the model
axis) is the one-device length.  recurrentgemma's ring buffer splits the
same way by slots (``ring_decode_attention``): the scores and V blocks,
gathered in slot order, are the whole ring, masked by its slot count.
An online fold of per-rank softmax partials would move no V but adds the
value sums in another order: its ulp-level differences flipped a token
of the full-width granite-8b on the card.
"""
from __future__ import annotations

from typing import Dict, Optional

import torch

from repro_torch.kernels.flashattn import ops as flash_ops
from repro_torch.launch import mesh as mesh_lib
from repro_torch.nn import kvcache
from repro_torch.nn import layers
from repro_torch.nn import quantized as Q
from repro_torch.nn.param import ParamSpec

__all__ = [
    "NEG_INF", "GQA_NAMES", "chunked_attention", "sharded_heads_attention",
    "decode_attention", "decode_attention_streamed",
    "ring_decode_attention", "gqa_spec",
    "gqa_serve_spec", "gqa_prefill", "gqa_decode", "gqa_verify",
    "mla_spec", "mla_prefill", "mla_decode", "mla_verify",
]

NEG_INF = -1e30


def _repeat_kv(k: torch.Tensor, groups: int) -> torch.Tensor:
    """(B, S, KV, D) -> (B, S, KV * groups, D), each KV head repeated over
    its group of query heads.  A broadcast and a reshape, as the reference
    writes it: its gradient is a sum over the group axis, where
    ``repeat_interleave``'s is an index-add, whose atomics add in no fixed
    order on a card."""
    if groups == 1:
        return k
    b, s, h, d = k.shape
    return k[:, :, :, None, :].expand(b, s, h, groups, d).reshape(
        b, s, h * groups, d)


def _fixed_order_einsum(eq: str, x: torch.Tensor,
                        y: torch.Tensor) -> torch.Tensor:
    """One of the decode attention's two products as an elementwise
    product into a buffer laid out with the summed axis last, then one sum
    over that axis."""
    if eq == "bkgd,bskd->bkgs":  # sum over D
        a, b = x[:, :, :, None, :], y.permute(0, 2, 1, 3)[:, :, None]
    elif eq == "bkgs,bskd->bkgd":  # sum over S
        a, b = x[:, :, :, None, :], y.permute(0, 2, 3, 1)[:, :, None]
    else:
        raise ValueError(f"no fixed-order form for {eq!r}")
    buf = torch.empty(torch.broadcast_shapes(a.shape, b.shape),
                      dtype=torch.float32, device=x.device)
    return torch.mul(a, b, out=buf).sum(-1)


def _batch_invariant_einsum(eq: str, x: torch.Tensor,
                            y: torch.Tensor) -> torch.Tensor:
    """The decode attention's two products, ``torch.einsum`` over operands
    whose axis 0 is the batch.  On a CUDA device each runs in its fixed
    order form (``_fixed_order_einsum``): cuBLAS picks its kernel, and so
    the order of a dot product's sums, by the shape, batch count included,
    and a row must give the same bits whether a decode step holds it alone
    or beside other requests (the schedulers' contract).  The sum adds
    each row in the same order at batches 1 to 8 and lengths 16 to 8192
    (``tools/decode_products.py``), in as many launches as the batched
    product.  On the CPU the batched product already computes each row
    alone."""
    if x.is_cuda:
        return _fixed_order_einsum(eq, x, y)
    return torch.einsum(eq, x, y)


def _bf16_f32(x: torch.Tensor) -> torch.Tensor:
    """Round to bf16 (the reference's matmul operand type), then widen to
    f32 so the product runs in f32 with exact operands."""
    return x.to(torch.bfloat16).to(torch.float32)


def _scaled(q: torch.Tensor, scale: float) -> torch.Tensor:
    """q times the softmax scale, the scale first rounded to q's dtype: JAX
    converts a Python scalar to the array's dtype (bf16) before it
    multiplies, torch multiplies by the unrounded value (head dims 8 and
    MLA's 192 have scales that bf16 does not hold)."""
    return q * torch.tensor(scale, dtype=q.dtype, device=q.device)


def chunked_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, *,
                      causal: bool = True, q_offset: int = 0,
                      window: Optional[int] = None, chunk: int = 1024,
                      softmax_scale: Optional[float] = None) -> torch.Tensor:
    """Online-softmax attention over KV chunks; q (B, Sq, H, D), k/v
    (B, Sk, H, D) already GQA-expanded (v's head dim may differ, MLA) ->
    (B, Sq, H, Dv) in q's dtype.  Each chunk widens the scaled bf16 q to
    f32 on its own, so that under autograd each chunk's gradient of q is
    rounded to bf16 and the chunks' gradients are added in bf16, the last
    chunk's first, as the reference's bf16 product operand and its scan's
    transpose add them (one widening for all chunks would add them in f32
    and round once)."""
    b, sq, h, d = q.shape
    sk = k.shape[1]
    dv = v.shape[-1]
    scale = softmax_scale if softmax_scale is not None else d ** -0.5
    qb = _scaled(q, scale).to(torch.bfloat16).permute(0, 2, 1, 3)
    q_pos = q_offset + torch.arange(sq, device=q.device)
    acc = torch.zeros((b, h, sq, dv), dtype=torch.float32, device=q.device)
    m = torch.full((b, h, sq), NEG_INF, dtype=torch.float32, device=q.device)
    l = torch.zeros((b, h, sq), dtype=torch.float32, device=q.device)
    for c0 in range(0, sk, chunk):
        kb = _bf16_f32(k[:, c0:c0 + chunk]).permute(0, 2, 1, 3)
        vb = _bf16_f32(v[:, c0:c0 + chunk]).permute(0, 2, 1, 3)
        s = torch.matmul(qb.to(torch.float32),
                         kb.transpose(-1, -2))               # (B, H, Sq, c)
        kv_pos = c0 + torch.arange(kb.shape[2], device=q.device)
        mask = (kv_pos[None, :] <= q_pos[:, None] if causal
                else torch.ones((sq, kb.shape[2]), dtype=torch.bool,
                                device=q.device))
        if window is not None:
            mask = mask & (kv_pos[None, :] > q_pos[:, None] - window)
        s = s + torch.where(mask, 0.0, NEG_INF)
        m_new = torch.maximum(m, s.amax(dim=-1))
        p = torch.exp(s - m_new[..., None])
        alpha = torch.exp(m - m_new)
        l = l * alpha + p.sum(dim=-1)
        acc = acc * alpha[..., None] + torch.matmul(_bf16_f32(p), vb)
        m = m_new
    out = acc / torch.clamp_min(l, 1e-30)[..., None]
    return out.permute(0, 2, 1, 3).to(q.dtype)


def sharded_heads_attention(q: torch.Tensor, k: torch.Tensor,
                            v: torch.Tensor, r: int, m: int,
                            **kw) -> torch.Tensor:
    """``chunked_attention`` (same keywords) over a tensor-parallel rank's
    heads, rank ``r`` of ``m`` on 'model': q, k, v (B, S, H/M, D), k/v
    already GQA-expanded -> (B, Sq, H/M, Dv), each head bitwise the
    one-device head.  The call runs at the one-device shape: q, k and v
    are zero-padded to all H heads, the rank's at their own index, and the
    rank's heads are cut from the output.  cuBLAS picks a batched
    product's kernel, and torch its reductions' layout, by the shape, the
    head count included (on an H100 one head alone and 8 heads batched
    differ by up to two bf16 ulps), so only the one-device shape is sure
    to give the one-device bits; the rank pays one device's attention.
    One device (``m`` 1) calls ``chunked_attention`` itself."""
    if m == 1:
        return chunked_attention(q, k, v, **kw)
    h = q.shape[2]

    def whole(t):
        return torch.nn.functional.pad(t, (0, 0, r * h, (m - 1 - r) * h))
    return chunked_attention(whole(q), whole(k), whole(v),
                             **kw)[:, :, r * h:(r + 1) * h]


def decode_attention(q: torch.Tensor, k_cache: torch.Tensor,
                     v_cache: torch.Tensor, length: int, *,
                     window: Optional[int] = None,
                     softmax_scale: Optional[float] = None) -> torch.Tensor:
    """Single-token attention against the whole cache, masked by
    ``length`` (valid entries, the new token included).  q (B, 1, H, D),
    caches (B, Smax, KV, D) -> (B, 1, H, D)."""
    b, smax, kvh, d = k_cache.shape
    h = q.shape[2]
    scale = softmax_scale if softmax_scale is not None else d ** -0.5
    qg = _bf16_f32(_scaled(q[:, 0], scale)).reshape(b, kvh, h // kvh, d)
    s = _batch_invariant_einsum("bkgd,bskd->bkgs", qg, _bf16_f32(k_cache))
    return _decode_values(s, v_cache, length, window, q.dtype)


def _decode_values(s: torch.Tensor, v_cache: torch.Tensor, length: int,
                   window: Optional[int], dtype) -> torch.Tensor:
    """``decode_attention`` from the scores on: s (B, KV, G, Smax) f32,
    unmasked -> (B, 1, H, Dv)."""
    b, kvh, g, smax = s.shape
    pos = torch.arange(smax, device=s.device)
    mask = pos < length
    if window is not None:
        mask = mask & (pos > length - 1 - window)
    s = s + torch.where(mask, 0.0, NEG_INF)
    p = torch.softmax(s, dim=-1)
    o = _batch_invariant_einsum("bkgs,bskd->bkgd", _bf16_f32(p),
                                _bf16_f32(v_cache))
    return o.reshape(b, 1, kvh * g, v_cache.shape[-1]).to(dtype)


def _kv_chunk(cache, fmt, start: int, c: int) -> torch.Tensor:
    """One sequence chunk of a decode cache tensor as bf16 (B, c, KV, D): a
    bf16 tensor (fmt None) is sliced, a packed leaf has only the chunk's
    bytes unpacked."""
    if fmt is None:
        return cache[:, start:start + c]
    return kvcache.unpack_kv({"p": cache["p"][:, :, start:start + c],
                              "s": cache["s"][:, start:start + c],
                              "z": cache["z"][:, start:start + c]}, fmt)


def decode_attention_streamed(q: torch.Tensor, ck, cv, fmt_k, fmt_v,
                              length: int, *, window: Optional[int] = None,
                              softmax_scale: Optional[float] = None,
                              chunk: int = 1024) -> torch.Tensor:
    """Single-token attention streaming the cache in sequence chunks with an
    online softmax.  ``ck``/``cv`` are bf16 (B, Smax, KV, D) tensors or
    packed leaves; a packed chunk dequantizes to exactly the qdq store's
    values, and both stores run this routine with the same chunking."""
    smax = _seq_len(ck, fmt_k)
    kvh = ck["s"].shape[2] if fmt_k is not None else ck.shape[2]
    b, _, h, d = q.shape
    scale = softmax_scale if softmax_scale is not None else d ** -0.5
    qg = _bf16_f32(_scaled(q[:, 0], scale)).reshape(b, kvh, h // kvh, d)

    def scores(start, c):
        return _batch_invariant_einsum(
            "bkgd,bskd->bkgs", qg, _bf16_f32(_kv_chunk(ck, fmt_k, start, c)))
    return _streamed_values(scores, cv, fmt_v, length, smax,
                            (b, kvh, h // kvh, d), window, chunk, q.dtype)


def _seq_len(cache, fmt) -> int:
    """Sequence length of a bf16 cache tensor or a packed leaf."""
    return cache["p"].shape[2] if fmt is not None else cache.shape[1]


def _streamed_values(scores, cv, fmt_v, length: int, smax: int, shape,
                     window: Optional[int], chunk: int, dtype
                     ) -> torch.Tensor:
    """``decode_attention_streamed`` from the scores on: ``scores(start,
    c)`` gives a chunk's unmasked scores (B, KV, G, c), f32; ``shape`` is
    (B, KV, G, D) -> (B, 1, H, D)."""
    b, kvh, groups, d = shape
    device = cv["p"].device if fmt_v is not None else cv.device
    c = min(chunk, smax)
    if smax % c:
        c = smax  # a ragged max_len runs as one whole-cache chunk
    acc = torch.zeros((b, kvh, groups, d), dtype=torch.float32,
                      device=device)
    m = torch.full((b, kvh, groups), NEG_INF, dtype=torch.float32,
                   device=device)
    l = torch.zeros((b, kvh, groups), dtype=torch.float32, device=device)
    for start in range(0, smax, c):
        vc = _bf16_f32(_kv_chunk(cv, fmt_v, start, c))
        s = scores(start, c)
        pos = start + torch.arange(c, device=device)
        mask = pos < length
        if window is not None:
            mask = mask & (pos > length - 1 - window)
        s = s + torch.where(mask, 0.0, NEG_INF)
        m_new = torch.maximum(m, s.amax(dim=-1))
        pexp = torch.exp(s - m_new[..., None])
        alpha = torch.exp(m - m_new)
        l = l * alpha + pexp.sum(dim=-1)
        acc = acc * alpha[..., None] + _batch_invariant_einsum(
            "bkgs,bskd->bkgd", _bf16_f32(pexp), vc)
        m = m_new
    out = acc / torch.clamp_min(l, 1e-30)[..., None]
    return out.reshape(b, 1, kvh * groups, d).to(dtype)


# --- the GQA block ---------------------------------------------------------------


GQA_NAMES = {k: k for k in ("q", "k", "v", "o")}


def _gqa_names(lname: str, names: Optional[Dict[str, str]] = None
               ) -> Dict[str, str]:
    """Workload layer names of the four projections: the scope prefix
    ``lname`` + the family's base names (``GQA_NAMES``, or e.g. whisper's
    map of all four to 'enc_qkvo')."""
    base = names or GQA_NAMES
    return {k: lname + base[k] for k in ("q", "k", "v", "o")}


def gqa_spec(d_model: int, n_heads: int, n_kv: int, head_dim: int, *,
             lname: str = "", names: Optional[Dict[str, str]] = None
             ) -> Dict[str, Dict[str, ParamSpec]]:
    """Train-mode (float QAT) spec of the four projections."""
    nm = _gqa_names(lname, names)
    return {
        "q": Q.qlinear_spec(d_model, n_heads * head_dim,
                            axes=("embed", "heads"), name=nm["q"]),
        "k": Q.qlinear_spec(d_model, n_kv * head_dim,
                            axes=("embed", "kv_heads"), name=nm["k"]),
        "v": Q.qlinear_spec(d_model, n_kv * head_dim,
                            axes=("embed", "kv_heads"), name=nm["v"]),
        "o": Q.qlinear_spec(n_heads * head_dim, d_model,
                            axes=("heads", "act_embed"), name=nm["o"]),
    }


def gqa_serve_spec(d_model: int, n_heads: int, n_kv: int, head_dim: int, *,
                   policy, lname: str = "",
                   names: Optional[Dict[str, str]] = None):
    """Serve-mode (packed) spec of the four projections."""
    nm = _gqa_names(lname, names)
    mk = Q.qlinear_serve_spec
    return {
        "q": mk(d_model, n_heads * head_dim, axes=("embed", "heads"),
                policy=policy, name=nm["q"]),
        "k": mk(d_model, n_kv * head_dim, axes=("embed", "kv_heads"),
                policy=policy, name=nm["k"]),
        "v": mk(d_model, n_kv * head_dim, axes=("embed", "kv_heads"),
                policy=policy, name=nm["v"]),
        "o": mk(n_heads * head_dim, d_model, axes=("heads", "act_embed"),
                policy=policy, name=nm["o"]),
    }


def _proj(p, x, policy, *, serve, impl, name, row_mesh=None, **kw):
    """One projection: packed (serve) or fake-quant (train); ``row_mesh``
    makes it a row shard over that mesh's 'model' axis; ``kw`` (train
    only): ``col_mesh`` (``qlinear_apply``)."""
    if row_mesh is not None:
        kw["row_mesh"] = row_mesh
    return Q.qlinear_any(p, x, policy, serve=serve, impl=impl, name=name,
                         **kw)


def _model(mesh, n_heads: int, serve: bool):
    """(this rank's 'model' coordinate, the axis' size) of a serving
    attention block, checked: over whole heads; a tensor-parallel train
    block is the full-sequence forward's alone (``gqa_prefill`` and
    ``mla_prefill`` with ``serve=False``, ``_train_heads``)."""
    r, m = mesh_lib.model_coords(mesh)
    if m > 1 and (not serve or n_heads % m):
        raise ValueError(f"a tensor-parallel attention block serves "
                         f"(serve=True) {n_heads} heads split evenly over "
                         f"{m} ranks; tensor-parallel training runs the "
                         f"full-sequence forward (gqa_prefill, mla_prefill)")
    return r, m


def _local_kv_heads(r: int, h_l: int, group: int):
    """The KV heads the q heads ``[r h_l, (r + 1) h_l)`` attend to, as a
    slice where they are contiguous blocks of ``group`` heads (h_l a
    multiple of the group) or one head (the group a multiple of h_l, MQA
    among them), else the reference's per-head index ``(off +
    arange(h_l)) // group`` (each local q head its own KV head)."""
    off = r * h_l
    if h_l % group == 0:
        return slice(off // group, (off + h_l) // group)
    if group % h_l == 0:
        return slice(off // group, off // group + 1)
    return torch.div(off + torch.arange(h_l), group, rounding_mode="floor")


def _kv_select(x, heads):
    """The KV heads ``heads`` (a slice or an index) of a bf16 (B, S, KV,
    D) tensor or a packed leaf (planes (P, B, S, KV, pd), scale and zero
    (B, S, KV)); the whole of ``x`` where the slice covers it."""
    if isinstance(x, dict):
        return {key: _kv_select_axis(v, heads, 3 if key == "p" else 2)
                for key, v in x.items()}
    return _kv_select_axis(x, heads, 2)


def _kv_select_axis(t: torch.Tensor, heads, axis: int) -> torch.Tensor:
    if isinstance(heads, slice):
        if heads.start == 0 and heads.stop == t.shape[axis]:
            return t
        return t.narrow(axis, heads.start,
                        heads.stop - heads.start).contiguous()
    return torch.index_select(t, axis, heads.to(t.device))


def _train_heads(p, mesh, n_heads: int, cols: Dict[str, int],
                 rows: Dict[str, int]):
    """(p, r, m) of a training block on ``mesh``: as they are where the
    heads split over the 'model' axis (``cols``' projections, q among
    them, column-parallel by heads, ``rows``' row-parallel); where they do
    not (nor, then, M whole heads a rank), the columns of ``cols``' and
    the rows of ``rows``' projections ({key: the whole width}) are
    all-gathered where the rules cut them (``launch.mesh.gather_model``:
    the rank's block of each gradient) and the block runs whole on every
    rank, as on one device (r 0, m 1)."""
    r, m = mesh_lib.model_coords(mesh)
    if m == 1 or n_heads % m == 0:
        return p, r, m
    p = dict(p)
    for key, width in cols.items():
        if p[key]["w"].shape[-1] != width:
            got = dict(p[key], w=mesh_lib.gather_model(mesh, p[key]["w"], -1))
            if got["gw"].ndim:
                got["gw"] = mesh_lib.gather_model(mesh, got["gw"], -1)
            p[key] = got
    for key, width in rows.items():
        if p[key]["w"].shape[-2] != width:
            p[key] = dict(p[key], w=mesh_lib.gather_model(mesh, p[key]["w"],
                                                          -2))
    return p, 0, 1


def _qkv(p, x, policy, *, n_heads, n_kv, head_dim, sin, cos, impl, nm,
         rope=True, serve=True, train_mesh=None):
    """The q/k/v projections, rotary applied to q and k (``rope``);
    ``n_heads`` counts the q heads this rank holds.  ``train_mesh``
    (tensor-parallel training): q column-parallel; k and v whole on every
    rank, as on one device (``gqa_prefill`` sums their cotangents)."""
    b, s, _ = x.shape
    tp = lambda key: ({"col_mesh": train_mesh}  # noqa: E731
                      if train_mesh is not None and key == "q" else {})
    proj = lambda key, n: _proj(  # noqa: E731
        p[key], x, policy, serve=serve, impl=impl, name=nm[key],
        **tp(key)).reshape(b, s, n, head_dim)
    q, k, v = proj("q", n_heads), proj("k", n_kv), proj("v", n_kv)
    if not rope:
        return q, k, v
    return (layers.apply_rotary(q, sin, cos), layers.apply_rotary(k, sin, cos),
            v)


def gqa_prefill(p: Dict, x: torch.Tensor, policy, *, n_heads: int,
                n_kv: int, head_dim: int, sin: torch.Tensor,
                cos: torch.Tensor, causal: bool = True,
                window: Optional[int] = None, rope: bool = True,
                chunk: int = 1024, impl: str = "auto",
                attn_impl: str = "xla", lname: str = "",
                names: Optional[Dict[str, str]] = None, kv_fmts=None,
                kv_store: str = "packed", serve: bool = True, mesh=None):
    """Prefill of one GQA block -> (out (B, S, D), cache): causal (else
    bidirectional), over the last ``window`` keys when given, with rotary
    q/k unless ``rope=False``.

    ``serve=False`` is the QAT training forward: fake-quant projections
    (``qlinear_apply``) and ``chunked_attention`` under autograd, whatever
    ``attn_impl`` says (the reference takes its flash kernel only when
    serving).  A quantized K/V cache still runs through ``pack_kv`` /
    ``unpack_kv`` (or ``qdq_kv``): the integer codes carry no gradient, so
    k and v get theirs through the rows' bf16 scale and zero, which come
    from each row's max and min -- as ``jax.grad`` of the reference gives.

    With ``kv_fmts=None`` the cache is the bf16 ``(k, v)`` pair (B, S, KV,
    Dh).  A kv-quantizing layer passes ``(fmt_k, fmt_v)`` (either may be None,
    keeping that tensor bf16): attention then reads the quantization-grid
    values, so prefill agrees with decode against the quantized cache, and
    the cache is ``{"k": leaf, "v": leaf}`` of packed leaves (store
    'packed') or the bf16 pair of grid values (store 'qdq').

    ``mesh`` with a 'model' axis above 1: this rank's heads (see the
    module doc); the returned cache is the whole prompt's, of which the
    caller keeps the rank's sequence block (``runtime.serve``)."""
    b, s, _ = x.shape
    nm = _gqa_names(lname, names)
    if serve:
        r, m = _model(mesh, n_heads, serve)
    else:
        width = n_heads * head_dim
        p, r, m = _train_heads(p, mesh, n_heads, {"q": width}, {"o": width})
    h_l = n_heads // m
    q, k, v = _qkv(p, x, policy, n_heads=h_l, n_kv=n_kv,
                   head_dim=head_dim, sin=sin, cos=cos, impl=impl, nm=nm,
                   rope=rope, serve=serve,
                   train_mesh=mesh if not serve and m > 1 else None)
    fmt_k, fmt_v = kv_fmts if kv_fmts is not None else (None, None)
    packed = kv_fmts is not None and kv_store == "packed"
    kq = kvcache.pack_kv(k, fmt_k) if packed and fmt_k is not None else None
    vq = kvcache.pack_kv(v, fmt_v) if packed and fmt_v is not None else None
    heads = _local_kv_heads(r, h_l, n_heads // n_kv)
    # the reference's flash kernels serve only
    if serve and attn_impl == "flash" and kq is not None and vq is not None:
        # K4: the codes travel to the kernel, never bf16 K/V
        o = flash_ops.flash_attention_packed(
            q, _kv_select(kq, heads), _kv_select(vq, heads), fmt_k, fmt_v,
            causal=causal, window=window, block_k=chunk, impl=impl)
    else:
        # grid values in bf16; unpack_kv(pack_kv(x)) == qdq_kv(x) bitwise
        if fmt_k is not None:
            k = (kvcache.unpack_kv(kq, fmt_k) if kq is not None
                 else kvcache.qdq_kv(k, fmt_k))
        if fmt_v is not None:
            v = (kvcache.unpack_kv(vq, fmt_v) if vq is not None
                 else kvcache.qdq_kv(v, fmt_v))
        if not serve:
            # the rank's q heads' KV heads (all of them on one device),
            # broadcast then cut (no index_select, whose backward adds
            # with atomics on a card), and attention over those heads.
            # k and v are whole on every rank: their cotangents are
            # summed over 'model' where one device's broadcast sums its
            # group, so all that precedes (the projections, rotary, the
            # cache's quantization) runs one device's backward
            g, tp = n_heads // n_kv, mesh if m > 1 else None
            k_l, v_l = (_repeat_kv(mesh_lib.copy_model(tp, t), g)
                        [:, :, r * h_l:(r + 1) * h_l] for t in (k, v))
            o = chunked_attention(q, k_l, v_l, causal=causal,
                                  window=window, chunk=chunk)
        elif attn_impl == "flash":
            o = flash_ops.flash_attention(
                q, _kv_select(k, heads), _kv_select(v, heads),
                causal=causal, window=window, block_k=chunk, impl=impl)
        elif attn_impl == "xla":
            k_l, v_l = _kv_select(k, heads), _kv_select(v, heads)
            g = h_l // k_l.shape[2]
            o = sharded_heads_attention(
                q, _repeat_kv(k_l, g), _repeat_kv(v_l, g), r, m,
                causal=causal, window=window, chunk=chunk)
        else:
            raise ValueError(f"attn_impl must be 'flash' or 'xla', got "
                             f"{attn_impl!r}")
    o = o.reshape(b, s, h_l * head_dim)
    out = _proj(p["o"], o, policy, serve=serve, impl=impl, name=nm["o"],
                row_mesh=mesh if m > 1 else None)
    if packed:
        return out, {"k": kq if fmt_k is not None else k,
                     "v": vq if fmt_v is not None else v}
    return out, (k, v)


def gqa_decode(p: Dict, x: torch.Tensor, cache, length: int, policy,
               **kw):
    """One-token step: x (B, 1, D); ``cache`` is the decode-sized cache of
    this layer (the bf16 pair, or the packed ``{"k", "v"}`` tree), updated
    IN PLACE at index ``length`` (the reference returns a new one; the port
    saves the copy).  It is ``gqa_verify`` at T = 1, whose per-query
    routine at one query is the decode attention itself.  Returns (out
    (B, 1, D), cache)."""
    return gqa_verify(p, x, cache, length, policy, **kw)


def _append_block(cache, new, length: int, start: int, seq_axis: int):
    """Write the tokens of ``new`` (positions ``length ..``) that fall in
    the block ``[start, start + L)`` a cache tensor holds (the whole cache
    at ``start`` 0; a rank's block of a tensor-parallel one), sequence
    axis ``seq_axis``, in place."""
    t = new.shape[seq_axis]
    lo, hi = max(length, start), min(length + t, start + cache.shape[seq_axis])
    if lo < hi:
        cache.narrow(seq_axis, lo - start, hi - lo).copy_(
            new.narrow(seq_axis, lo - length, hi - lo).to(cache.dtype))


def _append_owned(c, new, fmt, length: int, start: int) -> None:
    """``_append_block`` of a bf16 tensor, or of a packed leaf: planes at
    sequence axis 2 (after the plane axis and batch), scale/zero at 1."""
    if fmt is None:
        _append_block(c, new, length, start, 1)
        return
    _append_block(c["p"], new["p"], length, start, 2)
    _append_block(c["s"], new["s"], length, start, 1)
    _append_block(c["z"], new["z"], length, start, 1)


def _gather_seq(mesh, cache, fmt):
    """Every 'model' rank's block of a cache tensor or packed leaf,
    concatenated along its sequence axis in rank order: the whole
    cache."""
    if fmt is None:
        return mesh_lib.all_gather_model(mesh, cache, dim=1)
    return {"p": mesh_lib.all_gather_model(mesh, cache["p"], dim=2),
            "s": mesh_lib.all_gather_model(mesh, cache["s"], dim=1),
            "z": mesh_lib.all_gather_model(mesh, cache["z"], dim=1)}


def _split_decode(q_local: torch.Tensor, ck, cv, fmt_k, fmt_v, length: int,
                  window: Optional[int], mesh, streamed: bool
                  ) -> torch.Tensor:
    """Split-sequence decode of T queries (B, T, h_l, D) of this rank's
    heads against its block of the cache -> (B, T, h_l, D) in q's dtype.

    q of every head is all-gathered over 'model'; each rank scores its own
    positions against its K block (a score is one dot product over D, the
    same bits in any block), and the scores (B T H L f32 a rank) and the V
    blocks are all-gathered in rank order.  Every rank then runs the
    one-device routine from the scores on -- ``decode_attention``'s softmax
    and value sum, or ``decode_attention_streamed``'s chunks with
    ``streamed`` -- over the whole row, so each query's output is the
    one-device output, bitwise, on every rank, wherever the rounded cache
    length equals the one-device length.  K never moves."""
    r, _ = mesh_lib.model_coords(mesh)
    b, t_new, h_l, d = q_local.shape
    q = mesh_lib.all_gather_model(mesh, q_local, dim=2)
    kvh = ck["s"].shape[2] if fmt_k is not None else ck.shape[2]
    kc = _bf16_f32(_kv_chunk(ck, fmt_k, 0, _seq_len(ck, fmt_k)))
    qg = _bf16_f32(_scaled(q, d ** -0.5)).reshape(b, t_new, kvh, -1, d)
    mine = torch.stack([_batch_invariant_einsum("bkgd,bskd->bkgs",
                                                qg[:, t], kc)
                        for t in range(t_new)])      # (T, B, KV, G, L)
    s = mesh_lib.all_gather_model(mesh, mine, dim=-1)
    v = _gather_seq(mesh, cv, fmt_v)
    smax = s.shape[-1]
    outs = []
    for t in range(t_new):
        if streamed:
            outs.append(_streamed_values(
                lambda start, c, t=t: s[t][..., start:start + c], v, fmt_v,
                length + 1 + t, smax, (b, kvh, qg.shape[3], d), window,
                1024, q.dtype))
        else:
            outs.append(_decode_values(s[t], v, length + 1 + t, window,
                                       q.dtype))
    return torch.cat(outs, dim=1)[:, :, r * h_l:(r + 1) * h_l]


def ring_decode_attention(q: torch.Tensor, k_ring: torch.Tensor,
                          v_ring: torch.Tensor, mask_len: int,
                          mesh=None) -> torch.Tensor:
    """One query against a ring buffer of slots, the first ``mask_len``
    valid (all of them once it has wrapped): q (B, 1, h, D), rings (B,
    slots, KV, D) -> (B, 1, h, D).  On a 'model' axis above 1 ``q`` holds
    this rank's heads and each ring this rank's block of the slots: the
    split decode (``_split_decode``) gathers the scores and the V blocks
    in slot order and runs ``decode_attention``'s routine over the whole
    ring, so each head's output is the one-device output, bitwise, where
    the ranks' slots add up to the one-device ring's."""
    if mesh is None or mesh_lib.model_coords(mesh)[1] == 1:
        return decode_attention(q, k_ring, v_ring, mask_len)
    return _split_decode(q, k_ring, v_ring, None, None, mask_len - 1, None,
                         mesh, streamed=False)


def gqa_verify(p: Dict, x: torch.Tensor, cache, length: int, policy, *,
               n_heads: int, n_kv: int, head_dim: int, sin: torch.Tensor,
               cos: torch.Tensor, window: Optional[int] = None,
               rope: bool = True, impl: str = "auto", attn_impl: str = "xla",
               lname: str = "", names: Optional[Dict[str, str]] = None,
               kv_fmts=None, kv_store: str = "packed", serve: bool = True,
               mesh=None):
    """T-token cache extension, the verify step of speculative decoding.

    x (B, T, D): the T candidate tokens land at cache positions ``length ..
    length + T - 1`` in one write (``pack_kv`` of a T-block equals T
    per-token packs: the grid is per (token, head)), updated IN PLACE as
    ``gqa_decode`` does.  Then every query t runs the single-query routine
    ``gqa_decode`` runs, at valid length ``length + 1 + t``; cache rows at
    or past a query's valid length add an exact f32 zero, so the T rows
    equal T sequential ``gqa_decode`` steps over the same tokens bitwise,
    whatever the rejected rows of an earlier cycle hold.

    ``attn_impl='flash'`` sends a cache whose K and V are both packed
    through K4 (``flash_attention_packed``) with ``q_offset=length``: the
    same function within K4's contract (one bf16 ulp), not bitwise.
    ``serve=False`` runs the projections fake-quant (the QAT forward's
    train-mode cache path) and never K4, as the reference.  Returns (out
    (B, T, D), cache).

    ``mesh`` with a 'model' axis above 1: ``cache`` is this rank's block
    of the sequence, each position written on its owner, and attention is
    split-sequence (``_split_decode``; ``attn_impl`` 'xla' only)."""
    b, t_new = x.shape[0], x.shape[1]
    nm = _gqa_names(lname, names)
    r, m = _model(mesh, n_heads, serve)
    h_l = n_heads // m
    q, k, v = _qkv(p, x, policy, n_heads=h_l, n_kv=n_kv,
                   head_dim=head_dim, sin=sin, cos=cos, impl=impl, nm=nm,
                   rope=rope, serve=serve)
    if not serve:
        attn_impl = "xla"  # the reference's flash kernels serve only
    fmt_k, fmt_v = kv_fmts if kv_fmts is not None else (None, None)
    packed = kv_fmts is not None and kv_store == "packed"
    if packed:
        ck, cv = cache["k"], cache["v"]
        fk, fv = fmt_k, fmt_v
        k = kvcache.pack_kv(k, fk) if fk is not None else k
        v = kvcache.pack_kv(v, fv) if fv is not None else v
    else:  # bf16; the qdq store holds grid values
        ck, cv = cache
        fk = fv = None
        k = kvcache.qdq_kv(k, fmt_k) if fmt_k is not None else k
        v = kvcache.qdq_kv(v, fmt_v) if fmt_v is not None else v
    block = _seq_len(ck, fk)
    if length + t_new > m * block:
        raise ValueError(f"positions {length} .. {length + t_new - 1} do "
                         f"not fit a cache of {m * block}")
    _append_owned(ck, k, fk, length, r * block)
    _append_owned(cv, v, fv, length, r * block)
    if m > 1:
        if attn_impl != "xla":
            raise NotImplementedError(
                "a tensor-parallel verify runs split-sequence decode "
                "attention (attn_impl='xla'); K4 takes a whole cache")
        o = _split_decode(q, ck, cv, fk, fv, length, window, mesh,
                          streamed=kv_fmts is not None)
    elif attn_impl == "flash" and packed and fmt_k is not None \
            and fmt_v is not None:
        o = flash_ops.flash_attention_packed(q, ck, cv, fmt_k, fmt_v,
                                             window=window, q_offset=length,
                                             impl=impl)
    elif attn_impl not in ("flash", "xla"):
        raise ValueError(f"attn_impl must be 'flash' or 'xla', got "
                         f"{attn_impl!r}")
    elif kv_fmts is not None:
        o = torch.cat([decode_attention_streamed(q[:, t:t + 1], ck, cv, fk,
                                                 fv, length + 1 + t,
                                                 window=window)
                       for t in range(t_new)], dim=1)
    else:
        o = torch.cat([decode_attention(q[:, t:t + 1], ck, cv,
                                        length + 1 + t, window=window)
                       for t in range(t_new)], dim=1)
    o = o.reshape(b, t_new, h_l * head_dim)
    out = _proj(p["o"], o, policy, serve=serve, impl=impl, name=nm["o"],
                row_mesh=mesh if m > 1 else None)
    return out, ({"k": ck, "v": cv} if packed else (ck, cv))


# --- MLA: multi-head latent attention (DeepSeek-V2) -------------------------


def mla_spec(d_model: int, n_heads: int, *, kv_lora: int, qk_nope: int,
             qk_rope: int, v_head: int, serve: bool = False,
             policy=None, lname: str = "") -> Dict:
    """The five projections (q, dkv = down to the latent plus the rotary
    key, uk / uv = the latent up to per-head K and V, o) and the latent's
    rmsnorm ``kv_norm``."""
    def mk(i, o, name, axes):
        if serve:
            return Q.qlinear_serve_spec(i, o, axes=axes, policy=policy,
                                        name=lname + name)
        return Q.qlinear_spec(i, o, axes=axes, name=lname + name)
    return {
        "q": mk(d_model, n_heads * (qk_nope + qk_rope), "q",
                ("embed", "heads")),
        "dkv": mk(d_model, kv_lora + qk_rope, "dkv", ("embed", "qk_dim")),
        "uk": mk(kv_lora, n_heads * qk_nope, "uk", ("qk_dim", "heads")),
        "uv": mk(kv_lora, n_heads * v_head, "uv", ("qk_dim", "heads")),
        "o": mk(n_heads * v_head, d_model, "o", ("heads", "act_embed")),
        "kv_norm": layers.rmsnorm_spec(kv_lora),
    }


def _mla_proj(p, key, x, policy, *, serve, impl, lname, col_mesh=None):
    kw = {} if col_mesh is None else {"col_mesh": col_mesh}
    return _proj(p[key], x, policy, serve=serve, impl=impl, name=lname + key,
                 **kw)


def _mla_qkv(p, x, policy, *, n_heads, qk_nope, qk_rope, kv_lora, sin, cos,
             impl, lname, serve=True, train_mesh=None):
    """-> q_nope, q_rope (rotary), the normed latent c_kv and the rotary
    key k_rope of the tokens x (B, S, D); ``n_heads`` counts the rank's q
    heads.  ``train_mesh`` (tensor-parallel training): q column-parallel
    by heads, dkv and ``kv_norm`` whole."""
    b, s, _ = x.shape
    kw = dict(serve=serve, impl=impl, lname=lname)
    q = _mla_proj(p, "q", x, policy, col_mesh=train_mesh,
                  **kw).reshape(b, s, n_heads, qk_nope + qk_rope)
    q_nope, q_rope = q[..., :qk_nope], q[..., qk_nope:]
    q_rope = layers.apply_rotary(q_rope, sin, cos)
    ckv = _mla_proj(p, "dkv", x, policy, **kw)
    c_kv = layers.rmsnorm_apply(p["kv_norm"], ckv[..., :kv_lora])
    k_rope = layers.apply_rotary(ckv[..., kv_lora:][:, :, None, :], sin,
                                 cos)[:, :, 0, :]
    return q_nope, q_rope, c_kv, k_rope


class _HeadBroadcast(torch.autograd.Function):
    """The rotary key k_rope (B, S, R), shared by every head, broadcast to
    (B, S, H, R).  Its backward adds the H heads' cotangents one at a time
    in their dtype, in head order, as XLA runs the reference's transpose of
    ``jnp.broadcast_to`` (a bf16 sum over a non-minor axis); ``expand``'s
    backward would add them in f32 and round once.

    ``mesh`` with a 'model' axis of M above 1 (tensor-parallel training by
    heads): the rank's H/M heads of the broadcast; the backward
    all-gathers every rank's heads' cotangents in rank order -- the whole
    (B, S, H, R) cotangent, exactly, on every rank -- and adds all H heads
    in order, as one device does.  Each rank adding its own heads and the
    partials then summed over 'model' would add them in another order."""

    @staticmethod
    def forward(ctx, k, h, mesh=None):
        b, s, r = k.shape
        ctx.mesh = mesh
        return k[:, :, None, :].expand(
            b, s, h // mesh_lib.model_coords(mesh)[1], r).clone()

    @staticmethod
    def backward(ctx, g):
        g = mesh_lib.all_gather_model(ctx.mesh, g.contiguous(), dim=2)
        acc = g[:, :, 0]
        for i in range(1, g.shape[2]):
            acc = acc + g[:, :, i]
        return acc, None, None


def _mla_expand(p, q_nope, q_rope, c_kv, k_rope, policy, *, n_heads,
                qk_nope, qk_rope, v_head, impl, lname, serve=True,
                train_mesh=None):
    """The latent (B, Sk, r) and rotary key up to per-head K (B, Sk, H,
    qk_nope + qk_rope) and V (B, Sk, H, v_head); q joined the same way.
    ``n_heads`` counts the rank's heads; ``train_mesh`` (tensor-parallel
    training): uk and uv column-parallel by heads over the whole latent
    (its cotangent summed over 'model', ``qlinear_apply``'s ``col_mesh``),
    the rotary key broadcast to the rank's heads (``_HeadBroadcast``)."""
    b, sk = c_kv.shape[:2]
    kw = dict(serve=serve, impl=impl, lname=lname, col_mesh=train_mesh)
    k_nope = _mla_proj(p, "uk", c_kv, policy, **kw).reshape(b, sk, n_heads,
                                                            qk_nope)
    v = _mla_proj(p, "uv", c_kv, policy, **kw).reshape(b, sk, n_heads,
                                                       v_head)
    if serve:
        k_rope_b = k_rope[:, :, None, :].expand(b, sk, n_heads, qk_rope)
    elif train_mesh is None:
        k_rope_b = _HeadBroadcast.apply(k_rope, n_heads)
    else:
        m = mesh_lib.model_coords(train_mesh)[1]
        k_rope_b = _HeadBroadcast.apply(k_rope, n_heads * m, train_mesh)
    k = torch.cat([k_nope, k_rope_b.to(k_nope.dtype)], dim=-1)
    q = torch.cat([q_nope, q_rope.to(q_nope.dtype)], dim=-1)
    return q, k, v


def mla_prefill(p: Dict, x: torch.Tensor, policy, *, n_heads: int,
                kv_lora: int, qk_nope: int, qk_rope: int, v_head: int,
                sin: torch.Tensor, cos: torch.Tensor, impl: str = "auto",
                chunk: int = 1024, lname: str = "", serve: bool = True,
                mesh=None):
    """Causal prefill of one MLA block -> (out (B, S, D), cache (c_kv (B,
    S, r), k_rope (B, S, qk_rope))).  ``serve=False`` is the QAT training
    forward: the five projections fake-quant, ``kv_norm``, rotary on q_rope
    and k_rope and ``chunked_attention`` at ``chunk``, under autograd.

    ``mesh`` with a 'model' axis of M above 1: q, uk and uv hold this
    rank's H/M heads' columns, dkv and ``kv_norm`` are whole, o holds its
    heads' rows (a row shard summed over 'model'); the rank attends over
    its heads at the one-device shape (``sharded_heads_attention``), and
    the returned latent cache is the whole prompt's (dkv is whole), of
    which the caller keeps the rank's ``kv_seq`` block.  In training
    (``serve=False``) q, uk and uv are column-parallel (the latent's
    cotangent summed over 'model'), the rotary key's cotangent gathered
    by heads and added in head order (``_HeadBroadcast``), attention
    runs over the rank's heads (``chunked_attention``) and o is
    row-parallel; where the heads do not split the block runs whole on
    every rank (``_train_heads``)."""
    b, s, _ = x.shape
    if serve:
        r, m = _model(mesh, n_heads, serve)
    else:
        p, r, m = _train_heads(
            p, mesh, n_heads, {"q": n_heads * (qk_nope + qk_rope),
                               "uk": n_heads * qk_nope,
                               "uv": n_heads * v_head},
            {"o": n_heads * v_head})
    h_l = n_heads // m
    tp = mesh if not serve and m > 1 else None
    kw = dict(n_heads=h_l, qk_nope=qk_nope, qk_rope=qk_rope, serve=serve,
              train_mesh=tp)
    q_nope, q_rope, c_kv, k_rope = _mla_qkv(
        p, x, policy, kv_lora=kv_lora, sin=sin, cos=cos, impl=impl,
        lname=lname, **kw)
    q, k, v = _mla_expand(p, q_nope, q_rope, c_kv, k_rope, policy,
                          v_head=v_head, impl=impl, lname=lname, **kw)
    # training attends over the rank's heads alone (no bitwise claim)
    attend = lambda q, k, v: sharded_heads_attention(  # noqa: E731
        q, k, v, r if serve else 0, m if serve else 1, causal=True,
        chunk=chunk, softmax_scale=(qk_nope + qk_rope) ** -0.5)
    if x.is_cuda:  # one batch row at a time: the same bits in any batch
        o = torch.cat([attend(q[i:i + 1], k[i:i + 1], v[i:i + 1])
                       for i in range(b)])
    else:
        o = attend(q, k, v)
    o = o.reshape(b, s, h_l * v_head)
    return (_proj(p["o"], o, policy, serve=serve, impl=impl,
                  name=lname + "o", row_mesh=mesh if m > 1 else None),
            (c_kv, k_rope))


def mla_verify(p: Dict, x: torch.Tensor, cache, length: int, policy, *,
               n_heads: int, kv_lora: int, qk_nope: int, qk_rope: int,
               v_head: int, sin: torch.Tensor, cos: torch.Tensor,
               impl: str = "auto", lname: str = "", serve: bool = True,
               mesh=None):
    """T-token latent-cache extension (the MLA counterpart of
    ``gqa_verify``): x (B, T, D) lands at ``length .. length + T - 1`` of
    the cache ``(c_kv (B, Smax, r), k_rope (B, Smax, qk_rope))``, updated
    IN PLACE; the whole cache is expanded to K/V once (per position, so
    rows past a query's length may hold anything) and each query t runs
    ``decode_attention`` at valid length ``length + 1 + t`` -- the T rows
    are T sequential ``mla_decode`` steps, bitwise.  ``serve=False`` runs
    the projections fake-quant.  -> (out (B, T, D), cache).

    ``mesh`` with a 'model' axis of M above 1: the cache is this rank's
    ``kv_seq`` block, each new position written on the rank that owns it.
    A rank holds neither the whole sequence nor every head's uk/uv, so
    the latent blocks (kv_lora + qk_rope bf16 values a position) are
    all-gathered over 'model' in rank order, and the rank expands its H/M
    heads over the whole sequence and runs the one-device
    ``decode_attention`` on them: each head bitwise the one-device head.
    No absorbed-weight form: it would change the numerics."""
    b, t_new = x.shape[0], x.shape[1]
    r, m = _model(mesh, n_heads, serve)
    h_l = n_heads // m
    kw = dict(n_heads=h_l, qk_nope=qk_nope, qk_rope=qk_rope, serve=serve)
    q_nope, q_rope, c_new, kr_new = _mla_qkv(
        p, x, policy, kv_lora=kv_lora, sin=sin, cos=cos, impl=impl,
        lname=lname, **kw)
    c_cache, kr_cache = cache
    block = c_cache.shape[1]
    if length + t_new > m * block:
        raise ValueError(f"positions {length} .. {length + t_new - 1} do "
                         f"not fit a cache of {m * block}")
    _append_block(c_cache, c_new, length, r * block, 1)
    _append_block(kr_cache, kr_new, length, r * block, 1)
    c_all, kr_all = c_cache, kr_cache
    if m > 1:
        c_all = mesh_lib.all_gather_model(mesh, c_cache, dim=1)
        kr_all = mesh_lib.all_gather_model(mesh, kr_cache, dim=1)
    q, k, v = _mla_expand(p, q_nope, q_rope, c_all, kr_all, policy,
                          v_head=v_head, impl=impl, lname=lname, **kw)
    scale = (qk_nope + qk_rope) ** -0.5
    o = torch.cat([decode_attention(q[:, t:t + 1], k, v, length + 1 + t,
                                    softmax_scale=scale)
                   for t in range(t_new)], dim=1)
    o = o.reshape(b, t_new, h_l * v_head)
    return (_proj(p["o"], o, policy, serve=serve, impl=impl,
                  name=lname + "o", row_mesh=mesh if m > 1 else None),
            (c_cache, kr_cache))


def mla_decode(p: Dict, x: torch.Tensor, cache, length: int, policy, **kw):
    """One-token step: x (B, 1, D) against the latent cache, which is
    updated IN PLACE at ``length``; uk and uv expand the whole ``Smax``
    cache and scores past ``length`` are masked, as in the reference.
    ``mesh=`` as ``mla_verify``'s.  -> (out (B, 1, D), cache)."""
    return mla_verify(p, x, cache, length, policy, **kw)
