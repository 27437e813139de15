"""RecurrentGemma (Griffin) (port of ``repro.models.recurrentgemma``):
RG-LRU blocks and local attention, one attention layer in three --
superblocks (R, R, A) and the remainder R layers.

The JAX package scans the superblocks as one stacked tree ``supers.{r1,
r2, att}`` beside the remainder ``rem_{i}``; the port keeps one per-layer
list in model order, ``params["layers"][i]``, layer i an attention layer
when ``layer_kind(cfg, i) == "A"``.  The prefill cache is per layer too:
``{"h", "conv"}`` for an R layer, the bf16 pair ``(k, v)`` (B, S, KV, Dh)
of the whole prompt (keys after rotary) for an A layer.  Decode keeps a
ring buffer of ``min(window, max_len)`` slots per A layer, token p in slot
p % window (``runtime.serve.Generator._grow_cache`` re-packs the prompt's
last keys into it), so the decode state is O(window + d_rnn) whatever
the context.

On a card the attention prefill and the serve-mode ``forward`` run K3
(``attn_impl='flash'``, the FULL config: head dim 256, one KV head, window
2048), as the reference runs its Pallas kernel; decode attention is plain
torch in both.  ``forward(mode="train")`` is the QAT training forward:
fake-quant projections, the RG-LRU scan and the windowed attention
(``gqa_prefill(serve=False)``, never K3) under autograd, each whole (R, R,
A) superblock under ``torch.utils.checkpoint`` when ``cfg.remat`` and the
remainder layers without, as the reference checkpoints its scanned
superblock body only.  ``prefill`` and ``decode_step`` take
``mode="train"`` too, over an ``init_params("train")`` tree.

Tensor-parallel serving (``mesh=`` with a 'model' axis of M above 1):
``params`` is this rank's slice (``shard_serve_tree``): the RG-LRU blocks
by channels (``nn.rglru``), the attention's q by heads with k and v whole
(one KV head) and o by rows, the MLP's gate/up by columns and down by
rows, the embedding by vocabulary rows and the head by columns.  The
prefill runs K3 (or torch attention) over the rank's heads; the decode
cache is the rank's channels of each R state and its block of each A
layer's ring slots (``cache_specs(..., model=M)``, ``ring_cache``), a new
key written on the rank that owns its slot, and the decode attention is
split by slots (``nn.attention.ring_decode_attention``).  Prefill and
decode logits are the one-device logits, bitwise, wherever the ranks'
slots add up to the one-device ring (the window fits ``max_len``, or M
divides ``max_len``).
"""
from __future__ import annotations

import dataclasses
from typing import Dict, List, Optional

import torch

from repro_torch.core.dse import Gemm
from repro_torch.launch import mesh as mesh_lib
from repro_torch.models import transformer as T
from repro_torch.models.remat import remat
from repro_torch.models.transformer import _serve_mode
from repro_torch.nn import attention as attn
from repro_torch.nn import layers as nnl
from repro_torch.nn import param as nnp
from repro_torch.nn import quantized as Q
from repro_torch.nn import rglru as nnr
from repro_torch.nn.param import ParamSpec
from repro_torch.nn.rglru import RGLRUConfig

__all__ = ["RGConfig", "layer_kind", "specs", "forward", "prefill",
           "decode_step", "cache_specs", "ring_cache", "shard_serve_tree",
           "gemm_workload", "active_params", "total_params", "model_flops"]


@dataclasses.dataclass(frozen=True)
class RGConfig:
    name: str
    n_layers: int
    d_model: int
    n_heads: int
    n_kv: int
    d_ff: int
    vocab: int
    window: int = 2048
    head_dim: Optional[int] = None
    scan_layers: bool = True
    scan_unroll: bool = False
    attn_impl: str = "xla"
    remat: bool = True
    attn_chunk: int = 1024
    family: str = "hybrid"

    @property
    def hd(self) -> int:
        return self.head_dim or self.d_model // self.n_heads

    @property
    def rnn(self) -> RGLRUConfig:
        return RGLRUConfig(d_model=self.d_model, d_rnn=self.d_model)

    @property
    def n_super(self) -> int:
        return self.n_layers // 3

    @property
    def n_rem(self) -> int:
        return self.n_layers - 3 * self.n_super


# gemm_workload names of the attention projections: q/k/v/o answer to the
# aggregated attn_q / attn_kv / attn_o workload entries.
ATTN_NAMES = {"q": "attn_q", "k": "attn_kv", "v": "attn_kv", "o": "attn_o"}


def layer_kind(cfg: RGConfig, i: int) -> str:
    """'A' for the third layer of each superblock, else 'R'."""
    return "A" if i < 3 * cfg.n_super and i % 3 == 2 else "R"


def _mlp_spec(cfg, serve, policy):
    if serve:
        mk = lambda i, o, ax: Q.qlinear_serve_spec(  # noqa: E731
            i, o, axes=ax, policy=policy, name="mlp")
    else:
        mk = lambda i, o, ax: Q.qlinear_spec(  # noqa: E731
            i, o, axes=ax, name="mlp")
    d, ff = cfg.d_model, cfg.d_ff
    up, down = ("embed", "mlp"), ("mlp", "act_embed")
    return {"gate": mk(d, ff, up), "up": mk(d, ff, up),
            "down": mk(ff, d, down)}


def layer_spec(cfg: RGConfig, i: int, mode: str = "train",
               policy=None) -> Dict:
    serve = mode == "serve"
    if layer_kind(cfg, i) == "A":
        mixer = ("attn", (attn.gqa_serve_spec(
            cfg.d_model, cfg.n_heads, cfg.n_kv, cfg.hd, policy=policy,
            names=ATTN_NAMES) if serve else attn.gqa_spec(
            cfg.d_model, cfg.n_heads, cfg.n_kv, cfg.hd, names=ATTN_NAMES)))
    else:
        mixer = ("rnn", nnr.rglru_block_spec(cfg.rnn, serve=serve,
                                             policy=policy))
    return {"ln1": nnl.rmsnorm_spec(cfg.d_model), mixer[0]: mixer[1],
            "ln2": nnl.rmsnorm_spec(cfg.d_model),
            "mlp": _mlp_spec(cfg, serve, policy)}


def specs(cfg: RGConfig, mode: str = "train", policy=None) -> Dict:
    serve = mode == "serve"
    vp = nnl.pad_vocab(cfg.vocab)
    return {
        "embed": (nnl.embed_serve_spec(vp, cfg.d_model, policy) if serve
                  else nnl.embed_spec(vp, cfg.d_model)),
        "final_norm": nnl.rmsnorm_spec(cfg.d_model),
        "head": (Q.qlinear_serve_spec(cfg.d_model, vp, axes=("embed", "vocab"),
                                      layer_class="boundary", policy=policy,
                                      name="head") if serve
                 else Q.qlinear_spec(cfg.d_model, vp, axes=("embed", "vocab"),
                                     layer_class="boundary", name="head")),
        "layers": [layer_spec(cfg, i, mode, policy)
                   for i in range(cfg.n_layers)],
    }


def _proj(p, x, policy, impl, name, serve=True, row_mesh=None):
    """One projection; ``row_mesh``: a row shard over its 'model' axis."""
    if row_mesh is not None:
        return Q.qlinear_serve_apply(p, x, policy, impl=impl, name=name,
                                     row_mesh=row_mesh)
    return Q.qlinear_any(p, x, policy, serve=serve, impl=impl, name=name)


def _mlp(p, h, policy, impl, serve=True, mesh=None):
    """The SwiGLU MLP; on a tensor-parallel ``mesh`` gate/up hold the
    rank's columns and down its rows (a row shard)."""
    fn = lambda w, x: _proj(w, x, policy, impl, "mlp", serve)  # noqa: E731
    return _proj(p["down"], nnl.swiglu_combine(fn(p["gate"], h),
                                               fn(p["up"], h)),
                 policy, impl, "mlp", serve, mesh)


def _layer_fwd(cfg, i, lp, x, policy, aux, *, impl, serve=True, mesh=None):
    """Prefill of layer i -> (x, its cache); ``aux`` holds the rotary
    tables."""
    h = nnl.rmsnorm_apply(lp["ln1"], x)
    if layer_kind(cfg, i) == "A":
        o, cache = attn.gqa_prefill(
            lp["attn"], h, policy, n_heads=cfg.n_heads, n_kv=cfg.n_kv,
            head_dim=cfg.hd, sin=aux["sin"], cos=aux["cos"],
            window=cfg.window, impl=impl, chunk=cfg.attn_chunk,
            attn_impl=cfg.attn_impl, names=ATTN_NAMES, serve=serve,
            mesh=mesh)
    else:
        o, cache = nnr.rglru_block_forward(lp["rnn"], h, policy, cfg.rnn,
                                           impl=impl, serve=serve, mesh=mesh)
    x = x + o
    x = x + _mlp(lp["mlp"], nnl.rmsnorm_apply(lp["ln2"], x), policy, impl,
                 serve, mesh)
    return x, cache


def _prefill_inputs(cfg, params, tokens, serve=True, mesh=None):
    """Embedded tokens and the per-layer side inputs of a prefill."""
    b, s = tokens.shape
    pos = torch.arange(s, device=tokens.device).expand(b, s)
    sin, cos = nnl.rotary_cache(pos, cfg.hd)
    return T._embed(params, tokens, serve, mesh), {"sin": sin, "cos": cos}


def _head(cfg, params, x, policy, impl, serve=True, mesh=None):
    """Final norm and head -> logits; on a tensor-parallel ``mesh`` the
    rank's vocabulary columns, all-gathered."""
    x = nnl.rmsnorm_apply(params["final_norm"], x)
    logits = Q.qlinear_any(params["head"], x, policy, serve=serve,
                           impl=impl, name="head", layer_class="boundary")
    if mesh is not None:
        logits = mesh_lib.all_gather_model(mesh, logits, dim=-1)
    return logits[..., :cfg.vocab]  # drop the vocab padding


def forward(cfg: RGConfig, params, tokens: torch.Tensor, policy, *,
            mode: str = "serve", impl: str = "auto",
            mesh=None) -> torch.Tensor:
    """tokens (B, S) -> logits (B, S, V) in bf16: the packed serve forward
    (``mode="serve"``; K1, and K3 where ``attn_impl='flash'``) or the QAT
    training forward (``mode="train"``, over an ``init_params("train")``
    tree, no kernel).  ``mesh``: tensor-parallel (module doc)."""
    serve = _serve_mode(mode)
    mesh = T._tp_mesh(cfg, mesh, serve)
    x, aux = _prefill_inputs(cfg, params, tokens, serve, mesh)
    layers = params["layers"]

    def run(h, lo, hi):
        for i in range(lo, hi):
            h = _layer_fwd(cfg, i, layers[i], h, policy, aux, impl=impl,
                           serve=serve, mesh=mesh)[0]
        return h
    for j in range(cfg.n_super):  # a superblock (R, R, A) under remat
        x = remat(cfg, lambda h, j=j: run(h, 3 * j, 3 * j + 3), x)
    x = run(x, 3 * cfg.n_super, cfg.n_layers)
    return _head(cfg, params, x, policy, impl, serve, mesh)


def prefill(cfg: RGConfig, params, tokens: torch.Tensor, policy, *,
            impl: str = "auto", mode: str = "serve", mesh=None):
    """tokens (B, S) -> (last-token logits (B, V), per-layer prefill
    cache: R ``{"h", "conv"}``, A ``(k, v)`` over the whole prompt);
    ``mode="train"`` over an ``init_params("train")`` tree; ``mesh``:
    tensor-parallel, the R states this rank's channels."""
    serve = _serve_mode(mode)
    mesh = T._tp_mesh(cfg, mesh, serve)
    x, aux = _prefill_inputs(cfg, params, tokens, serve, mesh)
    caches = []
    for i, lp in enumerate(params["layers"]):
        x, cache = _layer_fwd(cfg, i, lp, x, policy, aux, impl=impl,
                              serve=serve, mesh=mesh)
        caches.append(cache)
    return _head(cfg, params, x[:, -1:, :], policy, impl,
                 serve, mesh)[:, 0, :], caches


def cache_specs(cfg: RGConfig, batch: int, max_len: int,
                policy=None, model: int = 1) -> List:
    """Per-layer decode cache: R ``{"h": (B, d_rnn), "conv": (B, W-1,
    d_rnn)}`` f32; A the ring pair (B, min(window, max_len), KV, Dh)
    bf16.  ``model`` > 1: one tensor-parallel rank's, its d_rnn / M
    channels and its block of the ring's slots (which must split)."""
    del policy
    w = min(cfg.window, max_len)
    if w % model:
        raise ValueError(f"a ring of {w} slots does not split over "
                         f"{model} 'model' ranks")
    ring = ParamSpec(shape=(batch, w // model, cfg.n_kv, cfg.hd),
                     dtype=torch.bfloat16,
                     axes=("batch", "kv_seq", "kv_heads", "head_dim"),
                     init="zeros")
    return [(ring, ring) if layer_kind(cfg, i) == "A"
            else nnr.rglru_state_spec(cfg.rnn, batch, model)
            for i in range(cfg.n_layers)]


def shard_serve_tree(cfg: RGConfig, params, axes, mesh, shard):
    """This rank's slice of a whole packed tree (``runtime.serve.
    local_params``): ``shard(tree, axes, mesh)``, the ``SERVE_RULES``
    cut, then each RG-LRU conv (whole under the rules) cut to the rank's
    channels."""
    r, m = mesh_lib.model_coords(mesh)
    out = shard(params, axes, mesh)
    n = cfg.rnn.d_rnn // m
    for lp in out["layers"]:
        if "rnn" in lp:
            lp["rnn"]["conv"] = {
                k: Q.take_pieces(v, ((r * n, (r + 1) * n),))
                for k, v in lp["rnn"]["conv"].items()}
    return out


def cache_axes(cfg: RGConfig, policy=None):
    """Logical axes of ``cache_specs``' tree, leaf for leaf."""
    return nnp.axes_tree(cache_specs(cfg, 1, 1, policy))


def _attn_ring_step(cfg, lp, x, ring, length, policy, sin, cos, impl,
                    serve=True, mesh=None):
    """One-token local attention against the ring buffer (updated in
    place at slot ``length % slots``); on a tensor-parallel ``mesh`` the
    rank's heads against its block of the slots, the slot written on its
    owner."""
    b = x.shape[0]
    k_cache, v_cache = ring
    r, m = mesh_lib.model_coords(mesh)
    block = k_cache.shape[1]
    w = block * m
    h_l = cfg.n_heads // m
    fn = lambda key, h, n: _proj(  # noqa: E731
        lp["attn"][key], h, policy, impl, ATTN_NAMES[key],
        serve).reshape(b, 1, n, cfg.hd)
    h = nnl.rmsnorm_apply(lp["ln1"], x)
    q = nnl.apply_rotary(fn("q", h, h_l), sin, cos)
    k = nnl.apply_rotary(fn("k", h, cfg.n_kv), sin, cos)
    v = fn("v", h, cfg.n_kv)
    slot = length % w - r * block
    if 0 <= slot < block:
        k_cache[:, slot:slot + 1] = k.to(k_cache.dtype)
        v_cache[:, slot:slot + 1] = v.to(v_cache.dtype)
    mask_len = w if length >= w - 1 else length + 1
    o = attn.ring_decode_attention(q, k_cache, v_cache, mask_len, mesh)
    x = x + _proj(lp["attn"]["o"], o.reshape(b, 1, h_l * cfg.hd),
                  policy, impl, ATTN_NAMES["o"], serve, mesh)
    x = x + _mlp(lp["mlp"], nnl.rmsnorm_apply(lp["ln2"], x), policy, impl,
                 serve, mesh)
    return x, (k_cache, v_cache)


def _r_step(cfg, lp, x, st, policy, impl, serve=True, mesh=None):
    o, st = nnr.rglru_block_step(lp["rnn"], nnl.rmsnorm_apply(lp["ln1"], x),
                                 st, policy, cfg.rnn, impl=impl, serve=serve,
                                 mesh=mesh)
    x = x + o
    x = x + _mlp(lp["mlp"], nnl.rmsnorm_apply(lp["ln2"], x), policy, impl,
                 serve, mesh)
    return x, st


def decode_step(cfg: RGConfig, params, cache, tokens: torch.Tensor,
                length: int, policy, *, impl: str = "auto",
                mode: str = "serve", mesh=None):
    """One token per row at position ``length`` -> (logits (B, V), the
    per-layer cache: R states replaced, A rings updated in place);
    ``mode="train"`` over an ``init_params("train")`` tree; ``mesh`` as
    ``prefill``'s, the cache this rank's (``cache_specs(model=M)``)."""
    serve = _serve_mode(mode)
    mesh = T._tp_mesh(cfg, mesh, serve)
    b = tokens.shape[0]
    x = T._embed(params, tokens, serve, mesh)
    pos = torch.full((b, 1), length, device=tokens.device)
    sin, cos = nnl.rotary_cache(pos, cfg.hd)
    new = []
    for i, (lp, st) in enumerate(zip(params["layers"], cache)):
        if layer_kind(cfg, i) == "A":
            x, st = _attn_ring_step(cfg, lp, x, st, length, policy, sin, cos,
                                    impl, serve, mesh)
        else:
            x, st = _r_step(cfg, lp, x, st, policy, impl, serve, mesh)
        new.append(st)
    return _head(cfg, params, x, policy, impl, serve, mesh)[:, 0, :], new


def ring_cache(cfg: RGConfig, pre_cache, s: int, specs_: List, device,
               rank: int = 0, ranks: int = 1):
    """Prefill cache of an ``s``-token prompt -> the decode cache of
    ``specs_``: each A layer's last ``min(s, slots)`` keys and values in
    their ring slots (position p in slot p % slots), R states as they
    are (the reference's ``Generator._rg_cache``).  ``rank`` of ``ranks``
    on 'model': ``specs_`` is the rank's block of the slots (the ring
    holds ``ranks`` blocks), and the rank keeps the keys whose slots fall
    in it."""
    out = []
    for i, (pre, spec) in enumerate(zip(pre_cache, specs_)):
        if layer_kind(cfg, i) != "A":
            out.append(pre)
            continue
        block = spec[0].shape[1]
        w = block * ranks
        take = min(s, w)
        pos = torch.arange(s - take, s, device=device)
        local = pos % w - rank * block
        mine = (local >= 0) & (local < block)
        ring = []
        for full, sp in zip(pre, spec):
            buf = torch.zeros(sp.shape, dtype=sp.dtype, device=device)
            buf[:, local[mine]] = full[:, pos[mine]].to(sp.dtype)
            ring.append(buf)
        out.append(tuple(ring))
    return out


# --- workload descriptions (DSE, planner, roofline) --------------------------


def gemm_workload(cfg: RGConfig, tokens: int) -> List[Gemm]:
    d, dr, hd = cfg.d_model, cfg.rnn.d_rnn, cfg.hd
    n_r = cfg.n_layers - cfg.n_super  # recurrent layers
    n_a = cfg.n_super
    return [
        Gemm("rnn_in", tokens, d, dr, count=2 * n_r),
        Gemm("rnn_gates", tokens, dr, dr, count=2 * n_r),
        Gemm("rnn_out", tokens, dr, d, count=n_r),
        Gemm("attn_q", tokens, d, cfg.n_heads * hd, count=n_a),
        Gemm("attn_kv", tokens, d, cfg.n_kv * hd, count=2 * n_a),
        Gemm("attn_o", tokens, cfg.n_heads * hd, d, count=n_a),
        Gemm("mlp", tokens, d, cfg.d_ff, count=3 * cfg.n_layers),
        Gemm("head", tokens, d, cfg.vocab, layer_class="boundary"),
    ]


def active_params(cfg: RGConfig) -> int:
    d, dr, hd = cfg.d_model, cfg.rnn.d_rnn, cfg.hd
    n_r = cfg.n_layers - cfg.n_super
    n_a = cfg.n_super
    n = n_r * (2 * d * dr + 2 * dr * dr + dr * d)
    n += n_a * (d * cfg.n_heads * hd + 2 * d * cfg.n_kv * hd
                + cfg.n_heads * hd * d)
    n += cfg.n_layers * 3 * d * cfg.d_ff
    n += 2 * cfg.vocab * d
    return n


total_params = active_params


def model_flops(cfg: RGConfig, *, tokens: int, step: str) -> float:
    return (6.0 if step == "train" else 2.0) * active_params(cfg) * tokens
