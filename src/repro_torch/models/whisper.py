"""Whisper-style encoder-decoder (port of ``repro.models.whisper``; the
audio backbone only).

The conv/mel frontend is a stub, as in the reference: the caller supplies
frame embeddings (B, n_audio, d_model).  The encoder is bidirectional, the
decoder causal with cross-attention onto the encoder output; positions are
sinusoidal (no rotary).  Decode grows a self-attention cache and reads a
static cross-attention K/V computed once from the encoder output.

The JAX package scans ``enc_layers`` and ``dec_layers`` as stacked trees;
the port keeps two per-layer lists, and the cache ``{"self": [(k, v)],
"cross": [(k, v)]}`` per decoder layer, bf16 (B, S, H, Dh).  Attention is
plain torch on every device (``attn_impl`` stays the reference's 'xla':
whisper never reaches a flash kernel); the projections run on K1.

``forward`` gives the teacher-forced decoder logits at every position:
the packed serve forward (``mode="serve"``) or the QAT training forward
(``mode="train"``, fake-quant projections under autograd, each encoder
and each decoder layer under ``torch.utils.checkpoint`` when
``cfg.remat``, as the reference's ``jax.checkpoint`` of both scan
bodies).  The encoder output feeds every decoder layer's cross K and V;
its gradient is their cotangents' bf16 sum, added as the reference's scan
transpose adds it (``_CrossFanout``).  ``prefill`` and ``decode_step``
take ``mode="train"`` too, over an ``init_params("train")`` tree.

Tensor-parallel serving (``mesh=`` with a 'model' axis of M above 1):
``params`` is this rank's ``SERVE_RULES`` slice -- in both stacks q by its
H/M heads' columns, k/v whole, o by rows; the MLPs' up by columns and
down by rows; the embedding and the head by vocabulary -- exactly as the
dense decoders' (``models.transformer``).  The encoder and the cross
attention attend over the rank's heads at the one-device shape
(``nn.attention.sharded_heads_attention``).  Every rank computes the
whole cross K/V once a prefill (k/v are whole) and keeps its block of the
``n_audio`` frames; both caches shard their sequence axis over 'model'
(``cache_specs(..., model=M)``), and a decode step's self and cross
attention are split-sequence (``nn.attention._split_decode``: the scores
and the V blocks all-gathered, the one-device routine on the whole row),
so prefill and decode logits are the one-device logits bitwise on every
rank.

Tensor-parallel training (``forward(mode="train", mesh=)``): ``params``
is this rank's ``TRAIN_RULES`` slice, cut as for serving (q by heads' and
up by hidden columns, o and down by rows, the embedding and the head by
vocabulary; k/v, the norms whole).  Both stacks' self attention runs
``nn.attention.gqa_prefill(serve=False, mesh=)``; the cross attention's q
is column-parallel and o row-parallel, and its K/V are computed whole
from the encoder output on every rank and cut to the rank's heads by
``launch.mesh.cut_model``, whose backward gathers the heads' cotangents,
so the encoder output's cotangent that reaches ``_CrossFanout`` (and
through it every encoder layer) is whole and the same on every rank.  The
MLPs' up is column-parallel and down row-parallel, and the head returns
the rank's vocabulary columns (``nn.layers.VocabShard``).  Where the
heads do not split (whisper-base's 8 over 16 ranks) the attention blocks
run whole on every rank (``nn.attention._train_heads``); where d_ff does
not, the MLPs do.
"""
from __future__ import annotations

import dataclasses
from typing import Dict, List, Optional

import torch

from repro_torch.core.dse import Gemm
from repro_torch.models.remat import remat
from repro_torch.launch import mesh as mesh_lib
from repro_torch.models.transformer import _embed, _serve_mode, _tp_mesh
from repro_torch.nn import attention as attn
from repro_torch.nn import layers as nnl
from repro_torch.nn import param as nnp
from repro_torch.nn import quantized as Q
from repro_torch.nn.param import ParamSpec

__all__ = ["WhisperConfig", "specs", "encode", "forward", "prefill",
           "decode_step", "cross_decode",
           "cache_specs", "gemm_workload", "active_params", "total_params",
           "model_flops"]


@dataclasses.dataclass(frozen=True)
class WhisperConfig:
    name: str
    n_layers: int            # per side (encoder and decoder)
    d_model: int
    n_heads: int
    d_ff: int
    vocab: int
    n_audio: int = 1500
    scan_layers: bool = True
    scan_unroll: bool = False
    remat: bool = True
    attn_chunk: int = 512
    family: str = "audio"

    @property
    def hd(self) -> int:
        return self.d_model // self.n_heads


# gemm_workload name maps: the workload aggregates q/k/v/o into one entry
# per attention kind, and cross-attention splits by operand rows (q/o run
# over tokens -> dec_cross_q; k/v over frames -> dec_cross_kv).
ENC_ATTN = {k: "enc_qkvo" for k in ("q", "k", "v", "o")}
DEC_ATTN = {k: "dec_self_qkvo" for k in ("q", "k", "v", "o")}
X_ATTN = {"q": "dec_cross_q", "o": "dec_cross_q",
          "k": "dec_cross_kv", "v": "dec_cross_kv"}


def _attn_spec(cfg, serve, policy, names):
    h = cfg.n_heads
    if serve:
        return attn.gqa_serve_spec(cfg.d_model, h, h, cfg.hd, policy=policy,
                                   names=names)
    return attn.gqa_spec(cfg.d_model, h, h, cfg.hd, names=names)


def _mlp_spec(cfg, serve, policy, name):
    if serve:
        mk = lambda i, o, ax: Q.qlinear_serve_spec(  # noqa: E731
            i, o, axes=ax, policy=policy, name=name)
    else:
        mk = lambda i, o, ax: Q.qlinear_spec(  # noqa: E731
            i, o, axes=ax, name=name)
    return {"up": mk(cfg.d_model, cfg.d_ff, ("embed", "mlp")),
            "down": mk(cfg.d_ff, cfg.d_model, ("mlp", "act_embed"))}


def enc_layer_spec(cfg: WhisperConfig, mode: str = "train",
                   policy=None) -> Dict:
    serve = mode == "serve"
    return {"ln1": nnl.layernorm_spec(cfg.d_model),
            "attn": _attn_spec(cfg, serve, policy, ENC_ATTN),
            "ln2": nnl.layernorm_spec(cfg.d_model),
            "mlp": _mlp_spec(cfg, serve, policy, "enc_mlp")}


def dec_layer_spec(cfg: WhisperConfig, mode: str = "train",
                   policy=None) -> Dict:
    serve = mode == "serve"
    return {"ln1": nnl.layernorm_spec(cfg.d_model),
            "attn": _attn_spec(cfg, serve, policy, DEC_ATTN),
            "ln2": nnl.layernorm_spec(cfg.d_model),
            "mlp": _mlp_spec(cfg, serve, policy, "dec_mlp"),
            "ln_x": nnl.layernorm_spec(cfg.d_model),
            "xattn": _attn_spec(cfg, serve, policy, X_ATTN)}


def specs(cfg: WhisperConfig, mode: str = "train", policy=None) -> Dict:
    serve = mode == "serve"
    vp = nnl.pad_vocab(cfg.vocab)
    return {
        "embed": (nnl.embed_serve_spec(vp, cfg.d_model, policy) if serve
                  else nnl.embed_spec(vp, cfg.d_model)),
        "enc_layers": [enc_layer_spec(cfg, mode, policy)
                       for _ in range(cfg.n_layers)],
        "enc_norm": nnl.layernorm_spec(cfg.d_model),
        "dec_layers": [dec_layer_spec(cfg, mode, policy)
                       for _ in range(cfg.n_layers)],
        "dec_norm": nnl.layernorm_spec(cfg.d_model),
        "head": (Q.qlinear_serve_spec(cfg.d_model, vp, axes=("embed", "vocab"),
                                      layer_class="boundary", policy=policy,
                                      name="head") if serve
                 else Q.qlinear_spec(cfg.d_model, vp, axes=("embed", "vocab"),
                                     layer_class="boundary", name="head")),
    }


def _sinusoid(positions: torch.Tensor, dim: int) -> torch.Tensor:
    sin, cos = nnl.rotary_cache(positions, dim)
    return torch.cat([sin, cos], dim=-1)


def _proj(p, x, policy, impl, name, serve=True, row_mesh=None, **kw):
    """One projection; ``row_mesh`` (serve only): a row shard summed over
    that tensor-parallel mesh's 'model' axis."""
    if row_mesh is not None:
        kw["row_mesh"] = row_mesh
    return Q.qlinear_any(p, x, policy, serve=serve, impl=impl, name=name,
                         **kw)


def _mlp(p, h, policy, impl, name, serve=True, mesh=None, d_ff=0):
    """up, gelu, down; on a tensor-parallel ``mesh`` up holds this rank's
    columns and down its rows (in training up column-parallel, where its
    leaf is a shard of ``d_ff`` columns; a whole one runs as on one
    device)."""
    col = {}
    if mesh is not None and not serve:
        if p["up"]["w"].shape[-1] == d_ff:
            mesh = None
        else:
            col = {"col_mesh": mesh}
    return _proj(p["down"], nnl.gelu(_proj(p["up"], h, policy, impl, name,
                                           serve, **col)),
                 policy, impl, name, serve, row_mesh=mesh)


def _local_heads(cfg, mesh) -> slice:
    """The heads this rank holds on a tensor-parallel ``mesh``."""
    r, m = mesh_lib.model_coords(mesh)
    h_l = cfg.n_heads // m
    return slice(r * h_l, (r + 1) * h_l)


def _positions(b: int, s: int, device) -> torch.Tensor:
    return torch.arange(s, device=device).expand(b, s)


def _enc_layer_fwd(cfg, lp, x, policy, *, impl, serve=True, mesh=None):
    h = nnl.layernorm_apply(lp["ln1"], x)
    o, _ = attn.gqa_prefill(lp["attn"], h, policy, n_heads=cfg.n_heads,
                            n_kv=cfg.n_heads, head_dim=cfg.hd, sin=None,
                            cos=None, causal=False, rope=False, impl=impl,
                            chunk=cfg.attn_chunk, names=ENC_ATTN,
                            serve=serve, mesh=mesh)
    x = x + o
    return x + _mlp(lp["mlp"], nnl.layernorm_apply(lp["ln2"], x), policy,
                    impl, "enc_mlp", serve, mesh, cfg.d_ff)


def _enc_inputs(cfg, frames: torch.Tensor) -> torch.Tensor:
    b, t, _ = frames.shape
    return (frames.to(torch.bfloat16)
            + _sinusoid(_positions(b, t, frames.device),
                        cfg.d_model).to(torch.bfloat16))


def encode(cfg: WhisperConfig, params, frames: torch.Tensor, policy, *,
           impl: str = "auto", serve: bool = True,
           mesh=None) -> torch.Tensor:
    """frames (B, T, D) stub embeddings -> encoder output (B, T, D);
    ``serve=False`` is the QAT forward, each layer under remat; ``mesh``
    tensor-parallel (module doc), the output whole on every rank."""
    mesh = _tp_mesh(cfg, mesh, serve, forward=True)
    x = _enc_inputs(cfg, frames)
    for lp in params["enc_layers"]:
        x = remat(cfg, lambda h, lp=lp: _enc_layer_fwd(
            cfg, lp, h, policy, impl=impl, serve=serve, mesh=mesh), x)
    return nnl.layernorm_apply(params["enc_norm"], x)


def _cross_kv(cfg, xp, enc_out, policy, impl, serve=True):
    b, t, _ = enc_out.shape
    return tuple(_proj(xp[key], enc_out, policy, impl,
                       X_ATTN[key], serve).reshape(b, t, cfg.n_heads, cfg.hd)
                 for key in ("k", "v"))


def _cross_train(cfg, xp, h, enc_out, policy, impl, mesh):
    """The cross attention's QAT forward on a tensor-parallel ``mesh`` (or
    None): q column-parallel by heads, K/V whole and cut to the rank's
    heads (``cut_model``), attention over those heads, o row-parallel;
    the block whole where the heads do not split -> (out (B, S, D), the
    whole K, V)."""
    width = cfg.n_heads * cfg.hd
    xp, _, m = attn._train_heads(xp, mesh, cfg.n_heads, {"q": width},
                                 {"o": width})
    tp = mesh if m > 1 else None
    col = {} if tp is None else {"col_mesh": tp}
    b, s, _ = h.shape
    q = _proj(xp["q"], h, policy, impl, X_ATTN["q"], False,
              **col).reshape(b, s, cfg.n_heads // m, cfg.hd)
    k, v = _cross_kv(cfg, xp, enc_out, policy, impl, False)
    o = attn.chunked_attention(q, mesh_lib.cut_model(tp, k, 2),
                               mesh_lib.cut_model(tp, v, 2), causal=False,
                               chunk=cfg.attn_chunk)
    return _proj(xp["o"], o.reshape(b, s, -1), policy, impl, X_ATTN["o"],
                 False, row_mesh=tp), k, v


def _layer_fwd(cfg, i, lp, x, policy, aux, *, impl, serve=True, mesh=None):
    """Prefill of decoder layer i -> (x, (self (k, v), cross (k, v)));
    ``aux`` holds the encoder output.  On a tensor-parallel ``mesh`` both
    caches are whole (every head, every position), of which the caller
    keeps the rank's ``kv_seq`` block."""
    del i
    h = nnl.layernorm_apply(lp["ln1"], x)
    o, kv = attn.gqa_prefill(lp["attn"], h, policy, n_heads=cfg.n_heads,
                             n_kv=cfg.n_heads, head_dim=cfg.hd, sin=None,
                             cos=None, causal=True, rope=False, impl=impl,
                             chunk=cfg.attn_chunk, names=DEC_ATTN,
                             serve=serve, mesh=mesh)
    x = x + o
    h = nnl.layernorm_apply(lp["ln_x"], x)
    if not serve:
        o, k, v = _cross_train(cfg, lp["xattn"], h, aux["enc_out"], policy,
                               impl, mesh)
        x = x + o
    else:
        heads = _local_heads(cfg, mesh)
        q = _proj(lp["xattn"]["q"], h, policy, impl, X_ATTN["q"],
                  serve).reshape(*h.shape[:2], heads.stop - heads.start,
                                 cfg.hd)
        k, v = _cross_kv(cfg, lp["xattn"], aux["enc_out"], policy, impl,
                         serve)
        o = attn.sharded_heads_attention(
            q, k[:, :, heads], v[:, :, heads], *mesh_lib.model_coords(mesh),
            causal=False, chunk=cfg.attn_chunk)
        x = x + _proj(lp["xattn"]["o"], o.reshape(*h.shape[:2], -1), policy,
                      impl, X_ATTN["o"], serve, row_mesh=mesh)
    x = x + _mlp(lp["mlp"], nnl.layernorm_apply(lp["ln2"], x), policy, impl,
                 "dec_mlp", serve, mesh, cfg.d_ff)
    return x, (kv, (k, v))


def _zero_frames(cfg, b, device):
    return torch.zeros((b, cfg.n_audio, cfg.d_model), dtype=torch.bfloat16,
                       device=device)


def _prefill_inputs(cfg, params, tokens, frames, policy, impl, serve=True,
                    mesh=None):
    """Embedded tokens plus positions, and the encoder output."""
    b, s = tokens.shape
    if frames is None:
        frames = _zero_frames(cfg, b, tokens.device)
    enc_out = encode(cfg, params, frames, policy, impl=impl, serve=serve,
                     mesh=mesh)
    if not serve and mesh is not None \
            and params["embed"]["table"].shape[0] == nnl.pad_vocab(cfg.vocab):
        mesh = None   # a whole table (a vocabulary that does not split)
    x = _embed(params, tokens, serve, mesh)
    x = x + _sinusoid(_positions(b, s, tokens.device),
                      cfg.d_model).to(x.dtype)
    return x, {"enc_out": enc_out}


def _head(cfg, params, x, policy, impl, serve=True, mesh=None):
    """Final norm and head -> logits; on a tensor-parallel ``mesh`` the
    rank's vocabulary columns: all-gathered over 'model' in rank order
    when serving, in training a ``nn.layers.VocabShard`` for the
    vocabulary-parallel loss (the head column-parallel), as
    ``models.transformer``'s head."""
    x = nnl.layernorm_apply(params["dec_norm"], x)
    n = None if serve else params["head"]["w"].shape[-1]
    if mesh is not None and not serve and n != nnl.pad_vocab(cfg.vocab):
        logits = Q.qlinear_apply(params["head"], x, policy, name="head",
                                 layer_class="boundary", col_mesh=mesh)
        return nnl.VocabShard(logits, mesh,
                              mesh_lib.model_coords(mesh)[0] * n, cfg.vocab)
    logits = _proj(params["head"], x, policy, impl, "head", serve,
                   layer_class="boundary")
    if mesh is not None and serve:
        logits = mesh_lib.all_gather_model(mesh, logits, dim=-1)
    return logits[..., :cfg.vocab]  # drop the vocab padding


class _CrossFanout(torch.autograd.Function):
    """The encoder output handed to each of ``n`` decoder layers as a view
    of its own.  Its gradient is the bf16 sum of the layers' cotangents
    as the reference's scan transpose adds them: a carry that starts at
    zero and takes each layer's cotangent in turn, the last layer first."""

    @staticmethod
    def forward(ctx, x, n):
        return tuple(x.view_as(x) for _ in range(n))

    @staticmethod
    def backward(ctx, *gs):
        acc = None
        for g in reversed(gs):
            if g is not None:
                acc = g if acc is None else acc + g
        return acc, None


def forward(cfg: WhisperConfig, params, tokens: torch.Tensor, policy, *,
            frames: Optional[torch.Tensor] = None, mode: str = "serve",
            impl: str = "auto", mesh=None) -> torch.Tensor:
    """Teacher-forced decoder logits (B, S, V) in bf16 of tokens (B, S)
    given frames (B, n_audio, D) (zeros when None): the packed serve
    forward (``mode="serve"``) or the QAT training forward
    (``mode="train"``, over an ``init_params("train")`` tree, no
    kernel).  ``mesh``: tensor-parallel serving, or training, whose
    logits are then the rank's ``nn.layers.VocabShard`` (module doc)."""
    serve = _serve_mode(mode)
    mesh = _tp_mesh(cfg, mesh, serve, forward=True)
    x, aux = _prefill_inputs(cfg, params, tokens, frames, policy, impl,
                             serve, mesh)
    layers = params["dec_layers"]
    enc = _CrossFanout.apply(aux["enc_out"], len(layers))
    for i, lp in enumerate(layers):
        x = remat(cfg, lambda h, e, i=i, lp=lp: _layer_fwd(
            cfg, i, lp, h, policy, {"enc_out": e}, impl=impl,
            serve=serve, mesh=mesh)[0], x, enc[i])
    return _head(cfg, params, x, policy, impl, serve, mesh)


def prefill(cfg: WhisperConfig, params, tokens: torch.Tensor, policy, *,
            frames: Optional[torch.Tensor] = None, impl: str = "auto",
            mode: str = "serve", mesh=None):
    """tokens (B, S), frames (B, n_audio, D) (zeros when None) ->
    (last-token logits (B, V), ``{"self": [(k, v)], "cross": [(k, v)]}``);
    ``mode="train"`` over an ``init_params("train")`` tree.  On a
    tensor-parallel ``mesh`` the caches are whole; the caller keeps the
    rank's ``kv_seq`` block of each (``runtime.serve``)."""
    serve = _serve_mode(mode)
    mesh = _tp_mesh(cfg, mesh, serve)
    x, aux = _prefill_inputs(cfg, params, tokens, frames, policy, impl,
                             serve, mesh)
    cache = {"self": [], "cross": []}
    for i, lp in enumerate(params["dec_layers"]):
        x, (kv, xkv) = _layer_fwd(cfg, i, lp, x, policy, aux, impl=impl,
                                  serve=serve, mesh=mesh)
        cache["self"].append(kv)
        cache["cross"].append(xkv)
    return _head(cfg, params, x[:, -1:, :], policy, impl,
                 serve, mesh)[:, 0, :], cache


def cache_specs(cfg: WhisperConfig, batch: int, max_len: int,
                policy=None, model: int = 1) -> Dict[str, List]:
    """The decode cache: per decoder layer the self pair (B, max_len, H,
    Dh) and the cross pair (B, n_audio, H, Dh), bf16.  ``model`` > 1: one
    tensor-parallel rank's block of each sequence axis (``max_len`` and
    ``n_audio`` must divide)."""
    del policy
    for name, n in (("a cache of", max_len), ("n_audio", cfg.n_audio)):
        if n % model:
            raise ValueError(f"{name} {n} positions does not split over "
                             f"{model} 'model' ranks")
    kv = lambda s: ParamSpec(shape=(batch, s, cfg.n_heads, cfg.hd),  # noqa
                             dtype=torch.bfloat16,
                             axes=("batch", "kv_seq", "heads", "head_dim"),
                             init="zeros")
    return {"self": [(kv(max_len // model), kv(max_len // model))
                     for _ in range(cfg.n_layers)],
            "cross": [(kv(cfg.n_audio // model), kv(cfg.n_audio // model))
                      for _ in range(cfg.n_layers)]}


def cache_axes(cfg: WhisperConfig, policy=None):
    """Logical axes of ``cache_specs``' tree, leaf for leaf."""
    return nnp.axes_tree(cache_specs(cfg, 1, 1, policy))


def cross_decode(q: torch.Tensor, ck: torch.Tensor, cv: torch.Tensor,
                 n_audio: int, mesh=None) -> torch.Tensor:
    """A decode step's cross attention: q (B, 1, H_local, Dh) against the
    cross K/V over all ``n_audio`` frames -> (B, 1, H_local, Dh).  On a
    tensor-parallel ``mesh`` the cache is this rank's block of the frames
    and the attention split-sequence (``nn.attention._split_decode``),
    bitwise ``decode_attention`` over the whole cache."""
    if mesh is None:
        return attn.decode_attention(q, ck, cv, n_audio)
    return attn._split_decode(q, ck, cv, None, None, n_audio - 1, None,
                              mesh, streamed=False)


def decode_step(cfg: WhisperConfig, params, cache, tokens: torch.Tensor,
                length: int, policy, *, impl: str = "auto",
                mode: str = "serve", mesh=None):
    """One token per row at ``length`` -> (logits (B, V), cache); the self
    cache is written in place, the cross K/V only read; ``mode="train"``
    over an ``init_params("train")`` tree; ``mesh`` tensor-parallel, both
    caches this rank's ``kv_seq`` blocks."""
    serve = _serve_mode(mode)
    mesh = _tp_mesh(cfg, mesh, serve)
    b = tokens.shape[0]
    x = _embed(params, tokens, serve, mesh)
    pos = torch.full((b, 1), length, device=tokens.device)
    x = x + _sinusoid(pos, cfg.d_model).to(x.dtype)
    heads = _local_heads(cfg, mesh)
    for lp, sc, (ck, cv) in zip(params["dec_layers"], cache["self"],
                                cache["cross"]):
        h = nnl.layernorm_apply(lp["ln1"], x)
        o, _ = attn.gqa_decode(lp["attn"], h, sc, length, policy,
                               n_heads=cfg.n_heads, n_kv=cfg.n_heads,
                               head_dim=cfg.hd, sin=None, cos=None,
                               rope=False, impl=impl, names=DEC_ATTN,
                               serve=serve, mesh=mesh)
        x = x + o
        h = nnl.layernorm_apply(lp["ln_x"], x)
        q = _proj(lp["xattn"]["q"], h, policy, impl, X_ATTN["q"],
                  serve).reshape(b, 1, heads.stop - heads.start, cfg.hd)
        o = cross_decode(q, ck, cv, cfg.n_audio, mesh)
        x = x + _proj(lp["xattn"]["o"], o.reshape(b, 1, -1), policy, impl,
                      X_ATTN["o"], serve, row_mesh=mesh)
        x = x + _mlp(lp["mlp"], nnl.layernorm_apply(lp["ln2"], x), policy,
                     impl, "dec_mlp", serve, mesh)
    return _head(cfg, params, x, policy, impl, serve, mesh)[:, 0, :], cache


# --- workload descriptions (DSE, planner, roofline) --------------------------


def gemm_workload(cfg: WhisperConfig, tokens: int,
                  frames: Optional[int] = None) -> List[Gemm]:
    frames = frames or cfg.n_audio
    d, hd, h = cfg.d_model, cfg.hd, cfg.n_heads
    n = cfg.n_layers
    return [
        Gemm("enc_qkvo", frames, d, h * hd, count=4 * n),
        Gemm("enc_mlp", frames, d, cfg.d_ff, count=2 * n),
        Gemm("dec_self_qkvo", tokens, d, h * hd, count=4 * n),
        Gemm("dec_cross_q", tokens, d, h * hd, count=2 * n),
        Gemm("dec_cross_kv", frames, d, h * hd, count=2 * n),
        Gemm("dec_mlp", tokens, d, cfg.d_ff, count=2 * n),
        Gemm("head", tokens, d, cfg.vocab, layer_class="boundary"),
    ]


def active_params(cfg: WhisperConfig) -> int:
    d, hd, h, n = cfg.d_model, cfg.hd, cfg.n_heads, cfg.n_layers
    enc = n * (4 * d * h * hd + 2 * d * cfg.d_ff)
    dec = n * (8 * d * h * hd + 2 * d * cfg.d_ff)
    return enc + dec + 2 * cfg.vocab * d


total_params = active_params


def model_flops(cfg: WhisperConfig, *, tokens: int, step: str) -> float:
    return (6.0 if step == "train" else 2.0) * active_params(cfg) * tokens
