"""Decoder-only LM, serve half (port of ``repro.models.transformer``):
dense GQA blocks with a SwiGLU (or squared-ReLU / GELU) MLP, Mixture-of-
Experts blocks (olmoe, deepseek), MLA attention (deepseek) and a dense
prefix of layers before an MoE stack (deepseek's first layer), through one
config dataclass -- granite-8b/34b, yi-34b, nemotron-4-340b, chameleon-34b
(token ids already include the VQ image range), olmoe-1b-7b and
deepseek-v2-lite-16b.

The JAX package scans the layer stack and, under a depth-heterogeneous
``PrecisionPlan``, splits it into contiguous FORMAT GROUPS (``g0``, ``g1``,
...) so that each ``lax.scan`` is homogeneous; its dense prefix is unrolled
beside the stack as ``dense_layer_{i}``.  The port runs the layers in a
Python loop and keeps them as one per-layer list, ``params["layers"][i]``
for model layer i (the dense prefix at i < ``dense_first_n``), each layer
packed at the formats the plan resolves for ``l{i}.*`` -- the same formats
``_layer_signature`` gives the group holding layer i, so
``scan_format_groups`` stays only as the reference's description of the
stack.  The decode cache is per layer too: the bf16 pair ``(k, v)``
(B, Smax, KV, Dh) for fp and 'qdq' caches, ``{"k", "v"}`` holding packed
leaves (``nn.kvcache``) where the plan packs that tensor, or MLA's latent
pair ``(c_kv (B, Smax, r), k_rope (B, Smax, qk_rope))``, always bf16.

Entry points: ``prefill`` (full prompt -> last-token logits and the cache),
``decode_step`` (one token against the cache, updated in place) and
``decode_steps`` (T tokens against the cache in one forward, the
speculative verify); all take ``impl`` ('auto', 'cuda', 'torch'), which
routes every kernel of the call.  ``forward(mode="train")`` is the QAT
training forward of every arch here: fake-quant projections (GQA or MLA),
fake-quant expert banks behind the router (MoE, ``nn.moe``), the dense
prefix, and the chunked attention, under autograd, every layer under
``torch.utils.checkpoint`` when ``cfg.remat`` (the reference's
``jax.checkpoint``; ``remat_policy="dots"`` keeps the projections' 2-D
products, ``aten.mm``, and recomputes the rest, the batched bank and
attention products included, as ``dots_with_no_batch_dims_saveable``
does).  ``prefill``, ``decode_step`` and ``decode_steps`` take
``mode="train"`` too, over the same train tree: the reference's train-mode
cache path.

Tensor-parallel serving (``mesh=`` with a 'model' axis above 1, every
arch here): ``params`` is this rank's ``nn.partitioning.shard_tree`` slice
under ``SERVE_RULES`` -- q/gate/up and the head by columns, o/down by
rows, the embedding by vocabulary rows, k/v and the norms whole; MLA's q,
uk and uv by heads, dkv and ``kv_norm`` whole; an MoE block's router by
expert columns and its banks by whole experts (expert parallelism,
``nn.moe``), the shared experts and the dense prefix's MLP as a dense MLP
-- and the decode cache this rank's block of ``kv_seq`` (``cache_specs(...,
model=M)``; MLA's latent pair too).  The embedding's int32 codes and the
row shards' int32 accumulators are summed over 'model', the head's columns
all-gathered, so every rank holds the same residual stream and the same
logits, and prefill and decode logits are the one-device logits bitwise
(``nn.attention`` for the split decode, ``nn.moe`` for the combine).

Tensor-parallel training (``forward(mode="train", mesh=)``, the dense
decoders and the MoE archs): ``params`` holds the rank's 'model' blocks
under ``TRAIN_RULES`` -- q, gate, up and the head by columns, o and down
by rows, the embedding by vocabulary rows, MLA's uk/uv by heads, the
router by its experts' columns and each expert bank by whole experts;
k/v, MLA's dkv and the norms whole.  The embedding's rows come from
their owning rank, q/gate/up are column-parallel over the whole residual
stream, o/down row-parallel with f32 partial products summed in rank
order, k/v whole weights of which the rank's q heads use their KV heads,
an MoE block expert-parallel (``nn.moe``: the routed block one device's
bits), MLA by heads (``nn.attention.mla_prefill``), and the head returns
the rank's vocabulary columns (``nn.layers.VocabShard``) to the
vocabulary-parallel loss.  Where the heads (or a dense MLP's width, the
dense prefix's own) do not split, the attention block (or the MLP) runs
whole on every rank.  Every collective runs under autograd
(``launch.mesh.{sum_model, copy_model, gather_model, owned_model}``), and
``remat`` recomputes a layer's collectives in its backward, alike on
every rank.
"""
from __future__ import annotations

import dataclasses
from typing import Any, Dict, List, Optional, Tuple

import torch

from repro_torch.core import plan as plan_lib
from repro_torch.core.dse import Gemm
from repro_torch.core.precision import PrecisionPolicy
from repro_torch.launch import mesh as mesh_lib
from repro_torch.models.remat import remat
from repro_torch.nn import attention as attn
from repro_torch.nn import kvcache
from repro_torch.nn import layers as nnl
from repro_torch.nn import moe as nnmoe
from repro_torch.nn import quantized as Q
from repro_torch.nn.moe import MoEConfig
from repro_torch.nn import param as nnp
from repro_torch.nn.param import ParamSpec

__all__ = ["MLAConfig", "TransformerConfig", "plan_layer_names",
           "mlp_width", "kv_layer_names", "kv_cache_workload",
           "scan_format_groups", "specs", "forward", "prefill",
           "decode_step", "decode_steps", "cache_specs", "kv_formats",
           "gemm_workload", "total_params", "active_params", "model_flops"]


@dataclasses.dataclass(frozen=True)
class MLAConfig:
    kv_lora: int = 512
    qk_nope: int = 128
    qk_rope: int = 64
    v_head: int = 128


@dataclasses.dataclass(frozen=True)
class TransformerConfig:
    name: str
    n_layers: int
    d_model: int
    n_heads: int
    n_kv: int
    d_ff: int
    vocab: int
    head_dim: Optional[int] = None
    act: str = "swiglu"            # 'swiglu' | 'sq_relu' | 'gelu'
    norm: str = "rms"
    moe: Optional[MoEConfig] = None
    mla: Optional[MLAConfig] = None
    rope_base: float = 10000.0
    remat: bool = True             # train: recompute each layer's forward
    remat_policy: str = "full"     # 'full' | 'dots' (keep the 2-D products)
    attn_impl: str = "xla"         # 'xla' | 'flash' (the K3 / K4 kernels)
    dense_first_n: int = 0         # deepseek: the first N layers' MLP dense
    dense_ff: int = 0
    attn_chunk: int = 1024
    family: str = "dense"

    @property
    def hd(self) -> int:
        return self.head_dim or self.d_model // self.n_heads

    @property
    def rope_dim(self) -> int:
        return self.mla.qk_rope if self.mla is not None else self.hd

    @property
    def norm_fns(self):
        if self.norm == "rms":
            return nnl.rmsnorm_spec, nnl.rmsnorm_apply
        return nnl.layernorm_spec, nnl.layernorm_apply


# --- layer namespace and formats ---------------------------------------------


def _layer_bases(cfg: TransformerConfig, dense_mlp: bool) -> Tuple[str, ...]:
    """Base workload layer names of one decoder layer."""
    a = (("q", "dkv", "uk", "uv", "o") if cfg.mla is not None
         else ("q", "k", "v", "o"))
    if cfg.moe is not None and not dense_mlp:
        m = ("expert",) + (("shared",) if cfg.moe.n_shared else ())
    else:
        m = ("mlp",)
    return a + m


def _dense_mlp(cfg: TransformerConfig, i: int) -> bool:
    return i < cfg.dense_first_n


def mlp_width(cfg: TransformerConfig, i: int) -> int:
    """The hidden width of layer i's dense MLP: ``dense_ff`` in the dense
    prefix where the config sets one (deepseek's first layer), else
    ``d_ff``."""
    return cfg.dense_ff if _dense_mlp(cfg, i) and cfg.dense_ff else cfg.d_ff


def plan_layer_names(cfg: TransformerConfig) -> List[str]:
    """Every name a plan may bind: the base projection names, their
    depth-scoped ``l{i}.name`` forms, and the boundary ``head``."""
    names = {"head"}
    for i in range(cfg.n_layers):
        bases = _layer_bases(cfg, _dense_mlp(cfg, i))
        names.update(bases)
        names.update(f"l{i}.{b}" for b in bases)
    return sorted(names)


def kv_layer_names(cfg: TransformerConfig) -> List[str]:
    """Cached-tensor names a plan may bind ``kv_bits`` to; none for MLA,
    whose latent cache is not a per-head tensor and stays bf16."""
    if cfg.mla is not None:
        return []
    names = {"k", "v"}
    for i in range(cfg.n_layers):
        names.update((f"l{i}.k", f"l{i}.v"))
    return sorted(names)


def kv_cache_workload(cfg: TransformerConfig) -> Dict[str, Tuple[int, int]]:
    """{cached tensor name: (kv_heads, head_dim)}; empty for MLA."""
    if cfg.mla is not None:
        return {}
    return {f"l{i}.{t}": (cfg.n_kv, cfg.hd)
            for i in range(cfg.n_layers) for t in ("k", "v")}


def _kv_fmt(cfg, policy, name: str) -> Optional[kvcache.KVFormat]:
    bits = plan_lib.resolve_kv_bits(policy, name)
    if bits is None:
        return None
    return kvcache.KVFormat(bits, policy.kv_slice(bits), cfg.hd)


def kv_formats(cfg, policy):
    """None for a bf16 cache everywhere, else ``(store, [(fmt_k, fmt_v)]
    per depth)`` -- the one gate every cache-shaped code path asks.  A plan
    that quantizes the cache of an MLA model or of one with a dense prefix
    raises, as the reference's ``_kv_formats`` does."""
    if not isinstance(policy, plan_lib.PrecisionPlan) \
            or not policy.kv_enabled():
        return None
    fmts = [(_kv_fmt(cfg, policy, f"l{i}.k"), _kv_fmt(cfg, policy, f"l{i}.v"))
            for i in range(cfg.n_layers)]
    if all(fk is None and fv is None for fk, fv in fmts):
        return None
    if cfg.mla is not None:
        raise ValueError(
            f"plan {policy.name or '<unnamed>'!r} sets KV-cache "
            f"word-lengths but {cfg.name} uses MLA latent caches, which "
            f"have no per-head K/V tensors to quantize")
    if cfg.dense_first_n:
        raise ValueError("KV-cache quantization does not support "
                         "dense-prefix (unrolled) layer stacks")
    return policy.kv_store(), fmts


def _layer_signature(cfg, policy, i: int):
    """The formats of depth i: the weight policy of each projection and the
    cache word-lengths of its K and V."""
    sig = tuple(plan_lib.resolve_policy(policy, f"l{i}.{b}")
                for b in _layer_bases(cfg, dense_mlp=False))
    return sig + (plan_lib.resolve_kv_bits(policy, f"l{i}.k"),
                  plan_lib.resolve_kv_bits(policy, f"l{i}.v"))


def scan_format_groups(cfg: TransformerConfig,
                       policy) -> List[Tuple[int, int]]:
    """Contiguous runs of identical per-layer formats past the dense
    prefix, [(start, length)] in depth order: the reference's scan groups
    ``g{j}``."""
    groups: List[List[int]] = []
    prev = None
    for i in range(cfg.dense_first_n, cfg.n_layers):
        sig = _layer_signature(cfg, policy, i)
        if groups and sig == prev:
            groups[-1][1] += 1
        else:
            groups.append([i, 1])
            prev = sig
    return [tuple(g) for g in groups]


# --- specs -------------------------------------------------------------------


def _mlp_spec(cfg, d_ff, *, serve, policy, lname):
    nm = lname + "mlp"
    if serve:
        mk = lambda i, o, ax: Q.qlinear_serve_spec(  # noqa: E731
            i, o, axes=ax, policy=policy, name=nm)
    else:
        mk = lambda i, o, ax: Q.qlinear_spec(  # noqa: E731
            i, o, axes=ax, name=nm)
    d = cfg.d_model
    up, down = ("embed", "mlp"), ("mlp", "act_embed")
    if cfg.act == "swiglu":
        return {"gate": mk(d, d_ff, up), "up": mk(d, d_ff, up),
                "down": mk(d_ff, d, down)}
    return {"up": mk(d, d_ff, up), "down": mk(d_ff, d, down)}


def _attn_spec(cfg, *, serve, policy, lname):
    if cfg.mla is not None:
        m = cfg.mla
        return attn.mla_spec(cfg.d_model, cfg.n_heads, kv_lora=m.kv_lora,
                             qk_nope=m.qk_nope, qk_rope=m.qk_rope,
                             v_head=m.v_head, serve=serve, policy=policy,
                             lname=lname)
    if serve:
        return attn.gqa_serve_spec(cfg.d_model, cfg.n_heads, cfg.n_kv,
                                   cfg.hd, policy=policy, lname=lname)
    return attn.gqa_spec(cfg.d_model, cfg.n_heads, cfg.n_kv, cfg.hd,
                         lname=lname)


def layer_spec(cfg: TransformerConfig, i: int, mode: str = "train",
               policy=PrecisionPolicy()) -> Dict[str, Any]:
    """Spec of decoder layer i, its projections named ``l{i}.*``: MoE (or
    a dense MLP in the dense prefix, of width ``dense_ff``), MLA or GQA."""
    serve = mode == "serve"
    nspec, _ = cfg.norm_fns
    lname = f"l{i}."
    spec = {"ln1": nspec(cfg.d_model), "ln2": nspec(cfg.d_model),
            "attn": _attn_spec(cfg, serve=serve, policy=policy, lname=lname)}
    if cfg.moe is not None and not _dense_mlp(cfg, i):
        spec["moe"] = nnmoe.moe_spec(cfg.moe, serve=serve, policy=policy,
                                     lname=lname)
    else:
        spec["mlp"] = _mlp_spec(cfg, mlp_width(cfg, i), serve=serve,
                                policy=policy, lname=lname)
    return spec


def specs(cfg: TransformerConfig, mode: str = "train",
          policy=PrecisionPolicy()) -> Dict[str, Any]:
    """Parameter-spec tree for 'train' (float QAT) or 'serve' (packed)."""
    serve = mode == "serve"
    nspec, _ = cfg.norm_fns
    vp = nnl.pad_vocab(cfg.vocab)
    head = (Q.qlinear_serve_spec(cfg.d_model, vp, axes=("embed", "vocab"),
                                 layer_class="boundary", policy=policy,
                                 name="head") if serve else
            Q.qlinear_spec(cfg.d_model, vp, axes=("embed", "vocab"),
                           layer_class="boundary", name="head"))
    return {
        "embed": (nnl.embed_serve_spec(vp, cfg.d_model, policy) if serve
                  else nnl.embed_spec(vp, cfg.d_model)),
        "final_norm": nspec(cfg.d_model),
        "head": head,
        "layers": [layer_spec(cfg, i, mode, policy)
                   for i in range(cfg.n_layers)],
    }


# --- forward -----------------------------------------------------------------


def _apply_mlp(cfg, p, x, policy, impl, lname, per_token=False,
               serve=True, mesh=None, ff=None):
    """The layer's MLP, packed (``serve``) or fake-quant (the QAT
    forward).  ``per_token``: an MoE block routes each token as a group of
    its own (capacity 1, every expert runs it), as a decode step routes its
    one token -- so a verify's T tokens are T decode steps.  On a
    tensor-parallel ``mesh`` gate/up hold this rank's columns and down its
    rows (a row shard, summed over 'model'), an MoE block runs expert
    parallel.  ``ff``: the dense MLP's whole hidden width (``mlp_width``;
    default ``d_ff``), which a training leaf of that width is not cut
    from."""
    if "moe" in p:
        b, s, d = x.shape
        xg = x.reshape(b * s, 1, d) if per_token else x
        return nnmoe.moe_apply(p["moe"], xg, policy, cfg.moe, serve=serve,
                               impl=impl, lname=lname,
                               mesh=mesh).reshape(b, s, d)
    nm = lname + "mlp"
    mp = p["mlp"]
    col = {}
    if mesh is not None and not serve:
        # training: gate/up column-parallel, down row-parallel where the
        # leaves hold shards of d_ff; where d_ff does not split over the
        # ranks they are whole and the MLP runs as on one device
        if mp["up"]["w"].shape[-1] == (ff or cfg.d_ff):
            mesh = None
        else:
            col = {"col_mesh": mesh}
    fn = lambda w, h, **kw: Q.qlinear_any(  # noqa: E731
        w, h, policy, serve=serve, impl=impl, name=nm, **kw)
    if cfg.act == "swiglu":
        h = nnl.swiglu_combine(fn(mp["gate"], x, **col),
                               fn(mp["up"], x, **col))
    else:
        h = fn(mp["up"], x, **col)
        h = nnl.squared_relu(h) if cfg.act == "sq_relu" else nnl.gelu(h)
    if mesh is not None:
        return fn(mp["down"], h, row_mesh=mesh)
    return fn(mp["down"], h)


def _mla_kw(cfg):
    m = cfg.mla
    return dict(n_heads=cfg.n_heads, kv_lora=m.kv_lora, qk_nope=m.qk_nope,
                qk_rope=m.qk_rope, v_head=m.v_head)


def _layer_fwd(cfg, p, x, policy, sin, cos, *, impl, lname, kv_fmts=None,
               kv_store="packed", serve=True, mesh=None, ff=None):
    """Pre-norm block -> (x, this layer's cache); ``serve=False`` is its
    QAT forward (GQA or MLA, a dense MLP or MoE); ``ff``: its dense MLP's
    width (``_apply_mlp``)."""
    _, napply = cfg.norm_fns
    h = napply(p["ln1"], x)
    if cfg.mla is not None:
        o, cache = attn.mla_prefill(p["attn"], h, policy, sin=sin, cos=cos,
                                    impl=impl, chunk=cfg.attn_chunk,
                                    lname=lname, serve=serve, mesh=mesh,
                                    **_mla_kw(cfg))
    else:
        o, cache = attn.gqa_prefill(
            p["attn"], h, policy, n_heads=cfg.n_heads, n_kv=cfg.n_kv,
            head_dim=cfg.hd, sin=sin, cos=cos, impl=impl,
            chunk=cfg.attn_chunk, attn_impl=cfg.attn_impl, lname=lname,
            kv_fmts=kv_fmts, kv_store=kv_store, serve=serve, mesh=mesh)
    x = x + o
    x = x + _apply_mlp(cfg, p, napply(p["ln2"], x), policy, impl, lname,
                       serve=serve, mesh=mesh, ff=ff)
    return x, cache


def _serve_mode(mode: str) -> bool:
    if mode not in ("train", "serve"):
        raise ValueError(f"mode must be 'train' or 'serve', got {mode!r}")
    return mode == "serve"


def _tp_mesh(cfg, mesh, serve: bool = True, forward: bool = False):
    """``mesh`` where its 'model' axis is above 1, else None.  In training
    (``serve=False``) only the full-sequence ``forward`` runs
    tensor-parallel; the train-mode cache path raises."""
    del cfg
    if mesh_lib.model_coords(mesh)[1] == 1:
        return None
    if not serve and not forward:
        raise ValueError("a 'model' axis above 1 in training runs the "
                         "full-sequence forward(mode='train') only")
    return mesh


def _embed(params, tokens, serve=True, mesh=None):
    if serve:
        return nnl.embed_serve_apply(params["embed"], tokens, mesh=mesh)
    return nnl.embed_apply(params["embed"], tokens, mesh=mesh)


def _head_input(cfg, params, x):
    """The final norm: what the head quantizes and multiplies."""
    _, napply = cfg.norm_fns
    return napply(params["final_norm"], x)


def _head(cfg, params, x, policy, impl, serve=True, mesh=None):
    """Final norm and head -> logits over the vocabulary; on a
    tensor-parallel ``mesh`` the rank's vocabulary columns: all-gathered
    over 'model' in rank order when serving (every rank the same logits),
    in training a ``nn.layers.VocabShard`` of the padded vocabulary for
    the vocabulary-parallel loss (the head column-parallel)."""
    h = _head_input(cfg, params, x)
    n = None if serve else params["head"]["w"].shape[-1]
    if mesh is not None and not serve and n != nnl.pad_vocab(cfg.vocab):
        logits = Q.qlinear_apply(params["head"], h, policy, name="head",
                                 layer_class="boundary", col_mesh=mesh)
        return nnl.VocabShard(logits, mesh, mesh_lib.model_coords(mesh)[0]
                              * n, cfg.vocab)
    logits = Q.qlinear_any(params["head"], h, policy, serve=serve, impl=impl,
                           name="head", layer_class="boundary")
    if mesh is not None and serve:
        logits = mesh_lib.all_gather_model(mesh, logits, dim=-1)
    return logits[..., :cfg.vocab]  # drop the vocab padding


def _rotary(cfg, positions):
    return nnl.rotary_cache(positions, cfg.rope_dim, cfg.rope_base)


def _run_layers(cfg, params, x, policy, sin, cos, *, impl, serve=True,
                mesh=None):
    kv_info = kv_formats(cfg, policy)
    store = kv_info[0] if kv_info is not None else "packed"
    caches = []
    for i, lp in enumerate(params["layers"]):
        x, cache = _layer_fwd(
            cfg, lp, x, policy, sin, cos, impl=impl, lname=f"l{i}.",
            kv_fmts=kv_info[1][i] if kv_info is not None else None,
            kv_store=store, serve=serve, mesh=mesh, ff=mlp_width(cfg, i))
        caches.append(cache)
    return x, caches


def _positions(b: int, s: int, start: int, device) -> torch.Tensor:
    return (start + torch.arange(s, device=device)).expand(b, s)


def _train_forward(cfg, params, tokens, policy, mesh=None):
    b, s = tokens.shape
    sin, cos = _rotary(cfg, _positions(b, s, 0, tokens.device))
    kv_info = kv_formats(cfg, policy)
    store = kv_info[0] if kv_info is not None else "packed"
    cut = params["embed"]["table"].shape[0] != nnl.pad_vocab(cfg.vocab)
    x = _embed(params, tokens, serve=False, mesh=mesh if cut else None)
    for i, lp in enumerate(params["layers"]):
        def layer(h, lp=lp, i=i):
            return _layer_fwd(
                cfg, lp, h, policy, sin, cos, impl="torch", lname=f"l{i}.",
                kv_fmts=kv_info[1][i] if kv_info is not None else None,
                kv_store=store, serve=False, mesh=mesh,
                ff=mlp_width(cfg, i))[0]
        x = remat(cfg, layer, x)
    return _head(cfg, params, x, policy, "torch", serve=False, mesh=mesh)


def forward(cfg: TransformerConfig, params, tokens: torch.Tensor, policy, *,
            mode: str = "serve", impl: str = "auto",
            mesh=None) -> torch.Tensor:
    """tokens (B, S) -> logits (B, S, V) in bf16: the packed serve forward
    (``mode="serve"``, over a ``pack_for_serving`` tree) or the QAT
    training forward (``mode="train"``, over an ``init_params("train")``
    tree; ``impl`` unused, no kernel runs).  ``mode`` defaults to "serve"
    here, where the reference's ``forward`` defaults to "train";
    ``ModelAPI.forward`` defaults to "train" in both packages.  ``mesh``:
    tensor-parallel serving, or training, whose logits are then the
    rank's ``nn.layers.VocabShard`` (module doc)."""
    mesh = _tp_mesh(cfg, mesh, _serve_mode(mode), forward=True)
    if not _serve_mode(mode):
        return _train_forward(cfg, params, tokens, policy, mesh)
    b, s = tokens.shape
    sin, cos = _rotary(cfg, _positions(b, s, 0, tokens.device))
    x, _ = _run_layers(cfg, params, _embed(params, tokens, mesh=mesh),
                       policy, sin, cos, impl=impl, mesh=mesh)
    return _head(cfg, params, x, policy, impl, mesh=mesh)


def prefill(cfg: TransformerConfig, params, tokens: torch.Tensor, policy, *,
            impl: str = "auto", mode: str = "serve", mesh=None):
    """tokens (B, S) -> (last-token logits (B, V), per-layer cache).
    ``mode="train"`` runs the QAT forward over an ``init_params("train")``
    tree (no kernel), as the reference's ``prefill(mode="train")``.  On a
    tensor-parallel ``mesh`` the cache is the whole prompt's; the caller
    keeps this rank's ``kv_seq`` block of it (``runtime.serve``)."""
    serve = _serve_mode(mode)
    mesh = _tp_mesh(cfg, mesh, serve)
    b, s = tokens.shape
    sin, cos = _rotary(cfg, _positions(b, s, 0, tokens.device))
    x, caches = _run_layers(cfg, params, _embed(params, tokens, serve, mesh),
                            policy, sin, cos, impl=impl, serve=serve,
                            mesh=mesh)
    return _head(cfg, params, x[:, -1:, :], policy, impl, serve,
                 mesh)[:, 0, :], caches


def cache_specs(cfg: TransformerConfig, batch: int, max_len: int,
                policy=None, model: int = 1) -> List[Any]:
    """Per-layer decode-cache specs (``ParamSpec``, init zeros): MLA's bf16
    latent pair (c_kv (B, Smax, r), k_rope (B, Smax, qk_rope)); else the
    bf16 pair for fp and 'qdq' caches, or under a 'packed' plan ``{"k",
    "v"}`` of packed leaves ``{"p": (P, B, Smax, KV, pd) uint8, "s"/"z":
    (B, Smax, KV) bf16}``, or a bf16 tensor where that tensor stays
    unquantized.  ``model`` > 1: one rank's block of a tensor-parallel
    cache, ``kv_seq`` = ``max_len / model`` (which must divide)."""
    kv_info = kv_formats(cfg, policy)  # raises on MLA under a kv plan
    if model > 1:
        if max_len % model:
            raise ValueError(f"a cache of {max_len} positions does not "
                             f"split over {model} 'model' ranks")
        max_len //= model
    if cfg.mla is not None:
        lat = lambda d: ParamSpec(shape=(batch, max_len, d),  # noqa: E731
                                  dtype=torch.bfloat16,
                                  axes=("batch", "kv_seq", None),
                                  init="zeros")
        return [(lat(cfg.mla.kv_lora), lat(cfg.mla.qk_rope))
                for _ in range(cfg.n_layers)]
    bf16 = ParamSpec(shape=(batch, max_len, cfg.n_kv, cfg.hd),
                     dtype=torch.bfloat16,
                     axes=("batch", "kv_seq", "kv_heads", "head_dim"),
                     init="zeros")
    if kv_info is None or kv_info[0] != "packed":
        return [(bf16, bf16) for _ in range(cfg.n_layers)]

    def tensor_spec(fmt):
        if fmt is None:
            return bf16
        sz = ParamSpec(shape=(batch, max_len, cfg.n_kv), dtype=torch.bfloat16,
                       axes=("batch", "kv_seq", "kv_heads"), init="zeros")
        return {"p": ParamSpec(shape=(fmt.planes, batch, max_len, cfg.n_kv,
                                      fmt.packed_d), dtype=torch.uint8,
                               axes=(None, "batch", "kv_seq", "kv_heads",
                                     None),
                               init="zeros"),
                "s": sz, "z": sz}

    return [{"k": tensor_spec(fk), "v": tensor_spec(fv)}
            for fk, fv in kv_info[1]]


def cache_axes(cfg: TransformerConfig, policy=None):
    """Logical axes of ``cache_specs``' tree, leaf for leaf (a leaf's
    layer is its list index: no 'layers' axis); a tensor-parallel rank's
    block has the same axes, ``kv_seq`` its local ``max_len / M``."""
    return nnp.axes_tree(cache_specs(cfg, 1, 1, policy))


def _extend(cfg, params, cache, tokens, length, policy, *, impl, attn_impl,
            mode, mesh=None):
    """T tokens per row at positions ``length ..`` against the per-layer
    cache (updated in place) -> (logits (B, T, V), cache); ``mode="train"``
    over an ``init_params("train")`` tree, fake-quant; ``mesh``
    tensor-parallel, the cache this rank's ``kv_seq`` block."""
    serve = _serve_mode(mode)
    mesh = _tp_mesh(cfg, mesh, serve)
    kv_info = kv_formats(cfg, policy)
    store = kv_info[0] if kv_info is not None else "packed"
    b, t_new = tokens.shape
    sin, cos = _rotary(cfg, _positions(b, t_new, length, tokens.device))
    _, napply = cfg.norm_fns
    x = _embed(params, tokens, serve, mesh)
    for i, lp in enumerate(params["layers"]):
        lname = f"l{i}."
        h = napply(lp["ln1"], x)
        if cfg.mla is not None:
            o, cache[i] = attn.mla_verify(
                lp["attn"], h, cache[i], length, policy, sin=sin, cos=cos,
                impl=impl, lname=lname, serve=serve, mesh=mesh,
                **_mla_kw(cfg))
        else:
            o, cache[i] = attn.gqa_verify(
                lp["attn"], h, cache[i], length, policy,
                n_heads=cfg.n_heads, n_kv=cfg.n_kv, head_dim=cfg.hd,
                sin=sin, cos=cos, impl=impl, attn_impl=attn_impl,
                lname=lname,
                kv_fmts=kv_info[1][i] if kv_info is not None else None,
                kv_store=store, serve=serve, mesh=mesh)
        x = x + o
        x = x + _apply_mlp(cfg, lp, napply(lp["ln2"], x), policy, impl, lname,
                           per_token=True, serve=serve, mesh=mesh,
                           ff=mlp_width(cfg, i))
    return _head(cfg, params, x, policy, impl, serve, mesh), cache


def decode_step(cfg: TransformerConfig, params, cache, tokens: torch.Tensor,
                length: int, policy, *, impl: str = "auto",
                mode: str = "serve", mesh=None):
    """One new token per row: tokens (B, 1) at position ``length`` against
    the per-layer cache from ``cache_specs`` (updated in place) ->
    (logits (B, V), cache).  It is ``decode_steps`` at T = 1: the verify's
    per-query attention at one query is the decode attention itself.
    ``mode="train"`` runs over an ``init_params("train")`` tree; ``mesh``
    as ``prefill``'s, the cache this rank's ``kv_seq`` block."""
    logits, cache = _extend(cfg, params, cache, tokens, length, policy,
                            impl=impl, attn_impl="xla", mode=mode, mesh=mesh)
    return logits[:, 0, :], cache


def decode_steps(cfg: TransformerConfig, params, cache, tokens: torch.Tensor,
                 length: int, policy, *, impl: str = "auto",
                 attn_impl: str = "xla", mode: str = "serve", mesh=None):
    """T new tokens per row in ONE forward, the speculative verify: tokens
    (B, T) go to positions ``length .. length + T - 1`` of the per-layer
    cache (updated in place) -> (logits (B, T, V), cache), where logits[:,
    t] is the next-token row after tokens[:, :t + 1].

    The T rows equal T sequential ``decode_step`` calls over the same
    tokens: the projections' int32 accumulation is exact, norms, rotary
    (per position ``length + t``) and activation quantization act per row,
    attention runs the decode step's single-query routine per position
    (``nn.attention.gqa_verify``, ``mla_verify``), and an MoE block routes
    each token alone, as a decode step does.  The reference routes a row's
    T tokens as one group there, whose capacity (1 expert slot for 4
    tokens at olmoe's and deepseek's widths) drops tokens that a decode
    step would run, so its own verify is not its decode steps for MoE.
    ``attn_impl='flash'`` takes K4 for a packed cache instead, within K4's
    contract.  ``mode="train"`` runs over an ``init_params("train")`` tree,
    fake-quant and without K4, each MoE token still routed alone.
    ``mesh``: tensor-parallel, as ``decode_step``'s."""
    return _extend(cfg, params, cache, tokens, length, policy, impl=impl,
                   attn_impl=attn_impl, mode=mode, mesh=mesh)


# --- workload descriptions (DSE, planner, roofline) --------------------------


def _per_layer_gemms(cfg: TransformerConfig, tokens: int) -> List[Gemm]:
    """The GEMMs of one decoder layer at ``tokens`` activation rows, as the
    reference counts them (every layer at the stack's shapes)."""
    d, hd = cfg.d_model, cfg.hd
    n_mats = 3 if cfg.act == "swiglu" else 2
    if cfg.mla is not None:
        m = cfg.mla
        out = [Gemm("q", tokens, d, cfg.n_heads * (m.qk_nope + m.qk_rope)),
               Gemm("dkv", tokens, d, m.kv_lora + m.qk_rope),
               Gemm("uk", tokens, m.kv_lora, cfg.n_heads * m.qk_nope),
               Gemm("uv", tokens, m.kv_lora, cfg.n_heads * m.v_head),
               Gemm("o", tokens, cfg.n_heads * m.v_head, d)]
    else:
        out = [Gemm("q", tokens, d, cfg.n_heads * hd),
               Gemm("k", tokens, d, cfg.n_kv * hd),
               Gemm("v", tokens, d, cfg.n_kv * hd),
               Gemm("o", tokens, cfg.n_heads * hd, d)]
    if cfg.moe is not None:
        mc = cfg.moe
        out.append(Gemm("expert", tokens * mc.topk, d, mc.d_ff,
                        count=n_mats))
        if mc.n_shared:
            out.append(Gemm("shared", tokens, d, mc.shared_hidden,
                            count=n_mats))
    else:
        out.append(Gemm("mlp", tokens, d, cfg.d_ff, count=n_mats))
    return out


def gemm_workload(cfg: TransformerConfig, tokens: int) -> List[Gemm]:
    """All GEMMs of one forward over ``tokens`` tokens: each projection
    counted once a layer, and the boundary head."""
    gemms = [dataclasses.replace(g, count=g.count * cfg.n_layers)
             for g in _per_layer_gemms(cfg, tokens)]
    gemms.append(Gemm("head", tokens, cfg.d_model, cfg.vocab,
                      layer_class="boundary"))
    return gemms


def _params(cfg: TransformerConfig, experts: int) -> int:
    """Projection weights of every layer (``experts`` of each bank) plus
    the embedding and head."""
    n = 0
    for g in _per_layer_gemms(cfg, 1):
        per = g.k * g.n * g.count
        if g.name == "expert":
            per = experts * cfg.d_model * cfg.moe.d_ff * \
                (3 if cfg.act == "swiglu" else 2)
        n += per
    return n * cfg.n_layers + 2 * cfg.vocab * cfg.d_model


def total_params(cfg: TransformerConfig) -> int:
    """Every weight: all experts of each bank."""
    return _params(cfg, cfg.moe.n_experts if cfg.moe is not None else 0)


def active_params(cfg: TransformerConfig) -> int:
    """N_active: weights a token touches (MoE: its top-k experts and the
    shared ones)."""
    return _params(cfg, cfg.moe.topk if cfg.moe is not None else 0)


def model_flops(cfg: TransformerConfig, *, tokens: int, step: str) -> float:
    """6·N_active·tokens (train) or 2·N_active·tokens (prefill, decode)."""
    return (6.0 if step == "train" else 2.0) * active_params(cfg) * tokens
