"""Decoder-only LM, dense family, serve half (port of
``repro.models.transformer``): granite-style GQA blocks with a SwiGLU (or
squared-ReLU / GELU) MLP.

The JAX package scans the layer stack and, under a depth-heterogeneous
``PrecisionPlan``, splits it into contiguous FORMAT GROUPS (``g0``, ``g1``,
...) so that each ``lax.scan`` is homogeneous.  The port runs the layers in
a Python loop and keeps them as a per-layer list, ``params["layers"][i]``,
each layer packed at the formats the plan resolves for ``l{i}.*`` -- the
same formats ``_layer_signature`` gives the group holding layer i, so
``scan_format_groups`` stays only as the reference's description of the
stack.  The decode cache is per layer too: the bf16 pair ``(k, v)``
(B, Smax, KV, Dh) for fp and 'qdq' caches, or ``{"k", "v"}`` holding packed
leaves (``nn.kvcache``) where the plan packs that tensor.

Entry points: ``prefill`` (full prompt -> last-token logits and the cache),
``decode_step`` (one token against the cache, updated in place) and
``decode_steps`` (T tokens against the cache in one forward, the
speculative verify); all take ``impl`` ('auto', 'cuda', 'torch'), which
routes every kernel of the call.  The training forward, MoE, MLA and the
dense-prefix stacks are not ported yet.
"""
from __future__ import annotations

import dataclasses
from typing import Any, Dict, List, Optional, Tuple

import torch

from repro_torch.core import plan as plan_lib
from repro_torch.core.precision import PrecisionPolicy
from repro_torch.nn import attention as attn
from repro_torch.nn import kvcache
from repro_torch.nn import layers as nnl
from repro_torch.nn import quantized as Q
from repro_torch.nn.param import ParamSpec

__all__ = ["TransformerConfig", "plan_layer_names", "kv_layer_names",
           "kv_cache_workload", "scan_format_groups", "specs", "forward",
           "prefill", "decode_step", "decode_steps", "cache_specs",
           "kv_formats"]

LAYER_BASES = ("q", "k", "v", "o", "mlp")


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
    rope_base: float = 10000.0
    attn_impl: str = "xla"         # 'xla' | 'flash' (the K3 / K4 kernels)
    attn_chunk: int = 1024
    family: str = "dense"

    @property
    def hd(self) -> int:
        return self.head_dim or self.d_model // self.n_heads

    @property
    def norm_fns(self):
        if self.norm == "rms":
            return nnl.rmsnorm_spec, nnl.rmsnorm_apply
        return nnl.layernorm_spec, nnl.layernorm_apply


# --- layer namespace and formats ---------------------------------------------------


def plan_layer_names(cfg: TransformerConfig) -> List[str]:
    """Every name a plan may bind: the base projection names, their
    depth-scoped ``l{i}.name`` forms, and the boundary ``head``."""
    names = {"head", *LAYER_BASES}
    for i in range(cfg.n_layers):
        names.update(f"l{i}.{b}" for b in LAYER_BASES)
    return sorted(names)


def kv_layer_names(cfg: TransformerConfig) -> List[str]:
    """Cached-tensor names a plan may bind ``kv_bits`` to."""
    names = {"k", "v"}
    for i in range(cfg.n_layers):
        names.update((f"l{i}.k", f"l{i}.v"))
    return sorted(names)


def kv_cache_workload(cfg: TransformerConfig) -> Dict[str, Tuple[int, int]]:
    """{cached tensor name: (kv_heads, head_dim)}."""
    return {f"l{i}.{t}": (cfg.n_kv, cfg.hd)
            for i in range(cfg.n_layers) for t in ("k", "v")}


def _kv_fmt(cfg, policy, name: str) -> Optional[kvcache.KVFormat]:
    bits = plan_lib.resolve_kv_bits(policy, name)
    if bits is None:
        return None
    return kvcache.KVFormat(bits, policy.kv_slice(bits), cfg.hd)


def kv_formats(cfg, policy):
    """None for a bf16 cache everywhere, else ``(store, [(fmt_k, fmt_v)]
    per depth)`` -- the one gate every cache-shaped code path asks."""
    if not isinstance(policy, plan_lib.PrecisionPlan) \
            or not policy.kv_enabled():
        return None
    fmts = [(_kv_fmt(cfg, policy, f"l{i}.k"), _kv_fmt(cfg, policy, f"l{i}.v"))
            for i in range(cfg.n_layers)]
    if all(fk is None and fv is None for fk, fv in fmts):
        return None
    return policy.kv_store(), fmts


def _layer_signature(cfg, policy, i: int):
    """The formats of depth i: the weight policy of each projection and the
    cache word-lengths of its K and V."""
    sig = tuple(plan_lib.resolve_policy(policy, f"l{i}.{b}")
                for b in LAYER_BASES)
    return sig + (plan_lib.resolve_kv_bits(policy, f"l{i}.k"),
                  plan_lib.resolve_kv_bits(policy, f"l{i}.v"))


def scan_format_groups(cfg: TransformerConfig,
                       policy) -> List[Tuple[int, int]]:
    """Contiguous runs of identical per-layer formats, [(start, length)] in
    depth order: the reference's scan groups ``g{j}``."""
    groups: List[List[int]] = []
    prev = None
    for i in range(cfg.n_layers):
        sig = _layer_signature(cfg, policy, i)
        if groups and sig == prev:
            groups[-1][1] += 1
        else:
            groups.append([i, 1])
            prev = sig
    return [tuple(g) for g in groups]


# --- specs -------------------------------------------------------------------------


def _mlp_spec(cfg, *, serve, policy, lname):
    nm = lname + "mlp"
    if serve:
        mk = lambda i, o: Q.qlinear_serve_spec(  # noqa: E731
            i, o, policy=policy, name=nm)
    else:
        mk = lambda i, o: Q.qlinear_spec(i, o, name=nm)  # noqa: E731
    d, f = cfg.d_model, cfg.d_ff
    if cfg.act == "swiglu":
        return {"gate": mk(d, f), "up": mk(d, f), "down": mk(f, d)}
    return {"up": mk(d, f), "down": mk(f, d)}


def layer_spec(cfg: TransformerConfig, i: int, mode: str = "train",
               policy=PrecisionPolicy()) -> Dict[str, Any]:
    """Spec of decoder layer i, its projections named ``l{i}.*``."""
    serve = mode == "serve"
    nspec, _ = cfg.norm_fns
    lname = f"l{i}."
    a = (attn.gqa_serve_spec(cfg.d_model, cfg.n_heads, cfg.n_kv, cfg.hd,
                             policy=policy, lname=lname) if serve else
         attn.gqa_spec(cfg.d_model, cfg.n_heads, cfg.n_kv, cfg.hd,
                       lname=lname))
    return {"ln1": nspec(cfg.d_model), "ln2": nspec(cfg.d_model), "attn": a,
            "mlp": _mlp_spec(cfg, serve=serve, policy=policy, lname=lname)}


def specs(cfg: TransformerConfig, mode: str = "train",
          policy=PrecisionPolicy()) -> Dict[str, Any]:
    """Parameter-spec tree for 'train' (float QAT) or 'serve' (packed)."""
    serve = mode == "serve"
    nspec, _ = cfg.norm_fns
    vp = nnl.pad_vocab(cfg.vocab)
    head = (Q.qlinear_serve_spec(cfg.d_model, vp, layer_class="boundary",
                                 policy=policy, name="head") if serve else
            Q.qlinear_spec(cfg.d_model, vp, layer_class="boundary",
                           name="head"))
    return {
        "embed": (nnl.embed_serve_spec(vp, cfg.d_model, policy) if serve
                  else nnl.embed_spec(vp, cfg.d_model)),
        "final_norm": nspec(cfg.d_model),
        "head": head,
        "layers": [layer_spec(cfg, i, mode, policy)
                   for i in range(cfg.n_layers)],
    }


# --- forward -------------------------------------------------------------------------


def _apply_mlp(cfg, p, x, policy, impl, lname):
    nm = lname + "mlp"
    fn = lambda w, h: Q.qlinear_serve_apply(  # noqa: E731
        w, h, policy, impl=impl, name=nm)
    mp = p["mlp"]
    if cfg.act == "swiglu":
        h = nnl.swiglu_combine(fn(mp["gate"], x), fn(mp["up"], x))
    else:
        h = fn(mp["up"], x)
        h = nnl.squared_relu(h) if cfg.act == "sq_relu" else nnl.gelu(h)
    return fn(mp["down"], h)


def _layer_fwd(cfg, p, x, policy, sin, cos, *, impl, lname, kv_fmts=None,
               kv_store="packed"):
    """Pre-norm block -> (x, this layer's cache)."""
    _, napply = cfg.norm_fns
    o, cache = attn.gqa_prefill(
        p["attn"], napply(p["ln1"], x), policy, n_heads=cfg.n_heads,
        n_kv=cfg.n_kv, head_dim=cfg.hd, sin=sin, cos=cos, impl=impl,
        chunk=cfg.attn_chunk, attn_impl=cfg.attn_impl, lname=lname,
        kv_fmts=kv_fmts, kv_store=kv_store)
    x = x + o
    x = x + _apply_mlp(cfg, p, napply(p["ln2"], x), policy, impl, lname)
    return x, cache


def _embed(params, tokens):
    return nnl.embed_serve_apply(params["embed"], tokens)


def _head_input(cfg, params, x):
    """The final norm: what the head quantizes and multiplies."""
    _, napply = cfg.norm_fns
    return napply(params["final_norm"], x)


def _head(cfg, params, x, policy, impl):
    logits = Q.qlinear_serve_apply(params["head"], _head_input(cfg, params, x),
                                   policy, layer_class="boundary", impl=impl,
                                   name="head")
    return logits[..., :cfg.vocab]  # drop the vocab padding


def _rotary(cfg, positions):
    return nnl.rotary_cache(positions, cfg.hd, cfg.rope_base)


def _run_layers(cfg, params, x, policy, sin, cos, *, impl):
    kv_info = kv_formats(cfg, policy)
    store = kv_info[0] if kv_info is not None else "packed"
    caches = []
    for i, lp in enumerate(params["layers"]):
        x, cache = _layer_fwd(
            cfg, lp, x, policy, sin, cos, impl=impl, lname=f"l{i}.",
            kv_fmts=kv_info[1][i] if kv_info is not None else None,
            kv_store=store)
        caches.append(cache)
    return x, caches


def _positions(b: int, s: int, start: int, device) -> torch.Tensor:
    return (start + torch.arange(s, device=device)).expand(b, s)


def forward(cfg: TransformerConfig, params, tokens: torch.Tensor, policy, *,
            impl: str = "auto") -> torch.Tensor:
    """Serve forward: tokens (B, S) -> logits (B, S, V) in bf16."""
    b, s = tokens.shape
    sin, cos = _rotary(cfg, _positions(b, s, 0, tokens.device))
    x, _ = _run_layers(cfg, params, _embed(params, tokens), policy, sin, cos,
                       impl=impl)
    return _head(cfg, params, x, policy, impl)


def prefill(cfg: TransformerConfig, params, tokens: torch.Tensor, policy, *,
            impl: str = "auto"):
    """tokens (B, S) -> (last-token logits (B, V), per-layer cache)."""
    b, s = tokens.shape
    sin, cos = _rotary(cfg, _positions(b, s, 0, tokens.device))
    x, caches = _run_layers(cfg, params, _embed(params, tokens), policy, sin,
                            cos, impl=impl)
    return _head(cfg, params, x[:, -1:, :], policy, impl)[:, 0, :], caches


def cache_specs(cfg: TransformerConfig, batch: int, max_len: int,
                policy=None) -> List[Any]:
    """Per-layer decode-cache specs (``ParamSpec``, init zeros): the bf16
    pair for fp and 'qdq' caches; under a 'packed' plan ``{"k", "v"}`` of
    packed leaves ``{"p": (P, B, Smax, KV, pd) uint8, "s"/"z": (B, Smax,
    KV) bf16}``, or a bf16 tensor where that tensor stays unquantized."""
    bf16 = ParamSpec(shape=(batch, max_len, cfg.n_kv, cfg.hd),
                     dtype=torch.bfloat16, init="zeros")
    kv_info = kv_formats(cfg, policy)
    if kv_info is None or kv_info[0] != "packed":
        return [(bf16, bf16) for _ in range(cfg.n_layers)]

    def tensor_spec(fmt):
        if fmt is None:
            return bf16
        sz = ParamSpec(shape=(batch, max_len, cfg.n_kv), dtype=torch.bfloat16,
                       init="zeros")
        return {"p": ParamSpec(shape=(fmt.planes, batch, max_len, cfg.n_kv,
                                      fmt.packed_d), dtype=torch.uint8,
                               init="zeros"),
                "s": sz, "z": sz}

    return [{"k": tensor_spec(fk), "v": tensor_spec(fv)}
            for fk, fv in kv_info[1]]


def decode_step(cfg: TransformerConfig, params, cache, tokens: torch.Tensor,
                length: int, policy, *, impl: str = "auto"):
    """One new token per row: tokens (B, 1) at position ``length`` against
    the per-layer cache from ``cache_specs`` (updated in place) ->
    (logits (B, V), cache)."""
    kv_info = kv_formats(cfg, policy)
    store = kv_info[0] if kv_info is not None else "packed"
    b = tokens.shape[0]
    sin, cos = _rotary(cfg, _positions(b, 1, length, tokens.device))
    _, napply = cfg.norm_fns
    x = _embed(params, tokens)
    for i, lp in enumerate(params["layers"]):
        lname = f"l{i}."
        o, cache[i] = attn.gqa_decode(
            lp["attn"], napply(lp["ln1"], x), cache[i], length, policy,
            n_heads=cfg.n_heads, n_kv=cfg.n_kv, head_dim=cfg.hd, sin=sin,
            cos=cos, impl=impl, lname=lname,
            kv_fmts=kv_info[1][i] if kv_info is not None else None,
            kv_store=store)
        x = x + o
        x = x + _apply_mlp(cfg, lp, napply(lp["ln2"], x), policy, impl, lname)
    return _head(cfg, params, x, policy, impl)[:, 0, :], cache


def decode_steps(cfg: TransformerConfig, params, cache, tokens: torch.Tensor,
                 length: int, policy, *, impl: str = "auto",
                 attn_impl: str = "xla"):
    """T new tokens per row in ONE forward, the speculative verify: tokens
    (B, T) go to positions ``length .. length + T - 1`` of the per-layer
    cache (updated in place) -> (logits (B, T, V), cache), where logits[:,
    t] is the next-token row after tokens[:, :t + 1].

    The T rows equal T sequential ``decode_step`` calls over the same
    tokens: the projections' int32 accumulation is exact, norms, rotary
    (per position ``length + t``) and activation quantization act per row,
    and attention runs ``gqa_decode``'s single-query routine per position
    (``nn.attention.gqa_verify``).  ``attn_impl='flash'`` takes K4 for a
    packed cache instead, within K4's contract."""
    kv_info = kv_formats(cfg, policy)
    store = kv_info[0] if kv_info is not None else "packed"
    b, t_new = tokens.shape
    sin, cos = _rotary(cfg, _positions(b, t_new, length, tokens.device))
    _, napply = cfg.norm_fns
    x = _embed(params, tokens)
    for i, lp in enumerate(params["layers"]):
        lname = f"l{i}."
        o, cache[i] = attn.gqa_verify(
            lp["attn"], napply(lp["ln1"], x), cache[i], length, policy,
            n_heads=cfg.n_heads, n_kv=cfg.n_kv, head_dim=cfg.hd, sin=sin,
            cos=cos, impl=impl, attn_impl=attn_impl, lname=lname,
            kv_fmts=kv_info[1][i] if kv_info is not None else None,
            kv_store=store)
        x = x + o
        x = x + _apply_mlp(cfg, lp, napply(lp["ln2"], x), policy, impl, lname)
    return _head(cfg, params, x, policy, impl), cache
