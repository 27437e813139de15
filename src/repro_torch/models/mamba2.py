"""Mamba-2 LM (SSD) (port of ``repro.models.mamba2``): attention-free,
constant-state decode.

The JAX package scans a stacked layer tree; the port keeps one per-layer
list, ``params["layers"][i] = {"ln", "ssm"}``, and a per-layer decode
state ``[{"ssm": (B, H, N, P), "conv": (B, W-1, C)}]`` in f32, which the
prefill already returns at its decode size.

``forward`` gives the logits at every position: the packed serve forward
(``mode="serve"``, K1 on every projection) or the QAT training forward
(``mode="train"``, fake-quant projections under autograd, each layer under
``torch.utils.checkpoint`` when ``cfg.remat``, as the reference's
``jax.checkpoint`` of its scan body).  Both pad the sequence up to a
multiple of ``chunk`` as the reference does and drop the pads before the
head.

``prefill`` pads the prompt the same way, but returns the state after the
real tokens (``nn.ssm`` says how; the reference returns it after the pads,
ROADMAP Queue 3 R6), in either mode.  ``prefill`` and ``decode_step`` take
``mode="train"`` over an ``init_params("train")`` tree: the reference's
train-mode cache path.

Tensor-parallel serving (``mesh=`` with a 'model' axis of M above 1):
``params`` is this rank's slice (``shard_serve_tree``): every SSD block's
heads (``nn.ssm``), the embedding by vocabulary rows and the head by
columns, as ``models.transformer`` cuts them; the decode state is the
rank's heads' (``cache_specs(..., model=M)``).  The embedding's codes and
the ``out`` rows' accumulators are summed over 'model' as int32 and the
head's columns all-gathered, so every rank holds the same residual stream
and logits, bitwise the one-device ones.
"""
from __future__ import annotations

import dataclasses
from typing import Dict, List

import torch
import torch.nn.functional as F

from repro_torch.core.dse import Gemm
from repro_torch.launch import mesh as mesh_lib
from repro_torch.models.remat import remat
from repro_torch.models import transformer as T
from repro_torch.models.transformer import _serve_mode
from repro_torch.nn import layers as nnl
from repro_torch.nn import param as nnp
from repro_torch.nn import quantized as Q
from repro_torch.nn import ssm as nnssm
from repro_torch.nn.ssm import SSMConfig

__all__ = ["Mamba2Config", "specs", "forward", "prefill", "decode_step",
           "cache_specs", "shard_serve_tree", "gemm_workload",
           "active_params", "total_params", "model_flops"]


@dataclasses.dataclass(frozen=True)
class Mamba2Config:
    name: str
    n_layers: int
    d_model: int
    vocab: int
    ssm: SSMConfig
    scan_layers: bool = True
    scan_unroll: bool = False
    remat: bool = True
    family: str = "ssm"


def layer_spec(cfg: Mamba2Config, mode: str = "train", policy=None) -> Dict:
    return {"ln": nnl.rmsnorm_spec(cfg.d_model),
            "ssm": nnssm.ssm_spec(cfg.ssm, serve=mode == "serve",
                                  policy=policy)}


def specs(cfg: Mamba2Config, mode: str = "train", policy=None) -> Dict:
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
        "layers": [layer_spec(cfg, mode, policy)
                   for _ in range(cfg.n_layers)],
    }


def _head(cfg, params, x, policy, impl, serve=True, mesh=None):
    """Final norm and head -> logits; on a tensor-parallel ``mesh`` the
    rank's vocabulary columns, all-gathered (``transformer._head``)."""
    x = nnl.rmsnorm_apply(params["final_norm"], x)
    logits = Q.qlinear_any(params["head"], x, policy, serve=serve,
                           impl=impl, name="head", layer_class="boundary")
    if mesh is not None:
        logits = mesh_lib.all_gather_model(mesh, logits, dim=-1)
    return logits[..., :cfg.vocab]  # drop the vocab padding


def _prefill_inputs(cfg, params, tokens, serve=True, mesh=None):
    """Embedded tokens with zero rows appended up to a multiple of chunk,
    and the per-layer side input: how many rows are real."""
    x = T._embed(params, tokens, serve, mesh)
    pad = (-x.shape[1]) % cfg.ssm.chunk
    return (F.pad(x, (0, 0, 0, pad)) if pad else x), {
        "valid": tokens.shape[1]}


def _layer_fwd(cfg, i, lp, x, policy, aux, *, impl, serve=True, mesh=None):
    """Prefill of layer i -> (x, its state after the ``aux["valid"]`` real
    rows; after all of them where ``aux`` has none)."""
    del i
    o, st = nnssm.ssd_forward(lp["ssm"], nnl.rmsnorm_apply(lp["ln"], x),
                              policy, cfg.ssm, impl=impl,
                              valid=aux.get("valid"), serve=serve, mesh=mesh)
    return x + o, st


def forward(cfg: Mamba2Config, params, tokens: torch.Tensor, policy, *,
            mode: str = "serve", impl: str = "auto",
            mesh=None) -> torch.Tensor:
    """tokens (B, S) -> logits (B, S, V) in bf16: the packed serve forward
    (``mode="serve"``) or the QAT training forward (``mode="train"``, over
    an ``init_params("train")`` tree, no kernel).  Like the reference's,
    the pads run through every layer (they follow the real tokens, so no
    real position sees them).  ``mesh``: tensor-parallel (module doc)."""
    serve = _serve_mode(mode)
    mesh = T._tp_mesh(cfg, mesh, serve)
    s = tokens.shape[1]
    x, _ = _prefill_inputs(cfg, params, tokens, serve, mesh)
    for i, lp in enumerate(params["layers"]):
        def layer(h, lp=lp, i=i):
            return _layer_fwd(cfg, i, lp, h, policy, {}, impl=impl,
                              serve=serve, mesh=mesh)[0]
        x = remat(cfg, layer, x)
    return _head(cfg, params, x[:, :s], policy, impl, serve, mesh)


def prefill(cfg: Mamba2Config, params, tokens: torch.Tensor, policy, *,
            impl: str = "auto", mode: str = "serve", mesh=None):
    """tokens (B, S) -> (last-token logits (B, V), per-layer state after
    the S tokens); ``mode="train"`` over an ``init_params("train")``
    tree; ``mesh``: tensor-parallel, the state this rank's heads'."""
    serve = _serve_mode(mode)
    mesh = T._tp_mesh(cfg, mesh, serve)
    s = tokens.shape[1]
    x, aux = _prefill_inputs(cfg, params, tokens, serve, mesh)
    states = []
    for i, lp in enumerate(params["layers"]):
        x, st = _layer_fwd(cfg, i, lp, x, policy, aux, impl=impl,
                           serve=serve, mesh=mesh)
        states.append(st)
    return _head(cfg, params, x[:, s - 1:s], policy, impl,
                 serve, mesh)[:, 0, :], states


def cache_specs(cfg: Mamba2Config, batch: int, max_len: int,
                policy=None, model: int = 1) -> List[Dict]:
    """Per-layer decode state (f32, zeros); independent of ``max_len``;
    ``model`` > 1: one tensor-parallel rank's (its heads)."""
    del max_len, policy
    return [nnssm.ssm_state_spec(cfg.ssm, batch, model)
            for _ in range(cfg.n_layers)]


def shard_serve_tree(cfg: Mamba2Config, params, axes, mesh, shard):
    """This rank's slice of a whole packed tree (``runtime.serve.
    local_params``): ``shard(tree, axes, mesh)``, the ``SERVE_RULES``
    cut, for every leaf but each block's ``in_xbc`` and conv, which keep
    the rank's x columns (channels) with B and C whole
    (``nn.ssm.xbc_pieces``)."""
    r, m = mesh_lib.model_coords(mesh)
    pieces = nnssm.xbc_pieces(cfg.ssm, r, m)
    axes = dict(axes, layers=[
        dict(la, ssm=dict(la["ssm"], in_xbc=_whole(la["ssm"]["in_xbc"])))
        for la in axes["layers"]])
    out = shard(params, axes, mesh)
    for lp in out["layers"]:
        blk = lp["ssm"]
        blk["in_xbc"] = Q.column_pieces(blk["in_xbc"], pieces)
        blk["conv"] = {k: Q.take_pieces(v, pieces)
                       for k, v in blk["conv"].items()}
    return out


def _whole(axes):
    """An axes subtree with every dimension unnamed: no rule cuts it."""
    if isinstance(axes, dict):
        return {k: _whole(v) for k, v in axes.items()}
    return (None,) * len(axes)


def cache_axes(cfg: Mamba2Config, policy=None):
    """Logical axes of ``cache_specs``' tree, leaf for leaf."""
    return nnp.axes_tree(cache_specs(cfg, 1, 1, policy))


def decode_step(cfg: Mamba2Config, params, cache, tokens: torch.Tensor,
                length: int, policy, *, impl: str = "auto",
                mode: str = "serve", mesh=None):
    """One token per row: tokens (B, 1) -> (logits (B, V), new state);
    ``mode="train"`` over an ``init_params("train")`` tree; ``mesh`` as
    ``prefill``'s."""
    del length  # the state carries the position
    serve = _serve_mode(mode)
    mesh = T._tp_mesh(cfg, mesh, serve)
    x = T._embed(params, tokens, serve, mesh)
    new = []
    for lp, st in zip(params["layers"], cache):
        o, st = nnssm.ssd_decode_step(lp["ssm"],
                                      nnl.rmsnorm_apply(lp["ln"], x), st,
                                      policy, cfg.ssm, impl=impl,
                                      serve=serve, mesh=mesh)
        x = x + o
        new.append(st)
    return _head(cfg, params, x, policy, impl, serve, mesh)[:, 0, :], new


# --- workload descriptions (DSE, planner, roofline) --------------------------


def gemm_workload(cfg: Mamba2Config, tokens: int) -> List[Gemm]:
    s = cfg.ssm
    d, di = cfg.d_model, s.d_inner
    gn = s.n_groups * s.d_state
    per = [Gemm("in_xbc", tokens, d, di + 2 * gn),
           Gemm("in_z", tokens, d, di),
           Gemm("in_dt", tokens, d, s.n_heads),
           Gemm("out", tokens, di, d)]
    out = [dataclasses.replace(g, count=cfg.n_layers) for g in per]
    out.append(Gemm("head", tokens, d, cfg.vocab, layer_class="boundary"))
    return out


def active_params(cfg: Mamba2Config) -> int:
    s = cfg.ssm
    per = (cfg.d_model * (s.d_inner + 2 * s.n_groups * s.d_state)
           + cfg.d_model * s.d_inner + cfg.d_model * s.n_heads
           + s.d_inner * cfg.d_model)
    return per * cfg.n_layers + 2 * cfg.vocab * cfg.d_model


total_params = active_params


def model_flops(cfg: Mamba2Config, *, tokens: int, step: str) -> float:
    return (6.0 if step == "train" else 2.0) * active_params(cfg) * tokens
