"""Mamba-2 LM (SSD), serve half (port of ``repro.models.mamba2``):
attention-free, constant-state decode.

The JAX package scans a stacked layer tree; the port keeps one per-layer
list, ``params["layers"][i] = {"ln", "ssm"}``, and a per-layer decode
state ``[{"ssm": (B, H, N, P), "conv": (B, W-1, C)}]`` in f32, which the
prefill already returns at its decode size.

``prefill`` pads the prompt up to a multiple of ``chunk`` as the reference
does, but returns the state after the real tokens (``nn.ssm`` says how;
the reference returns it after the pads, ROADMAP Queue 3 R6).  The
forwards over every position (training, teacher forcing) are not ported
yet.
"""
from __future__ import annotations

import dataclasses
from typing import Dict, List

import torch
import torch.nn.functional as F

from repro_torch.core.dse import Gemm
from repro_torch.nn import layers as nnl
from repro_torch.nn import quantized as Q
from repro_torch.nn import ssm as nnssm
from repro_torch.nn.ssm import SSMConfig

__all__ = ["Mamba2Config", "specs", "prefill", "decode_step",
           "cache_specs", "gemm_workload", "active_params", "total_params",
           "model_flops"]


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
        "head": (Q.qlinear_serve_spec(cfg.d_model, vp, layer_class="boundary",
                                      policy=policy, name="head") if serve
                 else Q.qlinear_spec(cfg.d_model, vp, layer_class="boundary",
                                     name="head")),
        "layers": [layer_spec(cfg, mode, policy)
                   for _ in range(cfg.n_layers)],
    }


def _head(cfg, params, x, policy, impl):
    x = nnl.rmsnorm_apply(params["final_norm"], x)
    logits = Q.qlinear_serve_apply(params["head"], x, policy,
                                   layer_class="boundary", impl=impl,
                                   name="head")
    return logits[..., :cfg.vocab]  # drop the vocab padding


def _prefill_inputs(cfg, params, tokens):
    """Embedded tokens with zero rows appended up to a multiple of chunk,
    and the per-layer side input: how many rows are real."""
    x = nnl.embed_serve_apply(params["embed"], tokens)
    pad = (-x.shape[1]) % cfg.ssm.chunk
    return (F.pad(x, (0, 0, 0, pad)) if pad else x), {
        "valid": tokens.shape[1]}


def _layer_fwd(cfg, i, lp, x, policy, aux, *, impl):
    """Prefill of layer i -> (x, its state after the real rows)."""
    del i
    o, st = nnssm.ssd_forward(lp["ssm"], nnl.rmsnorm_apply(lp["ln"], x),
                              policy, cfg.ssm, impl=impl, valid=aux["valid"])
    return x + o, st


def prefill(cfg: Mamba2Config, params, tokens: torch.Tensor, policy, *,
            impl: str = "auto"):
    """tokens (B, S) -> (last-token logits (B, V), per-layer state after
    the S tokens)."""
    s = tokens.shape[1]
    x, aux = _prefill_inputs(cfg, params, tokens)
    states = []
    for i, lp in enumerate(params["layers"]):
        x, st = _layer_fwd(cfg, i, lp, x, policy, aux, impl=impl)
        states.append(st)
    return _head(cfg, params, x[:, s - 1:s], policy, impl)[:, 0, :], states


def cache_specs(cfg: Mamba2Config, batch: int, max_len: int,
                policy=None) -> List[Dict]:
    """Per-layer decode state (f32, zeros); independent of ``max_len``."""
    del max_len, policy
    return [nnssm.ssm_state_spec(cfg.ssm, batch)
            for _ in range(cfg.n_layers)]


def decode_step(cfg: Mamba2Config, params, cache, tokens: torch.Tensor,
                length: int, policy, *, impl: str = "auto"):
    """One token per row: tokens (B, 1) -> (logits (B, V), new state)."""
    del length  # the state carries the position
    x = nnl.embed_serve_apply(params["embed"], tokens)
    new = []
    for lp, st in zip(params["layers"], cache):
        o, st = nnssm.ssd_decode_step(lp["ssm"],
                                      nnl.rmsnorm_apply(lp["ln"], x), st,
                                      policy, cfg.ssm, impl=impl)
        x = x + o
        new.append(st)
    return _head(cfg, params, x, policy, impl)[:, 0, :], new


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
