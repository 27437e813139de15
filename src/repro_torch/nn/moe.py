"""Mixture-of-Experts, serve half (port of ``repro.nn.moe``).

Token-choice top-k routing, then capacity-bounded dispatch per batch row:
each expert takes its top-C tokens by gate (C = capacity; an
undersubscribed expert pads with gate-0 tokens that contribute nothing, an
oversubscribed one drops its lowest gates), runs them through its own
quantized FFN, and the gated outputs are summed back per token in f32.
Shared experts (deepseek) run on every token after the bank.

The experts' weights are one qlinear bank each for gate, up and down
(``lead=(E,)``, one workload layer name ``expert`` for the bank), and each
bank is ONE K1 call over all E experts (``nn.quantized.qlinear_serve_apply``
on a bank), where the reference maps its kernel over the experts with
``jax.vmap``: each expert quantizes its gathered rows with its own
activation step.

Numerics, against the reference and across batches:

* The router runs in f32.  On a card its product is the fixed-order form
  (an elementwise product, one sum over the model axis), so a token's
  scores do not depend on the rows it shares a call with: cuBLAS would
  pick its kernel, and so a dot product's order of sums, by the shape.
* ``jax.lax.top_k`` puts the lower index first among equal values (the
  capacity pass ranks rows full of exact zero gates), so both top-k passes
  here are a stable descending sort.
* The combine adds each token's contributions in ascending expert order,
  in f32, as the reference's scatter-add does (it adds in index order).
  Only the tokens the router chose for an expert can contribute a nonzero
  value, so those are added in that order; the gate-0 padding contributes
  ``h * 0``, which is a signed zero -- an identity of every partial sum,
  which is never -0 -- or NaN where ``h`` is not finite, and is added after
  in any order (atomics on a card) with the same result.
"""
from __future__ import annotations

import dataclasses
from typing import Dict, Optional

import torch

from repro_torch.core.precision import PrecisionPolicy
from repro_torch.nn import layers
from repro_torch.nn import quantized as Q
from repro_torch.nn.param import ParamSpec

__all__ = ["MoEConfig", "moe_spec", "moe_apply", "capacity",
           "router_logits", "top_k"]

# Tokens of one fixed-order router product on a card: its (rows, E, D)
# buffer stays near 2^25 values at olmoe's and deepseek's widths.
ROUTER_ROWS = 256


@dataclasses.dataclass(frozen=True)
class MoEConfig:
    d_model: int
    d_ff: int                 # per-expert hidden
    n_experts: int
    topk: int
    n_shared: int = 0         # deepseek shared experts
    shared_ff: Optional[int] = None
    capacity_factor: float = 2.0
    act: str = "swiglu"

    @property
    def shared_hidden(self) -> int:
        return (self.shared_ff or self.d_ff) * self.n_shared


def moe_spec(cfg: MoEConfig, *, serve: bool = False,
             policy: PrecisionPolicy = PrecisionPolicy(),
             lname: str = "") -> Dict:
    """The router (f32), the expert banks gate/up/down (lead ``(E,)``, named
    ``{lname}expert``) and the shared experts (``{lname}shared``)."""
    def mk(i, o, lead, name):
        if serve:
            return Q.qlinear_serve_spec(i, o, policy=policy, lead=lead,
                                        name=lname + name)
        return Q.qlinear_spec(i, o, lead=lead, name=lname + name)

    e, d = (cfg.n_experts,), cfg.d_model
    spec = {
        # the router stays f32: parameter-light and accuracy-critical
        "router": ParamSpec(shape=(d, cfg.n_experts), init="normal",
                            fan_in_axes=(-2,)),
        "gate": mk(d, cfg.d_ff, e, "expert"),
        "up": mk(d, cfg.d_ff, e, "expert"),
        "down": mk(cfg.d_ff, d, e, "expert"),
    }
    if cfg.n_shared:
        sh = cfg.shared_hidden
        spec["shared_gate"] = mk(d, sh, (), "shared")
        spec["shared_up"] = mk(d, sh, (), "shared")
        spec["shared_down"] = mk(sh, d, (), "shared")
    return spec


def capacity(cfg: MoEConfig, s: int) -> int:
    """Tokens each expert takes from a row of ``s`` tokens: 1 at decode
    (s = 1), so every expert then runs every token."""
    cap = max(int(s * cfg.topk * cfg.capacity_factor / cfg.n_experts), 1)
    return min(cap, s)


def top_k(v: torch.Tensor, k: int):
    """(values, indices) of the k largest along the last axis, the lower
    index first among equal values (``jax.lax.top_k``'s order)."""
    vals, idx = torch.sort(v, dim=-1, descending=True, stable=True)
    return vals[..., :k], idx[..., :k]


def router_logits(x: torch.Tensor, router: torch.Tensor) -> torch.Tensor:
    """f32 router scores ``einsum('bsd,de->bse')``.  On a card, the
    fixed-order form: each token's E dot products as an elementwise
    product into a (rows, E, D) buffer and one sum over D, ROUTER_ROWS
    tokens at a time -- a token's scores are then the same bits whatever
    rows share the call (the schedulers' and the speculative verify's
    contracts)."""
    xf = x.to(torch.float32)
    rf = router.to(torch.float32)
    if not xf.is_cuda:
        return torch.einsum("bsd,de->bse", xf, rf)
    b, s, d = xf.shape
    rows = xf.reshape(b * s, d)
    rt = rf.t().contiguous()[None]                        # (1, E, D)
    out = [torch.mul(rows[i:i + ROUTER_ROWS, None, :], rt).sum(-1)
           for i in range(0, b * s, ROUTER_ROWS)]
    return torch.cat(out).reshape(b, s, -1)


def _act(cfg: MoEConfig, g: torch.Tensor, u: torch.Tensor) -> torch.Tensor:
    return layers.swiglu_combine(g, u) if cfg.act == "swiglu" \
        else layers.gelu(g)


def _ffn(p, x, policy, cfg: MoEConfig, impl: str, name: str, prefix=""):
    fn = lambda key, h: Q.qlinear_serve_apply(  # noqa: E731
        p[prefix + key], h, policy, impl=impl, name=name)
    u = fn("up", x) if cfg.act == "swiglu" else None
    return fn("down", _act(cfg, fn("gate", x), u))


def _combine(gated: torch.Tensor, tok_idx: torch.Tensor, idx: torch.Tensor,
             s: int) -> torch.Tensor:
    """gated (B, E, C, D) expert outputs times their gates, tok_idx (B, E,
    C) the token of each, idx (B, S, K) the router's choices -> (B, S, D)
    f32, each token's contributions summed in ascending expert order."""
    b, e, c, d = gated.shape
    dev = gated.device
    hf = gated.to(torch.float32).reshape(b, e * c, d)
    # where expert e took token t: its slot c, or -1
    pos = torch.full((b, e, s), -1, dtype=torch.long, device=dev)
    pos.scatter_(2, tok_idx, torch.arange(c, device=dev).expand(b, e, c))
    chosen = torch.sort(idx, dim=-1).values.transpose(1, 2)   # (B, K, S)
    slot = torch.gather(pos, 1, chosen)                        # (B, K, S)
    flat = torch.where(slot >= 0, chosen * c + slot, e * c)    # e*c: a zero
    hz = torch.cat([hf, hf.new_zeros(b, 1, d)], dim=1)
    y = torch.zeros((b, s, d), dtype=torch.float32, device=dev)
    for j in range(flat.shape[1]):
        y = y + torch.gather(hz, 1, flat[:, j, :, None].expand(b, s, d))
    # the gate-0 padding: signed zeros, or NaN where h is not finite
    routed = torch.zeros((b, s, e), dtype=torch.bool, device=dev)
    routed.scatter_(2, idx, True)
    took = torch.gather(routed.transpose(1, 2), 2, tok_idx)   # (B, E, C)
    pad = torch.where(took.reshape(b, e * c, 1), 0.0, hf)
    z = torch.zeros_like(y).scatter_add_(
        1, tok_idx.reshape(b, e * c, 1).expand(b, e * c, d), pad)
    return y + z


def moe_apply(p: Dict, x: torch.Tensor, policy, cfg: MoEConfig, *,
              impl: str = "auto", lname: str = "") -> torch.Tensor:
    """Serve forward of one MoE block: x (B, S, D) -> (B, S, D), routing
    and capacity per batch row as the reference's grouped dispatch."""
    b, s, d = x.shape
    e = cfg.n_experts
    scores = torch.softmax(router_logits(x, p["router"]), dim=-1)
    gates, idx = top_k(scores, cfg.topk)                     # (B, S, K)
    gates = gates / torch.sum(gates, dim=-1, keepdim=True)   # renormalize
    sel = torch.zeros((b, s, e), dtype=torch.float32, device=x.device)
    sel.scatter_(2, idx, gates)
    cap = capacity(cfg, s)
    vals, tok_idx = top_k(sel.transpose(1, 2), cap)          # (B, E, C)
    xg = torch.gather(x, 1, tok_idx.reshape(b, e * cap, 1).expand(
        b, e * cap, d))
    # the bank: (E, B*C, D), one K1 call per projection
    xe = xg.reshape(b, e, cap, d).transpose(0, 1).reshape(e, b * cap, d)
    h = _ffn(p, xe, policy, cfg, impl, lname + "expert")
    h = h.reshape(e, b, cap, d).transpose(0, 1)              # (B, E, C, D)
    h = h * vals[..., None].to(h.dtype)
    y = _combine(h, tok_idx, idx, s).to(x.dtype)
    if cfg.n_shared:
        y = y + _ffn(p, x, policy, cfg, impl, lname + "shared",
                     prefix="shared_").to(y.dtype)
    return y
