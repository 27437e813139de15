"""Mixture-of-Experts (port of ``repro.nn.moe``): the packed serve forward
and the QAT train forward (``moe_apply(serve=False)``).

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

Expert parallelism (``moe_apply(mesh=)``, a 'model' axis of M above 1):
the rank holds E/M columns of the router and E/M whole experts
of each bank (``nn.partitioning.shard_tree`` on the 'experts' axis), the
shared experts' gate/up columns and ``shared_down``'s rows.  The router's
column shards are all-gathered over 'model', so every rank routes every
token the same way; the rank dispatches only its experts' slots and runs
each projection as one K1 launch over its bank of E/M experts.  The
combine is the trap: the one-device sum adds a token's rows one at a time
in ascending expert order, and a sum of per-rank partials would add them
in another order.  So the gated rows (B, E/M, C, D) bf16 are all-gathered
over 'model' in rank order -- experts in ascending order -- and every rank
runs the one-device ``_combine`` on them: bitwise the one-device block.
That moves B E C D bf16 values a layer, of which a rank receives (M - 1) /
M; the alternative, passing each token's f32 running sum rank to rank,
moves B S D f32 values a hop but serializes the ranks.

Expert-parallel training (``moe_apply(serve=False, mesh=)``) keeps that
scheme under autograd, and every gradient of the routed block -- x's, the
router's, each expert's ``w``/``gw``/``ga`` -- bitwise one device's on
every rank: the router's column shards are all-gathered (d x E f32) and
every rank routes with the whole router (``gather_model``: its backward
keeps the rank's columns of the whole router's gradient, which every rank
computes alike); the rank dispatches its experts' slots, runs its E/M
experts as a bank and gates its rows with its experts' gates
(``cut_model``: the gate cotangents, nonzero on one rank each, all-gathered
before the router's softmax backward); the gated rows are all-gathered and
combined as on one device.  The dispatch's backward all-gathers every
rank's slot cotangents (B, E/M, C, D) bf16 in rank order and adds each
token's in ascending expert order as one device does (``_Dispatch``): rank
partials added over 'model' would add them in another order.  The shared
experts are column-parallel gate/up and a row-parallel down, as the dense
MLP.

The train forward runs the same routing under autograd, with the experts
as fake-quant banks (``nn.quantized.qlinear_apply`` over ``lead=(E,)``:
each expert's own ``gw`` -- one per output column under olmoe's
``channel_wise`` -- and ``ga``, its step-size gradients scaled by its own
count).  Its backward follows ``jax.vjp`` of the reference where a sum in
bf16 leaves XLA: the dispatch's transpose adds a token's cotangents from
the experts that took it one by one in bf16 (``_Dispatch``), and the
gates' gradient, a bf16 sum over the model axis, is added in windows of
32 as XLA's CPU compiler adds it (``_Gate``).  The f32 router and softmax
products are left to torch (another order of f32 sums).  On a card
every index operation of the backward is deterministic under
``torch.use_deterministic_algorithms``: gathers, a sort's scatter, the
combine's scatter-add.
"""
from __future__ import annotations

import dataclasses
from typing import Dict, Optional

import torch

from repro_torch.core.precision import PrecisionPolicy
from repro_torch.launch import mesh as mesh_lib
from repro_torch.nn import layers
from repro_torch.nn import quantized as Q
from repro_torch.nn.param import ParamSpec

__all__ = ["MoEConfig", "moe_spec", "moe_apply", "capacity",
           "router_logits", "top_k", "route", "dispatch", "gate_and_combine",
           "expert_coords", "expert_parallel_combine", "whole_router",
           "gather_gated"]

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
    def mk(i, o, lead, name, axes):
        lead_axes = ("experts",) if lead else ()
        if serve:
            return Q.qlinear_serve_spec(i, o, axes=axes, policy=policy,
                                        lead=lead, lead_axes=lead_axes,
                                        name=lname + name)
        return Q.qlinear_spec(i, o, axes=axes, lead=lead,
                              lead_axes=lead_axes, name=lname + name)

    e, d = (cfg.n_experts,), cfg.d_model
    spec = {
        # the router stays f32: parameter-light and accuracy-critical
        "router": ParamSpec(shape=(d, cfg.n_experts),
                            axes=("embed", "experts"), init="normal",
                            fan_in_axes=(-2,)),
        "gate": mk(d, cfg.d_ff, e, "expert", ("embed", "expert_mlp")),
        "up": mk(d, cfg.d_ff, e, "expert", ("embed", "expert_mlp")),
        "down": mk(cfg.d_ff, d, e, "expert", ("expert_mlp", "act_embed")),
    }
    if cfg.n_shared:
        sh = cfg.shared_hidden
        spec["shared_gate"] = mk(d, sh, (), "shared", ("embed", "mlp"))
        spec["shared_up"] = mk(d, sh, (), "shared", ("embed", "mlp"))
        spec["shared_down"] = mk(sh, d, (), "shared", ("mlp", "act_embed"))
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


def _fixed_order_rows(a: torch.Tensor, bt: torch.Tensor) -> torch.Tensor:
    """a (N, K) times bt (M, K) transposed -> (N, M) f32, each row as an
    elementwise product into a (rows, M, K) buffer and one sum over K,
    ROUTER_ROWS rows at a time: a row's bits do not depend on the others."""
    out = [torch.mul(a[i:i + ROUTER_ROWS, None, :], bt[None]).sum(-1)
           for i in range(0, a.shape[0], ROUTER_ROWS)]
    return torch.cat(out)


class _FixedOrderRouter(torch.autograd.Function):
    """The card's router product ``rows @ router`` in the fixed-order form,
    and its backward: the gradient to a token's row (a sum over the E
    experts) in the same form, so that it too keeps its bits whatever rows
    share the call, and the router's gradient (a sum over the tokens,
    which depends on them by nature) as one f32 product, deterministic
    for a given shape."""

    @staticmethod
    def forward(ctx, rows, rf):
        ctx.save_for_backward(rows, rf)
        return _fixed_order_rows(rows, rf.t().contiguous())

    @staticmethod
    def backward(ctx, g):
        rows, rf = ctx.saved_tensors
        dx = (_fixed_order_rows(g, rf.contiguous())
              if ctx.needs_input_grad[0] else None)
        dr = torch.mm(rows.t(), g) if ctx.needs_input_grad[1] else None
        return dx, dr


def router_logits(x: torch.Tensor, router: torch.Tensor,
                  mesh=None) -> torch.Tensor:
    """f32 router scores ``einsum('bsd,de->bse')``, under autograd.  On a
    card, the fixed-order form: each token's E dot products as an
    elementwise product into a (rows, E, D) buffer and one sum over D,
    ROUTER_ROWS tokens at a time -- a token's scores, and its gradient
    through the router, are then the same bits whatever rows share the
    call (the schedulers' and the speculative verify's contracts).

    ``mesh`` with a 'model' axis of M above 1: ``router`` holds this
    rank's E/M columns, and the rank's scores are all-gathered over
    'model' into every expert's, in rank order -- the one-device scores
    bitwise.  On a card each score is one sum over D, the same bits at any
    column count; the CPU's blocked product picks its blocking by the
    shape (a 16-column shard of olmoe's router differs from the whole
    product's columns), so there the shard multiplies a (D, E) router
    holding its columns in place and zeros elsewhere, the whole product's
    shape (on one device, the router itself)."""
    xf = x.to(torch.float32)
    rf = router.to(torch.float32)
    r, m = mesh_lib.model_coords(mesh)
    if not xf.is_cuda:
        el = rf.shape[1]
        padded = torch.nn.functional.pad(rf, (r * el, (m - 1 - r) * el))
        mine = torch.einsum("bsd,de->bse", xf, padded)[..., r * el:
                                                        (r + 1) * el]
    else:
        b, s, d = xf.shape
        mine = _FixedOrderRouter.apply(xf.reshape(b * s, d),
                                       rf).reshape(b, s, -1)
    return mesh_lib.all_gather_model(mesh, mine.contiguous(), dim=-1)


def _act(cfg: MoEConfig, g: torch.Tensor, u: torch.Tensor) -> torch.Tensor:
    return layers.swiglu_combine(g, u) if cfg.act == "swiglu" \
        else layers.gelu(g)


def _ffn(p, x, policy, cfg: MoEConfig, impl: str, name: str, prefix="",
         serve=True, row_mesh=None):
    """The expert bank (x (E, M, D), ``prefix`` '') or the shared experts
    (x (B, S, D), ``prefix`` 'shared_'): packed (``serve``, one K1 call a
    projection over the bank) or fake-quant (the QAT forward, one batched
    bf16 product a projection).  ``row_mesh``: the shared experts
    tensor-parallel, gate/up by columns and down a row shard summed over
    'model' (in training where the leaves hold shards of the shared
    hidden width; where it does not split they are whole and run as on
    one device)."""
    col = {}
    if row_mesh is not None and not serve:
        if p[prefix + "up"]["w"].shape[-1] == cfg.shared_hidden:
            row_mesh = None
        else:
            col = {"col_mesh": row_mesh}
    fn = lambda key, h, **kw: Q.qlinear_any(  # noqa: E731
        p[prefix + key], h, policy, serve=serve, impl=impl, name=name, **kw)
    u = fn("up", x, **col) if cfg.act == "swiglu" else None
    h = _act(cfg, fn("gate", x, **col), u)
    if row_mesh is not None:
        return fn("down", h, row_mesh=row_mesh)
    return fn("down", h)


def _token_slots(tok_idx: torch.Tensor, idx: torch.Tensor,
                 s: int) -> torch.Tensor:
    """tok_idx (B, E, C) the token in each expert slot, idx (B, S, K) the
    router's choices -> (B, K, S): for each token and each of its K
    choices in ascending expert order, the flat slot e * C + c where that
    expert took it, or E * C (a zero row) where its capacity dropped it."""
    b, e, c = tok_idx.shape
    dev = tok_idx.device
    pos = torch.full((b, e, s), -1, dtype=torch.long, device=dev)
    pos.scatter_(2, tok_idx, torch.arange(c, device=dev).expand(b, e, c))
    chosen = torch.sort(idx, dim=-1).values.transpose(1, 2)   # (B, K, S)
    slot = torch.gather(pos, 1, chosen)                        # (B, K, S)
    return torch.where(slot >= 0, chosen * c + slot, e * c)


def _sum_slots(rows: torch.Tensor, flat: torch.Tensor) -> torch.Tensor:
    """rows (B, E * C, D), flat (B, K, S) from ``_token_slots`` -> (B, S, D)
    in rows' dtype: each token's slots added one at a time, in ascending
    expert order, from zero."""
    b, _, d = rows.shape
    s = flat.shape[2]
    rz = torch.cat([rows, rows.new_zeros(b, 1, d)], dim=1)
    y = torch.zeros((b, s, d), dtype=rows.dtype, device=rows.device)
    for j in range(flat.shape[1]):
        y = y + torch.gather(rz, 1, flat[:, j, :, None].expand(b, s, d))
    return y


def _combine(gated: torch.Tensor, tok_idx: torch.Tensor, idx: torch.Tensor,
             s: int) -> torch.Tensor:
    """gated (B, E, C, D) expert outputs times their gates, tok_idx (B, E,
    C) the token of each, idx (B, S, K) the router's choices -> (B, S, D)
    f32, each token's contributions summed in ascending expert order.
    Under autograd its backward is a gather: each slot takes its token's
    cotangent, as the reference's scatter-add transposes."""
    b, e, c, d = gated.shape
    dev = gated.device
    hf = gated.to(torch.float32).reshape(b, e * c, d)
    y = _sum_slots(hf, _token_slots(tok_idx, idx, s))
    # the gate-0 padding: signed zeros, or NaN where h is not finite
    routed = torch.zeros((b, s, e), dtype=torch.bool, device=dev)
    routed.scatter_(2, idx, True)
    took = torch.gather(routed.transpose(1, 2), 2, tok_idx)   # (B, E, C)
    pad = torch.where(took.reshape(b, e * c, 1), 0.0, hf)
    z = torch.zeros_like(y).scatter_add_(
        1, tok_idx.reshape(b, e * c, 1).expand(b, e * c, d), pad)
    return y + z


class _Dispatch(torch.autograd.Function):
    """The train path's dispatch: x (B, S, D) gathered into the expert
    slots (B, E, C, D).  Its backward adds each token's cotangents from the
    experts that took it one at a time in x's dtype, in ascending expert
    order, as XLA runs the reference's transpose (a scatter-add in bf16,
    in index order); a plain gather's backward would add them in f32 and
    round once.  The gate-0 padding slots are left out: their cotangents
    are zeros (h times a zero gate), which change no sum.

    ``mesh`` with a 'model' axis of M above 1: the rank's E/M experts'
    slots (B, E/M, C, D) of every expert's routing; the backward
    all-gathers every rank's slot cotangents in rank order (the experts in
    ascending order) and runs the one-device sum over all of them, so x's
    cotangent is one device's on every rank."""

    @staticmethod
    def forward(ctx, x, tok_idx, idx, mesh=None):
        b, _, c = tok_idx.shape
        d = x.shape[-1]
        ctx.save_for_backward(_token_slots(tok_idx, idx, x.shape[1]))
        ctx.mesh = mesh
        first, e = expert_coords(mesh, tok_idx.shape[1])
        mine = tok_idx[:, first:first + e].reshape(b, e * c, 1)
        return torch.gather(x, 1, mine.expand(b, e * c, d)).reshape(
            b, e, c, d)

    @staticmethod
    def backward(ctx, g):
        (flat,) = ctx.saved_tensors
        g = mesh_lib.all_gather_model(ctx.mesh, g.contiguous(), dim=1)
        b, e, c, d = g.shape
        return _sum_slots(g.reshape(b, e * c, d), flat), None, None, None


def _xla_row_sum(t: torch.Tensor) -> torch.Tensor:
    """Sum over the last axis in t's dtype, in the order XLA's CPU
    compiler adds a bf16 row (``layers.xla_sum``)."""
    return layers.xla_sum(t, (t.ndim - 1,))


class _Gate(torch.autograd.Function):
    """h (B, E, C, D) times its gates vals (B, E, C, f32, rounded to h's
    dtype).  The gates' gradient is a bf16 sum over D, added as XLA adds
    the reference's (``_xla_row_sum``); torch would add it in f32 and
    round once, and a gate's gradient reaches the router and every
    token's input through it."""

    @staticmethod
    def forward(ctx, h, vals):
        vb = vals[..., None].to(h.dtype)
        ctx.save_for_backward(h, vb)
        return h * vb

    @staticmethod
    def backward(ctx, g):
        h, vb = ctx.saved_tensors
        dv = _xla_row_sum(g * h).to(torch.float32) \
            if ctx.needs_input_grad[1] else None
        return g * vb, dv


def route(x: torch.Tensor, router: torch.Tensor, cfg: MoEConfig,
          mesh=None):
    """The routing's decisions for x (B, S, D), under autograd: the f32
    router's softmax, the top-k experts of each token with their
    renormalized gates scattered into ``sel`` (B, S, E), and each expert's
    top-C tokens of a row by gate -> (idx (B, S, K) the experts each token
    chose, vals (B, E, C) f32 the gate of each expert slot, tok_idx (B, E,
    C) its token).  Both top-k passes send a gradient to the entries they
    picked only, so ties among unrouted zeros move none.  ``mesh``: the
    router holds this rank's columns (``router_logits``); every rank
    takes the same decisions over all E experts."""
    b, s, _ = x.shape
    scores = torch.softmax(router_logits(x, router, mesh), dim=-1)
    gates, idx = top_k(scores, cfg.topk)                     # (B, S, K)
    gates = gates / torch.sum(gates, dim=-1, keepdim=True)   # renormalize
    sel = torch.zeros((b, s, cfg.n_experts), dtype=torch.float32,
                      device=x.device).scatter(2, idx, gates)
    vals, tok_idx = top_k(sel.transpose(1, 2), capacity(cfg, s))
    return idx, vals, tok_idx


def dispatch(x: torch.Tensor, tok_idx: torch.Tensor, idx: torch.Tensor, *,
             serve: bool, mesh=None) -> torch.Tensor:
    """x (B, S, D) gathered into the expert slots (B, E, C, D); the train
    path's backward is ``_Dispatch``'s.  ``mesh`` (training): the slots of
    this rank's experts of every expert's ``tok_idx``."""
    if not serve:
        return _Dispatch.apply(x, tok_idx, idx, mesh)
    b, e, c = tok_idx.shape
    d = x.shape[-1]
    return torch.gather(x, 1, tok_idx.reshape(b, e * c, 1).expand(
        b, e * c, d)).reshape(b, e, c, d)


def gate_and_combine(h: torch.Tensor, vals: torch.Tensor,
                     tok_idx: torch.Tensor, idx: torch.Tensor, s: int, *,
                     serve: bool) -> torch.Tensor:
    """The experts' outputs h (B, E, C, D) times their gates (``_Gate`` on
    the train path), summed back per token in f32 -> (B, S, D) f32."""
    h = h * vals[..., None].to(h.dtype) if serve else _Gate.apply(h, vals)
    return _combine(h, tok_idx, idx, s)


def expert_coords(mesh, n_experts: int):
    """(this rank's first expert, its expert count) on ``mesh``'s 'model'
    axis; (0, E) without one.  E must split evenly over the axis."""
    r, m = mesh_lib.model_coords(mesh)
    if n_experts % m:
        raise ValueError(f"{n_experts} experts do not split evenly over "
                         f"{m} 'model' ranks")
    el = n_experts // m
    return r * el, el


def expert_parallel_combine(h: torch.Tensor, vals: torch.Tensor,
                            tok_idx: torch.Tensor, idx: torch.Tensor, s: int,
                            mesh) -> torch.Tensor:
    """The serve path's ``gate_and_combine``: h (B, E/M, C, D) the outputs
    of this rank's experts (all E without a 'model' axis above 1), vals /
    tok_idx / idx every expert's routing -> (B, S, D) f32, bitwise the
    one-device combine on every rank.  The rank's rows are gated,
    all-gathered over 'model' in rank order (the experts in ascending
    order; the identity on one device) and combined as on one device
    (``_combine``)."""
    first, e = expert_coords(mesh, vals.shape[1])
    gated = h * vals[:, first:first + e, :, None].to(h.dtype)
    return _combine(mesh_lib.all_gather_model(mesh, gated, dim=1), tok_idx,
                    idx, s)


def whole_router(router: torch.Tensor, mesh) -> torch.Tensor:
    """The training router: this rank's (D, E/M) column shard all-gathered
    over 'model' in rank order into the whole (D, E) f32 router, under
    autograd (``launch.mesh.gather_model``: its backward keeps the rank's
    columns).  Not ``router_logits``' gather of scores, which serving
    uses: it has no backward, so the router's columns would get no
    gradient through the other ranks' tokens' scores."""
    return mesh_lib.gather_model(mesh, router, -1)


def gather_gated(gated: torch.Tensor, mesh) -> torch.Tensor:
    """The rank's gated rows (B, E/M, C, D) all-gathered over 'model' in
    rank order into every expert's (B, E, C, D), under autograd (its
    backward keeps the rank's experts' cotangents)."""
    return mesh_lib.gather_model(mesh, gated, 1)


def moe_apply(p: Dict, x: torch.Tensor, policy, cfg: MoEConfig, *,
              serve: bool = True, impl: str = "auto",
              lname: str = "", mesh=None) -> torch.Tensor:
    """One MoE block: x (B, S, D) -> (B, S, D), routing and capacity per
    batch row as the reference's grouped dispatch.  ``serve`` (the port's
    default; the reference defaults to the train path) runs the packed
    experts through K1; ``serve=False`` is the QAT forward under autograd:
    ``route``, ``dispatch``, the fake-quant banks and ``gate_and_combine``,
    each with the reference's gradient.  ``mesh`` with a 'model' axis
    above 1: expert parallelism over this rank's slice of ``p`` (module
    doc), the routed block's output bitwise the one-device block's on
    every rank, and in training each of its gradients too."""
    b, s, d = x.shape
    first, e = expert_coords(mesh, cfg.n_experts)
    tp = e < cfg.n_experts
    mine = slice(first, first + e)
    if tp and not serve:
        idx, vals, tok_idx = route(x, whole_router(p["router"], mesh), cfg)
        xg = dispatch(x, tok_idx, idx, serve=False, mesh=mesh)
    else:
        idx, vals, tok_idx = route(x, p["router"], cfg, mesh)
        xg = dispatch(x, tok_idx[:, mine], idx, serve=serve)
    cap = tok_idx.shape[-1]
    # the bank: (E, B*C, D), one product per projection
    xe = xg.transpose(0, 1).reshape(e, b * cap, d)
    h = _ffn(p, xe, policy, cfg, impl, lname + "expert", serve=serve)
    h = h.reshape(e, b, cap, d).transpose(0, 1)              # (B, E, C, D)
    if serve:
        y = expert_parallel_combine(h, vals, tok_idx, idx, s,
                                    mesh).to(x.dtype)
    elif tp:
        gated = _Gate.apply(h, mesh_lib.cut_model(mesh, vals, 1))
        y = _combine(gather_gated(gated, mesh), tok_idx, idx, s).to(x.dtype)
    else:
        y = gate_and_combine(h, vals, tok_idx, idx, s,
                             serve=False).to(x.dtype)
    if cfg.n_shared:
        y = y + _ffn(p, x, policy, cfg, impl, lname + "shared",
                     prefix="shared_", serve=serve,
                     row_mesh=mesh if tp else None).to(y.dtype)
    return y
