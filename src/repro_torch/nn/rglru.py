"""RG-LRU recurrent block (port of ``repro.nn.rglru``; Griffin /
RecurrentGemma):

    r_t = sigmoid(W_a x_t)          recurrence gate
    i_t = sigmoid(W_x x_t)          input gate
    a_t = exp(-c * softplus(L) * r_t)
    h_t = a_t * h_{t-1} + sqrt(1 - a_t^2) * (i_t * x_t)

The prefill runs the linear recurrence as ``jax.lax.associative_scan``
does (``associative_scan`` below: its odd/even recursion over the same
slices, so each element is combined in the same order and rounded the
same way); decode is the one-step recurrence.  The five projections run
on K1 through ``nn.quantized``'s serve path (``serve=True``), or
fake-quant under autograd (``serve=False``, the QAT forward); ``lam`` and
the state stay f32.  Everything past the projections is elementwise, so a
row's bits do not depend on the batch.  The scan's output is built by
copies into strided views of an empty tensor, which autograd takes back
as slices, as JAX transposes the reference's interleave (pads and adds).

Tensor-parallel serving (``mesh=`` with a 'model' axis of M above 1): a
rank holds the channels ``[r d_rnn/M, (r + 1) d_rnn/M)``: its columns of
``in_x`` and ``in_gate``, its channels of the conv and of ``lam``, its
rows of ``w_a``, ``w_x`` and ``out`` and its channels of the state.  The
gates are row shards whose output is the rank's channels again: K1
accumulator-only over its rows, the int32 sums all-reduced, and the rank
keeps its columns (``qlinear_serve_apply(row_mesh=)``; the fp baseline
all-gathers the input and multiplies its columns of the whole rows).
Everything else is elementwise on the rank's channels, and ``out`` is a
row shard, so every rank's output is the one-device block's, bitwise.
"""
from __future__ import annotations

import dataclasses
from typing import Callable, Dict, List, Optional, Tuple

import torch

from repro_torch.launch import mesh as mesh_lib
from repro_torch.nn import layers
from repro_torch.nn import quantized as Q
from repro_torch.nn.param import ParamSpec

__all__ = ["RGLRUConfig", "rglru_block_spec", "rglru_block_forward",
           "rglru_block_step", "rglru_state_spec", "associative_scan",
           "linear_combine"]

_C = 8.0  # Griffin's fixed temperature


@dataclasses.dataclass(frozen=True)
class RGLRUConfig:
    d_model: int
    d_rnn: int
    conv_width: int = 4


def rglru_block_spec(cfg: RGLRUConfig, *, serve: bool = False,
                     policy=None) -> Dict:
    """Plan-layer names = recurrentgemma's ``gemm_workload`` names:
    ``rnn_in`` covers both input projections, ``rnn_gates`` the recurrence
    gates."""
    if serve:
        mk = lambda i, o, nm, ax: Q.qlinear_serve_spec(  # noqa: E731
            i, o, axes=ax, policy=policy, name=nm)
    else:
        mk = lambda i, o, nm, ax: Q.qlinear_spec(  # noqa: E731
            i, o, axes=ax, name=nm)
    d, dr = cfg.d_model, cfg.d_rnn
    return {
        "in_x": mk(d, dr, "rnn_in", ("embed", "mlp")),
        "in_gate": mk(d, dr, "rnn_in", ("embed", "mlp")),
        "w_a": mk(dr, dr, "rnn_gates", ("mlp", "mlp")),
        "w_x": mk(dr, dr, "rnn_gates", ("mlp", "mlp")),
        "out": mk(dr, d, "rnn_out", ("mlp", "act_embed")),
        "conv": layers.conv1d_spec(dr, cfg.conv_width),
        "lam": ParamSpec(shape=(dr,), axes=("mlp",), init="constant",
                         const=0.7),
    }


def rglru_state_spec(cfg: RGLRUConfig, batch: int,
                     model: int = 1) -> Dict[str, ParamSpec]:
    """The decode state; ``model`` > 1: one tensor-parallel rank's
    channels."""
    dr = cfg.d_rnn // model
    return {"h": ParamSpec(shape=(batch, dr), axes=("batch", "mlp"),
                           init="zeros"),
            "conv": ParamSpec(shape=(batch, cfg.conv_width - 1, dr),
                              axes=("batch", None, "mlp"), init="zeros")}


def _proj(p, x, policy, impl, name, serve=True, row_mesh=None):
    """One projection; ``row_mesh`` (serve only): a row shard over that
    mesh's 'model' axis."""
    if row_mesh is not None:
        return Q.qlinear_serve_apply(p, x, policy, impl=impl, name=name,
                                     row_mesh=row_mesh)
    return Q.qlinear_any(p, x, policy, serve=serve, impl=impl, name=name)


def _tp(mesh, serve: bool):
    """``mesh`` where its 'model' axis is above 1 (serve only), else
    None."""
    if mesh_lib.model_coords(mesh)[1] == 1:
        return None
    if not serve:
        raise ValueError("a tensor-parallel RG-LRU block serves packed "
                         "trees only (serve=True)")
    return mesh


def _gates(p, xb, policy, impl, serve=True, mesh=None):
    """xb (..., d_rnn) -> (a, gated input) in f32."""
    r = torch.sigmoid(_proj(p["w_a"], xb, policy, impl, "rnn_gates",
                            serve, mesh).to(torch.float32))
    i = torch.sigmoid(_proj(p["w_x"], xb, policy, impl, "rnn_gates",
                            serve, mesh).to(torch.float32))
    log_a = -_C * layers.softplus(p["lam"].to(torch.float32)) * r
    a = torch.exp(log_a)
    beta = torch.sqrt(torch.clamp_min(1.0 - torch.exp(2.0 * log_a), 1e-12))
    return a, beta * i * xb.to(torch.float32)


def linear_combine(left, right):
    """The recurrence's monoid: (a1, b1) then (a2, b2) -> (a1 a2,
    a2 b1 + b2), the product and the sum each rounded (no FMA), as the
    JAX package computes them op by op."""
    a1, b1 = left
    a2, b2 = right
    return [a1 * a2, a2 * b1 + b2]


def _slice(x: torch.Tensor, axis: int, start: int, stop: Optional[int],
           step: int = 1) -> torch.Tensor:
    idx = [slice(None)] * x.ndim
    idx[axis] = slice(start, stop, step)
    return x[tuple(idx)]


def _interleave(a: torch.Tensor, b: torch.Tensor, axis: int) -> torch.Tensor:
    """a at the even positions of ``axis``, b at the odd ones (a may hold
    one more)."""
    n = a.shape[axis] + b.shape[axis]
    shape = list(a.shape)
    shape[axis] = n
    out = a.new_empty(shape)
    _slice(out, axis, 0, None, 2).copy_(a)
    _slice(out, axis, 1, None, 2).copy_(b)
    return out


def associative_scan(fn: Callable, elems: List[torch.Tensor],
                     axis: int = 0) -> List[torch.Tensor]:
    """Inclusive scan of ``fn`` over ``axis`` by ``jax.lax.associative_scan``'s
    recursion: combine adjacent pairs, scan the pairs, then fill in the
    even positions -- the same combines on the same operands in the same
    order, so an elementwise ``fn`` rounds as the JAX package's does."""
    n = elems[0].shape[axis]
    if n < 2:
        return elems
    reduced = fn([_slice(e, axis, 0, -1, 2) for e in elems],
                 [_slice(e, axis, 1, None, 2) for e in elems])
    odd = associative_scan(fn, reduced, axis)
    if n % 2 == 0:
        even = fn([_slice(e, axis, 0, -1) for e in odd],
                  [_slice(e, axis, 2, None, 2) for e in elems])
    else:
        even = fn(odd, [_slice(e, axis, 2, None, 2) for e in elems])
    even = [torch.cat([_slice(e, axis, 0, 1), r], dim=axis)
            for e, r in zip(elems, even)]
    return [_interleave(e, o, axis) for e, o in zip(even, odd)]


def rglru_block_forward(p: Dict, x: torch.Tensor, policy, cfg: RGLRUConfig,
                        *, impl: str = "auto",
                        h0: Optional[torch.Tensor] = None,
                        serve: bool = True, mesh=None
                        ) -> Tuple[torch.Tensor, Dict[str, torch.Tensor]]:
    """x (B, S, D) -> (out (B, S, D), {"h": (B, d_rnn), "conv": (B, W-1,
    d_rnn)}); ``h0`` folds a carried state in as a step-0 contribution;
    ``serve=False`` runs the projections fake-quant; ``mesh``:
    tensor-parallel over this rank's channels (module doc), the state
    the rank's."""
    mesh = _tp(mesh, serve)
    xb = _proj(p["in_x"], x, policy, impl, "rnn_in", serve)
    gate = layers.gelu(_proj(p["in_gate"], x, policy, impl, "rnn_in",
                             serve))
    pre_conv = xb
    xb = layers.causal_conv1d(p["conv"], xb)
    a, b = _gates(p, xb, policy, impl, serve, mesh)
    if h0 is not None:
        b = b.clone()
        b[:, 0, :] = b[:, 0, :] + a[:, 0, :] * h0.to(torch.float32)
    _, h_seq = associative_scan(linear_combine, [a, b], axis=1)
    y = h_seq.to(x.dtype) * gate
    out = _proj(p["out"], y, policy, impl, "rnn_out", serve, mesh)
    w1 = cfg.conv_width - 1
    tail = pre_conv[:, -w1:, :].to(torch.float32)
    if tail.shape[1] < w1:  # the reference's slice is as short as S
        tail = torch.nn.functional.pad(tail, (0, 0, w1 - tail.shape[1], 0))
    return out, {"h": h_seq[:, -1, :], "conv": tail}


def rglru_block_step(p: Dict, x_t: torch.Tensor,
                     state: Dict[str, torch.Tensor], policy,
                     cfg: RGLRUConfig, *, impl: str = "auto",
                     serve: bool = True, mesh=None
                     ) -> Tuple[torch.Tensor, Dict[str, torch.Tensor]]:
    """One-token step: x_t (B, 1, D) -> (out (B, 1, D), new state);
    ``serve=False`` runs the projections fake-quant; ``mesh`` as
    ``rglru_block_forward``'s."""
    mesh = _tp(mesh, serve)
    xb = _proj(p["in_x"], x_t, policy, impl, "rnn_in", serve)[:, 0]
    gate = layers.gelu(_proj(p["in_gate"], x_t, policy, impl, "rnn_in",
                             serve))[:, 0]
    conv_cache, xbc = layers.causal_conv1d_step(
        p["conv"], state["conv"].to(xb.dtype), xb)
    a, b = _gates(p, xbc, policy, impl, serve, mesh)
    h = a * state["h"] + b
    y = (h.to(x_t.dtype) * gate)[:, None, :]
    out = _proj(p["out"], y, policy, impl, "rnn_out", serve, mesh)
    return out, {"h": h, "conv": conv_cache.to(torch.float32)}
