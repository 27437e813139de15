"""Quantized layers (port of ``repro.nn.quantized``): the QAT (train)
forward and the packed-plane (serve) forward.

Train mode: LSQ fake-quant of both operands -- activations unsigned 8 bit
in their own dtype (bf16), weights signed w_Q bit in f32 with trained step
sizes -- then a bf16 product, as ``jnp.einsum`` computes it
(``qlinear_apply``); a conv is im2col + that (``qconv_apply``).  Plain
torch under autograd: the reference's train path reaches no Pallas kernel.
On a tensor-parallel training mesh a projection is column-parallel
(``col_mesh``) or row-parallel (``row_mesh``), its collectives under
autograd (``launch.mesh``).

Serve mode: weights live as packed k-bit digit planes (uint8), activations are
quantized on the fly to biased int8 codes, and the product runs through
``kernels.mpmm.ops`` -- the hand-written kernels on CUDA tensors.  BN,
the shortcut add and ReLU run in the kernel epilogue.  On a tensor-parallel
mesh a column-parallel layer (q, gate, up, the head) runs as it is over its
local columns; a row-parallel one (o, down: ``row_mesh=``) holds the rows of
its contraction axis, runs K1's accumulator-only mode over them, sums the
int32 partials over 'model' and finishes the whole sum with the shared
epilogue, so its output is bitwise the one-device layer's.  A row shard
whose output columns are split too (the RG-LRU's gates, ``('mlp',
'mlp')``) keeps its own columns of the summed accumulator.

A quantized-linear param subtree is marked by the key ``QMARK``; in spec
trees the marker carries the layer class and its workload layer name, so a
layer-wise ``PrecisionPlan`` resolves each layer's format at pack and
serve time.  Under ``quantize=False`` (the fp baseline the paper compares
against) ``pack_qlinear`` keeps the weight in bf16 under ``"w"`` and the
serve forward is a plain bf16 matrix product followed by the same f32
epilogue; convs then always go through im2col.  On a tensor-parallel mesh
the fp baseline departs from ``SERVE_RULES``: a bf16 partial sum is not
exact, so no fp weight splits its contraction axis (``fp_serve_axes``).
A row-parallel layer keeps its whole weight and all-gathers its input
over 'model'; a column shard (or an expert bank's experts) runs at the
one-device shape, its weight zero-padded to the whole (``fp_shard``),
because the product's kernel, and so its bits, is picked by the shape.
"""
from __future__ import annotations

import dataclasses
import functools
from typing import Dict, Optional, Tuple

import torch

from repro_torch.core import dse, packing, quant
from repro_torch.core import plan as plan_lib
from repro_torch.core.packing import PlaneFormat
from repro_torch.core.plan import PolicyOrPlan
from repro_torch.core.precision import PrecisionPolicy
from repro_torch.kernels.mpmm import epilogue as mpmm_epilogue
from repro_torch.kernels.mpmm import ops as mpmm_ops
from repro_torch.kernels.mpmm import ref as mpmm_ref
from repro_torch.kernels.mpmm.epilogue import EpilogueSpec
from repro_torch.launch import mesh as mesh_lib
from repro_torch.nn.param import QMARK, ParamSpec

__all__ = [
    "qlinear_spec",
    "qlinear_serve_spec",
    "qconv_spec",
    "qlinear_apply",
    "qconv_apply",
    "qlinear_serve_apply",
    "qconv_serve_apply",
    "conv_serve_dataflow",
    "im2col",
    "im2col_train",
    "pack_qlinear",
    "pack_tree",
    "is_qlinear",
    "fp_serve_axes",
    "fp_shard",
    "take_pieces",
    "column_pieces",
    "QMARK",
    "EpilogueSpec",
]


def _marker(layer_class: str, name: str = "") -> ParamSpec:
    # Zero-size marker: the layer class and the workload layer name ride in
    # its axes slots.
    return ParamSpec(shape=(0, 0), axes=(layer_class, name or None),
                     init="zeros")


def qlinear_spec(in_dim: int, out_dim: int, *,
                 axes: Tuple[Optional[str], str] = ("embed", "mlp"),
                 layer_class: str = "inner",
                 channel_wise: bool = False, lead: Tuple[int, ...] = (),
                 lead_axes: Tuple[Optional[str], ...] = (),
                 name: str = "") -> Dict[str, ParamSpec]:
    """Spec of one QAT linear: master weight + LSQ step sizes.  ``lead``
    adds leading axes -- ``(E,)`` for an MoE expert bank, one weight and
    one pair of step sizes per expert -- named by ``lead_axes``; ``axes``
    names the (in, out) axes for the partitioning rules."""
    return {
        QMARK: _marker(layer_class, name),
        "w": ParamSpec(shape=lead + (in_dim, out_dim),
                       axes=lead_axes + tuple(axes), init="normal",
                       fan_in_axes=(-2,)),
        "gw": ParamSpec(shape=lead + ((out_dim,) if channel_wise else ()),
                        axes=lead_axes + ((axes[1],) if channel_wise else ()),
                        init="constant", const=0.05),
        "ga": ParamSpec(shape=lead, axes=lead_axes, init="constant",
                        const=0.05),
    }


def qlinear_serve_spec(in_dim: int, out_dim: int, *,
                       axes: Tuple[Optional[str], str] = ("embed", "mlp"),
                       layer_class: str = "inner",
                       policy: PolicyOrPlan = PrecisionPolicy(),
                       lead: Tuple[int, ...] = (),
                       lead_axes: Tuple[Optional[str], ...] = (),
                       name: str = "") -> Dict[str, ParamSpec]:
    """Spec of the deployed (packed) form at the layer's own resolved
    format: what ``pack_qlinear`` returns for a ``lead + (in_dim,
    out_dim)`` weight (``lead=(E,)``: an expert bank, one format for the
    whole bank).  The packed contraction axis is named after the input
    axis (``mlp_packed``, ``heads_packed``, ...), so the serve rules can
    shard the rows of projections that write the residual stream."""
    pol = plan_lib.resolve_policy(policy, name)
    if not pol.quantize:  # the fp baseline: the bf16 weight
        return {QMARK: _marker(layer_class, name),
                "w": ParamSpec(shape=lead + (in_dim, out_dim),
                               dtype=torch.bfloat16,
                               axes=lead_axes + tuple(axes), init="normal",
                               fan_in_axes=(-2,))}
    fmt = PlaneFormat(w_bits=pol.bits_for(layer_class), k=pol.k,
                      k_dim=in_dim)
    k_axis = f"{axes[0]}_packed" if axes[0] else None
    return {
        QMARK: _marker(layer_class, name),
        "planes": ParamSpec(shape=lead + (fmt.planes, fmt.packed_k, out_dim),
                            dtype=torch.uint8,
                            axes=lead_axes + ("plane", k_axis, axes[1]),
                            init="zeros"),
        "colsum": ParamSpec(shape=lead + (1, out_dim), dtype=torch.int32,
                            axes=lead_axes + (None, axes[1]), init="zeros"),
        "gamma": ParamSpec(shape=lead + (1, out_dim),
                           axes=lead_axes + (None, axes[1]),
                           init="constant", const=1e-3),
        "ga": ParamSpec(shape=lead, axes=lead_axes, init="constant",
                        const=0.05),
    }


def qconv_spec(cin: int, cout: int, k: int, *, layer_class: str = "inner",
               channel_wise: bool = False, name: str = "",
               name_axes: Tuple[Optional[str], str] = ("embed", "mlp")
               ) -> Dict[str, ParamSpec]:
    """A k x k conv is a (k*k*cin, cout) linear over (kh, kw, C) patches."""
    return qlinear_spec(k * k * cin, cout, axes=name_axes,
                        layer_class=layer_class, channel_wise=channel_wise,
                        name=name)


def is_qlinear(sub) -> bool:
    return isinstance(sub, dict) and QMARK in sub


def _layer_class_of(sub: Dict) -> str:
    return sub[QMARK].axes[0] or "inner"


def _layer_name_of(sub: Dict) -> str:
    return sub[QMARK].axes[1] or ""


class _ColumnProduct(torch.autograd.Function):
    """x (..., K) @ w (K, N) in bf16, x whole on every 'model' rank and w
    the rank's block of columns: forward the bf16 product; backward x's
    cotangent as the rank's f32 partial product, summed over 'model' in
    rank order (``sum_model``) and rounded to bf16 once, as one device's
    bf16 product rounds its f32 sum once -- a partial rounded on each
    rank first would round twice -- and w's as torch's product gives
    it."""

    @staticmethod
    def forward(ctx, x, w, mesh):
        ctx.save_for_backward(x, w)
        ctx.mesh = mesh
        return torch.matmul(x, w)

    @staticmethod
    def backward(ctx, g):
        x, w = ctx.saved_tensors
        f32 = torch.float32
        g2 = g.reshape(-1, g.shape[-1])
        dx = torch.matmul(g2.to(f32), w.to(f32).mT)
        dx = mesh_lib.sum_model(ctx.mesh, dx).to(x.dtype)
        dw = x.reshape(-1, x.shape[-1]).mT.mm(g2)
        return dx.reshape(x.shape), dw, None


class _RowStep(torch.autograd.Function):
    """A row shard's activation step (0-d, in the activation's dtype)
    broadcast to the shard's ``shape``.  Backward: its cotangent summed
    over the shard in f32, over 'model' in rank order (``sum_model``),
    and rounded to the step's dtype once, as one device's reduction over
    the whole activation rounds once.  LSQ's step gradient is a sum of
    cancelling terms: each rank's partial rounded to bf16 first would
    carry an error of the order of the sum itself."""

    @staticmethod
    def forward(ctx, g, shape, mesh):
        ctx.mesh = mesh
        return g.expand(shape)

    @staticmethod
    def backward(ctx, grad):
        total = mesh_lib.sum_model(ctx.mesh, grad.sum(dtype=torch.float32))
        return total.to(grad.dtype), None, None


def _whole(shape) -> Dict:
    """``fake_quant``'s ``whole=`` where a shard's tensor has one, else
    nothing (one device calls it as before)."""
    return {} if shape is None else {"whole": shape}


def _grown(shape, dim: int, m: int) -> tuple:
    shape = list(shape)
    shape[dim] *= m
    return tuple(shape)


def qlinear_apply(p: Dict[str, torch.Tensor], x: torch.Tensor,
                  policy: PolicyOrPlan, *, layer_class: str = "inner",
                  quantize_act: bool = True, name: str = "",
                  col_mesh=None, row_mesh=None) -> torch.Tensor:
    """QAT forward: fake-quant(x) @ fake-quant(w) (+ b), the product in
    bf16.  The weight quantizes in f32 (channel-wise where the
    layer's ``gw`` is a vector and the policy asks for it), the activation
    in its own dtype; ``quantize_act=False`` (the CNN stem's raw pixels)
    leaves x as it is.

    An expert bank (``p`` with ``lead=(E,)``) takes x (E, M, K): each
    expert's weight and rows are fake-quantized with its own steps, and
    the product is one batched bf16 product -> (E, M, N), as the
    reference's ``jax.vmap`` over the experts computes it.

    Tensor-parallel training over the 'model' axis of the mesh given (M
    ranks; LSQ's N is always the whole tensor's count, ``fake_quant(...,
    whole=)``):

    * ``col_mesh``: column-parallel.  ``w`` holds the rank's block of
      output columns, x is whole on every rank and is fake-quantized
      there; d(x_q) is summed over the ranks before the LSQ backward
      (the f32 partial products, summed and rounded once:
      ``_ColumnProduct``), so x's and ``ga``'s gradients are whole and
      the same on every rank.  A per-tensor ``gw``'s gradient is
      summed over 'model' in f32; a channel-wise one is the rank's own.
      -> the rank's columns.
    * ``row_mesh``: row-parallel.  ``w`` holds the rank's block of rows, x
      the rank's block of K.  ``gw``'s gradient is partial and summed in
      f32; ``ga``'s, a bf16 reduction, is summed in f32 before it is
      rounded (``_RowStep``).  The partial product runs in f32 (bf16
      operands, exact products), is summed over the ranks in rank order
      (``sum_model``) and rounded to bf16 once; the bias is added once,
      after it."""
    policy = plan_lib.resolve_policy(policy, name)
    w, gw, ga = p["w"], p["gw"], p["ga"]
    lead = w.ndim - 2
    mesh = col_mesh or row_mesh
    m = mesh_lib.model_coords(mesh)[1]
    if m == 1:
        mesh = col_mesh = row_mesh = None
    w_whole = (_grown(w.shape, -1, m) if col_mesh is not None else
               _grown(w.shape, -2, m) if row_mesh is not None else None)
    if policy.quantize:
        channel = gw.ndim > lead and policy.channel_wise
        wspec = quant.weight_spec(policy.bits_for(layer_class),
                                  channel_axis=-1 if channel else None)
        if row_mesh is not None or (col_mesh is not None and not channel):
            gw = mesh_lib.copy_model(mesh, gw)  # a share of its gradient
        w = quant.fake_quant(w.to(torch.float32), gw, wspec, lead=lead,
                             **_whole(w_whole))
        if quantize_act:
            kw = {}
            if row_mesh is not None:
                kw = {"whole": _grown(x.shape, -1, m),
                      "spread": lambda g, shape: _RowStep.apply(g, shape,
                                                                mesh)}
            x = quant.fake_quant(x, ga, quant.act_spec(policy.a_bits),
                                 lead=lead, **kw)
    if col_mesh is not None:
        y = _ColumnProduct.apply(x.to(torch.bfloat16), w.to(torch.bfloat16),
                                 mesh)
    elif row_mesh is not None:
        f32 = torch.float32
        y = torch.matmul(x.to(torch.bfloat16).to(f32),
                         w.to(torch.bfloat16).to(f32))
        y = mesh_lib.sum_model(mesh, y).to(torch.bfloat16)
    else:
        y = torch.matmul(x.to(torch.bfloat16), w.to(torch.bfloat16))
    if "b" in p:
        y = y + p["b"].to(torch.bfloat16)
    return y


def qlinear_any(p, x: torch.Tensor, policy: PolicyOrPlan, *, serve: bool,
                impl: str = "auto", name: str = "", **kw) -> torch.Tensor:
    """One projection in either mode: packed through K1 (``serve``, a
    ``pack_for_serving`` leaf) or fake-quant under autograd (a train
    leaf); ``kw`` (``layer_class``) goes to both."""
    if serve:
        return qlinear_serve_apply(p, x, policy, impl=impl, name=name, **kw)
    return qlinear_apply(p, x, policy, name=name, **kw)


def qconv_apply(p, x: torch.Tensor, policy: PolicyOrPlan, *, k: int,
                stride: int = 1, padding: str = "SAME",
                layer_class: str = "inner", quantize_act: bool = True,
                name: str = "", mesh=None, cout: int = 0) -> torch.Tensor:
    """QAT conv forward: im2col (NHWC, (kh, kw, C) patches,
    ``im2col_train``) + the fake-quant linear.

    ``mesh`` (tensor-parallel training over its 'model' axis) where the
    weight holds a block of its ``cout`` output channels: the linear is
    column-parallel (``qlinear_apply``'s ``col_mesh``) and its channels
    are all-gathered (``launch.mesh.gather_model``), so what follows (BN
    and its batch statistics) runs whole on every rank.  A weight kept
    whole (its channels do not split) runs as on one device."""
    cut = mesh is not None and p["w"].shape[-1] != cout
    cols = im2col_train(x, k, k, stride, padding)
    y = qlinear_apply({kk: v for kk, v in p.items() if kk != QMARK},
                      cols, policy, layer_class=layer_class,
                      quantize_act=quantize_act, name=name,
                      col_mesh=mesh if cut else None)
    return mesh_lib.gather_model(mesh, y, -1) if cut else y


def _fold_bias(p, epilogue, scale, shift):
    """Fold a layer bias into the epilogue's scale/shift stage (the bias
    enters before the post-ops, as in the QAT forward)."""
    if "b" in p and epilogue is not None:
        b = p["b"].to(torch.float32).reshape(1, -1)
        if epilogue.bn:
            shift = shift.to(torch.float32) + b * scale.to(torch.float32)
        else:
            epilogue = dataclasses.replace(epilogue, bn=True)
            scale = torch.ones_like(b)
            shift = b
    return epilogue, scale, shift


def fp_serve_axes(specs):
    """Logical axes of the fp baseline's serve tree (``specs``: its spec
    tree, markers kept) for a tensor-parallel mesh: as ``axes_tree``
    gives them, but every bf16 weight's contraction axis unnamed, so no
    rank holds a block of it (a row-parallel weight is whole on every
    rank; the RG-LRU's ``('mlp', 'mlp')`` gates split their columns)."""
    if is_qlinear(specs):
        out = {k: v.axes for k, v in specs.items() if k != QMARK}
        w = out["w"]
        out["w"] = w[:-2] + (None, w[-1])
        return out
    if isinstance(specs, dict):
        return {k: fp_serve_axes(v) for k, v in specs.items() if k != QMARK}
    if isinstance(specs, list):
        return [fp_serve_axes(v) for v in specs]
    return specs.axes if specs.axes else (None,) * len(specs.shape)


def fp_shard(p, dim: int, pieces) -> Dict:
    """An fp baseline layer's shard over 'model': ``p`` (``{"w"[, "b"]}``,
    whole) cut to the ``pieces`` ``((start, stop), ...)`` of weight
    dimension ``dim`` (-1: output columns, with the bias; -3: an expert
    bank's experts), in order, with ``"shard": (dim, whole size,
    pieces)``, which ``qlinear_serve_apply`` reads to run the product at
    the one-device shape."""
    w = p["w"]
    out = {"w": take_pieces(w, pieces, dim),
           "shard": (dim, w.shape[dim], tuple(pieces))}
    if "b" in p:
        out["b"] = take_pieces(p["b"], pieces) if dim == -1 else p["b"]
    return out


def take_pieces(t: torch.Tensor, pieces, dim: int = -1) -> torch.Tensor:
    """The ``pieces`` ``((start, stop), ...)`` of ``t``'s dimension
    ``dim``, in order, as a tensor of its own."""
    idx = torch.cat([torch.arange(a, b, device=t.device) for a, b in pieces])
    return torch.index_select(t, dim % t.ndim, idx).contiguous()


def column_pieces(p, pieces) -> Dict:
    """A whole serve layer cut to the ``pieces`` ``((start, stop), ...)``
    of its output columns, in order: a packed layer's planes, colsum and
    gamma (and bias; ``ga`` is per tensor), or the fp baseline's
    ``fp_shard``.  A K1 output column is one exact int32 dot product, so
    any set of columns is the one-device layer's, bit for bit."""
    if "w" in p:
        return fp_shard(p, -1, pieces)
    return {k: v if k == "ga" else take_pieces(v, pieces)
            for k, v in p.items()}


def _fp_whole(t: torch.Tensor, dim: int, whole: int, pieces) -> torch.Tensor:
    """``t``'s pieces along ``dim`` placed at their own index of a
    zero tensor ``whole`` long there."""
    shape = list(t.shape)
    shape[dim] = whole
    out = t.new_zeros(shape)
    at = 0
    for a, b in pieces:
        out.narrow(dim, a, b - a).copy_(t.narrow(dim, at, b - a))
        at += b - a
    return out


def _fp_pieces(y: torch.Tensor, dim: int, pieces) -> torch.Tensor:
    parts = [y.narrow(dim, a, b - a) for a, b in pieces]
    return parts[0] if len(parts) == 1 else torch.cat(parts, dim)


def _fp_serve_apply(p, x, *, compute_dtype, epilogue, scale, shift,
                    residual) -> torch.Tensor:
    """The fp baseline: a bf16 matrix product, the bias, then the f32
    epilogue (the reference's order: the bias is not folded).  A shard
    (``fp_shard``) multiplies at the one-device shape: its weight
    zero-padded to the whole, and for an expert bank its rows too, then
    keeps its own pieces of the product."""
    w = p["w"]
    shard = p.get("shard")
    if shard is not None:
        dim, whole, pieces = shard
        w = _fp_whole(w, dim, whole, pieces)
        if dim != -1:  # the experts: x (E/M, R, K) -> (E, R, K)
            x = _fp_whole(x, dim, whole, pieces)
    y = torch.matmul(x.to(compute_dtype), w.to(compute_dtype))
    if shard is not None:
        y = _fp_pieces(y, shard[0], shard[2])
    if "b" in p:
        y = y + p["b"].to(compute_dtype)
    out_dtype = mpmm_epilogue.resolve_out_dtype(epilogue, compute_dtype)
    return mpmm_epilogue.apply(y.to(torch.float32), epilogue, scale, shift,
                               residual).to(out_dtype)


def qlinear_serve_apply(p: Dict[str, torch.Tensor], x: torch.Tensor,
                        policy: PolicyOrPlan, *, layer_class: str = "inner",
                        tile: Optional[mpmm_ops.TileShape] = None,
                        impl: str = "auto", compute_dtype=torch.bfloat16,
                        epilogue: Optional[EpilogueSpec] = None,
                        scale: Optional[torch.Tensor] = None,
                        shift: Optional[torch.Tensor] = None,
                        residual: Optional[torch.Tensor] = None,
                        act_signed: bool = False, name: str = "",
                        row_mesh=None) -> torch.Tensor:
    """Deployed forward: quantize activations -> mpmm over packed planes.

    ``act_signed=True`` uses symmetric signed codes (act_zero = 0), for
    inputs that straddle zero such as a CNN stem's pixels.  ``policy`` may
    be a ``PrecisionPlan``; ``name`` picks this layer's entry.

    An expert bank (``p`` packed with ``lead=(E,)``) takes x (E, ..., K):
    each expert's rows are quantized with that expert's ``ga`` (the
    reference maps ``qlinear_serve_apply`` over the experts with
    ``jax.vmap``, so each carries its own step), and the product is ONE
    kernel call over the bank -> (E, ..., N).

    ``row_mesh``: the layer is a row shard on that mesh's 'model' axis
    (``x`` and ``planes`` hold this rank's block of the contraction axis,
    gamma and colsum are whole, or this rank's block of the output
    columns): the local codes -- the one-device codes' block, since the
    whole ``ga`` quantizes elementwise -- run K1's accumulator-only mode,
    the int32 partials are summed over 'model'
    (``launch.mesh.all_reduce_model``), the rank keeps its columns where
    gamma holds a block of them, and ``epilogue.finish`` completes the
    sum: bitwise the one-device output on every rank.  The fp baseline
    all-gathers ``x`` over 'model' instead and multiplies its weight,
    whole over the contraction axis.
    """
    policy = plan_lib.resolve_policy(policy, name)
    mpmm_epilogue.validate_operands(epilogue, scale, shift, residual)
    tp_rows = row_mesh is not None and mesh_lib.model_coords(row_mesh)[1] > 1
    if "w" in p:  # the fp baseline
        if tp_rows:  # the whole input against the whole contraction axis
            x = mesh_lib.all_gather_model(row_mesh, x, dim=-1)
        return _fp_serve_apply(p, x, compute_dtype=compute_dtype,
                               epilogue=epilogue, scale=scale, shift=shift,
                               residual=residual)
    epilogue, scale, shift = _fold_bias(p, epilogue, scale, shift)
    fmt = PlaneFormat(w_bits=policy.bits_for(layer_class), k=policy.k,
                      k_dim=x.shape[-1])
    act_zero = 0 if act_signed else 2 ** (policy.a_bits - 1)
    if tp_rows:
        return _row_parallel_apply(p, x, fmt, policy, row_mesh, impl=impl,
                                   act_signed=act_signed, act_zero=act_zero,
                                   compute_dtype=compute_dtype,
                                   epilogue=epilogue, scale=scale,
                                   shift=shift, residual=residual)
    ga = p["ga"]
    if ga.ndim:  # an expert bank: one step per expert, over its rows
        ga = ga.reshape(ga.shape + (1,) * (x.ndim - ga.ndim))
    a = mpmm_ops.quantize_activations(x, ga, policy.a_bits,
                                      signed=act_signed)
    y = mpmm_ops.mpmm(
        a, p["planes"], p["gamma"], p["colsum"], scale, shift, residual,
        fmt=fmt, act_zero=act_zero, tile=tile, variant=policy.variant,
        impl=impl, out_dtype=compute_dtype, epilogue=epilogue)
    if "b" in p and epilogue is None:
        y = y + p["b"].to(compute_dtype)
    return y


def _row_parallel_apply(p, x, fmt, policy, mesh, *, impl, act_signed,
                        act_zero, compute_dtype, epilogue, scale, shift,
                        residual) -> torch.Tensor:
    """A row shard of a linear (see ``qlinear_serve_apply``'s
    ``row_mesh``): local codes -> int32 partial (K1 accumulator-only) ->
    sum over 'model' -> the epilogue on the whole sum."""
    if p["ga"].ndim:
        raise NotImplementedError("an expert bank is not row-sharded over "
                                  "'model': expert parallelism holds whole "
                                  "experts a rank (nn.moe)")
    if p["planes"].shape[-2] != fmt.packed_k \
            or fmt.k_dim % fmt.digits_per_byte:
        raise ValueError(
            f"a row shard of {fmt.k_dim} inputs must fill whole packed "
            f"bytes ({fmt.digits_per_byte} digits a byte) and match its "
            f"planes' {p['planes'].shape[-2]} packed rows")
    a = mpmm_ops.quantize_activations(x, p["ga"], policy.a_bits,
                                      signed=act_signed)
    acc = mpmm_ops.mpmm_acc(a, p["planes"], fmt=fmt, variant=policy.variant,
                            impl=impl)
    acc = mesh_lib.all_reduce_model(mesh, acc)
    n = p["gamma"].shape[-1]
    if n != acc.shape[-1]:  # the rank holds a block of the columns too
        r, m = mesh_lib.model_coords(mesh)
        if n * m != acc.shape[-1]:
            raise ValueError(f"a row shard's {n} output columns are neither "
                             f"its {acc.shape[-1]} nor a 'model' block of "
                             f"them")
        acc = acc[..., r * n:(r + 1) * n]
    y = mpmm_epilogue.finish(acc, p["gamma"], p["colsum"], act_zero=act_zero,
                             spec=epilogue, scale=scale, shift=shift,
                             residual=residual, out_dtype=compute_dtype)
    if "b" in p and epilogue is None:
        y = y + p["b"].to(compute_dtype)
    return y


def im2col(x: torch.Tensor, kh: int, kw: int, stride: int,
           padding: str) -> torch.Tensor:
    """x (B, H, W, C) -> patches (B, Ho, Wo, kh*kw*C) in (kh, kw, C) order,
    matching the HWIO weight flattening; zero padding with XLA's SAME pads."""
    xp = mpmm_ref.pad_spatial(x, kh, kw, stride, padding, fill=0)
    return mpmm_ref.gather_patches(xp, kh, kw, stride)


class _Im2colTrain(torch.autograd.Function):
    """``im2col`` in x's dtype, whose backward adds a pixel's kh*kw tap
    gradients in f32, tap by tap in (kh, kw) order from zero, and rounds
    once to x's dtype."""

    @staticmethod
    def forward(ctx, x, kh, kw, stride, padding):
        ctx.geom = (x.shape, x.dtype, kh, kw, stride, padding)
        return im2col(x, kh, kw, stride, padding)

    @staticmethod
    def backward(ctx, g):
        (b, h, w, c), dtype, kh, kw, stride, padding = ctx.geom
        ph = mpmm_ref.same_pads(h, kh, stride, padding)
        pw = mpmm_ref.same_pads(w, kw, stride, padding)
        ho, wo = g.shape[1], g.shape[2]
        acc = torch.zeros((b, h + sum(ph), w + sum(pw), c),
                          dtype=torch.promote_types(dtype, torch.float32),
                          device=g.device)
        taps = g.reshape(b, ho, wo, kh * kw, c)
        for i in range(kh):
            for j in range(kw):
                acc[:, i:i + (ho - 1) * stride + 1:stride,
                    j:j + (wo - 1) * stride + 1:stride, :] += taps[
                        :, :, :, i * kw + j, :]
        dx = acc[:, ph[0]:ph[0] + h, pw[0]:pw[0] + w, :].to(dtype)
        return dx, None, None, None, None


def im2col_train(x: torch.Tensor, kh: int, kw: int, stride: int,
                 padding: str) -> torch.Tensor:
    """The QAT forward's im2col: the same gather as ``im2col``, whose
    backward adds a pixel's kh*kw tap gradients in f32 and rounds once, as
    XLA's transpose of the reference's ``conv_general_dilated_patches``
    does; the plain gather's backward would add them one by one in x's
    dtype."""
    return _Im2colTrain.apply(x, kh, kw, stride, padding)


@functools.lru_cache(maxsize=4096)
def conv_serve_dataflow(x_shape, policy, *, k: int, stride: int,
                        padding: str, layer_class: str, n_out: int) -> str:
    """A conv's dataflow under 'auto': the H100 cost model's choice
    (``core.dse.choose_conv_dataflow``), which charges im2col its patch
    matrix written and read back and the implicit conv only the raw
    feature map, and scores each at the tile its kernel runs; a layer K2
    cannot run (C not a multiple of 8//k) has no implicit candidate.
    Both dataflows are bit-exact to each other.  Cached by shape and
    policy: every forward asks again for every conv."""
    b, h, w, cin = x_shape
    conv = dse.ConvShape(batch=b, h=h, w=w, c_in=cin, c_out=n_out, kh=k,
                         kw=k, stride=stride, padding=padding)
    return dse.choose_conv_dataflow(
        conv, w_bits=policy.bits_for(layer_class), k=policy.k,
        variant=policy.variant).dataflow


def qconv_serve_apply(p, x: torch.Tensor, policy: PolicyOrPlan, *, k: int,
                      stride: int = 1, padding: str = "SAME",
                      layer_class: str = "inner",
                      tile: Optional[mpmm_ops.TileShape] = None,
                      impl: str = "auto", compute_dtype=torch.bfloat16,
                      epilogue: Optional[EpilogueSpec] = None,
                      scale: Optional[torch.Tensor] = None,
                      shift: Optional[torch.Tensor] = None,
                      residual: Optional[torch.Tensor] = None,
                      act_signed: bool = False, dataflow: str = "auto",
                      name: str = "") -> torch.Tensor:
    """Deployed conv forward with a per-layer dataflow.

    'im2col' materializes the patch matrix and runs the matmul (K1);
    'implicit' runs the implicit-GEMM conv (K2); 'auto' asks the H100 cost
    model (``conv_serve_dataflow``).  An explicit argument beats the
    plan's per-layer entry, which beats 'auto'; a layer K2 cannot run goes
    to im2col whatever was asked, and so does the fp baseline.
    """
    dataflow = plan_lib.resolve_dataflow(policy, name, dataflow)
    policy = plan_lib.resolve_policy(policy, name)
    if dataflow not in ("auto", "im2col", "implicit"):
        raise ValueError(f"unknown dataflow {dataflow!r}")
    if "w" in p or not policy.quantize:
        dataflow = "im2col"  # the fp baseline: the bf16 matrix product
    elif dataflow == "auto":
        dataflow = conv_serve_dataflow(
            tuple(x.shape), policy, k=k, stride=stride, padding=padding,
            layer_class=layer_class, n_out=p["planes"].shape[-1])
    elif dataflow == "implicit" and not mpmm_ops.conv_implicit_feasible(
            x.shape[-1], PlaneFormat(w_bits=policy.bits_for(layer_class),
                                     k=policy.k, k_dim=k * k * x.shape[-1])):
        dataflow = "im2col"
    if dataflow == "im2col":
        cols = im2col(x, k, k, stride, padding)
        return qlinear_serve_apply(
            p, cols, policy, layer_class=layer_class, tile=tile, impl=impl,
            compute_dtype=compute_dtype, epilogue=epilogue, scale=scale,
            shift=shift, residual=residual, act_signed=act_signed)
    mpmm_epilogue.validate_operands(epilogue, scale, shift, residual)
    epilogue, scale, shift = _fold_bias(p, epilogue, scale, shift)
    cin = x.shape[-1]
    fmt = PlaneFormat(w_bits=policy.bits_for(layer_class), k=policy.k,
                      k_dim=k * k * cin)
    a = mpmm_ops.quantize_activations(x, p["ga"], policy.a_bits,
                                      signed=act_signed)
    y = mpmm_ops.conv_mpmm(
        a, p["planes"], p["gamma"], p["colsum"], scale, shift, residual,
        fmt=fmt, act_zero=0 if act_signed else 2 ** (policy.a_bits - 1),
        kh=k, kw=k, stride=stride, padding=padding,
        bn=tile.bn if tile is not None else None, variant=policy.variant,
        impl=impl, out_dtype=compute_dtype, epilogue=epilogue)
    if "b" in p and epilogue is None:
        y = y + p["b"].to(compute_dtype)
    return y


# Weight values packed at a time: a wider weight is packed in column slices
# (each output column packs on its own), so the quantize and bit-plane
# temporaries of a 256000-word head stay a fraction of the weight.
PACK_SLICE_VALUES = 1 << 28


def pack_qlinear(p: Dict[str, torch.Tensor], policy: PolicyOrPlan,
                 layer_class: str = "inner",
                 name: str = "") -> Dict[str, torch.Tensor]:
    """Trained QAT params -> deployed packed params, at the layer's own
    resolved format under a ``PrecisionPlan``.  Leading axes (an expert
    bank's E) are kept: each expert packs with its own step sizes -- a
    per-tensor ``gw`` of shape ``lead``, a channel-wise one of shape
    ``lead + (N,)`` -- into planes ``lead + (P, Kp, N)``, colsum and gamma
    ``lead + (1, N)``, as ``repro.nn.quantized.pack_qlinear`` does."""
    policy = plan_lib.resolve_policy(policy, name)
    if not policy.quantize:  # the fp baseline: bf16 weights
        out = {"w": p["w"].to(torch.bfloat16)}
        if "b" in p:
            out["b"] = p["b"]
        return out
    w, gw, ga = p["w"], p["gw"], p["ga"]
    w_bits = policy.bits_for(layer_class)
    kdim, n = w.shape[-2:]
    channel_wise = policy.channel_wise and gw.ndim == w.ndim - 1
    gww = gw.to(torch.float32)
    lead = w.shape[:-2]
    g_b = gww.reshape(lead + ((1, n) if channel_wise else (1, 1)))
    fmt = PlaneFormat(w_bits=w_bits, k=policy.k, k_dim=kdim)
    spec = quant.weight_spec(w_bits)
    step = max(1, PACK_SLICE_VALUES // max(1, w.numel() // n))
    planes, colsum = [], []
    for c0 in range(0, max(n, 1), step):
        sl = slice(c0, min(c0 + step, n))
        w_int = quant.quantize_int(w[..., sl].to(torch.float32),
                                   g_b[..., sl] if channel_wise else g_b,
                                   spec)
        planes.append(packing.pack_planes(w_int, fmt, axis=-2)
                      .movedim(0, -3))                 # lead + (P, Kp, n')
        colsum.append(torch.sum(w_int, dim=-2, dtype=torch.int32)[
            ..., None, :])
        del w_int
    cat = lambda ts: ts[0] if len(ts) == 1 else torch.cat(ts, -1)  # noqa: E731
    gamma_w = torch.broadcast_to(g_b, lead + (1, n))
    out = {
        "planes": cat(planes).contiguous(),
        "colsum": cat(colsum),
        "gamma": gamma_w * ga.to(torch.float32).reshape(lead + (1, 1)),
        "ga": ga.to(torch.float32),
    }
    if "b" in p:
        out["b"] = p["b"]
    return out


def pack_tree(params, specs, policy: PolicyOrPlan):
    """Recursively pack every qlinear subtree of a trained param tree; the
    spec markers carry each layer's class and workload name."""
    if is_qlinear(specs):
        sub = {k: v for k, v in params.items() if k != QMARK}
        return pack_qlinear(sub, policy, _layer_class_of(specs),
                            name=_layer_name_of(specs))
    if isinstance(specs, dict):
        return {k: pack_tree(params[k], specs[k], policy)
                for k in specs if k != QMARK}
    if isinstance(specs, list):  # per-layer stacks
        return [pack_tree(p, sp, policy) for p, sp in zip(params, specs)]
    return params
