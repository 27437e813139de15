"""Quantized layers, serve half (port of ``repro.nn.quantized``).

Weights live as packed k-bit digit planes (uint8), activations are
quantized on the fly to biased int8 codes, and the product runs through
``kernels.mpmm.ops`` -- the hand-written kernels on CUDA tensors.  BN,
the shortcut add and ReLU run in the kernel epilogue.

A quantized-linear param subtree is marked by the key ``QMARK``; in spec
trees the marker carries the layer class and its workload layer name, so a
layer-wise ``PrecisionPlan`` resolves each layer's format at pack and
serve time.  Under ``quantize=False`` (the fp baseline the paper compares
against) ``pack_qlinear`` keeps the weight in bf16 under ``"w"`` and the
serve forward is a plain bf16 matrix product followed by the same f32
epilogue; convs then always go through im2col.  The QAT (training)
forward is not ported yet.
"""
from __future__ import annotations

import dataclasses
import functools
from typing import Dict, Optional

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
from repro_torch.nn.param import QMARK, ParamSpec

__all__ = [
    "qlinear_spec",
    "qlinear_serve_spec",
    "qconv_spec",
    "qlinear_serve_apply",
    "qconv_serve_apply",
    "conv_serve_dataflow",
    "im2col",
    "pack_qlinear",
    "pack_tree",
    "is_qlinear",
    "QMARK",
    "EpilogueSpec",
]


def _marker(layer_class: str, name: str = "") -> ParamSpec:
    # Zero-size marker: the layer class and the workload layer name ride in
    # its axes slots.
    return ParamSpec(shape=(0, 0), axes=(layer_class, name or None),
                     init="zeros")


def qlinear_spec(in_dim: int, out_dim: int, *, layer_class: str = "inner",
                 channel_wise: bool = False,
                 name: str = "") -> Dict[str, ParamSpec]:
    """Spec of one QAT linear: master weight + LSQ step sizes."""
    return {
        QMARK: _marker(layer_class, name),
        "w": ParamSpec(shape=(in_dim, out_dim), init="normal",
                       fan_in_axes=(-2,)),
        "gw": ParamSpec(shape=(out_dim,) if channel_wise else (),
                        init="constant", const=0.05),
        "ga": ParamSpec(shape=(), init="constant", const=0.05),
    }


def qlinear_serve_spec(in_dim: int, out_dim: int, *,
                       layer_class: str = "inner",
                       policy: PolicyOrPlan = PrecisionPolicy(),
                       name: str = "") -> Dict[str, ParamSpec]:
    """Spec of the deployed (packed) form at the layer's own resolved
    format: what ``pack_qlinear`` returns for a (in_dim, out_dim) weight."""
    pol = plan_lib.resolve_policy(policy, name)
    fmt = PlaneFormat(w_bits=pol.bits_for(layer_class), k=pol.k,
                      k_dim=in_dim)
    return {
        QMARK: _marker(layer_class, name),
        "planes": ParamSpec(shape=(fmt.planes, fmt.packed_k, out_dim),
                            dtype=torch.uint8, init="zeros"),
        "colsum": ParamSpec(shape=(1, out_dim), dtype=torch.int32,
                            init="zeros"),
        "gamma": ParamSpec(shape=(1, out_dim), init="constant", const=1e-3),
        "ga": ParamSpec(shape=(), init="constant", const=0.05),
    }


def qconv_spec(cin: int, cout: int, k: int, *, layer_class: str = "inner",
               channel_wise: bool = False, name: str = "") -> Dict[str, ParamSpec]:
    """A k x k conv is a (k*k*cin, cout) linear over (kh, kw, C) patches."""
    return qlinear_spec(k * k * cin, cout, layer_class=layer_class,
                        channel_wise=channel_wise, name=name)


def is_qlinear(sub) -> bool:
    return isinstance(sub, dict) and QMARK in sub


def _layer_class_of(sub: Dict) -> str:
    return sub[QMARK].axes[0] or "inner"


def _layer_name_of(sub: Dict) -> str:
    return sub[QMARK].axes[1] or ""


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


def _fp_serve_apply(p, x, *, compute_dtype, epilogue, scale, shift,
                    residual) -> torch.Tensor:
    """The fp baseline: a bf16 matrix product, the bias, then the f32
    epilogue (the reference's order: the bias is not folded)."""
    y = torch.matmul(x.to(compute_dtype), p["w"].to(compute_dtype))
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
                        act_signed: bool = False,
                        name: str = "") -> torch.Tensor:
    """Deployed forward: quantize activations -> mpmm over packed planes.

    ``act_signed=True`` uses symmetric signed codes (act_zero = 0), for
    inputs that straddle zero such as a CNN stem's pixels.  ``policy`` may
    be a ``PrecisionPlan``; ``name`` picks this layer's entry.
    """
    policy = plan_lib.resolve_policy(policy, name)
    mpmm_epilogue.validate_operands(epilogue, scale, shift, residual)
    if "w" in p:  # the fp baseline
        return _fp_serve_apply(p, x, compute_dtype=compute_dtype,
                               epilogue=epilogue, scale=scale, shift=shift,
                               residual=residual)
    epilogue, scale, shift = _fold_bias(p, epilogue, scale, shift)
    fmt = PlaneFormat(w_bits=policy.bits_for(layer_class), k=policy.k,
                      k_dim=x.shape[-1])
    a = mpmm_ops.quantize_activations(x, p["ga"], policy.a_bits,
                                      signed=act_signed)
    y = mpmm_ops.mpmm(
        a, p["planes"], p["gamma"], p["colsum"], scale, shift, residual,
        fmt=fmt, act_zero=0 if act_signed else 2 ** (policy.a_bits - 1),
        tile=tile, variant=policy.variant, impl=impl,
        out_dtype=compute_dtype, epilogue=epilogue)
    if "b" in p and epilogue is None:
        y = y + p["b"].to(compute_dtype)
    return y


def im2col(x: torch.Tensor, kh: int, kw: int, stride: int,
           padding: str) -> torch.Tensor:
    """x (B, H, W, C) -> patches (B, Ho, Wo, kh*kw*C) in (kh, kw, C) order,
    matching the HWIO weight flattening; zero padding with XLA's SAME pads."""
    xp = mpmm_ref.pad_spatial(x, kh, kw, stride, padding, fill=0)
    return mpmm_ref.gather_patches(xp, kh, kw, stride)


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


def pack_qlinear(p: Dict[str, torch.Tensor], policy: PolicyOrPlan,
                 layer_class: str = "inner",
                 name: str = "") -> Dict[str, torch.Tensor]:
    """Trained QAT params -> deployed packed params, at the layer's own
    resolved format under a ``PrecisionPlan``."""
    policy = plan_lib.resolve_policy(policy, name)
    if not policy.quantize:  # the fp baseline: bf16 weights
        out = {"w": p["w"].to(torch.bfloat16)}
        if "b" in p:
            out["b"] = p["b"]
        return out
    w, gw, ga = p["w"], p["gw"], p["ga"]
    w_bits = policy.bits_for(layer_class)
    kdim, n = w.shape
    channel_wise = policy.channel_wise and gw.ndim == 1
    gww = gw.to(torch.float32)
    g_b = gww.reshape(1, n) if channel_wise else gww.reshape(1, 1)
    w_int = quant.quantize_int(w.to(torch.float32), g_b,
                               quant.weight_spec(w_bits))
    fmt = PlaneFormat(w_bits=w_bits, k=policy.k, k_dim=kdim)
    out = {
        "planes": packing.pack_planes(w_int, fmt, axis=-2),
        "colsum": torch.sum(w_int, dim=0, dtype=torch.int32).reshape(1, n),
        "gamma": torch.broadcast_to(g_b, (1, n))
        * ga.to(torch.float32).reshape(1, 1),
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
