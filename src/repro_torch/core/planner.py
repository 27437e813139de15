"""Sensitivity-guided search over layer-wise precision plans (paper Fig.
9), port of ``repro.core.planner`` with the H100 as the default device.

  * **Sensitivity** -- how much accuracy a layer loses at each w_Q, as
    {layer: {w_bits: error}}: :func:`weight_ptq_sensitivity` (per-layer
    PTQ weight MSE, LSQ step init, scaled by MACs; no forward pass) or
    :func:`calibration_sensitivity` (one layer at a time dropped to each
    w_Q, the others at 8 bit, the logit-MSE increase over uniform w8 on a
    calibration batch, against the fp baseline's logits).
  * **Latency** -- each layer's roofline time (``core.dse.gemm_time``) at
    the tile its kernel runs (``autotune_tile``), summed over the workload.
  * **Search** -- greedy bit-descent from uniform w8, the best latency
    gain per unit of sensitivity cost first, a plan point a step; the
    trajectory plus the uniform plans reduced to the Pareto front.

Everything is numpy over the hashable ``PrecisionPlan``: the emitted plans
serialize to JSON and feed ``pack_for_serve`` / ``serve_forward``.  The
weight sensitivities take ``init_step_size``'s mean in float64, so they
agree with the JAX package's (an f32 mean) to a relative tolerance, not
bitwise.
"""
from __future__ import annotations

import dataclasses
import math
from typing import Callable, Dict, List, Mapping, Optional, Sequence, Tuple

import numpy as np

import torch

from repro_torch.core import quant
from repro_torch.core.dse import Gemm, autotune_tile, gemm_time
from repro_torch.core.packing import PlaneFormat
from repro_torch.core.plan import (KVCachePlan, LayerPlan, PrecisionPlan,
                                   kv_cache_token_bytes,
                                   plan_footprint_report)
from repro_torch.core.precision import PrecisionPolicy
from repro_torch.core.roofline import H100, HW

__all__ = [
    "PlanPoint",
    "PlanSearchResult",
    "default_k",
    "weight_ptq_sensitivity",
    "calibration_sensitivity",
    "kv_cache_sensitivity",
    "layer_latency_table",
    "kv_decode_latency_table",
    "plan_latency",
    "greedy_bit_descent",
    "greedy_joint_descent",
    "pareto_front",
    "plan_search",
]

BIT_OPTIONS = (8, 4, 2, 1)
# KV-cache word-length ladder; 16 means "keep the fp16 cache" (no kv entry).
KV_BIT_OPTIONS = (16, 8, 4, 2)


def default_k(w_bits: int) -> int:
    """The repo-wide slice convention: k = min(w_Q, 4) (paper k in 1/2/4)."""
    return min(w_bits, 4)


# --- sensitivity backends --------------------------------------------------


def weight_ptq_sensitivity(
    weights: Mapping[str, np.ndarray],
    *,
    macs: Optional[Mapping[str, int]] = None,
    bit_options: Sequence[int] = BIT_OPTIONS,
) -> Dict[str, Dict[int, float]]:
    """Analytic proxy: per-layer PTQ weight-quantization MSE x MACs.

    ``weights`` maps workload layer name -> FP weight matrix.  Each layer
    is PTQ-quantized at every candidate w_Q with the LSQ step-size
    initialization (the same grid the packed deployment uses) and the
    mean squared error is scaled by the layer's MAC count (``macs``,
    default: weight size) — a layer whose error feeds many output pixels
    costs proportionally more, the standard additive-independence proxy
    of mixed-precision search (HAWQ-style).
    """
    out: Dict[str, Dict[int, float]] = {}
    for name, w in weights.items():
        if isinstance(w, torch.Tensor):
            w = w.detach().cpu().numpy()
        wf = np.asarray(w, np.float64)
        w32 = torch.from_numpy(np.asarray(wf, np.float32))
        scale = float(macs[name]) if macs is not None else float(wf.size)
        per_bits: Dict[int, float] = {}
        for b in bit_options:
            spec = quant.weight_spec(b)
            gamma = float(quant.init_step_size(w32, spec))
            qn, qp = quant.qrange(spec)
            codes = np.clip(np.round(wf / gamma), qn, qp)
            err = float(np.mean((wf - codes * gamma) ** 2))
            per_bits[b] = err * scale
        out[name] = per_bits
    return out


def calibration_sensitivity(
    forward_fn: Callable[[PrecisionPlan], np.ndarray],
    layer_names: Sequence[str],
    *,
    bit_options: Sequence[int] = BIT_OPTIONS,
    k_for_bits: Callable[[int], int] = default_k,
    base_plan: Optional[PrecisionPlan] = None,
) -> Dict[str, Dict[int, float]]:
    """Measured PTQ sensitivity on a calibration batch.

    ``forward_fn(plan)`` must run the model on the (closed-over)
    calibration batch under ``plan`` and return logits.  For each layer
    and each candidate w_Q the layer is dropped to that word-length
    while every other layer stays at the 8-bit base; the sensitivity is
    the increase in logit MSE (vs the FP reference logits) over the
    uniform-w8 plan — so sens[l][8] == 0 by construction and lower bits
    only ever cost more.
    """
    base = base_plan or PrecisionPlan.uniform(
        PrecisionPolicy(inner_bits=8, k=default_k(8)))
    ref = np.asarray(
        forward_fn(dataclasses.replace(base, quantize=False)), np.float64)

    def mse(plan: PrecisionPlan) -> float:
        y = np.asarray(forward_fn(plan), np.float64)
        return float(np.mean((y - ref) ** 2))

    base_mse = mse(base)
    out: Dict[str, Dict[int, float]] = {}
    for name in layer_names:
        per_bits: Dict[int, float] = {}
        for b in bit_options:
            if b == 8:
                per_bits[b] = 0.0
                continue
            entry = LayerPlan(w_bits=b, k=k_for_bits(b),
                              channel_wise=base.default.channel_wise)
            # Replace (not append) any base entry for this layer — a
            # base_plan that already names it must stay probe-able.
            others = tuple(e for e in base.layers if e[0] != name)
            probe = dataclasses.replace(
                base, layers=others + ((name, entry),))
            per_bits[b] = max(mse(probe) - base_mse, 0.0)
        out[name] = per_bits
    return out


def _round_bf16(x: np.ndarray) -> np.ndarray:
    """Round f32 values to the nearest bf16 (ties to even), as f64.

    The stored-grid rounding of nn/kvcache.py, in numpy.
    """
    a = np.ascontiguousarray(np.asarray(x, np.float32)).view(np.uint32)
    r = (a + np.uint32(0x7FFF) + ((a >> np.uint32(16)) & np.uint32(1))) \
        & np.uint32(0xFFFF0000)
    return r.view(np.float32).astype(np.float64)


def kv_cache_sensitivity(
    kv_values: Mapping[str, np.ndarray],
    *,
    bit_options: Sequence[int] = KV_BIT_OPTIONS,
    weights: Optional[Mapping[str, float]] = None,
) -> Dict[str, Dict[int, float]]:
    """{cached tensor: {kv_bits: error}} — per-(token, head) affine PTQ MSE.

    ``kv_values`` maps cached-tensor name -> sample rows ``(..., head_dim)``
    of what the serve path would cache (post-rope K, the V projections).
    Each candidate word-length replays EXACTLY the nn/kvcache.py grid —
    bf16-rounded scale/zero, unsigned codes — so the proxy measures the
    same values the packed cache dequantizes to.  16 bits means keep fp
    (zero error); ``weights`` optionally scales each tensor's MSE (e.g.
    by its attention read volume), defaulting to the sample size.
    """
    out: Dict[str, Dict[int, float]] = {}
    for name, x in kv_values.items():
        flat = np.asarray(x, np.float64).reshape(-1, np.shape(x)[-1])
        scale_w = float(weights[name]) if weights is not None \
            else float(flat.size)
        row: Dict[int, float] = {}
        for b in bit_options:
            if b >= 16:
                row[b] = 0.0
                continue
            levels = (1 << b) - 1
            mx, mn = flat.max(axis=-1), flat.min(axis=-1)
            s = _round_bf16((mx - mn) / levels)
            z = _round_bf16(mn)
            sf = np.maximum(s, 1e-20)
            codes = np.clip(
                np.round((flat - z[:, None]) / sf[:, None]), 0, levels)
            deq = codes * s[:, None] + z[:, None]
            row[b] = float(np.mean((flat - deq) ** 2)) * scale_w
        out[name] = row
    return out


def _kv_proxy_sensitivity(
    kv_workload: Mapping[str, Tuple[int, int]],
    bit_options: Sequence[int],
) -> Dict[str, Dict[int, float]]:
    """Calibration-free fallback: uniform-quantizer noise power 4^-b
    scaled by the tensor's read width (heads * head_dim)."""
    return {
        name: {b: 0.0 if b >= 16 else float(heads * hd) * 4.0 ** (-b)
               for b in bit_options}
        for name, (heads, hd) in kv_workload.items()
    }


# --- latency model ---------------------------------------------------------


def layer_latency_table(
    gemms: Sequence[Gemm],
    *,
    bit_options: Sequence[int] = BIT_OPTIONS,
    k_for_bits: Callable[[int], int] = default_k,
    hw: HW = H100,
    variant: str = "st",
) -> Dict[str, Dict[int, float]]:
    """{layer: {w_bits: roofline_s}} with per-(layer, w_Q) autotuned tiles.

    Boundary layers are pinned to 8 bit (the paper's first/last rule), so
    their row is constant across ``bit_options`` — the greedy search then
    never sees a gain from touching them.
    """
    out: Dict[str, Dict[int, float]] = {}
    for g in gemms:
        row: Dict[int, float] = {}
        for b in bit_options:
            eff_b = 8 if g.layer_class == "boundary" else b
            kk = k_for_bits(eff_b)
            fmt = PlaneFormat(w_bits=eff_b, k=kk, k_dim=g.k)
            tile = autotune_tile(g.m, g.k, g.n, w_bits=eff_b, k=kk,
                                 variant=variant, hw=hw)
            c, m = gemm_time(g, tile, fmt, hw, variant)
            row[b] = max(c, m)
        out[g.name] = row
    return out


def kv_decode_latency_table(
    kv_workload: Mapping[str, Tuple[int, int]],
    *,
    tokens: int,
    batch: int = 1,
    bit_options: Sequence[int] = KV_BIT_OPTIONS,
    slice_k: int = 4,
    hw: HW = H100,
) -> Dict[str, Dict[int, float]]:
    """{cached tensor: {kv_bits: decode_s}} — the decode-bandwidth term.

    A decode step streams every resident cache row once, so its roofline
    time is pure HBM bandwidth over the *stored* bytes: packed digit
    planes + scale/zero at ``kv_bits``, bf16 rows at 16.  ``tokens`` is
    the context length the plan is being tuned for (the paper's
    per-operating-point workload), ``batch`` the concurrent decodes.
    """
    out: Dict[str, Dict[int, float]] = {}
    for name, (heads, head_dim) in kv_workload.items():
        row: Dict[int, float] = {}
        for b in bit_options:
            bits = None if b >= 16 else b
            per_tok = kv_cache_token_bytes(bits, heads, head_dim,
                                           slice_k=slice_k)
            row[b] = batch * tokens * per_tok / hw.hbm_bw
        out[name] = row
    return out


def plan_latency(
    latency: Mapping[str, Mapping[int, float]],
    bits: Mapping[str, int],
) -> float:
    """Roofline sum over ALL workload layers in the table: inner layers
    at the plan's bit assignment, layers absent from ``bits`` (the
    boundary stem/fc rows, constant across bit options) at their pinned
    time — so PlanPoint latencies are whole-model, not inner-only."""
    total = 0.0
    for name, row in latency.items():
        b = bits.get(name)
        total += row[b] if b is not None else next(iter(row.values()))
    return total


# --- search ----------------------------------------------------------------


@dataclasses.dataclass(frozen=True)
class PlanPoint:
    """One evaluated plan: the Fig. 9 scatter point."""

    name: str
    plan: PrecisionPlan
    bits: Tuple[Tuple[str, int], ...]     # inner layers only, sorted
    error: float                          # accuracy-proxy cost, lower better
    latency_s: float
    footprint_bytes: float = 0.0

    @property
    def fps(self) -> float:
        return 1.0 / self.latency_s if self.latency_s > 0 else math.inf

    @property
    def accuracy_proxy(self) -> float:
        """Higher = better (Fig. 9 y-axis): the negated error cost."""
        return -self.error

    def row(self) -> Dict[str, object]:
        return {
            "name": self.name,
            "error": self.error,
            "accuracy_proxy": self.accuracy_proxy,
            "latency_s": self.latency_s,
            "fps": self.fps,
            "footprint_bytes": self.footprint_bytes,
            "distinct_wbits": list(self.plan.distinct_wbits()),
            "distinct_kv_bits": list(self.plan.distinct_kvbits()),
        }


@dataclasses.dataclass
class PlanSearchResult:
    points: List[PlanPoint]               # every evaluated plan
    frontier: List[PlanPoint]             # Pareto-optimal subset
    chosen: PlanPoint                     # best under the budget

    def frontier_rows(self) -> List[Dict[str, object]]:
        return [p.row() for p in self.frontier]


def pareto_front(points: Sequence[PlanPoint]) -> List[PlanPoint]:
    """Non-dominated subset on (error, latency), both minimized.

    A point is dominated when another is <= on both axes and strictly
    better on at least one; the survivors are returned sorted by latency
    (the Fig. 9 frontier, fastest first).
    """
    survivors = []
    for p in points:
        dominated = any(
            (q.error <= p.error and q.latency_s <= p.latency_s)
            and (q.error < p.error or q.latency_s < p.latency_s)
            for q in points)
        if not dominated:
            survivors.append(p)
    # Collapse exact duplicates on both axes (keep the first).
    seen = set()
    out = []
    for p in sorted(survivors, key=lambda p: (p.latency_s, p.error)):
        key = (p.error, p.latency_s)
        if key not in seen:
            seen.add(key)
            out.append(p)
    return out


def _mk_plan(
    bits: Mapping[str, int],
    *,
    k_for_bits: Callable[[int], int],
    variant: str,
    channel_wise: bool,
    name: str,
    kv_bits: Optional[Mapping[str, Optional[int]]] = None,
    kv_slice: int = 4,
) -> PrecisionPlan:
    layers = {
        n: LayerPlan(w_bits=b, k=k_for_bits(b), channel_wise=channel_wise)
        for n, b in bits.items()
    }
    enabled = False
    if kv_bits:
        for n, b in kv_bits.items():
            if b is None:
                continue
            enabled = True
            if n in layers:  # cached-tensor name coincides with a weight
                layers[n] = dataclasses.replace(layers[n], kv_bits=b)
            else:
                layers[n] = LayerPlan(w_bits=8, k=k_for_bits(8),
                                      channel_wise=channel_wise, kv_bits=b)
    plan = PrecisionPlan.build(
        layers, default=LayerPlan(w_bits=8, k=k_for_bits(8),
                                  channel_wise=channel_wise),
        variant=variant, name=name)
    if enabled:
        plan = dataclasses.replace(
            plan, kv=KVCachePlan(bits=None, k=min(kv_slice, 4)))
    return plan


def greedy_bit_descent(
    inner_layers: Sequence[str],
    sensitivity: Mapping[str, Mapping[int, float]],
    latency: Mapping[str, Mapping[int, float]],
    *,
    bit_options: Sequence[int] = BIT_OPTIONS,
    k_for_bits: Callable[[int], int] = default_k,
    variant: str = "st",
    channel_wise: bool = False,
    min_bits: int = 1,
) -> List[PlanPoint]:
    """Greedy descent from uniform-w8: one bit-drop per step.

    At each step every inner layer's next-lower word-length is scored by
    ``latency_gain / sensitivity_cost``; the best ratio wins and a plan
    point is recorded.  The trajectory ends when no layer can drop
    further (or no drop gains latency).
    """
    opts = sorted(set(bit_options), reverse=True)
    bits = {n: opts[0] for n in inner_layers}
    eps = 1e-30

    def point(tag: str) -> PlanPoint:
        plan = _mk_plan(bits, k_for_bits=k_for_bits, variant=variant,
                        channel_wise=channel_wise, name=tag)
        err = sum(sensitivity[n][b] for n, b in bits.items())
        return PlanPoint(
            name=tag, plan=plan, bits=tuple(sorted(bits.items())),
            error=err, latency_s=plan_latency(latency, bits))

    trajectory = [point("greedy_step0")]
    step = 0
    while True:
        best: Optional[Tuple[float, str, int]] = None
        for n in inner_layers:
            cur = bits[n]
            idx = opts.index(cur)
            if idx + 1 >= len(opts) or opts[idx + 1] < min_bits:
                continue
            nb = opts[idx + 1]
            gain = latency[n][cur] - latency[n][nb]
            if gain <= 0:
                continue
            cost = max(sensitivity[n][nb] - sensitivity[n][cur], 0.0)
            ratio = gain / (cost + eps)
            if best is None or ratio > best[0]:
                best = (ratio, n, nb)
        if best is None:
            break
        _, n, nb = best
        bits[n] = nb
        step += 1
        trajectory.append(point(f"greedy_step{step}"))
    return trajectory


def greedy_joint_descent(
    inner_layers: Sequence[str],
    sensitivity: Mapping[str, Mapping[int, float]],
    latency: Mapping[str, Mapping[int, float]],
    kv_names: Sequence[str],
    kv_sensitivity: Mapping[str, Mapping[int, float]],
    kv_latency: Mapping[str, Mapping[int, float]],
    *,
    bit_options: Sequence[int] = BIT_OPTIONS,
    kv_bit_options: Sequence[int] = KV_BIT_OPTIONS,
    k_for_bits: Callable[[int], int] = default_k,
    variant: str = "st",
    channel_wise: bool = False,
    min_bits: int = 1,
    kv_slice: int = 4,
) -> List[PlanPoint]:
    """Greedy descent over weight AND KV-cache word-lengths jointly.

    Same ratio rule as :func:`greedy_bit_descent`, but each step's
    candidate moves include dropping one cached tensor down the KV
    ladder (16 -> 8 -> 4 -> 2): the weight moves gain compute/weight-
    roofline time, the KV moves gain decode-bandwidth time, and both
    compete on latency-gain per unit sensitivity-cost — so the search
    spends its error budget wherever a byte buys the most decode time.
    """
    opts = sorted(set(bit_options), reverse=True)
    kv_opts = sorted(set(kv_bit_options), reverse=True)
    bits = {n: opts[0] for n in inner_layers}
    kv_bits = {n: kv_opts[0] for n in kv_names}
    eps = 1e-30

    def point(tag: str) -> PlanPoint:
        assign = {n: (None if b >= 16 else b) for n, b in kv_bits.items()}
        plan = _mk_plan(bits, k_for_bits=k_for_bits, variant=variant,
                        channel_wise=channel_wise, name=tag,
                        kv_bits=assign, kv_slice=kv_slice)
        err = sum(sensitivity[n][b] for n, b in bits.items()) \
            + sum(kv_sensitivity[n][b] for n, b in kv_bits.items())
        lat = plan_latency(latency, bits) \
            + sum(kv_latency[n][b] for n, b in kv_bits.items())
        return PlanPoint(name=tag, plan=plan,
                         bits=tuple(sorted(bits.items())),
                         error=err, latency_s=lat)

    trajectory = [point("joint_step0")]
    step = 0
    while True:
        best: Optional[Tuple[float, str, str, int]] = None
        for n in inner_layers:
            idx = opts.index(bits[n])
            if idx + 1 >= len(opts) or opts[idx + 1] < min_bits:
                continue
            nb = opts[idx + 1]
            gain = latency[n][bits[n]] - latency[n][nb]
            if gain <= 0:
                continue
            cost = max(sensitivity[n][nb] - sensitivity[n][bits[n]], 0.0)
            ratio = gain / (cost + eps)
            if best is None or ratio > best[0]:
                best = (ratio, "w", n, nb)
        for n in kv_names:
            idx = kv_opts.index(kv_bits[n])
            if idx + 1 >= len(kv_opts):
                continue
            nb = kv_opts[idx + 1]
            gain = kv_latency[n][kv_bits[n]] - kv_latency[n][nb]
            if gain <= 0:
                continue
            cost = max(kv_sensitivity[n][nb] - kv_sensitivity[n][kv_bits[n]],
                       0.0)
            ratio = gain / (cost + eps)
            if best is None or ratio > best[0]:
                best = (ratio, "kv", n, nb)
        if best is None:
            break
        _, kind, n, nb = best
        (bits if kind == "w" else kv_bits)[n] = nb
        step += 1
        trajectory.append(point(f"joint_step{step}"))
    return trajectory


def plan_search(
    gemms: Sequence[Gemm],
    sensitivity: Mapping[str, Mapping[int, float]],
    *,
    bit_options: Sequence[int] = BIT_OPTIONS,
    k_for_bits: Callable[[int], int] = default_k,
    hw: HW = H100,
    variant: str = "st",
    channel_wise: bool = False,
    layer_params: Optional[Mapping[str, int]] = None,
    budget_bytes: Optional[float] = None,
    budget_error: Optional[float] = None,
    kv_workload: Optional[Mapping[str, Tuple[int, int]]] = None,
    kv_sensitivity: Optional[Mapping[str, Mapping[int, float]]] = None,
    kv_tokens: int = 4096,
    kv_batch: int = 1,
    kv_bit_options: Sequence[int] = KV_BIT_OPTIONS,
    kv_slice: int = 4,
) -> PlanSearchResult:
    """The full sensitivity-guided DSE: greedy trajectory + uniform plans
    -> Pareto front -> budgeted choice.

    ``budget_bytes`` (packed-footprint ceiling) and ``budget_error``
    (sensitivity ceiling) gate the chosen point: the LOWEST-ERROR
    frontier point satisfying every given budget (accuracy is
    sacrificed only as far as the budget forces — the paper's Table III
    operating points), breaking error ties toward the faster plan and
    falling back to the smallest-footprint frontier point when none
    qualifies.

    Passing ``kv_workload`` (``api.kv_cache_workload()``) turns on joint
    weight + KV-cache descent: every plan point gains a decode-bandwidth
    roofline term (:func:`kv_decode_latency_table` at ``kv_tokens`` x
    ``kv_batch``), the greedy search may spend steps dropping a cached
    tensor down the KV ladder instead of a weight layer, and emitted
    plans carry the version-2 ``kv_bits`` assignment.  ``kv_sensitivity``
    (from :func:`kv_cache_sensitivity` on calibration activations)
    defaults to an analytic 4^-b noise proxy.
    """
    inner = [g.name for g in gemms if g.layer_class != "boundary"]
    missing = [n for n in inner if n not in sensitivity]
    if missing:
        raise ValueError(f"sensitivity missing inner layers: {missing}")
    if budget_bytes is not None and layer_params is None:
        raise ValueError(
            "budget_bytes requires layer_params (footprints are only "
            "computed from per-layer weight counts)")
    latency = layer_latency_table(
        gemms, bit_options=bit_options, k_for_bits=k_for_bits, hw=hw,
        variant=variant)

    kv_names: List[str] = []
    kv_latency: Dict[str, Dict[int, float]] = {}
    if kv_workload:
        kv_names = sorted(kv_workload)
        kv_latency = kv_decode_latency_table(
            kv_workload, tokens=kv_tokens, batch=kv_batch,
            bit_options=kv_bit_options, slice_k=kv_slice, hw=hw)
        if kv_sensitivity is None:
            kv_sensitivity = _kv_proxy_sensitivity(kv_workload,
                                                   kv_bit_options)
        missing_kv = [n for n in kv_names if n not in kv_sensitivity]
        if missing_kv:
            raise ValueError(
                f"kv_sensitivity missing cached tensors: {missing_kv}")
        points = greedy_joint_descent(
            inner, sensitivity, latency, kv_names, kv_sensitivity,
            kv_latency, bit_options=bit_options,
            kv_bit_options=kv_bit_options, k_for_bits=k_for_bits,
            variant=variant, channel_wise=channel_wise, kv_slice=kv_slice)
    else:
        points = greedy_bit_descent(
            inner, sensitivity, latency, bit_options=bit_options,
            k_for_bits=k_for_bits, variant=variant,
            channel_wise=channel_wise)
    # Uniform plans: the paper's Table III/IV rows, always in the scatter.
    # Under joint search they keep the fp16 cache, so the scatter shows
    # what weight-only quantization leaves on the decode-bandwidth table.
    kv_fp = sum(kv_latency[n][max(kv_bit_options)] for n in kv_names)
    for b in sorted(set(bit_options), reverse=True):
        bits = {n: b for n in inner}
        plan = _mk_plan(bits, k_for_bits=k_for_bits, variant=variant,
                        channel_wise=channel_wise, name=f"uniform_w{b}")
        points.append(PlanPoint(
            name=f"uniform_w{b}", plan=plan, bits=tuple(sorted(bits.items())),
            error=sum(sensitivity[n][b] for n in inner),
            latency_s=plan_latency(latency, bits) + kv_fp))

    if layer_params is not None:
        classes = {g.name: g.layer_class for g in gemms}

        def fp_bytes(p: PlanPoint) -> float:
            # Under joint search EVERY point counts its resident cache
            # (fp16 for non-kv plans) so footprints compare like-with-like.
            rep = plan_footprint_report(
                layer_params, classes, p.plan,
                kv_layers=kv_workload or None,
                kv_tokens=kv_tokens * kv_batch)
            return rep.get("total_quant_bytes", rep["quant_bytes"])

        points = [dataclasses.replace(p, footprint_bytes=fp_bytes(p))
                  for p in points]

    frontier = pareto_front(points)
    feasible = [
        p for p in frontier
        if (budget_bytes is None or p.footprint_bytes <= budget_bytes)
        and (budget_error is None or p.error <= budget_error)
    ]
    if feasible:
        chosen = min(feasible, key=lambda p: (p.error, p.latency_s))
    else:
        chosen = min(frontier, key=lambda p: p.footprint_bytes)
    return PlanSearchResult(points=points, frontier=frontier, chosen=chosen)
