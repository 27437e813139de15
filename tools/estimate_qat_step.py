#!/usr/bin/env python3
"""A shape-based estimate of a QAT train step of ``chip_smoke.py``'s
phases 14 and 15 on an H100, from the configs alone (no card needed):

    python3 tools/estimate_qat_step.py

For granite-8b, olmoe-1b-7b and deepseek-v2-lite-16b at full width, cut
to their first 2 layers, one step of 4 x 1024 tokens in 2 microbatches,
it counts what the step must at least do and divides by the H100's
published peaks (SXM data sheet, 700 W): 989 TFLOP/s bf16, 67 TFLOP/s f32
outside the tensor cores, 3.35 TB/s:

* the bf16 products: every fake-quant projection (an expert bank at E x
  rows x capacity rows) and the head, forward and the two backward
  products, and the forward again where ``remat_policy`` is 'full';
* the f32 work in torch: attention's two products over all S x S pairs
  and the router's product, forward, recomputed forward and backward;
* fake-quant, as bytes: every quantized weight read in f32 and written in
  bf16 in each forward (and each recomputed one), its straight-through
  gradient read and written in f32; every product's input read and
  written in bf16 the same way;
* the MoE routing, as bytes: x read, the expert slots written by the
  dispatch and read by the gating and combine, the output written, and
  as much again for the recomputed forward and the backward;
* AdamW: parameters, gradients and both moments read in f32, parameters
  and moments written.

Each part's time is a lower bound.  The estimate scales the products by
the rate granite-8b's reached on the card (``GRANITE_MEASURED``, phase 14 of
the port's QAT bring-up) and the rest by how far granite's rest ran above
its bound; granite's own row then reproduces its measured step.
"""
from __future__ import annotations

import dataclasses
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT / "src"))

BF16_FLOPS, F32_FLOPS, HBM = 989e12, 67e12, 3.35e12
DEPTH, BATCH, SEQ, MICROBATCHES = 2, 4, 1024, 2
ARCHS = ("granite-8b", "olmoe-1b-7b", "deepseek-v2-lite-16b")
# granite-8b x2's step on an H100 80GB HBM3 at 700 W, chip_smoke.py phase
# 14 ([p14-time]): the step and its bf16 products, ms
GRANITE_MEASURED = {"step": 393.11, "products": 22.03}


def walk(spec, fn, path=""):
    """fn(path, subtree) at every fake-quant linear and every parameter."""
    from repro_torch.nn import quantized as Q
    from repro_torch.nn.param import QMARK, ParamSpec
    if Q.is_qlinear(spec) or isinstance(spec, ParamSpec):
        fn(path, spec)
    elif isinstance(spec, dict):
        for k, v in spec.items():
            if k != QMARK:
                walk(v, fn, f"{path}.{k}")
    elif isinstance(spec, (list, tuple)):
        for i, v in enumerate(spec):
            walk(v, fn, f"{path}[{i}]")


def bounds(arch):
    """-> {part: (work, ms at the peak)} for one step of ``arch``."""
    import math
    from repro_torch import configs
    from repro_torch.nn import moe as M
    from repro_torch.nn.param import QMARK, ParamSpec
    api = configs.get(arch)
    cfg = dataclasses.replace(api.cfg, n_layers=DEPTH)
    rows, b = BATCH * SEQ // MICROBATCHES, BATCH // MICROBATCHES
    fwd_passes = 2 if cfg.remat and cfg.remat_policy == "full" else 1
    cap = M.capacity(cfg.moe, SEQ) if cfg.moe else 0
    acc = {"params": 0, "qparams": 0, "flops": 0.0, "act_elems": 0.0}

    def visit(path, sp):
        if isinstance(sp, ParamSpec):
            acc["params"] += math.prod(sp.shape)
            return
        w = sp["w"].shape
        acc["params"] += sum(math.prod(v.shape) for k, v in sp.items()
                             if k != QMARK)
        acc["qparams"] += math.prod(w)
        m = b * cap * w[0] if len(w) == 3 else rows   # a bank: E x B x C
        acc["flops"] += 2 * m * math.prod(w[-2:])
        acc["act_elems"] += m * w[-2]
    walk(dataclasses.replace(api, cfg=cfg).specs("train"), visit)
    mb = MICROBATCHES
    out = {}
    # bf16 products: forward (again under remat 'full'), two backward
    fl = mb * acc["flops"] * (fwd_passes + 2)
    out["products"] = (fl, fl / BF16_FLOPS * 1e3)
    # f32: attention over all pairs, the router; forward, remat, backward
    if cfg.mla is not None:
        dqk, dv = cfg.mla.qk_nope + cfg.mla.qk_rope, cfg.mla.v_head
    else:
        dqk = dv = cfg.hd
    att = 2 * b * cfg.n_heads * SEQ * SEQ * (dqk + dv) * cfg.n_layers
    n_moe = cfg.n_layers - cfg.dense_first_n if cfg.moe else 0
    router = 2 * rows * cfg.d_model * (cfg.moe.n_experts if cfg.moe else 0)
    fl = mb * (att + router * n_moe) * (fwd_passes + 2)
    out["f32"] = (fl, fl / F32_FLOPS * 1e3)
    # fake-quant: weights 6 B a forward, 12 B the backward; inputs 4 and 6
    by = mb * (acc["qparams"] * (6 * fwd_passes + 12)
               + acc["act_elems"] * (4 * fwd_passes + 6))
    out["fake_quant"] = (by, by / HBM * 1e3)
    # routing: x and y (T x D) and the slots (B x E x C x D), bf16
    if cfg.moe:
        td = rows * cfg.d_model * 2
        rd = b * cfg.moe.n_experts * cap * cfg.d_model * 2
        by = mb * n_moe * ((2 * td + 2 * rd) * fwd_passes + 3 * td + 3 * rd)
    else:
        by = 0
    out["routing"] = (by, by / HBM * 1e3)
    by = 28 * acc["params"]
    out["adamw"] = (by, by / HBM * 1e3)
    out["params"] = (acc["params"], 0.0)
    return out


def main() -> int:
    res = {a: bounds(a) for a in ARCHS}
    g = res["granite-8b"]
    rest = ("f32", "fake_quant", "routing", "adamw")
    r_prod = GRANITE_MEASURED["products"] / g["products"][1]
    r_rest = ((GRANITE_MEASURED["step"] - GRANITE_MEASURED["products"])
              / sum(g[p][1] for p in rest))
    print(f"granite-8b x{DEPTH} on the card (phase 14): products at "
          f"{1 / r_prod:.2f} of their bound, the rest {r_rest:.2f}x its "
          "bound")
    for arch, r in res.items():
        parts = ", ".join(f"{p} {r[p][1]:.2f} ms" for p in
                          ("products",) + rest)
        bound = sum(r[p][1] for p in ("products",) + rest)
        est = r["products"][1] * r_prod + sum(r[p][1] for p in rest) * r_rest
        print(f"{arch} x{DEPTH} ({r['params'][0] / 1e9:.3f} B parameters), "
              f"{BATCH} x {SEQ} tokens in {MICROBATCHES} microbatches: "
              f"{parts}; bound {bound:.2f} ms; estimate {est:.1f} ms "
              f"({r['products'][1] * r_prod:.1f} products, routing "
              f"{r['routing'][1] * r_rest:.1f})")
    return 0


if __name__ == "__main__":
    sys.exit(main())
