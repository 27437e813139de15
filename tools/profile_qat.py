#!/usr/bin/env python3
"""What the QAT step's im2col and MoE routing cost on the card, and what
their backwards' fixed sums cost against torch's own.

Run from the root of a checkout on a machine with one NVIDIA card:

    python3 tools/profile_qat.py [--src DIR] [--label NAME] [--reps N]

``--src`` names the ``src`` directory of the package to measure (default
this checkout's), so that two trees can be timed on one card: unpack
the other with ``git archive`` into a directory ``.gitignore`` lists and
alternate the runs (parent, change, change, parent).  Every time is CUDA
events around ``--reps`` back-to-back calls after a warm-up, under
``launch.steps.deterministic`` as the train step runs, L2-warm; random
weights and inputs from seed 0.

(a) ResNet-18 at full width (224 x 224, batch 32, the plan
    ``examples/plans/resnet18_mixed.json``), as ``chip_smoke.py`` phase 14
    trains it: the QAT forward and backward (``value_and_grad`` of the
    loss) and one ``make_train_step``; then, at each conv geometry the
    forward runs (its input's shape, kernel and stride, counted), im2col
    forward and backward three ways: ``nn.quantized.im2col``, the bf16
    gather whose backward adds a pixel's tap gradients one by one in
    bf16; the same gather from an f32 copy of x, rounded back (its
    backward adds them in f32); and ``nn.quantized.im2col_train`` where the
    tree has it (its backward adds them in f32 in place).
(b) The MoE routing of olmoe-1b-7b and deepseek-v2-lite-16b at full width
    (2 x 1024 tokens, one microbatch of phase 15; the bank and the shared
    experts left out): ``nn.moe.route``, ``dispatch`` and
    ``gate_and_combine`` forward and backward as the train path runs them,
    against the same with the serve path's dispatch and gating under
    autograd (torch's own backwards: the gather's f32 scatter-add, the
    product's f32 sum over D); each of the two alone both ways; and MLA's
    rotary-key broadcast over deepseek's heads, ``nn.attention.
    _HeadBroadcast`` against ``expand``.  A tree without the MoE train
    path skips (b).

Prints ``[qat]`` lines and writes ``build/profile_qat_<label>.json``.
Exits non-zero without a card.
"""
from __future__ import annotations

import argparse
import json
import os
import subprocess
import sys
from collections import Counter
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]
PLAN = ROOT / "examples" / "plans" / "resnet18_mixed.json"
BATCH = 32
MOE_ARCHS = ("olmoe-1b-7b", "deepseek-v2-lite-16b")
MOE_B, MOE_S = 2, 1024
SEED = 0


def time_ms(torch, fn, reps, warmup=2):
    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(reps):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / reps


def fwd_bwd(torch, fn, inputs, ct):
    """A closure: ``fn(*inputs)`` and its gradient to ``inputs``."""
    def run():
        torch.autograd.grad(fn(*inputs), inputs, grad_outputs=ct)
    return run


def resnet(torch, dev, reps):
    from repro_torch import configs
    from repro_torch.core.plan import PrecisionPlan
    from repro_torch.data.pipeline import SyntheticImages
    from repro_torch.launch import steps as S
    from repro_torch.nn import quantized as Q
    api = configs.get("resnet18", policy=PrecisionPlan.load(PLAN))
    cfg = api.cfg
    state = S.init_train_state(
        api, torch.Generator(device=dev).manual_seed(SEED), device=dev)
    b = SyntheticImages(n_classes=cfg.n_classes, img_size=cfg.img_size,
                        global_batch=BATCH, seed=SEED).batch_at(0)
    x = torch.as_tensor(b["images"], device=dev)
    y = torch.as_tensor(b["labels"], device=dev).long()
    batch = {"tokens": x, "labels": y}
    out = {}
    loss_fn = lambda p, t, lb, f: S.cross_entropy(  # noqa: E731
        api.forward(p, t, mode="train"), lb)
    with S.deterministic(dev):
        out["fwd_bwd_ms"] = time_ms(torch, lambda: S.value_and_grad(
            loss_fn, state["params"], x, y, None), reps)
    step = S.make_train_step(api, peak_lr=1e-3)
    holder = {"s": state}

    def one_step():
        holder["s"], m = step(holder["s"], batch)
        float(m["loss"])  # the step ends when its metrics reach the host
    out["step_ms"] = time_ms(torch, one_step, reps)
    del holder, state

    # the conv geometries one forward runs, counted
    geoms = Counter()
    plain = Q.im2col

    def record(xx, kh, kw, stride, padding):
        geoms[(tuple(xx.shape), str(xx.dtype), kh, stride, padding)] += 1
        return plain(xx, kh, kw, stride, padding)
    Q.im2col = record
    try:
        with torch.no_grad():
            params = S.init_train_state(
                api, torch.Generator(device=dev).manual_seed(SEED),
                device=dev)["params"]
            api.forward(params, x, mode="train")
    finally:
        Q.im2col = plain
    variants = {
        "bf16_gather": plain,
        "f32_copy": lambda v, kh, kw, s, p: plain(
            v.to(torch.float32), kh, kw, s, p).to(v.dtype),
    }
    if hasattr(Q, "im2col_train"):
        variants["im2col_train"] = Q.im2col_train
    g = torch.Generator(device=dev).manual_seed(SEED)
    rows = []
    totals = dict.fromkeys(variants, 0.0)
    for (shape, dtype, k, s, pad), n in sorted(geoms.items()):
        dt = getattr(torch, dtype.split(".")[-1])
        xx = torch.randn(shape, generator=g, device=dev).to(dt)
        xx.requires_grad_(True)
        ct = torch.randn(plain(xx, k, k, s, pad).shape, generator=g,
                         device=dev).to(dt)
        row = {"x": list(shape), "dtype": dtype, "k": k, "stride": s,
               "count": n}
        with S.deterministic(dev):
            for name, fn in variants.items():
                ms = time_ms(torch, fwd_bwd(
                    torch, lambda v, f=fn: f(v, k, k, s, pad), (xx,), ct),
                    reps)
                row[name] = ms
                totals[name] += n * ms
        rows.append(row)
        print(f"[qat] im2col x {list(shape)} {dtype} k{k} s{s} (x{n}): "
              + ", ".join(f"{v} {row[v]:.4f} ms" for v in variants),
              flush=True)
    out["im2col"] = rows
    out["im2col_total_ms"] = totals
    print(f"[qat] resnet18 batch {BATCH}: forward+backward "
          f"{out['fwd_bwd_ms']:.2f} ms, step {out['step_ms']:.2f} ms; "
          "the im2cols of one forward+backward: "
          + ", ".join(f"{k} {v:.2f} ms" for k, v in totals.items()),
          flush=True)
    return out


def moe(torch, dev, reps):
    from repro_torch import configs
    from repro_torch.launch import steps as S
    from repro_torch.nn import attention as A
    from repro_torch.nn import moe as M
    if not hasattr(M, "gate_and_combine"):
        print("[qat] this tree has no MoE train path: (b) skipped")
        return None
    out = {}
    g = torch.Generator(device=dev).manual_seed(SEED)
    for arch in MOE_ARCHS:
        cfg = configs.get(arch).cfg
        mc = cfg.moe
        d = mc.d_model
        x = torch.randn((MOE_B, MOE_S, d), generator=g, device=dev).to(
            torch.bfloat16).requires_grad_(True)
        router = (torch.randn((d, mc.n_experts), generator=g, device=dev)
                  / d ** 0.5).requires_grad_(True)
        ct = torch.randn((MOE_B, MOE_S, d), generator=g, device=dev).to(
            torch.bfloat16)

        def routing(serve):
            def fn(xx, rr):
                idx, vals, tok_idx = M.route(xx, rr, mc)
                h = M.dispatch(xx, tok_idx, idx, serve=serve)
                return M.gate_and_combine(h, vals, tok_idx, idx, MOE_S,
                                          serve=serve).to(xx.dtype)
            return fn
        with torch.no_grad():
            idx, vals, tok_idx = M.route(x, router, mc)
        e, c = tok_idx.shape[1], tok_idx.shape[2]
        h = torch.randn((MOE_B, e, c, d), generator=g, device=dev).to(
            torch.bfloat16).requires_grad_(True)
        ct_h = torch.randn(h.shape, generator=g, device=dev).to(
            torch.bfloat16)
        v = vals.detach().clone().requires_grad_(True)
        r = {}
        with S.deterministic(dev):
            for name, serve in (("ordered", False), ("torch", True)):
                r[f"routing_{name}_ms"] = time_ms(torch, fwd_bwd(
                    torch, routing(serve), (x, router), ct), reps)
                r[f"dispatch_{name}_ms"] = time_ms(torch, fwd_bwd(
                    torch, lambda xx, s=serve: M.dispatch(
                        xx, tok_idx, idx, serve=s), (x,), ct_h), reps)
            r["gate_ordered_ms"] = time_ms(torch, fwd_bwd(
                torch, M._Gate.apply, (h, v), ct_h), reps)
            r["gate_torch_ms"] = time_ms(torch, fwd_bwd(
                torch, lambda hh, vv: hh * vv[..., None].to(hh.dtype),
                (h, v), ct_h), reps)
            if cfg.mla is not None:
                rd, nh = cfg.mla.qk_rope, cfg.n_heads
                k = torch.randn((MOE_B, MOE_S, rd), generator=g,
                                device=dev).to(torch.bfloat16)
                k.requires_grad_(True)
                ck = torch.randn((MOE_B, MOE_S, nh, rd), generator=g,
                                 device=dev).to(torch.bfloat16)
                r["head_broadcast_ordered_ms"] = time_ms(torch, fwd_bwd(
                    torch, lambda kk: A._HeadBroadcast.apply(kk, nh), (k,),
                    ck), reps)
                r["head_broadcast_torch_ms"] = time_ms(torch, fwd_bwd(
                    torch, lambda kk: kk[:, :, None, :].expand(
                        MOE_B, MOE_S, nh, rd), (k,), ck), reps)
        out[arch] = r
        print(f"[qat] {arch} routing at {MOE_B} x {MOE_S} tokens (E {e}, "
              f"top-{mc.topk}, capacity {c}), forward+backward: "
              + ", ".join(f"{k[:-3]} {val:.3f} ms" for k, val in r.items()),
              flush=True)
    return out


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--src", default=str(ROOT / "src"))
    ap.add_argument("--label", default="this")
    ap.add_argument("--reps", type=int, default=10)
    args = ap.parse_args(argv)
    sys.path.insert(0, str(Path(args.src).resolve()))
    # cuBLAS's deterministic mode, as launch.train sets it
    os.environ.setdefault("CUBLAS_WORKSPACE_CONFIG", ":4096:8")
    import torch
    if not torch.cuda.is_available():
        print("profile_qat: no CUDA device", file=sys.stderr)
        return 1
    dev = torch.device("cuda")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    card = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True
    ).stdout.strip().splitlines()[0]
    print(f"[qat] {args.label}: {args.src}, {card}", flush=True)
    res = {"label": args.label, "src": args.src, "card": card,
           "resnet18": resnet(torch, dev, args.reps)}
    torch.cuda.empty_cache()
    res["moe"] = moe(torch, dev, args.reps)
    out = ROOT / "build" / f"profile_qat_{args.label}.json"
    out.parent.mkdir(exist_ok=True)
    out.write_text(json.dumps(res, indent=1))
    return 0


if __name__ == "__main__":
    sys.exit(main())
