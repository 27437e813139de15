#!/usr/bin/env python3
"""The paper's PE models (``core/ppg``) timed on the card's clock alone.

Run from the root of a checkout on a machine with one NVIDIA card:

    python3 tools/ppg_device_time.py

``chip_smoke.py`` phase 17 times each variant by CUDA events around whole
calls.  Those calls are host-bound: casts, zero padding, one operand range
check that waits for the card, and shift-adds around each ``torch._int_mm``
cost far more than the device work, so that score ranks the host's work a
pass.  This script times the device alone: for every variant x (w, k) of
the Fig. 6 grid (M 64, K 256, N 256, operands drawn as
``benchmarks/fig6_pe_dse.py`` draws them) and of ResNet-18's s3 3x3 conv
at batch 8 as a GEMM (M 392, K 4608, N 512), it sums the time of the CUDA
kernels that REPS calls launch (``torch.profiler``, one session a case)
and prints it a call beside the host clock's, with the Fig. 6 score
(weight bits a second per byte of live accumulators) by each.  Each
result is first checked bitwise against ``matmul_exact``.  Exits non-zero
without a card.
"""
from __future__ import annotations

import subprocess
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT / "src"))
sys.path.insert(0, str(ROOT))

REPS = 5


def device_us(torch, fn) -> float:
    """Device time of one call, us: the CUDA kernels' own time over REPS
    calls (0.0 where the profiler saw none)."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile
    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        for _ in range(REPS):
            fn()
        torch.cuda.synchronize()
    return sum(e.self_device_time_total for e in prof.key_averages()
               if e.device_type == DeviceType.CUDA) / REPS


def main() -> int:
    import torch
    if not torch.cuda.is_available():
        print("ppg_device_time: torch sees no CUDA device", file=sys.stderr)
        return 2
    from chip_smoke import (P17_FORMATS, P17_GRID, P17_LAYER, Smoke,
                            p17_call, p17_inputs, p17_score)
    from repro_torch.core import ppg
    card = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        timeout=60).stdout.strip().splitlines()[0]
    device = torch.device("cuda", 0)
    sm = Smoke(torch, device)
    bad = 0
    for shape, label in ((P17_GRID, "fig6"), (P17_LAYER, "resnet18-s3")):
        a_np, ws = p17_inputs(*shape)
        a = torch.from_numpy(a_np).to(device)
        best = {}
        for w_bits, k in P17_FORMATS:
            w = torch.from_numpy(ws[w_bits]).to(device)
            exact = ppg.matmul_exact(a, w)
            for name, fn in ppg.PE_VARIANTS.items():
                def call(fn=fn, name=name):
                    return p17_call(fn, name, a, w, w_bits, k)
                got, stats = call()
                if not torch.equal(got, exact):
                    print(f"[ppg] {label} {name} w{w_bits}k{k}: not bitwise "
                          f"matmul_exact", flush=True)
                    bad += 1
                host_ms = sm.time_ms(call, reps=10, warmup=2)
                dev_us = device_us(torch, call)
                host_score = p17_score(shape, w_bits, stats, host_ms)
                dev_score = (p17_score(shape, w_bits, stats, dev_us * 1e-3)
                             if dev_us else float("nan"))
                for key, v in (("host", host_score), ("device", dev_score)):
                    if v > best.get(key, (0.0, ""))[0]:
                        best[key] = (v, f"{name} w{w_bits}k{k}")
                print(f"[ppg] {label} {name} w{w_bits}k{k}: device "
                      f"{dev_us:.2f} us a call, host clock "
                      f"{host_ms * 1e3:.2f} us; score {dev_score:.3e} by the "
                      f"device, {host_score:.3e} by the host clock (passes "
                      f"{stats.mxu_passes}, accumulators "
                      f"{stats.accumulators})  ({card})", flush=True)
        for key, (v, what) in best.items():
            print(f"[ppg] {label}: highest score by the {key}: {what} "
                  f"{v:.3e}  ({card})", flush=True)
    print(card)
    return 1 if bad else 0


if __name__ == "__main__":
    sys.exit(main())
