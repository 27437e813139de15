#!/usr/bin/env python3
"""Where a granite-8b prefill and decode step spend their time on the card.

Run from the root of a checkout on a machine with one NVIDIA card:

    python3 tools/profile_lm.py

Builds the same model as ``chip_smoke.py`` phase 8 (granite-8b at full
width and depth, random weights from a CUDA generator seeded 0, packed
under ``examples/plans/granite_8b_mixed.json``; 4 prompts of 1000 tokens)
and reports, for one prefill and for decode steps, from ``torch.profiler``:

* the wall time (host clock, synchronized) and the device time summed over
  all kernels, and their ratio, the device's busy share;
* device time by kernel name: K1's two routes (``mpmm_wgmma_kernel``;
  ``mpmm_splitk_kernel`` and its ``mpmm_splitk_epilogue``), K4, and the
  rest, with the heaviest kernels listed;
* the number of device operations.

Exits non-zero without a card.
"""
from __future__ import annotations

import dataclasses
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT / "src"))

PLAN = ROOT / "examples" / "plans" / "granite_8b_mixed.json"
BATCH, PROMPT = 4, 1000
DECODE_STEPS = 8
GROUPS = (("K1 wgmma", "mpmm_wgmma_kernel"),
          ("K1 splitk", "mpmm_splitk_kernel"),
          ("K1 splitk epilogue", "mpmm_splitk_epilogue"),
          ("K4", "flash_fwd_packed"))


def device_ms(prof, reps):
    """Device time by kernel name, ms per repetition."""
    from torch.autograd import DeviceType
    by_name = {}
    for e in prof.key_averages():
        if e.device_type != DeviceType.CUDA:
            continue
        by_name[e.key] = (by_name.get(e.key, 0.0)
                          + e.self_device_time_total / reps / 1e3)
    return by_name


def report(label, prof, reps, wall_ms):
    from torch.autograd import DeviceType
    by_name = device_ms(prof, reps)
    total = sum(by_name.values())
    ops = sum(1 for e in prof.events()
              if e.device_type == DeviceType.CUDA) / reps
    groups = {g: sum(v for k, v in by_name.items() if key in k)
              for g, key in GROUPS}
    rest = total - sum(groups.values())
    print(f"[profile] {label}: wall {wall_ms:.3f} ms, device {total:.3f} ms "
          f"(busy {total / wall_ms:.1%}), {ops:.0f} device ops; "
          + ", ".join(f"{g} {v:.3f} ms" for g, v in groups.items())
          + f", rest {rest:.3f} ms", flush=True)
    for name, ms in sorted(by_name.items(), key=lambda kv: -kv[1])[:10]:
        print(f"[profile]   {ms:9.4f} ms  {name[:110]}", flush=True)


def main() -> int:
    import numpy as np
    import torch
    from torch.profiler import ProfilerActivity, profile

    if not torch.cuda.is_available():
        print("profile_lm: torch sees no CUDA device", file=sys.stderr)
        return 2
    from repro_torch import configs
    from repro_torch.core.plan import PrecisionPlan
    from repro_torch.kernels import _build
    from repro_torch.runtime.serve import Generator, init_packed_lm

    _build.build_all()
    device = torch.device("cuda", 0)
    plan = PrecisionPlan.load(PLAN)
    api = dataclasses.replace(configs.get("granite-8b"), policy=plan)
    params = init_packed_lm(api, torch.Generator(device=device).manual_seed(0),
                            device=device)
    gen = Generator(api, params, device=device)
    prompts = torch.as_tensor(np.random.default_rng(0).integers(
        0, api.cfg.vocab, (BATCH, PROMPT)), device=device)
    print(f"[profile] {torch.cuda.get_device_name(0)}", flush=True)
    acts = [ProfilerActivity.CPU, ProfilerActivity.CUDA]
    with torch.inference_mode():
        gen.prefill(prompts)  # warm-up
        torch.cuda.synchronize()
        with profile(activities=acts) as prof:
            t0 = time.perf_counter()
            logits, pre = gen.prefill(prompts)
            torch.cuda.synchronize()
            wall = (time.perf_counter() - t0) * 1e3
        report(f"prefill {BATCH} x {PROMPT} tokens", prof, 1, wall)

        cache = gen._grow_cache(pre, BATCH, PROMPT, PROMPT + 2 + DECODE_STEPS)
        tok = torch.argmax(logits, -1)[:, None]
        for i in range(2):  # warm-up
            _, cache = gen.decode(cache, tok, PROMPT + i)
        torch.cuda.synchronize()
        with profile(activities=acts) as prof:
            t0 = time.perf_counter()
            for i in range(DECODE_STEPS):
                _, cache = gen.decode(cache, tok, PROMPT + 2 + i)
            torch.cuda.synchronize()
            wall = (time.perf_counter() - t0) * 1e3 / DECODE_STEPS
        report(f"decode step, batch {BATCH} (mean of {DECODE_STEPS})", prof,
               DECODE_STEPS, wall)
    return 0


if __name__ == "__main__":
    sys.exit(main())
