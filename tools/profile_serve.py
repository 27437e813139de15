#!/usr/bin/env python3
"""Where a served ResNet-18 forward spends its time on the card.

Run from the root of a checkout on a machine with one NVIDIA card:

    python3 tools/profile_serve.py

Builds the same server as ``chip_smoke.py`` (full ResNet-18, random weights
from seed 0, packed under ``examples/plans/resnet18_mixed.json``) and, per
batch bucket, reports:

* the wall time of ``ImageServer.predict`` (host clock, synchronized by the
  copy of the logits to the host) and of ``serve_forward`` alone on images
  already on the card (CUDA events);
* from ``torch.profiler`` over a few ``predict`` calls: device time by
  kernel name, the two hand-written kernels' share, and the device's busy
  share of the wall time (kernel and copy time over wall time).

Prints one summary line per bucket and its heaviest device kernels.
Exits non-zero without a card.
"""
from __future__ import annotations

import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT / "src"))

PLAN = ROOT / "examples" / "plans" / "resnet18_mixed.json"
BUCKETS = (1, 8)
REPS = 5


def main() -> int:
    import numpy as np
    import torch
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    if not torch.cuda.is_available():
        print("profile_serve: torch sees no CUDA device", file=sys.stderr)
        return 2
    from repro_torch import configs
    from repro_torch.core.plan import PrecisionPlan
    from repro_torch.kernels import _build
    from repro_torch.models import resnet as R
    from repro_torch.runtime.serve import ImageServer

    _build.build_all()
    device = torch.device("cuda", 0)
    api = configs.get("resnet18")
    plan = PrecisionPlan.load(PLAN)
    gen = torch.Generator().manual_seed(0)
    params = api.init_params(gen, device=device)
    packed = R.pack_for_serve(api.cfg, params,
                              R.init_bn_state(api.specs(), device=device),
                              plan)
    server = ImageServer(api=api, params=packed, batch_buckets=BUCKETS,
                         plan=plan, device=device)
    rng = np.random.default_rng(1)
    print(f"[profile] {torch.cuda.get_device_name(0)}", flush=True)
    for b in BUCKETS:
        x = rng.normal(0, 1, (b, 224, 224, 3)).astype(np.float32)
        for _ in range(3):
            server.predict(x)
        t0 = time.perf_counter()
        for _ in range(REPS):
            server.predict(x)
        predict_ms = (time.perf_counter() - t0) / REPS * 1e3

        xd = torch.from_numpy(x).to(device)
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        with torch.inference_mode():
            start.record()
            for _ in range(REPS):
                R.serve_forward(api.cfg, server.params, xd, plan)
            end.record()
        torch.cuda.synchronize()
        forward_ms = start.elapsed_time(end) / REPS

        with profile(activities=[ProfilerActivity.CPU,
                                 ProfilerActivity.CUDA]) as prof:
            t0 = time.perf_counter()
            for _ in range(REPS):
                server.predict(x)
            torch.cuda.synchronize()
            wall_ms = (time.perf_counter() - t0) / REPS * 1e3
        by_name = {}
        for e in prof.key_averages():
            if e.device_type != DeviceType.CUDA:
                continue
            us = e.self_device_time_total / REPS
            by_name[e.key] = by_name.get(e.key, 0.0) + us / 1e3
        device_ms = sum(by_name.values())
        ours = {k: v for k, v in by_name.items() if "mpmm" in k}
        top = sorted(by_name.items(), key=lambda kv: -kv[1])[:12]
        row = {
            "predict_ms": predict_ms, "forward_ms": forward_ms,
            "profiled_wall_ms": wall_ms, "device_ms": device_ms,
            "busy_share": device_ms / wall_ms if wall_ms else None,
            "hand_kernels_ms": sum(ours.values()),
            "kernel_launches": sum(1 for e in prof.events()
                                   if e.device_type == DeviceType.CUDA) / REPS,
            "top": top,
        }
        print(f"[profile] bucket {b}: predict {predict_ms:.3f} ms, "
              f"serve_forward {forward_ms:.3f} ms (CUDA events), profiled "
              f"wall {wall_ms:.3f} ms, device {device_ms:.3f} ms "
              f"(busy {row['busy_share']}), K1+K2 {row['hand_kernels_ms']:.3f}"
              f" ms, {row['kernel_launches']:.0f} device ops per predict",
              flush=True)
        for name, ms in top:
            print(f"[profile]   {ms:9.4f} ms  {name[:110]}", flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
