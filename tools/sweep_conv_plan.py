#!/usr/bin/env python3
"""K2's device time at every split a ResNet-18 conv can take.

Run from the root of a checkout on a machine with one NVIDIA card:

    python3 tools/sweep_conv_plan.py

For the ResNet-18 serve path's convs (full size, ``resnet18_mixed.json``)
at batches 1 and 8, times ``conv_mpmm_cuda`` under each candidate split of
``conv_kernel.plan_candidates`` (forced in place of ``conv_plan``'s choice)
as device time (``chip_smoke.Smoke.graph_ms``: calls captured in a CUDA
graph, replayed between CUDA events), beside the cost model's estimate
(``ConvPlan.cost_us``) and whether the split meets the grid rule.  These
are the measurements ``conv_kernel``'s cost-model constants are fitted to.
Prints one ``[sweep]`` line per (conv, batch, split); exits non-zero
without a card.
"""
from __future__ import annotations

import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT / "src"))
sys.path.insert(0, str(ROOT))

CONVS = ("s0b0c1", "s1b0p", "s1b0c1", "s1b1c1", "s2b0p", "s2b0c1", "s2b1c1",
         "s3b0p", "s3b0c1", "s3b1c1")


def main() -> int:
    import torch
    if not torch.cuda.is_available():
        print("sweep_conv_plan: torch sees no CUDA device", file=sys.stderr)
        return 2
    import chip_smoke as cs
    from repro_torch import configs
    from repro_torch.core.plan import PrecisionPlan
    from repro_torch.kernels.mpmm import conv_kernel as ck

    sm = cs.Smoke(torch, torch.device("cuda", 0))
    cfg = configs.get(cs.ARCH).cfg
    convs = {c[0]: c for c in cs.resnet_convs(cfg,
                                               PrecisionPlan.load(cs.PLAN))}
    print(f"[sweep] {cs.card_line()}", flush=True)
    chosen = ck.conv_plan
    try:
        for name in CONVS:
            conv = convs[name]
            _, cin, cout, kk, stride, h = conv[:6]
            ho = -(-h // stride)
            for batch in (1, 8):
                _, dev, kw = cs.k2_call(sm, batch, conv, conv[-1], "st")
                plan = chosen(batch, ho, ho, cout, kk * kk * cin, kw["fmt"])
                for cand in ck.plan_candidates(batch, ho, ho, cout,
                                               kk * kk * cin):
                    ck.conv_plan = lambda *a, p=cand: p  # noqa: E731
                    ms = sm.graph_ms(lambda: ck.conv_mpmm_cuda(**dev, **kw))
                    print(f"[sweep] {name} B={batch} bn={cand.bn} tiles="
                          f"{cand.tiles} k_steps={cand.k_steps} steps="
                          f"{cand.steps} splits={cand.splits} blocks="
                          f"{cand.blocks} ms={ms:.4f} model_us="
                          f"{cand.cost_us():.1f} rule={cand.fills_the_card()}"
                          + (" <- plan" if cand == plan else ""), flush=True)
    finally:
        ck.conv_plan = chosen
    return 0


if __name__ == "__main__":
    sys.exit(main())
