#!/usr/bin/env python3
"""``chip_smoke.py`` phase 21 alone (tensor-parallel serving of
mamba2-1.3b, recurrentgemma-9b and granite-8b's fp baseline on a (1, 2)
mesh of two ranks sharing the card), after probes of the bits it relies
on.

Run from the root of a checkout on a machine with one NVIDIA card:

    python3 tools/tp_phase21.py

Builds the kernels (``kernels._build.build_all``), then probes, on the
card, whether the parts a tensor-parallel rank computes over its share
are the same bits as the whole:

* the SSD chunk math (``nn.ssm._ssd_chunks``, mamba2-1.3b's 64 heads,
  one row of 1024 tokens) and the decode step's contraction
  (``_contract_n``) over half and a quarter of the heads: as a rank runs
  them, zero-padded to all the heads at their own index (must be
  bitwise), and over the rank's heads alone (reported);
* the fp baseline's column shard (granite-8b's gate, 4096 x 14336, at
  1024 and 4 rows) over each half of the columns: at the one-device N,
  the weight zero-padded (``nn.quantized.fp_shard``, must be bitwise),
  and at N / 2 alone (reported).

Then runs ``chip_smoke.phase_p21`` (its checks fail the run) and prints
its ``[p21-time]`` lines.  A rank started by ``launch.mesh.spawn``
re-imports the main module, so the phase must be run from a file, not
from stdin.  Exits non-zero without a card, or where a probe that must
be bitwise differs.
"""
from __future__ import annotations

import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT / "src"))
sys.path.insert(0, str(ROOT))

import chip_smoke as cs  # noqa: E402


def probes(torch, dev) -> bool:
    """Log each probe; True where every padded form held."""
    from repro_torch.core.precision import PrecisionPolicy
    from repro_torch.nn import quantized as Q
    from repro_torch.nn import ssm
    g = torch.Generator(device=dev).manual_seed(0)
    h, p, n, s = 64, 64, 128, 1024
    xh = torch.randn(1, s, h, p, generator=g, device=dev)
    bm = torch.randn(1, s, h, n, generator=g, device=dev)
    cm = torch.randn(1, s, h, n, generator=g, device=dev)
    dtp = torch.rand(1, s, h, generator=g, device=dev) * 0.1
    a = -torch.rand(h, generator=g, device=dev)
    y, final = ssm._ssd_chunks(xh, bm, cm, dtp, a, 256)
    cv = torch.randn(4, h, n, generator=g, device=dev)
    st = torch.randn(4, h, n, p, generator=g, device=dev)
    yc = ssm._contract_n(cv, st)
    ok = True
    for m in (2, 4):
        hl = h // m
        padded = alone = True
        for r in range(m):
            own = slice(r * hl, (r + 1) * hl)
            yr, fr = ssm._ssd_chunks(
                ssm._pad_heads(xh[:, :, own], 2, r, m), bm, cm,
                ssm._pad_heads(dtp[:, :, own], 2, r, m),
                ssm._pad_heads(a[own], 0, r, m), 256)
            padded &= (torch.equal(ssm._own_heads(yr, 2, r, m), y[:, :, own])
                       and torch.equal(ssm._own_heads(fr, 1, r, m),
                                       final[:, own])
                       and torch.equal(ssm._contract_n(
                           cv[:, own], st[:, own], r, m), yc[:, own]))
            ya, fa = ssm._ssd_chunks(xh[:, :, own], bm[:, :, own],
                                     cm[:, :, own], dtp[:, :, own], a[own],
                                     256)
            alone &= (torch.equal(ya, y[:, :, own])
                      and torch.equal(fa, final[:, own])
                      and torch.equal(ssm._contract_n(cv[:, own],
                                                      st[:, own]),
                                      yc[:, own]))
        ok &= padded
        cs.log(f"[probe] SSD chunk math and contraction over 1/{m} of the "
               f"heads: padded to all {h} bitwise {padded}; the rank's "
               f"heads alone bitwise {alone}")
    fp = PrecisionPolicy(quantize=False)
    w = (torch.randn(4096, 14336, generator=g, device=dev) * 0.02).to(
        torch.bfloat16)
    half = 14336 // 2
    for rows in (1024, 4):
        x = torch.randn(rows, 4096, generator=g, device=dev).to(
            torch.bfloat16)
        whole = Q.qlinear_serve_apply({"w": w}, x, fp)
        padded = alone = True
        for r in range(2):
            cols = slice(r * half, (r + 1) * half)
            shard = Q.fp_shard({"w": w}, -1, ((cols.start, cols.stop),))
            padded &= torch.equal(Q.qlinear_serve_apply(shard, x, fp),
                                  whole[:, cols])
            alone &= torch.equal(torch.matmul(x, w[:, cols].contiguous()),
                                 whole[:, cols])
        ok &= padded
        cs.log(f"[probe] fp column halves at {rows} rows: padded to the "
               f"one-device N bitwise {padded}; N / 2 alone bitwise "
               f"{alone}")
    return ok


def main() -> int:
    import torch
    if not torch.cuda.is_available():
        print("tp_phase21: torch sees no CUDA device", file=sys.stderr)
        return 2
    from repro_torch.kernels import _build
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    card = cs.card_line()
    cs.log(card)
    t0 = time.perf_counter()
    built = _build.build_all()
    cs.log(f"[build] {built['seconds']:.1f} s")
    dev = torch.device("cuda", 0)
    if not probes(torch, dev):
        cs.log("[probe] a padded probe differs")
        return 1
    launches, _, _ = cs.phase_p21(cs.Smoke(torch, dev), card)
    cs.log(f"[tp_phase21] launches {launches}; "
           f"{time.perf_counter() - t0:.1f} s")
    return 0


if __name__ == "__main__":
    sys.exit(main())
