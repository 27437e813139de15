#!/usr/bin/env python3
"""``chip_smoke.py`` phase 20 alone (tensor-parallel serving of
olmoe-1b-7b, deepseek-v2-lite-16b and whisper-base on a (1, 2) mesh of two
ranks sharing the card), after probes of the bits it relies on.

Run from the root of a checkout on a machine with one NVIDIA card:

    python3 tools/tp_phase20.py

Builds the kernels (``kernels._build.build_all``), then probes, on the
card, whether the parts a tensor-parallel rank computes over its share
are the same bits as the whole:

* ``nn.moe.router_logits`` at olmoe's width (4 x 256 tokens, 2048 x 64
  router) over each half of the expert columns, against all 64;
* the serve prefill's torch attention over half and a quarter of the
  heads against all of them, at MLA's prefill (16 heads of q/k 192 and v
  128, phase 12's 4 x 1000 and phase 20's 4 x 256 tokens) and at
  whisper-base's encoder (8 heads, 1536 frames, bidirectional), decoder
  (16, 64, 100 and 448 tokens, causal) and cross attention (64 queries
  over 1536 frames): as the port runs it on a rank
  (``nn.attention.sharded_heads_attention``, at the one-device shape:
  must be bitwise), and as one batched ``chunked_attention`` over the
  rank's heads alone, and over one head, and a batch row alone (cuBLAS may
  pick its batched product's kernel by the batch count: reported only).

Then runs ``chip_smoke.phase_p20`` (its checks fail the run) and prints
its ``[p20-time]`` lines.  This file is also how to run phase 20 alone: a
rank started by ``launch.mesh.spawn`` re-imports the main module, so the
phase must be run from a file, not from stdin.  Exits non-zero without a
card, or where a ``sharded_heads_attention`` or router probe differs.
"""
from __future__ import annotations

import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT / "src"))
sys.path.insert(0, str(ROOT))

import chip_smoke as cs  # noqa: E402

# (batch, tokens, heads, q/k head dim, v head dim, chunk, causal, key
# tokens; None: the query tokens)
PROBES = {"mla prefill 4 x 1000": (4, 1000, 16, 192, 128, 1024, True, None),
          "mla prefill 4 x 256": (4, 256, 16, 192, 128, 1024, True, None),
          "whisper encoder": (4, 1536, 8, 64, 64, 512, False, None),
          **{f"whisper decoder {s}": (4, s, 8, 64, 64, 512, True, None)
             for s in (16, 64, 100, 448)},
          "whisper cross": (4, 64, 8, 64, 64, 512, False, 1536)}


def probes(torch, dev) -> bool:
    """Log each probe; True where the router's and every
    ``sharded_heads_attention`` probe held."""
    from repro_torch.nn import attention as A
    from repro_torch.nn import moe
    g = torch.Generator(device=dev).manual_seed(0)
    x = torch.randn(4, 256, 2048, generator=g, device=dev)
    r = torch.randn(2048, 64, generator=g, device=dev)
    whole = moe.router_logits(x, r)
    halves = torch.cat([moe.router_logits(
        x, r[:, i * 32:(i + 1) * 32].contiguous()) for i in range(2)], -1)
    ok = torch.equal(whole, halves)
    cs.log(f"[probe] router column halves bitwise the whole: {ok}")
    for label, (b, s, h, d, dv, chunk, causal, sk) in PROBES.items():
        sk = sk or s
        q = torch.randn(b, s, h, d, generator=g, device=dev).bfloat16()
        k = torch.randn(b, sk, h, d, generator=g, device=dev).bfloat16()
        v = torch.randn(b, sk, h, dv, generator=g, device=dev).bfloat16()
        kw = dict(causal=causal, chunk=chunk)
        full = A.chunked_attention(q, k, v, **kw)
        port, alone = {}, {}
        for m in (2, 4, h):
            hl = h // m
            parts = [tuple(t[:, :, i * hl:(i + 1) * hl] for t in (q, k, v))
                     for i in range(m)]
            if m < h:
                port[f"1/{m}"] = torch.equal(full, torch.cat([
                    A.sharded_heads_attention(*p, i, m, **kw)
                    for i, p in enumerate(parts)], 2))
            alone["one head" if m == h else f"1/{m}"] = torch.equal(
                full, torch.cat([A.chunked_attention(*p, **kw)
                                 for p in parts], 2))
        alone["a row"] = torch.equal(full[1:2], A.chunked_attention(
            q[1:2], k[1:2], v[1:2], **kw))
        ok = ok and all(port.values())
        cs.log(f"[probe] {label}: sharded_heads_attention bitwise the "
               f"whole over " + ", ".join(f"{k} of the heads {v}"
                                          for k, v in port.items())
               + "; chunked_attention alone over " + ", ".join(
                   f"{k} {v}" for k, v in alone.items()))
    return ok


def main() -> int:
    import torch
    if not torch.cuda.is_available():
        print("tp_phase20: torch sees no CUDA device", file=sys.stderr)
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
        cs.log("[probe] a sharded_heads_attention or router probe differs")
        return 1
    launches, _ = cs.phase_p20(cs.Smoke(torch, dev), card)
    cs.log(f"[tp_phase20] launches {launches}; "
           f"{time.perf_counter() - t0:.1f} s")
    return 0


if __name__ == "__main__":
    sys.exit(main())
