#!/usr/bin/env python3
"""Three forms of the decode attention's two products on the card: their
cost in a granite-8b decode step, and whether a row's bits depend on the
batch.

Run from the root of a checkout on a machine with one NVIDIA card:

    python3 tools/decode_products.py

Builds the model of ``chip_smoke.py`` phase 8 (granite-8b at full width
and depth, random weights from a CUDA generator seeded 0, packed under
``examples/plans/granite_8b_mixed.json``; 4 prompts of 1000 tokens, a
cache of 1016 positions) and swaps the function that
``nn/attention.decode_attention_streamed`` calls for its two products
(``attn._batch_invariant_einsum``) between:

* ``batched``: one ``torch.einsum`` over the batch;
* ``rowwise``: one ``torch.einsum`` a batch row, then ``torch.cat``;
* ``fixed``: the module's own, ``attn._fixed_order_einsum``: an
  elementwise product into a buffer laid out with the summed axis last,
  then one ``sum`` over it.

First it probes the products alone: for each form, at cache lengths S
from 16 to 8192 and batches 2, 4 and 8 (random bf16-valued operands at
granite-8b's 8 KV heads, 4 query heads a group, head dim 128), is batch
row 0 the same bits as the product of that row alone?  Then, for each
form, it reports the wall time of a decode step at batch 4 (host
clock, synchronized each step; the forms take turns in the order
A B C C B A, four times, so a drift of the card's clock hits each alike), the
device operations and device time of one step (``torch.profiler``), and
two checks: are row 0's logits the same bits at batch 4 as alone at
batch 1, and are a 5-token verify's logits the same bits as 5 decode
steps.  Exits non-zero without a card.
"""
from __future__ import annotations

import dataclasses
import statistics
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT / "src"))
sys.path.insert(0, str(ROOT))

PLAN = ROOT / "examples" / "plans" / "granite_8b_mixed.json"
BATCH, PROMPT, NEW = 4, 1000, 16
STEPS, ROUNDS, T = 6, 4, 5
PROBE_S = (16, 100, 256, 520, 1016, 1024, 2048, 4096, 8192)
PROBE_B = (2, 4, 8)


def batched(eq, x, y):
    import torch
    return torch.einsum(eq, x, y)


def rowwise(eq, x, y):
    import torch
    if x.shape[0] == 1:
        return torch.einsum(eq, x, y)
    return torch.cat([torch.einsum(eq, x[i:i + 1], y[i:i + 1])
                      for i in range(x.shape[0])])


def probe(device, forms):
    """{form: [(product, S, B) where row 0 differs from the row alone]}."""
    import torch
    g = torch.Generator(device=device).manual_seed(1)
    rnd = lambda *shape: torch.randn(  # noqa: E731
        shape, generator=g, device=device).bfloat16().float()
    bad = {name: [] for name in forms}
    for s in PROBE_S:
        for b in PROBE_B:
            q, k, p = rnd(b, 8, 4, 128), rnd(b, s, 8, 128), rnd(b, 8, 4, s)
            for eq, x, y in (("bkgd,bskd->bkgs", q, k),
                             ("bkgs,bskd->bkgd", p, k)):
                for name, form in forms.items():
                    if not torch.equal(form(eq, x, y)[:1],
                                       form(eq, x[:1], y[:1])):
                        bad[name].append((eq[-4:], s, b))
    return bad


def main() -> int:
    import numpy as np
    import torch
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    if not torch.cuda.is_available():
        print("decode_products: torch sees no CUDA device", file=sys.stderr)
        return 2
    from chip_smoke import clone_tree
    from repro_torch import configs
    from repro_torch.core.plan import PrecisionPlan
    from repro_torch.kernels import _build
    from repro_torch.nn import attention as attn
    from repro_torch.runtime.serve import Generator, init_packed_lm

    forms = {"batched": batched, "rowwise": rowwise,
             "fixed": attn._fixed_order_einsum}
    device = torch.device("cuda", 0)
    n_cases = 2 * len(PROBE_S) * len(PROBE_B)
    for name, bad in probe(device, forms).items():
        print(f"[products] probe {name}: row 0 != the row alone in "
              f"{len(bad)} of {n_cases} (product, S, B) cases {bad}",
              flush=True)
    _build.build_all()
    plan = PrecisionPlan.load(PLAN)
    api = dataclasses.replace(configs.get("granite-8b"), policy=plan)
    params = init_packed_lm(api, torch.Generator(device=device).manual_seed(0),
                            device=device)
    gen = Generator(api, params, device=device)
    prompts = torch.as_tensor(np.random.default_rng(0).integers(
        0, api.cfg.vocab, (BATCH, PROMPT)), device=device)
    print(f"[products] {torch.cuda.get_device_name(0)}, granite-8b "
          f"{api.cfg.n_layers} layers, batch {BATCH}, cache "
          f"{PROMPT + NEW}", flush=True)
    length = PROMPT + NEW - T
    with torch.inference_mode():
        caches, toks = {}, {}
        for b in (BATCH, 1):
            logits, pre = gen.prefill(prompts[:b])
            caches[b] = gen._grow_cache(pre, b, PROMPT, PROMPT + NEW)
            toks[b] = torch.argmax(logits, -1)[:, None]
            del pre
        feed = torch.cat([toks[BATCH]] * T, dim=1)
        results = {}
        for name, form in forms.items():
            attn._batch_invariant_einsum = form
            one = gen.decode(clone_tree(caches[1]), toks[1], length)[0]
            four = gen.decode(clone_tree(caches[BATCH]), toks[BATCH],
                              length)[0]
            seq_cache = clone_tree(caches[BATCH])
            seq = torch.stack([gen.decode(seq_cache, feed[:, i:i + 1],
                                          length + i)[0]
                               for i in range(T)], dim=1)
            ver = api.decode_steps(gen.params, clone_tree(caches[BATCH]),
                                   feed, length)[0]
            with profile(activities=[ProfilerActivity.CPU,
                                     ProfilerActivity.CUDA]) as prof:
                gen.decode(caches[BATCH], toks[BATCH], length)
                torch.cuda.synchronize()
            dev = [e for e in prof.events()
                   if e.device_type == DeviceType.CUDA]
            results[name] = {
                "alone": bool(torch.equal(one[0], four[0])),
                "alone_diff": float((one[0].float()
                                     - four[0].float()).abs().max()),
                "verify": bool(torch.equal(ver, seq)),
                "ops": len(dev),
                "device_ms": sum(e.self_device_time_total for e in dev) / 1e3,
                "wall": []}
        order = list(forms) + list(forms)[::-1]
        for _ in range(ROUNDS):
            for name in order:
                attn._batch_invariant_einsum = forms[name]
                for _ in range(STEPS):
                    torch.cuda.synchronize()
                    t0 = time.perf_counter()
                    gen.decode(caches[BATCH], toks[BATCH], length)
                    torch.cuda.synchronize()
                    results[name]["wall"].append(
                        (time.perf_counter() - t0) * 1e3)
    for name, r in results.items():
        w = r["wall"]
        print(f"[products] {name}: decode step median {statistics.median(w)}"
              f" ms, mean {statistics.fmean(w)} ms, min {min(w)} ms over "
              f"{len(w)} steps; one profiled step {r['ops']} device ops, "
              f"{r['device_ms']} ms device time; row 0 at batch {BATCH} "
              f"== alone: {r['alone']} (max diff {r['alone_diff']}); "
              f"verify == {T} decode steps: {r['verify']}", flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
