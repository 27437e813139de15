#!/usr/bin/env python3
"""Drive the PyTorch port on one NVIDIA card and check it end to end.

Run from the root of a checkout:  python3 chip_smoke.py

Phases, each of which fails the run (non-zero exit, no result line):

1. Build the four CUDA kernels (K1's two routes and K2 from
   ``kernels/mpmm/csrc``, K3, K4 from ``kernels/flashattn/csrc``) with nvcc
   for sm_90a into seven libraries (K1's tensor-core route and K2 as two
   each, one per half of the 16 weight formats), one process per library,
   in parallel.
2. K1 (``mpmm_cuda``) against its plain version ``mpmm_torch``, through
   both routes (M 100 on the tensor-core route ``wgmma``, M 4 on the
   split-K route ``splitk``): all 16 weight formats (w and k in 1/2/4/8,
   k > w among them), both variants, the three epilogues, both output dtypes,
   ragged M/N/K, an int32-accumulator check; the ResNet serve path's own
   shapes (stem as im2col, classifier); and granite-8b's prefill and decode
   shapes, held against the plain version run on the card.
3. K2 (``conv_mpmm_cuda``, int8 tensor cores, padding in the kernel)
   against ``conv_mpmm_torch`` at every ResNet-18 conv shape, both on the
   unpadded input: at batches 8 and 1 with the path's epilogue (batch 1
   runs the split plans of ``conv_kernel.conv_plan``), and at batch 2 with
   Sum-Apart and the residual epilogue; every format the plan does not
   use (k > w among them) at two of those convs, batches 1 and 2.
4. ResNet end to end: full-width ResNet-18 (224x224, width 64, 1000
   classes) with random weights from a seeded generator, packed under
   ``examples/plans/resnet18_mixed.json`` and served by ``ImageServer`` with
   buckets (1, 2, 4, 8) for requests of 1, 3, 8 and 13 images.  The launch
   counters must show, per bucket call, K2 once for each conv that the
   layer's dataflow choice sends to the implicit conv and K1 once for the
   others and the classifier, by K1's route rule (``resnet_launches``:
   under ``dataflow="auto"`` the H100 cost model chooses); the logits are
   compared with the same forward through the plain versions.
5. ResNet timing at the serve path's shapes (K1 at batch 8, K2 at
   batches 8 and 1): each kernel, its plain version, one PyTorch library
   call for the same product (K2: ``F.conv2d`` in f32, TF32 off,
   channels_last, on the padded input) and the bound (the larger of bytes
   over 3.35 TB/s and int8 operations over 1979 TOP/s, the H100 SXM
   data-sheet peaks), K2's rows with their plan (N tile, splits, blocks);
   frames/s per bucket.  K2 and ``F.conv2d`` are timed as device time:
   calls captured in a CUDA graph and replayed between CUDA events
   (``Smoke.graph_ms``); K2 is also timed call by call, where the host's
   cost of a call sets the time.
6. K3 (``flash_fwd_cuda``) against ``flash_fwd_torch`` at granite-8b's
   attention shapes (B 4, H 32, KV 8, D 128, bf16): causal at Sq = Sk of
   1000 and 1024, a 256 window, q_offset continuations (Sq 8 and the
   speculative verify chunk Sq 9, Sk 1024) and a non-causal ragged Sk
   (forced causal, as the reference's padding does).
7. K4 (``flash_fwd_packed_cuda``) against ``flash_fwd_packed_torch`` on the
   cache formats of ``examples/plans/granite_8b_mixed.json`` (kv2 k2, kv4
   k4, kv8 k4), K and V in different formats, q_offset continuations (Sq 8
   and 9) and a ragged Sk; and against K3 run on ``unpack_kv`` of the same
   cache.
8. LM end to end: granite-8b at full width (d_model 4096, 32 heads, 8 KV
   heads, head_dim 128, d_ff 14336, vocab 49152) with random weights from
   a seeded CUDA generator, all 36 layers, drawn and packed layer by layer
   on the card under ``granite_8b_mixed.json``, served by ``Generator``: 4
   prompts of
   1000 tokens, 16 new tokens, greedy.  The counters must show K4 once per
   layer per prefill, K1 7 times per layer plus the head per prefill and
   per decode step (the prefill's projections on ``wgmma``, its head and
   all of a decode step's calls on ``splitk``), K3 never.  The same weights
   served again under the plan
   without its KV keys (a bf16 cache) must launch K3 once per layer per
   prefill and K4 never.  Each run is held against the same model through
   the plain versions of K1, K3 and K4: finite, non-constant logits; in the
   prefill, every plain layer fed the kernel path's own input lands within
   2% of the largest |output| with at most 2% of its bf16 outputs
   different, and so do the last token's logits and head-input codes taken
   through the plain last layer; every decode step, fed the kernel path's
   token and a copy of its cache, gives bitwise-equal logits (decode runs
   no flash kernel and K1 is bitwise).  The two paths run free through all
   layers are printed per layer (``[drift]`` lines), not held: 8-bit
   requantization carries the flash kernels' sub-ulp differences onward.
9. LM timing at the path's shapes (batch 4, S 1000): K3 and K4 per layer
   and per prefill against their plain versions, ``F.scaled_dot_product_
   attention`` in bf16 (for K4 on the unpacked K/V: it reads unpacked
   bytes) and the bound (bytes over 3.35 TB/s or causal attention FLOPs
   over 989 TFLOP/s, the H100 SXM dense bf16 peak); K1 at the prefill
   and decode shapes, with its route and its share of the bound, beside its
   plain version and one library call for the same product
   (``torch._int_mm`` where it takes the shape, else ``torch.mm`` in f32);
   prefill tokens/s, decode ms per step and the share of a prefill spent
   in K4, K1 and the rest.

10. Speculative decoding, the schedulers and the entry point, at full
   width: (a) ``SpeculativeGenerator`` (k 4, batch 4, the 1000-token
   prompts, 16 new tokens) over two packed views of one granite-8b weight
   draw -- verify ``granite_8b_mixed.json``, draft
   ``granite_8b_draft_w2.json`` -- must emit exactly the tokens of the
   verify-only ``Generator`` (and of phase 8's, on the same draw), launch
   K1 and K4 as often as its cycles call them, and give one verify's
   logits and cache bitwise equal to 5 sequential decode steps on a copy
   of the cache; (b) the ``attn_impl='flash'`` verify launches K4 once a
   layer, whose attention stays within one bf16 ulp of K4's plain version
   and within 3e-2 absolute plus relative of the per-query route; (c)
   ``GenerateScheduler`` (4 slots, 6 requests of 1000 and 500 tokens, n_new
   4/6/8) over the ``Generator`` and over the ``SpeculativeGenerator``:
   every ticket's tokens equal its request served alone; (d)
   ``ImageScheduler`` over the ResNet-18 ``ImageServer`` on 13 single
   images in bursts: every ticket's logits bitwise its image's served
   alone; (e) ``repro_torch.launch.serve.main`` in process for ResNet-18
   and for granite-8b with ``--spec-decode 4``, whose trace and metrics
   dump pass the port's validators.  ``[time]`` lines give speculative
   against verify-only tokens/s, ms a cycle, the accept rate (random
   weights: nothing to learn about a trained draft's acceptance) and the
   scheduler's p50/p99 latency.

11. The design-space exploration and the control plane at full ResNet-18
   width (random weights from SEED): (a) ``weight_ptq_sensitivity`` and
   ``calibration_sensitivity`` (8 random images through the card: the fp
   reference through the fp baseline, each probe through K1/K2, packed
   layers cached by format after one bitwise check against a fresh pack)
   feed ``plan_search`` under the H100 cost model; the frontier rows, the
   chosen plan (which then packs and serves) and the H100 entry beside the
   card's SMs and shared memory (must agree); (b) the fp baseline through
   ``ImageServer`` at buckets 1 and 8 within FP_LOGIT_TOL of a float64 run
   of the same bf16 weights, its bytes against the mixed plan's; (c)
   ``layer_attribution`` of a batch-8 forward timed by CUDA events:
   roofline fraction and achieved TOps/s, and the model's time of each
   conv beside phase 5's measured one with their rank correlation; (d)
   ``examples/frontiers/resnet18_frontier.json`` through
   ``frontier_from_manifest``: every level held to phase 4's contract and
   launch rule, frames/s and measured rel_latency at bucket 8; (e)
   ``SLOScheduler`` over that frontier with seeded faults (transient
   errors, latency spikes, malformed payloads), its deadline SLO_BATCHES
   level-0 batch times: a burst degrades, a trickle recovers, every
   ticket is terminal and every served one bitwise its image served alone
   at its level; (f) ``launch.serve.main`` with ``--frontier``,
   ``--fp-baseline`` and ``--plan --trace --metrics-dump`` (roofline line
   timed by CUDA events; the telemetry validate command on the files);
   (g) granite-8b at full width, first 4 layers, two points drawn once
   behind ``SLOScheduler`` through ``GenerateBackend``: K1 and K4 launched
   as the generate calls need, tickets bitwise their requests served
   alone; (h) the per-layer dataflow the H100 model picks and frames/s at
   buckets 1 and 8 under ``auto`` and with ``implicit`` forced.

Kernel outputs of K1 and K2 are compared bitwise with the plain version run
on the CPU copy of the inputs -- the version the CPU tests hold bitwise
against the JAX package (numeric contract in
``src/repro_torch/kernels/mpmm/epilogue.py``).  K3 and K4 are compared
with their plain versions on the card: f32 accumulation in another order,
so bf16 outputs within one bf16 ulp plus 1e-5 (the f32 tolerance, for
outputs near zero); K4 against K3 on the unpacked cache within 3e-2
absolute plus 3e-2 relative (K3 reads the bf16-rounded values code*s + z,
K4 the exact ones; the reference's own packed-vs-qdq tolerance).  Per-shape
times are printed as ``[time]`` lines.

The last three lines are the kernel summary, the card's name and power
limit, and ``{"ok": true, "device": {...}}``; nothing is printed there
unless every phase passed.
"""
from __future__ import annotations

import dataclasses
import json
import subprocess
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parent
sys.path.insert(0, str(ROOT / "src"))

ARCH = "resnet18"
PLAN = ROOT / "examples" / "plans" / "resnet18_mixed.json"
BUCKETS = (1, 2, 4, 8)
REQUESTS = (1, 3, 8, 13)
TIME_BATCH = 8      # batch of the timed path shapes (the largest bucket)
SMALL_BATCH = 1     # K2's other checked and timed batch (split plans)
CHECK_BATCH = 2     # batch of K2's extra (Sum-Apart, residual) checks
SEED = 0
E2E_LOGIT_TOL = 0.02
E2E_MAX_FLIP_RATE = 0.02
PEAK_BYTES_PER_S = 3.35e12     # H100 SXM HBM3
PEAK_INT8_OPS_PER_S = 1979e12  # H100 SXM dense int8 tensor-core peak
PEAK_BF16_FLOPS_PER_S = 989e12  # H100 SXM dense bf16 tensor-core peak
LM_ARCH = "granite-8b"
LM_PLAN = ROOT / "examples" / "plans" / "granite_8b_mixed.json"
LM_BATCH, LM_PROMPT, LM_NEW = 4, 1000, 16
K3_DEPTH = 4           # the bf16-cache (K3) run: l0-l2 overrides + a default
LM_LOGIT_TOL = 0.02
LM_MAX_FLIP_RATE = 0.02
ATTN_HEADS, ATTN_KV, ATTN_D = 32, 8, 128
K4_VS_K3_TOL = 3e-2
DRAFT_PLAN = ROOT / "examples" / "plans" / "granite_8b_draft_w2.json"
SPEC_K = 4
# (prompt length, n_new) of the GenerateScheduler's six requests
SCHED_TRACE = ((LM_PROMPT, 4), (LM_PROMPT, 8), (500, 6), (LM_PROMPT, 6),
               (500, 4), (500, 8))
SCHED_SLOTS = 4
IMG_BURSTS = (8, 3, 1, 1)  # single images arriving together, 13 in all
FORMATS = [(w, k) for w in (1, 2, 4, 8) for k in (1, 2, 4, 8)]
EPILOGUES = ("none", "bn_relu", "bn_res_relu")
FRONTIER = ROOT / "examples" / "frontiers" / "resnet18_frontier.json"
P11_BATCH = 8        # phase 11's workload and timed batch
CALIB_IMAGES = 8     # calibration_sensitivity's random images
FP_LOGIT_TOL = 0.05  # fp baseline vs float64, of the largest |logit|
SLO_SEED = 11        # FaultInjector's seed in phase 11 (e)
SLO_BATCHES = 6      # the deadline in level-0 batch times
SLO_BURST = 64       # images of phase 11 (e)'s burst
LM_FRONTIER_DEPTH = 4
# (prompt length, n_new) of phase 11 (g)'s requests
LM_FRONTIER_REQS = ((128, 4), (128, 4), (64, 3), (128, 4), (64, 3),
                    (128, 4), (128, 4), (64, 3), (128, 4), (128, 4))


def log(msg: str) -> None:
    print(msg, flush=True)


class Smoke:
    """State of one run: the device, a seeded generator, failures."""

    def __init__(self, torch, device):
        self.torch = torch
        self.device = device
        self.gen = torch.Generator().manual_seed(SEED)
        self.failures = []
        self.max_err = {"mpmm_cuda": 0.0, "conv_mpmm_cuda": 0.0,
                        "flash_fwd_cuda": 0.0, "flash_fwd_packed_cuda": 0.0}

    # --- inputs ---------------------------------------------------------

    def codes(self, shape, lo=-128, hi=128):
        t = self.torch
        return t.randint(lo, hi, shape, generator=self.gen,
                         dtype=t.int32).to(t.int8)

    def weights(self, kdim, n, w_bits, k):
        from repro_torch.core import packing
        t = self.torch
        fmt = packing.PlaneFormat(w_bits=w_bits, k=k, k_dim=kdim)
        w_int = t.randint(-(2 ** (w_bits - 1)), 2 ** (w_bits - 1), (kdim, n),
                          generator=self.gen, dtype=t.int32)
        planes = packing.pack_planes(w_int, fmt)
        colsum = w_int.sum(0, dtype=t.int32).reshape(1, n)
        gamma = (t.rand((1, n), generator=self.gen) * 0.009 + 0.001)
        return fmt, planes, gamma, colsum

    def epilogue(self, kind, out_shape, res_dtype):
        from repro_torch.kernels.mpmm.epilogue import EpilogueSpec
        t = self.torch
        n = out_shape[-1]
        if kind == "none":
            return None, {}
        ops = {"scale": t.rand((1, n), generator=self.gen) + 0.5,
               "shift": t.randn((1, n), generator=self.gen) * 0.3}
        if kind == "bn":
            return EpilogueSpec(bn=True), ops
        if kind == "bn_relu":
            return EpilogueSpec(bn=True, relu=True), ops
        ops["residual"] = t.randn(out_shape, generator=self.gen).to(res_dtype)
        return EpilogueSpec(bn=True, residual=True, relu=True), ops

    def on_device(self, args):
        return {k: (v.to(self.device) if isinstance(v, self.torch.Tensor)
                    else v) for k, v in args.items()}

    # --- comparison -----------------------------------------------------

    def compare(self, kernel_name, label, got, want):
        """Bitwise check of a kernel output against the plain version."""
        t = self.torch
        got = got.cpu()
        if got.shape != want.shape or got.dtype != want.dtype:
            self.failures.append(f"{label}: {got.shape}/{got.dtype} vs "
                                 f"{want.shape}/{want.dtype}")
            return
        diff = (got.to(t.float32) - want.to(t.float32)).abs()
        err = float(diff.max()) if diff.numel() else 0.0
        self.max_err[kernel_name] = max(self.max_err[kernel_name], err)
        if not t.equal(got, want):
            n_bad = int((diff > 0).sum())
            self.failures.append(f"{label}: {n_bad} of {diff.numel()} "
                                 f"differ, max abs err {err}")

    def check_phase(self, name):
        if self.failures:
            for f in self.failures[:40]:
                log(f"  FAIL {f}")
            raise SystemExit(f"{name}: {len(self.failures)} mismatches")
        log(f"[{name}] ok")

    # --- timing ---------------------------------------------------------

    def time_ms(self, fn, reps=20, warmup=3):
        """Mean device time of one call (CUDA events around ``reps``
        back-to-back calls, after ``warmup``; L2-warm)."""
        t = self.torch
        for _ in range(warmup):
            fn()
        t.cuda.synchronize()
        start = t.cuda.Event(enable_timing=True)
        end = t.cuda.Event(enable_timing=True)
        start.record()
        for _ in range(reps):
            fn()
        end.record()
        t.cuda.synchronize()
        return start.elapsed_time(end) / reps

    def graph_ms(self, fn, reps=20, warmup=3):
        """Device time of one call, back to back without the host: ``reps``
        calls captured in a CUDA graph (on a stream of their own, warmed up
        there first), the graph replayed between CUDA events; L2-warm."""
        t = self.torch
        if not hasattr(self, "graph_stream"):
            self.graph_stream = t.cuda.Stream(self.device)
        s = self.graph_stream
        s.wait_stream(t.cuda.current_stream())
        with t.cuda.stream(s):
            for _ in range(warmup):
                fn()
        s.synchronize()
        g = t.cuda.CUDAGraph()
        with t.cuda.graph(g, stream=s):
            for _ in range(reps):
                fn()
        g.replay()
        t.cuda.synchronize()
        start = t.cuda.Event(enable_timing=True)
        end = t.cuda.Event(enable_timing=True)
        start.record()
        g.replay()
        end.record()
        t.cuda.synchronize()
        del g
        return start.elapsed_time(end) / reps


# --- phase 2: K1 -----------------------------------------------------------


def k1_call(sm, m, kdim, n, w_bits, k, epi, variant, out_dtype, act_zero):
    fmt, planes, gamma, colsum = sm.weights(kdim, n, w_bits, k)
    spec, ops = sm.epilogue(epi, (m, n), out_dtype)
    args = dict(a_biased=sm.codes((m, kdim)), planes=planes, gamma=gamma,
                colsum=colsum, **ops)
    kw = dict(fmt=fmt, act_zero=act_zero, variant=variant,
              out_dtype=out_dtype, epilogue=spec)
    return args, kw


K1_ROWS = (100, 4)  # route A (M > 16) and route B (M <= 16)


def phase_k1(sm, path_k1, lm_shapes):
    from repro_torch.kernels.mpmm import kernel, ref
    t = sm.torch
    for m in K1_ROWS:
        route = kernel.mpmm_route(m, 45, 70)
        for w_bits, k in FORMATS:
            for variant in ("st", "sa"):
                # int32 accumulators: gamma = 1, act_zero = 0, f32 out gives
                # float(acc) exactly; held against the oracle's own decode.
                args, kw = k1_call(sm, m, 45, 70, w_bits, k, "none", variant,
                                   t.float32, 0)
                args["gamma"] = t.ones_like(args["gamma"])
                got = kernel.mpmm_cuda(**sm.on_device(args), **kw)
                want = ref.mpmm_ref_codes(args["a_biased"], args["planes"],
                                          kw["fmt"], act_zero=0).to(t.float32)
                sm.compare("mpmm_cuda",
                           f"K1 {route} acc M={m} w{w_bits}k{k} {variant}",
                           got, want)
                for epi in EPILOGUES:
                    for out_dtype in (t.float32, t.bfloat16):
                        args, kw = k1_call(sm, m, 45, 70, w_bits, k, epi,
                                           variant, out_dtype, 128)
                        got = kernel.mpmm_cuda(**sm.on_device(args), **kw)
                        sm.compare("mpmm_cuda",
                                   f"K1 {route} M={m} w{w_bits}k{k} "
                                   f"{variant} {epi} {out_dtype}",
                                   got, kernel.mpmm_torch(**args, **kw))
    for call in path_k1:
        for variant in ("st", "sa"):
            kw = dict(call["kw"], variant=variant)
            got = kernel.mpmm_cuda(**call["dev"], **kw)
            sm.compare("mpmm_cuda", f"K1 path {call['name']} {variant}", got,
                       kernel.mpmm_torch(**call["cpu"], **kw))
    # granite-8b's own prefill and decode shapes, against the plain version
    # on the card (its float64 integer product is exact there too)
    for phase, m, (kdim, n, w_bits, k), _ in lm_shapes:
        d, kw = k1_device_call(sm, m, kdim, n, w_bits, k, seed=m + kdim + n)
        got = kernel.mpmm_cuda(**d, **kw)
        want = kernel.mpmm_torch(**d, **kw)
        sm.compare("mpmm_cuda", f"K1 {kernel.mpmm_route(m, kdim, n)} LM "
                   f"{phase} M={m} K={kdim} N={n} w{w_bits}k{k}", got,
                   want.cpu())
        del d, got, want
    sm.check_phase("K1 mpmm_cuda vs mpmm_torch")


def k1_device_call(sm, m, kdim, n, w_bits, k, seed):
    """A K1 call drawn on the card (bf16 out, no epilogue): the LM shapes
    are too large to draw and pack on the host."""
    from repro_torch.core import packing
    t = sm.torch
    g = t.Generator(device=sm.device).manual_seed(seed)
    fmt = packing.PlaneFormat(w_bits=w_bits, k=k, k_dim=kdim)
    w_int = t.randint(-(2 ** (w_bits - 1)), 2 ** (w_bits - 1), (kdim, n),
                      generator=g, device=sm.device, dtype=t.int32)
    d = dict(a_biased=t.randint(-128, 128, (m, kdim), generator=g,
                                device=sm.device, dtype=t.int32).to(t.int8),
             planes=packing.pack_planes(w_int, fmt),
             gamma=t.rand((1, n), generator=g, device=sm.device) * 0.009
             + 0.001,
             colsum=w_int.sum(0, dtype=t.int32).reshape(1, n))
    return d, dict(fmt=fmt, act_zero=128, variant="st",
                   out_dtype=t.bfloat16, epilogue=None)


# --- phase 3: K2 -----------------------------------------------------------


def resnet_convs(cfg, plan):
    """The serve path's convs routed to K2, in order: (name, cin, cout,
    kernel, stride, h_in, w_bits, k, epilogue)."""
    from repro_torch.models import resnet as R
    out = []
    h = cfg.img_size // 4  # stem stride 2, max-pool stride 2
    for si, bi, cin, cmid, stride in R._block_channels(cfg):
        key = f"s{si}b{bi}"
        ho = -(-h // stride)
        layers = []
        if stride != 1 or cin != cmid:
            layers.append((key + "p", cin, cmid, 1, stride, h, "bn"))
        layers.append((key + "c1", cin, cmid, 3, stride, h, "bn_relu"))
        layers.append((key + "c2", cmid, cmid, 3, 1, ho, "bn_res_relu"))
        for name, ci, co, kk, s, hi, epi in layers:
            pol = plan.policy_for(name)
            out.append((name, ci, co, kk, s, hi, pol.bits_for("inner"), pol.k,
                        epi))
        h = ho
    return out


def k2_call(sm, batch, conv, epi, variant):
    """A K2 call at one of the path's convs: CPU and device operands (the
    unpadded input) and its keywords."""
    name, cin, cout, kk, stride, h, w_bits, k, _ = conv
    fmt, planes, gamma, colsum = sm.weights(kk * kk * cin, cout, w_bits, k)
    ho = -(-h // stride)
    spec, ops = sm.epilogue(epi, (batch, ho, ho, cout), sm.torch.bfloat16)
    kw = dict(fmt=fmt, act_zero=128, kh=kk, kw=kk, stride=stride,
              padding="SAME", variant=variant, out_dtype=sm.torch.bfloat16,
              epilogue=spec)
    cpu = dict(a_biased=sm.codes((batch, h, h, cin)), planes=planes,
               gamma=gamma, colsum=colsum, **ops)
    return cpu, sm.on_device(cpu), kw


def phase_k2(sm, convs):
    """Each conv at the path's batch and at batch 1 with its path
    epilogue, and at a small batch with Sum-Apart and the residual
    epilogue; then the formats the path's plan does not use, k > w among
    them, at two of its convs (N tiles 64 and 128; batch 1 splits)."""
    from repro_torch.kernels.mpmm import conv_kernel
    cases = [(conv, batch, epi, variant) for conv in convs
             for batch, epi, variant in ((TIME_BATCH, conv[-1], "st"),
                                         (SMALL_BATCH, conv[-1], "st"),
                                         (CHECK_BATCH, "bn_res_relu", "sa"))]
    path_formats = {conv[6:8] for conv in convs}
    for w_bits, k in FORMATS:
        if (w_bits, k) in path_formats:
            continue
        for conv in (convs[0], convs[5]):  # s0b0c1 (N 64), s1b0c1 (N 128)
            conv = conv[:6] + (w_bits, k) + conv[8:]
            cases += [(conv, SMALL_BATCH, conv[-1], "st"),
                      (conv, CHECK_BATCH, "bn_res_relu", "sa")]
    for conv, batch, epi, variant in cases:
        cpu, dev, kw = k2_call(sm, batch, conv, epi, variant)
        got = conv_kernel.conv_mpmm_cuda(**dev, **kw)
        want = conv_kernel.conv_mpmm_torch(**cpu, **kw)
        sm.compare("conv_mpmm_cuda", f"K2 {conv[0]} w{conv[6]}k{conv[7]} "
                   f"B={batch} {epi} {variant}", got, want)
    sm.check_phase("K2 conv_mpmm_cuda vs conv_mpmm_torch")


# --- phase 4: end to end ----------------------------------------------------


def phase_end_to_end(sm):
    import numpy as np
    from repro_torch import configs
    from repro_torch.core.plan import PrecisionPlan
    from repro_torch.kernels.mpmm import conv_kernel, kernel, ops
    from repro_torch.models import resnet as R
    from repro_torch.runtime.serve import ImageServer
    t = sm.torch
    api = configs.get(ARCH)
    plan = PrecisionPlan.load(PLAN)
    cfg = api.cfg
    t0 = time.perf_counter()
    params = api.init_params(sm.gen, device=sm.device)
    state = R.init_bn_state(api.specs(), device=sm.device)
    packed = R.pack_for_serve(cfg, params, state, plan)
    server = ImageServer(api=api, params=packed, batch_buckets=BUCKETS,
                         plan=plan, device=sm.device)
    plain = ImageServer(api=api, params=packed, batch_buckets=BUCKETS,
                        plan=plan, device=sm.device, impl="torch")
    log(f"[e2e] {cfg.name}: {cfg.img_size}x{cfg.img_size}, width "
        f"{cfg.width}, {cfg.n_classes} classes, plan {plan.name}; packed "
        f"in {time.perf_counter() - t0:.2f} s")
    rng = np.random.default_rng(SEED)
    requests = [rng.normal(0, 1, (n, cfg.img_size, cfg.img_size, 3))
                .astype(np.float32) for n in REQUESTS]

    # The expected launches come from the layers' own dataflow choices at
    # each bucket's batch (the H100 cost model under 'auto').
    buckets = [b for n in REQUESTS for b in bucket_calls(server, n)]
    want, want_routes = {}, dict.fromkeys(kernel.ROUTES, 0)
    for b in buckets:
        w, r, flows = resnet_launches(cfg, plan, b)
        want = add_counts(want, w)
        want_routes = add_counts(want_routes, r)
        log(f"[e2e] bucket {b}: K1 {w['mpmm_cuda']} (routes {r}), K2 "
            f"{w['conv_mpmm_cuda']}; im2col convs "
            f"{[k for k, f in flows.items() if f == 'im2col']}")
    reset_counts()
    outs = [server.predict(x) for x in requests]
    t.cuda.synchronize()
    launches = {"mpmm_cuda": kernel.mpmm_cuda.launches,
                "conv_mpmm_cuda": conv_kernel.conv_mpmm_cuda.launches}
    log(f"[e2e] {len(buckets)} bucket calls {buckets}, launches {launches}, "
        f"compiled buckets {server.compiled_buckets}")
    routes = dict(kernel.mpmm_cuda.routes)
    log(f"[e2e] K1 routes {routes}")
    if launches != want or routes != want_routes:
        raise SystemExit(f"launch counts {launches} / routes {routes} != the "
                         f"layers' choices {want} / {want_routes}")

    for n, x, y in zip(REQUESTS, requests, outs):
        if y.shape != (n, cfg.n_classes) or not np.isfinite(y).all():
            raise SystemExit(f"request of {n}: logits {y.shape}, finite "
                             f"{np.isfinite(y).all()}")
        if float(y.std()) == 0.0:
            raise SystemExit(f"request of {n}: constant logits")
        ref_y = plain.predict(x)
        tol = E2E_LOGIT_TOL * float(np.abs(ref_y).max())
        err = float(np.abs(y - ref_y).max())
        # Flipped classifier-input codes between the two feature paths.
        xt = t.from_numpy(x[:min(n, BUCKETS[-1])]).to(sm.device)
        f_k = R.serve_features(cfg, server.params, xt, plan)
        f_p = R.serve_features(cfg, server.params, xt, plan, impl="torch")
        ga = server.params["fc"]["ga"]
        flips = float((ops.quantize_activations(f_k, ga)
                       != ops.quantize_activations(f_p, ga)).float().mean())
        log(f"[e2e] request {n}: logits {y.shape}, max |kernel - plain| "
            f"{err} (tol {tol}), identical {bool((y == ref_y).all())}, "
            f"flipped fc-input codes {flips}")
        if err > tol or flips > E2E_MAX_FLIP_RATE:
            raise SystemExit(f"request of {n}: outside the end-to-end "
                             f"contract")
    log("[e2e] ok")
    return server, cfg, plan, launches, routes


def frames_per_second(sm, server, cfg):
    import numpy as np
    rng = np.random.default_rng(SEED + 1)
    fps = {}
    for b in BUCKETS:
        x = rng.normal(0, 1, (b, cfg.img_size, cfg.img_size, 3)).astype(
            np.float32)
        server.predict(x)
        server.predict(x)
        reps = 10
        t0 = time.perf_counter()
        for _ in range(reps):
            server.predict(x)  # returns host numpy: synchronized
        fps[b] = b * reps / (time.perf_counter() - t0)
    return fps


# --- phase 5: timing at the path's shapes ------------------------------------


def path_k1_calls(sm, cfg, plan, batch):
    """K1's two launches per forward: the stem as im2col, the classifier."""
    t = sm.torch
    calls = []
    hw = cfg.img_size // 2
    stem_pol = plan.policy_for("stem")
    fc_pol = plan.policy_for("fc")
    for name, m, kdim, n, pol, epi, az in (
            ("stem", batch * hw * hw, 147, cfg.width, stem_pol, "bn_relu", 0),
            ("fc", batch, cfg.fc_in, cfg.n_classes, fc_pol, "none", 128)):
        cpu, kw = k1_call(sm, m, kdim, n, pol.bits_for("boundary"), pol.k,
                          epi, "st", t.bfloat16, az)
        calls.append({"name": name, "cpu": cpu, "dev": sm.on_device(cpu),
                      "kw": kw, "m": m, "k": kdim, "n": n})
    return calls


def nbytes(*tensors):
    return sum(x.numel() * x.element_size() for x in tensors if x is not None)


def bound_ms(bytes_moved, ops_done):
    tb = bytes_moved / PEAK_BYTES_PER_S * 1e3
    to = ops_done / PEAK_INT8_OPS_PER_S * 1e3
    return (tb, "bytes") if tb >= to else (to, "operations")


def k1_library(sm, d, fmt):
    """K1's yardstick: one PyTorch call for the same product on the
    combined int8 weights -> (callable, its name)."""
    from repro_torch.kernels.mpmm import ref
    t = sm.torch
    a = d["a_biased"]
    w8 = ref.combined_int8_weights(d["planes"], fmt)
    (m, kdim), n = a.shape, w8.shape[1]
    if m > 16 and kdim % 8 == 0 and n % 8 == 0:
        try:
            t._int_mm(a, w8)
            return (lambda: t._int_mm(a, w8)), "torch._int_mm (int8)"
        except RuntimeError as e:  # a cuBLASLt refusal: the f32 yardstick
            log(f"[time] torch._int_mm refuses M={m} K={kdim} N={n}: {e}")
    # _int_mm needs M > 16 and K, N multiples of 8
    af, wf = a.float(), w8.float()
    return (lambda: t.mm(af, wf)), "torch.mm (f32, TF32 off)"


def measure(sm, path_k1, convs):
    from repro_torch.kernels.mpmm import kernel
    t = sm.torch
    t.backends.cuda.matmul.allow_tf32 = False
    t.backends.cudnn.allow_tf32 = False
    rows = []
    for call in path_k1:
        d, kw = call["dev"], call["kw"]
        out = kernel.mpmm_cuda(**d, **kw)
        m, kdim, n = call["m"], call["k"], call["n"]
        lib, lib_name = k1_library(sm, d, kw["fmt"])
        by = nbytes(d["a_biased"], d["planes"], d["gamma"], d["colsum"],
                    d.get("scale"), d.get("shift"), d.get("residual"), out)
        b_ms, b_by = bound_ms(by, 2 * m * n * kdim)
        rows.append({
            "kernel": "mpmm_cuda", "layer": call["name"],
            "route": kernel.mpmm_route(m, kdim, n),
            "shape": f"M={m} K={kdim} N={n} w{kw['fmt'].w_bits}k{kw['fmt'].k}",
            "ms": sm.time_ms(lambda: kernel.mpmm_cuda(**d, **kw)),
            "plain_ms": sm.time_ms(lambda: kernel.mpmm_torch(**d, **kw)),
            "library_ms": sm.time_ms(lib), "library": lib_name,
            "bound_ms": b_ms, "bound_by": b_by, "bytes": by,
            "ops": 2 * m * n * kdim})
    for batch in (TIME_BATCH, SMALL_BATCH):
        rows += [measure_k2(sm, batch, conv) for conv in convs]
    return rows


def measure_k2(sm, batch, conv):
    """One K2 row: the kernel on the unpadded input, its plain version,
    ``F.conv2d`` in f32 on the padded input, the bound and the plan.  The
    kernel and ``F.conv2d`` are timed on the device (``graph_ms``): a K2
    call costs the host more than the device (``call_ms``, call after
    call), which would time the wrapper, not the kernel."""
    from repro_torch.kernels.mpmm import conv_kernel, ref
    t = sm.torch
    _, dev, kw = k2_call(sm, batch, conv, conv[-1], "st")
    out = conv_kernel.conv_mpmm_cuda(**dev, **kw)
    name, cin, cout, kk, stride = conv[:5]
    xp = ref.pad_spatial(dev["a_biased"], kk, kk, stride, "SAME", fill=-128)
    xf = xp.permute(0, 3, 1, 2).float().contiguous(
        memory_format=t.channels_last)
    wf = (ref.combined_int8_weights(dev["planes"], kw["fmt"])
          .reshape(kk, kk, cin, cout).permute(3, 2, 0, 1).float()
          .contiguous(memory_format=t.channels_last))
    _, ho, wo, _ = out.shape
    m = batch * ho * wo
    kdim = kk * kk * cin
    plan = conv_kernel.conv_plan(batch, ho, wo, cout, kdim, kw["fmt"])
    by = nbytes(dev["a_biased"], dev["planes"], dev["gamma"], dev["colsum"],
                dev.get("scale"), dev.get("shift"), dev.get("residual"), out)
    b_ms, b_by = bound_ms(by, 2 * m * cout * kdim)
    return {
        "kernel": "conv_mpmm_cuda", "layer": name, "batch": batch,
        "shape": (f"B={batch} H={conv[5]} C={cin} N={cout} "
                  f"{kk}x{kk}/{stride} w{conv[6]}k{conv[7]} {conv[-1]}"),
        "plan": (f"tile {plan.bm}x{plan.bn}, {plan.splits} split(s) of "
                 f"{plan.steps} K-step(s) ({plan.k_steps} in all), "
                 f"{plan.blocks} blocks"),
        "ms": sm.graph_ms(lambda: conv_kernel.conv_mpmm_cuda(**dev, **kw)),
        "call_ms": sm.time_ms(lambda: conv_kernel.conv_mpmm_cuda(**dev,
                                                                 **kw)),
        "plain_ms": sm.time_ms(lambda: conv_kernel.conv_mpmm_torch(
            **dev, **kw)),
        "library_ms": sm.graph_ms(lambda: t.nn.functional.conv2d(
            xf, wf, stride=stride)),
        "library": "F.conv2d (f32, TF32 off, channels_last)",
        "bound_ms": b_ms, "bound_by": b_by, "bytes": by,
        "ops": 2 * m * cout * kdim}


def k2_build_info(convs):
    """[build] lines for the K2 instantiations the path runs, and for the
    k > w formats at both N tiles: dynamic shared memory and resident
    blocks an SM."""
    from repro_torch.core.packing import PlaneFormat
    from repro_torch.kernels.mpmm import conv_kernel
    keys = [(w_bits, k, variant, conv_kernel.n_tile(cout))
            for _, _, cout, _, _, _, w_bits, k, _ in convs
            for variant in ("st", "sa")]
    keys += [(w_bits, k, variant, bn) for w_bits, k in FORMATS if k > w_bits
             for variant in ("st", "sa") for bn in conv_kernel.N_TILES]
    for key in dict.fromkeys(keys):
        w_bits, k, variant, bn = key
        fmt = PlaneFormat(w_bits=w_bits, k=k, k_dim=1152)
        smem, blocks = conv_kernel.kernel_info(fmt, variant, bn)
        log(f"[build] conv_mpmm: w{w_bits}k{k} {variant} N tile {bn}: "
            f"{smem} bytes of dynamic shared memory, {blocks} block(s) an "
            f"SM")


# --- phases 6-7: K3 and K4 -----------------------------------------------------


def bf16_ulp(t, x):
    """Spacing of bf16 values at |x| (8 significant bits)."""
    _, e = t.frexp(x.abs().clamp_min(2.0 ** -126))
    return t.ldexp(t.ones_like(x), e - 8)


def compare_close(sm, kernel_name, label, got, want, tol=None):
    """A flash kernel's output against another version of the same function
    on the card: bf16 within one ulp of the larger value plus 1e-5 (the f32
    tolerance: outputs near zero come from cancelling sums, more so in K4's
    affine scores), or within ``tol`` absolute plus ``tol`` relative.  Only
    comparisons with the plain version (tol None) enter the kernel's
    max_abs_err."""
    t = sm.torch
    if got.shape != want.shape or got.dtype != want.dtype:
        sm.failures.append(f"{label}: {tuple(got.shape)}/{got.dtype} vs "
                           f"{tuple(want.shape)}/{want.dtype}")
        return 0.0
    g, w = got.float(), want.float()
    err = (g - w).abs()
    if tol is None:
        bound = bf16_ulp(t, t.maximum(g.abs(), w.abs())) + 1e-5
    else:
        bound = tol + tol * w.abs()
    max_err = float(err.max())
    if tol is None:
        sm.max_err[kernel_name] = max(sm.max_err[kernel_name], max_err)
    n_bad = int((err > bound).sum())
    if n_bad:
        sm.failures.append(f"{label}: {n_bad} of {err.numel()} outside the "
                           f"tolerance, max abs err {max_err}")
    return max_err


def attn_inputs(sm, b, sq, sk, seed):
    """bf16 q (B, Sq, H, D) and k, v (B, Sk, KV, D) at granite's heads."""
    t = sm.torch
    g = t.Generator(device=sm.device).manual_seed(seed)
    mk = lambda s, h: t.randn((b, s, h, ATTN_D), generator=g,  # noqa: E731
                              device=sm.device).to(t.bfloat16)
    return mk(sq, ATTN_HEADS), mk(sk, ATTN_KV), mk(sk, ATTN_KV)


K3_CASES = [dict(sq=1000, sk=1000), dict(sq=1024, sk=1024),
            dict(sq=1024, sk=1024, window=256),
            dict(sq=8, sk=1024, q_offset=1016),
            dict(sq=9, sk=1024, q_offset=1015),
            dict(sq=1000, sk=1000, causal=False)]


def phase_k3(sm, block_k):
    from repro_torch.kernels.flashattn import ops as fops
    for i, case in enumerate(K3_CASES):
        kw = {k: v for k, v in case.items() if k not in ("sq", "sk")}
        q, k, v = attn_inputs(sm, LM_BATCH, case["sq"], case["sk"], 100 + i)
        got = fops.flash_attention(q, k, v, block_k=block_k, impl="cuda",
                                   **kw)
        want = fops.flash_attention(q, k, v, block_k=block_k, impl="torch",
                                    **kw)
        sm.torch.cuda.synchronize()
        err = compare_close(sm, "flash_fwd_cuda", f"K3 {case}", got, want)
        log(f"[K3] {case}: max abs err vs plain {err}")
    sm.check_phase("K3 flash_fwd_cuda vs flash_fwd_torch")


K4_CASES = [((2, 2), (2, 2), dict(sq=1000, sk=1000)),
            ((4, 4), (4, 4), dict(sq=1000, sk=1000)),
            ((8, 4), (8, 4), dict(sq=1000, sk=1000)),
            ((2, 2), (4, 4), dict(sq=1024, sk=1024)),
            ((8, 4), (2, 2), dict(sq=8, sk=1024, q_offset=1016)),
            ((2, 2), (4, 4), dict(sq=9, sk=1024, q_offset=1015))]


def phase_k4(sm, block_k):
    from repro_torch.kernels.flashattn import ops as fops
    from repro_torch.nn import kvcache
    for i, (fk, fv, case) in enumerate(K4_CASES):
        kw = {k: v for k, v in case.items() if k not in ("sq", "sk")}
        q, k, v = attn_inputs(sm, LM_BATCH, case["sq"], case["sk"], 200 + i)
        fmt_k = kvcache.KVFormat(*fk, ATTN_D)
        fmt_v = kvcache.KVFormat(*fv, ATTN_D)
        kq, vq = kvcache.pack_kv(k, fmt_k), kvcache.pack_kv(v, fmt_v)
        got = fops.flash_attention_packed(q, kq, vq, fmt_k, fmt_v,
                                          block_k=block_k, impl="cuda", **kw)
        want = fops.flash_attention_packed(q, kq, vq, fmt_k, fmt_v,
                                           block_k=block_k, impl="torch",
                                           **kw)
        k3 = fops.flash_attention(q, kvcache.unpack_kv(kq, fmt_k),
                                  kvcache.unpack_kv(vq, fmt_v),
                                  block_k=block_k, impl="cuda", **kw)
        sm.torch.cuda.synchronize()
        label = f"K4 k{fk} v{fv} {case}"
        err = compare_close(sm, "flash_fwd_packed_cuda", label, got, want)
        err_k3 = compare_close(sm, "flash_fwd_packed_cuda", label + " vs K3",
                               got, k3, tol=K4_VS_K3_TOL)
        log(f"[K4] kv bits/slice k{fk} v{fv} {case}: max abs err vs plain "
            f"{err}, vs K3 on the unpacked cache {err_k3} (tol "
            f"{K4_VS_K3_TOL} absolute + relative)")
    sm.check_phase("K4 flash_fwd_packed_cuda vs flash_fwd_packed_torch "
                   "and vs K3")


# --- phase 8: the LM end to end -----------------------------------------------


COUNTED = (("mpmm_cuda", "repro_torch.kernels.mpmm.kernel"),
           ("conv_mpmm_cuda", "repro_torch.kernels.mpmm.conv_kernel"),
           ("flash_fwd_cuda", "repro_torch.kernels.flashattn.kernel"),
           ("flash_fwd_packed_cuda", "repro_torch.kernels.flashattn.kernel"))


def reset_counts():
    import importlib
    from repro_torch.kernels.mpmm import kernel
    for name, mod in COUNTED:
        getattr(importlib.import_module(mod), name).launches = 0
    kernel.mpmm_cuda.routes = dict.fromkeys(kernel.ROUTES, 0)


def read_counts():
    import importlib
    return {name: getattr(importlib.import_module(mod), name).launches
            for name, mod in COUNTED}


def lm_api(depth, plan):
    """granite-8b at full width under ``plan``; ``depth`` keeps the first
    layers (None: all of them)."""
    from repro_torch import configs
    api = configs.get(LM_ARCH)
    cfg = dataclasses.replace(api.cfg, n_layers=depth or api.cfg.n_layers)
    return dataclasses.replace(api, cfg=cfg, policy=plan)


def clone_tree(tree):
    if isinstance(tree, dict):
        return {k: clone_tree(v) for k, v in tree.items()}
    if isinstance(tree, (tuple, list)):
        return type(tree)(clone_tree(v) for v in tree)
    return tree.clone()


def prefill_contract(sm, api, params, prompts, label):
    """The prefill, layer by layer.  One-layer error: each plain layer fed
    the kernel path's own input, against the kernel layer -- held to
    ``LM_LOGIT_TOL`` of the largest |output| and ``LM_MAX_FLIP_RATE`` of
    differing bf16 outputs, and so are the last token's logits and head-
    input codes taken through the plain last layer.  Carried drift: each
    path fed its own previous output, printed per layer as ``[drift]``
    lines (8-bit requantization carries any sub-ulp difference onward)."""
    from repro_torch.kernels.mpmm import ops
    from repro_torch.models import transformer as T
    t = sm.torch
    cfg, plan = api.cfg, api.policy
    kv = T.kv_formats(cfg, plan)
    store, fmts = kv if kv is not None else ("packed", [None] * cfg.n_layers)
    ga = params["head"]["ga"]

    def stats(a, b):
        a, b = a.float(), b.float()
        return (float((a - b).abs().max()) / float(a.abs().max()),
                float((a != b).float().mean()))

    def flips(a, b):
        return float((ops.quantize_activations(T._head_input(cfg, params, a),
                                               ga)
                      != ops.quantize_activations(
                          T._head_input(cfg, params, b), ga)).float().mean())

    worst = [0.0, 0.0]
    with t.inference_mode():
        tt = t.as_tensor(prompts, device=sm.device)
        x_k = x_p = T._embed(params, tt)
        sin, cos = T._rotary(cfg, T._positions(LM_BATCH, LM_PROMPT, 0,
                                                sm.device))
        for i, lp in enumerate(params["layers"]):
            kw = dict(lname=f"l{i}.", kv_fmts=fmts[i], kv_store=store)
            y_k, _ = T._layer_fwd(cfg, lp, x_k, plan, sin, cos, impl="cuda",
                                  **kw)
            y_1, _ = T._layer_fwd(cfg, lp, x_k, plan, sin, cos,
                                  impl="torch", **kw)
            y_p, _ = T._layer_fwd(cfg, lp, x_p, plan, sin, cos,
                                  impl="torch", **kw)
            rel, diff = stats(y_k, y_1)
            c_rel, c_diff = stats(y_k, y_p)
            log(f"[drift] {label} layer {i}: one-layer {rel:.6f} of the "
                f"largest |output|, {diff:.6f} of outputs differ; carried "
                f"{c_rel:.6f}, {c_diff:.6f}")
            worst = [max(worst[0], rel), max(worst[1], diff)]
            if rel > LM_LOGIT_TOL or diff > LM_MAX_FLIP_RATE:
                raise SystemExit(f"{label} layer {i}: one-layer error "
                                 f"{rel:.5f} of the largest |output|, "
                                 f"{diff:.5f} of outputs differ (tol "
                                 f"{LM_LOGIT_TOL}, {LM_MAX_FLIP_RATE})")
            x_k, x_p = y_k, y_p
        last = (x_k[:, -1:], y_1[:, -1:], x_p[:, -1:])
        l_k = T._head(cfg, params, last[0], plan, "cuda")
        l_1 = T._head(cfg, params, last[1], plan, "torch")
        l_p = T._head(cfg, params, last[2], plan, "torch")
    out = {"layer_rel": worst[0], "layer_diff": worst[1],
           "logits_rel": stats(l_k, l_1)[0], "flips": flips(last[0], last[1]),
           "carried_rel": stats(l_k, l_p)[0],
           "carried_flips": flips(last[0], last[2])}
    if out["logits_rel"] > LM_LOGIT_TOL or out["flips"] > LM_MAX_FLIP_RATE:
        raise SystemExit(f"{label}: last-token logits {out['logits_rel']:.5f}"
                         f" of the largest |logit| apart, {out['flips']} "
                         f"head-input codes flipped")
    return out


def decode_contract(sm, gen, plain, prompts, toks, label):
    """Every decode step, teacher-forced: the plain path runs on a copy of
    the kernel path's own cache with the kernel path's token; decode has no
    flash kernel and K1 is bitwise, so the logits must be equal."""
    t = sm.torch
    with t.inference_mode():
        logits, pre = gen.prefill(t.as_tensor(prompts, device=sm.device))
        cache = gen._grow_cache(pre, LM_BATCH, LM_PROMPT,
                                LM_PROMPT + LM_NEW)
        for i in range(LM_NEW - 1):
            feed = t.as_tensor(toks[:, i:i + 1], device=sm.device)
            l_p, _ = plain.decode(clone_tree(cache), feed, LM_PROMPT + i)
            l_k, cache = gen.decode(cache, feed, LM_PROMPT + i)
            if not t.equal(l_k, l_p):
                err = float((l_k.float() - l_p.float()).abs().max())
                raise SystemExit(f"{label} decode step {i}: kernel and plain "
                                 f"logits differ (max {err})")


def serve_lm(sm, api, params, prompts, label, expect):
    """One Generator run through the kernels, counted; then the contract
    against the same model through the plain versions."""
    import numpy as np
    from repro_torch.runtime.serve import Generator
    t = sm.torch
    depth = api.cfg.n_layers
    gen = Generator(api, params, device=sm.device)
    plain = Generator(api, params, device=sm.device, impl="torch")
    reset_counts()
    t0 = time.perf_counter()
    toks, logits = gen.run(prompts, LM_NEW)
    t.cuda.synchronize()
    wall = time.perf_counter() - t0
    launches = read_counts()
    from repro_torch.kernels.mpmm import kernel
    routes = dict(kernel.mpmm_cuda.routes)
    want = dict(expect, mpmm_cuda=(7 * depth + 1) * LM_NEW, conv_mpmm_cuda=0)
    # the prefill's projections on route A, its head and every decode
    # step's projections and head on route B
    want_routes = {"wgmma": 7 * depth,
                   "splitk": 1 + (LM_NEW - 1) * (7 * depth + 1)}
    log(f"[lm] {label}: depth {depth}, {LM_BATCH} prompts x {LM_PROMPT} "
        f"tokens, {LM_NEW} new tokens in {wall:.2f} s (1 prefill + "
        f"{LM_NEW - 1} decode steps); launches {launches}; K1 routes "
        f"{routes}")
    if launches != want:
        raise SystemExit(f"{label}: launch counts {launches} != {want}")
    if routes != want_routes:
        raise SystemExit(f"{label}: K1 routes {routes} != {want_routes}")
    for step, a in enumerate(logits):
        a = a.float()
        if a.shape != (LM_BATCH, api.cfg.vocab) or not bool(
                t.isfinite(a).all()) or float(a.std()) == 0.0:
            raise SystemExit(f"{label} step {step}: logits {tuple(a.shape)} "
                             f"not finite or constant")
    pc = prefill_contract(sm, api, params, prompts, label)
    decode_contract(sm, gen, plain, prompts, toks, label)
    log(f"[lm] {label}: tokens[0] {toks[0].tolist()}; prefill one-layer "
        f"error <= {pc['layer_rel']:.5f} of the largest |output|, <= "
        f"{pc['layer_diff']:.5f} of outputs differ; last-token logits "
        f"{pc['logits_rel']:.5f}, head-input flips {pc['flips']:.5f} (tol "
        f"{LM_LOGIT_TOL}, {LM_MAX_FLIP_RATE}); {LM_NEW - 1} decode steps "
        f"bitwise equal; carried through {depth} layers: logits "
        f"{pc['carried_rel']:.5f}, head-input flips "
        f"{pc['carried_flips']:.5f}")
    return {"launches": launches, "routes": routes,
            "tokens": np.asarray(toks), "wall": wall, "contract": pc}


def phase_lm(sm):
    import numpy as np
    from repro_torch.core.plan import PrecisionPlan, strip_kv
    from repro_torch.runtime.serve import init_packed_lm
    t = sm.torch
    plan = PrecisionPlan.load(LM_PLAN)
    api = lm_api(None, plan)
    cfg = api.cfg
    depth = cfg.n_layers
    t0 = time.perf_counter()
    params = init_packed_lm(api, t.Generator(device=sm.device).manual_seed(
        SEED), device=sm.device)
    t.cuda.synchronize()
    log(f"[lm] {cfg.name}: d_model {cfg.d_model}, {cfg.n_heads} heads, "
        f"{cfg.n_kv} KV heads, head_dim {cfg.hd}, d_ff {cfg.d_ff}, vocab "
        f"{cfg.vocab}, depth {depth}, plan {plan.name}; drawn and "
        f"packed layer by layer in {time.perf_counter() - t0:.2f} s, "
        f"{t.cuda.memory_allocated() / 2**30:.2f} GiB on the card")
    prompts = np.random.default_rng(SEED).integers(0, cfg.vocab,
                                                   (LM_BATCH, LM_PROMPT))
    run = serve_lm(sm, api, params, prompts, "packed KV cache (K4)",
                   {"flash_fwd_packed_cuda": depth, "flash_fwd_cuda": 0})
    api3 = lm_api(K3_DEPTH, strip_kv(plan))
    params3 = dict(params, layers=params["layers"][:K3_DEPTH])
    run3 = serve_lm(sm, api3, params3, prompts, "bf16 KV cache (K3)",
                    {"flash_fwd_packed_cuda": 0, "flash_fwd_cuda": K3_DEPTH})
    log("[lm] ok")
    return api, params, prompts, run, run3


# --- phase 9: LM timing -------------------------------------------------------


def causal_pairs(sq, sk, q_offset=0):
    """(query, key) pairs a causal mask leaves: sum_i min(q_offset+i+1, Sk)."""
    return sum(min(q_offset + i + 1, sk) for i in range(sq))


def attn_bound(bytes_moved, pairs, b):
    tb = bytes_moved / PEAK_BYTES_PER_S * 1e3
    to = 4 * b * ATTN_HEADS * ATTN_D * pairs / PEAK_BF16_FLOPS_PER_S * 1e3
    return (tb, "bytes") if tb >= to else (to, "operations")


def sdpa_call(sm, q, k, v):
    """The library yardstick: F.scaled_dot_product_attention in bf16,
    causal, GQA by enable_gqa (or K/V heads expanded beforehand)."""
    t = sm.torch
    F = t.nn.functional
    qt, kt, vt = (x.transpose(1, 2).contiguous() for x in (q, k, v))
    try:
        F.scaled_dot_product_attention(qt, kt, vt, is_causal=True,
                                       enable_gqa=True)
        return (lambda: F.scaled_dot_product_attention(
            qt, kt, vt, is_causal=True, enable_gqa=True)), "enable_gqa"
    except TypeError:
        g = ATTN_HEADS // ATTN_KV
        ke, ve = (x.repeat_interleave(g, dim=1) for x in (kt, vt))
        return (lambda: F.scaled_dot_product_attention(
            qt, ke, ve, is_causal=True)), "K/V heads expanded"


def measure_attention(sm, api):
    """K3 and K4 per layer at the path's prefill shapes, and summed per
    prefill (K4 over the plan's per-layer cache formats)."""
    from collections import Counter
    from repro_torch.kernels.flashattn import ops as fops
    from repro_torch.models import transformer as T
    from repro_torch.nn import kvcache
    t = sm.torch
    block_k = api.cfg.attn_chunk
    q, k, v = attn_inputs(sm, LM_BATCH, LM_PROMPT, LM_PROMPT, 300)
    pairs = causal_pairs(LM_PROMPT, LM_PROMPT)
    rows = []
    out = fops.flash_attention(q, k, v, block_k=block_k, impl="cuda")
    lib, lib_how = sdpa_call(sm, q, k, v)
    b_ms, b_by = attn_bound(nbytes(q, k, v, out), pairs, LM_BATCH)
    rows.append({
        "kernel": "flash_fwd_cuda", "layer": "any", "count": K3_DEPTH,
        "shape": f"B={LM_BATCH} S={LM_PROMPT} H={ATTN_HEADS} KV={ATTN_KV} "
                 f"D={ATTN_D} bf16 causal",
        "ms": sm.time_ms(lambda: fops.flash_attention(
            q, k, v, block_k=block_k, impl="cuda"), reps=10),
        "plain_ms": sm.time_ms(lambda: fops.flash_attention(
            q, k, v, block_k=block_k, impl="torch"), reps=3, warmup=1),
        "library_ms": sm.time_ms(lib, reps=10),
        "library": f"F.scaled_dot_product_attention bf16 causal ({lib_how})",
        "bound_ms": b_ms, "bound_by": b_by})
    fmts = Counter(
        tuple((f.bits, f.k) for f in pair)
        for pair in T.kv_formats(api.cfg, api.policy)[1])
    for (fk, fv), count in sorted(fmts.items()):
        fmt_k = kvcache.KVFormat(*fk, ATTN_D)
        fmt_v = kvcache.KVFormat(*fv, ATTN_D)
        kq, vq = kvcache.pack_kv(k, fmt_k), kvcache.pack_kv(v, fmt_v)
        kd, vd = kvcache.unpack_kv(kq, fmt_k), kvcache.unpack_kv(vq, fmt_v)
        run = lambda impl: fops.flash_attention_packed(  # noqa: E731
            q, kq, vq, fmt_k, fmt_v, block_k=block_k, impl=impl)
        out = run("cuda")
        lib, lib_how = sdpa_call(sm, q, kd, vd)
        b_ms, b_by = attn_bound(nbytes(q, *kq.values(), *vq.values(), out),
                                pairs, LM_BATCH)
        rows.append({
            "kernel": "flash_fwd_packed_cuda", "layer": f"k{fk} v{fv}",
            "count": count,
            "shape": f"B={LM_BATCH} S={LM_PROMPT} H={ATTN_HEADS} "
                     f"KV={ATTN_KV} D={ATTN_D} K kv{fk[0]}k{fk[1]} "
                     f"V kv{fv[0]}k{fv[1]} causal",
            "ms": sm.time_ms(lambda: run("cuda"), reps=10),
            "plain_ms": sm.time_ms(lambda: run("torch"), reps=3, warmup=1),
            "library_ms": sm.time_ms(lib, reps=10),
            "library": f"F.scaled_dot_product_attention bf16 causal on the "
                       f"unpacked K/V, reading unpacked bytes ({lib_how})",
            "bound_ms": b_ms, "bound_by": b_by})
    return rows


def lm_k1_shapes(api):
    """Distinct K1 calls of one prefill: (K, N, w_bits, k) -> count, and
    the head's (K, N, w_bits, k) at M = batch."""
    from collections import Counter
    from repro_torch.core import plan as plan_lib
    cfg = api.cfg
    hd = cfg.hd
    calls = Counter()
    for i in range(cfg.n_layers):
        for name, kdim, n in (("q", cfg.d_model, cfg.n_heads * hd),
                              ("k", cfg.d_model, cfg.n_kv * hd),
                              ("v", cfg.d_model, cfg.n_kv * hd),
                              ("o", cfg.n_heads * hd, cfg.d_model),
                              ("mlp", cfg.d_model, cfg.d_ff),
                              ("mlp", cfg.d_model, cfg.d_ff),
                              ("mlp", cfg.d_ff, cfg.d_model)):
            pol = plan_lib.resolve_policy(api.policy, f"l{i}.{name}")
            calls[(kdim, n, pol.bits_for("inner"), pol.k)] += 1
    head = plan_lib.resolve_policy(api.policy, "head")
    from repro_torch.nn.layers import pad_vocab
    return calls, (cfg.d_model, pad_vocab(cfg.vocab),
                   head.bits_for("boundary"), head.k)


def lm_k1_calls(api):
    """K1's calls at the LM's shapes, per distinct shape: (phase, M, (K, N,
    w_bits, k), count) for the prefill's projections (M = batch x prompt)
    and head (M = batch), and a decode step's projections and head (M =
    batch)."""
    calls, head = lm_k1_shapes(api)
    shapes = [("prefill", LM_BATCH * LM_PROMPT, key, count)
              for key, count in sorted(calls.items())]
    shapes += [("prefill", LM_BATCH, head, 1)]
    shapes += [("decode", LM_BATCH, key, count)
               for key, count in sorted(calls.items())]
    shapes += [("decode", LM_BATCH, head, 1)]
    return shapes


def measure_k1_lm(sm, api):
    """K1 at the LM's shapes (``lm_k1_calls``): kernel, plain version and
    one library call, each shape's route and its bound."""
    from repro_torch.kernels.mpmm import kernel
    rows = []
    for phase, m, (kdim, n, w_bits, k), count in lm_k1_calls(api):
        d, kw = k1_device_call(sm, m, kdim, n, w_bits, k, seed=7 * m + n)
        out = kernel.mpmm_cuda(**d, **kw)
        by = nbytes(d["a_biased"], d["planes"], d["gamma"], d["colsum"], out)
        b_ms, b_by = bound_ms(by, 2 * m * n * kdim)
        lib, lib_name = k1_library(sm, d, kw["fmt"])
        rows.append({"kernel": "mpmm_cuda", "phase": phase,
                     "route": kernel.mpmm_route(m, kdim, n),
                     "shape": f"M={m} K={kdim} N={n} w{w_bits}k{k}",
                     "count": count,
                     "ms": sm.time_ms(lambda: kernel.mpmm_cuda(**d, **kw),
                                      reps=10, warmup=2),
                     "plain_ms": sm.time_ms(
                         lambda: kernel.mpmm_torch(**d, **kw), reps=2,
                         warmup=1),
                     "library_ms": sm.time_ms(lib, reps=10, warmup=2),
                     "library": lib_name,
                     "bound_ms": b_ms, "bound_by": b_by})
        del lib, d
    return rows


def measure_lm_end_to_end(sm, api, params, prompts):
    """Prefill and decode through the kernels, timed with CUDA events."""
    from repro_torch.runtime.serve import Generator
    t = sm.torch
    gen = Generator(api, params, device=sm.device)
    tt = t.as_tensor(prompts, device=sm.device)
    with t.inference_mode():
        prefill_ms = sm.time_ms(lambda: gen.prefill(tt), reps=2, warmup=1)
        logits, pre = gen.prefill(tt)
        cache = gen._grow_cache(pre, LM_BATCH, LM_PROMPT,
                                LM_PROMPT + LM_NEW)
        tok = t.argmax(logits, -1)[:, None]
        steps = iter(range(LM_NEW - 1))
        decode_ms = sm.time_ms(
            lambda: gen.decode(cache, tok, LM_PROMPT + next(steps)),
            reps=LM_NEW - 3, warmup=2)
    return prefill_ms, decode_ms


# --- phase 10: speculative decoding, the schedulers, the entry point ---------


class StepClock:
    """The schedulers' injected clock: the smoke sets it before each step
    (``tick``: to the host clock; ``advance``: by a fixed step), so every
    read inside a step sees one time and admission never races the host."""

    def __init__(self):
        self.t = 0.0

    def __call__(self):
        return self.t

    def tick(self):
        self.t = time.perf_counter()

    def advance(self, dt):
        self.t += dt


def phase_spec(sm, depth=None, phase8_tokens=None):
    """(a) ``SpeculativeGenerator`` (k = SPEC_K) over granite-8b at full
    width: two packed views of one weight draw, verify under
    ``granite_8b_mixed.json``, draft under ``granite_8b_draft_w2.json``.
    Its tokens must equal the verify-only ``Generator``'s on the same
    view (and phase 8's, which drew the same weights); its launch counts
    must be the calls the path makes, cycle by cycle; one verify cycle's
    logits must equal SPEC_K + 1 sequential decode steps on a copy of the
    cache, bitwise, caches included.  (b) The ``attn_impl='flash'``
    verify: K4 once a layer, its attention within one bf16 ulp of K4's
    plain version and within K4_VS_K3_TOL of the default per-query route
    on the cache the verify wrote.  -> (generator, prompts, results)."""
    import numpy as np
    from repro_torch.core.plan import PrecisionPlan
    from repro_torch.kernels.flashattn import ops as fops
    from repro_torch.kernels.mpmm import kernel
    from repro_torch.models import transformer as T
    from repro_torch.nn import attention as attn
    from repro_torch.runtime import telemetry as tele
    from repro_torch.runtime.serve import init_packed_views
    from repro_torch.runtime.specdec import SpeculativeGenerator
    t = sm.torch
    vplan, dplan = PrecisionPlan.load(LM_PLAN), PrecisionPlan.load(DRAFT_PLAN)
    api = lm_api(depth, vplan)
    cfg, n = api.cfg, api.cfg.n_layers
    t0 = time.perf_counter()
    views = init_packed_views(api, [vplan, dplan], t.Generator(
        device=sm.device).manual_seed(SEED), device=sm.device)
    t.cuda.synchronize()
    log(f"[spec] {cfg.name} depth {n}: verify [{vplan.name}] and draft "
        f"[{dplan.name}] drawn once and packed in "
        f"{time.perf_counter() - t0:.2f} s, "
        f"{t.cuda.memory_allocated() / 2**30:.2f} GiB on the card")
    tracer = tele.Tracer()
    sg = SpeculativeGenerator(api=api, packed_views=tuple(views),
                              draft_plan=dplan, k=SPEC_K, device=sm.device,
                              tracer=tracer)
    del views
    gen = sg.gen_verify
    prompts = np.random.default_rng(SEED).integers(0, cfg.vocab,
                                                   (LM_BATCH, LM_PROMPT))
    t0 = time.perf_counter()
    want = gen.generate(prompts, LM_NEW)  # host numpy: synchronised
    verify_s = time.perf_counter() - t0
    reset_counts()
    n0 = len(tracer.events)
    t0 = time.perf_counter()
    got = sg.generate(prompts, LM_NEW)
    spec_s = time.perf_counter() - t0
    launches = read_counts()
    routes = dict(kernel.mpmm_cuda.routes)
    cycles = [e for e in list(tracer.events)[n0:] if e[1] == "specdec.accept"]
    k_effs = [e[6]["drafted"] // LM_BATCH for e in cycles]
    per_step = 7 * n + 1  # a step's projections and its head
    want_routes = {"wgmma": 2 * 7 * n, "splitk": 2}  # the two prefills
    for k in k_effs:
        want_routes["splitk"] += (k + 1) * per_step if k else 0  # draft
        want_routes[kernel.mpmm_route(LM_BATCH * (k + 1), 1, 1)] += per_step
    want_launches = {"mpmm_cuda": sum(want_routes.values()),
                     "conv_mpmm_cuda": 0, "flash_fwd_cuda": 0,
                     "flash_fwd_packed_cuda": 2 * n}
    log(f"[spec] k={SPEC_K}: {len(cycles)} cycles (k_eff {k_effs}), "
        f"drafted {sg.drafted_tokens}, accepted {sg.accepted_tokens}; "
        f"launches {launches}; K1 routes {routes}; tokens[0] "
        f"{got[0].tolist()}")
    if launches != want_launches or routes != want_routes:
        raise SystemExit(f"spec: launches {launches} / routes {routes} != "
                         f"{want_launches} / {want_routes}")
    if not np.array_equal(got, want):
        raise SystemExit(f"spec: tokens differ from the verify-only "
                         f"Generator's:\n{got}\n{want}")
    if phase8_tokens is not None and not np.array_equal(got, phase8_tokens):
        raise SystemExit("spec: tokens differ from phase 8's Generator on "
                         "the same weight draw")
    with t.inference_mode():
        _, pre = gen.prefill(t.as_tensor(prompts, device=sm.device))
        cache = gen._grow_cache(pre, LM_BATCH, LM_PROMPT, LM_PROMPT + LM_NEW)
        del pre
        fresh = clone_tree(cache)
        seq_cache = clone_tree(cache)
        feed = t.as_tensor(got[:, :SPEC_K + 1], device=sm.device)
        bat, cache = sg.api_verify.decode_steps(gen.params, cache, feed,
                                                LM_PROMPT)
        seq = t.stack([gen.decode(seq_cache, feed[:, i:i + 1],
                                  LM_PROMPT + i)[0]
                       for i in range(SPEC_K + 1)], dim=1)
        same_cache = all(t.equal(a, b) for a, b in zip(
            tree_leaves(cache), tree_leaves(seq_cache)))
        if not t.equal(bat, seq) or not same_cache:
            err = float((bat.float() - seq.float()).abs().max())
            raise SystemExit(f"spec: a verify's logits (max diff {err}) or "
                             f"cache (equal {same_cache}) differ from "
                             f"{SPEC_K + 1} sequential decode steps")
        del seq_cache, seq
        reset_counts()
        flash, _ = sg.api_verify.decode_steps(gen.params, fresh, feed,
                                              LM_PROMPT, attn_impl="flash")
        t.cuda.synchronize()
        k4 = read_counts()["flash_fwd_packed_cuda"]
        del fresh
        rel = float((flash.float() - bat.float()).abs().max()
                    / bat.float().abs().max())
        fmt_k, fmt_v = T.kv_formats(cfg, api.policy)[1][0]
        ck, cv = cache[0]["k"], cache[0]["v"]
        g = t.Generator(device=sm.device).manual_seed(SEED + 10)
        q = t.randn((LM_BATCH, SPEC_K + 1, ATTN_HEADS, ATTN_D), generator=g,
                    device=sm.device).to(t.bfloat16)
        run = lambda impl: fops.flash_attention_packed(  # noqa: E731
            q, ck, cv, fmt_k, fmt_v, q_offset=LM_PROMPT, impl=impl)
        k4_out, k4_plain = run("cuda"), run("torch")
        per_query = t.cat([attn.decode_attention_streamed(
            q[:, i:i + 1], ck, cv, fmt_k, fmt_v, LM_PROMPT + 1 + i)
            for i in range(SPEC_K + 1)], dim=1)
        t.cuda.synchronize()
    err = compare_close(sm, "flash_fwd_packed_cuda",
                        "flash verify K4 vs plain", k4_out, k4_plain)
    err_q = compare_close(sm, "flash_fwd_packed_cuda",
                          "flash verify K4 vs per-query route", k4_out,
                          per_query, tol=K4_VS_K3_TOL)
    log(f"[spec] verify bitwise equal to {SPEC_K + 1} decode steps; flash "
        f"verify: K4 launched {k4} times ({n} layers), attention vs plain "
        f"{err}, vs the per-query route {err_q} (tol {K4_VS_K3_TOL}), "
        f"logits {rel:.5f} of the largest apart through {n} layers (not "
        f"held: the routes round differently and 8-bit requantization "
        f"carries it on)")
    if k4 != n:
        sm.failures.append(f"flash verify launched K4 {k4} times, not {n}")
    sm.check_phase("speculative decoding (verify-only tokens, launches, "
                   "verify vs sequential decode, flash verify)")
    res = {"spec_s": spec_s, "verify_s": verify_s, "cycles": len(cycles),
           "cycle_ms": [e[5] * 1e3 for e in cycles],
           "accept_rate": sg.accept_rate, "launches": launches,
           "routes": routes}
    return sg, prompts, res


def tree_leaves(tree):
    if isinstance(tree, dict):
        return [x for v in tree.values() for x in tree_leaves(v)]
    if isinstance(tree, (tuple, list)):
        return [x for v in tree for x in tree_leaves(v)]
    return [tree]


def phase_lm_schedulers(sm, sg):
    """(c) ``GenerateScheduler`` with SCHED_SLOTS slots over SCHED_TRACE
    (two prompt lengths, three n_new), over the verify view's
    ``Generator`` and then over the ``SpeculativeGenerator``: every
    ticket's tokens must equal the same request served alone by the
    ``Generator``.  The injected clock reads the host clock once a step."""
    import numpy as np
    from repro_torch.runtime.scheduler import GenerateScheduler
    gen = sg.gen_verify
    rng = np.random.default_rng(SEED + 2)
    trace = [(rng.integers(0, gen.api.cfg.vocab, plen), n_new)
             for plen, n_new in SCHED_TRACE]
    max_len = max(plen + n_new for plen, n_new in SCHED_TRACE)
    alone = [gen.generate(p[None], n_new)[0] for p, n_new in trace]
    out = {}
    for label, g in (("generator", gen), ("speculative", sg)):
        clock = StepClock()
        s = GenerateScheduler(g, slots=SCHED_SLOTS, max_len=max_len,
                              clock=clock)
        t0 = time.perf_counter()
        tickets = []
        for req in trace:
            clock.tick()
            tickets.append(s.submit(*req))
            clock.tick()
            s.step()
        for _ in range(1000):
            if not s.pending and not s.active:
                break
            clock.tick()
            s.step(flush=True)
        wall = time.perf_counter() - t0
        st = s.stats()
        bad = [tk.id for tk, want in zip(tickets, alone)
               if not tk.done or not np.array_equal(tk.result, want)]
        log(f"[sched] GenerateScheduler over the {label}: {len(trace)} "
            f"requests {list(SCHED_TRACE)} (prompt, n_new), "
            f"{SCHED_SLOTS} slots, {wall:.2f} s; events "
            f"{[(e[1], e[2]) for e in s.events]}; p50 "
            f"{st['p50_latency_s'] * 1e3:.1f} ms, p99 "
            f"{st['p99_latency_s'] * 1e3:.1f} ms; tickets unlike served "
            f"alone: {bad or 'none'}")
        if bad:
            sm.failures.append(f"GenerateScheduler over the {label}: tickets "
                               f"{bad} differ from their requests served "
                               f"alone")
        out[label] = {"wall": wall, "stats": st}
    sm.check_phase("GenerateScheduler tickets vs requests served alone")
    return out


def phase_image_scheduler(sm, server, cfg):
    """(d) ``ImageScheduler`` over the ResNet-18 ``ImageServer`` (buckets
    1/2/4/8) on single images arriving in bursts (IMG_BURSTS, 13 in all):
    every ticket's logits must be bitwise the image's served alone."""
    import numpy as np
    from repro_torch.runtime.scheduler import ImageScheduler
    rng = np.random.default_rng(SEED + 3)
    images = rng.normal(0, 1, (sum(IMG_BURSTS), cfg.img_size, cfg.img_size,
                               3)).astype(np.float32)
    clock = StepClock()
    s = ImageScheduler(server, max_wait_s=0.005, clock=clock)
    tickets, i = [], 0
    for burst in IMG_BURSTS:  # a full bucket goes at once, the rest waits
        tickets += [s.submit(im) for im in images[i:i + burst]]
        i += burst
        s.step()
        clock.advance(0.01)
        s.step()
    s.drain()
    bad = [tk.id for tk, im in zip(tickets, images)
           if not tk.done or not np.array_equal(tk.result,
                                                server.predict(im[None])[0])]
    log(f"[sched] ImageScheduler: {len(images)} images in batches "
        f"{list(s.dispatched_batches)}; tickets unlike served alone: "
        f"{bad or 'none'}")
    if bad:
        sm.failures.append(f"ImageScheduler tickets {bad} differ from their "
                           f"images served alone")
    sm.check_phase("ImageScheduler tickets vs images served alone")
    return list(s.dispatched_batches)


def phase_cli(sm):
    """(e) ``repro_torch.launch.serve.main`` in process, for ResNet-18 and
    for granite-8b with speculative decoding, at full width, each with a
    trace and a metrics dump that must pass the port's validators."""
    import json
    import tempfile
    from repro_torch.launch import serve as launch
    from repro_torch.runtime import telemetry as tele
    runs = {
        "resnet18": ["--arch", "resnet18", "--plan", str(PLAN), "--batch",
                     "8"],
        "granite-8b": ["--arch", "granite-8b", "--plan", str(LM_PLAN),
                       "--spec-decode", str(SPEC_K), "--draft-plan",
                       str(DRAFT_PLAN), "--batch", str(LM_BATCH),
                       "--prompt-len", "128", "--new-tokens", "8"],
    }
    (ROOT / "build").mkdir(exist_ok=True)
    with tempfile.TemporaryDirectory(dir=ROOT / "build") as d:
        for arch, argv in runs.items():
            trace, prom = Path(d) / f"{arch}.json", Path(d) / f"{arch}.prom"
            t0 = time.perf_counter()
            rc = launch.main(argv + ["--trace", str(trace),
                                     "--metrics-dump", str(prom)])
            sm.torch.cuda.empty_cache()
            problems = (tele.validate_chrome_trace(json.loads(
                trace.read_text())) + tele.validate_metrics_text(
                    prom.read_text()))
            log(f"[cli] launch.serve {arch}: rc {rc} in "
                f"{time.perf_counter() - t0:.2f} s; trace and metrics "
                f"problems: {problems or 'none'}")
            if rc != 0 or problems:
                sm.failures.append(f"launch.serve {arch}: rc {rc}, "
                                   f"{problems}")
    sm.check_phase("launch.serve on the card")


# --- phase 11: design-space exploration, fp baseline, frontier and SLO ------


def resnet_layer_shapes(cfg):
    """Every conv of a basic-block ResNet in serve order: (name, input
    size, C in, C out, kernel, stride, layer class), the stem first."""
    from repro_torch.models import resnet as R
    out = [("stem", cfg.img_size, 3, cfg.width, 7, 2, "boundary")]
    h = cfg.img_size // 4
    for si, bi, cin, cmid, stride in R._block_channels(cfg):
        key = f"s{si}b{bi}"
        if stride != 1 or cin != cmid:
            out.append((key + "p", h, cin, cmid, 1, stride, "inner"))
        out.append((key + "c1", h, cin, cmid, 3, stride, "inner"))
        h = -(-h // stride)
        out.append((key + "c2", h, cmid, cmid, 3, 1, "inner"))
    return out


def resnet_launches(cfg, plan, batch):
    """One quantized ResNet forward at ``batch``: its K1/K2 launches, K1's
    routes and each conv's dataflow, from the layers' own choices -- the
    plan's per-layer entry, else the H100 cost model
    (``nn.quantized.conv_serve_dataflow``), gated by K2's feasibility, as
    ``qconv_serve_apply`` resolves them -- and K1's route rule."""
    from repro_torch.core import plan as plan_lib
    from repro_torch.core.packing import PlaneFormat
    from repro_torch.kernels.mpmm import kernel, ops
    from repro_torch.nn import quantized as Q
    k2, routes, flows = 0, dict.fromkeys(kernel.ROUTES, 0), {}
    for name, h, cin, cout, kk, s, cls in resnet_layer_shapes(cfg):
        pol = plan_lib.resolve_policy(plan, name)
        flow = plan_lib.resolve_dataflow(plan, name)
        if flow == "auto":
            flow = Q.conv_serve_dataflow((batch, h, h, cin), pol, k=kk,
                                         stride=s, padding="SAME",
                                         layer_class=cls, n_out=cout)
        elif not ops.conv_implicit_feasible(cin, PlaneFormat(
                pol.bits_for(cls), pol.k, kk * kk * cin)):
            flow = "im2col"
        flows[name] = flow
        ho = -(-h // s)
        if flow == "implicit":
            k2 += 1
        else:
            routes[kernel.mpmm_route(batch * ho * ho, kk * kk * cin,
                                     cout)] += 1
    routes[kernel.mpmm_route(batch, cfg.fc_in, cfg.n_classes)] += 1
    return ({"mpmm_cuda": sum(routes.values()), "conv_mpmm_cuda": k2},
            routes, flows)


def bucket_calls(server, n):
    """The bucket sizes ``ImageServer.predict`` runs for ``n`` images."""
    out, i = [], 0
    while i < n:
        b = server._bucket_for(n - i)
        out.append(b)
        i += min(n - i, b)
    return out


def read_p11():
    """The launch counts and K1's routes (``route:<name>``) since the last
    ``reset_counts``."""
    from repro_torch.kernels.mpmm import kernel
    counts = read_counts()
    counts.update({f"route:{k}": v
                   for k, v in kernel.mpmm_cuda.routes.items()})
    return counts


def runs(seq):
    """[1, 2, 2, 2, 0] -> '1, 2x3, 0'."""
    out = []
    for v in seq:
        if out and out[-1][0] == v:
            out[-1][1] += 1
        else:
            out.append([v, 1])
    return ", ".join(f"{v}x{n}" if n > 1 else f"{v}" for v, n in out)


def add_counts(total, counts):
    return {k: total.get(k, 0) + v for k, v in counts.items()}


def logits_contract(sm, label, cfg, plan, server, plain, x):
    """Phase 4's contract for one batch: the kernel path's logits within
    E2E_LOGIT_TOL of the largest plain |logit|, at most E2E_MAX_FLIP_RATE
    of the classifier-input codes flipped."""
    import numpy as np
    from repro_torch.kernels.mpmm import ops
    from repro_torch.models import resnet as R
    t = sm.torch
    y, ref_y = server.predict(x), plain.predict(x)
    tol = E2E_LOGIT_TOL * float(np.abs(ref_y).max())
    err = float(np.abs(y - ref_y).max())
    xt = t.from_numpy(x).to(sm.device)
    f_k = R.serve_features(cfg, server.params, xt, plan)
    f_p = R.serve_features(cfg, server.params, xt, plan, impl="torch")
    ga = server.params["fc"]["ga"]
    flips = float((ops.quantize_activations(f_k, ga)
                   != ops.quantize_activations(f_p, ga)).float().mean())
    ok = (np.isfinite(y).all() and float(y.std()) > 0 and err <= tol
          and flips <= E2E_MAX_FLIP_RATE)
    log(f"[p11] {label}: max |kernel - plain| {err} (tol {tol}), flipped "
        f"fc-input codes {flips}")
    if not ok:
        sm.failures.append(f"{label}: outside the end-to-end contract")
    return y


def spearman(a, b):
    """Rank correlation of two equal-length sequences (average ranks)."""
    import numpy as np

    def ranks(v):
        v = np.asarray(v, np.float64)
        order = np.argsort(v, kind="stable")
        r = np.empty(len(v))
        r[order] = np.arange(len(v), dtype=np.float64)
        for val in np.unique(v):
            idx = v == val
            r[idx] = r[idx].mean()
        return r
    ra, rb = ranks(a), ranks(b)
    ra, rb = ra - ra.mean(), rb - rb.mean()
    return float((ra * rb).sum() / np.sqrt((ra ** 2).sum() * (rb ** 2).sum()))


def device_smem(torch):
    """(SMs, shared memory a block may opt into, shared memory an SM) of
    card 0, from torch's device properties or else the CUDA runtime."""
    props = torch.cuda.get_device_properties(0)
    block = getattr(props, "shared_memory_per_block_optin", None)
    per_sm = getattr(props, "shared_memory_per_multiprocessor", None)
    if block is None or per_sm is None:
        import ctypes
        rt = ctypes.CDLL("libcudart.so")
        v = ctypes.c_int()
        vals = []
        for attr in (97, 81):  # MaxSharedMemoryPerBlockOptin, ...PerSM
            if rt.cudaDeviceGetAttribute(ctypes.byref(v), attr, 0) != 0:
                raise SystemExit("cudaDeviceGetAttribute failed")
            vals.append(v.value)
        block, per_sm = vals
    return props.multi_processor_count, int(block), int(per_sm)


def fp64_forward(t, cfg, packed, x):
    """The fp baseline's network in float64 on the same (bf16) weights,
    with ``F.conv2d`` on XLA-SAME-padded inputs: the reference of phase
    11 (b)."""
    import torch.nn.functional as F
    from repro_torch.kernels.mpmm import ref
    from repro_torch.models import resnet as R
    f64 = t.float64

    def conv(p, x, k, stride, bn, relu, res=None):
        xp = ref.pad_spatial(x, k, k, stride, "SAME", fill=0.0)
        w = p["w"].to(f64).reshape(k, k, x.shape[-1], -1).permute(3, 2, 0, 1)
        y = F.conv2d(xp.permute(0, 3, 1, 2), w, stride=stride)
        y = y.permute(0, 2, 3, 1)
        y = y * bn[0].to(f64).reshape(-1) + bn[1].to(f64).reshape(-1)
        if res is not None:
            y = y + res
        return y.clamp_min(0.0) if relu else y

    h = conv(packed["stem"], x.to(f64), 7, 2, packed["bn_stem"], True)
    h = R.max_pool_same(h)
    for si, bi, cin, cmid, stride in R._block_channels(cfg):
        p = packed[f"s{si}b{bi}"]
        sc = (conv(p["proj"], h, 1, stride, p["bn_proj"], False)
              if "proj" in p else h)
        m = conv(p["conv1"], h, 3, stride, p["bn1"], True)
        h = conv(p["conv2"], m, 3, 1, p["bn2"], True, res=sc)
    return h.mean(dim=(1, 2)) @ packed["fc"]["w"].to(f64)


class SpikeClock:
    """The SLO scheduler's clock on the card: the host clock plus the
    latency spikes the fault injector adds (``advance``)."""

    def __init__(self):
        self.offset = 0.0

    def __call__(self):
        return time.perf_counter() + self.offset

    def advance(self, dt):
        self.offset += dt


def p11_dse(sm, api, params, state, images):
    """(a) ``plan_search`` at full ResNet-18 width under the H100 cost
    model, fed by ``weight_ptq_sensitivity`` of the random weights and by
    ``calibration_sensitivity`` of ``images`` through the card (the fp
    reference through the fp baseline, each probe through K1/K2); the
    H100 entry beside the card's own properties."""
    import dataclasses as dc
    import numpy as np
    from repro_torch.core import planner
    from repro_torch.core.plan import (LayerPlan, PrecisionPlan,
                                       plan_footprint_report)
    from repro_torch.core.precision import PrecisionPolicy
    from repro_torch.core.roofline import H100
    from repro_torch.models import resnet as R
    t = sm.torch
    cfg = api.cfg
    sms, smem_block, smem_sm = device_smem(t)
    log(f"[p11] H100 entry: {H100.sm_count} SMs, {H100.smem_per_block:.0f} B "
        f"shared memory a block, {H100.smem_bytes:.0f} B an SM, "
        f"{H100.peak_ops_int8 / 1e12:.0f} TOP/s int8, "
        f"{H100.hbm_bw / 1e12:.2f} TB/s; the card: {sms} SMs, {smem_block} "
        f"B a block (opt-in), {smem_sm} B an SM")
    if (sms, smem_block, smem_sm) != (H100.sm_count, H100.smem_per_block,
                                     H100.smem_bytes):
        sm.failures.append("the H100 entry disagrees with the card")
    inner = R.inner_layer_names(cfg)
    t0 = time.perf_counter()
    weights = R.layer_weights(cfg, params)
    w_sens = planner.weight_ptq_sensitivity({n: weights[n] for n in inner})
    t_w = time.perf_counter() - t0

    x = t.from_numpy(images).to(sm.device)
    trees = {}
    inv = {sfx: key for key, sfx in R._PLAN_SUFFIX.items()}

    def tree_of(pol):
        key = (pol.inner_bits, pol.k, pol.quantize)
        if key not in trees:
            trees[key] = R.pack_for_serve(cfg, params, state, pol)
        return trees[key]

    def cached(plan):
        """The plan's serve tree from uniform trees packed once: the base
        tree with each named layer's conv taken from the tree of its
        format."""
        if not plan.quantize:
            return tree_of(PrecisionPolicy(quantize=False))
        d = plan.default
        tree = dict(tree_of(PrecisionPolicy(inner_bits=d.w_bits, k=d.k)))
        for name, lp in plan.layers:
            sfx = next(s for s in inv if name.endswith(s))
            blk = name[:-len(sfx)]
            src = tree_of(PrecisionPolicy(inner_bits=lp.w_bits, k=lp.k))
            tree[blk] = dict(tree[blk])
            tree[blk][inv[sfx]] = src[blk][inv[sfx]]
        return tree

    calls = []

    def forward(plan):
        calls.append(plan.name)
        with t.inference_mode():
            y = R.serve_forward(cfg, cached(plan), x, plan)
        return y.float().cpu().numpy()

    reset_counts()
    t0 = time.perf_counter()
    c_sens = planner.calibration_sensitivity(forward, inner)
    t.cuda.synchronize()
    t_c = time.perf_counter() - t0
    counts = read_p11()
    probe = dc.replace(PrecisionPlan.uniform(PrecisionPolicy(inner_bits=8,
                                                             k=4)),
                       layers=(("s1b1c2", LayerPlan(2, 2)),))
    with t.inference_mode():
        fresh = R.serve_forward(cfg, R.pack_for_serve(cfg, params, state,
                                                      probe), x, probe)
        same = t.equal(fresh, R.serve_forward(cfg, cached(probe), x, probe))
    log(f"[p11] sensitivities: weight PTQ in {t_w:.2f} s; calibration on "
        f"{len(images)} images through the card in {t_c:.2f} s, "
        f"{len(calls)} forwards (fp reference through the fp baseline, "
        f"{len(trees)} uniform trees packed once), launches {counts}; the "
        f"cached probe tree's logits bitwise a fresh pack_for_serve's: "
        f"{same}")
    if not same:
        sm.failures.append("calibration: the cached probe tree's logits "
                           "differ from a fresh pack_for_serve's")
    if not counts["mpmm_cuda"] or not counts["conv_mpmm_cuda"]:
        sm.failures.append(f"calibration probes launched {counts}")
    gemms = api.gemm_workload(P11_BATCH)
    lp = R.layer_param_counts(cfg)
    mixed = PrecisionPlan.load(PLAN)
    budget = plan_footprint_report(lp, R.layer_classes(cfg),
                                   mixed)["quant_bytes"]
    results = {}
    for label, sens in (("weight PTQ", w_sens), ("calibration", c_sens)):
        res = planner.plan_search(gemms, sens, layer_params=lp,
                                  budget_bytes=budget)
        results[label] = res
        log(f"[p11] plan_search ({label} sensitivities, batch "
            f"{P11_BATCH}, H100 latencies, footprint budget {budget:.0f} B "
            f"= resnet18_mixed.json's): {len(res.points)} points, "
            f"{len(res.frontier)} on the frontier")
        for r in res.frontier_rows():
            log(f"[p11]   {r['name']:<14} error {r['error']:.6g} latency "
                f"{r['latency_s'] * 1e6:.3f} us ({r['fps']:.1f} /s) "
                f"footprint {r['footprint_bytes']:.0f} B w_bits "
                f"{r['distinct_wbits']}")
        ch = res.chosen
        log(f"[p11]   chosen {ch.name}: bits "
            f"{dict(ch.bits)}; latency {ch.latency_s * 1e6:.3f} us, "
            f"footprint {ch.footprint_bytes:.0f} B")
        lats = [p.latency_s for p in res.frontier]
        if lats != sorted(lats) or ch not in res.frontier:
            sm.failures.append(f"plan_search ({label}): frontier not "
                               f"sorted or the choice is off it")
    chosen = results["calibration"].chosen.plan
    with t.inference_mode():
        y = R.serve_forward(cfg, R.pack_for_serve(cfg, params, state,
                                                  chosen), x, chosen)
    ok = bool(t.isfinite(y.float()).all())
    log(f"[p11] the chosen plan packs and serves: logits {tuple(y.shape)}, "
        f"finite {ok}")
    if not ok:
        sm.failures.append("the chosen plan's logits are not finite")
    sm.check_phase("11 (a) plan_search at full width, H100 entry")
    return counts, tree_of(PrecisionPolicy(quantize=False))


def p11_fp_baseline(sm, api, packed_fp, mixed_server, images):
    """(b) The fp baseline through ``ImageServer`` at buckets 1 and 8,
    against a float64 run of the same bf16 weights; its packed bytes
    against the mixed plan's."""
    import dataclasses as dc
    import numpy as np
    from repro_torch.core.plan import PrecisionPlan, plan_footprint_report
    from repro_torch.core.precision import PrecisionPolicy
    from repro_torch.launch.serve import _tree_bytes
    from repro_torch.models import resnet as R
    from repro_torch.runtime.serve import ImageServer
    t = sm.torch
    cfg = api.cfg
    fp = PrecisionPolicy(quantize=False)
    server = ImageServer(api=dc.replace(api, policy=fp), params=packed_fp,
                         batch_buckets=(1, P11_BATCH), device=sm.device)
    reset_counts()
    y8 = server.predict(images)
    y1 = server.predict(images[:1])
    counts = read_p11()
    with t.inference_mode():
        ref = fp64_forward(t, cfg, server.params,
                           t.from_numpy(images).to(sm.device)).cpu().numpy()
    tol = FP_LOGIT_TOL * float(np.abs(ref).max())
    err8 = float(np.abs(y8 - ref).max())
    err1 = float(np.abs(y1 - ref[:1]).max())
    top = float(np.mean(np.argmax(y8, -1) == np.argmax(ref, -1)))
    lp, cls = R.layer_param_counts(cfg), R.layer_classes(cfg)
    rep_fp = plan_footprint_report(lp, cls, fp)
    rep_mx = plan_footprint_report(lp, cls, PrecisionPlan.load(PLAN))
    b_fp, b_mx = _tree_bytes(server.params), _tree_bytes(mixed_server.params)
    fps = {}
    for b in (1, P11_BATCH):
        x = images[:b]
        server.predict(x)
        t0 = time.perf_counter()
        for _ in range(10):
            server.predict(x)
        fps[b] = 10 * b / (time.perf_counter() - t0)
    log(f"[p11] fp baseline (bf16 weights, bf16 products, every conv "
        f"through im2col): logits at bucket 8 and 1 within {err8} and "
        f"{err1} of a float64 run of the same bf16 weights (tol {tol} = "
        f"{FP_LOGIT_TOL} of the largest |logit|), top-1 agreement {top}; "
        f"launches {counts} (no kernel of ours); frames/s bucket 1 "
        f"{fps[1]:.1f}, bucket 8 {fps[P11_BATCH]:.1f}")
    log(f"[p11] footprint (plan_footprint_report): fp baseline "
        f"{rep_fp['quant_bytes']:.0f} B (32 bits a weight), "
        f"resnet18_mixed.json {rep_mx['quant_bytes']:.0f} B, compression "
        f"{rep_mx['compression']:.3f}x; served trees on the card: fp "
        f"{b_fp} B (bf16), mixed {b_mx} B, {b_fp / b_mx:.3f}x")
    if max(err8, err1) > tol or not np.isfinite(y8).all():
        sm.failures.append(f"fp baseline: {max(err8, err1)} > {tol}")
    if counts["mpmm_cuda"] or counts["conv_mpmm_cuda"]:
        sm.failures.append(f"fp baseline launched {counts}")
    sm.check_phase("11 (b) the fp baseline")
    return fps


def p11_roofline(sm, api, server, plan, images, rows, card):
    """(c) ``layer_attribution`` of a measured batch-8 forward under the
    mixed plan; the cost model's per-conv time beside phase 5's measured
    K2 (and K1) times."""
    from repro_torch.core import dse
    from repro_torch.core.packing import PlaneFormat
    from repro_torch.models import resnet as R
    from repro_torch.runtime.telemetry import layer_attribution
    t = sm.torch
    cfg = api.cfg
    x = t.from_numpy(images).to(sm.device)
    fwd = lambda: R.serve_forward(cfg, server.params, x, plan)  # noqa: E731
    with t.inference_mode():
        ms = sm.time_ms(fwd)
        ms_graph = sm.graph_ms(fwd)
    gemms = api.gemm_workload(P11_BATCH)
    rep = layer_attribution(gemms, plan, ms / 1e3)
    rep_g = layer_attribution(gemms, plan, ms_graph / 1e3)
    log(f"[p11] roofline: batch-{P11_BATCH} forward under {plan.name}: "
        f"measured {ms:.4f} ms (CUDA events, 20 forwards back to back), "
        f"roofline {rep['roofline_s'] * 1e3:.4f} ms, roofline_fraction "
        f"{rep['roofline_fraction']:.4f}, achieved "
        f"{rep['achieved_tops']:.3f} TOps/s against "
        f"{rep['roofline_tops']:.1f} at the roofline and "
        f"{rep['peak_int8_tops']:.0f} peak  ({card})")
    log(f"[p11] roofline, device time alone: the same forward replayed in a "
        f"CUDA graph takes {ms_graph:.4f} ms: roofline_fraction "
        f"{rep_g['roofline_fraction']:.4f}, achieved "
        f"{rep_g['achieved_tops']:.3f} TOps/s  ({card})")
    pred, meas, names = [], [], []
    shapes = {s[0]: s for s in resnet_layer_shapes(cfg)}
    for r in rows:
        if r.get("batch", TIME_BATCH) != TIME_BATCH:
            continue
        name = r["layer"]
        if r["kernel"] == "conv_mpmm_cuda":
            _, h, cin, cout, kk, s, cls = shapes[name]
            pol = plan.policy_for(name)
            conv = dse.ConvShape(P11_BATCH, h, h, cin, cout, kk, kk, s)
            p = dse.choose_conv_dataflow(conv, w_bits=pol.bits_for(cls),
                                         k=pol.k).time_implicit_s
        elif r["kernel"] == "mpmm_cuda":
            g = next(g for g in gemms if g.name == name)
            pol = plan.policy_for(name)
            w, k = pol.bits_for(g.layer_class), pol.k
            tile = dse.autotune_tile(g.m, g.k, g.n, w_bits=w, k=k)
            p = max(dse.gemm_time(g, tile, PlaneFormat(w, k, g.k)))
        else:
            continue
        names.append(f"{r['kernel']}:{name}")
        pred.append(p * 1e3)
        meas.append(r["ms"])
        log(f"[p11]   {r['kernel']:<15} {name:<7} model {p * 1e3:.5f} ms, "
            f"measured {r['ms']:.5f} ms ({r['ms'] / (p * 1e3):.2f}x)")
    k2 = [i for i, n in enumerate(names) if n.startswith("conv")]
    rho = spearman(pred, meas)
    rho_k2 = spearman([pred[i] for i in k2], [meas[i] for i in k2])
    log(f"[p11] model vs measured: rank correlation {rho:.4f} over "
        f"{len(names)} calls (K2 alone {rho_k2:.4f} over {len(k2)}); sum "
        f"model {sum(pred):.4f} ms, measured {sum(meas):.4f} ms")
    if not 0 < rep["roofline_fraction"] < 1:
        sm.failures.append(f"roofline_fraction {rep['roofline_fraction']}")
    sm.check_phase("11 (c) roofline attribution")
    return {"ms": ms, "ms_graph": ms_graph, "rep": rep, "rho": rho,
            "rho_k2": rho_k2}


def p11_frontier(sm, api, params, state):
    """(d) ``examples/frontiers/resnet18_frontier.json`` through
    ``frontier_from_manifest`` on the card: every level held to phase 4's
    contract against its plain path, its launches against the layers' own
    choices, its frames/s at bucket 8 against the manifest's
    ``rel_latency``."""
    import numpy as np
    from repro_torch.core.plan import FrontierManifest
    from repro_torch.kernels.mpmm import kernel
    from repro_torch.runtime.frontier import frontier_from_manifest
    from repro_torch.runtime.serve import ImageServer
    cfg = api.cfg
    manifest = FrontierManifest.load(FRONTIER)
    t0 = time.perf_counter()
    fr = frontier_from_manifest(api, params, manifest, state=state,
                                batch_buckets=BUCKETS, device=sm.device)
    sm.torch.cuda.synchronize()
    log(f"[p11] frontier {manifest.name}: {' -> '.join(fr.names)} packed "
        f"from one weight draw in {time.perf_counter() - t0:.2f} s")
    rng = np.random.default_rng(SEED + 11)
    x = rng.normal(0, 1, (P11_BATCH, cfg.img_size, cfg.img_size,
                          3)).astype(np.float32)
    total, times = {}, []
    for lvl, entry in enumerate(manifest.points):
        srv = fr.server(lvl).server
        plain = ImageServer(api=srv.api, params=srv.params, plan=srv.plan,
                            batch_buckets=BUCKETS, device=sm.device,
                            impl="torch")
        plan = srv.plan if srv.plan is not None else srv.api.policy
        reset_counts()
        fr.serve(list(x), level=lvl)
        sm.torch.cuda.synchronize()
        counts = read_p11()
        want, routes, flows = resnet_launches(cfg, plan, P11_BATCH)
        got = {k: counts[k] for k in want}
        if got != want or dict(kernel.mpmm_cuda.routes) != routes:
            sm.failures.append(f"frontier level {lvl}: launches {got} != "
                               f"{want} (routes {routes})")
        total = add_counts(total, counts)
        logits_contract(sm, f"frontier level {lvl} ({entry.name})", cfg,
                        plan, srv, plain, x)
        for _ in range(2):
            fr.serve(list(x), level=lvl)
        t0 = time.perf_counter()
        for _ in range(10):
            fr.serve(list(x), level=lvl)  # host numpy: synchronised
        times.append((time.perf_counter() - t0) / 10)
        log(f"[p11] frontier level {lvl} {entry.name}: launches {got}, K1 "
            f"routes {routes}, implicit convs "
            f"{sum(f == 'implicit' for f in flows.values())}/{len(flows)}")
    for lvl, entry in enumerate(manifest.points):
        log(f"[p11] frontier level {lvl} {entry.name}: "
            f"{P11_BATCH / times[lvl]:.1f} frames/s at bucket {P11_BATCH} "
            f"({times[lvl] * 1e3:.3f} ms a batch), measured rel_latency "
            f"{times[lvl] / times[0]:.4f} against the manifest's "
            f"{entry.rel_latency}")
    sm.check_phase("11 (d) the frontier's levels")
    return fr, times, total


def p11_slo(sm, fr, times, cfg):
    """(e) ``SLOScheduler`` over the frontier on the card, with seeded
    faults: a burst that degrades, a trickle that recovers; every ticket
    terminal, every served one bitwise its image served alone at its
    level.  The deadline is set from the measured level-0 batch time."""
    import numpy as np
    from repro_torch.runtime.faults import FaultInjector, FaultSpec
    from repro_torch.runtime.slo import HysteresisConfig, SLOScheduler
    t0_batch = times[0]
    slo_s = SLO_BATCHES * t0_batch
    clock = SpikeClock()
    inj = FaultInjector(FaultSpec(
        step_error_rate=0.3, latency_spike_rate=0.2,
        latency_spike_s=t0_batch, malformed_rate=0.15), SLO_SEED)
    faulty = inj.wrap_frontier(fr, advance=clock.advance)
    s = SLOScheduler(faulty, slo_s=slo_s, clock=clock,
                     est_serve_s=list(times), max_retries=4, backoff_s=1e-3,
                     hysteresis=HysteresisConfig(up_after=1, down_after=2))
    rng = np.random.default_rng(SEED + 12)
    imgs = rng.normal(0, 1, (SLO_BURST + 24, cfg.img_size, cfg.img_size,
                             3)).astype(np.float32)
    tickets, refused, levels = [], 0, []
    reset_counts()
    t_start = time.perf_counter()
    for im in imgs[:SLO_BURST]:
        p, bad = inj.maybe_malform(im)
        try:
            tickets.append((im, s.submit(p)))
        except ValueError:
            refused += 1
    for _ in range(100_000):
        if not s.pending:
            break
        s.step()
        levels.append(s.level)
    for im in imgs[SLO_BURST:]:
        tickets.append((im, s.submit(im)))
        s.drain()
        levels.append(s.level)
        if s.level == 0 and max(levels) > 0:
            break
    wall = time.perf_counter() - t_start
    counts = read_p11()
    st = s.stats()
    bad = []
    for im, tk in tickets:
        if not tk.done:
            bad.append(tk.id)
        elif tk.plan_point:
            lvl = fr.level_of(tk.plan_point)
            alone = fr.restricted(lvl).serve([im], level=0)[0]
            if not np.array_equal(tk.result, alone):
                bad.append(tk.id)
    outcomes = {}
    for _, tk in tickets:
        key = tk.plan_point or tk.outcome
        outcomes[key] = outcomes.get(key, 0) + 1
    log(f"[p11] SLOScheduler: slo {slo_s * 1e3:.3f} ms ({SLO_BATCHES} x the "
        f"level-0 batch time), burst {SLO_BURST} images then a trickle; "
        f"{len(tickets)} tickets in {wall:.2f} s, {refused} malformed "
        f"refused at submit; served by {outcomes}; level after each step "
        f"{runs(levels)}; transitions {list(s.controller.transitions)}; "
        f"faults "
        f"{dict(inj.counts)}; stats degraded {st['degraded']:.0f}, expired "
        f"{st['expired']:.0f}, retried {st['retried']:.0f}, failed "
        f"{st['failed']:.0f}, p50 {st['p50_latency_s'] * 1e3:.2f} ms, p99 "
        f"{st['p99_latency_s'] * 1e3:.2f} ms; launches {counts}; tickets "
        f"unlike served alone or not terminal: {bad or 'none'}")
    if bad or max(levels) == 0 or s.level != 0:
        sm.failures.append(f"SLO: bad tickets {bad}, levels {levels}")
    if not refused or refused != inj.counts["malformed"]:
        # the malformed rolls come first and are as many as the burst, so
        # the seed fixes them; the serve-side rolls follow the timing
        sm.failures.append(f"SLO: {refused} refused at submit, "
                           f"{inj.counts['malformed']} malformed rolled")
    sm.check_phase("11 (e) SLOScheduler under faults")
    return counts, st


def p11_cli(sm, slo_ms):
    """(f) ``launch.serve.main`` with ``--frontier``/``--slo-ms``, with
    ``--fp-baseline``, and with ``--plan --trace --metrics-dump``: exit
    codes, the roofline line, and ``python -m repro_torch.runtime.
    telemetry validate`` on the written files."""
    import contextlib
    import io
    import tempfile
    from repro_torch.launch import serve as launch
    from repro_torch.runtime import telemetry as tele
    (ROOT / "build").mkdir(exist_ok=True)
    with tempfile.TemporaryDirectory(dir=ROOT / "build") as d:
        trace, prom = Path(d) / "t.json", Path(d) / "m.prom"
        runs = {
            "frontier": ["--frontier", str(FRONTIER), "--slo-ms",
                         f"{slo_ms:.3f}"],
            "fp-baseline": ["--fp-baseline"],
            "plan": ["--plan", str(PLAN), "--trace", str(trace),
                     "--metrics-dump", str(prom)],
        }
        for label, extra in runs.items():
            buf = io.StringIO()
            t0 = time.perf_counter()
            with contextlib.redirect_stdout(buf):
                rc = launch.main(["--arch", "resnet18", "--batch",
                                  str(P11_BATCH), *extra])
            sm.torch.cuda.empty_cache()
            out = buf.getvalue()
            for line in out.splitlines():
                log(f"[p11] cli {label}: {line}")
            roof = [ln for ln in out.splitlines() if "roofline:" in ln]
            log(f"[p11] cli {label}: rc {rc} in "
                f"{time.perf_counter() - t0:.2f} s")
            if rc != 0:
                sm.failures.append(f"launch.serve {label}: rc {rc}")
            if label != "frontier" and not (roof and "CUDA events" in roof[0]):
                sm.failures.append(f"launch.serve {label}: no roofline line "
                                   f"timed by CUDA events")
            if label == "frontier" and "drained back to level 0" not in out:
                sm.failures.append("launch.serve --frontier did not drain "
                                   "back to level 0")
        buf = io.StringIO()
        with contextlib.redirect_stdout(buf):
            rc = tele._main(["validate", "--trace", str(trace), "--metrics",
                             str(prom)])
        log(f"[p11] telemetry validate: rc {rc}: "
            f"{buf.getvalue().strip()}")
        if rc != 0:
            sm.failures.append("telemetry validate failed")
    sm.check_phase("11 (f) launch.serve --frontier / --fp-baseline / "
                   "--plan, telemetry validate")


def p11_lm_frontier(sm):
    """(g) granite-8b at full width, first LM_FRONTIER_DEPTH layers, two
    points drawn once (``granite_8b_mixed.json``, ``granite_8b_draft_w2.
    json``) behind ``SLOScheduler`` through ``GenerateBackend``: K1 and K4
    launched as often as the generate calls made need, every served ticket
    bitwise its request served alone at its level."""
    import numpy as np
    from repro_torch.core.plan import PrecisionPlan
    from repro_torch.runtime.frontier import build_frontier
    from repro_torch.runtime.slo import HysteresisConfig, SLOScheduler
    t = sm.torch
    vplan, dplan = PrecisionPlan.load(LM_PLAN), PrecisionPlan.load(DRAFT_PLAN)
    api = lm_api(LM_FRONTIER_DEPTH, vplan)
    n, cfg = api.cfg.n_layers, api.cfg
    max_len = max(p + k for p, k in LM_FRONTIER_REQS)
    t0 = time.perf_counter()
    fr = build_frontier(api, None, [(vplan.name, vplan), (dplan.name, dplan)],
                        max_len=max_len, device=sm.device,
                        generator=t.Generator(device=sm.device).manual_seed(
                            SEED))
    t.cuda.synchronize()
    log(f"[p11] LM frontier: {cfg.name} depth {n}, {' -> '.join(fr.names)} "
        f"drawn once and packed in {time.perf_counter() - t0:.2f} s")
    calls = []
    for lvl in range(fr.n_levels):
        gen = fr.server(lvl).gen
        inner = gen.generate

        def counted(tokens, n_new, _inner=inner, **kw):
            calls.append((tokens.shape[0], n_new))
            return _inner(tokens, n_new, **kw)
        gen.generate = counted
    rng = np.random.default_rng(SEED + 13)
    reqs = [(rng.integers(0, cfg.vocab, plen).astype(np.int32), n_new)
            for plen, n_new in LM_FRONTIER_REQS]
    alone = {}
    for lvl in range(fr.n_levels):  # warm, and each request alone
        alone[lvl] = [fr.server(lvl).gen.generate(tk[None], k)[0]
                      for tk, k in reqs]
    t0 = time.perf_counter()
    fr.serve(reqs[:8], level=0)
    t_batch = time.perf_counter() - t0
    calls.clear()
    reset_counts()
    s = SLOScheduler(fr, slo_s=1.5 * t_batch, est_serve_s=t_batch,
                     hysteresis=HysteresisConfig(up_after=1))
    tickets = [(i, s.submit(r)) for i, r in enumerate(reqs)]
    s.drain()
    # then deadline-free requests one at a time: no pressure, so the
    # controller climbs back and the accurate point serves too
    for i in range(2 * len(reqs)):
        j = i % len(reqs)
        tickets.append((j, s.submit(reqs[j], slo_s=float("inf"))))
        s.drain()
        if tickets[-1][1].plan_point == fr.name(0):
            break
    t.cuda.synchronize()
    counts = read_p11()
    per_call = 7 * n + 1  # a step's projections and its head
    want_k1 = sum(per_call * k for _, k in calls)
    want_k4 = n * len(calls)
    bad = [tk.id for i, tk in tickets
           if tk.plan_point and not np.array_equal(
               tk.result, alone[fr.level_of(tk.plan_point)][i])]
    pts = {}
    for _, tk in tickets:
        key = tk.plan_point or tk.outcome
        pts[key] = pts.get(key, 0) + 1
    log(f"[p11] LM frontier behind SLOScheduler (slo {1.5 * t_batch:.3f} s "
        f"= 1.5 x a batch of 8): {len(reqs)} requests "
        f"{list(LM_FRONTIER_REQS)} (prompt, n_new), then one at a time "
        f"with no deadline; served by {pts}; levels' transitions "
        f"{list(s.controller.transitions)}; "
        f"generate calls (rows, n_new) {calls}; launches {counts}, "
        f"expected K1 {want_k1} and K4 {want_k4}; tickets unlike served "
        f"alone: {bad or 'none'}")
    if (counts["mpmm_cuda"], counts["flash_fwd_packed_cuda"]) != (want_k1,
                                                                  want_k4):
        sm.failures.append(f"LM frontier launches {counts} != K1 {want_k1}, "
                           f"K4 {want_k4}")
    if counts["flash_fwd_cuda"] or counts["conv_mpmm_cuda"]:
        sm.failures.append(f"LM frontier launched {counts}")
    if bad or not all(tk.done for _, tk in tickets) or not calls \
            or set(pts) != set(fr.names):
        sm.failures.append(f"LM frontier tickets {bad}, served by {pts}")
    sm.check_phase("11 (g) the LM frontier through GenerateBackend")
    del fr
    t.cuda.empty_cache()
    return counts


def p11_dataflow(sm, api, server, plan, card):
    """(h) The per-layer dataflow the H100 model picks, and frames/s at
    buckets 1 and 8 under ``auto`` and with ``implicit`` forced (runs in
    turns: auto, implicit, implicit, auto)."""
    import dataclasses as dc
    import numpy as np
    from repro_torch.runtime.serve import ImageServer
    cfg = api.cfg
    for b in (1, P11_BATCH):
        _, routes, flows = resnet_launches(cfg, plan, b)
        log(f"[p11] dataflow auto at batch {b}: "
            + ", ".join(f"{k} {v}" for k, v in flows.items())
            + f"; K1 routes {routes}")
    forced = ImageServer(api=server.api, params=server.params,
                         plan=server.plan, batch_buckets=server.batch_buckets,
                         device=sm.device, dataflow="implicit")
    rng = np.random.default_rng(SEED + 14)
    x = rng.normal(0, 1, (P11_BATCH, cfg.img_size, cfg.img_size,
                          3)).astype(np.float32)
    res = {("auto", 1): [], ("auto", P11_BATCH): [],
           ("implicit", 1): [], ("implicit", P11_BATCH): []}
    for label, srv in (("auto", server), ("implicit", forced),
                       ("implicit", forced), ("auto", server)):
        for b in (1, P11_BATCH):
            xb = x[:b]
            srv.predict(xb)
            t0 = time.perf_counter()
            for _ in range(20):
                srv.predict(xb)
            res[(label, b)].append(20 * b / (time.perf_counter() - t0))
    same = np.array_equal(server.predict(x), forced.predict(x))
    from repro_torch.models import resnet as R
    dev = {}
    with sm.torch.inference_mode():
        for label in ("auto", "implicit", "implicit", "auto"):
            for b in (1, P11_BATCH):
                xb = sm.torch.from_numpy(x[:b]).to(sm.device)
                dev.setdefault((label, b), []).append(sm.graph_ms(
                    lambda: R.serve_forward(cfg, server.params, xb, plan,
                                            dataflow=label)))
    for b in (1, P11_BATCH):
        a, i = res[("auto", b)], res[("implicit", b)]
        da, di = dev[("auto", b)], dev[("implicit", b)]
        log(f"[p11] frames/s at bucket {b}: auto {a[0]:.1f} / {a[1]:.1f}, "
            f"implicit forced {i[0]:.1f} / {i[1]:.1f} (runs in turns); "
            f"auto/implicit {sum(a) / sum(i):.4f}; device time a forward "
            f"(CUDA graph): auto {da[0]:.4f} / {da[1]:.4f} ms, implicit "
            f"{di[0]:.4f} / {di[1]:.4f} ms  ({card})")
    log(f"[p11] auto and implicit logits bitwise equal: {same}")
    if not same:
        sm.failures.append("dataflow auto vs implicit: logits differ")
    sm.check_phase("11 (h) dataflow auto vs implicit")
    return res


def phase_p11(sm, server, rows, card):
    """Phase 11 at full ResNet-18 width (random weights from SEED): (a)-(h)
    above.  -> (launches of its main-path runs, results)."""
    import numpy as np
    from repro_torch import configs
    from repro_torch.core.plan import PrecisionPlan
    from repro_torch.models import resnet as R
    t = sm.torch
    t_start = time.perf_counter()
    api = configs.get(ARCH)
    cfg = api.cfg
    plan = PrecisionPlan.load(PLAN)
    gen = t.Generator(device=sm.device).manual_seed(SEED)
    params = api.init_params(gen, device=sm.device)
    state = R.init_bn_state(api.specs(), device=sm.device)
    images = np.random.default_rng(SEED + 10).normal(
        0, 1, (CALIB_IMAGES, cfg.img_size, cfg.img_size, 3)).astype(
            np.float32)
    launches = {}
    counts, packed_fp = p11_dse(sm, api, params, state, images)
    launches = add_counts(launches, counts)
    fps_fp = p11_fp_baseline(sm, api, packed_fp, server, images)
    del packed_fp
    roof = p11_roofline(sm, api, server, plan, images, rows, card)
    fr, times, counts = p11_frontier(sm, api, params, state)
    launches = add_counts(launches, counts)
    counts, slo_stats = p11_slo(sm, fr, times, cfg)
    launches = add_counts(launches, counts)
    del fr, params, state
    t.cuda.empty_cache()
    p11_cli(sm, SLO_BATCHES * times[0] * 1e3)
    launches = add_counts(launches, p11_lm_frontier(sm))
    flows = p11_dataflow(sm, api, server, plan, card)
    log(f"[p11] done in {time.perf_counter() - t_start:.1f} s; launches of "
        f"its runs {launches}")
    return launches, {"fps_fp": fps_fp, "roof": roof, "times": times,
                      "flows": flows, "slo": slo_stats}


KERNELS = (
    ("mpmm_cuda", "src/repro_torch/kernels/mpmm/csrc/mpmm_wgmma.cu",
     "src/repro/kernels/mpmm/kernel.py:164"),
    ("conv_mpmm_cuda", "src/repro_torch/kernels/mpmm/csrc/conv_mpmm.cu",
     "src/repro/kernels/mpmm/conv_kernel.py:140"),
    ("flash_fwd_cuda", "src/repro_torch/kernels/flashattn/csrc/flash_fwd.cu",
     "src/repro/kernels/flashattn/kernel.py:233"),
    ("flash_fwd_packed_cuda",
     "src/repro_torch/kernels/flashattn/csrc/flash_fwd_packed.cu",
     "src/repro/kernels/flashattn/kernel.py:178"),
)


def summarize(rows, launches, max_err, k1_routes):
    """One entry per kernel.  K1 and K2: times summed over one batch-8
    ResNet-18 forward (K2's batch-1 rows are printed, not summed); K3 and
    K4: over one prefill of the run that launched them (per-layer rows
    times their layer counts).  ``launches`` sums the main-path runs
    (ResNet, and the LM's two Generator runs); K1's entry also counts them
    by route and names both route sources."""
    out = []
    for name, src, replaces in KERNELS:
        rs = [r for r in rows if r["kernel"] == name
              and r.get("batch", TIME_BATCH) == TIME_BATCH]
        w = [r.get("count", 1) for r in rs]
        by_bytes = sum(c * r["bound_ms"] for c, r in zip(w, rs)
                       if r["bound_by"] == "bytes")
        by_ops = sum(c * r["bound_ms"] for c, r in zip(w, rs)
                     if r["bound_by"] != "bytes")
        out.append({
            "name": name, "route": "cuda", "source": src,
            "replaces": replaces, "launches": launches[name],
            "max_abs_err": max_err[name],
            "ms": sum(c * r["ms"] for c, r in zip(w, rs)),
            "plain_ms": sum(c * r["plain_ms"] for c, r in zip(w, rs)),
            "bound_ms": by_bytes + by_ops,
            "bound_by": "bytes" if by_bytes >= by_ops else "operations",
            "library_ms": sum(c * r["library_ms"] for c, r in zip(w, rs))})
        if name == "mpmm_cuda":
            out[-1]["routes"] = k1_routes
            out[-1]["sources"] = [src, src.replace("mpmm_wgmma.cu",
                                                   "mpmm_splitk.cu")]
    return out


def ptxas_lines(text):
    """nvcc -Xptxas -v output -> one line per kernel instantiation: its
    template arguments, registers, stack and spills."""
    import re

    def short(mangled):  # _ZN..16flash_fwd_kernelILi128ELi4E..EEv.. -> name<args>
        end = mangled.find("I")
        while end >= 0 and not mangled[:end].endswith("kernel"):
            end = mangled.find("I", end + 1)
        if end < 0:
            return mangled
        for run in re.finditer(r"\d+", mangled[:end]):
            for k in range(len(run.group())):  # the length prefix's digits
                start = run.end()
                if start + int(run.group()[k:]) == end:
                    args = [v if t == "i" else ("true" if v == "1"
                                                  else "false")
                            for t, v in re.findall(r"L([ib])(\d+)E",
                                                   mangled[end:])]
                    if mangled[start:end].startswith("flash"):
                        args.append("bf16" if "bfloat16" in mangled
                                    else "f32")
                    return f"{mangled[start:end]}<{','.join(args)}>"
        return mangled

    name, out = "?", []
    for line in text.splitlines():
        m = re.search(r"Compiling entry function '(\S+)'", line)
        if m:
            name = short(m.group(1))
        elif "registers" in line or "spill" in line:
            out.append(f"{name}: {line.split(':', 1)[-1].strip()}")
    return out


def card_line():
    r = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                        "--format=csv,noheader"], capture_output=True,
                       text=True, timeout=60)
    if r.returncode != 0:
        raise SystemExit(f"nvidia-smi failed: {r.stderr.strip()}")
    return r.stdout.strip().splitlines()[0]


def main() -> int:
    import torch
    if not torch.cuda.is_available():
        print("chip_smoke: torch sees no CUDA device", file=sys.stderr)
        return 2
    from repro_torch.core.plan import PrecisionPlan
    from repro_torch.kernels import _build
    from repro_torch import configs

    t_start = time.perf_counter()
    device = torch.device("cuda", 0)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    card = card_line()
    log(f"[card] {card}; torch {torch.__version__}, CUDA {torch.version.cuda}")

    built = _build.build_all()
    log(f"[build] {sorted(_build.KERNEL_SOURCES)} built in "
        f"{built['seconds']:.2f} s (parallel nvcc); each: " + ", ".join(
            f"{n} {sec:.2f} s" for n, sec in built["per_source"].items()))
    for name, text in built["logs"].items():
        for line in ptxas_lines(text):
            log(f"[build] {name}: {line}")

    sm = Smoke(torch, device)
    cfg = configs.get(ARCH).cfg
    plan = PrecisionPlan.load(PLAN)
    path_k1 = path_k1_calls(sm, cfg, plan, TIME_BATCH)
    convs = resnet_convs(cfg, plan)
    if len(convs) != 19:
        raise SystemExit(f"expected 19 K2 convs, found {len(convs)}")
    k2_build_info(convs)

    lm_plan = PrecisionPlan.load(LM_PLAN)
    phase_k1(sm, path_k1, lm_k1_calls(lm_api(None, lm_plan)))
    phase_k2(sm, convs)
    server, cfg, plan, launches, k1_routes = phase_end_to_end(sm)
    fps = frames_per_second(sm, server, cfg)
    rows = measure(sm, path_k1, convs)
    log(f"[resnet] done at {time.perf_counter() - t_start:.1f} s")

    lm_block_k = configs.get(LM_ARCH).cfg.attn_chunk
    phase_k3(sm, lm_block_k)
    phase_k4(sm, lm_block_k)
    api, params, prompts, run, run3 = phase_lm(sm)
    depth = api.cfg.n_layers
    for r in (run, run3):
        launches = {k: launches.get(k, 0) + r["launches"][k]
                    for k in r["launches"]}
        k1_routes = {k: k1_routes[k] + r["routes"][k] for k in k1_routes}
    attn_rows = measure_attention(sm, api)
    k1_rows = measure_k1_lm(sm, api)
    prefill_ms, decode_ms = measure_lm_end_to_end(sm, api, params, prompts)
    del params
    torch.cuda.empty_cache()
    log(f"[lm] done at {time.perf_counter() - t_start:.1f} s")

    sg, _, spec = phase_spec(sm, phase8_tokens=run["tokens"])
    launches = {k: launches[k] + spec["launches"][k] for k in launches}
    k1_routes = {k: k1_routes[k] + spec["routes"][k] for k in k1_routes}
    sched = phase_lm_schedulers(sm, sg)
    del sg
    torch.cuda.empty_cache()
    img_batches = phase_image_scheduler(sm, server, cfg)
    phase_cli(sm)
    log(f"[spec] done at {time.perf_counter() - t_start:.1f} s")
    p11_launches, p11 = phase_p11(sm, server, rows, card)
    launches = {k: launches[k] + p11_launches.get(k, 0) for k in launches}
    k1_routes = {k: k1_routes[k] + p11_launches.get(f"route:{k}", 0)
                 for k in k1_routes}
    del server
    log(f"[p11] phase 11 done at {time.perf_counter() - t_start:.1f} s")
    rows += attn_rows
    kernels = summarize(rows, launches, sm.max_err, k1_routes)

    for r in rows:
        log(f"[time] {r['kernel']} {r['layer']:7s} {r['shape']}"
            + (f" route {r['route']}" if "route" in r else "")
            + f": kernel {r['ms']:.4f} ms, plain {r['plain_ms']:.4f} ms, "
            f"library {r['library_ms']:.4f} ms, bound {r['bound_ms']:.4f} ms "
            f"({r['bound_by']}; {r['bound_ms'] / r['ms']:.1%} of it)"
            + (f", x{r['count']} per prefill" if "count" in r else "")
            + (f"; call by call {r['call_ms']:.4f} ms; {r['plan']}"
               if "plan" in r else ""))
    for batch in (TIME_BATCH, SMALL_BATCH):
        k2 = [r for r in rows if r["kernel"] == "conv_mpmm_cuda"
              and r["batch"] == batch]
        tot = {key: sum(r[key] for r in k2)
               for key in ("ms", "call_ms", "plain_ms", "library_ms",
                           "bound_ms")}
        slower = [r["layer"] for r in k2 if r["ms"] > r["library_ms"]]
        log(f"[time] conv_mpmm_cuda per batch-{batch} forward: kernel "
            f"{tot['ms']:.4f} ms, F.conv2d f32 {tot['library_ms']:.4f} ms "
            f"(kernel/library {tot['ms'] / tot['library_ms']:.2f}x; kernel "
            f"below library: {tot['ms'] < tot['library_ms']}), plain "
            f"{tot['plain_ms']:.4f} ms, bound {tot['bound_ms']:.4f} ms "
            f"({tot['bound_ms'] / tot['ms']:.1%} of it), call by call "
            f"{tot['call_ms']:.4f} ms; convs slower than "
            f"F.conv2d: {slower or 'none'}  ({card})")
    k1 = {ph: sum(r["count"] * r["ms"] for r in k1_rows if r["phase"] == ph)
          for ph in ("prefill", "decode")}
    for r in k1_rows:
        log(f"[time] mpmm_cuda LM {r['phase']} {r['shape']} route "
            f"{r['route']}: kernel {r['ms']:.4f} ms, plain "
            f"{r['plain_ms']:.4f} ms, library {r['library_ms']:.4f} ms "
            f"({r['library']}; kernel/library "
            f"{r['ms'] / r['library_ms']:.2f}x), bound {r['bound_ms']:.4f} "
            f"ms ({r['bound_by']}; {r['bound_ms'] / r['ms']:.1%} of it), "
            f"x{r['count']} per {r['phase']}")
    for ph in ("prefill", "decode"):
        tot = {key: sum(r["count"] * r[key] for r in k1_rows
                        if r["phase"] == ph)
               for key in ("library_ms", "plain_ms", "bound_ms")}
        by_route = {rt: sum(r["count"] * r["ms"] for r in k1_rows
                            if r["phase"] == ph and r["route"] == rt)
                    for rt in ("wgmma", "splitk")}
        log(f"[time] mpmm_cuda LM per {ph}: kernel {k1[ph]:.2f} ms (wgmma "
            f"{by_route['wgmma']:.2f}, splitk {by_route['splitk']:.2f}), "
            f"library {tot['library_ms']:.2f} ms (kernel/library "
            f"{k1[ph] / tot['library_ms']:.2f}x; kernel below library: "
            f"{k1[ph] < tot['library_ms']}), plain {tot['plain_ms']:.2f} ms, "
            f"bound {tot['bound_ms']:.4f} ms ({tot['bound_ms'] / k1[ph]:.1%} "
            f"of it)  ({card})")
    k4_prefill = sum(r["count"] * r["ms"] for r in attn_rows
                     if r["kernel"] == "flash_fwd_packed_cuda")
    k3_layer = [r["ms"] for r in attn_rows if r["kernel"] == "flash_fwd_cuda"]
    log(f"[lm-time] depth {depth}: prefill {prefill_ms:.2f} ms = "
        f"{LM_BATCH * LM_PROMPT / prefill_ms * 1e3:.1f} tokens/s; decode "
        f"{decode_ms:.2f} ms per step = {LM_BATCH / decode_ms * 1e3:.1f} "
        f"tokens/s at batch {LM_BATCH}  ({card})")
    log(f"[lm-time] prefill share: K4 {k4_prefill:.2f} ms "
        f"({k4_prefill / prefill_ms:.1%}), K1 {k1['prefill']:.2f} ms "
        f"({k1['prefill'] / prefill_ms:.1%}), rest "
        f"{prefill_ms - k4_prefill - k1['prefill']:.2f} ms "
        f"({1 - (k4_prefill + k1['prefill']) / prefill_ms:.1%}); decode "
        f"step share: K1 {k1['decode']:.2f} ms "
        f"({k1['decode'] / decode_ms:.1%}), rest "
        f"{decode_ms - k1['decode']:.2f} ms; K3 per layer {k3_layer[0]:.4f} "
        f"ms, x{depth} = {k3_layer[0] * depth:.2f} ms per "
        f"full-depth prefill")
    log("[fps] " + ", ".join(f"bucket {b}: {v:.1f} frames/s"
                             for b, v in fps.items()) + f"  ({card})")
    toks = LM_BATCH * LM_NEW
    cyc = spec["cycle_ms"]
    log(f"[time] speculative decoding, k={SPEC_K}, batch {LM_BATCH}, "
        f"{LM_PROMPT} + {LM_NEW} tokens: {toks / spec['spec_s']:.1f} "
        f"tokens/s ({spec['spec_s']:.2f} s, prefill of both views "
        f"included) against {toks / spec['verify_s']:.1f} tokens/s "
        f"verify-only ({spec['verify_s']:.2f} s); {spec['cycles']} cycles, "
        f"{sum(cyc) / len(cyc):.1f} ms a cycle (min {min(cyc):.1f}, max "
        f"{max(cyc):.1f}); accept rate {spec['accept_rate']:.4f} -- random "
        f"weights: says nothing of how often a trained draft is accepted "
        f"({card})")
    for label, r in sched.items():
        st = r["stats"]
        log(f"[time] GenerateScheduler over the {label}: {len(SCHED_TRACE)} "
            f"requests in {r['wall']:.2f} s, latency p50 "
            f"{st['p50_latency_s'] * 1e3:.1f} ms, p99 "
            f"{st['p99_latency_s'] * 1e3:.1f} ms (host clock read once a "
            f"step), accept rate {st['accept_rate']:.4f} -- random weights "
            f"({card})")
    log(f"[time] ImageScheduler: {sum(IMG_BURSTS)} images in batches "
        f"{img_batches}")
    log(f"[done] {time.perf_counter() - t_start:.1f} s")
    print(json.dumps({"kernels": kernels}))
    print(card)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
