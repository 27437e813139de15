#!/usr/bin/env python3
"""Drive the PyTorch port on one NVIDIA card and check it end to end.

Run from the root of a checkout:  python3 chip_smoke.py

Phases, each of which fails the run (non-zero exit, no result line):

1. Build both CUDA kernels from ``src/repro_torch/kernels/mpmm/csrc`` with
   nvcc for sm_90a, one process per source, in parallel.
2. K1 (``mpmm_cuda``) against its plain version ``mpmm_torch``: every
   weight format (w in 1/2/4/8, k dividing 8, k <= w), both variants, the
   three epilogues, ragged M/N/K, an int32-accumulator check, and the serve
   path's own shapes (stem as im2col, classifier).
3. K2 (``conv_mpmm_cuda``) against ``conv_mpmm_torch`` at every ResNet-18
   conv shape at batch 8 with the path's epilogue, and at batch 2 with
   Sum-Apart and the residual epilogue.
4. End to end: full-width ResNet-18 (224x224, width 64, 1000 classes) with
   random weights from a seeded generator, packed under
   ``examples/plans/resnet18_mixed.json`` and served by ``ImageServer`` with
   buckets (1, 2, 4, 8) for requests of 1, 3, 8 and 13 images.  The launch
   counters must show K1 twice and K2 19 times per bucket call; the logits
   are compared with the same forward through the plain versions.
5. Timing at the serve path's shapes (batch 8): each kernel, its plain
   version, one PyTorch library call for the same product, and the bound
   (the larger of bytes over 3.35 TB/s and int8 operations over 1979 TOP/s,
   the H100 SXM data-sheet peaks); frames/s per bucket.

Kernel outputs are compared bitwise with the plain version run on the CPU
copy of the same inputs -- the version the CPU tests hold bitwise against
the JAX package (numeric contract in
``src/repro_torch/kernels/mpmm/epilogue.py``).  End to end, kernel and
plain logits on the card are held to 2% of the largest logit and at most
2% flipped classifier-input codes.  Per-shape times are printed as
``[time]`` lines.

The last two lines are the kernel summary and
``{"ok": true, "device": {...}}``; nothing is printed there unless every
phase passed.
"""
from __future__ import annotations

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
CHECK_BATCH = 2     # batch of K2's extra (Sum-Apart, residual) checks
SEED = 0
E2E_LOGIT_TOL = 0.02
E2E_MAX_FLIP_RATE = 0.02
PEAK_BYTES_PER_S = 3.35e12     # H100 SXM HBM3
PEAK_INT8_OPS_PER_S = 1979e12  # H100 SXM dense int8 tensor-core peak
FORMATS = [(w, k) for w in (1, 2, 4, 8) for k in (1, 2, 4, 8) if k <= w]
EPILOGUES = ("none", "bn_relu", "bn_res_relu")


def log(msg: str) -> None:
    print(msg, flush=True)


class Smoke:
    """State of one run: the device, a seeded generator, failures."""

    def __init__(self, torch, device):
        self.torch = torch
        self.device = device
        self.gen = torch.Generator().manual_seed(SEED)
        self.failures = []
        self.max_err = {"mpmm_cuda": 0.0, "conv_mpmm_cuda": 0.0}

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


# --- phase 2: K1 -----------------------------------------------------------


def k1_call(sm, m, kdim, n, w_bits, k, epi, variant, out_dtype, act_zero):
    fmt, planes, gamma, colsum = sm.weights(kdim, n, w_bits, k)
    spec, ops = sm.epilogue(epi, (m, n), out_dtype)
    args = dict(a_biased=sm.codes((m, kdim)), planes=planes, gamma=gamma,
                colsum=colsum, **ops)
    kw = dict(fmt=fmt, act_zero=act_zero, variant=variant,
              out_dtype=out_dtype, epilogue=spec)
    return args, kw


def phase_k1(sm, path_k1):
    from repro_torch.kernels.mpmm import kernel, ref
    t = sm.torch
    for w_bits, k in FORMATS:
        for variant in ("st", "sa"):
            # int32 accumulators: gamma = 1, act_zero = 0, f32 out gives
            # float(acc) exactly; held against the oracle's own decode.
            args, kw = k1_call(sm, 100, 45, 70, w_bits, k, "none", variant,
                               t.float32, 0)
            args["gamma"] = t.ones_like(args["gamma"])
            got = kernel.mpmm_cuda(**sm.on_device(args), **kw)
            want = ref.mpmm_ref_codes(args["a_biased"], args["planes"],
                                      kw["fmt"], act_zero=0).to(t.float32)
            sm.compare("mpmm_cuda", f"K1 acc w{w_bits}k{k} {variant}", got,
                       want)
            for epi in EPILOGUES:
                for out_dtype in (t.float32, t.bfloat16):
                    args, kw = k1_call(sm, 100, 45, 70, w_bits, k, epi,
                                       variant, out_dtype, 128)
                    got = kernel.mpmm_cuda(**sm.on_device(args), **kw)
                    sm.compare("mpmm_cuda",
                               f"K1 w{w_bits}k{k} {variant} {epi} {out_dtype}",
                               got, kernel.mpmm_torch(**args, **kw))
    for call in path_k1:
        for variant in ("st", "sa"):
            kw = dict(call["kw"], variant=variant)
            got = kernel.mpmm_cuda(**call["dev"], **kw)
            sm.compare("mpmm_cuda", f"K1 path {call['name']} {variant}", got,
                       kernel.mpmm_torch(**call["cpu"], **kw))
    sm.check_phase("K1 mpmm_cuda vs mpmm_torch")


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
    from repro_torch.kernels.mpmm import ref
    name, cin, cout, kk, stride, h, w_bits, k, _ = conv
    fmt, planes, gamma, colsum = sm.weights(kk * kk * cin, cout, w_bits, k)
    ho = -(-h // stride)
    spec, ops = sm.epilogue(epi, (batch, ho, ho, cout), sm.torch.bfloat16)
    a = sm.codes((batch, h, h, cin))
    kw = dict(fmt=fmt, act_zero=128, kh=kk, kw=kk, stride=stride,
              variant=variant, out_dtype=sm.torch.bfloat16, epilogue=spec)
    cpu = dict(a_biased=a, planes=planes, gamma=gamma, colsum=colsum, **ops)
    xp = ref.pad_spatial(a, kk, kk, stride, "SAME", fill=-128)
    dev = sm.on_device(dict(cpu, a_biased=xp.contiguous()))
    dev["x_padded"] = dev.pop("a_biased")
    return cpu, dev, kw, (ho, ho)


def phase_k2(sm, convs):
    """Each conv at the path's batch with its path epilogue, and at a small
    batch with Sum-Apart and the residual epilogue."""
    from repro_torch.kernels.mpmm import conv_kernel
    for conv in convs:
        for batch, epi, variant in ((TIME_BATCH, conv[-1], "st"),
                                    (CHECK_BATCH, "bn_res_relu", "sa")):
            cpu, dev, kw, out_hw = k2_call(sm, batch, conv, epi, variant)
            got = conv_kernel.conv_mpmm_cuda(**dev, **kw, out_hw=out_hw)
            want = conv_kernel.conv_mpmm_torch(**cpu, **kw, padding="SAME")
            sm.compare("conv_mpmm_cuda",
                       f"K2 {conv[0]} B={batch} {epi} {variant}", got, want)
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

    bucket_calls = sum(-(-n // BUCKETS[-1]) for n in REQUESTS)
    kernel.mpmm_cuda.launches = 0
    conv_kernel.conv_mpmm_cuda.launches = 0
    outs = [server.predict(x) for x in requests]
    t.cuda.synchronize()
    launches = {"mpmm_cuda": kernel.mpmm_cuda.launches,
                "conv_mpmm_cuda": conv_kernel.conv_mpmm_cuda.launches}
    log(f"[e2e] {bucket_calls} bucket calls, launches {launches}, "
        f"compiled buckets {server.compiled_buckets}")
    if launches != {"mpmm_cuda": 2 * bucket_calls,
                    "conv_mpmm_cuda": 19 * bucket_calls}:
        raise SystemExit(f"launch counts {launches} != 2 and 19 per bucket "
                         f"call ({bucket_calls} calls)")

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
    return server, cfg, plan, launches, requests


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


def measure(sm, path_k1, convs):
    from repro_torch.kernels.mpmm import conv_kernel, kernel, ref
    t = sm.torch
    t.backends.cuda.matmul.allow_tf32 = False
    t.backends.cudnn.allow_tf32 = False
    rows = []
    for call in path_k1:
        d, kw = call["dev"], call["kw"]
        out = kernel.mpmm_cuda(**d, **kw)
        w8 = ref.combined_int8_weights(d["planes"], kw["fmt"])
        m, kdim, n = call["m"], call["k"], call["n"]
        if m > 16 and kdim % 8 == 0 and n % 8 == 0:
            lib_name = "torch._int_mm (int8)"
            lib = lambda: t._int_mm(d["a_biased"], w8)  # noqa: E731
        else:  # _int_mm needs M > 16 and K, N multiples of 8
            af, wf = d["a_biased"].float(), w8.float()
            lib_name = "torch.mm (f32, TF32 off)"
            lib = lambda: t.mm(af, wf)  # noqa: E731
        by = nbytes(d["a_biased"], d["planes"], d["gamma"], d["colsum"],
                    d.get("scale"), d.get("shift"), d.get("residual"), out)
        b_ms, b_by = bound_ms(by, 2 * m * n * kdim)
        rows.append({
            "kernel": "mpmm_cuda", "layer": call["name"],
            "shape": f"M={m} K={kdim} N={n} w{kw['fmt'].w_bits}k{kw['fmt'].k}",
            "ms": sm.time_ms(lambda: kernel.mpmm_cuda(**d, **kw)),
            "plain_ms": sm.time_ms(lambda: kernel.mpmm_torch(**d, **kw)),
            "library_ms": sm.time_ms(lib), "library": lib_name,
            "bound_ms": b_ms, "bound_by": b_by, "bytes": by,
            "ops": 2 * m * n * kdim})
    for conv in convs:
        cpu, dev, kw, out_hw = k2_call(sm, TIME_BATCH, conv, conv[-1], "st")
        out = conv_kernel.conv_mpmm_cuda(**dev, **kw, out_hw=out_hw)
        plain_args = dict(dev, a_biased=cpu["a_biased"].to(sm.device))
        plain_args.pop("x_padded")
        name, cin, cout, kk, stride = conv[:5]
        xf = dev["x_padded"].permute(0, 3, 1, 2).float().contiguous(
            memory_format=t.channels_last)
        wf = (ref.combined_int8_weights(dev["planes"], kw["fmt"])
              .reshape(kk, kk, cin, cout).permute(3, 2, 0, 1).float()
              .contiguous(memory_format=t.channels_last))
        m = out.shape[0] * out_hw[0] * out_hw[1]
        kdim = kk * kk * cin
        by = nbytes(dev["x_padded"], dev["planes"], dev["gamma"],
                    dev["colsum"], dev.get("scale"), dev.get("shift"),
                    dev.get("residual"), out)
        b_ms, b_by = bound_ms(by, 2 * m * cout * kdim)
        rows.append({
            "kernel": "conv_mpmm_cuda", "layer": name,
            "shape": (f"B={TIME_BATCH} H={conv[5]} C={cin} N={cout} "
                      f"{kk}x{kk}/{stride} w{conv[6]}k{conv[7]} {conv[-1]}"),
            "ms": sm.time_ms(lambda: conv_kernel.conv_mpmm_cuda(
                **dev, **kw, out_hw=out_hw)),
            "plain_ms": sm.time_ms(lambda: conv_kernel.conv_mpmm_torch(
                **plain_args, **kw, padding="SAME")),
            "library_ms": sm.time_ms(lambda: t.nn.functional.conv2d(
                xf, wf, stride=stride)),
            "library": "F.conv2d (f32, TF32 off, channels_last)",
            "bound_ms": b_ms, "bound_by": b_by, "bytes": by,
            "ops": 2 * m * cout * kdim})
    return rows


def summarize(rows, launches, max_err):
    out = []
    for name, src, replaces in (
            ("mpmm_cuda", "src/repro_torch/kernels/mpmm/csrc/mpmm.cu",
             "src/repro/kernels/mpmm/kernel.py:164"),
            ("conv_mpmm_cuda",
             "src/repro_torch/kernels/mpmm/csrc/conv_mpmm.cu",
             "src/repro/kernels/mpmm/conv_kernel.py:140")):
        rs = [r for r in rows if r["kernel"] == name]
        by_bytes = sum(r["bound_ms"] for r in rs if r["bound_by"] == "bytes")
        by_ops = sum(r["bound_ms"] for r in rs if r["bound_by"] != "bytes")
        out.append({
            "name": name, "route": "cuda", "source": src,
            "replaces": replaces, "launches": launches[name],
            "max_abs_err": max_err[name],
            "ms": sum(r["ms"] for r in rs),
            "plain_ms": sum(r["plain_ms"] for r in rs),
            "bound_ms": by_bytes + by_ops,
            "bound_by": "bytes" if by_bytes >= by_ops else "operations",
            "library_ms": sum(r["library_ms"] for r in rs)})
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
    card = card_line()
    log(f"[card] {card}; torch {torch.__version__}, CUDA {torch.version.cuda}")

    built = _build.build_all()
    log(f"[build] {sorted(_build.KERNEL_SOURCES)} built in "
        f"{built['seconds']:.2f} s (parallel nvcc)")
    for name, text in built["logs"].items():
        for line in text.splitlines():
            if "registers" in line or "spill" in line:
                log(f"[build] {name}: {line.strip()}")

    sm = Smoke(torch, device)
    cfg = configs.get(ARCH).cfg
    plan = PrecisionPlan.load(PLAN)
    path_k1 = path_k1_calls(sm, cfg, plan, TIME_BATCH)
    convs = resnet_convs(cfg, plan)
    if len(convs) != 19:
        raise SystemExit(f"expected 19 K2 convs, found {len(convs)}")

    phase_k1(sm, path_k1)
    phase_k2(sm, convs)
    server, cfg, plan, launches, _ = phase_end_to_end(sm)
    fps = frames_per_second(sm, server, cfg)
    rows = measure(sm, path_k1, convs)
    kernels = summarize(rows, launches, sm.max_err)
    for r in rows:
        log(f"[time] {r['kernel']} {r['layer']:7s} {r['shape']}: kernel "
            f"{r['ms']:.4f} ms, plain {r['plain_ms']:.4f} ms, library "
            f"{r['library_ms']:.4f} ms, bound {r['bound_ms']:.4f} ms "
            f"({r['bound_by']})")
    log("[fps] " + ", ".join(f"bucket {b}: {v:.1f} frames/s"
                             for b, v in fps.items()) + f"  ({card})")
    log(f"[done] {time.perf_counter() - t_start:.1f} s")
    print(json.dumps({"kernels": kernels}))
    print(card)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
