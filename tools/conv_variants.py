#!/usr/bin/env python3
"""Where K2's time per K-step goes: variants of ``csrc/conv_mpmm.cu`` with
one part of the Sum-Together loop removed or changed, timed side by side.

Run from the root of a checkout on a machine with one NVIDIA card:

    python3 tools/conv_variants.py

Copies the kernel's sources into ``build/conv_variants/<variant>/``,
patches each copy (the w2k2 instantiations only, to build fast), builds
them in parallel with the repo's nvcc flags, and times each at a few
ResNet-18 convs with the split forced to 1 (so the per-K-step cost shows
as a slope), as device time (``chip_smoke.Smoke.graph_ms``).  The
variants' outputs are wrong by design; only their times mean anything.
Variants: ``base`` (the kernel as it is), ``no_decode`` (B is decoded
once, not each K-step), ``no_mma``, ``no_lda`` / ``no_ldb`` (the A / B
tile loaded only for the first stages), ``contiguous_a`` (A loaded from
consecutive addresses, no gather), ``stages6`` (a six-stage ring),
``no_fences`` (the loop's two ``fence.proxy.async`` removed) and ``empty``
(no decode and no loads in the loop).  Prints one ``[variants]``
line per conv; exits non-zero without a card.
"""
from __future__ import annotations

import ctypes
import dataclasses
import shutil
import subprocess
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT / "src"))
sys.path.insert(0, str(ROOT))

SRC = ROOT / "src" / "repro_torch" / "kernels" / "mpmm" / "csrc"
OUT = ROOT / "build" / "conv_variants"
MMA = """      tc::mma_step<1, BN>(acc, slot(u), btile + (u & 1) * B_BYTES, wgi,
                          false);
"""
LOAD = MMA + "      load(u + STAGES - 1);\n"
DEC = """        tc::decode_stage<W, K, false, BN>(
            slot(u + 1) + A_BYTES, btile + ((u + 1) & 1) * B_BYTES, 0);
"""
FENCE_A = ("        cp_wait<STAGES - 2>();\n        wg::fence_proxy();\n",
           "        cp_wait<STAGES - 2>();\n")
FENCE_B = ("0);\n        wg::fence_proxy();\n      }\n", "0);\n      }\n")
LDA = "      load_a(slot(u), x, g, rows, t0 + u, tap);\n"
LDB = "      load_b<W, K, BN>(slot(u) + A_BYTES, planes, g, n0, t0 + u);\n"
CONTIGUOUS_A = """  if (g.vec_a) {
    const int c = threadIdx.x & 7;
#pragma unroll
    for (int j = 0; j < BM * 8 / THREADS; ++j) {
      const int r = (threadIdx.x >> 3) + j * (THREADS / 8);
      cp_async16(at + r * 128 + (((c ^ r) & 7) << 4),
                 x + ((static_cast<size_t>(t) * BM + r) * 8 + c) % 1536 * 16,
                 true);
    }
  } else {"""
VARIANTS = {
    "base": [],
    "no_decode": [(DEC, "")],
    "no_mma": [(MMA, "")],
    "no_lda": [(LDA, "      if (u < STAGES - 1) " + LDA.lstrip())],
    "no_ldb": [(LDB, "      if (u < STAGES - 1) " + LDB.lstrip())],
    "contiguous_a": "contiguous_a",
    "stages6": [("constexpr int STAGES = 4;", "constexpr int STAGES = 6;")],
    "no_fences": [FENCE_A, FENCE_B],
    "empty": [(DEC, ""), (LOAD, MMA + "      cp_commit();\n")],
}
CASES = (("s3b1c1", 1), ("s3b1c1", 8), ("s2b1c1", 8), ("s1b1c2", 8))


def build(name, patches, nvcc, flags):
    d = OUT / name
    d.mkdir(parents=True, exist_ok=True)
    for f in SRC.glob("*.cu*"):
        shutil.copy(f, d / f.name)
    src = (d / "conv_mpmm.cu").read_text()
    src = src.replace("K1_FORMATS(K1_FORMAT_CASE, K2_PICK)",
                      "K1_FORMAT_CASE(2, 2, K2_PICK)")
    if patches == "contiguous_a":
        a = src.index("  if (g.vec_a) {")
        end = "\n  } else {\n    for (int i = threadIdx.x; i < BM * BK"
        b = src.index(end, a)
        src = src[:a] + CONTIGUOUS_A + src[b + len("\n  } else {"):]
        patches = []
    for old, new in patches:
        if old not in src:
            raise SystemExit(f"variant {name}: the kernel no longer has "
                             f"{old.strip()!r}")
        src = src.replace(old, new)
    (d / "conv_mpmm.cu").write_text(src)
    return subprocess.Popen(
        [nvcc, *flags, "-o", str(d / "lib.so"), str(d / "conv_mpmm.cu")],
        stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)


def main() -> int:
    import torch
    if not torch.cuda.is_available():
        print("conv_variants: torch sees no CUDA device", file=sys.stderr)
        return 2
    import chip_smoke as cs
    from repro_torch import configs
    from repro_torch.core.plan import PrecisionPlan
    from repro_torch.kernels import _build
    from repro_torch.kernels.mpmm import conv_kernel as ck

    nvcc = _build.nvcc_path()
    flags = (*_build.NVCC_FLAGS,  # the variants instantiate w2k2 only
             *_build.KERNEL_DEFINES[_build.format_lib("conv_mpmm", 2)])
    procs = {n: build(n, p, nvcc, flags) for n, p in VARIANTS.items()}
    libs = {}
    for name, proc in procs.items():
        log, _ = proc.communicate()
        if proc.returncode:
            raise SystemExit(f"variant {name} failed to build:\n{log}")
        for line in cs.ptxas_lines(log):
            if "2,2,false,128" in line:
                print(f"[variants] build {name}: {line}", flush=True)
        lib = ctypes.CDLL(str(OUT / name / "lib.so"))
        lib.conv_mpmm_launch.argtypes = ([ctypes.c_void_p] * 10
                                         + [ctypes.c_int] * 22
                                         + [ctypes.c_void_p])
        lib.conv_mpmm_launch.restype = ctypes.c_int
        libs[name] = lib

    sm = cs.Smoke(torch, torch.device("cuda", 0))
    cfg = configs.get(cs.ARCH).cfg
    convs = {c[0]: c for c in cs.resnet_convs(cfg,
                                               PrecisionPlan.load(cs.PLAN))}
    print(f"[variants] {cs.card_line()}", flush=True)
    chosen, real_lib = ck.conv_plan, ck._lib
    try:
        for name, batch in CASES:
            conv = convs[name]
            _, cin, cout, kk, stride, h = conv[:6]
            ho = -(-h // stride)
            _, dev, kw = cs.k2_call(sm, batch, conv, conv[-1], "st")
            plan = dataclasses.replace(
                chosen(batch, ho, ho, cout, kk * kk * cin, kw["fmt"]),
                steps=-(-kk * kk * cin // ck.BK), splits=1)
            ck.conv_plan = lambda *a, p=plan: p  # noqa: E731
            times = []
            for vname, lib in libs.items():
                ck._lib = lambda lib=lib: lib  # noqa: E731
                ms = sm.graph_ms(lambda: ck.conv_mpmm_cuda(**dev, **kw))
                times.append(f"{vname} {ms:.4f}")
            print(f"[variants] {name} B={batch} {plan.steps} K-steps, "
                  f"{plan.blocks} blocks, ms: " + ", ".join(times),
                  flush=True)
    finally:
        ck.conv_plan, ck._lib = chosen, real_lib
    return 0


if __name__ == "__main__":
    sys.exit(main())
