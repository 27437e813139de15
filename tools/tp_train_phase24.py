#!/usr/bin/env python3
"""``chip_smoke.py`` phase 24 alone: tensor-parallel QAT training over
'model' of olmoe-1b-7b x2, deepseek-v2-lite-16b x2 (its dense first layer
and one MoE layer) and whisper-base whole on a (1, 2) mesh of two ranks
sharing the card, held to the one-device step.

Run from the root of a checkout on a machine with one NVIDIA card:

    python3 tools/tp_train_phase24.py

The training path reaches no CUDA kernel of the port, so nothing is
built: a rank that would run nvcc fails.  Runs ``chip_smoke.phase_p24``
(its checks fail the run) and prints its ``[p24-time]`` lines beside the
card's name and power limit.  A rank started by ``launch.mesh.spawn``
re-imports the main module, so the phase must be run from a file, not
from stdin.  Exits non-zero without a card or where a check fails.
"""
from __future__ import annotations

import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT / "src"))
sys.path.insert(0, str(ROOT))

import chip_smoke as cs  # noqa: E402


def main() -> int:
    import torch
    if not torch.cuda.is_available():
        print("tp_train_phase24: torch sees no CUDA device", file=sys.stderr)
        return 2
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    card = cs.card_line()
    cs.log(card)
    t0 = time.perf_counter()
    try:
        cs.phase_p24(cs.Smoke(torch, torch.device("cuda", 0)), card)
    finally:
        cs.remove_shm_run()
    cs.log(f"[tp_train_phase24] {time.perf_counter() - t0:.1f} s")
    return 0


if __name__ == "__main__":
    sys.exit(main())
