"""Training launcher CLI (port of ``repro.launch.train``): QAT training of
an LM arch on synthetic tokens, on one device, with checkpoints.

    PYTHONPATH=src python -m repro_torch.launch.train --arch granite-8b \
        --reduced --steps 200 --batch 8 --seq 64 --ckpt-dir build/ck \
        --device cpu

``--device`` defaults to ``cuda`` and raises without a card.  A run
restores the latest checkpoint in ``--ckpt-dir`` and continues from it;
``python -m repro_torch.launch.serve --ckpt-dir DIR`` serves what it
trained.  Every LM arch trains: the dense LMs (granite-8b/34b, yi-34b,
chameleon-34b, nemotron-4-340b), olmoe-1b-7b (MoE),
deepseek-v2-lite-16b (MLA, MoE, a dense first layer), mamba2-1.3b (SSD),
recurrentgemma-9b (RG-LRU and local attention) and whisper-base (on
synthetic frames as well as tokens).  ``--production-mesh``/``--multipod``
wait for multi-device training (ROADMAP 16b (iii)).  The ResNets are not trained here: the
reference lists them but its launcher reads ``cfg.vocab``, which a ResNet
config lacks (ROADMAP Queue 3, R7); train them with
``launch.steps.make_train_step`` on ``data.pipeline.SyntheticImages``.
"""
from __future__ import annotations

import argparse
import os
import sys

import torch

from repro_torch import configs
from repro_torch.data.pipeline import SyntheticLM
from repro_torch.device import resolve_device
from repro_torch.runtime.train import TrainLoopConfig, Trainer


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__,
                                 formatter_class=argparse.RawTextHelpFormatter)
    ap.add_argument("--arch", required=True,
                    choices=configs.LM_NAMES + configs.RESNET_NAMES)
    ap.add_argument("--reduced", action="store_true",
                    help="the arch's smoke-test scale (one microbatch)")
    ap.add_argument("--steps", type=int, default=100)
    ap.add_argument("--batch", type=int, default=8)
    ap.add_argument("--seq", type=int, default=64)
    ap.add_argument("--lr", type=float, default=1e-3)
    ap.add_argument("--ckpt-dir", default="build/ckpt")
    ap.add_argument("--ckpt-every", type=int, default=50)
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--device", default="cuda",
                    help="'cuda' (default; raises without a card) or 'cpu'")
    ap.add_argument("--production-mesh", action="store_true",
                    help="not ported: multi-device training (ROADMAP 16b (iii))")
    ap.add_argument("--multipod", action="store_true",
                    help="not ported: multi-device training (ROADMAP 16b (iii))")
    args = ap.parse_args(argv)

    if args.production_mesh or args.multipod:
        raise SystemExit("--production-mesh/--multipod need multi-device "
                         "training, not ported yet (ROADMAP Queue 1, label "
                         "16b (iii)); the port trains on one device")
    if args.arch in configs.RESNET_NAMES:
        raise SystemExit(
            f"{args.arch}: launch.train trains LM archs on synthetic tokens; "
            f"the reference lists the ResNets but fails on them (R7: it "
            f"reads cfg.vocab, which ResNetConfig lacks).  Train a ResNet "
            f"with launch.steps.make_train_step on "
            f"data.pipeline.SyntheticImages")
    # a deterministic step on a card needs it before cuBLAS starts
    os.environ.setdefault("CUBLAS_WORKSPACE_CONFIG", ":4096:8")
    device = resolve_device(args.device)
    api = configs.get(args.arch, reduced=args.reduced)
    if args.reduced:
        api.microbatches = 1
    pipe = SyntheticLM(
        vocab=api.cfg.vocab, seq_len=args.seq, global_batch=args.batch,
        seed=args.seed, with_frames=api.needs_frames,
        n_audio=getattr(api.cfg, "n_audio", 0),
        d_model=getattr(api.cfg, "d_model", 0))
    cfg = TrainLoopConfig(total_steps=args.steps, ckpt_every=args.ckpt_every,
                          ckpt_dir=args.ckpt_dir, peak_lr=args.lr)
    trainer = Trainer(api, pipe, cfg, device=device)
    state, history = trainer.run(
        torch.Generator(device=device).manual_seed(args.seed))
    losses = (f"loss {history[0]:.4f} -> {history[-1]:.4f}" if history
              else "no steps left to run")
    print(f"final step {int(state['step'])}; {losses}")
    return 0


if __name__ == "__main__":
    sys.exit(main())
