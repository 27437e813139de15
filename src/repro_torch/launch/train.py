"""Training launcher CLI (port of ``repro.launch.train``): QAT training of
an LM arch on synthetic tokens, with checkpoints, on one device or
data-parallel with FSDP over a (world, 1) mesh.

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
synthetic frames as well as tokens).

Under ``torchrun`` (``WORLD_SIZE`` set) every rank trains on
``launch.mesh.make_train_mesh``'s mesh, (world, 1) by default; alone,
``--devices N`` starts N ranks (``launch.mesh.spawn``, one process each,
ranks sharing the cards round-robin over gloo where N exceeds them).
``--mesh DATAxMODEL`` lays the world out as (data, model): a 'model'
axis above 1 trains tensor-parallel, which the dense decoders
(granite-8b/34b, yi-34b, chameleon-34b, nemotron-4-340b), olmoe-1b-7b
(expert parallelism), deepseek-v2-lite-16b (MLA by heads) and
whisper-base do; mamba2-1.3b and recurrentgemma-9b refuse, naming
ROADMAP 16b (iv) (c).  Rank 0 prints and writes the checkpoints;
``--ckpt-dir`` restores onto any mesh.
``--production-mesh``/``--multipod`` build the reference's 16 x 16 and 2
x 16 x 16 meshes (256 and 512 ranks, under ``torchrun``); a world of
another size is told the world it needs.  The ResNets are not trained here: the
reference lists them but its launcher reads ``cfg.vocab``, which a ResNet
config lacks (ROADMAP Queue 3, R7); train them with
``launch.steps.make_train_step`` on ``data.pipeline.SyntheticImages``.
"""
from __future__ import annotations

import argparse
import math
import os
import sys

import torch

from repro_torch import configs
from repro_torch.data.pipeline import SyntheticLM
from repro_torch.device import resolve_device
from repro_torch.launch import mesh as mesh_lib
from repro_torch.nn import partitioning as part
from repro_torch.runtime.train import TrainLoopConfig, Trainer


def main(argv=None) -> int:
    argv = list(sys.argv[1:] if argv is None else argv)
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
    ap.add_argument("--devices", type=int, default=None, metavar="N",
                    help="train data-parallel over N local ranks (one "
                         "process each); under torchrun the world is used")
    ap.add_argument("--mesh", default=None, metavar="DATAxMODEL",
                    help="lay the world out as (data, model), e.g. 1x2: "
                         "tensor-parallel over 'model' (default: all "
                         "ranks data-parallel)")
    ap.add_argument("--production-mesh", action="store_true",
                    help="the 16x16 (data, model) mesh of 256 ranks")
    ap.add_argument("--multipod", action="store_true",
                    help="the 2x16x16 (pod, data, model) mesh of 512 ranks")
    args = ap.parse_args(argv)

    shape = None
    if args.production_mesh or args.multipod:
        shape = (2, 16, 16) if args.multipod else (16, 16)
    elif args.mesh is not None:
        shape = mesh_lib.parse_mesh_spec(args.mesh)
    if shape is not None and args.arch not in configs.RESNET_NAMES:
        names = ("pod", "data", "model")[-len(shape):]
        try:
            part.require_train_mesh(dict(zip(names, shape)),
                                    configs.get(args.arch).family)
        except NotImplementedError as e:
            raise SystemExit(f"--mesh/--production-mesh/--multipod: {e}"
                             ) from None
    if args.arch in configs.RESNET_NAMES:
        raise SystemExit(
            f"{args.arch}: launch.train trains LM archs on synthetic tokens; "
            f"the reference lists the ResNets but fails on them (R7: it "
            f"reads cfg.vocab, which ResNetConfig lacks).  Train a ResNet "
            f"with launch.steps.make_train_step on "
            f"data.pipeline.SyntheticImages")
    if args.devices is not None and args.devices < 1:
        raise SystemExit(f"--devices must be >= 1, got {args.devices}")
    # a deterministic step on a card needs it before cuBLAS starts (and
    # before spawned ranks start, which inherit it)
    os.environ.setdefault("CUBLAS_WORKSPACE_CONFIG", ":4096:8")
    env = os.environ.get("WORLD_SIZE")
    if shape is not None:
        need = math.prod(shape)
        world = int(env) if env is not None else (args.devices or 1)
        if world != need:
            raise SystemExit(
                f"the {'x'.join(map(str, shape))} mesh ('model' axis of "
                f"{shape[-1]}, tensor-parallel training, ROADMAP Queue 1, "
                f"label 16b (iv)) needs a world of {need} ranks; this "
                f"one has {world}: start them under torchrun "
                f"--nproc-per-node (and --nnodes), or with --devices {need}")
    if env is None and (args.devices or 1) > 1:
        return _spawn(args, argv)
    if env is not None and args.devices not in (None, int(env)):
        raise SystemExit(f"--devices {args.devices} but torchrun's world "
                         f"has {env} ranks")
    mesh = None
    if env is not None or args.devices is not None:
        mesh = mesh_lib.make_train_mesh(shape, device=args.device,
                                        devices=_rank_devices(args))
        print(f"[train] mesh {dict(mesh_lib.mesh_axes(mesh))} over "
              f"{mesh_lib.chips(mesh)} ranks, this rank on "
              f"{mesh_lib.local_device(mesh)}")
        device = mesh_lib.local_device(mesh)
    else:
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
    trainer = Trainer(api, pipe, cfg, device=device, mesh=mesh)
    state, history = trainer.run(
        torch.Generator(device=device).manual_seed(args.seed))
    losses = (f"loss {history[0]:.4f} -> {history[-1]:.4f}" if history
              else "no steps left to run")
    print(f"final step {int(state['step'])}; {losses}")
    return 0


def _rank_devices(args):
    """Each rank's device where the world's ranks outnumber the cards
    (they share them round-robin, over gloo), else None."""
    if torch.device(args.device).type != "cuda":
        return None
    world = int(os.environ.get("WORLD_SIZE", "1"))
    cards = torch.cuda.device_count()
    if cards and world > cards:
        return [f"cuda:{r % cards}" for r in range(world)]
    return None


def _rank_main(rank: int, argv) -> int:
    """One spawned rank: rank 0 prints, the others run silently."""
    if rank:
        sys.stdout = open(os.devnull, "w")
    return main(argv)


def _spawn(args, argv) -> int:
    """``--devices N`` alone: N ranks in one world, each running ``main``
    over the world."""
    import tempfile
    n = args.devices
    cpu = torch.device(args.device).type == "cpu"
    shared = not cpu and n > torch.cuda.device_count()
    with tempfile.TemporaryDirectory() as store:
        rcs = mesh_lib.spawn(_rank_main, n, (argv,), store_dir=store,
                             backend="gloo" if cpu or shared else "nccl",
                             timeout_s=24 * 3600.0)
    return max(rcs)


if __name__ == "__main__":
    sys.exit(main())
