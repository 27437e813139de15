"""Serving launcher CLI (port of ``repro.launch.serve``): packed
mixed-precision batched generation and image serving on one device.

    PYTHONPATH=src python -m repro_torch.launch.serve --arch granite-8b \
        --reduced --plan examples/plans/granite_8b_mixed.json --batch 4 \
        --device cpu
    PYTHONPATH=src python -m repro_torch.launch.serve --arch granite-8b \
        --reduced --plan examples/plans/granite_8b_mixed.json \
        --spec-decode 4 --draft-plan examples/plans/granite_8b_draft_w2.json \
        --trace out.json --metrics-dump out.prom --device cpu
    PYTHONPATH=src python -m repro_torch.launch.serve --arch resnet18 \
        --reduced --plan examples/plans/resnet18_mixed.json --batch 8 \
        --device cpu

Weights are drawn from ``--seed`` (no checkpoint store yet) and packed under
the plan (``--plan``; else the arch's default uniform policy).  LM archs
run batched greedy generation through ``Generator``, or with
``--spec-decode K --draft-plan PLAN`` through ``SpeculativeGenerator``: a
low-bit repack of the same weights drafts K tokens a cycle and the
serving plan verifies them in one batched forward, with output equal to
serving the plan alone.  CNN archs serve a batch of images through
``ImageServer``.  The weights are drawn on ``--device`` and packed piece by
piece (``serve.init_packed_views``), so a full-width LM never holds its
float tree whole.

``--device`` defaults to ``cuda`` (the hand-written kernels) and raises
without a card; ``--device cpu`` runs the kernels' plain versions.
``--trace OUT.json`` exports a Chrome trace of the run, ``--metrics-dump
OUT.prom`` the metrics registry in Prometheus text, ``--profile DIR`` a
``torch.profiler`` trace of the measured section (``DIR/trace.json``).

Flags of the JAX launcher that wait for modules the port lacks, by their
ROADMAP Queue 1 label: ``--mesh``/``--devices``/``--xla-serving-flags``
(multi-device, label 16), ``--frontier``/``--slo-ms`` (the control plane,
label 13), ``--ckpt-dir`` (the checkpoint store, with QAT training, label
15), ``--fp-baseline`` (the slice-1 leftovers), and the roofline
attribution printed after a traced run (the Hopper cost model, label 8).
``--w-bits``/``--k``/``--channel-wise`` (a uniform policy) are left out:
a plan file says the same.
"""
from __future__ import annotations

import argparse
import contextlib
import os
import sys
import time

import numpy as np
import torch

from repro_torch import configs
from repro_torch.core.plan import PrecisionPlan
from repro_torch.device import resolve_device
from repro_torch.runtime.serve import (Generator, ImageServer,
                                       init_packed_views)
from repro_torch.runtime.telemetry import (NULL_METRICS, NULL_TRACER,
                                           MetricsRegistry, Tracer,
                                           device_time_split)


def _mk_telemetry(args):
    """(tracer, metrics): live objects only when a telemetry flag is set,
    else the shared no-op pair."""
    if args.trace or args.metrics_dump or args.profile:
        return Tracer(), MetricsRegistry()
    return NULL_TRACER, NULL_METRICS


@contextlib.contextmanager
def _profiled(profile_dir, device):
    """``--profile DIR``: a torch.profiler trace of the block (host, and
    the card's kernels on CUDA) written to DIR/trace.json."""
    if not profile_dir:
        yield
        return
    acts = [torch.profiler.ProfilerActivity.CPU]
    if device.type == "cuda":
        acts.append(torch.profiler.ProfilerActivity.CUDA)
    with torch.profiler.profile(activities=acts) as prof:
        yield
    os.makedirs(profile_dir, exist_ok=True)
    path = os.path.join(profile_dir, "trace.json")
    prof.export_chrome_trace(path)
    print(f"[serve] torch.profiler trace -> {path}")


def _sync(device) -> None:
    if device.type == "cuda":
        torch.cuda.synchronize(device)


def _tree_bytes(tree) -> int:
    if isinstance(tree, torch.Tensor):
        return tree.numel() * tree.element_size()
    if isinstance(tree, dict):
        return sum(_tree_bytes(v) for v in tree.values())
    if isinstance(tree, (list, tuple)):
        return sum(_tree_bytes(v) for v in tree)
    return 0


def _export_telemetry(args, tracer, metrics) -> None:
    if args.trace and tracer.enabled:
        tracer.export(args.trace)
        split = device_time_split(tracer)
        print(f"[serve] trace -> {args.trace} "
              f"({len(tracer.events)} events, {tracer.dropped} dropped; "
              f"device calls {split['calls']}: "
              f"dispatch {split['dispatch_s'] * 1e3:.1f}ms + "
              f"device {split['device_s'] * 1e3:.1f}ms)")
    if args.metrics_dump and metrics.enabled:
        with open(args.metrics_dump, "w") as f:
            f.write(metrics.prometheus_text())
        print(f"[serve] metrics -> {args.metrics_dump} "
              f"({len(metrics.names())} metrics)")


def _tag(api, args) -> str:
    pol = api.policy
    if isinstance(pol, PrecisionPlan):
        bits = sorted({lp.w_bits for _, lp in pol.layers}
                      | {pol.default.w_bits})
        return (f"plan [{pol.name or args.plan}] w_bits "
                f"{'/'.join(map(str, bits))}")
    return f"w_Q={pol.inner_bits} k={pol.k}"


def _serve_cnn(api, args, device) -> int:
    """Batched image serving of a packed CNN."""
    mod, cfg = api.mod, api.cfg
    gen = torch.Generator(device=device).manual_seed(args.seed)
    t0 = time.perf_counter()
    params = api.init_params(gen, device=device)
    state = mod.init_bn_state(api.specs(), device=device)
    packed = mod.pack_for_serve(cfg, params, state, api.policy)
    del params, state
    _sync(device)
    print(f"[serve] packed {args.arch} [{_tag(api, args)}]: "
          f"{_tree_bytes(packed) / 2**20:.1f} MiB in "
          f"{time.perf_counter() - t0:.2f}s on {device}")
    plan = api.policy if isinstance(api.policy, PrecisionPlan) else None
    tracer, metrics = _mk_telemetry(args)
    server = ImageServer(api=api, params=packed, plan=plan,
                         batch_buckets=(args.batch,), device=device,
                         tracer=tracer, metrics=metrics)
    imgs = np.asarray(np.random.default_rng(args.seed).normal(
        0.4, 0.5, (args.batch, cfg.img_size, cfg.img_size, 3)), np.float32)
    server.predict(imgs)  # builds the kernels on a card
    t0 = time.perf_counter()
    with _profiled(args.profile, device):
        logits = server.predict(imgs)  # host numpy: synchronised
    dt = time.perf_counter() - t0
    print(f"[serve] {args.batch} images in {dt:.3f}s -> "
          f"{args.batch / dt:.1f} images/s (img {cfg.img_size}, "
          f"logits {logits.shape})")
    _export_telemetry(args, tracer, metrics)
    return 0


def _serve_lm(api, args, device) -> int:
    """Batched greedy generation, plain or speculative."""
    tracer, metrics = _mk_telemetry(args)
    gen_w = torch.Generator(device=device).manual_seed(args.seed)
    t0 = time.perf_counter()
    if args.spec_decode is not None:
        # One weight draw, two packed views: the serving plan verifies, a
        # low-bit repack drafts (runtime/specdec.py).
        from repro_torch.runtime.specdec import SpeculativeGenerator
        dplan = PrecisionPlan.load(args.draft_plan)
        dplan.validate_layers(api.plan_layer_names())
        views = init_packed_views(api, [api.policy, dplan], gen_w,
                                  device=device)
        gen = SpeculativeGenerator(
            api=api, packed_views=tuple(views), draft_plan=dplan,
            k=args.spec_decode, device=device, tracer=tracer,
            metrics=metrics)
        _sync(device)
        print(f"[serve] packed {args.arch} at {_tag(api, args)} + draft "
              f"point [{dplan.name or args.draft_plan}] from one weight "
              f"draw in {time.perf_counter() - t0:.2f}s on {device} "
              f"(spec-decode k={args.spec_decode})")
    else:
        packed = init_packed_views(api, [api.policy], gen_w,
                                   device=device)[0]
        _sync(device)
        print(f"[serve] packed {args.arch} at {_tag(api, args)}: "
              f"{_tree_bytes(packed) / 2**20:.1f} MiB in "
              f"{time.perf_counter() - t0:.2f}s on {device}")
        gen = Generator(api=api, params=packed, device=device,
                        tracer=tracer, metrics=metrics)
    prompts = np.asarray(np.random.default_rng(args.seed).integers(
        0, api.cfg.vocab, (args.batch, args.prompt_len)), np.int32)
    # warm-up (builds the kernels on a card); spec mode runs one full cycle
    warm = (2 if args.spec_decode is None
            else min(args.new_tokens, args.spec_decode + 2))
    gen.generate(prompts, warm)
    if args.spec_decode is not None:
        gen.drafted_tokens = gen.accepted_tokens = 0  # drop warm-up stats
    t0 = time.perf_counter()
    with _profiled(args.profile, device):
        out = gen.generate(prompts, args.new_tokens)  # numpy: synchronised
    dt = time.perf_counter() - t0
    toks = args.batch * args.new_tokens
    print(f"[serve] {toks} tokens in {dt:.2f}s -> {toks / dt:.1f} tok/s "
          f"(batch {args.batch}, prompt {args.prompt_len})")
    if args.spec_decode is not None:
        print(f"[serve] specdec accept rate {gen.accept_rate:.3f} "
              f"({gen.accepted_tokens}/{gen.drafted_tokens} drafted tokens "
              f"accepted at k={args.spec_decode})")
    print(f"[serve] sample: {out[0, :12].tolist()}")
    _export_telemetry(args, tracer, metrics)
    return 0


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__,
                                 formatter_class=argparse.RawTextHelpFormatter)
    ap.add_argument("--arch", required=True,
                    choices=configs.RESNET_NAMES + configs.LM_NAMES)
    ap.add_argument("--reduced", action="store_true",
                    help="the arch's smoke-test scale")
    ap.add_argument("--plan", default=None,
                    help="layer-wise precision plan JSON, validated against "
                         "the arch's layer namespace")
    ap.add_argument("--spec-decode", type=int, default=None, metavar="K",
                    help="speculative decoding: draft K tokens a cycle on a "
                         "low-bit repack of the same weights and verify them "
                         "in one batched forward on the serving plan (LM "
                         "archs; greedy output equals the plan's alone)")
    ap.add_argument("--draft-plan", default=None, metavar="PLAN.json",
                    help="precision plan of the --spec-decode draft point "
                         "(e.g. examples/plans/granite_8b_draft_w2.json)")
    ap.add_argument("--batch", type=int, default=4)
    ap.add_argument("--prompt-len", type=int, default=16)
    ap.add_argument("--new-tokens", type=int, default=32)
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--device", default="cuda",
                    help="'cuda' (default: the kernels; raises without a "
                         "card) or 'cpu' (the plain versions)")
    ap.add_argument("--trace", default=None, metavar="OUT.json",
                    help="export a Chrome trace_event JSON of the run")
    ap.add_argument("--metrics-dump", default=None, metavar="OUT.prom",
                    help="dump the metrics registry in Prometheus text "
                         "exposition format at exit")
    ap.add_argument("--profile", default=None, metavar="DIR",
                    help="capture a torch.profiler trace of the measured "
                         "section into DIR/trace.json")
    args = ap.parse_args(argv)

    device = resolve_device(args.device)
    plan = PrecisionPlan.load(args.plan) if args.plan is not None else None
    api = configs.get(args.arch, reduced=args.reduced, policy=plan)
    if plan is not None:
        plan.validate_layers(api.plan_layer_names())
    if args.spec_decode is not None:
        if args.draft_plan is None:
            raise SystemExit("--spec-decode requires --draft-plan")
        if api.family == "cnn":
            raise SystemExit("--spec-decode serves autoregressive LM archs "
                             "only")
    if api.family == "cnn":
        return _serve_cnn(api, args, device)
    return _serve_lm(api, args, device)


if __name__ == "__main__":
    sys.exit(main())
