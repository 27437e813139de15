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

A uniform policy comes from ``--w-bits``/``--k``/``--channel-wise``, the
floating-point baseline (bf16 weights, plain bf16 products) from
``--fp-baseline``.  ``--frontier MANIFEST --slo-ms MS`` packs every plan
point of a frontier manifest from one weight draw and pushes a burst of
requests through ``runtime.slo.SLOScheduler``, which degrades to faster
points under deadline pressure and recovers when the queue clears:

    PYTHONPATH=src python -m repro_torch.launch.serve --arch resnet18 \
        --reduced --frontier examples/frontiers/resnet18_frontier.json \
        --slo-ms 4000 --device cpu

After a timed run the ``[serve] roofline:`` lines attribute its device
time (CUDA events on the card) across the model's layers against the H100
cost model (``runtime.telemetry.layer_attribution``): the share of the
roofline reached and the achieved TOps/s.

``--device`` defaults to ``cuda`` (the hand-written kernels) and raises
without a card; ``--device cpu`` runs the kernels' plain versions.
``--trace OUT.json`` exports a Chrome trace of the run, ``--metrics-dump
OUT.prom`` the metrics registry in Prometheus text, ``--profile DIR`` a
``torch.profiler`` trace of the measured section (``DIR/trace.json``).

Flags of the JAX launcher that wait for modules the port lacks, by their
ROADMAP Queue 1 label: ``--mesh``/``--devices``/``--xla-serving-flags``
(multi-device, label 16) and ``--ckpt-dir`` (the checkpoint store, with
QAT training, label 15).
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
from repro_torch.core.plan import FrontierManifest, PrecisionPlan
from repro_torch.core.precision import PrecisionPolicy
from repro_torch.device import resolve_device
from repro_torch.runtime.serve import (Generator, ImageServer,
                                       init_packed_views)
from repro_torch.runtime.telemetry import (NULL_METRICS, NULL_TRACER,
                                           MetricsRegistry, Tracer,
                                           device_time_split,
                                           layer_attribution)


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


def _timed(fn, device):
    """(fn(), wall s, device s): the device time between CUDA events
    recorded around the call on a card, the host clock on the CPU (where
    torch runs synchronously)."""
    if device.type == "cuda":
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        _sync(device)
        t0 = time.perf_counter()
        start.record()
        out = fn()
        end.record()
        end.synchronize()
        return out, time.perf_counter() - t0, start.elapsed_time(end) / 1e3
    t0 = time.perf_counter()
    out = fn()
    dt = time.perf_counter() - t0
    return out, dt, dt


def _print_attribution(gemms, policy, measured_s, device) -> None:
    """The ``[serve] roofline:`` lines: the measured device time against
    the H100 cost model's per-layer roofline at the policy's word-lengths,
    and the four layers that take the most of it."""
    rep = layer_attribution(gemms, policy, measured_s)
    if not rep.get("layers"):
        return
    clock = "CUDA events" if device.type == "cuda" else "host clock"
    print(f"[serve] roofline: measured {rep['measured_s'] * 1e3:.3f}ms "
          f"({clock}) vs model {rep['roofline_s'] * 1e3:.4f}ms -> "
          f"{100 * rep['roofline_fraction']:.2f}% of roofline "
          f"({rep['achieved_tops']:.3f} achieved / "
          f"{rep['roofline_tops']:.1f} roofline TOps/s, peak int8 "
          f"{rep['peak_int8_tops']:.0f})")
    for l in sorted(rep["layers"], key=lambda l: -l["attributed_s"])[:4]:
        print(f"[serve]   {l['name']:<12} w{l['w_bits']}  "
              f"{l['bound']:<7} share {100 * l['share']:5.1f}%  "
              f"achieved {l['achieved_tops']:8.3f} / "
              f"roofline {l['roofline_tops']:6.1f} TOps/s  "
              f"hbm {l['achieved_hbm_gbps']:7.2f} GB/s")


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
        return (f"plan [{pol.name or args.plan}] w_bits "
                f"{'/'.join(map(str, pol.distinct_wbits()))}")
    if not pol.quantize:
        return "w_Q=FP"
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
    with _profiled(args.profile, device):
        logits, dt, dev_s = _timed(lambda: server.predict(imgs), device)
    print(f"[serve] {args.batch} images in {dt:.3f}s -> "
          f"{args.batch / dt:.1f} images/s (img {cfg.img_size}, "
          f"logits {logits.shape})")
    _print_attribution(mod.gemm_workload(cfg, batch=args.batch), api.policy,
                       dev_s, device)
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
    with _profiled(args.profile, device):
        out, dt, dev_s = _timed(lambda: gen.generate(prompts,
                                                     args.new_tokens), device)
    toks = args.batch * args.new_tokens
    print(f"[serve] {toks} tokens in {dt:.2f}s -> {toks / dt:.1f} tok/s "
          f"(batch {args.batch}, prompt {args.prompt_len})")
    if args.spec_decode is not None:
        print(f"[serve] specdec accept rate {gen.accept_rate:.3f} "
              f"({gen.accepted_tokens}/{gen.drafted_tokens} drafted tokens "
              f"accepted at k={args.spec_decode})")
    print(f"[serve] sample: {out[0, :12].tolist()}")
    _print_attribution(
        api.gemm_workload(args.batch * (args.prompt_len + args.new_tokens)),
        api.policy, dev_s, device)
    _export_telemetry(args, tracer, metrics)
    return 0


def _serve_frontier(api, args, device) -> int:
    """Pack every manifest plan point from one weight draw and push a
    burst, then a trickle, of requests through the SLO scheduler."""
    from repro_torch.runtime.frontier import frontier_from_manifest
    from repro_torch.runtime.slo import SLOScheduler
    manifest = FrontierManifest.load(args.frontier)
    gen_w = torch.Generator(device=device).manual_seed(args.seed)
    t0 = time.perf_counter()
    if api.family == "cnn":
        params = api.init_params(gen_w, device=device)
        state = api.mod.init_bn_state(api.specs(), device=device)
    else:
        params = state = None  # drawn once, packed under every point
    frontier = frontier_from_manifest(
        api, params, manifest, state=state, batch_buckets=(args.batch,),
        max_len=args.prompt_len + args.new_tokens, device=device,
        generator=gen_w)
    del params, state
    _sync(device)
    print(f"[serve] packed {frontier.n_levels} plan points of {args.arch} "
          f"in {time.perf_counter() - t0:.2f}s on {device}: "
          f"{' -> '.join(frontier.names)} (accurate -> fast)")

    data = np.random.default_rng(args.seed)
    if api.family == "cnn":
        size = api.cfg.img_size
        mk = lambda: np.asarray(data.normal(  # noqa: E731
            0.4, 0.5, (size, size, 3)), np.float32)
    else:
        mk = lambda: (data.integers(  # noqa: E731
            0, api.cfg.vocab, (args.prompt_len,)).astype(np.int32),
            args.new_tokens)
    for lvl in range(frontier.n_levels):  # builds the kernels on a card
        frontier.serve([frontier.validate(mk())] * args.batch, level=lvl)

    tracer, metrics = _mk_telemetry(args)
    sched = SLOScheduler(frontier, slo_s=args.slo_ms / 1e3,
                         max_queue=max(4 * args.batch * 8, 256),
                         tracer=tracer, metrics=metrics)
    # The payloads are made before the clock starts: on a card, drawing a
    # 224x224 image takes longer than serving it, and would eat the burst's
    # deadlines before the first dispatch.
    burst = [mk() for _ in range(args.batch * 16)]
    trickle = [mk() for _ in range(16)]
    t0 = time.perf_counter()
    with _profiled(args.profile, device):
        tickets = [sched.submit(p) for p in burst]
        sched.drain()
        # a trickle, one request at a time: low pressure, back to level 0
        for p in trickle:
            tickets.append(sched.submit(p))
            sched.drain()
            if sched.level == 0:
                break
    dt = time.perf_counter() - t0
    st = sched.stats()
    by_point = {}
    for t in tickets:
        key = t.plan_point or t.outcome
        by_point[key] = by_point.get(key, 0) + 1
    met = sum(bool(t.deadline_met) for t in tickets)
    n_req = len(tickets)
    print(f"[serve] {n_req} requests in {dt:.2f}s -> {n_req / dt:.1f} req/s "
          f"at slo {args.slo_ms:.0f}ms: {met}/{n_req} deadlines met, "
          f"served by {by_point}")
    print(f"[serve] degraded={st['degraded']:.0f} expired={st['expired']:.0f}"
          f" transitions={st['transitions']:.0f} "
          f"p50={st['p50_latency_s'] * 1e3:.1f}ms "
          f"p95={st['p95_latency_s'] * 1e3:.1f}ms "
          f"p99={st['p99_latency_s'] * 1e3:.1f}ms "
          f"(drained back to level {sched.level}: {sched.plan_point})")
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
    ap.add_argument("--w-bits", type=int, default=None, choices=(1, 2, 4, 8),
                    help="a uniform policy: inner-layer weight bits")
    ap.add_argument("--k", type=int, default=None, choices=(1, 2, 4, 8),
                    help="a uniform policy: operand slice (default "
                         "min(w-bits, 4))")
    ap.add_argument("--channel-wise", action="store_true",
                    help="a uniform policy: per-output-channel steps")
    ap.add_argument("--fp-baseline", action="store_true",
                    help="serve the floating-point baseline (bf16 weights, "
                         "plain bf16 products)")
    ap.add_argument("--frontier", default=None,
                    help="frontier manifest JSON: pack every plan point "
                         "from one weight draw and serve a burst through "
                         "the SLO scheduler")
    ap.add_argument("--slo-ms", type=float, default=4000.0,
                    help="per-request deadline of --frontier mode (the "
                         "default suits the CPU; on a card set it from the "
                         "measured batch time)")
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
    if args.fp_baseline:
        policy = PrecisionPolicy(quantize=False)
    elif args.w_bits or args.k:
        wb = args.w_bits or 4
        policy = PrecisionPolicy(inner_bits=wb, k=args.k or min(wb, 4),
                                 channel_wise=args.channel_wise)
    else:
        policy = None
    if args.frontier is not None:
        if (args.plan or args.fp_baseline or args.w_bits or args.k
                or args.channel_wise):
            raise SystemExit(
                "--frontier carries its own plan points; it conflicts with "
                "--plan/--w-bits/--k/--channel-wise/--fp-baseline")
        if args.spec_decode is not None:
            raise SystemExit("--frontier does not take --spec-decode")
        return _serve_frontier(configs.get(args.arch, reduced=args.reduced),
                               args, device)
    plan = None
    if args.plan is not None:
        if (args.fp_baseline or args.w_bits or args.k
                or args.channel_wise):
            raise SystemExit(
                "--plan carries the per-layer policy; it conflicts with "
                "--w-bits/--k/--channel-wise/--fp-baseline")
        plan = policy = PrecisionPlan.load(args.plan)
    api = configs.get(args.arch, reduced=args.reduced, policy=policy)
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
