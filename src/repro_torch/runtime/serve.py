"""Serving runtime (port of ``repro.runtime.serve``): packed-weight
deployment, greedy LM generation and bucketed image serving.

``pack_for_serving`` packs every linear of a trained LM tree at its own
plan-resolved format and the embedding table to int8 codes;
``init_packed_lm`` does the same for random weights one layer at a time
(an MoE layer's expert banks with it; every per-layer list of the tree --
``layers``, whisper's ``enc_layers`` and ``dec_layers``), so a full-width
model never holds its float tree whole, and
``init_packed_views`` packs each layer so drawn under several plans at
once (the two views of speculative decoding).  ``Generator`` runs prefill
and decode on packed weights; ``ImageServer`` batches CNN requests.  Both
take a ``tracer`` and a ``metrics`` registry (``runtime.telemetry``) and
record the JAX module's device spans (``prefill``, ``decode``,
``predict``) and ``repro_device_time_seconds``.  The schedulers
(``runtime.scheduler``) drive a ``Generator`` through its step hooks
``_prefill``, ``_decode``, ``_grow_cache`` and ``params``, as they drive
the JAX one.

Multi-device serving runs one process a rank over a (data, model) mesh
(``mesh=``, ``launch.mesh.make_serve_mesh``): every rank calls the same API
with the same full inputs, pads the batch to a multiple of the 'data' size
as the reference pads it, runs its data coordinate's rows and all-gathers
the outputs over 'data', so every rank returns the whole result, as the
reference's single controller does.  Batch entries never mix.  On a
(D, 1) mesh every rank holds a full replica of the packed tree
(``pack_for_serving(mesh=)``) and a meshed run is bitwise the
single-device run.  With a 'model' axis above 1 (tensor-parallel serving
of every arch: the dense decoders -- granite-8b/34b, yi-34b,
chameleon-34b, nemotron-4-340b --, olmoe-1b-7b and deepseek-v2-lite-16b
with expert parallelism and MLA's sharded latent cache, whisper-base,
mamba2-1.3b, recurrentgemma-9b, each also as the fp baseline, and the
ResNets) an LM rank holds its ``SERVE_RULES`` slice of the packed tree
(``nn.partitioning.shard_tree``: an MoE bank by whole experts; mamba2's
``in_xbc`` and conv by its heads' x channels with B and C whole, the
RG-LRU's conv by its channels; the fp baseline's contraction axes whole,
``nn.quantized.fp_serve_axes``) and its block of every decode cache's
sequence (``max_len`` rounded up to a multiple of the model axis, as the
reference rounds it; whisper's cross cache its block of the ``n_audio``
frames, recurrentgemma's ring its block of the slots), or of an SSM or
RG-LRU state's heads and channels; the ranks of one data coordinate
compute the same rows together, and prefill and decode logits and
generated tokens are the single-device port's, bitwise.  A CNN's packed
tree stays whole on every rank (``part.replicated``).  A ``Generator``'s
decode cache stays rank-local.
"""
from __future__ import annotations

import dataclasses
from typing import Any, Callable, List, Optional, Tuple

import numpy as np
import torch

from repro_torch.device import resolve_device, tree_to
from repro_torch.launch import mesh as mesh_lib
from repro_torch.launch import steps as steps_lib
from repro_torch.nn import param as nnp
from repro_torch.nn import partitioning as part
from repro_torch.nn import quantized as Q
from repro_torch.nn.layers import pack_embed, pad_vocab
from repro_torch.runtime.telemetry import (as_metrics, as_tracer,
                                           device_span, device_timed)

__all__ = ["pack_for_serving", "serve_shardings", "local_params",
           "require_tensor_parallel", "init_packed_lm", "init_packed_views",
           "Generator", "ImageServer"]


def _pack_embed(policy, embed):
    if policy.quantize and "table" in embed:
        return pack_embed(embed, policy)
    return embed


def serve_shardings(api, mesh):
    """``NamedSharding`` tree of this api's packed serve tree under
    ``SERVE_RULES``: LM families by each serve-spec leaf's logical axes
    (replicated on a (N, 1) data-parallel mesh; on a 'model' axis above 1
    q/gate/up and the head shard their columns, o/down their packed rows,
    the embedding its vocabulary rows), a CNN's packed tree replicated
    whole."""
    if api.family == "cnn":
        return part.replicated(mesh)
    return part.tree_shardings(api.param_axes("serve"), mesh,
                               part.SERVE_RULES)


def require_tensor_parallel(api, mesh) -> None:
    """Raise unless ``api`` serves on ``mesh``'s 'model' axis (``mesh`` a
    mesh or its {axis: size}): every arch, packed or as the fp baseline,
    serves at any size whose splits are even -- ``ValueError`` where the
    heads (mamba2's SSM heads), an MoE block's experts, whisper's
    ``n_audio`` frames or recurrentgemma's local-attention window (its
    ring's slots) do not split evenly; ``NotImplementedError`` for a
    multi-pod mesh (``nn.partitioning.require_serve_mesh``)."""
    if mesh is None:
        return
    sizes = mesh if isinstance(mesh, dict) else part.axis_sizes(mesh)
    part.require_serve_mesh(sizes)
    m = sizes.get("model", 1)
    if m == 1 or api.family == "cnn":
        return
    cfg = api.cfg
    counts = [("heads", cfg.ssm.n_heads if api.family == "ssm"
               else cfg.n_heads)]
    if getattr(cfg, "moe", None) is not None:
        counts.append(("experts", cfg.moe.n_experts))
    if api.needs_frames:
        counts.append(("n_audio frames", cfg.n_audio))
    if api.family == "hybrid":
        counts.append(("window slots", cfg.window))
    for what, n in counts:
        if n % m:
            raise ValueError(f"{api.name}: {n} {what} do not split evenly "
                             f"over a 'model' axis of {m}")


def _shard_fp(tree, axes, mesh):
    """``nn.partitioning.shard_tree`` of the fp baseline's tree under
    ``nn.quantized.fp_serve_axes``: a bf16 weight cut on a dimension (its
    columns, or a bank's experts) becomes an ``nn.quantized.fp_shard``,
    which runs at the one-device shape."""
    if isinstance(tree, dict) and isinstance(tree.get("w"), torch.Tensor):
        w = tree["w"]
        spec = part.logical_to_spec(axes["w"], part.SERVE_RULES, mesh)
        cut = [d for d, e in enumerate(spec)
               if e == "model" or (isinstance(e, tuple) and "model" in e)]
        if not cut:
            return part.shard_tree(tree, axes, mesh, part.SERVE_RULES)
        r, m = mesh_lib.model_coords(mesh)
        n = w.shape[cut[0]] // m
        if n * m != w.shape[cut[0]]:
            raise ValueError(f"an fp weight's dimension {cut[0]} "
                             f"({w.shape[cut[0]]}) does not split over "
                             f"{m} 'model' ranks")
        return Q.fp_shard(tree, cut[0] - w.ndim, ((r * n, (r + 1) * n),))
    if isinstance(tree, dict):
        return {k: _shard_fp(v, axes[k], mesh) for k, v in tree.items()}
    if isinstance(tree, list):
        return [_shard_fp(v, a, mesh) for v, a in zip(tree, axes)]
    return part.shard_tree(tree, axes, mesh, part.SERVE_RULES)


def _shard(tree, axes, mesh):
    """This rank's ``SERVE_RULES`` slice of a (sub)tree whose logical axes
    are ``axes``: the fp baseline's (a bf16 ``"w"`` in its head) through
    ``_shard_fp``."""
    if _is_fp(tree):
        return _shard_fp(tree, axes, mesh)
    return part.shard_tree(tree, axes, mesh, part.SERVE_RULES)


def _is_fp(tree) -> bool:
    return isinstance(tree, dict) and "w" in tree.get("head", {})


def local_params(api, params, mesh):
    """This rank's part of a packed tree on ``mesh``: an LM's whole tree
    is cut to its ``SERVE_RULES`` slice (``nn.partitioning.shard_tree``;
    the fp baseline's under ``nn.quantized.fp_serve_axes``; an arch's own
    cuts by its module's ``shard_serve_tree``) where the 'model' axis is
    above 1, and a tree already cut (its head holds ``pad_vocab(vocab) /
    M`` columns) is kept; everything else, a CNN's tree among it, is whole
    on every rank."""
    if mesh is None or api.family == "cnn" \
            or mesh_lib.model_coords(mesh)[1] == 1:
        return params
    m = mesh_lib.model_coords(mesh)[1]
    head = params["head"]
    cols = (head["w"] if "w" in head else head["planes"]).shape[-1]
    vp = pad_vocab(api.cfg.vocab)
    if cols == vp // m:
        return params
    if cols != vp:
        raise ValueError(f"a head of {cols} columns is neither the whole "
                         f"{vp} nor a 'model' shard of {vp // m}")
    specs = api.specs("serve")
    axes = (Q.fp_serve_axes(specs) if _is_fp(params)
            else nnp.axes_tree(specs))
    own = getattr(api.mod, "shard_serve_tree", None)
    if own is not None:
        return own(api.cfg, params, axes, mesh, _shard)
    return _shard(params, axes, mesh)


def pack_for_serving(api, train_params, mesh=None):
    """Trained QAT tree -> packed serve tree, for any ``api.policy``
    (uniform or a layer-wise plan): every linear at its own resolved
    format, the embedding table as int8 codes and a step.  With ``mesh=``
    the tree is this rank's part (``local_params``: a full replica on a
    (D, 1) mesh, the rank's ``SERVE_RULES`` slice on a 'model' axis above
    1), on its device."""
    require_tensor_parallel(api, mesh)
    packed = Q.pack_tree(train_params, api.specs("train"), api.policy)
    if "embed" in packed:
        packed["embed"] = _pack_embed(api.policy, packed["embed"])
    if mesh is not None:
        packed = tree_to(local_params(api, packed, mesh),
                         mesh_lib.local_device(mesh))
    return packed


def init_packed_lm(api, generator: torch.Generator, device="cuda"):
    """Random LM weights, packed as ``pack_for_serving`` packs them, made
    piece by piece: each layer's float weights are drawn on ``device``
    (CUDA by default) from ``generator``, packed, and freed before the next
    layer is drawn."""
    return init_packed_views(api, [api.policy], generator, device)[0]


def init_packed_views(api, policies, generator: torch.Generator,
                      device="cuda"):
    """Random LM weights drawn once and packed under each of ``policies``
    (plans or uniform policies over the same layer namespace) -> one
    packed tree per policy, each as ``pack_for_serving`` of the same float
    tree would give.  Each piece's float weights are drawn on ``device``
    from ``generator``, packed into every view, and freed before the next
    piece is drawn, so a full-width model never holds its float tree
    whole."""
    dev = resolve_device(device)
    tspecs = api.specs("train")
    stacks = [k for k, v in tspecs.items() if isinstance(v, list)]
    views = [{k: [] for k in stacks} for _ in policies]
    for key in (k for k in tspecs if k not in stacks):
        p = nnp.init_params(tspecs[key], generator, device=dev)
        for view, pol in zip(views, policies):
            q = Q.pack_tree(p, tspecs[key], pol)
            view[key] = _pack_embed(pol, q) if key == "embed" else q
        del p
    for key in stacks:
        for spec in tspecs[key]:
            p = nnp.init_params(spec, generator, device=dev)
            for view, pol in zip(views, policies):
                view[key].append(Q.pack_tree(p, spec, pol))
            del p
    return views


def _pad_batch(arr: np.ndarray, to: int) -> np.ndarray:
    """Pad the leading axis up to ``to`` by repeating the last row (the
    padded rows' outputs are discarded; batch entries never mix)."""
    if arr.shape[0] == to:
        return arr
    reps = np.repeat(arr[-1:], to - arr.shape[0], axis=0)
    return np.concatenate([arr, reps])


def _pad_rows(x: torch.Tensor, to: int) -> torch.Tensor:
    """``_pad_batch`` for a tensor."""
    if x.shape[0] == to:
        return x
    return torch.cat([x, x[-1:].expand((to - x.shape[0],) + x.shape[1:])])


def _mesh_device(api, mesh, device) -> torch.device:
    """A serving object's device: this rank's on a mesh (whose arch check
    ``require_tensor_parallel`` passes), else ``device`` (CUDA unless the
    caller asks for the CPU)."""
    if mesh is None:
        return resolve_device(device)
    require_tensor_parallel(api, mesh)
    return mesh_lib.local_device(mesh)


@dataclasses.dataclass
class Generator:
    """Greedy batched generator over the model API (LM families).

    ``plan`` overrides the api's uniform policy with a layer-wise one;
    ``params`` must then be packed under the same plan (its weight
    formats; the plan's KV-cache keys decide the cache layout alone).
    ``params`` move to ``device``, CUDA by default, which raises without a
    card unless ``device="cpu"``.  ``impl`` routes every kernel: 'auto'
    (the kernels on CUDA, their plain versions on the CPU), 'cuda', or
    'torch' (the plain versions on any device).

    ``sample_fn(logits (B, V), generator) -> tokens (B,)`` replaces the
    greedy head; ``generate(..., generator=...)`` hands it a seeded
    ``torch.Generator``.  The default stays ``argmax`` (first maximum).

    An arch that takes audio frames (``api.needs_frames``, whisper) gets
    them through ``run``/``generate(..., frames=)`` (B, n_audio, d_model),
    zeros when omitted, as the reference does.

    Step hooks (what ``runtime.scheduler`` and ``runtime.specdec`` call):
    ``_prefill(params, {"tokens": (B, S)[, "frames"]})`` -> (logits (B, V),
    prefill cache); ``_decode(params, cache, tokens (B, 1), length)`` ->
    (logits, cache), the cache updated in place (a recurrent state is
    replaced); ``_grow_cache(pre, b, s, max_len)``.  With a live
    ``tracer`` each step records a ``prefill`` / ``decode`` device span
    and ``metrics`` observes ``repro_device_time_seconds``.

    ``mesh`` (``launch.mesh.make_serve_mesh``) runs every step on this
    rank's data coordinate's rows: the hooks take the whole batch (B a
    multiple of the 'data' size; ``run`` pads to one by repeating the last
    row) and return the whole batch's logits, while the cache holds this
    rank's rows only (``_grow_cache``'s ``b`` stays the whole batch).  A
    ``sample_fn`` draws for the real rows of the whole batch on every rank
    from the same generator, so each row's draw is the single-device draw.
    With a 'model' axis above 1 ``params`` is cut to this rank's slice
    (``local_params``), the model runs tensor-parallel, and the cache is
    this rank's block of the sequence (``_grow_cache`` rounds ``max_len``
    up to a multiple of the model axis; the tail is never attended).
    """

    api: Any
    params: Any
    plan: Any = None
    impl: str = "auto"
    device: Any = "cuda"
    sample_fn: Optional[Callable] = None
    tracer: Any = None   # telemetry.Tracer; None = the no-op fast path
    metrics: Any = None  # telemetry.MetricsRegistry; None = no-op
    mesh: Any = None     # data-parallel serve mesh; None = one device

    def __post_init__(self):
        if self.plan is not None:
            self.api = dataclasses.replace(self.api, policy=self.plan)
        self.device = _mesh_device(self.api, self.mesh, self.device)
        self.rows = mesh_lib.DataRows(self.mesh)
        self.model_rank, self.n_model = mesh_lib.model_coords(self.mesh)
        self.params = tree_to(local_params(self.api, self.params, self.mesh),
                              self.device)
        self.tracer = as_tracer(self.tracer)
        self.metrics = as_metrics(self.metrics)
        hist = self.metrics.histogram("repro_device_time_seconds")
        step = torch.inference_mode()
        prefill = device_timed(
            self.tracer, "prefill",
            step(steps_lib.make_prefill_fn(self.api, impl=self.impl,
                                           mesh=self.mesh)), hist,
            self.device)
        decode = device_timed(
            self.tracer, "decode",
            step(steps_lib.make_decode_fn(self.api, impl=self.impl,
                                          mesh=self.mesh)), hist,
            self.device)
        if self.rows.n == 1:
            self._prefill, self._decode = prefill, decode
            return
        rows = self.rows

        def meshed_prefill(params, batch):
            logits, pre = prefill(params, {k: rows.local(v)
                                           for k, v in batch.items()})
            return rows.gather(logits), pre

        def meshed_decode(params, cache, tokens, length):
            logits, cache = decode(params, cache, rows.local(tokens), length)
            return rows.gather(logits), cache

        self._prefill, self._decode = meshed_prefill, meshed_decode

    def _sample(self, logits: torch.Tensor, generator,
                b: Optional[int] = None) -> torch.Tensor:
        """Tokens of the whole (padded) batch: argmax, or ``sample_fn``
        over its first ``b`` (real) rows, padded by repeating the last."""
        if self.sample_fn is None:
            return torch.argmax(logits, dim=-1)
        b = logits.shape[0] if b is None else b
        return _pad_rows(self.sample_fn(logits[:b], generator),
                         logits.shape[0])

    def prefill(self, tokens: torch.Tensor,
                frames: Optional[torch.Tensor] = None):
        """tokens (B, S) on the device (and whisper's frames (B, n_audio,
        d_model)) -> (logits (B, V), prefill cache)."""
        batch = {"tokens": tokens}
        if frames is not None:
            batch["frames"] = frames
        return self._prefill(self.params, batch)

    def decode(self, cache, tokens: torch.Tensor, length: int):
        """One step: tokens (B, 1) at ``length`` -> (logits (B, V), cache)."""
        return self._decode(self.params, cache, tokens, length)

    def _frames(self, frames, b: int) -> Optional[torch.Tensor]:
        """An arch's audio frames on the device (zeros when omitted), or
        None for an arch that takes none."""
        if not self.api.needs_frames:
            if frames is not None:
                raise ValueError(f"{self.api.name} takes no frames")
            return None
        if frames is None:
            cfg = self.api.cfg
            return torch.zeros((b, cfg.n_audio, cfg.d_model),
                               dtype=torch.float32, device=self.device)
        return torch.as_tensor(np.asarray(frames), device=self.device)

    def run(self, tokens: np.ndarray, n_new: int,
            forced: Optional[np.ndarray] = None,
            generator: Optional[torch.Generator] = None,
            frames: Optional[np.ndarray] = None
            ) -> Tuple[np.ndarray, List[torch.Tensor]]:
        """Prefill, then ``n_new - 1`` decode steps -> (tokens (B, n_new),
        the logits of every step).  With ``forced`` (B, n_new) the decode
        steps are fed ``forced[:, i]`` instead of the sampled tokens
        (teacher forcing); the sampled tokens are still returned."""
        b, s = tokens.shape
        gb = self.rows.pad_to(b)  # an even split over the data axis
        with torch.inference_mode():
            toks = torch.as_tensor(_pad_batch(np.asarray(tokens), gb),
                                   dtype=torch.long, device=self.device)
            fr = self._frames(frames, b)
            logits, pre = self.prefill(toks, None if fr is None
                                       else _pad_rows(fr, gb))
            cache = self._grow_cache(pre, gb, s, s + n_new)
            out, all_logits = [], [logits[:b]]
            tok = self._sample(logits, generator, b)
            out.append(tok[:b])
            for i in range(n_new - 1):
                feed = (tok if forced is None else torch.as_tensor(
                    _pad_batch(np.asarray(forced[:, i]), gb),
                    dtype=torch.long, device=self.device))
                logits, cache = self.decode(cache, feed[:, None], s + i)
                all_logits.append(logits[:b])
                tok = self._sample(logits, generator, b)
                out.append(tok[:b])
            return torch.stack(out, dim=1).cpu().numpy(), all_logits

    def generate(self, tokens: np.ndarray, n_new: int,
                 generator: Optional[torch.Generator] = None,
                 frames: Optional[np.ndarray] = None) -> np.ndarray:
        """tokens (B, S) int -> the ``n_new`` generated tokens (B, n_new)."""
        return self.run(tokens, n_new, generator=generator,
                        frames=frames)[0]

    @torch.inference_mode()
    def _grow_cache(self, pre_cache, b: int, s: int, max_len: int):
        """The prefill cache of ``b`` rows and ``s`` tokens -> the decode
        cache of ``max_len``, by family: an SSM's state is decode-sized
        already; the hybrid's attention layers re-pack the prompt's last
        keys into ring buffers (``models.recurrentgemma.ring_cache``); the
        rest copy into zero buffers, sequence axis left-aligned.  Decode
        then writes into them in place.  On a mesh ``b`` is the whole
        batch and the cache this rank's ``b / n`` rows; on a 'model' axis
        of M above 1 ``max_len`` rounds up to a multiple of M and the
        cache is this rank's block of ``max_len / M`` positions, holding
        the prompt's positions that fall in it (a ring: its block of the
        ``min(window, max_len)`` slots, the one-device count wherever the
        window fits ``max_len`` or M divides it)."""
        b //= self.rows.n
        family = self.api.family
        if family == "ssm":
            return pre_cache
        m = self.n_model
        max_len = -(-max_len // m) * m
        specs = self.api.cache_specs(b, max_len, model=m)
        if family == "hybrid":
            return self.api.mod.ring_cache(self.api.cfg, pre_cache, s, specs,
                                           self.device,
                                           rank=self.model_rank, ranks=m)
        def grow(spec, pre):
            buf = torch.zeros(spec.shape, dtype=spec.dtype, device=self.device)
            if m > 1:  # this rank's block of the sequence axis
                ax = spec.axes.index("kv_seq")
                start = self.model_rank * spec.shape[ax]
                n = min(max(pre.shape[ax] - start, 0), spec.shape[ax])
                pre = pre.narrow(ax, min(start, pre.shape[ax]), n)
            buf[tuple(slice(0, n) for n in pre.shape)] = pre
            return buf

        def walk(spec, pre):
            if nnp.is_spec(spec):
                return grow(spec, pre)
            if isinstance(spec, dict):
                return {k: walk(spec[k], pre[k]) for k in spec}
            return type(spec)(walk(sp, p) for sp, p in zip(spec, pre))

        return walk(specs, pre_cache)


def round_buckets(buckets, n_data: int) -> tuple:
    """Batch buckets rounded up to multiples of the 'data' size (every
    rank an equal share), sorted and deduplicated."""
    return tuple(sorted({-(-int(b) // n_data) * n_data for b in buckets}))


@dataclasses.dataclass
class ImageServer:
    """Batched CNN serving over a packed ``serve_forward`` tree.

    Incoming batches of any size are chunked to the largest bucket and the
    remainder padded with zero images up to the smallest bucket that fits,
    so the network only ever runs at ``len(batch_buckets)`` batch sizes
    (one captured CUDA graph per bucket is later work).  Padded rows'
    outputs are discarded; batch entries never mix.

    ``params`` is a ``models.resnet.pack_for_serve`` tree; it is moved to
    ``device``, which defaults to CUDA and raises when there is no card.
    ``plan`` overrides the api's uniform policy with a layer-wise one;
    ``params`` must then be packed under the same plan.

    ``mesh`` makes every bucket a multiple of the 'data' size; each rank
    holds the whole packed tree on its device, runs its data coordinate's
    rows of a bucket (on a 'model' axis above 1 the ranks of one data
    coordinate run the same rows) and all-gathers the logits over 'data',
    which are bitwise the single-device ones.
    """

    api: Any
    params: Any
    batch_buckets: tuple = (1, 2, 4, 8)
    impl: str = "auto"
    dataflow: str = "auto"
    plan: Any = None
    device: Any = "cuda"
    tracer: Any = None   # telemetry.Tracer; None = the no-op fast path
    metrics: Any = None  # telemetry.MetricsRegistry; None = no-op
    mesh: Any = None     # data-parallel serve mesh; None = one device

    def __post_init__(self):
        if self.api.family != "cnn":
            raise ValueError(f"ImageServer serves CNNs, got family "
                             f"{self.api.family!r}")
        self.device = _mesh_device(self.api, self.mesh, self.device)
        self.rows = mesh_lib.DataRows(self.mesh)
        self.params = tree_to(self.params, self.device)
        self.batch_buckets = round_buckets(self.batch_buckets, self.rows.n)
        self._served = set()
        self.tracer = as_tracer(self.tracer)
        self.metrics = as_metrics(self.metrics)
        self._m_device = self.metrics.histogram("repro_device_time_seconds")

    def _forward(self, bucket: int, chunk: torch.Tensor) -> torch.Tensor:
        """One network forward at a bucket's batch size (this rank's rows
        of it on a mesh, which ``predict`` gathers)."""
        self._served.add(bucket)
        pol = self.plan if self.plan is not None else self.api.policy
        return self.api.mod.serve_forward(
            self.api.cfg, self.params, chunk, pol, impl=self.impl,
            dataflow=self.dataflow)

    def _bucket_for(self, n: int) -> int:
        for b in self.batch_buckets:
            if b >= n:
                return b
        return self.batch_buckets[-1]

    def predict(self, images: np.ndarray) -> np.ndarray:
        """(N, H, W, 3) float images -> (N, n_classes) f32 logits (the
        network's bf16 logits, widened exactly)."""
        n = images.shape[0]
        if n == 0:  # a drained request queue is not an error
            return np.zeros((0, self.api.cfg.n_classes), np.float32)
        outs: List[np.ndarray] = []
        i = 0
        with torch.inference_mode():
            while i < n:
                bucket = self._bucket_for(n - i)
                take = min(n - i, bucket)
                chunk = np.asarray(images[i:i + take], np.float32)
                if take < bucket:  # pad the tail up to the bucket
                    pad = np.zeros((bucket - take,) + chunk.shape[1:],
                                   chunk.dtype)
                    chunk = np.concatenate([chunk, pad])
                x = self.rows.local(torch.from_numpy(chunk)).to(self.device)
                if self.tracer.enabled:
                    # host dispatch vs device remainder of the forward;
                    # waiting changes when the host waits, never values
                    with device_span(self.tracer, "predict", self.device,
                                     self._m_device, {"bucket": bucket}):
                        y = self._forward(bucket, x)
                else:
                    y = self._forward(bucket, x)
                y = self.rows.gather(y)
                outs.append(y[:take].to(torch.float32).cpu().numpy())
                i += take
        return np.concatenate(outs)

    @property
    def compiled_buckets(self) -> tuple:
        """Batch sizes the network has run at so far."""
        return tuple(sorted(self._served))
