"""Serving frontier (port of ``repro.runtime.frontier``): N packed plan
points of ONE model behind one API, the degradation axis the SLO
scheduler (``runtime/slo.py``) moves along under load.

  * ``Server`` is the request -> result interface over the two family
    backends: ``ImageBackend`` wraps an ``ImageServer`` (payload one (H, W,
    C) image -> its logits row), ``GenerateBackend`` a ``Generator``
    (payload ``(tokens, n_new)`` -> the generated ids).  Both ``validate``
    payloads at submit, ``serve`` a list of payloads, and give a
    ``batch_limit``.  ``serve`` returns host numpy, so it returns only
    once the device has finished: a scheduler's clock around it measures
    the work, not its submission.
  * ``FrontierServer`` holds the points in degradation order (0 the
    accurate point, the last the fastest) and serves any batch at any
    level.  Every level is packed from the same weights, so a request
    served at level L equals a dedicated deployment of plan L.
  * ``build_frontier`` packs each plan from one weight tree (CNN:
    ``pack_for_serve`` per plan; LM: ``pack_for_serving`` per plan, or,
    without a tree, ``serve.init_packed_views``: random weights drawn once
    on the device and packed under every plan, so a full-width model never
    holds its float tree); ``frontier_from_manifest`` does so from a
    ``core.plan.FrontierManifest``.  The JAX package regroups its layer
    scans per plan; the port's per-layer list needs no regrouping.
"""
from __future__ import annotations

import dataclasses
from typing import Any, Dict, List, Optional, Sequence, Tuple

import numpy as np

from repro_torch.core.plan import FrontierManifest, PrecisionPlan, as_plan
from repro_torch.launch import mesh as mesh_lib
from repro_torch.runtime.serve import (Generator, ImageServer,
                                       init_packed_views, pack_for_serving)
from repro_torch.runtime.telemetry import (NULL_METRICS, NULL_TRACER,
                                           as_metrics, as_tracer)

__all__ = [
    "Server",
    "ImageBackend",
    "GenerateBackend",
    "as_server",
    "FrontierServer",
    "build_frontier",
    "frontier_from_manifest",
]


class Server:
    """Uniform single-shot serving interface (both model families).

    ``kind`` is ``'image'`` or ``'generate'``; payload/result shapes
    are family-specific but the scheduler never looks inside them —
    it validates at submit, batches opaque payloads, and hands back
    per-request results.
    """

    kind: str = "opaque"

    def validate(self, payload: Any) -> Any:
        """Normalize + reject a payload at the door (raises ValueError
        on malformed input).  Returns the normalized payload."""
        return payload

    def serve(self, payloads: Sequence[Any]) -> List[np.ndarray]:
        """A list of payloads -> the aligned list of per-request
        results.  Entries never mix, so results are independent of
        batch composition."""
        raise NotImplementedError

    @property
    def batch_limit(self) -> int:
        """Largest batch one ``serve`` call should carry."""
        return 1


class ImageBackend(Server):
    """``Server`` over an ``ImageServer``-shaped backend: payload is one
    (H, W, C) image, result its logits row."""

    kind = "image"

    def __init__(self, server):
        self.server = server
        # Expected shape: from the server's model config when it carries
        # one (ImageServer), else locked to the first request — the same
        # submit-side gate ImageScheduler uses.
        cfg = getattr(getattr(server, "api", None), "cfg", None)
        self._img_shape = ((cfg.img_size, cfg.img_size, 3)
                           if hasattr(cfg, "img_size") else None)

    def validate(self, payload: Any) -> np.ndarray:
        image = np.asarray(payload)
        if image.dtype == object:
            raise ValueError("image payload is not a numeric array")
        if self._img_shape is None:
            if image.ndim != 3:
                raise ValueError(
                    f"expected an (H, W, C) image, got shape {image.shape}")
            self._img_shape = image.shape
        elif image.shape != self._img_shape:
            raise ValueError(
                f"image shape {image.shape} does not match this "
                f"server's {self._img_shape}")
        return image

    def serve(self, payloads: Sequence[Any]) -> List[np.ndarray]:
        logits = np.asarray(self.server.predict(np.stack(list(payloads))))
        return [logits[i] for i in range(len(payloads))]

    @property
    def mesh(self):
        return getattr(self.server, "mesh", None)

    @property
    def batch_limit(self) -> int:
        return max(self.server.batch_buckets)


class GenerateBackend(Server):
    """``Server`` over a ``Generator``: payload is ``(tokens, n_new)``,
    result the generated token ids.

    ``serve`` groups payloads by (prompt length, n_new) — a
    ``Generator`` call takes one rectangular prompt batch — and
    reassembles results in submission order; batch entries never mix,
    so grouping is invisible to callers.
    """

    kind = "generate"

    def __init__(self, gen, max_len: int = 64):
        self.gen = gen
        self.max_len = int(max_len)

    @property
    def mesh(self):
        return getattr(self.gen, "mesh", None)

    def validate(self, payload: Any) -> Tuple[np.ndarray, int]:
        try:
            tokens, n_new = payload
        except (TypeError, ValueError):
            raise ValueError(
                "generate payload must be a (tokens, n_new) pair")
        toks = np.asarray(tokens)
        if toks.dtype == object or not np.issubdtype(toks.dtype, np.integer):
            raise ValueError("prompt tokens must be an integer array")
        toks = toks.astype(np.int32).reshape(-1)
        n_new = int(n_new)
        if toks.size == 0:
            raise ValueError("empty prompt")
        if n_new < 1:
            raise ValueError(f"n_new must be >= 1, got {n_new}")
        if toks.size + n_new > self.max_len:
            raise ValueError(
                f"prompt {toks.size} + n_new {n_new} exceeds max_len "
                f"{self.max_len}")
        return toks, n_new

    def serve(self, payloads: Sequence[Any]) -> List[Optional[np.ndarray]]:
        groups: Dict[Tuple[int, int], List[int]] = {}
        for i, (toks, n_new) in enumerate(payloads):
            groups.setdefault((toks.size, n_new), []).append(i)
        out: List[Optional[np.ndarray]] = [None] * len(payloads)
        for (_, n_new), idxs in groups.items():
            batch = np.stack([payloads[i][0] for i in idxs])
            res = self.gen.generate(batch, n_new)
            for row, i in enumerate(idxs):
                out[i] = np.asarray(res[row], np.int32)
        return out

    @property
    def batch_limit(self) -> int:
        return 8


def as_server(backend) -> Server:
    """Wrap either family backend (or pass a ``Server`` through):
    ``.predict`` duck-types an ``ImageServer``, ``.generate`` a
    ``Generator``."""
    if isinstance(backend, Server) or (
            hasattr(backend, "serve") and hasattr(backend, "validate")
            and hasattr(backend, "kind")):
        return backend  # Server, or a Server-shaped duck (FaultyServer)
    if hasattr(backend, "predict"):
        return ImageBackend(backend)
    if hasattr(backend, "generate"):
        return GenerateBackend(backend)
    raise TypeError(
        f"cannot wrap {type(backend).__name__}: needs .predict "
        f"(image family) or .generate (LM family)")


class FrontierServer:
    """Ordered plan points of one model: level 0 serves the accurate
    point, higher levels the faster/lower-bit re-packs — the
    degradation ladder ``runtime/slo.py`` climbs under pressure.

    ``points`` is ``[(name, server), ...]`` in degradation order; all
    servers must share one payload kind (they are re-packs of one
    model).  ``serve(payloads, level)`` dispatches at that level, and
    every level is independently reachable so tests can compare a
    scheduler-served result against a dedicated run at the same point.
    """

    def __init__(self, points: Sequence[Tuple[str, Any]],
                 manifest: Optional[FrontierManifest] = None):
        if not points:
            raise ValueError("a frontier needs at least one plan point")
        self._points: List[Tuple[str, Server]] = [
            (name, as_server(srv)) for name, srv in points]
        names = [n for n, _ in self._points]
        if len(set(names)) != len(names):
            raise ValueError(f"duplicate frontier point names: {names}")
        kinds = {s.kind for _, s in self._points}
        if len(kinds) != 1:
            raise ValueError(
                f"frontier points must share one payload kind, got {kinds}")
        self.kind = kinds.pop()
        self.manifest = manifest
        self._tracer = NULL_TRACER
        self._metrics = NULL_METRICS
        self._m_serve = NULL_METRICS.counter("repro_frontier_serve_total")

    def instrument(self, tracer=None, metrics=None) -> "FrontierServer":
        """Attach telemetry: every ``serve`` emits one span and one
        counter increment LABELED BY LEVEL AND POINT NAME, so per-level
        traffic and latency are separable downstream.  SLOScheduler
        propagates its own tracer/metrics here automatically; call this
        directly when driving a frontier without the SLO layer.
        Returns self (chainable)."""
        self._tracer = as_tracer(tracer)
        self._metrics = as_metrics(metrics)
        self._m_serve = self._metrics.counter("repro_frontier_serve_total")
        return self

    @property
    def mesh(self):
        """The points' serve mesh (None: one device)."""
        return getattr(self._points[0][1], "mesh", None)

    @property
    def names(self) -> Tuple[str, ...]:
        return tuple(n for n, _ in self._points)

    @property
    def n_levels(self) -> int:
        return len(self._points)

    def name(self, level: int) -> str:
        return self._points[level][0]

    def server(self, level: int) -> Server:
        return self._points[level][1]

    def level_of(self, name: str) -> int:
        return self.names.index(name)

    def validate(self, payload: Any) -> Any:
        """Submit-side payload check (level-independent: every point is
        the same model, so level 0's gate speaks for all)."""
        return self._points[0][1].validate(payload)

    def batch_limit(self, level: int = 0) -> int:
        return self._points[level][1].batch_limit

    def serve(self, payloads: Sequence[Any], level: int = 0) \
            -> List[np.ndarray]:
        if not 0 <= level < len(self._points):
            raise IndexError(
                f"level {level} outside frontier [0, {len(self._points)})")
        name, srv = self._points[level]
        tr = self._tracer
        if not tr.enabled:
            self._m_serve.inc(level=level, point=name)
            return srv.serve(payloads)
        t0 = tr.clock()
        results = srv.serve(payloads)
        tr.span_at("frontier.serve", t0, tr.clock(), cat="dispatch",
                   args={"level": level, "point": name,
                         "batch": len(payloads)})
        self._m_serve.inc(level=level, point=name)
        return results

    def restricted(self, level: int = 0) -> "FrontierServer":
        """A single-point frontier pinned at ``level`` — the fixed-plan
        baseline the SLO benchmark compares against.  Telemetry rides
        along (the restricted baseline stays comparable in traces)."""
        return FrontierServer(
            [self._points[level]], manifest=self.manifest,
        ).instrument(tracer=self._tracer, metrics=self._metrics)


# --- building a frontier from one weight store ------------------------------


def build_frontier(api, train_params, plans: Sequence[Tuple[str, Any]], *,
                   state=None,
                   batch_buckets: Tuple[int, ...] = (1, 2, 4, 8),
                   max_len: int = 64,
                   manifest: Optional[FrontierManifest] = None,
                   device="cuda", generator=None,
                   mesh=None) -> FrontierServer:
    """Pack every plan point from ONE weight tree and stand the servers up
    behind a ``FrontierServer``, on ``device`` (CUDA by default).

    ``plans`` is ``[(name, PrecisionPlan or PrecisionPolicy), ...]`` in
    degradation order.  CNN families pack through the family module's
    ``pack_for_serve`` (BN folded per point; ``state`` defaults to fresh
    running statistics).  LM families pack ``train_params`` through
    ``pack_for_serving`` with the api pinned to each plan; with
    ``train_params=None`` the weights are drawn from ``generator`` once
    and packed under every plan (``serve.init_packed_views``).  With
    ``mesh=`` every point serves on it, on this rank's device (on a
    'model' axis above 1 an LM point holds its rank's slice).
    """
    if mesh is not None:
        device = mesh_lib.local_device(mesh)
    points: List[Tuple[str, Server]] = []
    if api.family == "cnn":
        mod, cfg = api.mod, api.cfg
        if state is None:
            state = mod.init_bn_state(mod.specs(cfg), device=device)
        for name, plan in plans:
            packed = mod.pack_for_serve(cfg, train_params, state, plan)
            srv = ImageServer(
                api=dataclasses.replace(api, policy=as_plan(plan)),
                params=packed,
                plan=plan if isinstance(plan, PrecisionPlan) else None,
                batch_buckets=batch_buckets, device=device, mesh=mesh)
            points.append((name, ImageBackend(srv)))
        return FrontierServer(points, manifest=manifest)
    pols = [plan for _, plan in plans]
    if train_params is None:
        views = init_packed_views(api, pols, generator, device=device)
    else:
        views = [pack_for_serving(dataclasses.replace(api, policy=pol),
                                  train_params, mesh=mesh) for pol in pols]
    for (name, plan), packed in zip(plans, views):
        gen = Generator(api=dataclasses.replace(api, policy=plan),
                        params=packed, device=device, mesh=mesh)
        points.append((name, GenerateBackend(gen, max_len=max_len)))
    return FrontierServer(points, manifest=manifest)


def frontier_from_manifest(api, train_params, manifest, *, state=None,
                           batch_buckets: Tuple[int, ...] = (1, 2, 4, 8),
                           max_len: int = 64, device="cuda",
                           generator=None, mesh=None) -> FrontierServer:
    """``FrontierManifest`` (or a path to one) -> packed ``FrontierServer``.
    Every point's layer names are checked against the api before anything
    is packed."""
    if not isinstance(manifest, FrontierManifest):
        manifest = FrontierManifest.load(manifest)
    if manifest.arch and api.name != manifest.arch:
        raise ValueError(
            f"manifest targets arch {manifest.arch!r}, api is {api.name!r}")
    manifest.validate_layers(api.plan_layer_names())
    return build_frontier(api, train_params, manifest.plans(), state=state,
                          batch_buckets=batch_buckets, max_len=max_len,
                          manifest=manifest, device=device,
                          generator=generator, mesh=mesh)
