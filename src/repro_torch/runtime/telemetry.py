"""Serving telemetry (port of ``repro.runtime.telemetry``): request
tracing and metrics.

  * ``Tracer``: a clock-injectable span/event recorder with a bounded ring
    buffer and Chrome ``trace_event`` JSON export (Perfetto,
    chrome://tracing).  The schedulers emit per-ticket lifecycle spans
    (``submit -> admit -> prefill -> decode-step* -> complete``);
    ``ImageServer`` / ``Generator`` / ``SpeculativeGenerator`` emit
    device-time spans.  Disabled tracing costs nothing: ``NULL_TRACER`` is
    the default everywhere, every method a no-op, and instrumented code
    builds span arguments only behind ``tracer.enabled``.

  * ``MetricsRegistry``: counters, gauges and histograms with Prometheus
    text exposition (``prometheus_text()``).  ``GOLDEN_METRICS`` is the
    stable dashboard contract: every instrumented scheduler declares the
    whole set at init, so every scheduler's exposition carries the same
    metric names.

Telemetry is bit-neutral: nothing here touches payloads or results.
Tracing changes when clocks are read and when the host waits for the
device, never what is computed.

``device_timed`` and ``device_span`` split a call's wall time into the
host's dispatch and the device's remainder.  On a CUDA device the
remainder is read from CUDA events recorded around the call (the device
time between them); on the CPU, where torch runs synchronously, it is the
host clock after the call returns.  ``repro`` blocks on the result with
``block_until_ready`` instead.

Not ported yet: ``layer_attribution``, which joins a measured device time
against the planner's per-layer roofline model; it needs the Hopper cost
model (``core/dse``, ``core/roofline``; ROADMAP Queue 1, label 8).  The
``python -m repro.runtime.telemetry validate`` command line is not ported
either: ``validate_chrome_trace`` and ``validate_metrics_text`` are the
same checks as functions.
"""
from __future__ import annotations

import bisect
import collections
import json
import math
import time
from typing import (Any, Callable, Deque, Dict, List, Mapping, Optional,
                    Sequence, Tuple)

__all__ = [
    "Tracer",
    "NullTracer",
    "NULL_TRACER",
    "as_tracer",
    "MetricsRegistry",
    "NullMetrics",
    "NULL_METRICS",
    "as_metrics",
    "GOLDEN_METRICS",
    "declare_golden",
    "device_span",
    "device_timed",
    "device_time_split",
    "validate_chrome_trace",
    "parse_prometheus_text",
    "validate_metrics_text",
]


# ---------------------------------------------------------------------------
# Tracing
# ---------------------------------------------------------------------------


class _SpanCtx:
    """Context manager for one live ``Tracer.span``; re-entrant never."""

    __slots__ = ("_tracer", "_name", "_cat", "_tid", "_args", "_t0")

    def __init__(self, tracer: "Tracer", name: str, cat: str, tid: int,
                 args: Optional[Dict[str, Any]]):
        self._tracer = tracer
        self._name = name
        self._cat = cat
        self._tid = tid
        self._args = args

    def __enter__(self) -> "_SpanCtx":
        self._t0 = self._tracer.clock()
        return self

    def __exit__(self, exc_type, exc, tb) -> None:
        self._tracer.span_at(self._name, self._t0, self._tracer.clock(),
                             cat=self._cat, tid=self._tid, args=self._args)


class _NullCtx:
    """The shared no-op context manager: zero allocation per use."""

    __slots__ = ()

    def __enter__(self):
        return self

    def __exit__(self, exc_type, exc, tb):
        return None


_NULL_CTX = _NullCtx()


class Tracer:
    """Bounded span/event recorder with Chrome trace_event export.

    ``clock`` is any zero-arg callable returning SECONDS and must be
    the SAME clock the instrumented schedulers run on (tests inject a
    fake; production uses ``time.monotonic``, the scheduler default) —
    mixing clocks would break timestamp monotonicity in the export.

    The ring buffer holds the newest ``capacity`` events; overflow
    drops the OLDEST and counts into ``dropped`` (visible, never
    silent).  Event tuples are ``(ph, name, cat, tid, ts_s, dur_s,
    args)`` with ``ph`` one of ``'X'`` (complete span) / ``'i'``
    (instant), matching the Chrome trace_event phases emitted.
    """

    enabled = True

    def __init__(self, clock: Callable[[], float] = time.monotonic,
                 capacity: int = 65536, process_name: str = "repro-serve"):
        self.clock = clock
        self.capacity = int(capacity)
        self.process_name = process_name
        self.events: Deque[Tuple] = collections.deque(maxlen=self.capacity)
        self.dropped = 0
        self.last_ts = 0.0  # newest end-timestamp seen (clock-free anchor)

    # --- recording ---------------------------------------------------------

    def _push(self, ev: Tuple) -> None:
        if len(self.events) == self.capacity:
            self.dropped += 1
        self.events.append(ev)
        end = ev[4] + ev[5]
        if end > self.last_ts:
            self.last_ts = end

    def instant(self, name: str, cat: str = "event", tid: int = 0,
                args: Optional[Dict[str, Any]] = None) -> None:
        """One instantaneous event at the current clock."""
        self._push(("i", name, cat, tid, self.clock(), 0.0, args))

    def instant_at(self, name: str, ts: float, cat: str = "event",
                   tid: int = 0,
                   args: Optional[Dict[str, Any]] = None) -> None:
        """An instant with an EXPLICIT timestamp, no clock read: the JAX
        package's fault injector (``runtime/faults``, not ported yet)
        anchors its events on ``last_ts`` this way, so that a fault event
        never re-enters a fault-wrapped clock."""
        self._push(("i", name, cat, tid, ts, 0.0, args))

    def span_at(self, name: str, t_start: float, t_end: float, *,
                cat: str = "span", tid: int = 0,
                args: Optional[Dict[str, Any]] = None) -> None:
        """A complete span with EXPLICIT timestamps (same clock as
        ``self.clock``) — how schedulers emit ticket-phase spans
        retroactively from the timestamps the ``Ticket`` already
        carries, with zero overhead on the hot path."""
        self._push(("X", name, cat, tid, t_start,
                    max(0.0, t_end - t_start), args))

    def span(self, name: str, cat: str = "span", tid: int = 0,
             args: Optional[Dict[str, Any]] = None) -> _SpanCtx:
        """Context manager measuring ``clock()`` at enter/exit."""
        return _SpanCtx(self, name, cat, tid, args)

    # --- export ------------------------------------------------------------

    def chrome_trace(self) -> Dict[str, Any]:
        """The Chrome trace_event JSON object (ts/dur in MICROseconds,
        sorted by ts so viewers and tests see monotone timestamps)."""
        out: List[Dict[str, Any]] = [{
            "ph": "M", "name": "process_name", "pid": 0, "tid": 0,
            "args": {"name": self.process_name},
        }]
        evs = sorted(self.events, key=lambda e: (e[4], e[5]))
        for ph, name, cat, tid, ts, dur, args in evs:
            ev: Dict[str, Any] = {
                "ph": ph, "name": name, "cat": cat, "pid": 0,
                "tid": int(tid), "ts": ts * 1e6,
            }
            if ph == "X":
                ev["dur"] = dur * 1e6
            if ph == "i":
                ev["s"] = "t"  # instant scope: thread
            if args:
                ev["args"] = dict(args)
            out.append(ev)
        return {"traceEvents": out, "displayTimeUnit": "ms",
                "otherData": {"dropped_events": self.dropped}}

    def export(self, path) -> None:
        with open(path, "w") as f:
            json.dump(self.chrome_trace(), f, indent=1)


class NullTracer(Tracer):
    """The disabled tracer: every method a no-op, one shared instance.

    The no-op fast path is the ZERO-COST guarantee — no clock reads, no
    tuple/dict allocation, no ring-buffer traffic.  ``span`` returns a
    shared context manager object, so even ``with tracer.span(...)``
    allocates nothing.
    """

    enabled = False

    def __init__(self):
        super().__init__(capacity=1)

    def instant(self, name, cat="event", tid=0, args=None):
        return None

    def instant_at(self, name, ts, cat="event", tid=0, args=None):
        return None

    def span_at(self, name, t_start, t_end, *, cat="span", tid=0, args=None):
        return None

    def span(self, name, cat="span", tid=0, args=None):
        return _NULL_CTX


NULL_TRACER = NullTracer()


def as_tracer(tracer: Optional[Tracer]) -> Tracer:
    """None -> the shared no-op tracer (the default everywhere)."""
    return tracer if tracer is not None else NULL_TRACER


class device_span:
    """Context manager timing the device work issued inside it: one span
    ``name`` (category ``device``) from entry until that work is done,
    with ``args`` plus ``dispatch_s`` (host time until the block returned)
    and ``device_s``.  On a CUDA ``device``, ``device_s`` is the device
    time between CUDA events recorded at entry and exit (the host then
    waits for the second); on the CPU, where torch runs synchronously, the
    host time after the block (zero, give or take the clock).  Waiting
    changes when the host waits, never what is computed.  ``hist``
    observes the span's wall time under ``phase=name``.  Use it only on a
    live tracer: it reads the clock."""

    def __init__(self, tracer: Tracer, name: str, device=None,
                 hist: Optional["Histogram"] = None,
                 args: Optional[Dict[str, Any]] = None):
        import torch
        self._torch = torch
        self.tracer, self.name, self.hist = tracer, name, hist
        self.args = dict(args or {})
        self.on_card = (device is not None
                        and torch.device(device).type == "cuda")

    def __enter__(self) -> "device_span":
        if self.on_card:
            self._start = self._torch.cuda.Event(enable_timing=True)
            self._end = self._torch.cuda.Event(enable_timing=True)
            self._start.record()
        self._t0 = self.tracer.clock()
        return self

    def __exit__(self, exc_type, exc, tb) -> None:
        if exc_type is not None:
            return
        t1 = self.tracer.clock()
        if self.on_card:
            self._end.record()
            self._end.synchronize()
        t2 = self.tracer.clock()
        device_s = (self._start.elapsed_time(self._end) / 1e3
                    if self.on_card else t2 - t1)
        self.tracer.span_at(self.name, self._t0, t2, cat="device",
                            args=dict(self.args, dispatch_s=t1 - self._t0,
                                      device_s=device_s))
        if self.hist is not None:
            self.hist.observe(t2 - self._t0, phase=self.name)


def device_timed(tracer: Tracer, name: str, fn: Callable,
                 metrics_hist: Optional["Histogram"] = None,
                 device=None) -> Callable:
    """Wrap a callable that issues device work: each call records one
    ``device_span`` (host dispatch vs device remainder, CUDA events on a
    CUDA ``device``).  With the null tracer the original function is
    returned untouched, so the disabled path costs nothing."""
    if not tracer.enabled:
        return fn

    def timed(*args, **kw):
        with device_span(tracer, name, device, metrics_hist):
            return fn(*args, **kw)

    timed.__wrapped__ = fn
    return timed


# ---------------------------------------------------------------------------
# Metrics
# ---------------------------------------------------------------------------


def _label_key(labels: Mapping[str, Any]) -> Tuple[Tuple[str, str], ...]:
    return tuple(sorted((k, str(v)) for k, v in labels.items()))


def _fmt_labels(key: Tuple[Tuple[str, str], ...]) -> str:
    if not key:
        return ""
    inner = ",".join(f'{k}="{v}"' for k, v in key)
    return "{" + inner + "}"


class _Metric:
    kind = "untyped"

    def __init__(self, name: str, help_: str = ""):
        self.name = name
        self.help = help_
        self._vals: Dict[Tuple[Tuple[str, str], ...], float] = {}

    def samples(self) -> List[Tuple[str, str, float]]:
        """[(sample_name, label_text, value)] for exposition."""
        return [(self.name, _fmt_labels(k), v)
                for k, v in sorted(self._vals.items())]

    def value(self, **labels) -> float:
        return self._vals.get(_label_key(labels), 0.0)


class Counter(_Metric):
    kind = "counter"

    def inc(self, v: float = 1.0, **labels) -> None:
        k = _label_key(labels)
        self._vals[k] = self._vals.get(k, 0.0) + v


class Gauge(_Metric):
    kind = "gauge"

    def set(self, v: float, **labels) -> None:
        self._vals[_label_key(labels)] = float(v)


DEFAULT_BUCKETS = (0.001, 0.0025, 0.005, 0.01, 0.025, 0.05, 0.1,
                   0.25, 0.5, 1.0, 2.5, 5.0, 10.0)


class Histogram(_Metric):
    kind = "histogram"

    def __init__(self, name: str, help_: str = "",
                 buckets: Sequence[float] = DEFAULT_BUCKETS):
        super().__init__(name, help_)
        self.buckets = tuple(sorted(buckets))
        # per label-set: [bucket counts..., +Inf count], sum
        self._hists: Dict[Tuple, Tuple[List[int], float]] = {}

    def observe(self, v: float, **labels) -> None:
        k = _label_key(labels)
        if k not in self._hists:
            self._hists[k] = ([0] * (len(self.buckets) + 1), 0.0)
        counts, total = self._hists[k]
        counts[bisect.bisect_left(self.buckets, v)] += 1
        self._hists[k] = (counts, total + v)

    def samples(self) -> List[Tuple[str, str, float]]:
        out: List[Tuple[str, str, float]] = []
        for k, (counts, total) in sorted(self._hists.items()):
            cum = 0
            for le, c in zip(self.buckets, counts):
                cum += c
                out.append((f"{self.name}_bucket",
                            _fmt_labels(k + (("le", repr(le)),)), cum))
            cum += counts[-1]
            out.append((f"{self.name}_bucket",
                        _fmt_labels(k + (("le", "+Inf"),)), cum))
            out.append((f"{self.name}_sum", _fmt_labels(k), total))
            out.append((f"{self.name}_count", _fmt_labels(k), cum))
        return out

    def count(self, **labels) -> int:
        h = self._hists.get(_label_key(labels))
        return sum(h[0]) if h else 0


class MetricsRegistry:
    """Named counters/gauges/histograms + Prometheus text exposition.

    Getters are idempotent (same name returns the same object) and
    kind-checked — registering ``foo`` as both a counter and a gauge is
    a bug, not a silent shadow.
    """

    enabled = True

    def __init__(self):
        self._metrics: Dict[str, _Metric] = {}

    def _get(self, cls, name: str, help_: str, **kw) -> _Metric:
        m = self._metrics.get(name)
        if m is None:
            m = cls(name, help_, **kw)
            self._metrics[name] = m
        elif not isinstance(m, cls):
            raise TypeError(f"metric {name!r} already registered as "
                            f"{m.kind}, requested {cls.kind}")
        return m

    def counter(self, name: str, help_: str = "") -> Counter:
        return self._get(Counter, name, help_)

    def gauge(self, name: str, help_: str = "") -> Gauge:
        return self._get(Gauge, name, help_)

    def histogram(self, name: str, help_: str = "",
                  buckets: Sequence[float] = DEFAULT_BUCKETS) -> Histogram:
        return self._get(Histogram, name, help_, buckets=buckets)

    def names(self) -> List[str]:
        return sorted(self._metrics)

    def prometheus_text(self) -> str:
        """The text exposition format (what ``--metrics-dump`` writes).

        Every registered metric emits its ``# TYPE`` header even with
        no samples yet, so the exposed METRIC-NAME SET is stable from
        the first scrape — the golden-set contract CI checks."""
        lines: List[str] = []
        for name in sorted(self._metrics):
            m = self._metrics[name]
            if m.help:
                lines.append(f"# HELP {name} {m.help}")
            lines.append(f"# TYPE {name} {m.kind}")
            for sname, ltext, v in m.samples():
                if v == int(v) and abs(v) < 1e15:
                    lines.append(f"{sname}{ltext} {int(v)}")
                else:
                    lines.append(f"{sname}{ltext} {v}")
        return "\n".join(lines) + "\n"


class NullMetrics(MetricsRegistry):
    """The disabled registry: hands out shared no-op metric objects."""

    enabled = False

    class _NullCounter(Counter):
        def inc(self, v=1.0, **labels):
            return None

    class _NullGauge(Gauge):
        def set(self, v, **labels):
            return None

    class _NullHistogram(Histogram):
        def observe(self, v, **labels):
            return None

    def __init__(self):
        super().__init__()
        self._c = self._NullCounter("null")
        self._g = self._NullGauge("null")
        self._h = self._NullHistogram("null")

    def counter(self, name, help_=""):
        return self._c

    def gauge(self, name, help_=""):
        return self._g

    def histogram(self, name, help_="", buckets=DEFAULT_BUCKETS):
        return self._h

    def names(self):
        return []

    def prometheus_text(self):
        return ""


NULL_METRICS = NullMetrics()


def as_metrics(metrics: Optional[MetricsRegistry]) -> MetricsRegistry:
    return metrics if metrics is not None else NULL_METRICS


# The stable dashboard contract: every instrumented scheduler declares
# this exact name set at init (``declare_golden``), so ANY scheduler's
# exposition can feed the same dashboards (tests/test_torch_telemetry.py
# holds the port's set to the JAX package's).
GOLDEN_METRICS = frozenset({
    "repro_requests_submitted_total",
    "repro_requests_rejected_total",
    "repro_requests_completed_total",
    "repro_batches_total",
    "repro_queue_depth",
    "repro_request_latency_seconds",
    "repro_queue_wait_seconds",
    "repro_device_time_seconds",
    "repro_frontier_level",
    "repro_frontier_serve_total",
    "repro_frontier_transitions_total",
    "repro_faults_injected_total",
    "repro_dropped_events_total",
    "repro_dropped_tickets_total",
    "repro_specdec_drafted_total",
    "repro_specdec_accepted_total",
    "repro_specdec_accept_rate",
})

_GOLDEN_KINDS = {
    "repro_request_latency_seconds": "histogram",
    "repro_queue_wait_seconds": "histogram",
    "repro_device_time_seconds": "histogram",
    "repro_queue_depth": "gauge",
    "repro_frontier_level": "gauge",
    "repro_specdec_accept_rate": "gauge",
}


def declare_golden(metrics: MetricsRegistry) -> MetricsRegistry:
    """Register every golden metric (TYPE headers from the first
    scrape); no-op on the null registry."""
    if not metrics.enabled:
        return metrics
    for name in sorted(GOLDEN_METRICS):
        kind = _GOLDEN_KINDS.get(name, "counter")
        getattr(metrics, kind)(name)
    return metrics


def device_time_split(tracer: Tracer, since: int = 0) -> Dict[str, float]:
    """Aggregate the host/device split over the tracer's ``device``-
    category spans (the ones ``device_timed`` and ``ImageServer.predict``
    emit), optionally only events recorded after index ``since``.

    ``dispatch_s`` is host time until the async dispatch returned,
    ``device_s`` the block-until-ready remainder, ``wall_s`` their sum
    over all calls.  Per-phase wall totals land under ``phases``.
    """
    calls = 0
    wall = disp = dev = 0.0
    phases: Dict[str, float] = {}
    for ev in list(tracer.events)[since:]:
        ph, name, cat, _tid, _ts, dur, args = ev
        if ph != "X" or cat != "device":
            continue
        calls += 1
        wall += dur
        phases[name] = phases.get(name, 0.0) + dur
        if args:
            disp += args.get("dispatch_s", 0.0)
            dev += args.get("device_s", 0.0)
    return {"calls": calls, "wall_s": wall, "dispatch_s": disp,
            "device_s": dev, "phases": phases}


# ---------------------------------------------------------------------------
def validate_chrome_trace(trace: Mapping[str, Any]) -> List[str]:
    """Structural checks on an exported Chrome trace; returns problems
    (empty = well-formed): required keys per phase, non-negative
    durations, and MONOTONE timestamps in file order."""
    problems: List[str] = []
    evs = trace.get("traceEvents")
    if not isinstance(evs, list) or not evs:
        return ["traceEvents missing or empty"]
    last_ts = -math.inf
    for i, ev in enumerate(evs):
        ph = ev.get("ph")
        if ph not in ("X", "i", "M"):
            problems.append(f"event {i}: unknown phase {ph!r}")
            continue
        if "name" not in ev or "pid" not in ev or "tid" not in ev:
            problems.append(f"event {i}: missing name/pid/tid")
        if ph == "M":
            continue
        ts = ev.get("ts")
        if not isinstance(ts, (int, float)):
            problems.append(f"event {i}: non-numeric ts")
            continue
        if ts < last_ts:
            problems.append(f"event {i}: ts {ts} < previous {last_ts} "
                            f"(not monotone)")
        last_ts = ts
        if ph == "X" and ev.get("dur", 0.0) < 0:
            problems.append(f"event {i}: negative dur")
    return problems


def parse_prometheus_text(text: str) -> Dict[str, Dict[str, Any]]:
    """Parse a text exposition into {metric_name: {kind, samples}}.

    Minimal but strict on what the registry emits: TYPE lines declare
    names; every sample line must parse as ``name[{labels}] value`` and
    belong to a declared metric (histogram _bucket/_sum/_count roll up
    to their base name).
    """
    metrics: Dict[str, Dict[str, Any]] = {}
    for ln, line in enumerate(text.splitlines(), 1):
        line = line.strip()
        if not line:
            continue
        if line.startswith("# TYPE "):
            _, _, name, kind = line.split(None, 3)
            metrics[name] = {"kind": kind, "samples": []}
            continue
        if line.startswith("#"):
            continue
        head, _, val = line.rpartition(" ")
        if not head:
            raise ValueError(f"line {ln}: unparseable sample {line!r}")
        sname = head.split("{", 1)[0]
        base = sname
        for suffix in ("_bucket", "_sum", "_count"):
            if sname.endswith(suffix) and sname[:-len(suffix)] in metrics:
                base = sname[:-len(suffix)]
                break
        if base not in metrics:
            raise ValueError(f"line {ln}: sample {sname!r} has no TYPE")
        metrics[base]["samples"].append((head, float(val)))
    return metrics


def validate_metrics_text(text: str,
                          require_golden: bool = False) -> List[str]:
    """Problems with a Prometheus dump (empty = OK).  With
    ``require_golden``, the declared name set must CONTAIN the golden
    set — the dashboard contract."""
    try:
        metrics = parse_prometheus_text(text)
    except ValueError as e:
        return [str(e)]
    problems: List[str] = []
    if require_golden:
        missing = GOLDEN_METRICS - set(metrics)
        if missing:
            problems.append(f"golden metrics missing: {sorted(missing)}")
    for name, m in metrics.items():
        if m["kind"] == "histogram":
            sums = [s for s, _ in m["samples"] if s.startswith(f"{name}_sum")]
            bkts = [s for s, _ in m["samples"]
                    if s.startswith(f"{name}_bucket")]
            if bkts and not sums:
                problems.append(f"{name}: buckets without _sum")
    return problems
