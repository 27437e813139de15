"""Deterministic fault injection (port of ``repro.runtime.faults``): the
testable half of robustness.

Every failure mode the SLO serving stack claims to survive is
INJECTABLE here, from one seed, so chaos tests replay bit-identically:

  * ``TransientStepError``: a compute step that fails once and would
    succeed on retry (device hiccup, preempted kernel) — raised by a
    wrapped server before the real dispatch, consumed by the SLO
    scheduler's retry-with-backoff path.
  * latency spikes: a serve call that takes ``latency_spike_s`` longer
    than usual — modeled by advancing the injectable clock, so fake-
    clock tests see deadline pressure without wall-time sleeps.
  * malformed payloads: traffic-generator corruption (wrong rank, wrong
    dtype, garbage tuples) that MUST bounce at ``submit`` and never
    strand a coalesced batch.
  * clock skew: a clock read that jumps forward ``clock_skew_s``
    (NTP-step shaped; monotonic clocks never run backwards, so skew is
    always a forward jump) — schedulers must keep their invariants when
    time lurches.

``FaultInjector`` owns one seeded RNG; every roll consumes from the
same stream, so a (spec, seed) pair defines ONE reproducible fault
schedule -- the same ``random.Random`` stream as the JAX package's, so a
(spec, seed) pair gives the same schedule in both.  Rolls are logged
(bounded deque) for test assertions.
"""
from __future__ import annotations

import collections
import dataclasses
import random
from typing import Any, Callable, Deque, List, Optional, Sequence, Tuple

import numpy as np

from repro_torch.runtime.telemetry import (NULL_METRICS, NULL_TRACER,
                                           as_metrics, as_tracer)

__all__ = [
    "TransientStepError",
    "FaultSpec",
    "FaultInjector",
    "FaultyServer",
    "SkewedClock",
]


class TransientStepError(RuntimeError):
    """An injectable compute-step failure that a retry may clear."""


@dataclasses.dataclass(frozen=True)
class FaultSpec:
    """Per-event fault probabilities (all default off).

    ``step_error_rate``/``latency_spike_rate`` are rolled per SERVE
    call, ``clock_skew_rate`` per clock READ, ``malformed_rate`` per
    generated payload (the traffic side, used by chaos tests).
    """

    step_error_rate: float = 0.0
    latency_spike_rate: float = 0.0
    latency_spike_s: float = 0.0
    clock_skew_rate: float = 0.0
    clock_skew_s: float = 0.0
    malformed_rate: float = 0.0

    def __post_init__(self):
        for f in ("step_error_rate", "latency_spike_rate",
                  "clock_skew_rate", "malformed_rate"):
            v = getattr(self, f)
            if not 0.0 <= v <= 1.0:
                raise ValueError(f"{f} must be a probability, got {v}")
        for f in ("latency_spike_s", "clock_skew_s"):
            if getattr(self, f) < 0.0:
                raise ValueError(f"{f} must be >= 0")


class FaultInjector:
    """One seeded fault schedule; every roll logs (bounded history)."""

    def __init__(self, spec: FaultSpec, seed: int, history: int = 4096):
        self.spec = spec
        self.seed = int(seed)
        self._rng = random.Random(self.seed)
        self.log: Deque[Tuple[int, str]] = collections.deque(maxlen=history)
        self.counts = collections.Counter()
        self._n = 0
        self.tracer = NULL_TRACER
        self.metrics = NULL_METRICS
        self._m_faults = NULL_METRICS.counter("repro_faults_injected_total")

    def instrument(self, tracer=None, metrics=None) -> "FaultInjector":
        """Attach telemetry: every fault HIT becomes a trace instant
        (``fault.<kind>``) and a labeled counter increment, so chaos
        runs are traceable.  Telemetry never touches ``_rng`` or reads
        a clock (a clock read could re-enter a skew-wrapped clock and
        roll again) — the (spec, seed) fault schedule replays
        bit-identically with or without tracing.  Returns self."""
        self.tracer = as_tracer(tracer)
        self.metrics = as_metrics(metrics)
        self._m_faults = self.metrics.counter("repro_faults_injected_total")
        return self

    def _roll(self, rate: float, kind: str) -> bool:
        self._n += 1
        hit = rate > 0.0 and self._rng.random() < rate
        if hit:
            self.log.append((self._n, kind))
            self.counts[kind] += 1
            self._m_faults.inc(kind=kind)
            if self.tracer.enabled:
                # clock-free timestamp: anchored to the newest traced
                # event, so tracing can never perturb the roll stream
                self.tracer.instant_at(f"fault.{kind}",
                                       self.tracer.last_ts, cat="fault",
                                       args={"roll": self._n,
                                             "seed": self.seed})
        return hit

    # --- compute-side faults -----------------------------------------------

    def before_serve(self, advance: Optional[Callable[[float], None]] = None
                     ) -> None:
        """Roll the per-dispatch faults: maybe stall the clock, maybe
        raise.  ``advance`` is the injectable clock's advance hook
        (None = spikes cannot be modeled, only step errors fire)."""
        if self._roll(self.spec.latency_spike_rate, "latency_spike") \
                and advance is not None and self.spec.latency_spike_s > 0:
            advance(self.spec.latency_spike_s)
        if self._roll(self.spec.step_error_rate, "step_error"):
            raise TransientStepError(
                f"injected transient step failure (seed {self.seed}, "
                f"roll {self._n})")

    def wrap_server(self, server,
                    advance: Optional[Callable[[float], None]] = None):
        """A ``Server``-shaped proxy whose ``serve`` rolls faults first."""
        return FaultyServer(server, self, advance=advance)

    def wrap_frontier(self, frontier,
                      advance: Optional[Callable[[float], None]] = None):
        """Wrap EVERY level of a ``FrontierServer`` (one shared roll
        stream, so the schedule is independent of which level serves)."""
        from repro_torch.runtime.frontier import FrontierServer
        points = [(name, self.wrap_server(frontier.server(i),
                                          advance=advance))
                  for i, name in enumerate(frontier.names)]
        # instrumentation survives wrapping: the chaos frontier traces
        # exactly like the healthy one
        return FrontierServer(points, manifest=frontier.manifest) \
            .instrument(tracer=frontier._tracer, metrics=frontier._metrics)

    # --- clock-side faults -------------------------------------------------

    def wrap_clock(self, clock: Callable[[], float]) -> "SkewedClock":
        return SkewedClock(clock, self)

    # --- traffic-side faults -----------------------------------------------

    def maybe_malform(self, payload: Any) -> Tuple[Any, bool]:
        """With ``malformed_rate``, corrupt a payload the way a buggy
        client would; returns (payload, was_malformed)."""
        if not self._roll(self.spec.malformed_rate, "malformed"):
            return payload, False
        style = self._rng.randrange(3)
        if isinstance(payload, tuple) and len(payload) == 2:
            toks, n_new = payload
            if style == 0:
                return (np.asarray(toks, np.float32), n_new), True  # dtype
            if style == 1:
                return (toks, 0), True                              # n_new
            return ("not tokens",), True                            # shape
        arr = np.asarray(payload)
        if style == 0:
            return arr[..., 0], True                                # rank
        if style == 1:
            return np.asarray([object()], dtype=object), True       # dtype
        return arr[:-1] if arr.shape[0] > 1 else arr[None], True    # shape


class FaultyServer:
    """Delegating server proxy: rolls injector faults before dispatch.

    Only ``serve`` is intercepted — ``validate``/``batch_limit``/
    ``kind`` pass through, so the proxy drops into a ``FrontierServer``
    or ``SLOScheduler`` anywhere the real server would go.
    """

    def __init__(self, inner, injector: FaultInjector,
                 advance: Optional[Callable[[float], None]] = None):
        self.inner = inner
        self.injector = injector
        self._advance = advance

    @property
    def kind(self) -> str:
        return self.inner.kind

    @property
    def batch_limit(self) -> int:
        return self.inner.batch_limit

    def validate(self, payload):
        return self.inner.validate(payload)

    def serve(self, payloads: Sequence[Any]) -> List[np.ndarray]:
        self.injector.before_serve(advance=self._advance)
        return self.inner.serve(payloads)


class SkewedClock:
    """A clock whose reads may jump FORWARD by ``clock_skew_s``.

    Monotonic within itself (offset only accumulates), deterministic
    from the injector's stream, and transparent when skew is off.
    """

    def __init__(self, base: Callable[[], float], injector: FaultInjector):
        self.base = base
        self.injector = injector
        self.offset = 0.0

    def __call__(self) -> float:
        inj = self.injector
        if inj._roll(inj.spec.clock_skew_rate, "clock_skew"):
            self.offset += inj.spec.clock_skew_s
        return self.base() + self.offset
