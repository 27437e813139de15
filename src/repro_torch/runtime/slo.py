"""SLO-aware multi-tenant serving over a plan-point frontier (port of
``repro.runtime.slo``).

The planner's accuracy×latency frontier (``core/planner.py``) becomes a
RUNTIME control knob here: under deadline pressure the scheduler sheds
load to faster/lower-bit plan points of the same model
(``runtime/frontier.py`` — every point a re-pack of one weight store),
and drains back to the accurate point when pressure clears.  Piece by
piece:

  * ``TokenBucket`` / ``TenantConfig``: per-tenant admission control.
    A tenant over its refill rate gets ``QueueFull(reason='tenant')``
    with a ``retry_after_s`` hint instead of starving everyone else's
    deadline budget.
  * ``DegradationController``: the hysteresis state machine.  Pressure
    (worst projected completion/deadline ratio over the queue) above
    ``high_water`` for ``up_after`` consecutive observations sheds one
    level; below ``low_water`` for ``down_after`` observations recovers
    one level; the mid-band HOLDS — the dead zone plus the consecutive-
    observation counts are what prevent flapping between plan points.
  * ``SLOScheduler``: the drive loop.  Per-request absolute deadlines
    (``slo_s`` from submit time), deadline-expired tickets cancelled in
    the queue (outcome ``'expired'`` — an expired request never strands
    a coalesced batch), transient step failures
    (``faults.TransientStepError``) retried with exponential backoff
    until ``max_retries``, and every terminal ticket records which plan
    point served it (``plan_point``) — results are bit-identical to a
    dedicated deployment of that point.

Memory is bounded under SUSTAINED overload: the queue by ``max_queue``
(backpressure), ticket/event history and the latency reservoir by fixed
caps, tenant buckets by the configured tenant set (unknown tenants
share the default bucket).  Everything is clock-injectable and
deterministic — chaos tests replay thousands of injected-fault steps
bit-identically (``tests/test_torch_slo.py``).
"""
from __future__ import annotations

import collections
import dataclasses
import math
import time
from typing import Any, Callable, Deque, Dict, List, Mapping, Optional, Tuple

import numpy as np

from repro_torch.runtime.faults import TransientStepError
from repro_torch.runtime.frontier import FrontierServer
from repro_torch.runtime.scheduler import QueueFull, Ticket, _SchedulerBase

__all__ = [
    "TokenBucket",
    "TenantConfig",
    "HysteresisConfig",
    "DegradationController",
    "SLOScheduler",
]


# ---------------------------------------------------------------------------
# Admission control: per-tenant token buckets
# ---------------------------------------------------------------------------


@dataclasses.dataclass(frozen=True)
class TenantConfig:
    """One tenant's admission budget: ``rate`` requests/s refill into a
    bucket of ``burst`` capacity (burst also the initial fill)."""

    rate: float
    burst: float = 1.0

    def __post_init__(self):
        if self.rate < 0 or self.burst < 1:
            raise ValueError(
                f"need rate >= 0 and burst >= 1, got {self}")


class TokenBucket:
    """Classic token bucket on an injectable clock.

    Robust to skewed clocks: refill never runs backwards (a forward
    clock jump just refills faster once).
    """

    def __init__(self, rate: float, burst: float,
                 clock: Callable[[], float]):
        self.rate = float(rate)
        self.burst = float(burst)
        self.clock = clock
        self.tokens = float(burst)
        self._t_last = clock()

    def _refill(self) -> None:
        now = self.clock()
        dt = max(0.0, now - self._t_last)
        self._t_last = now
        if self.rate > 0:
            self.tokens = min(self.burst, self.tokens + dt * self.rate)

    def try_take(self, n: float = 1.0) -> bool:
        self._refill()
        if self.tokens >= n:
            self.tokens -= n
            return True
        return False

    def retry_after_s(self, n: float = 1.0) -> float:
        """Seconds until ``n`` tokens will be available (0 if now)."""
        self._refill()
        if self.tokens >= n:
            return 0.0
        if self.rate <= 0:
            return math.inf
        return (n - self.tokens) / self.rate


# ---------------------------------------------------------------------------
# The degradation state machine
# ---------------------------------------------------------------------------


@dataclasses.dataclass(frozen=True)
class HysteresisConfig:
    """Shed/recover thresholds on the pressure signal.

    ``pressure`` is the worst projected completion-time/deadline-budget
    ratio over the queue (1.0 = the deadline will be hit exactly).  The
    dead zone between ``low_water`` and ``high_water`` HOLDS the current
    level, and transitions additionally need ``up_after``/``down_after``
    consecutive out-of-band observations — both are required for the
    no-flapping property.
    """

    high_water: float = 0.7
    low_water: float = 0.3
    up_after: int = 2
    down_after: int = 4

    def __post_init__(self):
        if not 0.0 < self.low_water < self.high_water:
            raise ValueError(
                f"need 0 < low_water < high_water, got {self}")
        if self.up_after < 1 or self.down_after < 1:
            raise ValueError("up_after/down_after must be >= 1")


class DegradationController:
    """Hysteresis ladder over ``n_levels`` frontier points.

    ``observe(pressure)`` is called once per scheduler tick and returns
    the level to serve at.  Transitions move ONE level at a time (the
    frontier is ordered, so each step is the smallest accuracy
    sacrifice that buys latency) and are recorded as
    ``(observation, from_level, to_level, pressure)`` in a bounded
    deque plus a running ``n_transitions`` counter.
    """

    def __init__(self, n_levels: int,
                 cfg: HysteresisConfig = HysteresisConfig(),
                 history: int = 1024):
        if n_levels < 1:
            raise ValueError("need at least one level")
        self.n_levels = int(n_levels)
        self.cfg = cfg
        self.level = 0
        self.n_transitions = 0
        self.transitions: Deque[Tuple[int, int, int, float]] = \
            collections.deque(maxlen=history)
        self._hot = 0
        self._cool = 0
        self._n_obs = 0

    def observe(self, pressure: float) -> int:
        self._n_obs += 1
        cfg = self.cfg
        if pressure >= cfg.high_water:
            self._hot += 1
            self._cool = 0
            if self._hot >= cfg.up_after and self.level < self.n_levels - 1:
                self._move(self.level + 1, pressure)
                self._hot = 0
        elif pressure <= cfg.low_water:
            self._cool += 1
            self._hot = 0
            if self._cool >= cfg.down_after and self.level > 0:
                self._move(self.level - 1, pressure)
                self._cool = 0
        else:
            # dead zone: hold the level AND reset the streaks — a signal
            # hovering around either threshold cannot flap the ladder.
            self._hot = self._cool = 0
        return self.level

    def _move(self, to: int, pressure: float) -> None:
        self.transitions.append((self._n_obs, self.level, to, pressure))
        self.n_transitions += 1
        self.level = to


# ---------------------------------------------------------------------------
# The SLO scheduler
# ---------------------------------------------------------------------------


class SLOScheduler(_SchedulerBase):
    """Deadline-aware admission + dispatch over a ``FrontierServer``.

    * ``slo_s``: default per-request deadline budget (overridable per
      submit); a ticket's ``deadline`` is absolute scheduler-clock time.
    * ``tenants``: ``{name: TenantConfig}`` token buckets;
      ``default_tenant`` covers unlisted tenants with ONE shared bucket
      (None = unlisted tenants are unthrottled), so bucket memory is
      bounded by the configured set, not by traffic.
    * ``est_serve_s``: initial per-dispatch serve-time estimate (one
      float, or one per frontier level); refined online by EWMA of
      measured dispatch times and used for the pressure projection and
      the ``QueueFull.retry_after_s`` hint.
    * ``max_retries``/``backoff_s``: a dispatch that raises
      ``TransientStepError`` requeues its batch at the FRONT (FIFO
      preserved) and pauses dispatch for an exponentially growing
      backoff; a ticket failing more than ``max_retries`` times is
      terminal ``'failed'``.

    ``step()`` order: cancel deadline-expired tickets, observe pressure
    (maybe shed/recover one level), then dispatch at most one batch at
    the current level.  Returns tickets terminalized this tick
    (completed + expired + failed).
    """

    def __init__(self, frontier: FrontierServer, *,
                 slo_s: float = 0.5,
                 tenants: Optional[Mapping[str, TenantConfig]] = None,
                 default_tenant: Optional[TenantConfig] = None,
                 hysteresis: HysteresisConfig = HysteresisConfig(),
                 est_serve_s=0.0,
                 ewma_alpha: float = 0.3,
                 max_retries: int = 3,
                 backoff_s: float = 0.01,
                 max_backoff_s: float = 1.0,
                 max_queue: int = 256,
                 max_wait_s: float = 0.0,
                 clock: Callable[[], float] = time.monotonic,
                 history: int = 1024, tracer=None, metrics=None):
        super().__init__(max_queue=max_queue, max_wait_s=max_wait_s,
                         clock=clock, history=history, tracer=tracer,
                         metrics=metrics,
                         mesh=getattr(frontier, "mesh", None))
        self.frontier = frontier
        # Frontier-level telemetry handles (base init cached the rest).
        # The frontier inherits this scheduler's tracer/metrics so its
        # per-level serve accounting lands in the same registry.
        self._m_level = self.metrics.gauge("repro_frontier_level")
        self._m_transitions = self.metrics.counter(
            "repro_frontier_transitions_total")
        frontier.instrument(tracer=self.tracer, metrics=self.metrics)
        self.slo_s = float(slo_s)
        self.controller = DegradationController(frontier.n_levels,
                                                hysteresis, history=history)
        n = frontier.n_levels
        est = ([float(est_serve_s)] * n
               if np.isscalar(est_serve_s) else
               [float(e) for e in est_serve_s])
        if len(est) != n:
            raise ValueError(
                f"est_serve_s needs {n} entries, got {len(est)}")
        self._est = est
        self.ewma_alpha = float(ewma_alpha)
        self.max_retries = int(max_retries)
        self.backoff_s = float(backoff_s)
        self.max_backoff_s = float(max_backoff_s)
        self.throttled = 0
        self._not_before = 0.0       # retry-backoff dispatch gate
        self._consec_failures = 0
        self._tenant_cfgs = dict(tenants or {})
        self._default_tenant = default_tenant
        self._buckets: Dict[str, Optional[TokenBucket]] = {}
        self._shared_default: Optional[TokenBucket] = None

    # --- admission ---------------------------------------------------------

    def _bucket(self, tenant: str) -> Optional[TokenBucket]:
        cfg = self._tenant_cfgs.get(tenant)
        if cfg is not None:
            b = self._buckets.get(tenant)
            if b is None:
                b = TokenBucket(cfg.rate, cfg.burst, self.clock)
                self._buckets[tenant] = b
            return b
        if self._default_tenant is None:
            return None
        # ONE shared bucket for every unlisted tenant: adversarial
        # tenant names cannot grow memory.
        if self._shared_default is None:
            self._shared_default = TokenBucket(
                self._default_tenant.rate, self._default_tenant.burst,
                self.clock)
        return self._shared_default

    def _retry_after_hint(self) -> float:
        est = self._est[self.level]
        if est > 0 and self._queue:
            limit = self.frontier.batch_limit(self.level)
            return est * math.ceil(len(self._queue) / limit)
        return super()._retry_after_hint()

    def submit(self, payload: Any, *, tenant: str = "default",
               slo_s: Optional[float] = None) -> Ticket:
        """One request -> a ticket (raises ``ValueError`` on a malformed
        payload, ``QueueFull`` on backpressure or tenant throttle).

        ``slo_s`` overrides the scheduler default for this request;
        pass ``float('inf')`` for a deadline-exempt request.
        """
        payload = self.frontier.validate(payload)
        now = self.clock()
        budget = self.slo_s if slo_s is None else float(slo_s)
        deadline = None if math.isinf(budget) else now + budget
        ticket = Ticket(id=next(self._ids), payload=payload, t_submit=now,
                        tenant=tenant, deadline=deadline)
        if len(self._queue) >= self.max_queue:
            return self._enqueue(ticket)  # raises the enriched QueueFull
        bucket = self._bucket(tenant)
        if bucket is not None and not bucket.try_take():
            self.rejected += 1
            self.throttled += 1
            self._m_rejected.inc(reason="tenant")
            if self.tracer.enabled:
                self.tracer.instant("throttle", cat="queue",
                                    args={"tenant": tenant})
            hint = bucket.retry_after_s()
            oldest = (now - self._queue[0].t_submit
                      if self._queue else 0.0)
            raise QueueFull(
                f"tenant {tenant!r} over its admission rate; retry in "
                f"{hint:.3f}s", depth=len(self._queue),
                oldest_wait_s=oldest, retry_after_s=hint, reason="tenant")
        return self._enqueue(ticket)

    # --- pressure + the drive loop -----------------------------------------

    @property
    def level(self) -> int:
        return self.controller.level

    @property
    def plan_point(self) -> str:
        """Name of the frontier point currently being served."""
        return self.frontier.name(self.level)

    def _expire_due(self, now: float) -> int:
        """Cancel queued tickets whose deadline has passed — BEFORE
        batch assembly, so an expired request never occupies a slot in
        a coalesced batch."""
        if not any(t.deadline is not None and t.deadline <= now
                   for t in self._queue):
            return 0
        keep: List[Ticket] = []
        expired: List[Ticket] = []
        for t in self._queue:
            if t.deadline is not None and t.deadline <= now:
                expired.append(t)
            else:
                keep.append(t)
        self._queue.clear()
        self._queue.extend(keep)
        for t in expired:
            self._expire(t, note="deadline passed in queue")
        self._log("expire", expired)
        return len(expired)

    def _pressure(self, now: float) -> float:
        """Worst projected completion/deadline-budget ratio in queue.

        The head's projection assumes its batch dispatches next; the
        tail's scales the per-batch serve estimate by the batches ahead
        of it, so sustained overload (deep backlog) raises pressure
        even while individual waits are still short.
        """
        if not self._queue:
            return 0.0
        est = self._est[self.level]
        limit = self.frontier.batch_limit(self.level)
        n_batches = math.ceil(len(self._queue) / limit)
        worst = 0.0
        for t, ahead in ((self._queue[0], 1), (self._queue[-1], n_batches)):
            if t.deadline is None:
                continue
            budget = max(t.deadline - t.t_submit, 1e-9)
            projected = (now - t.t_submit) + est * ahead
            worst = max(worst, projected / budget)
        return worst

    def step(self, flush: bool = False) -> int:
        """One tick: expire, observe pressure (maybe shed/recover),
        dispatch at most one batch.  Returns tickets terminalized."""
        self._tick += 1
        now = self.clock()
        done = self._expire_due(now)
        before = self.controller.level
        pressure = self._pressure(now)
        level = self.controller.observe(pressure)
        if level != before:
            direction = "shed" if level > before else "recover"
            self._log(direction, [])
            self._m_transitions.inc(direction=direction)
            self._m_level.set(level)
            if self.tracer.enabled:
                self.tracer.instant(
                    direction, cat="slo",
                    args={"from": before, "to": level,
                          "pressure": pressure,
                          "point": self.frontier.name(level)})
        if not self._queue:
            return done
        if now < self._not_before and not flush:
            return done  # retry backoff: let the transient clear
        limit = self.frontier.batch_limit(level)
        oldest_wait = now - self._queue[0].t_submit
        if len(self._queue) < limit and oldest_wait < self.max_wait_s \
                and not flush:
            return done  # keep coalescing inside the batching window
        take = min(len(self._queue), limit)
        batch = [self._queue.popleft() for _ in range(take)]
        for t in batch:
            if t.t_admit is None:
                t.t_admit = now
        self._log("dispatch", batch)
        try:
            t_serve = self.clock()
            results = self.frontier.serve([t.payload for t in batch],
                                          level=level)
            dt = max(0.0, self.clock() - t_serve)
        except TransientStepError as e:
            return done + self._handle_transient(batch, now, e)
        self._consec_failures = 0
        a = self.ewma_alpha
        self._est[level] = ((1 - a) * self._est[level] + a * dt
                            if self._est[level] > 0 else dt)
        name = self.frontier.name(level)
        for t, r in zip(batch, results):
            t.result = np.asarray(r)
            t.plan_point = name
            if level > 0:
                t.outcome = "degraded"
                self.degraded += 1
            self._complete(t)
            done += 1
        return done

    def _handle_transient(self, batch: List[Ticket], now: float,
                          err: TransientStepError) -> int:
        """Requeue a failed batch at the FRONT (FIFO preserved), fail
        tickets out of retries, and open the backoff window."""
        self.retried += len(batch)
        self._consec_failures += 1
        backoff = min(self.backoff_s * 2 ** (self._consec_failures - 1),
                      self.max_backoff_s)
        self._not_before = now + backoff
        done = 0
        survivors: List[Ticket] = []
        for t in batch:
            t.retries += 1
            if t.retries > self.max_retries:
                self._fail(t, note=f"retries exhausted: {err}")
                done += 1
            else:
                survivors.append(t)
        self._queue.extendleft(reversed(survivors))
        self._log("retry", survivors)
        if self.tracer.enabled:
            self.tracer.instant("backoff", cat="slo",
                                args={"backoff_s": backoff,
                                      "consecutive": self._consec_failures,
                                      "requeued": len(survivors)})
        return done

    def drain(self, max_steps: int = 10_000) -> int:
        """Serve until the queue is empty (ignores batching window and
        retry backoff; non-convergence FAILS the pending tickets and
        reports their ids/ages)."""
        n = 0
        for _ in range(max_steps):
            if not self._queue:
                return n
            n += self.step(flush=True)
        raise self._fail_pending("drain", max_steps)

    def stats(self) -> Dict[str, float]:
        st = super().stats()
        st["level"] = float(self.level)
        st["throttled"] = float(self.throttled)
        st["transitions"] = float(self.controller.n_transitions)
        return st
