"""Continuous-batching serving front end: admission queue -> batched
compute (port of ``repro.runtime.scheduler``).

``runtime/serve.py`` owns the compute side of deployment (packed weights,
the batch buckets of ``ImageServer``); this module owns the traffic side:
requests arrive one at a time, and a scheduler decides when to coalesce
them into the batch shapes the servers take.

  * ``ImageScheduler`` (CNN): independent single images, coalesced into
    ``ImageServer``'s batch buckets.  A batch dispatches as soon as the
    largest bucket fills, or when the oldest request has waited
    ``max_wait_s``.

  * ``GenerateScheduler`` (LM): (prompt, n_new) jobs of different lengths
    and lifetimes over a fixed number of decode slots.  Each ``step()``
    first admits waiting requests into free slots (same-length prompts in
    one batched prefill), then advances every in-flight slot by one token
    (or, over a ``SpeculativeGenerator``, one draft + verify cycle):
    prefill interleaves with in-flight decode.  Slots at the same position
    share one decode call (the decode step takes one scalar ``length``),
    padded up to a decode bucket.

Both are deterministic and clock-injectable (``clock`` is any zero-arg
callable returning seconds), stamp each ``Ticket`` per phase (submit /
admit / done), and push back: ``submit`` raises ``QueueFull`` at
``max_queue`` instead of buffering without bound.

A request's results do not depend on arrival order or batch composition:
batch entries never mix (every model operation acts per example on the
batch axis), and padding repeats an existing row whose outputs are
discarded, so a request's tokens or logits are the same bits whether it
was served alone, coalesced or interleaved mid-decode.

The port's decode updates its cache in place: a slot keeps a one-row view
of the batched cache of its last group, and the next tick's merge copies
the rows into a new batched cache.

Over a meshed backend every rank runs the same scheduler on the same
requests.  Buckets round up to multiples of the 'data' size; every clock
read is rank 0's, broadcast, so each decision taken from it is the same on
every rank.  A ``GenerateScheduler`` pins slot i to data coordinate i mod
n: its cache lives on that coordinate's ranks only (on a 'model' axis
above 1 each of them holds its block of the slot's sequence), each
prefill and decode batch holds every coordinate's own slots (padded per
coordinate), and only logits and tokens cross data coordinates.
"""
from __future__ import annotations

import collections
import dataclasses
import itertools
import random
import time
from typing import Any, Callable, Deque, Dict, List, Optional, Sequence, Tuple

import numpy as np
import torch

from repro_torch.core.plan import strip_kv
from repro_torch.launch import mesh as mesh_lib
from repro_torch.nn import param as nnp
from repro_torch.runtime.serve import round_buckets
from repro_torch.runtime.telemetry import as_metrics, as_tracer, declare_golden

__all__ = ["QueueFull", "Ticket", "ImageScheduler", "GenerateScheduler"]


class QueueFull(RuntimeError):
    """Backpressure: the admission queue is at ``max_queue`` (or a
    tenant's token bucket is empty); the caller should shed load or
    retry later (HTTP 429 territory).

    Carries enough context for a well-behaved client (or the SLO
    retry/backoff path) to act on the rejection without string parsing:

      * ``depth``:         requests waiting when the submit was refused.
      * ``oldest_wait_s``: how long the head of the queue has waited.
      * ``retry_after_s``: suggested backoff before resubmitting (the
                           serve-time estimate the SLO path uses).
      * ``reason``:        'queue' (admission queue at max_queue) or
                           'tenant' (per-tenant token bucket empty).
    """

    def __init__(self, message: str = "admission queue full", *,
                 depth: int = 0, oldest_wait_s: float = 0.0,
                 retry_after_s: float = 0.0, reason: str = "queue"):
        super().__init__(message)
        self.depth = int(depth)
        self.oldest_wait_s = float(oldest_wait_s)
        self.retry_after_s = float(retry_after_s)
        self.reason = reason


@dataclasses.dataclass
class Ticket:
    """One request's handle: result + per-phase latency accounting.

    SLO fields (the JAX package's ``runtime/slo.py``, not ported yet):
    ``deadline`` is the ABSOLUTE time
    (same clock as the scheduler's) by which the caller needs the
    result, ``tenant`` tags the request for per-tenant admission
    control, and the terminal ``outcome`` is one of

      * ``'ok'``:       served within the deadline (or no deadline).
      * ``'degraded'``: served by a faster/lower-bit plan point.
      * ``'late'``:     served, but past the deadline.
      * ``'expired'``:  cancelled in the queue at deadline (no result).
      * ``'failed'``:   retries exhausted / drive loop aborted (no
                        result; ``note`` says why).

    ``plan_point`` records which frontier plan point actually served
    the request (bit-equality against a dedicated run at that point is
    the graded property), ``retries`` how many transient-failure
    redispatches it survived.
    """

    id: int
    payload: Any = None
    n_new: int = 0                      # LM only: tokens requested
    t_submit: float = 0.0
    t_admit: Optional[float] = None     # first compute dispatch
    t_done: Optional[float] = None
    result: Optional[np.ndarray] = None
    done: bool = False
    deadline: Optional[float] = None    # absolute, scheduler-clock time
    tenant: str = "default"
    outcome: str = ""                   # terminal outcome (see above)
    plan_point: str = ""                # frontier point that served it
    retries: int = 0
    note: str = ""                      # diagnostic detail for failures

    @property
    def queue_wait_s(self) -> Optional[float]:
        return None if self.t_admit is None else self.t_admit - self.t_submit

    @property
    def latency_s(self) -> Optional[float]:
        return None if self.t_done is None else self.t_done - self.t_submit

    @property
    def deadline_met(self) -> Optional[bool]:
        """True/False once terminal (None while pending or no deadline).
        Expired/failed tickets never met their deadline."""
        if self.deadline is None or not self.done:
            return None
        return self.result is not None and self.t_done <= self.deadline


class _SchedulerBase:
    """Queue + accounting shared by both front ends.

    A scheduler is a LONG-RUNNING component: latency statistics are
    kept as running aggregates (O(1) memory), the retained
    ticket/event history is bounded by ``history`` (the newest entries,
    for debugging/tests), and a completed ticket drops its input
    payload — callers hold their own ``Ticket`` reference for the
    result.
    """

    RESERVOIR_SIZE = 512  # latency quantile sample (O(1) memory forever)

    def __init__(self, *, max_queue: int, max_wait_s: float,
                 clock: Callable[[], float], history: int = 1024,
                 tracer=None, metrics=None, mesh=None):
        self.max_queue = int(max_queue)
        self.max_wait_s = float(max_wait_s)
        # Over a meshed backend every rank runs this scheduler on the same
        # requests: each clock read is rank 0's, broadcast, so deadlines,
        # batching windows and bucket choices agree on every rank.
        self.clock = mesh_lib.shared_clock(clock, mesh)
        self._queue: Deque[Ticket] = collections.deque()
        self._ids = itertools.count()
        self.rejected = 0
        self.expired = 0     # deadline cancellations (SLO scheduling)
        self.degraded = 0    # served at a lower-bit frontier point
        self.retried = 0     # transient-failure redispatches
        self.failed = 0      # retries exhausted / drive loop aborted
        self.served: Deque[Ticket] = collections.deque(maxlen=history)
        self.events: Deque[Tuple[int, str, Tuple[int, ...]]] = \
            collections.deque(maxlen=max(4 * history, 4096))
        self.dropped_events = 0   # oldest entries the bounded deques shed
        self.dropped_tickets = 0  # (truncation must be visible, not silent)
        self._tick = 0
        self._n_served = 0
        self._lat_sum = self._lat_max = self._qw_sum = 0.0
        # Fixed-size latency reservoir (Vitter's algorithm R, seeded so
        # runs are reproducible): a uniform sample of ALL completions at
        # O(1) memory — safe for a front end that serves forever.
        self._res: List[float] = []
        self._res_seen = 0
        self._res_rng = random.Random(0x510)
        # Telemetry: both default to the shared no-op objects, and every
        # metric handle is cached here so the hot path never does a
        # registry lookup.  The tracer MUST share this scheduler's clock
        # (trace timestamps mix span_at(ticket times) with live reads).
        self.tracer = as_tracer(tracer)
        self.metrics = declare_golden(as_metrics(metrics))
        m = self.metrics
        self._m_submitted = m.counter("repro_requests_submitted_total")
        self._m_rejected = m.counter("repro_requests_rejected_total")
        self._m_completed = m.counter("repro_requests_completed_total")
        self._m_batches = m.counter("repro_batches_total")
        self._m_qdepth = m.gauge("repro_queue_depth")
        self._m_latency = m.histogram("repro_request_latency_seconds")
        self._m_qwait = m.histogram("repro_queue_wait_seconds")
        self._m_drop_ev = m.counter("repro_dropped_events_total")
        self._m_drop_tk = m.counter("repro_dropped_tickets_total")

    def _retry_after_hint(self) -> float:
        """Suggested client backoff on rejection: the batching window is
        the base scheduler's best guess at when a slot frees (the SLO
        scheduler overrides this with its serve-time estimate)."""
        return max(self.max_wait_s, 1e-3)

    def _enqueue(self, ticket: Ticket) -> Ticket:
        if len(self._queue) >= self.max_queue:
            self.rejected += 1
            self._m_rejected.inc(reason="queue")
            now = self.clock()
            oldest = now - self._queue[0].t_submit if self._queue else 0.0
            hint = self._retry_after_hint()
            if self.tracer.enabled:
                self.tracer.instant("reject", cat="queue",
                                    args={"depth": len(self._queue),
                                          "reason": "queue"})
            raise QueueFull(
                f"admission queue full ({len(self._queue)} waiting, "
                f"oldest {oldest:.3f}s); retry in {hint:.3f}s",
                depth=len(self._queue), oldest_wait_s=oldest,
                retry_after_s=hint)
        self._queue.append(ticket)
        self._m_submitted.inc()
        self._m_qdepth.set(len(self._queue))
        if self.tracer.enabled:
            self.tracer.instant("submit", cat="request", tid=ticket.id,
                                args={"tenant": ticket.tenant})
        return ticket

    @property
    def pending(self) -> int:
        return len(self._queue)

    def _log(self, kind: str, tickets: Sequence[Ticket]) -> None:
        if len(self.events) == self.events.maxlen:
            self.dropped_events += 1
            self._m_drop_ev.inc()
        self.events.append((self._tick, kind, tuple(t.id for t in tickets)))
        self._m_batches.inc(phase=kind)
        if self.tracer.enabled:
            self.tracer.instant(kind, cat="sched",
                                args={"tick": self._tick,
                                      "n": len(tickets)})

    def _retire(self, ticket: Ticket) -> None:
        """Append a terminal ticket to the bounded history, counting the
        oldest entry it pushes out."""
        if len(self.served) == self.served.maxlen:
            self.dropped_tickets += 1
            self._m_drop_tk.inc()
        self.served.append(ticket)

    def _trace_terminal(self, ticket: Ticket) -> None:
        """Retroactive lifecycle spans from the timestamps the ticket
        already carries (one call at terminal time — the hot path never
        touches the tracer): an outer ``request`` span enclosing
        ``queue`` (submit -> admit) and ``serve`` (admit -> done), all
        on the ticket's own trace track (tid = ticket id)."""
        tr = self.tracer
        if not tr.enabled:
            return
        tid = ticket.id
        args = {"outcome": ticket.outcome}
        if ticket.plan_point:
            args["plan_point"] = ticket.plan_point
        if ticket.retries:
            args["retries"] = ticket.retries
        if ticket.note:
            args["note"] = ticket.note
        tr.span_at("request", ticket.t_submit, ticket.t_done,
                   cat="request", tid=tid, args=args)
        if ticket.t_admit is not None:
            tr.span_at("queue", ticket.t_submit, ticket.t_admit,
                       cat="request", tid=tid)
            tr.span_at("serve", ticket.t_admit, ticket.t_done,
                       cat="request", tid=tid)

    def _check_not_terminal(self, ticket: Ticket) -> None:
        """A ticket terminates exactly once — double completion is a
        scheduler bug the chaos suite must be able to catch loudly."""
        if ticket.done:
            raise RuntimeError(
                f"ticket {ticket.id} is already terminal "
                f"({ticket.outcome!r}): double completion")

    def _complete(self, ticket: Ticket) -> None:
        self._check_not_terminal(ticket)
        ticket.t_done = self.clock()
        ticket.done = True
        ticket.payload = None  # the result is what callers keep
        if not ticket.outcome:
            ticket.outcome = "ok"
        if (ticket.deadline is not None and ticket.t_done > ticket.deadline
                and ticket.outcome == "ok"):
            ticket.outcome = "late"  # served, but past the deadline
        self._n_served += 1
        self._lat_sum += ticket.latency_s
        self._lat_max = max(self._lat_max, ticket.latency_s)
        self._qw_sum += ticket.queue_wait_s
        self._sample_latency(ticket.latency_s)
        self._retire(ticket)
        self._m_completed.inc(outcome=ticket.outcome)
        self._m_latency.observe(ticket.latency_s)
        self._m_qwait.observe(ticket.queue_wait_s)
        self._m_qdepth.set(len(self._queue))
        self._trace_terminal(ticket)

    def _expire(self, ticket: Ticket, note: str = "") -> None:
        """Deadline cancellation: terminal without a result, so an
        expired request can never strand a coalesced batch."""
        self._check_not_terminal(ticket)
        ticket.t_done = self.clock()
        ticket.done = True
        ticket.outcome = "expired"
        ticket.note = note
        ticket.payload = None
        self.expired += 1
        self._retire(ticket)
        self._m_completed.inc(outcome="expired")
        self._m_qdepth.set(len(self._queue))
        self._trace_terminal(ticket)

    def _fail(self, ticket: Ticket, note: str = "") -> None:
        """Terminal failure (retries exhausted, aborted drive loop)."""
        self._check_not_terminal(ticket)
        ticket.t_done = self.clock()
        ticket.done = True
        ticket.outcome = "failed"
        ticket.note = note
        ticket.payload = None
        self.failed += 1
        self._retire(ticket)
        self._m_completed.inc(outcome="failed")
        self._m_qdepth.set(len(self._queue))
        self._trace_terminal(ticket)

    # --- non-convergent drive loops ----------------------------------------

    def _pending_tickets(self) -> List[Ticket]:
        """Every ticket the drive loop still owes (queue; subclasses add
        in-flight slots)."""
        return list(self._queue)

    def _fail_pending(self, op: str, max_steps: int) -> RuntimeError:
        """A drive loop that did not converge must not STRAND its
        pending tickets (callers block on ``ticket.done`` forever):
        fail each one with a diagnostic outcome, then report their ids
        and ages so the operator can see what was stuck."""
        now = self.clock()
        pending = self._pending_tickets()
        ages = ", ".join(f"{t.id}:{now - t.t_submit:.3f}s"
                         for t in pending[:16])
        more = "" if len(pending) <= 16 else f" +{len(pending) - 16} more"
        for t in pending:
            self._fail(t, note=f"{op} did not converge")
        self._queue.clear()
        self._log(f"{op}_abort", pending)
        return RuntimeError(
            f"{op} did not converge after {max_steps} steps; failed "
            f"{len(pending)} pending tickets with outcome 'failed' "
            f"(id:age {ages}{more})")

    # --- statistics --------------------------------------------------------

    def _sample_latency(self, lat: float) -> None:
        self._res_seen += 1
        if len(self._res) < self.RESERVOIR_SIZE:
            self._res.append(lat)
        else:
            j = self._res_rng.randrange(self._res_seen)
            if j < self.RESERVOIR_SIZE:
                self._res[j] = lat

    def _quantile(self, sorted_res: List[float], q: float) -> float:
        if not sorted_res:
            return 0.0
        idx = min(int(round(q * (len(sorted_res) - 1))), len(sorted_res) - 1)
        return sorted_res[idx]

    def stats(self) -> Dict[str, float]:
        """Aggregate latency accounting over completed requests.

        Quantiles come from the fixed-size reservoir — a uniform sample
        of every completion so far, not a sliding window.  The key set
        is IDENTICAL across every scheduler (the schema-parity contract;
        tests/test_torch_scheduler.py holds it to the JAX package's): SLO
        counters are zero on the plain schedulers, cache accounting zero
        outside the LM front end — dashboards consume any scheduler
        uniformly."""
        n = self._n_served
        res = sorted(self._res)
        return {
            "served": float(n),
            "rejected": float(self.rejected),
            "pending": float(self.pending),
            "expired": float(self.expired),
            "degraded": float(self.degraded),
            "retried": float(self.retried),
            "failed": float(self.failed),
            "mean_latency_s": self._lat_sum / n if n else 0.0,
            "max_latency_s": self._lat_max,
            "mean_queue_wait_s": self._qw_sum / n if n else 0.0,
            "p50_latency_s": self._quantile(res, 0.50),
            "p95_latency_s": self._quantile(res, 0.95),
            "p99_latency_s": self._quantile(res, 0.99),
            # bounded-history truncation (oldest entries shed)
            "dropped_events": float(self.dropped_events),
            "dropped_tickets": float(self.dropped_tickets),
            # SLO machinery (live only on SLOScheduler)
            "level": 0.0,
            "throttled": 0.0,
            "transitions": 0.0,
            # resident KV-cache accounting (live only on GenerateScheduler)
            "cache_bytes_per_slot": 0.0,
            "resident_cache_bytes": 0.0,
            "resident_cache_fp_bytes": 0.0,
            "kv_cache_compression": 1.0,
            # speculative decode (live only on a spec-decoding
            # GenerateScheduler; zero-filled on every other path)
            "accept_rate": 0.0,
            "drafted_tokens": 0.0,
            "accepted_tokens": 0.0,
        }


# ---------------------------------------------------------------------------
# CNN: bucket coalescing
# ---------------------------------------------------------------------------


class ImageScheduler(_SchedulerBase):
    """Admission queue in front of an ``ImageServer``-shaped backend.

    ``server`` needs ``.predict(images) -> logits`` and
    ``.batch_buckets`` (ascending tuple); unit tests inject fakes.

    Admission rule: a batch dispatches when the queue can fill the
    largest bucket, or when the oldest waiting request is older than
    ``max_wait_s`` (then the smallest bucket that fits the stragglers
    is used — the server pads the remainder).  ``step(flush=True)``
    dispatches whatever is queued regardless of the window (drain).
    """

    def __init__(self, server, *, max_queue: int = 256,
                 max_wait_s: float = 0.005,
                 clock: Callable[[], float] = time.monotonic,
                 history: int = 1024, tracer=None, metrics=None):
        super().__init__(max_queue=max_queue, max_wait_s=max_wait_s,
                         clock=clock, history=history, tracer=tracer,
                         metrics=metrics, mesh=getattr(server, "mesh", None))
        self.server = server
        self.buckets = tuple(sorted(server.batch_buckets))
        self.dispatched_batches: Deque[int] = collections.deque(
            maxlen=history)
        # Expected request shape: from the server's model config when it
        # carries one (ImageServer), else locked to the first request.
        cfg = getattr(getattr(server, "api", None), "cfg", None)
        self._img_shape = ((cfg.img_size, cfg.img_size, 3)
                           if hasattr(cfg, "img_size") else None)

    def submit(self, image: np.ndarray) -> Ticket:
        """One (H, W, C) image -> a ticket (raises ``QueueFull``).

        Shape-checked here: a malformed request must be rejected at the
        door, not explode a dispatch and strand its whole batch."""
        image = np.asarray(image)
        if self._img_shape is None:
            if image.ndim != 3:
                raise ValueError(
                    f"expected an (H, W, C) image, got shape {image.shape}")
            self._img_shape = image.shape
        elif image.shape != self._img_shape:
            raise ValueError(
                f"image shape {image.shape} does not match this "
                f"scheduler's {self._img_shape}")
        t = Ticket(id=next(self._ids), payload=image,
                   t_submit=self.clock())
        return self._enqueue(t)

    def step(self, flush: bool = False) -> int:
        """Dispatch at most one batch; returns requests completed."""
        self._tick += 1
        if not self._queue:
            return 0
        oldest = self.clock() - self._queue[0].t_submit
        if (len(self._queue) < self.buckets[-1] and oldest < self.max_wait_s
                and not flush):
            return 0  # keep coalescing inside the batching window
        take = min(len(self._queue), self.buckets[-1])
        batch = [self._queue.popleft() for _ in range(take)]
        now = self.clock()
        for t in batch:
            t.t_admit = now
        self._log("dispatch", batch)
        self.dispatched_batches.append(take)
        logits = np.asarray(self.server.predict(
            np.stack([t.payload for t in batch])))
        for i, t in enumerate(batch):
            t.result = logits[i]
            self._complete(t)
        return take

    def drain(self, max_steps: int = 10_000) -> int:
        """Serve until the queue is empty (flushing partial batches).

        If the loop does not converge within ``max_steps``, the pending
        tickets are FAILED (outcome ``'failed'``) rather than stranded,
        and the raised error lists their ids and ages."""
        n = 0
        for _ in range(max_steps):
            if not self._queue:
                return n
            n += self.step(flush=True)
        raise self._fail_pending("drain", max_steps)


# ---------------------------------------------------------------------------
# LM: prefill/decode slot interleaving (continuous batching)
# ---------------------------------------------------------------------------


@dataclasses.dataclass
class _Slot:
    ticket: Ticket
    cache: Any             # per-request cache tree (batch dim kept at 1);
                           # None on a rank that does not hold the slot
    last_tok: np.ndarray   # (1, 1) int32
    pos: int               # tokens currently in the cache
    remaining: int         # decode steps still owed
    out: List[int]


def _tree_map(fn, tree, *rest):
    """Map over the leaves of matching trees of dicts, lists and tuples."""
    if isinstance(tree, dict):
        return {k: _tree_map(fn, tree[k], *(r[k] for r in rest))
                for k in tree}
    if isinstance(tree, (list, tuple)):
        return type(tree)(_tree_map(fn, t, *(r[i] for r in rest))
                          for i, t in enumerate(tree))
    return fn(tree, *rest)


def _leaves(tree) -> List[Any]:
    if isinstance(tree, dict):
        return [x for v in tree.values() for x in _leaves(v)]
    if isinstance(tree, (list, tuple)):
        return [x for v in tree for x in _leaves(v)]
    return [tree]


def _cache_batch_axes(api, max_len: int):
    """Which axis of every decode-cache leaf is the request (batch) axis.

    Probed structurally -- ``cache_specs(1, L)`` and ``cache_specs(2, L)``
    differ in exactly the batch dimension -- so slot insert/extract works
    for any family whose cache is a tree of batched tensors, without
    per-family layout knowledge.
    """
    def axis(s1, s2):
        diffs = [i for i, (d1, d2) in enumerate(zip(s1.shape, s2.shape))
                 if d1 != d2]
        if len(diffs) != 1:
            raise ValueError(
                f"cannot locate the batch axis of cache leaf {s1.shape}; "
                f"continuous batching needs a per-request-sliceable cache")
        return diffs[0]

    return _tree_map(axis, api.cache_specs(1, max_len),
                     api.cache_specs(2, max_len))


def _spec_bytes(specs) -> int:
    return sum(int(np.prod(s.shape)) * torch.empty((), dtype=s.dtype)
               .element_size() for s in _leaves(specs) if nnp.is_spec(s))


class GenerateScheduler(_SchedulerBase):
    """Continuous-batching front end over a packed LM ``Generator`` (or a
    ``SpeculativeGenerator``).

    ``gen`` supplies the prefill/decode steps and the cache-growing logic
    (``_prefill``, ``_decode``, ``_grow_cache``, ``params``); this class
    owns slots, admission and per-request accounting.

    * ``slots``: max requests decoding concurrently.
    * ``max_len``: every slot's cache is allocated at this length, so
      slots are shape-compatible and can share decode calls; a request
      with ``prompt_len + n_new > max_len`` is rejected at submit.
    * ``prefill_buckets`` / ``decode_buckets``: the allowed batch shapes
      (groups are padded up by repeating a row).

    Admission coalesces the FIFO head-run of same-prompt-length requests
    into one batched prefill (held up to ``max_wait_s`` while below the
    admittable group size; the default 0.0 admits at once); decode groups
    in-flight slots by their current position and advances each group one
    token per ``step()``.
    """

    def __init__(self, gen, *, slots: int = 4, max_len: int = 64,
                 prefill_buckets: Tuple[int, ...] = (1, 2, 4),
                 decode_buckets: Tuple[int, ...] = (1, 2, 4, 8),
                 max_queue: int = 256, max_wait_s: float = 0.0,
                 clock: Callable[[], float] = time.monotonic,
                 history: int = 1024, tracer=None, metrics=None):
        super().__init__(max_queue=max_queue, max_wait_s=max_wait_s,
                         clock=clock, history=history, tracer=tracer,
                         metrics=metrics, mesh=getattr(gen, "mesh", None))
        self.gen = gen
        # A SpeculativeGenerator carries two packed views of one
        # checkpoint; slots then hold a {"verify","draft"} cache pair and
        # decode advances by spec cycles instead of single steps.
        self._speculative = bool(getattr(gen, "is_speculative", False))
        self.spec_k = int(gen.k) if self._speculative else 0
        self.api = gen.api_verify if self._speculative else gen.api
        if self.api.needs_frames:
            raise NotImplementedError(
                "GenerateScheduler does not carry per-request audio frames")
        self.device = gen.device
        self.n_slots = int(slots)
        self.max_len = int(max_len)
        # A meshed Generator splits every batch evenly over 'data': the
        # buckets round up to its size.  Slot i lives on data coordinate i
        # mod n, and every batch puts each coordinate's own slots in its
        # rows (``_layout``), so a slot's cache never leaves its ranks.
        self.rows = mesh_lib.DataRows(getattr(gen, "mesh", None))
        self.prefill_buckets = round_buckets(prefill_buckets, self.rows.n)
        self.decode_buckets = round_buckets(decode_buckets, self.rows.n)
        self._slots: List[Optional[_Slot]] = [None] * self.n_slots
        # one cache row a rank runs in a decode group holding none of its
        # slots (its outputs are discarded, as a padded row's are)
        self._spare = None
        # The axis probe runs per plan point: a speculative slot's cache
        # is the dict pair, and the tree map carries the mirrored structure.
        if self._speculative:
            self._batch_axes = {
                "verify": _cache_batch_axes(gen.api_verify, self.max_len),
                "draft": _cache_batch_axes(gen.api_draft, self.max_len)}
        else:
            self._batch_axes = _cache_batch_axes(self.api, self.max_len)
        # Resident-cache accounting (stats()): bytes of one slot's cache
        # under the serving plan (packed digit planes for kv plans) and
        # under the same plan with a bf16 cache -- the quotient is the
        # deployed KV compression, reported live per step.
        point_apis = ([gen.api_verify, gen.api_draft] if self._speculative
                      else [self.api])
        self.cache_bytes_per_slot = sum(
            _spec_bytes(a.cache_specs(1, self.max_len)) for a in point_apis)
        self.cache_fp_bytes_per_slot = sum(
            _spec_bytes(dataclasses.replace(a, policy=strip_kv(a.policy))
                        .cache_specs(1, self.max_len)) for a in point_apis)

    # --- slot cache plumbing (family-agnostic via the axis probe) ----------

    def _merge(self, caches: List[Any], pad_to: int):
        """Per-slot cache trees -> one batched tree, padded by repeating
        the last real row (its outputs are discarded)."""
        g = len(caches)
        idx = torch.as_tensor(list(range(g)) + [g - 1] * (pad_to - g),
                              device=self.device)

        def leaf(ax, *xs):
            m = xs[0] if g == 1 else torch.cat(xs, dim=ax)
            return torch.index_select(m, ax, idx) if pad_to != g else m

        return _tree_map(leaf, self._batch_axes, *caches)

    def _extract(self, cache, i: int):
        """Row ``i`` of a batched cache tree, batch dim kept at size 1 (a
        view: the next merge copies it)."""
        return _tree_map(lambda ax, x: x.narrow(ax, i, 1), self._batch_axes,
                         cache)

    def _layout(self, owners: Sequence[int], buckets: Tuple[int, ...]):
        """A batch whose item i runs on rank ``owners[i]`` -> (the item
        each row of the batch holds (np), each item's row (np), the
        bucket).  Rank r's rows ``[r * per, (r + 1) * per)`` hold its
        items in order, padded by repeating its last (a rank with none
        repeats the batch's last item); with one rank that is
        ``_pad_batch``'s padding."""
        n = self.rows.n
        mine = [[i for i, o in enumerate(owners) if o == r]
                for r in range(n)]
        need = n * max(len(m) for m in mine)
        bucket = next(b for b in buckets if b >= need)
        per = bucket // n
        src = np.concatenate([
            m + [m[-1] if m else len(owners) - 1] * (per - len(m))
            for m in mine]).astype(np.int64)
        row = np.empty(len(owners), np.int64)
        for r, m in enumerate(mine):
            row[m] = r * per + np.arange(len(m))
        return src, row, bucket

    def _local_rows(self, row: np.ndarray, owners: Sequence[int],
                    bucket: int) -> List[Optional[int]]:
        """Each item's row in this rank's share of the batch, or None
        where another rank holds it."""
        per = bucket // self.rows.n
        return [int(r) - self.rows.rank * per if o == self.rows.rank
                else None for r, o in zip(row, owners)]

    def _keep_spare(self, cache) -> None:
        if self.rows.n > 1 and self._spare is None:
            self._spare = _tree_map(lambda ax, x: x.narrow(ax, 0, 1).clone(),
                                    self._batch_axes, cache)

    def _tokens(self, arr: np.ndarray) -> torch.Tensor:
        return torch.as_tensor(arr, dtype=torch.long, device=self.device)

    # --- admission ---------------------------------------------------------

    def submit(self, tokens: np.ndarray, n_new: int) -> Ticket:
        """One (L,) or (1, L) prompt -> a ticket (raises ``QueueFull``)."""
        toks = np.asarray(tokens, np.int32).reshape(1, -1)
        if n_new < 1:
            raise ValueError(f"n_new must be >= 1, got {n_new}")
        if toks.shape[1] + n_new > self.max_len:
            raise ValueError(
                f"prompt {toks.shape[1]} + n_new {n_new} exceeds the "
                f"scheduler's max_len {self.max_len}")
        t = Ticket(id=next(self._ids), payload=toks, n_new=int(n_new),
                   t_submit=self.clock())
        return self._enqueue(t)

    @property
    def active(self) -> int:
        return sum(s is not None for s in self._slots)

    def _free_slots(self) -> List[int]:
        return [i for i, s in enumerate(self._slots) if s is None]

    def _admission_ranks(self, free: List[int]) -> List[int]:
        """The ranks the next prompts of one prefill go to, in order: the
        ranks' free slots taken in turn, at most a rank's share of the
        largest prefill bucket each (one rank: ``min(len(free),
        prefill_buckets[-1])`` prompts)."""
        n = self.rows.n
        cap = self.prefill_buckets[-1] // n
        room = [min(sum(1 for i in free if i % n == r), cap)
                for r in range(n)]
        return [r for tier in range(max(room)) for r in range(n)
                if room[r] > tier]

    def _admit(self, flush: bool = False) -> int:
        """Prefill the FIFO head-run of same-length prompts into free
        slots (one batched prefill per head-run), holding below-capacity
        groups inside the ``max_wait_s`` batching window."""
        free = self._free_slots()
        if not free or not self._queue:
            return 0
        plen = self._queue[0].payload.shape[1]
        ranks = self._admission_ranks(free)
        limit = len(ranks)
        run = 0
        while (run < len(self._queue) and run < limit
               and self._queue[run].payload.shape[1] == plen):
            run += 1
        oldest = self.clock() - self._queue[0].t_submit
        if run < limit and oldest < self.max_wait_s and not flush:
            return 0  # keep coalescing prompts inside the window
        group: List[Ticket] = []
        while (self._queue and len(group) < limit
               and self._queue[0].payload.shape[1] == plen):
            group.append(self._queue.popleft())
        owners = ranks[:len(group)]
        src, row, bucket = self._layout(owners, self.prefill_buckets)
        toks = self._tokens(np.concatenate([t.payload for t in group])[src])
        now = self.clock()
        for t in group:
            t.t_admit = now
        self._log("prefill", group)
        if self._speculative:
            # Prefill BOTH packed views of the checkpoint; the first
            # emitted token comes from the verify plan (the shipped one).
            first, pre = self.gen.prefill_slots(toks)
            cache = {
                "verify": self.gen.gen_verify._grow_cache(
                    pre["verify"], bucket, plen, self.max_len),
                "draft": self.gen.gen_draft._grow_cache(
                    pre["draft"], bucket, plen, self.max_len)}
        else:
            logits, pre_cache = self.gen._prefill(self.gen.params,
                                                  {"tokens": toks})
            cache = self.gen._grow_cache(pre_cache, bucket, plen,
                                         self.max_len)
            first = torch.argmax(logits, -1).cpu().numpy()
        self._keep_spare(cache)
        first = np.asarray(first, np.int32)[row]
        local = self._local_rows(row, owners, bucket)
        finished = 0
        for i, t in enumerate(group):
            slot = _Slot(ticket=t, cache=(None if local[i] is None else
                                          self._extract(cache, local[i])),
                         last_tok=first[i].reshape(1, 1), pos=plen,
                         remaining=t.n_new - 1, out=[int(first[i])])
            if slot.remaining == 0:  # n_new == 1: done at prefill
                self._finish(slot)
                finished += 1
            else:  # the first free slot of the rank that holds its cache
                slot_i = next(j for j in free
                              if j % self.rows.n == owners[i])
                free.remove(slot_i)
                self._slots[slot_i] = slot
        return finished

    # --- decode ------------------------------------------------------------

    def _finish(self, slot: _Slot) -> None:
        t = slot.ticket
        t.result = np.asarray(slot.out, np.int32)
        self._complete(t)

    def _groups(self):
        """In-flight slots by position, each rank's slots of a group cut to
        its share of the largest decode bucket (the rest go next step) ->
        [(pos, slot indices, slots, owners, layout)], ``layout`` as
        ``_layout`` gives it."""
        groups: Dict[int, List[int]] = collections.defaultdict(list)
        for i, s in enumerate(self._slots):
            if s is not None:
                groups[s.pos].append(i)
        n = self.rows.n
        cap = self.decode_buckets[-1] // n
        out = []
        for pos in sorted(groups):
            taken = collections.Counter()
            idxs = []
            for i in groups[pos]:
                if taken[i % n] < cap:
                    taken[i % n] += 1
                    idxs.append(i)
            owners = [i % n for i in idxs]
            out.append((pos, idxs, [self._slots[i] for i in idxs], owners,
                        self._layout(owners, self.decode_buckets)))
        return out

    def _group_inputs(self, slots, owners, layout):
        """A decode group's batch -> (this rank's merged cache, the whole
        batch's last tokens)."""
        src, _, bucket = layout
        mine = [s.cache for s, o in zip(slots, owners)
                if o == self.rows.rank]
        cache = self._merge(mine or [self._spare], bucket // self.rows.n)
        toks = self._tokens(np.concatenate([s.last_tok for s in slots])[src])
        return cache, toks

    def _advance(self, idxs, slots, cache, rows: np.ndarray,
                 takes: Sequence[int],
                 local: Sequence[Optional[int]]) -> int:
        """Hand each slot of a group its new tokens (row i of ``rows``, the
        first ``takes[i]`` of them) and, on the rank that holds it, its
        cache row ``local[i]``; finish the done."""
        finished = 0
        for i, (slot_i, s) in enumerate(zip(idxs, slots)):
            take = takes[i]
            s.cache = None if local[i] is None else self._extract(cache,
                                                                  local[i])
            s.out.extend(int(x) for x in rows[i, :take])
            s.last_tok = np.asarray(rows[i, take - 1],
                                    np.int32).reshape(1, 1)
            s.pos += take
            s.remaining -= take
            if s.remaining == 0:
                self._finish(s)
                self._slots[slot_i] = None
                finished += 1
        return finished

    def _spec_tick(self) -> int:
        """Advance every in-flight slot one speculative cycle (up to
        ``spec_k + 1`` tokens); same-position slots share one cycle.

        Acceptance-aware accounting: slot i takes ``min(a_i + 1,
        remaining_i)`` tokens from the verify argmax rows, so slots of one
        group diverge in position and regroup on later ticks.  The group's
        ``k_eff`` is clamped to the smallest remaining budget, so no
        slot's cache is written past its submit-time bound."""
        finished = 0
        for pos, idxs, slots, owners, layout in self._groups():
            _, row, bucket = layout
            cache, toks = self._group_inputs(slots, owners, layout)
            k_eff = min(self.spec_k, min(s.remaining for s in slots) - 1)
            self._log("decode", [s.ticket for s in slots])
            v_toks, acc, cache = self.gen.spec_cycle(cache, toks, pos, k_eff,
                                                     rows=row)
            takes = [min(int(acc[r]) + 1, s.remaining)
                     for r, s in zip(row, slots)]
            finished += self._advance(idxs, slots, cache, v_toks[row], takes,
                                      self._local_rows(row, owners, bucket))
        return finished

    def _decode_tick(self) -> int:
        """Advance every in-flight slot one token; same-position slots
        share one decode call (scalar ``length``)."""
        if self._speculative:
            return self._spec_tick()
        finished = 0
        for pos, idxs, slots, owners, layout in self._groups():
            _, row, bucket = layout
            cache, toks = self._group_inputs(slots, owners, layout)
            self._log("decode", [s.ticket for s in slots])
            logits, cache = self.gen._decode(self.gen.params, cache, toks,
                                             pos)
            nxt = torch.argmax(logits, -1).cpu().numpy()[row][:, None]
            finished += self._advance(idxs, slots, cache, nxt,
                                      [1] * len(slots),
                                      self._local_rows(row, owners, bucket))
        return finished

    # --- the drive loop ----------------------------------------------------

    def step(self, flush: bool = False) -> int:
        """One scheduler tick: admit (prefill) then decode one token for
        every in-flight slot.  Returns requests completed this tick
        (including ``n_new == 1`` jobs that finish at prefill)."""
        self._tick += 1
        return self._admit(flush=flush) + self._decode_tick()

    def _pending_tickets(self) -> List[Ticket]:
        return (list(self._queue)
                + [s.ticket for s in self._slots if s is not None])

    def _fail_pending(self, op: str, max_steps: int) -> RuntimeError:
        err = super()._fail_pending(op, max_steps)
        self._slots = [None] * self.n_slots  # in-flight caches released
        return err

    def stats(self) -> Dict[str, float]:
        """Base accounting plus live resident-cache bytes: what the
        in-flight slots hold right now under the serving plan, next to
        what the same occupancy would hold with a bf16 cache."""
        st = super().stats()
        st["cache_bytes_per_slot"] = float(self.cache_bytes_per_slot)
        st["resident_cache_bytes"] = float(
            self.cache_bytes_per_slot * self.active)
        st["resident_cache_fp_bytes"] = float(
            self.cache_fp_bytes_per_slot * self.active)
        st["kv_cache_compression"] = (
            self.cache_fp_bytes_per_slot / self.cache_bytes_per_slot
            if self.cache_bytes_per_slot else 1.0)
        if self._speculative:
            st["accept_rate"] = float(self.gen.accept_rate)
            st["drafted_tokens"] = float(self.gen.drafted_tokens)
            st["accepted_tokens"] = float(self.gen.accepted_tokens)
        return st

    def run_until_idle(self, max_steps: int = 100_000) -> int:
        """Serve until queue and slots are empty (flushing the admission
        window: a drive loop with no new traffic must terminate).

        Non-convergence FAILS the pending tickets (queued and in-flight,
        whose caches are released) instead of stranding them; the raised
        error lists their ids and ages."""
        n = 0
        for _ in range(max_steps):
            if not self._queue and self.active == 0:
                return n
            n += self.step(flush=True)
        raise self._fail_pending("run_until_idle", max_steps)
