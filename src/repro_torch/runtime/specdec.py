"""Speculative decoding from one checkpoint: a low-bit draft, a mixed
verify (port of ``repro.runtime.specdec``).

A uniform low-bit repack of the same float checkpoint (e.g.
``examples/plans/granite_8b_draft_w2.json``, w2 weights and a kv2 cache)
drafts k greedy tokens on its own packed KV cache, and the shipped mixed
plan verifies all k + 1 positions in one batched forward
(``models.transformer.decode_steps``).  The longest prefix of draft tokens
that matches the verify argmax is accepted; both caches roll back the
rejected positions, and decoding goes on from the verify model's
correction token.

The output equals verify-plan-only greedy decoding token for token:
accepted tokens are, by the acceptance rule, the verify argmaxes, so every
emitted token is a verify row, and the batched verify rows equal
sequential single-token decode (exact int32 accumulation, per-row norms,
rotary and activation quantization, per-query attention in which masked
rows add an exact f32 zero).  The draft decides which positions a cycle
verifies (speed), never the emitted values.

Rollback is logical truncation: every cache write lands at the logical
length and every attention mask is ``pos < length``, so rejected positions
are never attended and the next cycle overwrites them in place (the
port's decode updates its cache in place).

With ``mesh=`` the batch is padded to a multiple of the 'data' size, each
data coordinate drafts and verifies its own rows, and the verify argmaxes
and drafts are all-gathered so every rank takes the same acceptance
decisions.  Both views are replicated on a (D, 1) mesh; on a 'model' axis
above 1 each view is cut to the rank's slice and both generators run
tensor-parallel (``runtime.serve.Generator``).  The draft's k + 1 steps run as a Python loop
of single-token decode steps where ``repro`` fuses them in one
``lax.scan``.
"""
from __future__ import annotations

import dataclasses
from typing import Any, Optional, Sequence

import numpy as np
import torch

from repro_torch.launch import steps as steps_lib
from repro_torch.runtime.serve import Generator, _pad_batch
from repro_torch.runtime.telemetry import as_metrics, as_tracer, device_timed

__all__ = ["SpeculativeGenerator"]


def _leading_matches(drafts: np.ndarray, targets: np.ndarray) -> np.ndarray:
    """Per-row count of leading positions where drafts == targets."""
    if drafts.shape[1] == 0:
        return np.zeros(drafts.shape[0], np.int64)
    miss = drafts != targets
    any_miss = miss.any(axis=1)
    first = miss.argmax(axis=1)
    return np.where(any_miss, first, drafts.shape[1])


@dataclasses.dataclass
class SpeculativeGenerator:
    """Two packed views of one float checkpoint: draft k, verify k + 1.

    ``packed_views`` is ``(verify, draft)``: the checkpoint packed under
    ``api.policy``, the verify plan, and under ``draft_plan``, each by
    ``pack_for_serving`` or, for a full-width model whose float tree does
    not fit the device at once, drawn and packed piece by piece
    (``serve.init_packed_views``).

    ``generate`` keeps ``Generator.generate``'s contract (greedy, batched)
    and emits exactly what a verify-plan-only ``Generator`` emits.
    ``impl``, ``device`` and ``mesh`` are the ``Generator``'s.

    Telemetry: one ``specdec.accept`` span per cycle (drafted / accepted /
    rejected counts), a ``specdec.rollback`` instant when positions are
    rejected, device spans ``specdec.draft`` and ``specdec.verify``, and
    the metrics ``repro_specdec_drafted_total``,
    ``repro_specdec_accepted_total`` and ``repro_specdec_accept_rate``.
    """

    api: Any
    packed_views: Any
    draft_plan: Any
    k: int = 4
    impl: str = "auto"
    device: Any = "cuda"
    tracer: Any = None
    metrics: Any = None
    mesh: Any = None

    is_speculative = True  # GenerateScheduler's dispatch gate

    def __post_init__(self):
        if self.k < 1:
            raise ValueError(f"spec-decode k must be >= 1, got {self.k}")
        self.tracer = as_tracer(self.tracer)
        self.metrics = as_metrics(self.metrics)
        api_v = self.api
        api_d = dataclasses.replace(self.api, policy=self.draft_plan)
        self.api_verify, self.api_draft = api_v, api_d
        packed_v, packed_d = self.packed_views
        self.packed_views = None  # the generators own them now
        kw = dict(impl=self.impl, device=self.device, tracer=self.tracer,
                  metrics=self.metrics, mesh=self.mesh)
        self.gen_verify = Generator(api_v, packed_v, **kw)
        self.gen_draft = Generator(api_d, packed_d, **kw)
        self.device = self.gen_verify.device
        self.rows = self.gen_verify.rows
        hist = self.metrics.histogram("repro_device_time_seconds")
        step = torch.inference_mode()
        self._verify = device_timed(
            self.tracer, "specdec.verify",
            step(steps_lib.make_verify_fn(api_v, impl=self.impl,
                                          mesh=self.mesh)),
            hist, self.device)
        # the draft's steps untimed inside the one specdec.draft span
        self._draft_decode = steps_lib.make_decode_fn(api_d, impl=self.impl,
                                                      mesh=self.mesh)
        self._draft = device_timed(self.tracer, "specdec.draft",
                                   step(self._draft_steps), hist,
                                   self.device)
        self._m_drafted = self.metrics.counter("repro_specdec_drafted_total")
        self._m_accepted = self.metrics.counter(
            "repro_specdec_accepted_total")
        self._m_rate = self.metrics.gauge("repro_specdec_accept_rate")
        self.drafted_tokens = 0
        self.accepted_tokens = 0

    # -- draft ---------------------------------------------------------------

    def _draft_steps(self, params, cache, tok: torch.Tensor, length: int,
                     n_steps: int):
        """Greedy draft: ``n_steps`` single-token decode steps.  Step i
        consumes tok_i, writes its K/V at ``length + i`` and emits tok_{i+1}
        by argmax, so the cache ends valid through ``length + n_steps``
        exclusive and the last proposal's K/V is already written, leaving
        no gap for a fully accepted next cycle.  -> (proposals (B,
        n_steps), cache)."""
        out = []
        for i in range(n_steps):
            logits, cache = self._draft_decode(params, cache, tok, length + i)
            tok = torch.argmax(logits, -1)[:, None]
            out.append(tok)
        return torch.cat(out, dim=1), cache

    # -- accounting ----------------------------------------------------------

    def _account(self, drafted: int, accepted: int, rejected: int,
                 t0: float, t1: float) -> None:
        self.drafted_tokens += drafted
        self.accepted_tokens += accepted
        self._m_drafted.inc(drafted)
        self._m_accepted.inc(accepted)
        if self.drafted_tokens:
            self._m_rate.set(self.accepted_tokens / self.drafted_tokens)
        tr = self.tracer
        if tr.enabled:
            tr.span_at("specdec.accept", t0, t1, cat="specdec",
                       args={"drafted": drafted, "accepted": accepted,
                             "rejected": rejected})
            if rejected:
                tr.instant("specdec.rollback", cat="specdec",
                           args={"rejected": rejected})

    @property
    def accept_rate(self) -> float:
        return (self.accepted_tokens / self.drafted_tokens
                if self.drafted_tokens else 0.0)

    # -- one cycle -----------------------------------------------------------

    def _cycle(self, cache_v, cache_d, tok: torch.Tensor, pos: int,
               k_eff: int, rows: np.ndarray):
        """Draft ``k_eff`` tokens after ``tok`` (B, 1) at ``pos`` and verify
        ``k_eff + 1`` positions -> (verify argmax rows (B, k_eff + 1) np,
        per-row accept counts (B,) np, caches); ``rows`` indexes the real
        rows, which the acceptance statistics count.  On a mesh ``tok`` and
        the returned rows are the whole batch's, the caches this rank's."""
        gv, gd = self.gen_verify, self.gen_draft
        tok = self.rows.local(tok)
        t0 = self.tracer.clock() if self.tracer.enabled else 0.0
        if k_eff > 0:
            # k_eff + 1 steps: k_eff proposals plus the last proposal's
            # own K/V write (no cache gap on a full accept)
            props, cache_d = self._draft(gd.params, cache_d, tok, pos,
                                         k_eff + 1)
            props = props[:, :k_eff]
            vin = torch.cat([tok, props], dim=1)
        else:
            props = tok[:, :0]
            vin = tok
        logits, cache_v = self._verify(gv.params, cache_v, vin, pos)
        v_toks = self.rows.gather(torch.argmax(logits, -1)).cpu().numpy()
        a = _leading_matches(self.rows.gather(props).cpu().numpy(),
                             v_toks[:, :k_eff])  # (B, k_eff + 1), (B,)
        t1 = self.tracer.clock() if self.tracer.enabled else 0.0
        real = a[rows]
        self._account(drafted=k_eff * len(real), accepted=int(real.sum()),
                      rejected=int((k_eff - real).sum()), t0=t0, t1=t1)
        return v_toks, a, cache_v, cache_d

    # -- generate ------------------------------------------------------------

    def generate(self, tokens: np.ndarray, n_new: int) -> np.ndarray:
        """Greedy speculative generate: tokens (B, S) -> (B, n_new), equal
        to a verify-plan-only ``Generator.generate``."""
        gv, gd = self.gen_verify, self.gen_draft
        b, s = tokens.shape
        gb = self.rows.pad_to(b)  # an even split over the data axis
        toks = torch.as_tensor(_pad_batch(np.asarray(tokens), gb),
                               dtype=torch.long, device=self.device)
        logits_v, pre_v = gv._prefill(gv.params, {"tokens": toks})
        _, pre_d = gd._prefill(gd.params, {"tokens": toks})
        cache_v = gv._grow_cache(pre_v, gb, s, s + n_new)
        cache_d = gd._grow_cache(pre_d, gb, s, s + n_new)
        del pre_v, pre_d
        tok = torch.argmax(logits_v, -1).cpu().numpy()  # verify owns it
        out = [tok]
        pos = s  # tokens whose K/V both caches hold; `tok` sits at `pos`
        while len(out) < n_new:
            remaining = n_new - len(out)
            k_eff = min(self.k, remaining - 1)
            feed = torch.as_tensor(tok[:, None], dtype=torch.long,
                                   device=self.device)
            v_toks, a, cache_v, cache_d = self._cycle(cache_v, cache_d, feed,
                                                      pos, k_eff,
                                                      np.arange(b))
            e = min(int(a[:b].min()) + 1, remaining)
            # accepted drafts == verify argmaxes: every emission is a
            # verify row
            out.extend(v_toks[:, j] for j in range(e))
            tok = v_toks[:, e - 1]
            pos += e
        return np.stack(out, axis=1)[:b]

    # -- scheduler seams (GenerateScheduler drives these per slot group) ----

    def prefill_slots(self, toks: torch.Tensor):
        """(B, S) prompt block -> (first tokens (B,) np, the two points'
        prefill-sized caches ``{"verify", "draft"}``); the scheduler grows
        and extracts them per slot."""
        gv, gd = self.gen_verify, self.gen_draft
        logits_v, pre_v = gv._prefill(gv.params, {"tokens": toks})
        _, pre_d = gd._prefill(gd.params, {"tokens": toks})
        return (torch.argmax(logits_v, -1).cpu().numpy(),
                {"verify": pre_v, "draft": pre_d})

    def spec_cycle(self, caches, tok: torch.Tensor, pos: int, k_eff: int,
                   rows: Optional[Sequence[int]] = None):
        """One draft + verify cycle over a same-position slot group.

        caches: ``{"verify": ..., "draft": ...}`` batched over the group's
        slots (updated in place); tok (B, 1); pos = tokens resident in both
        caches; rows = the indices of the real (not padded) rows, which
        the acceptance statistics count (default: every row).  -> (verify
        argmax rows (B, k_eff + 1) np, per-row accept counts (B,) np,
        caches).  Rollback is the caller keeping
        its per-slot logical position at ``pos + accepted_i + 1``.
        """
        rows = np.arange(tok.shape[0]) if rows is None else np.asarray(rows)
        v_toks, a, cache_v, cache_d = self._cycle(
            caches["verify"], caches["draft"], tok, pos, k_eff, rows)
        return v_toks, a, {"verify": cache_v, "draft": cache_d}

