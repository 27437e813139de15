"""The port's continuous-batching schedulers against the JAX package's.

The same request trace goes through both packages' schedulers under the
same fake clock: ``ImageScheduler`` over reduced ResNet-18's
``ImageServer`` (buckets 1/2/4/8), ``GenerateScheduler`` over reduced
granite-8b's ``Generator`` (cut to one layer, packed KV cache, 4 slots,
two prompt lengths, three ``n_new``) and over a ``SpeculativeGenerator``.
Weights are drawn on the JAX side and carried across by ``convert``.

Contract: the admission order (the scheduler's event log and dispatched
batches) and ``stats()`` -- keys and, under the fake clock, values -- equal
the JAX package's; per ticket, the LM's tokens equal the JAX package's
(run op by op, as ``test_torch_lm_serve.py`` explains) and the CNN's logits
are within the ResNet contract of the JAX package's (5% of the largest
|logit|: the mean pool's f32 sum order differs between the frameworks);
inside the port every ticket's result equals the same request served
alone, bitwise.
"""
import dataclasses
from pathlib import Path

import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import numpy as np  # noqa: E402

from repro import configs as jconfigs  # noqa: E402
from repro.core import plan as jplan  # noqa: E402
from repro.runtime import scheduler as jsched  # noqa: E402
from repro.runtime import serve as jserve  # noqa: E402
from repro.runtime import telemetry as jtele  # noqa: E402
from repro_torch import configs, convert  # noqa: E402
from repro_torch.core import plan as tplan  # noqa: E402
from repro_torch.runtime import scheduler as sched  # noqa: E402
from repro_torch.runtime import telemetry as tele  # noqa: E402
from repro_torch.runtime.serve import (Generator, ImageServer,  # noqa: E402
                                       pack_for_serving)
from repro_torch.runtime.specdec import SpeculativeGenerator  # noqa: E402

PLANS = Path(__file__).resolve().parents[1] / "examples" / "plans"
BUCKETS = (1, 2, 4, 8)
LOGIT_RTOL = 0.05
# (prompt length, n_new) of six LM requests: two lengths, three n_new
LM_TRACE = [(5, 3), (5, 4), (3, 2), (5, 4), (3, 3), (3, 2)]
MAX_LEN = 9


class FakeClock:
    def __init__(self):
        self.t = 0.0

    def __call__(self):
        return self.t


def _np_tree(tree):
    return jax.tree.map(lambda a: np.array(a), tree)


def _events(s):
    return [tuple(e) for e in s.events]


def _drive(scheduler, submit, trace, clock, dt=0.002):
    """Submit ``trace`` one request a tick, stepping the scheduler between
    submissions, then run it dry; -> the tickets in submit order."""
    tickets = []
    for item in trace:
        tickets.append(submit(scheduler, item))
        clock.t += dt
        scheduler.step()
        clock.t += dt
    return tickets


# --- ImageScheduler -----------------------------------------------------------


@pytest.fixture(scope="module")
def resnet():
    jplan_ = jplan.PrecisionPlan.load(PLANS / "resnet18_mixed.json")
    japi = jconfigs.get("resnet18", reduced=True, policy=jplan_)
    jparams = japi.init_params(jax.random.PRNGKey(0), "train")
    jstate = japi.mod.init_bn_state(japi.mod.specs(japi.cfg))
    jpacked = jax.jit(lambda p, s: japi.mod.pack_for_serve(
        japi.cfg, p, s, jplan_))(jparams, jstate)
    tplan_ = tplan.PrecisionPlan.from_json(jplan_.to_json())
    tapi = configs.get("resnet18", reduced=True, policy=tplan_)
    packed = convert.from_jax_serve_tree(_np_tree(jpacked), device="cpu")
    jserver = jserve.ImageServer(api=japi, params=jpacked, plan=jplan_,
                                 batch_buckets=BUCKETS)
    server = ImageServer(api=tapi, params=packed, plan=tplan_,
                         batch_buckets=BUCKETS, device="cpu")
    images = np.random.default_rng(3).normal(
        0, 1, (13, 32, 32, 3)).astype(np.float32)
    return jserver, server, images


def _image_run(mod, server, images, **kw):
    clock = FakeClock()
    s = mod.ImageScheduler(server, max_wait_s=0.005, clock=clock, **kw)
    tickets = _drive(s, lambda sc, im: sc.submit(im), images, clock)
    s.drain()
    return s, tickets


def test_image_scheduler_matches_jax(resnet):
    jserver, server, images = resnet
    js, jt = _image_run(jsched, jserver, images)
    ts, tt = _image_run(sched, server, images)
    assert _events(ts) == _events(js)
    assert list(ts.dispatched_batches) == list(js.dispatched_batches)
    assert ts.stats() == js.stats()
    assert all(t.done and t.outcome == "ok" for t in tt)
    for got, want in zip(tt, jt):
        w = np.asarray(want.result, np.float32)
        np.testing.assert_allclose(got.result, w, rtol=0,
                                   atol=LOGIT_RTOL * np.abs(w).max())
    # batch entries never mix: each ticket is its image served alone
    for t, im in zip(tt, images):
        np.testing.assert_array_equal(t.result, server.predict(im[None])[0])


def test_image_scheduler_backpressure_and_shape_check(resnet):
    _, server, images = resnet
    clock = FakeClock()
    s = sched.ImageScheduler(server, max_queue=2, clock=clock)
    s.submit(images[0])
    s.submit(images[1])
    with pytest.raises(sched.QueueFull) as err:
        s.submit(images[2])
    assert err.value.depth == 2 and err.value.reason == "queue"
    assert s.stats()["rejected"] == 1.0
    with pytest.raises(ValueError, match="shape"):
        s.submit(images[0][:16])
    assert s.drain() == 2 and s.pending == 0


# --- GenerateScheduler --------------------------------------------------------


@pytest.fixture(scope="module")
def granite():
    jvp = jplan.PrecisionPlan.load(PLANS / "granite_8b_mixed.json")
    jdp = jplan.PrecisionPlan.load(PLANS / "granite_8b_draft_w2.json")
    japi = jconfigs.get("granite-8b", reduced=True, policy=jvp)
    japi = dataclasses.replace(
        japi, cfg=dataclasses.replace(japi.cfg, n_layers=1))
    jtrain = japi.init_params(jax.random.PRNGKey(1), "train")
    jpacked = jax.jit(lambda t: jserve.pack_for_serving(japi, t))(jtrain)
    tvp = tplan.PrecisionPlan.from_json(jvp.to_json())
    tdp = tplan.PrecisionPlan.from_json(jdp.to_json())
    tapi = configs.get("granite-8b", reduced=True, policy=tvp)
    tapi = dataclasses.replace(
        tapi, cfg=dataclasses.replace(tapi.cfg, n_layers=1))
    ttrain = convert.from_jax_lm_train_params(_np_tree(jtrain), device="cpu")
    rng = np.random.default_rng(4)
    trace = [(rng.integers(0, japi.cfg.vocab, plen).astype(np.int32), n)
             for plen, n in LM_TRACE]
    return japi, jpacked, tapi, ttrain, tvp, tdp, trace


def _lm_run(mod, gen, trace, **kw):
    clock = FakeClock()
    s = mod.GenerateScheduler(gen, slots=4, max_len=MAX_LEN, clock=clock,
                              **kw)
    tickets = _drive(s, lambda sc, req: sc.submit(*req), trace, clock)
    s.run_until_idle()
    return s, tickets


def test_generate_scheduler_matches_jax(granite):
    japi, jpacked, tapi, ttrain, _, _, trace = granite
    jgen = jserve.Generator(japi, jpacked, max_len=MAX_LEN)
    with jax.disable_jit():
        js, jt = _lm_run(jsched, jgen, trace)
    gen = Generator(tapi, pack_for_serving(tapi, ttrain), device="cpu")
    ts, tt = _lm_run(sched, gen, trace)
    assert _events(ts) == _events(js)
    assert ts.stats() == js.stats()
    for got, want in zip(tt, jt):
        assert got.outcome == want.outcome == "ok"
        np.testing.assert_array_equal(got.result, np.asarray(want.result))
    # every ticket is its request served alone
    for t, (prompt, n) in zip(tt, trace):
        np.testing.assert_array_equal(
            t.result, gen.generate(prompt[None], n)[0])


def test_speculative_scheduler_matches_plain(granite):
    """Over a SpeculativeGenerator the tickets carry the same tokens as
    over the verify plan's Generator (served alone too); the cycle
    accounting lands in stats()."""
    _, _, tapi, ttrain, _, tdp, trace = granite
    gen = Generator(tapi, pack_for_serving(tapi, ttrain), device="cpu")
    views = (pack_for_serving(tapi, ttrain),
             pack_for_serving(dataclasses.replace(tapi, policy=tdp), ttrain))
    sg = SpeculativeGenerator(api=tapi, packed_views=views, draft_plan=tdp,
                              k=3, device="cpu")
    ss, st = _lm_run(sched, sg, trace)
    for t, (prompt, n) in zip(st, trace):
        assert t.outcome == "ok"
        np.testing.assert_array_equal(
            t.result, gen.generate(prompt[None], n)[0])
    stats = ss.stats()
    assert stats["drafted_tokens"] == sg.drafted_tokens > 0
    assert stats["accepted_tokens"] == sg.accepted_tokens
    assert stats["accept_rate"] == sg.accept_rate
    assert stats["served"] == len(trace)


def test_stats_keys_match_jax(granite, resnet):
    _, _, tapi, ttrain, _, _, _ = granite
    jkeys = set(jsched._SchedulerBase(max_queue=1, max_wait_s=0.0,
                                      clock=FakeClock()).stats())
    gen = Generator(tapi, pack_for_serving(tapi, ttrain), device="cpu")
    assert set(sched.GenerateScheduler(gen).stats()) == jkeys
    assert set(sched.ImageScheduler(resnet[1]).stats()) == jkeys


def test_generate_scheduler_rejects_and_fails_loudly(granite):
    _, _, tapi, ttrain, _, _, trace = granite
    gen = Generator(tapi, pack_for_serving(tapi, ttrain), device="cpu")
    s = sched.GenerateScheduler(gen, slots=2, max_len=MAX_LEN,
                                clock=FakeClock())
    with pytest.raises(ValueError, match="max_len"):
        s.submit(trace[0][0], MAX_LEN)
    with pytest.raises(ValueError, match="n_new"):
        s.submit(trace[0][0], 0)
    tickets = [s.submit(*req) for req in trace[:3]]
    with pytest.raises(RuntimeError, match="did not converge"):
        s.run_until_idle(max_steps=1)
    assert all(t.done and t.outcome == "failed" for t in tickets)
    assert s.active == 0 and s.pending == 0


def test_scheduler_telemetry_passes_the_jax_validators(granite):
    _, _, tapi, ttrain, _, _, trace = granite
    clock = FakeClock()
    tracer, metrics = tele.Tracer(clock=clock), tele.MetricsRegistry()
    gen = Generator(tapi, pack_for_serving(tapi, ttrain), device="cpu",
                    tracer=tracer, metrics=metrics)
    s = sched.GenerateScheduler(gen, slots=4, max_len=MAX_LEN, clock=clock,
                                tracer=tracer, metrics=metrics)
    _drive(s, lambda sc, req: sc.submit(*req), trace, clock)
    s.run_until_idle()
    assert jtele.validate_chrome_trace(tracer.chrome_trace()) == []
    text = metrics.prometheus_text()
    assert jtele.validate_metrics_text(text, require_golden=True) == []
    names = {e[1] for e in tracer.events}
    assert {"submit", "prefill", "decode", "request", "queue",
            "serve"} <= names
    assert metrics.counter("repro_requests_completed_total").value(
        outcome="ok") == len(trace)
