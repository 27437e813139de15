"""The port's telemetry against the JAX package's.

The same operations go through both packages' tracers and metrics
registries under the same fake clock: the Chrome trace export, the
Prometheus text and its parse must be equal, and each package's
validators must judge the same inputs alike.  The serving objects' spans
(``ImageServer``'s ``predict``, ``Generator``'s ``prefill`` / ``decode``)
carry the JAX package's names, and their exports pass its validators.
"""
import json
from pathlib import Path

import pytest

torch = pytest.importorskip("torch")

import numpy as np  # noqa: E402

from repro.runtime import telemetry as jtele  # noqa: E402
from repro_torch import configs  # noqa: E402
from repro_torch.core.plan import PrecisionPlan  # noqa: E402
from repro_torch.runtime import telemetry as tele  # noqa: E402
from repro_torch.runtime.serve import (Generator, ImageServer,  # noqa: E402
                                       init_packed_views)

PLANS = Path(__file__).resolve().parents[1] / "examples" / "plans"


class FakeClock:
    def __init__(self):
        self.t = 10.0

    def __call__(self):
        self.t += 0.25
        return self.t


def _record(mod):
    """One scripted session through a package's telemetry -> (tracer,
    registry)."""
    tr = mod.Tracer(clock=FakeClock(), capacity=8)
    reg = mod.declare_golden(mod.MetricsRegistry())
    with tr.span("outer", cat="sched", tid=3, args={"n": 2}):
        tr.instant("submit", cat="request", tid=1, args={"tenant": "a"})
    tr.span_at("prefill", 1.0, 1.5, cat="device",
               args={"dispatch_s": 0.1, "device_s": 0.4})
    tr.instant_at("fault", 1.2, cat="fault")
    for i in range(8):  # overflow the ring: 4 of the oldest drop
        tr.span_at("decode", 2.0 + i, 2.5 + i, cat="device",
                   args={"dispatch_s": 0.2, "device_s": 0.3})
    reg.counter("repro_requests_submitted_total").inc()
    reg.counter("repro_requests_completed_total").inc(outcome="ok")
    reg.counter("repro_requests_completed_total").inc(2, outcome="late")
    reg.gauge("repro_queue_depth").set(3)
    reg.gauge("repro_specdec_accept_rate").set(0.375)
    h = reg.histogram("repro_request_latency_seconds")
    for v in (0.0005, 0.003, 0.07, 0.3, 12.0):
        h.observe(v)
    reg.histogram("repro_device_time_seconds").observe(0.02, phase="decode")
    reg.histogram("custom_seconds", "help text", buckets=(0.1, 1.0)).observe(
        0.5, phase="x")
    return tr, reg


def test_golden_set_matches_jax():
    assert tele.GOLDEN_METRICS == jtele.GOLDEN_METRICS
    assert tele._GOLDEN_KINDS == jtele._GOLDEN_KINDS
    assert tele.DEFAULT_BUCKETS == jtele.DEFAULT_BUCKETS


def test_exports_equal_jax():
    ttr, treg = _record(tele)
    jtr, jreg = _record(jtele)
    assert ttr.chrome_trace() == jtr.chrome_trace()
    assert ttr.dropped == jtr.dropped == 4
    assert treg.prometheus_text() == jreg.prometheus_text()
    assert treg.names() == jreg.names()
    text = treg.prometheus_text()
    assert tele.parse_prometheus_text(text) == \
        jtele.parse_prometheus_text(text)
    assert tele.device_time_split(ttr) == jtele.device_time_split(jtr)
    assert tele.device_time_split(ttr, since=3) == \
        jtele.device_time_split(jtr, since=3)
    assert jtele.validate_chrome_trace(ttr.chrome_trace()) == []
    assert jtele.validate_metrics_text(text, require_golden=True) == []


def test_export_writes_json(tmp_path):
    tr, _ = _record(tele)
    path = tmp_path / "trace.json"
    tr.export(path)
    assert json.loads(path.read_text()) == tr.chrome_trace()


_TRACES = [
    {},
    {"traceEvents": []},
    {"traceEvents": [{"ph": "X", "name": "a", "pid": 0, "tid": 0, "ts": 5.0,
                      "dur": -1.0}]},
    {"traceEvents": [{"ph": "i", "name": "a", "pid": 0, "tid": 0, "ts": 5.0},
                     {"ph": "i", "name": "b", "pid": 0, "tid": 0,
                      "ts": 4.0}]},
    {"traceEvents": [{"ph": "Q", "name": "a", "pid": 0, "tid": 0}]},
    {"traceEvents": [{"ph": "X", "pid": 0, "tid": 0, "ts": "x"}]},
]
_TEXTS = [
    "# TYPE a counter\na 1\n",
    "a 1\n",
    "# TYPE h histogram\nh_bucket{le=\"1\"} 1\nh_count 1\n",
    "# TYPE g gauge\ng{x=\"1\"} 0.5\n\n# HELP g help\n",
    "# TYPE a counter\nnovalue\n",
]


@pytest.mark.parametrize("i", range(len(_TRACES)))
def test_trace_validator_agrees_with_jax(i):
    assert tele.validate_chrome_trace(_TRACES[i]) == \
        jtele.validate_chrome_trace(_TRACES[i])


@pytest.mark.parametrize("golden", [False, True])
@pytest.mark.parametrize("i", range(len(_TEXTS)))
def test_metrics_validator_agrees_with_jax(i, golden):
    assert tele.validate_metrics_text(_TEXTS[i], golden) == \
        jtele.validate_metrics_text(_TEXTS[i], golden)


def test_registry_is_kind_checked_and_idempotent():
    reg = tele.MetricsRegistry()
    c = reg.counter("x_total")
    assert reg.counter("x_total") is c
    with pytest.raises(TypeError, match="already registered"):
        reg.gauge("x_total")


def test_null_objects_cost_nothing():
    assert tele.as_tracer(None) is tele.NULL_TRACER
    assert tele.as_metrics(None) is tele.NULL_METRICS
    fn = lambda x: x + 1  # noqa: E731
    assert tele.device_timed(tele.NULL_TRACER, "f", fn) is fn
    with tele.NULL_TRACER.span("s") as s:
        assert s is tele.NULL_TRACER.span("t")
    tele.NULL_TRACER.instant("i")
    tele.NULL_TRACER.span_at("x", 0.0, 1.0)
    assert len(tele.NULL_TRACER.events) == 0
    m = tele.NULL_METRICS
    m.counter("a").inc()
    m.histogram("b").observe(1.0)
    assert m.names() == [] and m.prometheus_text() == ""
    assert tele.declare_golden(m) is m


def test_device_timed_on_the_cpu():
    clock = FakeClock()
    tr = tele.Tracer(clock=clock)
    reg = tele.MetricsRegistry()
    hist = reg.histogram("repro_device_time_seconds")
    f = tele.device_timed(tr, "step", lambda a, b=0: a + b, hist,
                          device="cpu")
    assert f(2, b=3) == 5 and f.__wrapped__(1) == 1
    (ph, name, cat, _, ts, dur, args), = tr.events
    assert (ph, name, cat) == ("X", "step", "device")
    assert args == {"dispatch_s": 0.25, "device_s": 0.25}
    assert dur == 0.5 and hist.count(phase="step") == 1
    with tele.device_span(tr, "predict", "cpu", hist, {"bucket": 4}):
        pass
    assert tr.events[-1][6]["bucket"] == 4
    assert hist.count(phase="predict") == 1


def test_image_server_spans():
    api = configs.get("resnet18", reduced=True)
    from repro_torch.models import resnet as R
    gen = torch.Generator().manual_seed(0)
    packed = R.pack_for_serve(api.cfg, api.init_params(gen, device="cpu"),
                              R.init_bn_state(api.specs(), device="cpu"),
                              api.policy)
    tr, reg = tele.Tracer(), tele.MetricsRegistry()
    server = ImageServer(api=api, params=packed, batch_buckets=(2, 4),
                         device="cpu", tracer=tr, metrics=reg)
    x = np.zeros((5, 32, 32, 3), np.float32)
    quiet = ImageServer(api=api, params=packed, batch_buckets=(2, 4),
                        device="cpu")
    np.testing.assert_array_equal(server.predict(x), quiet.predict(x))
    spans = [e for e in tr.events if e[1] == "predict"]
    assert [e[6]["bucket"] for e in spans] == [4, 2]
    assert all({"dispatch_s", "device_s"} <= set(e[6]) for e in spans)
    assert reg.histogram("repro_device_time_seconds").count(
        phase="predict") == 2
    assert jtele.validate_chrome_trace(tr.chrome_trace()) == []


def test_generator_spans_and_bit_neutrality():
    plan = PrecisionPlan.load(PLANS / "granite_8b_mixed.json")
    api = configs.get("granite-8b", reduced=True, policy=plan)
    packed, = init_packed_views(api, [plan], torch.Generator().manual_seed(2),
                                device="cpu")
    tr, reg = tele.Tracer(), tele.MetricsRegistry()
    traced = Generator(api, packed, device="cpu", tracer=tr, metrics=reg)
    quiet = Generator(api, packed, device="cpu")
    prompts = np.arange(12).reshape(2, 6)
    toks, logits = traced.run(prompts, 4)
    toks_q, logits_q = quiet.run(prompts, 4)
    np.testing.assert_array_equal(toks, toks_q)
    assert all(torch.equal(a, b) for a, b in zip(logits, logits_q))
    assert [e[1] for e in tr.events] == ["prefill"] + ["decode"] * 3
    split = tele.device_time_split(tr)
    assert split["calls"] == 4 and set(split["phases"]) == {"prefill",
                                                            "decode"}
    assert jtele.validate_metrics_text(reg.prometheus_text()) == []
    assert reg.histogram("repro_device_time_seconds").count(
        phase="decode") == 3
    # the null tracer leaves the steps unwrapped
    assert traced._decode.__name__ == "timed"
    assert quiet._decode.__name__ == "decode_fn"
