"""The port's control plane against the JAX package's: ``runtime/slo``
(``TokenBucket``, ``DegradationController``, ``SLOScheduler``),
``runtime/faults`` (``FaultInjector``, ``SkewedClock``, ``FaultyServer``),
``runtime/frontier`` and ``telemetry.layer_attribution``, plus the
``ModelAPI`` workload methods.

Both packages are driven by the same script on the same fake clock and
fault seed over numpy stub backends (each level's serve advances the clock
by its cost), and must agree exactly: the level after every step, every
ticket's outcome, plan point, retries and result, ``stats()``, the
controller's transitions and the fault log.  Over a small packed ResNet
frontier (width 16, 32x32) the port's tickets equal their images served
alone at the ticket's level, bitwise, and each level's logits are within
the ResNet contract of ``test_torch_resnet_serve.py`` (5% of the largest
|logit|) of the JAX package's same plan point.  ``layer_attribution``
equals ``repro``'s on the TPU entry built from its fields.
"""
import dataclasses
from pathlib import Path
import math

import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402
import numpy as np  # noqa: E402

from repro import configs as jconfigs  # noqa: E402
from repro.core import plan as jplan  # noqa: E402
from repro.models import resnet as JR  # noqa: E402
from repro.nn import param as jparam  # noqa: E402
from repro.runtime import faults as jfaults  # noqa: E402
from repro.runtime import frontier as jfrontier  # noqa: E402
from repro.runtime import scheduler as jsched  # noqa: E402
from repro.runtime import slo as jslo  # noqa: E402
from repro.runtime import telemetry as jtele  # noqa: E402
from repro_torch import configs, convert  # noqa: E402
from repro_torch.core import plan as tplan  # noqa: E402
from repro_torch.models import resnet as R  # noqa: E402
from repro_torch.models.api import ModelAPI  # noqa: E402
from repro_torch.runtime import faults, frontier, scheduler, slo  # noqa
from repro_torch.runtime import telemetry as tele  # noqa: E402
from test_torch_roofline import tpu_hw  # noqa: E402

EX = Path(__file__).resolve().parents[1] / "examples"

PORT = dict(slo=slo, faults=faults, frontier=frontier, sched=scheduler)
REF = dict(slo=jslo, faults=jfaults, frontier=jfrontier, sched=jsched)
LOGIT_RTOL = 0.05


class FakeClock:
    def __init__(self):
        self.t = 0.0

    def __call__(self):
        return self.t

    def advance(self, dt):
        self.t += dt


class CostServer:
    """ImageServer-shaped stub: ``predict`` costs ``cost_s`` of fake time
    and scales its output, so levels are told apart."""

    def __init__(self, clk, cost_s, scale, buckets=(4,)):
        self.clk, self.cost_s, self.scale = clk, cost_s, scale
        self.batch_buckets = tuple(buckets)

    def predict(self, images):
        self.clk.advance(self.cost_s)
        return images.sum(axis=(1, 2, 3), keepdims=True) * self.scale


def _img(v, hw=2):
    return np.full((hw, hw, 3), float(v), np.float32)


# --- admission and the degradation state machine -----------------------------


def test_token_bucket_equals_reference():
    def drive(m):
        clk = FakeClock()
        b = m["slo"].TokenBucket(2.0, 3.0, clk)
        out = []
        for dt in (0.0, 0.0, 0.0, 0.0, 0.1, 0.4, 0.0, 2.0, -5.0, 0.0, 1.0):
            clk.advance(dt)
            out.append((b.try_take(), b.tokens, b.retry_after_s(2.0)))
        z = m["slo"].TokenBucket(0.0, 1.0, clk)
        out.append((z.try_take(), z.try_take(), z.retry_after_s()))
        return out
    assert drive(PORT) == drive(REF)


def test_controller_equals_reference():
    rng = np.random.default_rng(0)
    seq = list(rng.uniform(0, 1.2, 300)) + [0.9] * 5 + [0.1] * 20
    for cfg in ({}, {"high_water": 0.5, "low_water": 0.2, "up_after": 1,
                     "down_after": 2}):
        def drive(m):
            c = m["slo"].DegradationController(
                4, m["slo"].HysteresisConfig(**cfg))
            levels = [c.observe(p) for p in seq]
            return levels, list(c.transitions), c.n_transitions
        assert drive(PORT) == drive(REF)
    for bad in ({"low_water": 0.8}, {"up_after": 0}):
        with pytest.raises(ValueError):
            slo.HysteresisConfig(**bad)
    with pytest.raises(ValueError, match="rate"):
        slo.TenantConfig(rate=-1.0)


def test_fault_injector_equals_reference():
    spec = dict(step_error_rate=0.3, latency_spike_rate=0.2,
                latency_spike_s=0.5, clock_skew_rate=0.1, clock_skew_s=2.0,
                malformed_rate=0.25)

    def drive(m):
        clk = FakeClock()
        inj = m["faults"].FaultInjector(m["faults"].FaultSpec(**spec), 42)
        sk = inj.wrap_clock(clk)
        out = []
        for i in range(200):
            try:
                inj.before_serve(advance=clk.advance)
                out.append("ok")
            except m["faults"].TransientStepError as e:
                out.append(str(e))
            out.append(sk())
            p, bad = inj.maybe_malform(_img(i))
            out.append((bad, np.asarray(p, dtype=object).shape))
            q, bad2 = inj.maybe_malform((np.arange(3), 2))
            out.append((bad2, repr(type(q))))
        return out, list(inj.log), dict(inj.counts), clk.t
    assert drive(PORT) == drive(REF)
    with pytest.raises(ValueError, match="probability"):
        faults.FaultSpec(step_error_rate=1.5)


# --- the scheduler over stub backends ----------------------------------------


def _drive_scheduler(m, *, fault_seed=None, tenants=False):
    """One script: a burst that forces degradation, a trickle that lets the
    controller recover, tenant throttles and (optionally) injected faults.
    Returns everything observable."""
    clk = FakeClock()
    fr = m["frontier"].FrontierServer(
        [(f"p{i}", m["frontier"].ImageBackend(CostServer(clk, c, i + 1.0)))
         for i, c in enumerate((1.0, 0.25, 0.05))])
    inj = None
    if fault_seed is not None:
        inj = m["faults"].FaultInjector(m["faults"].FaultSpec(
            step_error_rate=0.2, latency_spike_rate=0.15,
            latency_spike_s=0.3, clock_skew_rate=0.05, clock_skew_s=0.2,
            malformed_rate=0.15), fault_seed)
        fr = inj.wrap_frontier(fr, advance=clk.advance)
        clock = inj.wrap_clock(clk)
    else:
        clock = clk
    kw = {}
    if tenants:
        kw = dict(tenants={"a": m["slo"].TenantConfig(rate=2.0, burst=4)},
                  default_tenant=m["slo"].TenantConfig(rate=1.0, burst=2))
    s = m["slo"].SLOScheduler(
        fr, slo_s=3.0, clock=clock, est_serve_s=[1.0, 0.25, 0.05],
        hysteresis=m["slo"].HysteresisConfig(up_after=1, down_after=3),
        max_queue=64, max_retries=2, backoff_s=0.05, **kw)
    tickets, levels, refused = [], [], []
    for i in range(40):
        payload = _img(i % 7)
        if inj is not None:
            payload, _ = inj.maybe_malform(payload)
        try:
            tickets.append(s.submit(payload, tenant="ab"[i % 2]
                                    if tenants else "default"))
        except ValueError as e:
            refused.append(("bad", str(e)))
        except m["sched"].QueueFull as e:
            refused.append((e.reason, e.depth, e.retry_after_s))
        if i % 20 == 19:
            s.step()
            levels.append(s.level)
    for _ in range(400):
        if not s.pending:
            break
        s.step()
        levels.append(s.level)
        clk.advance(0.01)
    for i in range(12):  # a trickle: low pressure, back towards level 0
        clk.advance(0.5)
        try:
            tickets.append(s.submit(_img(i)))
        except (ValueError, m["sched"].QueueFull) as e:
            refused.append(str(e))
        s.drain()
        levels.append(s.level)
    st = s.stats()
    rows = [(t.id, t.outcome, t.plan_point, t.retries, t.deadline,
             None if t.result is None else np.asarray(t.result).tolist())
            for t in tickets]
    return dict(levels=levels, tickets=rows, stats=st, refused=refused,
                transitions=list(s.controller.transitions),
                faults=None if inj is None else (list(inj.log),
                                                 dict(inj.counts)),
                events=[(e[1], e[2]) for e in s.events])


@pytest.mark.parametrize("fault_seed,tenants", [(None, False), (7, False),
                                                (101, True)])
def test_scheduler_equals_reference(fault_seed, tenants):
    mine = _drive_scheduler(PORT, fault_seed=fault_seed, tenants=tenants)
    ref = _drive_scheduler(REF, fault_seed=fault_seed, tenants=tenants)
    for key in ref:
        assert mine[key] == ref[key], key
    assert max(mine["levels"]) > 0, "the burst never forced degradation"
    assert mine["levels"][-1] < max(mine["levels"]), "never recovered"
    terminal = [t[1] for t in mine["tickets"]]
    assert all(o in ("ok", "late", "degraded", "expired", "failed")
               for o in terminal), terminal


def test_scheduler_checks_like_reference():
    clk = FakeClock()
    fr = frontier.FrontierServer([("p", frontier.ImageBackend(
        CostServer(clk, 1.0, 1.0)))])
    two = frontier.FrontierServer([(f"p{i}", frontier.ImageBackend(
        CostServer(clk, 1.0, 1.0))) for i in range(2)])
    with pytest.raises(ValueError, match="2 entries"):
        slo.SLOScheduler(two, est_serve_s=[1.0, 2.0, 3.0], clock=clk)
    with pytest.raises(ValueError, match="share one payload kind"):
        frontier.FrontierServer([("a", frontier.ImageBackend(
            CostServer(clk, 1.0, 1.0))), ("b", frontier.GenerateBackend(
                object()))])
    with pytest.raises(TypeError, match="cannot wrap"):
        frontier.as_server(object())
    with pytest.raises(IndexError):
        fr.serve([_img(0)], level=3)
    gb = frontier.GenerateBackend(object(), max_len=8)
    for bad in ((np.arange(3.0), 2), (np.arange(3), 0), (np.arange(9), 1),
                "tokens"):
        with pytest.raises(ValueError):
            gb.validate(bad)


# --- a real packed frontier --------------------------------------------------


@pytest.fixture(scope="module")
def resnet_frontier():
    """The same small ResNet, three plan points, in both packages."""
    kw = dict(name="tiny", depth=18, n_classes=10, img_size=32, width=16,
              stages_override=(1, 1))
    jcfg, cfg = JR.ResNetConfig(**kw), R.ResNetConfig(**kw)
    plans = [{"name": "w8", "default": {"w_bits": 8, "k": 4}},
             {"name": "mixed", "default": {"w_bits": 4, "k": 4},
              "layers": {"s0b0c1": {"w_bits": 2, "k": 2},
                         "s1b0p": {"w_bits": 8, "k": 4}}},
             {"name": "w2", "default": {"w_bits": 2, "k": 2}}]
    jplans = [(p["name"], jplan.PrecisionPlan.from_json(p)) for p in plans]
    tplans = [(p["name"], tplan.PrecisionPlan.from_json(p)) for p in plans]
    jparams = jparam.init_params(JR.specs(jcfg), jax.random.PRNGKey(2))
    rng = np.random.default_rng(2)
    jstate = JR.init_bn_state(JR.specs(jcfg))
    params, state = convert.from_jax_train_params(
        jax.tree.map(np.array, jparams), jax.tree.map(np.array, jstate),
        device="cpu")
    api = ModelAPI(name="tiny", family="cnn", cfg=cfg, mod=R,
                   policy=tplans[0][1])
    fr = frontier.build_frontier(api, params, tplans, state=state,
                                 batch_buckets=(1, 4), device="cpu")
    images = [rng.normal(0.4, 0.5, (32, 32, 3)).astype(np.float32)
              for _ in range(10)]
    ref = {}
    for name, jp in jplans:
        packed = JR.pack_for_serve(jcfg, jparams, jstate, jp)
        ref[name] = np.asarray(jax.jit(lambda p, x, jp=jp: JR.serve_forward(
            jcfg, p, x, jp, impl="xla"))(packed, jnp.asarray(np.stack(
                images))).astype(jnp.float32))
    return fr, images, ref


def test_frontier_levels_match_reference(resnet_frontier):
    fr, images, ref = resnet_frontier
    assert fr.names == ("w8", "mixed", "w2") and fr.kind == "image"
    for lvl, name in enumerate(fr.names):
        got = np.stack(fr.serve([fr.validate(im) for im in images],
                                level=lvl))
        err = float(np.abs(got - ref[name]).max())
        assert err <= LOGIT_RTOL * float(np.abs(ref[name]).max()), (name,
                                                                     err)


def test_slo_tickets_equal_their_point_alone(resnet_frontier):
    """A burst degrades, faults are injected (seeded); every served ticket
    equals its image served alone at the ticket's level, bitwise."""
    fr, images, _ = resnet_frontier
    clk = FakeClock()
    inj = faults.FaultInjector(faults.FaultSpec(
        step_error_rate=0.25, latency_spike_rate=0.2, latency_spike_s=0.5,
        malformed_rate=0.2), 5)
    faulty = inj.wrap_frontier(fr, advance=clk.advance)
    s = slo.SLOScheduler(faulty, slo_s=2.0, clock=clk,
                         est_serve_s=[1.0, 0.3, 0.1], max_retries=4,
                         hysteresis=slo.HysteresisConfig(up_after=1,
                                                         down_after=2))
    tickets, bad = [], 0
    for im in images * 2:
        p, malformed = inj.maybe_malform(im)
        try:
            tickets.append((im, s.submit(p)))
        except ValueError:
            bad += 1
            assert malformed
    s.drain()
    for _ in range(6):
        clk.advance(1.0)
        tickets.append((images[0], s.submit(images[0])))
        s.drain()
    assert bad > 0 and inj.counts["step_error"] > 0
    assert s.stats()["transitions"] >= 2 and s.level == 0
    assert all(t.done for _, t in tickets)
    served = [(im, t) for im, t in tickets if t.plan_point is not None]
    assert {t.plan_point for _, t in served} > {"w8"}
    for im, t in served:
        lvl = fr.level_of(t.plan_point)
        alone = fr.restricted(lvl).serve([im], level=0)[0]
        np.testing.assert_array_equal(t.result, alone)


def test_frontier_from_manifest_checks_arch_and_layers(tmp_path):
    api = configs.get("resnet18", reduced=True)
    m = tplan.FrontierManifest.load(
        EX / "frontiers" / "resnet18_frontier.json")
    with pytest.raises(ValueError, match="manifest targets"):
        frontier.frontier_from_manifest(configs.get("granite-8b"), None, m,
                                        device="cpu")
    bad = dataclasses.replace(m, points=(dataclasses.replace(
        m.points[0], plan=dataclasses.replace(
            m.points[0].plan, layers=(("s9b9c9", tplan.LayerPlan()),))),))
    with pytest.raises(ValueError, match="s9b9c9"):
        frontier.frontier_from_manifest(api, None, bad, device="cpu")


def test_lm_frontier_draws_weights_once():
    """Two granite points drawn once through ``init_packed_views``: each
    level equals a Generator over the same view served alone."""
    from repro_torch.runtime.serve import Generator, init_packed_views
    api = configs.get("granite-8b", reduced=True)
    plans = [(p.name, p) for p in (
        tplan.PrecisionPlan.load(EX / "plans" / "granite_8b_mixed.json"),
        tplan.PrecisionPlan.load(EX / "plans" / "granite_8b_draft_w2.json"))]
    fr = frontier.build_frontier(api, None, plans, max_len=24, device="cpu",
                                 generator=torch.Generator().manual_seed(3))
    views = init_packed_views(api, [p for _, p in plans],
                              torch.Generator().manual_seed(3), device="cpu")
    rng = np.random.default_rng(3)
    reqs = [(rng.integers(0, api.cfg.vocab, n).astype(np.int32), k)
            for n, k in ((6, 3), (6, 3), (9, 2))]
    for lvl, ((_, plan), view) in enumerate(zip(plans, views)):
        got = fr.serve([fr.validate(r) for r in reqs], level=lvl)
        gen = Generator(api=dataclasses.replace(api, policy=plan),
                        params=view, device="cpu")
        for (toks, n_new), g in zip(reqs, got):
            np.testing.assert_array_equal(g, gen.generate(toks[None],
                                                          n_new)[0])


# --- roofline attribution and the workload methods ---------------------------


@pytest.mark.parametrize("arch,batch", [("resnet18", 8), ("resnet50", 1),
                                        ("granite-8b", 4096)])
def test_layer_attribution_equals_reference(arch, batch):
    gemms = configs.get(arch).gemm_workload(batch)
    jgemms = jconfigs.get(arch).gemm_workload(batch)
    pols = [(tplan.PrecisionPlan.from_json({"name": "u"}),
             jplan.PrecisionPlan.from_json({"name": "u"}))]
    for p in ("resnet18_mixed.json", "granite_8b_mixed.json"):
        jp = jplan.PrecisionPlan.load(EX / "plans" / p)
        if jp.arch == arch:
            pols.append((tplan.PrecisionPlan.load(EX / "plans" / p), jp))
    from repro.core.precision import PrecisionPolicy as JPolicy
    from repro_torch.core.precision import PrecisionPolicy
    pols.append((PrecisionPolicy(quantize=False), JPolicy(quantize=False)))
    for mine, ref in pols:
        for measured in (3.1e-3, 0.0):
            assert tele.layer_attribution(
                gemms, mine, measured, hw=tpu_hw(), batch_note="b") == \
                jtele.layer_attribution(jgemms, ref, measured,
                                        batch_note="b")


def test_layer_attribution_defaults_to_the_h100():
    gemms = configs.get("resnet18").gemm_workload(8)
    rep = tele.layer_attribution(gemms, tplan.PrecisionPlan.load(
        EX / "plans" / "resnet18_mixed.json"), 1e-3)
    assert rep["peak_int8_tops"] == 1979.0
    assert 0 < rep["roofline_fraction"] < 1
    assert math.isclose(rep["achieved_tops"], 2 * sum(
        g.macs for g in gemms) / 1e-3 / 1e12)


@pytest.mark.parametrize("arch", configs.ARCH_NAMES)
def test_workload_methods_equal_reference(arch):
    api, japi = configs.get(arch), jconfigs.get(arch)
    assert api.total_params() == japi.total_params()
    assert api.active_params() == japi.active_params()
    for tokens, step in ((1, "train"), (8, "prefill"), (4096, "decode")):
        assert api.model_flops(tokens=tokens, step=step) == \
            japi.model_flops(tokens=tokens, step=step)
    assert api.param_class_counts() == japi.param_class_counts()
    assert [dataclasses.astuple(g) for g in api.gemm_workload(8)] == \
        [dataclasses.astuple(g) for g in japi.gemm_workload(8)]
    if api.family == "cnn":
        assert R.inner_layer_names(api.cfg) == JR.inner_layer_names(
            japi.cfg)
        assert R.param_counts(api.cfg) == JR.param_counts(japi.cfg)
        for b in (1, 8):
            assert R.model_flops(api.cfg, batch=b, step="serve") == \
                JR.model_flops(japi.cfg, batch=b, step="serve")


def test_layer_weights_equal_reference():
    cfg = R.ResNetConfig(name="tiny", depth=50, n_classes=10, img_size=32,
                         width=16, stages_override=(1, 1))
    jcfg = JR.ResNetConfig(**dataclasses.asdict(cfg))
    jparams = jparam.init_params(JR.specs(jcfg), jax.random.PRNGKey(0))
    jstate = JR.init_bn_state(JR.specs(jcfg))
    params, _ = convert.from_jax_train_params(
        jax.tree.map(np.array, jparams), jax.tree.map(np.array, jstate),
        device="cpu")
    mine, ref = R.layer_weights(cfg, params), JR.layer_weights(jcfg, jparams)
    assert list(mine) == list(ref)
    assert sorted(mine) == sorted(R.plan_layer_names(cfg))
    for n in ref:
        np.testing.assert_array_equal(mine[n].numpy(), np.asarray(ref[n]))
