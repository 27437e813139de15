"""The port's planner (``repro_torch.core.planner``) against the JAX
package's.

Contracts:

* ``weight_ptq_sensitivity``: within a relative 1e-4 of the JAX package's
  (``init_step_size`` takes its mean in float64 in the port, in f32 in
  the reference: the step may differ by an f32 ulp, which moves the odd
  code at a rounding boundary).  ``kv_cache_sensitivity`` is numpy on
  both sides and equal.
* Given the SAME sensitivity table and the TPU entry built from
  ``repro``'s fields, the latency tables, ``plan_latency``,
  ``pareto_front``, ``greedy_bit_descent``, ``greedy_joint_descent``
  (granite-8b's KV workload) and ``plan_search`` give equal numbers and
  equal plan JSON.
* ``calibration_sensitivity`` equals the reference's for one
  deterministic numpy ``forward_fn`` (the algorithm, not the model: the
  port's forward is held by the ResNet contract of
  ``test_torch_resnet_serve.py``).
* ``plan_search``'s chosen plan (H100 latencies) packs and serves through
  the port's small ResNet.
"""
import pytest

torch = pytest.importorskip("torch")

import numpy as np  # noqa: E402

from repro import configs as jconfigs  # noqa: E402
from repro.core import planner as jplanner  # noqa: E402
from repro_torch import configs  # noqa: E402
from repro_torch.core import planner  # noqa: E402
from repro_torch.core.plan import PrecisionPlan  # noqa: E402
from repro_torch.models import resnet as R  # noqa: E402
from repro_torch.models.api import ModelAPI  # noqa: E402
from test_torch_roofline import tpu_hw  # noqa: E402

TPU = tpu_hw()
SENS_RTOL = 1e-4


def _weights(seed, shapes):
    rng = np.random.default_rng(seed)
    return {f"l{i}": (rng.normal(0, 1 / np.sqrt(s[0]), s)
                      * rng.uniform(0.5, 2.0)).astype(np.float32)
            for i, s in enumerate(shapes)}


@pytest.mark.parametrize("seed", [0, 1])
def test_weight_sensitivity_matches_reference(seed):
    ws = _weights(seed, [(147, 64), (576, 64), (1152, 128), (64, 128),
                         (4608, 512), (512, 10)])
    macs = {n: int(w.size) * (seed + 3) for n, w in ws.items()}
    for m in (None, macs):
        mine = planner.weight_ptq_sensitivity(ws, macs=m)
        ref = jplanner.weight_ptq_sensitivity(ws, macs=m)
        assert mine.keys() == ref.keys()
        for n in ref:
            assert mine[n].keys() == ref[n].keys()
            for b in ref[n]:
                assert mine[n][b] == pytest.approx(ref[n][b], rel=SENS_RTOL)
        assert all(mine[n][1] > mine[n][2] > mine[n][4] > mine[n][8]
                   for n in mine)


def test_weight_sensitivity_takes_tensors():
    ws = _weights(3, [(64, 32)])
    a = planner.weight_ptq_sensitivity(ws)
    b = planner.weight_ptq_sensitivity(
        {n: torch.from_numpy(w) for n, w in ws.items()})
    assert a == b


def test_kv_sensitivity_equals_reference():
    rng = np.random.default_rng(4)
    kv = {f"l{i}.{t}": rng.normal(0, 1, (3, 17, 2, 16)).astype(np.float32)
          for i in range(2) for t in "kv"}
    w = {n: float(i + 1) for i, n in enumerate(kv)}
    for weights in (None, w):
        assert planner.kv_cache_sensitivity(kv, weights=weights) == \
            jplanner.kv_cache_sensitivity(kv, weights=weights)


def _table(names, seed, options=planner.BIT_OPTIONS):
    """A deterministic sensitivity table, rising as bits fall."""
    rng = np.random.default_rng(seed)
    out = {}
    for n in names:
        base = float(rng.uniform(0.1, 10.0))
        out[n] = {b: (0.0 if b == 8 else base * float(rng.uniform(1, 2))
                      * 4.0 ** (-b)) for b in options}
        out[n][1] = out[n][2] * 3 if 1 in options else None
    return out


def _same_points(a, b):
    assert [p.row() for p in a] == [p.row() for p in b]
    assert [p.plan.to_json() for p in a] == [p.plan.to_json() for p in b]
    assert [p.bits for p in a] == [p.bits for p in b]


@pytest.mark.parametrize("arch,batch", [("resnet18", 8), ("resnet50", 1)])
def test_latency_tables_equal_reference(arch, batch):
    gemms = configs.get(arch).gemm_workload(batch)
    jgemms = jconfigs.get(arch).gemm_workload(batch)
    lat = planner.layer_latency_table(gemms, hw=TPU)
    assert lat == jplanner.layer_latency_table(jgemms)
    bits = {n: b for n, b in zip(lat, [8, 4, 2, 1] * 40)}
    assert planner.plan_latency(lat, bits) == jplanner.plan_latency(lat,
                                                                    bits)


def test_kv_latency_table_equals_reference():
    kvw = configs.get("granite-8b").kv_cache_workload()
    assert kvw == jconfigs.get("granite-8b").kv_cache_workload()
    for tokens, batch in ((4096, 1), (1016, 4)):
        assert planner.kv_decode_latency_table(
            kvw, tokens=tokens, batch=batch, hw=TPU) == \
            jplanner.kv_decode_latency_table(kvw, tokens=tokens, batch=batch)


@pytest.mark.parametrize("arch", ["resnet18", "resnet152"])
def test_plan_search_equals_reference(arch):
    api, japi = configs.get(arch), jconfigs.get(arch)
    gemms, jgemms = api.gemm_workload(8), japi.gemm_workload(8)
    cfg = api.cfg
    sens = _table(R.inner_layer_names(cfg), 7)
    lp, classes = R.layer_param_counts(cfg), R.layer_classes(cfg)
    budget = 0.2 * 4 * sum(lp.values()) / 8
    for kw in ({}, {"layer_params": lp, "budget_bytes": budget},
               {"budget_error": 1e-3}, {"variant": "sa",
                                        "channel_wise": True}):
        a = planner.plan_search(gemms, sens, hw=TPU, **kw)
        b = jplanner.plan_search(jgemms, sens, **kw)
        _same_points(a.points, b.points)
        _same_points(a.frontier, b.frontier)
        _same_points([a.chosen], [b.chosen])
        assert a.frontier_rows() == b.frontier_rows()
    assert classes == dict(zip(lp, [g.layer_class for g in
                                    api.gemm_workload(1)]))


def test_greedy_descents_equal_reference():
    api = configs.get("granite-8b")
    gemms, jgemms = api.gemm_workload(4096), \
        jconfigs.get("granite-8b").gemm_workload(4096)
    inner = [g.name for g in gemms if g.layer_class != "boundary"]
    sens = _table(inner, 11)
    lat = planner.layer_latency_table(gemms, hw=TPU)
    assert lat == jplanner.layer_latency_table(jgemms)
    _same_points(planner.greedy_bit_descent(inner, sens, lat),
                 jplanner.greedy_bit_descent(inner, sens, lat))
    _same_points(planner.greedy_bit_descent(inner, sens, lat, min_bits=2),
                 jplanner.greedy_bit_descent(inner, sens, lat, min_bits=2))
    kvw = api.kv_cache_workload()
    kv_names = sorted(kvw)[:6]
    kv_sens = _table(kv_names, 12, planner.KV_BIT_OPTIONS)
    for n in kv_names:
        kv_sens[n] = {b: (0.0 if b >= 16 else 2.0 ** -b)
                      for b in planner.KV_BIT_OPTIONS}
    kv_lat = planner.kv_decode_latency_table(
        {n: kvw[n] for n in kv_names}, tokens=4096, hw=TPU)
    _same_points(
        planner.greedy_joint_descent(inner, sens, lat, kv_names, kv_sens,
                                     kv_lat),
        jplanner.greedy_joint_descent(inner, sens, lat, kv_names, kv_sens,
                                      kv_lat))


def test_joint_plan_search_equals_reference():
    """granite-8b with its KV workload: joint descent, the analytic KV
    proxy, footprints with the cache counted."""
    api, japi = configs.get("granite-8b"), jconfigs.get("granite-8b")
    gemms, jgemms = api.gemm_workload(1024), japi.gemm_workload(1024)
    inner = [g.name for g in gemms if g.layer_class != "boundary"]
    sens = _table(inner, 13)
    kvw = {n: v for n, v in api.kv_cache_workload().items()
           if n.startswith(("l0.", "l1."))}
    lp = {g.name: g.k * g.n * g.count for g in gemms}
    a = planner.plan_search(gemms, sens, hw=TPU, kv_workload=kvw,
                            layer_params=lp, kv_tokens=2048, kv_batch=2)
    b = jplanner.plan_search(jgemms, sens, kv_workload=kvw,
                             layer_params=lp, kv_tokens=2048, kv_batch=2)
    _same_points(a.points, b.points)
    _same_points(a.frontier, b.frontier)
    _same_points([a.chosen], [b.chosen])
    assert any(p.plan.kv_enabled() for p in a.points)


def test_pareto_front_equals_reference():
    rng = np.random.default_rng(5)
    pts, jpts = [], []
    plan = PrecisionPlan(name="p")
    from repro.core.plan import PrecisionPlan as JPlan
    for i in range(40):
        e, l = (float(rng.integers(0, 8)), float(rng.integers(1, 8)))
        pts.append(planner.PlanPoint(f"p{i}", plan, (), e, l))
        jpts.append(jplanner.PlanPoint(f"p{i}", JPlan(name="p"), (), e, l))
    assert [p.name for p in planner.pareto_front(pts)] == \
        [p.name for p in jplanner.pareto_front(jpts)]


def test_plan_search_rejects_like_reference():
    gemms = configs.get("resnet18").gemm_workload(1)
    sens = _table(R.inner_layer_names(configs.get("resnet18").cfg)[1:], 0)
    with pytest.raises(ValueError, match="sensitivity missing"):
        planner.plan_search(gemms, sens)
    full = _table(R.inner_layer_names(configs.get("resnet18").cfg), 0)
    with pytest.raises(ValueError, match="layer_params"):
        planner.plan_search(gemms, full, budget_bytes=1.0)


def _fake_forward(layer_names, plan_cls):
    """A deterministic numpy 'model': logits move with each layer's bits,
    and the fp baseline gives the clean logits."""
    rng = np.random.default_rng(9)
    clean = rng.normal(0, 1, (4, 10))
    noise = {n: rng.normal(0, 1, (4, 10)) for n in layer_names}

    def fwd(plan):
        if not plan.quantize:
            return clean.astype(np.float32)
        y = clean.copy()
        for n in layer_names:
            y = y + noise[n] * 2.0 ** (-plan.policy_for(n).inner_bits)
        return y.astype(np.float32)
    return fwd


def test_calibration_sensitivity_equals_reference():
    from repro.core import plan as jplan
    from repro.core.precision import PrecisionPolicy as JPolicy
    from repro_torch.core.precision import PrecisionPolicy
    names = ["a", "b", "c"]
    mine = planner.calibration_sensitivity(_fake_forward(names, None),
                                           names)
    ref = jplanner.calibration_sensitivity(_fake_forward(names, None),
                                           names)
    assert mine == ref
    assert all(mine[n][8] == 0.0 and mine[n][1] > mine[n][4] for n in names)
    base = PrecisionPlan.from_json({"name": "b", "layers": {
        "a": {"w_bits": 4, "k": 4}}})
    jbase = jplan.PrecisionPlan.from_json(base.to_json())
    assert planner.calibration_sensitivity(
        _fake_forward(names, None), names, base_plan=base,
        bit_options=(8, 2)) == jplanner.calibration_sensitivity(
        _fake_forward(names, None), names, base_plan=jbase,
        bit_options=(8, 2))
    assert PrecisionPlan.uniform(PrecisionPolicy()).to_json() == \
        jplan.PrecisionPlan.uniform(JPolicy()).to_json()


def test_chosen_plan_serves_a_small_resnet():
    """The H100 search over a small ResNet's own sensitivities: the chosen
    plan validates, packs and serves finite logits."""
    cfg = R.ResNetConfig(name="tiny", depth=18, n_classes=10, img_size=32,
                         width=16, stages_override=(1, 1))
    api = ModelAPI(name="tiny", family="cnn", cfg=cfg, mod=R,
                   policy=configs.get("resnet18", reduced=True).policy)
    params = api.init_params(torch.Generator().manual_seed(1), device="cpu")
    state = R.init_bn_state(api.specs(), device="cpu")
    lw = R.layer_weights(cfg, params)
    inner = R.inner_layer_names(cfg)
    sens = planner.weight_ptq_sensitivity({n: lw[n] for n in inner})
    res = planner.plan_search(R.gemm_workload(cfg, 8), sens,
                              layer_params=R.layer_param_counts(cfg),
                              budget_bytes=0.5 * sum(
                                  R.layer_param_counts(cfg).values()))
    lats = [p.latency_s for p in res.frontier]
    assert lats == sorted(lats) and res.chosen in res.frontier
    plan = PrecisionPlan.loads(res.chosen.plan.dumps())
    plan.validate_layers(R.plan_layer_names(cfg))
    packed = R.pack_for_serve(cfg, params, state, plan)
    x = torch.from_numpy(np.random.default_rng(2).normal(
        0, 1, (2, 32, 32, 3)).astype(np.float32))
    y = R.serve_forward(cfg, packed, x, plan)
    assert y.shape == (2, 10) and torch.isfinite(y.float()).all()
