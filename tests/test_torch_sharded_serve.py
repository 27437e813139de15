"""Data-parallel serving == single-device serving, bit for bit.

The counterpart of ``tests/test_sharded_serve.py``'s data-parallel cases for
the port, at a world of 4 ranks over gloo on the CPU: one spawn of four
processes (``launch.mesh.spawn``, a ``FileStore`` under ``tmp_path``) runs
every case on a (4, 1) mesh, and each meshed result -- every rank's, since
every rank returns the whole result -- must equal the port's single-device
run of the same case bitwise.  Mixed layer-wise plans (w8/w4/w2) on the CNN
and LM serving shapes, ragged and odd batches, the packed KV cache, the
schedulers, speculative decoding, a frontier behind ``SLOScheduler`` and a
seeded sampler.  A mesh larger than the world raises, and so does an arch
whose heads do not split over a 'model' axis above 1 (a mamba2 of 3 SSD
heads on M = 2; ``test_torch_tensor_parallel``,
``test_torch_tensor_parallel_moe`` and ``test_torch_tensor_parallel_ssm``
serve the archs).

The module imports no JAX: the spawned ranks import it to find the case
functions.  Every process computes on one thread.
"""
import dataclasses

import numpy as np
import pytest
import torch

from repro_torch import configs
from repro_torch.core.plan import KVCachePlan, LayerPlan, PrecisionPlan
from repro_torch.launch import mesh as mesh_lib
from repro_torch.models import resnet as R
from repro_torch.runtime import frontier, slo
from repro_torch.runtime.scheduler import GenerateScheduler, ImageScheduler
from repro_torch.runtime.serve import (Generator, ImageServer,
                                       pack_for_serving, round_buckets,
                                       serve_shardings)
from repro_torch.runtime.specdec import SpeculativeGenerator

WORLD = 4
PLANS = "examples/plans"

MIXED_CNN = PrecisionPlan.build(
    {"s0b0c1": LayerPlan(w_bits=4, k=4),
     "s0b0c2": LayerPlan(w_bits=2, k=2),
     "s1b0c1": LayerPlan(w_bits=2, k=2),
     "s1b0p": LayerPlan(w_bits=4, k=4)},
    default=LayerPlan(w_bits=8, k=4), name="test_mixed_cnn",
    arch="resnet18")

MIXED_LM = PrecisionPlan.build(
    {"q": LayerPlan(w_bits=4, k=4),
     "mlp": LayerPlan(w_bits=2, k=2)},
    default=LayerPlan(w_bits=8, k=4), name="test_mixed_lm",
    arch="granite-8b")


class FakeClock:
    def __init__(self):
        self.t = 0.0

    def __call__(self):
        return self.t

    def advance(self, dt):
        self.t += dt


def _rng(seed):
    return np.random.default_rng(seed)


def _images(n, seed):
    return _rng(seed).normal(0.4, 0.5, (n, 32, 32, 3)).astype(np.float32)


def _cnn():
    api = configs.get("resnet18", reduced=True)
    params = api.init_params(torch.Generator().manual_seed(0), device="cpu")
    state = R.init_bn_state(R.specs(api.cfg), device="cpu")
    return api, R.pack_for_serve(api.cfg, params, state, MIXED_CNN)


def _lm_train():
    return configs.get("granite-8b", reduced=True).init_params(
        torch.Generator().manual_seed(0), "train", device="cpu")


def _lm(plan=MIXED_LM):
    return configs.get("granite-8b", reduced=True, policy=plan)


def _tokens(b, s, seed, vocab):
    return _rng(seed).integers(0, vocab, (b, s)).astype(np.int32)


# --- the cases: each runs on ``mesh`` (None: one device) -> its results -----


def case_cnn_mixed(mesh):
    api, packed = _cnn()
    srv = ImageServer(api=api, params=packed, plan=MIXED_CNN,
                      batch_buckets=(16,), device="cpu", mesh=mesh)
    seen = []
    fwd = srv._forward
    srv._forward = lambda b, x: (seen.append(x.shape[0]), fwd(b, x))[1]
    out = {"logits": srv.predict(_images(16, 0)), "rows": seen,
           "leaves": [(tuple(v[0].shape) if isinstance(v, tuple)
                       else tuple(v.shape)) for v in _flat(srv.params)],
           "device": str(srv.device)}
    # the ImageScheduler over the meshed server: six single images
    srv2 = ImageServer(api=api, params=packed, plan=MIXED_CNN,
                       batch_buckets=(1, 2, 4, 8), device="cpu", mesh=mesh)
    sched = ImageScheduler(srv2, clock=FakeClock(), max_wait_s=0.0)
    tickets = [sched.submit(im) for im in _images(6, 5)]
    sched.drain()
    out["sched"] = [t.result for t in tickets]
    out["dispatched"] = list(sched.dispatched_batches)
    return out


def _flat(tree):
    if isinstance(tree, dict):
        return [x for k in sorted(tree) for x in _flat(tree[k])]
    if isinstance(tree, list):
        return [x for v in tree for x in _flat(v)]
    return [tree]


def case_cnn_ragged(mesh):
    api, packed = _cnn()
    srv = ImageServer(api=api, params=packed, plan=MIXED_CNN,
                      batch_buckets=(8,), device="cpu", mesh=mesh)
    return {"logits": srv.predict(_images(5, 1))}


def case_buckets(mesh):
    api, packed = _cnn()
    mk = lambda b: ImageServer(api=api, params=packed, plan=MIXED_CNN,  # noqa
                               batch_buckets=b, device="cpu", mesh=mesh)
    return {"a": mk((1, 2, 4, 8)).batch_buckets,
            "b": mk((2, 6, 8)).batch_buckets}


def case_lm_mixed(mesh):
    api = _lm()
    packed = pack_for_serving(api, _lm_train(), mesh=mesh)
    gen = Generator(api=api, params=packed, device="cpu", mesh=mesh)
    toks = _tokens(8, 8, 0, api.cfg.vocab)
    out, logits = gen.run(toks, 5)
    return {"tokens": out, "logits": [lg.float().numpy() for lg in logits]}


def case_lm_odd(mesh):
    api = _lm()
    gen = Generator(api=api, params=pack_for_serving(api, _lm_train()),
                    device="cpu", mesh=mesh)
    return {"tokens": gen.generate(_tokens(3, 6, 1, api.cfg.vocab), 4)}


def case_pack_places(mesh):
    api = _lm()
    packed = pack_for_serving(api, _lm_train(), mesh=mesh)
    out = {"leaves": [x.numpy() for x in _flat(packed)]}
    if mesh is not None:
        sh = _flat(serve_shardings(api, mesh))
        out["n_shardings"] = len(sh)
        out["replicated"] = all(s.is_fully_replicated for s in sh)
        out["on_device"] = all(x.device == mesh_lib.local_device(mesh)
                               for x in _flat(packed))
    return out


def _kv_plan(store):
    plan = PrecisionPlan.build(
        {"k": LayerPlan(w_bits=8, kv_bits=4),
         "v": LayerPlan(w_bits=8, kv_bits=2),
         "l1.k": LayerPlan(w_bits=8, kv_bits=8)},
        default=LayerPlan(w_bits=8, k=4), name="test_kv_mesh",
        arch="granite-8b")
    return dataclasses.replace(plan, kv=KVCachePlan(k=4, store=store))


def case_kv_cache(mesh):
    train = _lm_train()
    toks = _tokens(8, 8, 5, 256)
    out = {}
    for store in ("packed", "qdq"):
        api = _lm(_kv_plan(store))
        gen = Generator(api=api, params=pack_for_serving(api, train,
                                                         mesh=mesh),
                        device="cpu", mesh=mesh)
        out[store] = gen.generate(toks, 5)
    return out


def case_scheduler(mesh):
    api = _lm()
    gen = Generator(api=api, params=pack_for_serving(api, _lm_train(),
                                                     mesh=mesh),
                    device="cpu", mesh=mesh)
    sched = GenerateScheduler(gen, slots=4, max_len=16, clock=FakeClock())
    rng = _rng(5)
    prompts = [rng.integers(0, api.cfg.vocab, (6,)).astype(np.int32)
               for _ in range(3)]
    prompts.append(rng.integers(0, api.cfg.vocab, (4,)).astype(np.int32))
    tickets = [sched.submit(p, n) for p, n in zip(prompts, (3, 5, 2, 4))]
    sched.step()
    sched.step()
    # which in-flight slots hold a cache here (this rank's own only)
    held = [(i, s.cache is not None) for i, s in enumerate(sched._slots)
            if s is not None]
    sched.run_until_idle()
    return {"per_rank": {"held": held}, "buckets": sched.prefill_buckets,
            "decode_buckets": sched.decode_buckets,
            "results": [t.result for t in tickets],
            "alone": [gen.generate(p.reshape(1, -1), n)[0]
                      for p, n in zip(prompts, (3, 5, 2, 4))]}


def case_uniform(mesh):
    api = configs.get("granite-8b", reduced=True)
    params = api.init_params(torch.Generator().manual_seed(2), "train",
                             device="cpu")
    gen = Generator(api=api, params=pack_for_serving(api, params, mesh=mesh),
                    device="cpu", mesh=mesh)
    return {"tokens": gen.generate(np.ones((4, 8), np.int32), 3)}


def case_specdec(mesh):
    verify = PrecisionPlan.load(f"{PLANS}/granite_8b_mixed.json")
    draft = PrecisionPlan.load(f"{PLANS}/granite_8b_draft_w2.json")
    api = _lm(verify)
    train = _lm_train()
    views = tuple(pack_for_serving(dataclasses.replace(api, policy=p), train,
                                   mesh=mesh) for p in (verify, draft))
    sg = SpeculativeGenerator(api=api, packed_views=views, draft_plan=draft,
                              k=3, device="cpu", mesh=mesh)
    toks = _tokens(3, 6, 7, api.cfg.vocab)
    out = {"tokens": sg.generate(toks, 7), "drafted": sg.drafted_tokens,
           "accepted": sg.accepted_tokens}
    sched = GenerateScheduler(sg, slots=2, max_len=16, clock=FakeClock())
    tickets = [sched.submit(t, 5) for t in toks]
    sched.run_until_idle()
    out["sched"] = [t.result for t in tickets]
    out["sched_counts"] = (sg.drafted_tokens, sg.accepted_tokens)
    return out


def _tiny_frontier(mesh):
    kw = dict(name="tiny", depth=18, n_classes=10, img_size=32, width=16,
              stages_override=(1, 1))
    cfg = R.ResNetConfig(**kw)
    plans = [{"name": "w8", "default": {"w_bits": 8, "k": 4}},
             {"name": "mixed", "default": {"w_bits": 4, "k": 4},
              "layers": {"s0b0c1": {"w_bits": 2, "k": 2},
                         "s1b0p": {"w_bits": 8, "k": 4}}},
             {"name": "w2", "default": {"w_bits": 2, "k": 2}}]
    tplans = [(p["name"], PrecisionPlan.from_json(p)) for p in plans]
    from repro_torch.models.api import ModelAPI
    api = ModelAPI(name="tiny", family="cnn", cfg=cfg, mod=R,
                   policy=tplans[0][1])
    from repro_torch.nn import param as nnp
    params = nnp.init_params(R.specs(cfg), torch.Generator().manual_seed(2),
                             device="cpu")
    state = R.init_bn_state(R.specs(cfg), device="cpu")
    return frontier.build_frontier(api, params, tplans, state=state,
                                   batch_buckets=(1, 4), device="cpu",
                                   mesh=mesh)


def case_slo(mesh):
    """A burst through SLOScheduler over a meshed frontier under seeded
    faults, then each served image alone at its ticket's level."""
    from repro_torch.runtime import faults
    fr = _tiny_frontier(mesh)
    clk = FakeClock()
    inj = faults.FaultInjector(faults.FaultSpec(
        step_error_rate=0.25, latency_spike_rate=0.2, latency_spike_s=0.5),
        5)
    s = slo.SLOScheduler(inj.wrap_frontier(fr, advance=clk.advance),
                         slo_s=2.0, clock=clk, est_serve_s=[1.0, 0.3, 0.1],
                         max_retries=4,
                         hysteresis=slo.HysteresisConfig(up_after=1,
                                                         down_after=2))
    images = list(_images(10, 3))
    tickets = [s.submit(im) for im in images * 2]
    s.drain()
    for _ in range(6):
        clk.advance(1.0)
        tickets.append(s.submit(images[0]))
        s.drain()
    return {"points": [t.plan_point for t in tickets],
            "results": [t.result for t in tickets],
            "transitions": s.stats()["transitions"], "level": s.level,
            "alone": {lvl: fr.serve(images, level=lvl)
                      for lvl in range(fr.n_levels)}}


def _sampler(logits, generator):
    """Gumbel-max over the rows it is given, from ``generator``."""
    u = torch.rand(logits.shape, generator=generator, dtype=torch.float64)
    return torch.argmax(logits.double() - torch.log(-torch.log(u)), dim=-1)


def case_sample(mesh):
    api = _lm()
    gen = Generator(api=api, params=pack_for_serving(api, _lm_train()),
                    device="cpu", mesh=mesh, sample_fn=_sampler)
    return {"tokens": gen.generate(_tokens(5, 6, 9, api.cfg.vocab), 6,
                                   generator=torch.Generator().manual_seed(3))}


CASES = {f.__name__[5:]: f for f in (
    case_cnn_mixed, case_cnn_ragged, case_buckets, case_lm_mixed,
    case_lm_odd, case_pack_places, case_kv_cache, case_scheduler,
    case_uniform, case_specdec, case_slo, case_sample)}


def _rank(rank, names):
    """One rank of the world: every case on a (4, 1) mesh, then the mesh
    errors -> {case: results}."""
    torch.set_num_threads(1)
    mesh = mesh_lib.make_serve_mesh(WORLD, 1, device="cpu")
    out = {name: CASES[name](mesh) for name in names}
    errors = {}
    for shape, exc in (((4, 2), ValueError), ((8, 1), ValueError),
                       ((2, 1), ValueError)):
        try:
            mesh_lib.make_serve_mesh(*shape, device="cpu")
        except exc as e:
            errors[shape] = str(e)
    tp = mesh_lib.make_serve_mesh(2, 2, device="cpu")
    ssm = configs.get("mamba2-1.3b", reduced=True)
    ssm = dataclasses.replace(ssm, cfg=dataclasses.replace(
        ssm.cfg, ssm=dataclasses.replace(ssm.cfg.ssm, expand=3,
                                         head_dim=64)))   # 3 SSD heads
    train = ssm.init_params(torch.Generator().manual_seed(0), "train",
                            device="cpu")
    try:
        pack_for_serving(ssm, train, mesh=tp)
    except ValueError as e:
        errors[(2, 2, "mamba2-1.3b")] = str(e)
    out["_errors"] = errors
    out["_coords"] = mesh_lib.data_coords(mesh)
    return out


@pytest.fixture(scope="module")
def meshed(tmp_path_factory):
    store = tmp_path_factory.mktemp("world")
    return mesh_lib.spawn(_rank, WORLD, (list(CASES),), store_dir=str(store),
                          timeout_s=240)


@pytest.fixture(scope="module")
def single():
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    try:
        return {name: fn(None) for name, fn in CASES.items()}
    finally:
        torch.set_num_threads(threads)


def _equal(a, b, path="") -> None:
    if isinstance(a, dict):
        assert sorted(a) == sorted(b), path
        for k in a:
            _equal(a[k], b[k], f"{path}.{k}")
    elif isinstance(a, (list, tuple)):
        assert len(a) == len(b), path
        for i, (x, y) in enumerate(zip(a, b)):
            _equal(x, y, f"{path}[{i}]")
    elif isinstance(a, np.ndarray) or isinstance(b, np.ndarray):
        np.testing.assert_array_equal(a, b, err_msg=path)
    else:
        assert a == b, path


def _meshed(meshed, name):
    """The case's results, the same on every rank (but its ``per_rank``
    entry, which each rank fills with what it alone holds)."""
    def shared(r):
        return {k: v for k, v in meshed[r][name].items() if k != "per_rank"}
    for r in range(1, WORLD):
        _equal(shared(0), shared(r), f"rank {r}")
    return shared(0)


def test_every_rank_has_its_coordinate(meshed):
    assert [m["_coords"] for m in meshed] == [(r, WORLD)
                                               for r in range(WORLD)]


def test_mixed_cnn_plan_bit_equal(meshed, single):
    got, want = _meshed(meshed, "cnn_mixed"), single["cnn_mixed"]
    np.testing.assert_array_equal(got["logits"], want["logits"])
    assert want["rows"] == [16] and got["rows"] == [16 // WORLD]
    # each rank holds the whole packed tree, on its device
    assert got["leaves"] == want["leaves"] and got["device"] == "cpu"


def test_image_scheduler_over_meshed_server(meshed, single):
    got, want = _meshed(meshed, "cnn_mixed"), single["cnn_mixed"]
    _equal(got["sched"], want["sched"])
    assert sum(got["dispatched"]) == 6


def test_ragged_batch_bit_equal(meshed, single):
    np.testing.assert_array_equal(_meshed(meshed, "cnn_ragged")["logits"],
                                  single["cnn_ragged"]["logits"])


def test_buckets_round_to_device_multiples(meshed, single):
    assert _meshed(meshed, "buckets") == {"a": (4, 8), "b": (4, 8)}
    assert single["buckets"] == {"a": (1, 2, 4, 8), "b": (2, 6, 8)}
    # the pure rule, also at data 8 (the reference's 8-device case)
    assert round_buckets((1, 2, 4, 8), 8) == (8,)
    assert round_buckets((2, 6, 8), 4) == (4, 8)


def test_mixed_lm_plan_bit_equal(meshed, single):
    _equal(_meshed(meshed, "lm_mixed"), single["lm_mixed"])


def test_odd_batch_pads_to_device_multiple(meshed, single):
    got = _meshed(meshed, "lm_odd")["tokens"]
    assert got.shape == (3, 4)
    np.testing.assert_array_equal(got, single["lm_odd"]["tokens"])


def test_pack_for_serving_places_on_mesh(meshed, single):
    got = _meshed(meshed, "pack_places")
    _equal(got["leaves"], single["pack_places"]["leaves"])
    assert got["n_shardings"] == len(got["leaves"])
    assert got["replicated"] and got["on_device"]


def test_packed_kv_cache_meshed_bit_equal(meshed, single):
    got, want = _meshed(meshed, "kv_cache"), single["kv_cache"]
    _equal(got, want)
    np.testing.assert_array_equal(want["packed"], want["qdq"])


def test_scheduler_over_meshed_generator_bit_equal(meshed, single):
    got, want = _meshed(meshed, "scheduler"), single["scheduler"]
    assert got["buckets"] == (4,)  # rounded to the data axis
    assert got["decode_buckets"] == (4, 8)
    _equal(got["results"], want["alone"])
    _equal(got["alone"], want["alone"])
    _equal(want["results"], want["alone"])


def test_scheduler_slot_caches_stay_on_their_rank(meshed, single):
    """Slot i's cache lives on rank i mod 4 alone; one device holds all."""
    want = single["scheduler"]["per_rank"]["held"]
    assert len(want) >= 2 and all(h for _, h in want)
    for r in range(WORLD):
        held = meshed[r]["scheduler"]["per_rank"]["held"]
        assert [i for i, _ in held] == [i for i, _ in want]
        assert held == [(i, i % WORLD == r) for i, _ in held]


def test_uniform_policy_sharded_too(meshed, single):
    _equal(_meshed(meshed, "uniform"), single["uniform"])


def test_speculative_generator_meshed(meshed, single):
    got, want = _meshed(meshed, "specdec"), single["specdec"]
    _equal(got, want)
    verify = PrecisionPlan.load(f"{PLANS}/granite_8b_mixed.json")
    api = _lm(verify)
    plain = Generator(api=api, params=pack_for_serving(api, _lm_train()),
                      device="cpu")
    np.testing.assert_array_equal(
        want["tokens"], plain.generate(_tokens(3, 6, 7, api.cfg.vocab), 7))


def test_meshed_frontier_behind_slo_scheduler(meshed, single):
    got, want = _meshed(meshed, "slo"), single["slo"]
    assert got["transitions"] >= 2 and got["level"] == 0
    names = ("w8", "mixed", "w2")
    images = list(_images(10, 3))
    idx = list(range(10)) * 2 + [0] * 6
    served = [(i, p, r) for i, p, r in zip(idx, got["points"],
                                           got["results"]) if p is not None]
    assert {p for _, p, _ in served} > {"w8"}
    for i, p, r in served:
        np.testing.assert_array_equal(r, want["alone"][names.index(p)][i])
    for lvl in range(3):
        _equal(got["alone"][lvl], want["alone"][lvl])
    assert len(images) == 10


def test_sampled_rows_draw_as_single_device(meshed, single):
    _equal(_meshed(meshed, "sample"), single["sample"])


def test_model_axis_raises_16b_ii(meshed):
    """A (4, 2) mesh on a world of 4 is too large for it; a mamba2 of 3
    SSD heads on a (2, 2) mesh does not split them."""
    errs = _meshed(meshed, "_errors")
    assert "3 heads do not split evenly over a 'model' axis of 2" in errs[
        (2, 2, "mamba2-1.3b")]
    assert "needs 8 ranks" in errs[(4, 2)]
    assert "needs 8 ranks" in errs[(8, 1)]
    assert "covers 2 ranks" in errs[(2, 1)]
