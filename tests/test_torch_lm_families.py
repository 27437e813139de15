"""The port's other decoder archs against the JAX package's, at reduced size.

granite-34b (MQA), yi-34b (7 query heads a KV head), chameleon-34b (the
VLM backbone), nemotron-4-340b (squared-ReLU MLP), olmoe-1b-7b (MoE) and
deepseek-v2-lite-16b (MoE with MLA attention and a dense first layer), each
at ``reduced=True``:

* the configs, the ``ModelAPI`` fields, the plan and KV layer namespaces
  and the workload the cost model reads (GEMMs, parameter counts, FLOPs)
  equal the JAX package's;
* trained weights drawn by the JAX package and packed by it convert bit
  for bit, and the port's own ``pack_for_serving`` of the same float
  weights gives the same bytes -- the dense prefix and olmoe's expert banks
  under a plan that packs each layer's bank in its own format (the plan of
  ``tests/test_lm_plan.py``'s ``TestMoEPlan``) included;
* prefill logits and three teacher-forced decode steps agree within 2% of
  the largest |logit| (the LM contract), against the JAX package run op by
  op (``jax.disable_jit``; its jitted run fuses differently), and the
  greedy tokens are equal.

``repro``'s side of each arch is computed once, in a pool of three
processes started with the first case (``references``).
"""
import dataclasses

import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402
import numpy as np  # noqa: E402

from repro import configs as jconfigs  # noqa: E402
from repro.configs import shapes as jshapes  # noqa: E402
from repro.core import plan as jplan  # noqa: E402
from repro.models import transformer as JT  # noqa: E402
from repro.runtime import serve as jserve  # noqa: E402
from repro_torch import configs, convert  # noqa: E402
from repro_torch.configs import shapes  # noqa: E402
from repro_torch.core import plan as tplan  # noqa: E402
from repro_torch.models import transformer as T  # noqa: E402
from repro_torch.runtime.serve import Generator, pack_for_serving  # noqa: E402

ARCHS = ["granite-34b", "yi-34b", "chameleon-34b", "nemotron-4-340b",
         "olmoe-1b-7b", "deepseek-v2-lite-16b"]
LOGIT_RTOL = 2e-2
BATCH, PROMPT, NEW = 2, 19, 4


def _np_tree(tree):
    return jax.tree.map(lambda a: np.array(a), tree)


def _f32(x):
    if isinstance(x, torch.Tensor):
        return x.to(torch.float32).numpy()
    return np.asarray(jnp.asarray(x).astype(jnp.float32))


def _fields(obj):
    """A config dataclass as a dict, nested configs as dicts."""
    return {f.name: (_fields(getattr(obj, f.name))
                     if dataclasses.is_dataclass(getattr(obj, f.name))
                     else getattr(obj, f.name))
            for f in dataclasses.fields(obj)}


@pytest.mark.parametrize("reduced", [False, True])
@pytest.mark.parametrize("arch", ARCHS)
def test_config_and_api_fields_equal(arch, reduced):
    j = jconfigs.get(arch, reduced=reduced)
    t = configs.get(arch, reduced=reduced)
    theirs = _fields(j.cfg)
    for name, mine in _fields(t.cfg).items():
        assert mine == theirs[name], name
    assert (t.name, t.family, t.microbatches, t.long_context_ok) == \
        (j.name, j.family, j.microbatches, j.long_context_ok)
    assert str(t.opt_dtype).split(".")[-1] == jnp.dtype(j.opt_dtype).name
    assert _fields(t.policy) == _fields(j.policy)
    for shape in shapes.SHAPES:
        assert shapes.applicable(t, shapes.SHAPES[shape]) == \
            jshapes.applicable(j, jshapes.SHAPES[shape])


@pytest.mark.parametrize("reduced", [False, True])
@pytest.mark.parametrize("arch", ARCHS)
def test_layer_names_equal(arch, reduced):
    j = jconfigs.get(arch, reduced=reduced)
    t = configs.get(arch, reduced=reduced)
    assert t.plan_layer_names() == JT.plan_layer_names(j.cfg)
    assert t.kv_layer_names() == JT.kv_layer_names(j.cfg)
    assert t.kv_cache_workload() == JT.kv_cache_workload(j.cfg)


@pytest.mark.parametrize("arch", ARCHS)
def test_workload_equal(arch):
    j = jconfigs.get(arch)
    t = configs.get(arch)
    for tokens in (1, 64, 4096):
        mine = [dataclasses.astuple(g) for g in t.gemm_workload(tokens)]
        theirs = [(g.name, g.m, g.k, g.n, g.count, g.layer_class)
                  for g in JT.gemm_workload(j.cfg, tokens)]
        assert mine == theirs
    assert t.active_params() == JT.active_params(j.cfg)
    assert t.total_params() == JT.total_params(j.cfg)
    for step in ("train", "prefill", "decode"):
        assert t.model_flops(tokens=4096, step=step) == \
            JT.model_flops(j.cfg, tokens=4096, step=step)


def _plan(arch):
    """olmoe: each layer's expert bank in its own format (the reference's
    MoE plan test); the others: their default policy."""
    if arch != "olmoe-1b-7b":
        return None
    return jplan.PrecisionPlan.build(
        {"l0.expert": jplan.LayerPlan(w_bits=4, k=4),
         "l1.expert": jplan.LayerPlan(w_bits=2, k=2)},
        default=jplan.LayerPlan(w_bits=8, k=4), name="olmoe-mixed")


def _randomize(tree, rng):
    """Non-trivial LSQ step sizes, from numpy."""
    if isinstance(tree, dict):
        return {k: (jnp.asarray(rng.uniform(0.02, 0.06, np.shape(v)),
                                jnp.float32) if k in ("gw", "ga")
                    else _randomize(v, rng)) for k, v in tree.items()}
    return tree


@dataclasses.dataclass
class Case:
    arch: str
    japi: object
    tapi: object
    jtrain: dict
    packed: dict
    tokens: np.ndarray
    jlogits: list
    jtokens: np.ndarray


def _apis(arch):
    """(``repro``'s ``ModelAPI``, the port's) of ``arch`` at reduced size,
    under ``_plan``'s plan where it has one."""
    japi = jconfigs.get(arch, reduced=True)
    tapi = configs.get(arch, reduced=True)
    jp = _plan(arch)
    if jp is not None:
        japi = dataclasses.replace(japi, policy=jp)
        tapi = dataclasses.replace(
            tapi, policy=tplan.PrecisionPlan.from_json(jp.to_json()))
    return japi, tapi


def _reference(arch):
    """``repro``'s side of ``arch``, in a process of its own: float train
    weights (numpy's step sizes), their jitted packing, the prompt, and
    the prefill and three greedy decode steps op by op -> numpy."""
    japi, _ = _apis(arch)
    rng = np.random.default_rng(5)
    jtrain = _randomize(japi.init_params(jax.random.PRNGKey(7), "train"),
                        rng)
    jpacked = jax.jit(lambda t: jserve.pack_for_serving(japi, t))(jtrain)
    tokens = rng.integers(0, japi.cfg.vocab, (BATCH, PROMPT))
    gen = jserve.Generator(japi, jpacked)
    with jax.disable_jit():
        logits, cache = gen._prefill(jpacked, {"tokens": jnp.asarray(tokens)})
        cache = gen._grow_cache(cache, BATCH, PROMPT, PROMPT + NEW)
        jlogits = [logits]
        jtokens = [np.asarray(jnp.argmax(logits, -1))]
        for i in range(NEW - 1):
            logits, cache = gen._decode(jpacked, cache,
                                        jnp.asarray(jtokens[-1][:, None]),
                                        jnp.asarray(PROMPT + i, jnp.int32))
            jlogits.append(logits)
            jtokens.append(np.asarray(jnp.argmax(logits, -1)))
    return (_np_tree(jtrain), _np_tree(jpacked), tokens,
            [np.array(x) for x in jlogits], np.stack(jtokens, axis=1))


@pytest.fixture(scope="module")
def references():
    """``_reference`` of every arch, three processes at a time, started
    once for the module: {arch: its pending result}."""
    import torch.multiprocessing as mp
    pool = mp.get_context("spawn").Pool(3)
    try:
        yield {arch: pool.apply_async(_reference, (arch,))
               for arch in ARCHS}
    finally:
        pool.terminate()
        pool.join()


@pytest.fixture(scope="module", params=ARCHS)
def case(request, references):
    arch = request.param
    japi, tapi = _apis(arch)
    jtrain, jpacked, tokens, jlogits, jtokens = \
        references[arch].get(timeout=900)
    packed = convert.from_jax_lm_serve_tree(jpacked, device="cpu")
    return Case(arch, japi, tapi, jtrain, packed, tokens, jlogits, jtokens)


def test_pack_for_serving_matches(case):
    """The port packs the JAX package's float weights to the same bytes."""
    train = convert.from_jax_lm_train_params(_np_tree(case.jtrain),
                                             device="cpu")
    assert len(train["layers"]) == case.tapi.cfg.n_layers
    mine = pack_for_serving(case.tapi, train)

    def walk(a, b, path):
        if isinstance(a, dict):
            assert a.keys() == b.keys(), path
            for k in a:
                walk(a[k], b[k], f"{path}/{k}")
        elif isinstance(a, list):
            assert len(a) == len(b), path
            for i, (x, y) in enumerate(zip(a, b)):
                walk(x, y, f"{path}[{i}]")
        elif path == "/embed/gamma":  # LSQ init's mean: float64 here
            np.testing.assert_allclose(a.numpy(), b.numpy(), rtol=1e-6)
        else:
            assert a.dtype == b.dtype, path
            np.testing.assert_array_equal(_f32(a), _f32(b), err_msg=path)
    walk(mine, case.packed, "")
    spec = T.specs(case.tapi.cfg, "serve", case.tapi.policy)
    for i, (lp, sp) in enumerate(zip(mine["layers"], spec["layers"])):
        mlp = "moe" if "moe" in sp else "mlp"
        key = "gate" if "gate" in sp[mlp] else "up"
        assert tuple(lp[mlp][key]["planes"].shape) == \
            sp[mlp][key]["planes"].shape, i


def test_dense_prefix_and_expert_banks_convert(case):
    """deepseek's ``dense_layer_0`` lands at ``layers[0]`` ahead of the
    stack; olmoe's banks keep their expert axis, each layer's in its
    plan's format."""
    layers = case.packed["layers"]
    cfg = case.tapi.cfg
    for i, lp in enumerate(layers):
        dense = cfg.moe is None or i < cfg.dense_first_n
        assert ("mlp" in lp) == dense and ("moe" in lp) == (not dense), i
    if case.arch == "deepseek-v2-lite-16b":
        assert layers[0]["mlp"]["up"]["planes"].shape[-1] == cfg.dense_ff
        assert set(layers[0]["attn"]) == {"q", "dkv", "uk", "uv", "o",
                                          "kv_norm"}
    if case.arch == "olmoe-1b-7b":
        e = cfg.moe.n_experts
        g0 = layers[0]["moe"]["gate"]["planes"]
        g1 = layers[1]["moe"]["gate"]["planes"]
        assert g0.shape[0] == g1.shape[0] == e
        assert g0.shape[-3] == g1.shape[-3] == 1
        assert g1.shape[-2] == g0.shape[-2] // 2  # w2k2 packs half the bytes
        assert tuple(layers[0]["moe"]["gate"]["ga"].shape) == (e,)


def test_prefill_and_teacher_forced_decode_match_jax(case):
    gen = Generator(case.tapi, case.packed, device="cpu")
    toks, logits = gen.run(case.tokens, NEW, forced=case.jtokens)
    np.testing.assert_array_equal(toks, case.jtokens)
    for step, (got, want) in enumerate(zip(logits, case.jlogits)):
        g, w = _f32(got), _f32(want)
        assert g.shape == w.shape == (BATCH, case.tapi.cfg.vocab)
        assert np.isfinite(g).all() and g.std() > 0
        np.testing.assert_allclose(g, w, rtol=0,
                                   atol=LOGIT_RTOL * np.abs(w).max(),
                                   err_msg=f"{case.arch} step {step}")
