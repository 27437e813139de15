"""The port's granite-8b serve path against the JAX package's.

Reduced granite-8b (3 layers, d_model 64, ``attn_impl="flash"``) under
``examples/plans/granite_8b_mixed.json`` itself -- its depth-scoped keys
name l0-l2, so every layer has its own weight and cache formats and prefill
runs K4 in every layer -- and under the same plan without its KV keys, where
prefill runs K3 on a bf16 cache.  The JAX side runs op by op
(``jax.disable_jit``), its Pallas kernels in interpret mode; the port runs
the kernels' plain versions.

Why op by op: XLA's fusions under ``jit`` round differently (contracted
multiply-adds in the norms and rotary), and through three layers of 8-bit
activation quantization that moves this random model's logits by 2-5% of
their largest magnitude between the JAX package's own jitted and eager
runs.  The port follows the eager run's arithmetic.

Contract: the packed trees convert bit for bit, and the port's own
``pack_for_serving`` gives the same planes, colsum and gamma bitwise;
prefill logits and teacher-forced ``decode_step`` logits agree within 2% of
the largest |logit| (rsqrt, sin/cos, silu and f32 sum orders may differ
between the frameworks, so the LM is held by tolerance); the generated
tokens are equal; inside the port the packed and qdq stores decode bitwise
equal.
"""
import dataclasses
from pathlib import Path

import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402
import numpy as np  # noqa: E402

from repro import configs as jconfigs  # noqa: E402
from repro.core import plan as jplan  # noqa: E402
from repro.runtime import serve as jserve  # noqa: E402
from repro_torch import configs, convert  # noqa: E402
from repro_torch.core import plan as tplan  # noqa: E402
from repro_torch.kernels.flashattn import kernel as fkernel  # noqa: E402
from repro_torch.models import resnet as R  # noqa: E402
from repro_torch.nn import kvcache  # noqa: E402
from repro_torch.nn import param as nnp  # noqa: E402
from repro_torch.runtime.serve import Generator, pack_for_serving  # noqa: E402

PLAN = Path(__file__).resolve().parents[1] / "examples" / "plans" / \
    "granite_8b_mixed.json"
LOGIT_RTOL = 2e-2
BATCH, PROMPT, NEW = 2, 21, 6


def _np_tree(tree):
    return jax.tree.map(lambda a: np.array(a), tree)


def _f32(x):
    if isinstance(x, torch.Tensor):
        return x.to(torch.float32).numpy()
    return np.asarray(jnp.asarray(x).astype(jnp.float32))


def _randomize(tree, rng):
    """Non-trivial LSQ step sizes, from numpy."""
    if isinstance(tree, dict):
        return {k: (jnp.asarray(rng.uniform(0.02, 0.06, np.shape(v)),
                                jnp.float32) if k in ("gw", "ga")
                    else _randomize(v, rng)) for k, v in tree.items()}
    return tree


def _apis(store: str, kv: bool):
    """(JAX api, port api, plans) for the reduced config with flash."""
    jp = jplan.PrecisionPlan.load(PLAN)
    if kv:
        jp = dataclasses.replace(jp, kv=dataclasses.replace(jp.kv,
                                                            store=store))
    else:
        jp = jplan.strip_kv(jp)
    tp = tplan.PrecisionPlan.from_json(jp.to_json())
    japi = jconfigs.get("granite-8b", reduced=True)
    japi.cfg = dataclasses.replace(japi.cfg, attn_impl="flash")
    japi = dataclasses.replace(japi, policy=jp)
    tapi = configs.get("granite-8b", reduced=True)
    tapi = dataclasses.replace(
        tapi, cfg=dataclasses.replace(tapi.cfg, attn_impl="flash"), policy=tp)
    return japi, tapi


@dataclasses.dataclass
class Case:
    japi: object
    tapi: object
    jtrain: dict
    jpacked: dict
    packed: dict
    tokens: np.ndarray
    jlogits: list       # JAX prefill + teacher-forced decode logits
    jtokens: np.ndarray  # JAX greedy tokens (the decode steps are fed these)


def _build(kv: bool) -> Case:
    japi, tapi = _apis("packed", kv)
    rng = np.random.default_rng(12)
    jtrain = _randomize(japi.init_params(jax.random.PRNGKey(3), "train"), rng)
    # Jitted: the packing is integer work and a product of two steps, the
    # same bits as op by op, in one compile instead of hundreds of ops.
    jpacked = jax.jit(lambda t: jserve.pack_for_serving(japi, t))(jtrain)
    packed = convert.from_jax_lm_serve_tree(_np_tree(jpacked), device="cpu")
    tokens = rng.integers(0, japi.cfg.vocab, (BATCH, PROMPT))
    gen = jserve.Generator(japi, jpacked)
    with jax.disable_jit():  # greedy, as gen.generate, keeping the logits
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
    jtokens = np.stack(jtokens, axis=1)
    return Case(japi, tapi, jtrain, jpacked, packed, tokens, jlogits,
                jtokens)


@pytest.fixture(scope="module", params=["kv_plan", "kv_less"])
def case(request):
    return _build(kv=request.param == "kv_plan")


def test_pack_for_serving_matches(case):
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
        elif path == "/embed/gamma":
            # LSQ init's mean: float64 here, XLA's f32 tree sum there
            np.testing.assert_allclose(a.numpy(), b.numpy(), rtol=1e-6)
        else:
            assert a.dtype == b.dtype, path
            np.testing.assert_array_equal(_f32(a), _f32(b), err_msg=path)
    walk(mine, case.packed, "")
    spec = nnp.strip_markers(case.tapi.specs("serve"))
    assert [tuple(lp["mlp"]["gate"]["planes"].shape) for lp in mine["layers"]] \
        == [sp["mlp"]["gate"]["planes"].shape for sp in spec["layers"]]


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
                                   err_msg=f"step {step}")


def test_prefill_routes_through_k4_or_k3(case, monkeypatch):
    calls = {"k3": 0, "k4": 0}

    def count(name, fn):
        def wrapped(*a, **kw):
            calls[name] += 1
            return fn(*a, **kw)
        return wrapped
    monkeypatch.setattr(fkernel, "flash_fwd_torch",
                        count("k3", fkernel.flash_fwd_torch))
    monkeypatch.setattr(fkernel, "flash_fwd_packed_torch",
                        count("k4", fkernel.flash_fwd_packed_torch))
    gen = Generator(case.tapi, case.packed, device="cpu")
    gen.run(case.tokens, 3)
    n = case.tapi.cfg.n_layers
    kv = case.tapi.policy.kv_enabled()
    assert calls == ({"k3": 0, "k4": n} if kv else {"k3": n, "k4": 0})


def test_packed_and_qdq_stores_decode_bitwise(case):
    if not case.tapi.policy.kv_enabled():
        pytest.skip("the kv-less plan has one store")
    from repro_torch.models import transformer as T
    api_p = case.tapi
    api_q = dataclasses.replace(api_p, policy=dataclasses.replace(
        api_p.policy, kv=dataclasses.replace(api_p.policy.kv, store="qdq")))
    fmts = T.kv_formats(api_p.cfg, api_p.policy)[1]
    gp = Generator(api_p, case.packed, device="cpu")
    gq = Generator(api_q, case.packed, device="cpu")
    toks = torch.as_tensor(case.tokens)
    with torch.inference_mode():
        _, pre = gp.prefill(toks)
        pre_q = [tuple(kvcache.unpack_kv(c[t], f) if f is not None else c[t]
                       for t, f in zip(("k", "v"), pair))
                 for c, pair in zip(pre, fmts)]
        cp = gp._grow_cache(pre, BATCH, PROMPT, PROMPT + NEW)
        cq = gq._grow_cache(pre_q, BATCH, PROMPT, PROMPT + NEW)
        for i in range(NEW - 1):
            feed = torch.as_tensor(case.jtokens[:, i:i + 1])
            lp, cp = gp.decode(cp, feed, PROMPT + i)
            lq, cq = gq.decode(cq, feed, PROMPT + i)
            assert torch.equal(lp, lq), i
    # with the plain chunked attention in prefill too, whole runs agree
    for api in (api_p, api_q):
        api.cfg = dataclasses.replace(api.cfg, attn_impl="xla")
    runs = [Generator(api, case.packed, device="cpu").run(case.tokens, NEW)
            for api in (api_p, api_q)]
    assert (runs[0][0] == runs[1][0]).all()
    assert all(torch.equal(a, b) for a, b in zip(runs[0][1], runs[1][1]))


def test_sample_fn_seam(case):
    seen = []

    def lowest(logits, generator):
        seen.append(generator)
        return torch.argmin(logits, dim=-1)
    gen = Generator(case.tapi, case.packed, device="cpu", sample_fn=lowest)
    rng = torch.Generator().manual_seed(0)
    toks, logits = gen.run(case.tokens, 3, generator=rng)
    assert len(seen) == 3 and all(g is rng for g in seen)
    np.testing.assert_array_equal(toks[:, 0],
                                  torch.argmin(logits[0], -1).numpy())


def test_forward_last_position_is_prefill(case):
    from repro_torch.models import transformer as T
    toks = torch.as_tensor(case.tokens)
    with torch.inference_mode():
        full = T.forward(case.tapi.cfg, case.packed, toks, case.tapi.policy)
        last, _ = T.prefill(case.tapi.cfg, case.packed, toks,
                            case.tapi.policy)
    assert full.shape == (BATCH, PROMPT, case.tapi.cfg.vocab)
    # the head runs on all positions or on the last one: row-wise, the same
    assert torch.equal(full[:, -1], last)


def test_entry_points_default_to_the_card(case):
    if torch.cuda.is_available():
        pytest.skip("this machine has a card; the defaults would run there")
    api = case.tapi
    gen = torch.Generator().manual_seed(0)
    for call in (lambda **kw: api.init_params(gen, **kw),
                 lambda **kw: nnp.init_params(api.specs(), gen, **kw),
                 lambda **kw: R.init_bn_state(
                     configs.get("resnet18", reduced=True).specs(), **kw),
                 lambda **kw: Generator(api, case.packed, **kw)):
        with pytest.raises(RuntimeError, match="CUDA"):
            call()
        call(device="cpu")
