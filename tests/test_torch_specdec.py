"""The port's speculative decoding against the JAX package's.

Reduced granite-8b, cut to one layer, under
``examples/plans/granite_8b_mixed.json`` (verify) and
``examples/plans/granite_8b_draft_w2.json`` (draft), with the KV cache
stored packed and as qdq grid values.  The float checkpoint is drawn on the
JAX side and carried across by ``convert``; both packages pack their two
views from it.

The JAX side runs op by op (``jax.disable_jit``; its packing, integer work,
stays jitted): XLA's fusions under ``jit`` round its own norms and rotary
differently, enough to move a greedy token of this random model, and the
port follows the op-by-op arithmetic (``test_torch_lm_serve.py``).

Contract: the emitted tokens and the drafted and accepted counts equal the
JAX package's at k in {1, 3, 4}; the output equals the port's
verify-plan-only ``Generator``; ``decode_steps`` rows equal sequential
``decode_step`` calls bitwise, cache included, and the JAX package's
op-by-op ``decode_steps`` within the LM contract (2% of the largest
|logit|); the ``attn_impl='flash'`` verify (K4's plain version here) stays
within that contract of the default route.
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
from repro.runtime import specdec as jspecdec  # noqa: E402
from repro_torch import configs, convert  # noqa: E402
from repro_torch.core import plan as tplan  # noqa: E402
from repro_torch.runtime import telemetry  # noqa: E402
from repro_torch.runtime.serve import Generator, pack_for_serving  # noqa: E402
from repro_torch.runtime.specdec import (SpeculativeGenerator,  # noqa: E402
                                         _leading_matches)

PLANS = Path(__file__).resolve().parents[1] / "examples" / "plans"
DEPTH = 1
BATCH, PROMPT, NEW = 2, 5, 6
LOGIT_RTOL = 2e-2


def _np_tree(tree):
    return jax.tree.map(lambda a: np.array(a), tree)


def _f32(x):
    if isinstance(x, torch.Tensor):
        return x.to(torch.float32).numpy()
    return np.asarray(jnp.asarray(x).astype(jnp.float32))


def _plan(name, store):
    jp = jplan.PrecisionPlan.load(PLANS / name)
    jp = dataclasses.replace(jp, kv=dataclasses.replace(jp.kv, store=store))
    return jp, tplan.PrecisionPlan.from_json(jp.to_json())


@dataclasses.dataclass
class Case:
    store: str
    japi: object
    tapi: object
    jtrain: dict
    ttrain: dict
    jverify: object
    jdraft: object
    tverify: object
    tdraft: object
    prompts: np.ndarray


@pytest.fixture(scope="module")
def weights():
    japi = jconfigs.get("granite-8b", reduced=True)
    japi = dataclasses.replace(
        japi, cfg=dataclasses.replace(japi.cfg, n_layers=DEPTH))
    rng = np.random.default_rng(7)
    jtrain = japi.init_params(jax.random.PRNGKey(5), "train")
    ttrain = convert.from_jax_lm_train_params(_np_tree(jtrain), device="cpu")
    prompts = rng.integers(0, japi.cfg.vocab, (BATCH, PROMPT)).astype(
        np.int32)
    return japi, jtrain, ttrain, prompts


@pytest.fixture(scope="module", params=["packed", "qdq"])
def case(request, weights):
    japi, jtrain, ttrain, prompts = weights
    jverify, tverify = _plan("granite_8b_mixed.json", request.param)
    jdraft, tdraft = _plan("granite_8b_draft_w2.json", request.param)
    tapi = configs.get("granite-8b", reduced=True)
    tapi = dataclasses.replace(
        tapi, cfg=dataclasses.replace(tapi.cfg, n_layers=DEPTH))
    return Case(request.param, japi, tapi, jtrain, ttrain, jverify, jdraft,
                tverify, tdraft, prompts)


@pytest.fixture(scope="module")
def jax_runs(weights):
    """The JAX package's speculative generate at each k, op by op, under
    the packed store: {k: (tokens, drafted, accepted)}.  Its qdq store
    decodes the same bits (the JAX package's own rollback contract,
    ``tests/test_specdec.py``), so both of the port's stores are held
    against these runs.  Its packing, integer work, runs jitted: the same
    bits as op by op, in one compile instead of hundreds of eager ops."""
    japi, jtrain, _, prompts = weights
    jverify, _ = _plan("granite_8b_mixed.json", "packed")
    jdraft, _ = _plan("granite_8b_draft_w2.json", "packed")
    orig = jspecdec.pack_for_serving
    jspecdec.pack_for_serving = lambda api, params, mesh=None: jax.jit(
        lambda t: orig(api, t))(params)
    runs = {}
    try:
        for k in (1, 3, 4):
            jsg = jspecdec.SpeculativeGenerator(
                api=japi, train_params=jtrain, draft_plan=jdraft,
                verify_plan=jverify, k=k, max_len=PROMPT + NEW)
            with jax.disable_jit():
                toks = np.asarray(jsg.generate(prompts, NEW))
            runs[k] = (toks, jsg.drafted_tokens, jsg.accepted_tokens)
    finally:
        jspecdec.pack_for_serving = orig
    return runs


def _spec(case, draft, k, **kw):
    """The port's SpeculativeGenerator over the case's checkpoint, packed
    here under the verify plan (``api.policy``) and under ``draft``."""
    api = dataclasses.replace(case.tapi, policy=case.tverify)
    views = tuple(pack_for_serving(dataclasses.replace(api, policy=plan),
                                   case.ttrain)
                  for plan in (case.tverify, draft))
    return SpeculativeGenerator(api=api, packed_views=views,
                                draft_plan=draft, k=k, device="cpu", **kw)


def test_leading_matches():
    d = np.array([[1, 2, 3], [4, 9, 9], [7, 7, 7]])
    t = np.array([[1, 2, 0], [4, 9, 1], [7, 7, 7]])
    assert _leading_matches(d, t).tolist() == [2, 2, 3]
    assert _leading_matches(np.zeros((3, 0)),
                            np.zeros((3, 0))).tolist() == [0, 0, 0]


@pytest.mark.parametrize("k", [1, 3, 4])
def test_speculative_generate_matches_jax(case, k, jax_runs):
    want, drafted, accepted = jax_runs[k]
    sg = _spec(case, case.tdraft, k)
    got = sg.generate(case.prompts, NEW)
    np.testing.assert_array_equal(got, want)
    assert (sg.drafted_tokens, sg.accepted_tokens) == (drafted, accepted)
    assert sg.accept_rate == accepted / drafted
    # and the port's verify-plan-only Generator emits the same tokens
    gv = Generator(case.tapi, pack_for_serving(
        dataclasses.replace(case.tapi, policy=case.tverify), case.ttrain),
        plan=case.tverify, device="cpu")
    np.testing.assert_array_equal(gv.generate(case.prompts, NEW), got)


def test_decode_steps_equal_sequential_decode(case):
    """T rows of one verify forward == T decode_step calls, logits and
    cache bitwise; and within the LM contract of the JAX package's
    op-by-op decode_steps."""
    api = dataclasses.replace(case.tapi, policy=case.tverify)
    params = pack_for_serving(api, case.ttrain)
    gen = Generator(api, params, device="cpu")
    new = np.random.default_rng(9).integers(0, api.cfg.vocab, (BATCH, 4))
    toks = torch.as_tensor(case.prompts, dtype=torch.long)
    feed = torch.as_tensor(new, dtype=torch.long)
    with torch.inference_mode():
        _, pre = gen.prefill(toks)
        cache = gen._grow_cache(pre, BATCH, PROMPT, PROMPT + 8)
        seq_cache = gen._grow_cache(pre, BATCH, PROMPT, PROMPT + 8)
        seq = [api.decode_step(params, seq_cache, feed[:, t:t + 1],
                               PROMPT + t)[0] for t in range(4)]
        bat, cache = api.decode_steps(params, cache, feed, PROMPT)
    assert bat.shape == (BATCH, 4, api.cfg.vocab)
    assert torch.equal(bat, torch.stack(seq, dim=1))

    def leaves(tree):
        if isinstance(tree, dict):
            return [x for v in tree.values() for x in leaves(v)]
        if isinstance(tree, (list, tuple)):
            return [x for v in tree for x in leaves(v)]
        return [tree]
    assert all(torch.equal(a, b)
               for a, b in zip(leaves(cache), leaves(seq_cache)))

    japi = dataclasses.replace(case.japi, policy=case.jverify)
    jparams = jax.jit(lambda t: jserve.pack_for_serving(japi, t))(
        case.jtrain)
    jgen = jserve.Generator(japi, jparams, max_len=PROMPT + 8)
    with jax.disable_jit():
        _, jpre = jgen._prefill(jparams,
                                {"tokens": jnp.asarray(case.prompts)})
        jcache = jgen._grow_cache(jpre, BATCH, PROMPT, PROMPT + 8)
        jbat, _ = japi.decode_steps(jparams, jcache, jnp.asarray(new),
                                    jnp.asarray(PROMPT, jnp.int32))
    w = _f32(jbat)
    np.testing.assert_allclose(_f32(bat), w, rtol=0,
                               atol=LOGIT_RTOL * np.abs(w).max())


def test_flash_verify_within_contract(case):
    """The K4 route of the verify (its plain version on the CPU) against
    the default per-query route: the same attention within the packed-vs-
    qdq tolerance K4 is held to against K3 (3e-2 absolute plus relative:
    K4 reads code * s + z exactly, the per-query route its bf16 grid
    values).  ``decode_steps`` takes K4 once a layer for a packed cache,
    never for the qdq store."""
    from repro_torch.kernels.flashattn import kernel as fkernel
    from repro_torch.kernels.flashattn import ops as fops
    from repro_torch.models import transformer as T
    from repro_torch.nn import attention as attn
    from repro_torch.nn import kvcache
    api = dataclasses.replace(case.tapi, policy=case.tverify)
    params = pack_for_serving(api, case.ttrain)
    gen = Generator(api, params, device="cpu")
    feed = torch.as_tensor(np.random.default_rng(11).integers(
        0, api.cfg.vocab, (BATCH, 5)), dtype=torch.long)
    calls = []
    orig = fkernel.flash_fwd_packed_torch

    def counted(*a, **kw):
        calls.append(kw.get("q_offset"))
        return orig(*a, **kw)
    with torch.inference_mode():
        _, pre = gen.prefill(torch.as_tensor(case.prompts,
                                             dtype=torch.long))
        cache = gen._grow_cache(pre, BATCH, PROMPT, PROMPT + 8)
        fkernel.flash_fwd_packed_torch = counted
        try:
            logits, cache = api.decode_steps(params, cache, feed, PROMPT,
                                             attn_impl="flash")
        finally:
            fkernel.flash_fwd_packed_torch = orig
        assert calls == ([PROMPT] * api.cfg.n_layers
                         if case.store == "packed" else [])
        assert bool(torch.isfinite(logits.float()).all())
        if case.store != "packed":
            return
        # the two attention routes on the cache the verify just wrote
        fmt_k, fmt_v = T.kv_formats(api.cfg, api.policy)[1][0]
        ck, cv = cache[0]["k"], cache[0]["v"]
        q = torch.randn((BATCH, 5, api.cfg.n_heads, api.cfg.hd),
                        generator=torch.Generator().manual_seed(3)).to(
                            torch.bfloat16)
        flash = fops.flash_attention_packed(q, ck, cv, fmt_k, fmt_v,
                                            q_offset=PROMPT)
        per_query = torch.cat([attn.decode_attention_streamed(
            q[:, t:t + 1], ck, cv, fmt_k, fmt_v, PROMPT + 1 + t)
            for t in range(5)], dim=1)
        grid = torch.cat([attn.decode_attention_streamed(
            q[:, t:t + 1], kvcache.unpack_kv(ck, fmt_k),
            kvcache.unpack_kv(cv, fmt_v), None, None, PROMPT + 1 + t)
            for t in range(5)], dim=1)
    assert torch.equal(per_query, grid)
    w = per_query.float()
    assert bool(((flash.float() - w).abs() <= 3e-2 + 3e-2 * w.abs()).all())


def test_self_draft_accepts_everything(case):
    """Draft plan == verify plan: every proposal is the verify argmax."""
    sg = _spec(case, case.tverify, 4)
    sg.generate(case.prompts[:1], 9)
    assert sg.drafted_tokens > 0 and sg.accept_rate == 1.0


def test_telemetry_spans_and_metrics(case):
    tracer, metrics = telemetry.Tracer(), telemetry.MetricsRegistry()
    sg = _spec(case, case.tdraft, 3, tracer=tracer, metrics=metrics)
    sg.generate(case.prompts, NEW)
    names = {e[1] for e in tracer.events}
    assert {"prefill", "specdec.draft", "specdec.verify",
            "specdec.accept"} <= names
    accepts = [e[6] for e in tracer.events if e[1] == "specdec.accept"]
    assert sum(a["drafted"] for a in accepts) == sg.drafted_tokens
    assert sum(a["accepted"] for a in accepts) == sg.accepted_tokens
    rolled = sum(e[6]["rejected"] for e in tracer.events
                 if e[1] == "specdec.rollback")
    assert rolled == sg.drafted_tokens - sg.accepted_tokens
    assert metrics.counter("repro_specdec_drafted_total").value() == \
        sg.drafted_tokens
    assert metrics.counter("repro_specdec_accepted_total").value() == \
        sg.accepted_tokens
    assert metrics.gauge("repro_specdec_accept_rate").value() == \
        sg.accept_rate


def test_views_packed_by_the_caller():
    """``packed_views`` (verify, draft) drawn and packed layer by layer by
    ``init_packed_views`` serve as the ones ``pack_for_serving`` gives."""
    from repro_torch.runtime.serve import init_packed_views
    api = configs.get("granite-8b", reduced=True)
    _, verify = _plan("granite_8b_mixed.json", "packed")
    _, draft = _plan("granite_8b_draft_w2.json", "packed")
    api = dataclasses.replace(api, policy=verify)
    views = init_packed_views(api, [verify, draft],
                              torch.Generator().manual_seed(0), device="cpu")
    sg = SpeculativeGenerator(api=api, packed_views=tuple(views),
                              draft_plan=draft, k=2, device="cpu")
    prompts = np.arange(2 * PROMPT).reshape(2, PROMPT) % api.cfg.vocab
    out = sg.generate(prompts, 5)
    ref = Generator(api, views[0], device="cpu").generate(prompts, 5)
    np.testing.assert_array_equal(out, ref)
    with pytest.raises(ValueError, match="k must be >= 1"):
        SpeculativeGenerator(api=api, packed_views=tuple(views),
                             draft_plan=draft, k=0, device="cpu")
