"""The port's MLA (multi-head latent attention, deepseek) against the JAX
package's, at the reduced deepseek-v2-lite dims (kv_lora 32, qk 16 + 8,
v 16, 4 heads).

* ``mla_prefill``, ``mla_decode`` and ``mla_verify`` on the same packed
  weights (drawn and packed by the JAX package) and the same inputs give
  bitwise the JAX package's outputs and latent caches, run op by op
  (``jax.disable_jit``): the projections are exact integer products and the
  attention's f32 arithmetic follows the reference's op for op, the
  softmax scale rounded to bf16 first as JAX rounds a Python scalar.
* ``mla_verify`` over T tokens equals T sequential ``mla_decode`` steps
  bitwise, outputs and cache (the speculative verify's contract), and so
  does a whole reduced deepseek's and olmoe's ``decode_steps``.
* A plan that quantizes the KV cache raises for MLA, and for a dense-prefix
  stack, as the reference's does.
"""
import dataclasses

import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402
import numpy as np  # noqa: E402

from repro import configs as jconfigs  # noqa: E402
from repro.core import plan as jplan  # noqa: E402
from repro.models import transformer as JT  # noqa: E402
from repro.nn import attention as JA  # noqa: E402
from repro.nn import layers as JL  # noqa: E402
from repro.nn import param as jparam  # noqa: E402
from repro.nn import quantized as JQ  # noqa: E402
from repro_torch import configs, convert  # noqa: E402
from repro_torch.core import plan as tplan  # noqa: E402
from repro_torch.models import transformer as T  # noqa: E402
from repro_torch.nn import attention as TA  # noqa: E402
from repro_torch.nn import layers as TL  # noqa: E402
from repro_torch.runtime.serve import Generator, pack_for_serving  # noqa: E402

B, S, SMAX, T_NEW = 2, 11, 20, 4
TPOL = configs.get("deepseek-v2-lite-16b", reduced=True).policy


def _f32(x):
    if isinstance(x, torch.Tensor):
        return x.to(torch.float32).numpy()
    return np.asarray(jnp.asarray(x).astype(jnp.float32))


def _t(x):
    return torch.from_numpy(np.array(_f32(x))).to(torch.bfloat16)


@pytest.fixture(scope="module")
def mla():
    api = jconfigs.get("deepseek-v2-lite-16b", reduced=True)
    cfg = api.cfg
    m = cfg.mla
    kw = dict(n_heads=cfg.n_heads, kv_lora=m.kv_lora, qk_nope=m.qk_nope,
              qk_rope=m.qk_rope, v_head=m.v_head)
    spec = JA.mla_spec(cfg.d_model, cfg.n_heads, kv_lora=m.kv_lora,
                       qk_nope=m.qk_nope, qk_rope=m.qk_rope, v_head=m.v_head)
    rng = np.random.default_rng(4)
    train = jparam.init_params(spec, jax.random.PRNGKey(2))
    train = {k: ({kk: (jnp.asarray(rng.uniform(0.02, 0.06, np.shape(v)),
                                   jnp.float32) if kk in ("gw", "ga") else v)
                  for kk, v in sub.items()} if k != "kv_norm" else sub)
             for k, sub in train.items()}
    jp = jax.jit(lambda t: JQ.pack_tree(t, spec, api.policy))(train)
    tp = convert.from_jax_serve_tree(jax.tree.map(np.array, jp),
                                     device="cpu")
    x = rng.standard_normal((B, S + T_NEW, cfg.d_model)).astype(np.float32)
    return api, kw, jp, tp, jnp.asarray(x, jnp.bfloat16)


def _rot(cfg, pos, lib):
    if lib == "jax":
        return JL.rotary_cache(jnp.asarray(pos), cfg.mla.qk_rope,
                               cfg.rope_base)
    return TL.rotary_cache(torch.as_tensor(pos), cfg.mla.qk_rope,
                           cfg.rope_base)


def _positions(start, n):
    return np.broadcast_to(np.arange(start, start + n)[None], (B, n))


def test_prefill_decode_verify_bitwise_against_reference(mla):
    api, kw, jp, tp, x = mla
    cfg, pol = api.cfg, api.policy
    xs, xn = x[:, :S], x[:, S:]
    with jax.disable_jit():
        sin, cos = _rot(cfg, _positions(0, S), "jax")
        jo, (jc, jr) = JA.mla_prefill(jp, xs, pol, sin=sin, cos=cos,
                                      serve=True, impl="xla", chunk=8, **kw)
        c_cache = jnp.zeros((B, SMAX, cfg.mla.kv_lora), jnp.bfloat16)
        r_cache = jnp.zeros((B, SMAX, cfg.mla.qk_rope), jnp.bfloat16)
        c_cache = c_cache.at[:, :S].set(jc)
        r_cache = r_cache.at[:, :S].set(jr)
        sin1, cos1 = _rot(cfg, _positions(S, 1), "jax")
        jd, (jc1, jr1) = JA.mla_decode(jp, xn[:, :1], (c_cache, r_cache),
                                       jnp.asarray(S), pol, sin=sin1,
                                       cos=cos1, impl="xla", **kw)
        sinv, cosv = _rot(cfg, _positions(S, T_NEW), "jax")
        jv, (jcv, jrv) = JA.mla_verify(jp, xn, (c_cache, r_cache), S, pol,
                                       sin=sinv, cos=cosv, impl="xla", **kw)
    sin, cos = _rot(cfg, _positions(0, S), "torch")
    to, (tc, tr) = TA.mla_prefill(tp, _t(xs), TPOL, sin=sin, cos=cos,
                                  impl="torch", chunk=8, **kw)
    for got, want in ((to, jo), (tc, jc), (tr, jr)):
        np.testing.assert_array_equal(_f32(got), _f32(want))

    def fresh():
        c = torch.zeros((B, SMAX, cfg.mla.kv_lora), dtype=torch.bfloat16)
        r = torch.zeros((B, SMAX, cfg.mla.qk_rope), dtype=torch.bfloat16)
        c[:, :S], r[:, :S] = tc, tr
        return c, r
    sin1, cos1 = _rot(cfg, _positions(S, 1), "torch")
    td, (tc1, tr1) = TA.mla_decode(tp, _t(xn[:, :1]), fresh(), S, TPOL,
                                   sin=sin1, cos=cos1, impl="torch", **kw)
    for got, want in ((td, jd), (tc1, jc1), (tr1, jr1)):
        np.testing.assert_array_equal(_f32(got), _f32(want))
    sinv, cosv = _rot(cfg, _positions(S, T_NEW), "torch")
    tv, (tcv, trv) = TA.mla_verify(tp, _t(xn), fresh(), S, TPOL,
                                   sin=sinv, cos=cosv, impl="torch", **kw)
    for got, want in ((tv, jv), (tcv, jcv), (trv, jrv)):
        np.testing.assert_array_equal(_f32(got), _f32(want))


def test_verify_equals_sequential_decode_steps(mla):
    api, kw, _, tp, x = mla
    cfg, pol = api.cfg, TPOL
    sin, cos = _rot(cfg, _positions(0, S), "torch")
    _, (tc, tr) = TA.mla_prefill(tp, _t(x[:, :S]), pol, sin=sin, cos=cos,
                                 impl="torch", chunk=8, **kw)
    caches = []
    for _ in range(2):
        c = torch.zeros((B, SMAX, cfg.mla.kv_lora), dtype=torch.bfloat16)
        r = torch.zeros((B, SMAX, cfg.mla.qk_rope), dtype=torch.bfloat16)
        c[:, :S], r[:, :S] = tc, tr
        caches.append((c, r))
    xn = _t(x[:, S:])
    sinv, cosv = _rot(cfg, _positions(S, T_NEW), "torch")
    verify, vcache = TA.mla_verify(tp, xn, caches[0], S, pol, sin=sinv,
                                   cos=cosv, impl="torch", **kw)
    steps = []
    cache = caches[1]
    for t in range(T_NEW):
        o, cache = TA.mla_decode(tp, xn[:, t:t + 1], cache, S + t, pol,
                                 sin=sinv[:, t:t + 1], cos=cosv[:, t:t + 1],
                                 impl="torch", **kw)
        steps.append(o)
    assert torch.equal(verify, torch.cat(steps, dim=1))
    assert all(torch.equal(a, b) for a, b in zip(vcache, cache))


@pytest.mark.parametrize("arch", ["deepseek-v2-lite-16b", "olmoe-1b-7b"])
def test_model_decode_steps_equal_sequential_steps(arch):
    """A whole reduced model (deepseek: a dense first layer, MoE and MLA;
    olmoe: MoE and GQA): one verify forward of T tokens against T decode
    steps, logits and cache.  The MoE blocks route each verify token
    alone, as a decode step does."""
    api = configs.get(arch, reduced=True)
    params = api.init_params(torch.Generator().manual_seed(1), "train",
                             device="cpu")
    gen = Generator(api, pack_for_serving(api, params), device="cpu")
    toks = np.random.default_rng(0).integers(0, api.cfg.vocab, (B, S))
    with torch.inference_mode():
        _, pre = gen.prefill(torch.as_tensor(toks))
        c1 = gen._grow_cache(pre, B, S, SMAX)
        c2 = gen._grow_cache(pre, B, S, SMAX)
        feed = torch.as_tensor(np.random.default_rng(1).integers(
            0, api.cfg.vocab, (B, T_NEW)))
        bat, c1 = api.decode_steps(gen.params, c1, feed, S, impl="torch")
        seq = []
        for t in range(T_NEW):
            logits, c2 = api.decode_step(gen.params, c2, feed[:, t:t + 1],
                                         S + t, impl="torch")
            seq.append(logits)
    assert torch.equal(bat, torch.stack(seq, dim=1))
    for (a1, b1), (a2, b2) in zip(c1, c2):
        assert torch.equal(a1, a2) and torch.equal(b1, b2)


@pytest.mark.parametrize("arch", ["deepseek-v2-lite-16b",
                                  "olmoe-dense-prefix"])
def test_kv_plan_raises_as_reference(arch):
    kv = {"bits": 4, "k": 4, "store": "packed"}
    name = "deepseek-v2-lite-16b" if arch != "olmoe-dense-prefix" else \
        "olmoe-1b-7b"
    jcfg = jconfigs.get(name, reduced=True).cfg
    tcfg = configs.get(name, reduced=True).cfg
    if arch == "olmoe-dense-prefix":
        jcfg = dataclasses.replace(jcfg, dense_first_n=1, dense_ff=64)
        tcfg = dataclasses.replace(tcfg, dense_first_n=1, dense_ff=64)
    obj = {"version": 2, "name": "kv4", "arch": name, "a_bits": 8,
           "boundary_bits": 8, "variant": "st", "quantize": True,
           "default": {"w_bits": 4, "k": 4, "channel_wise": False,
                       "dataflow": "auto"}, "kv": kv, "layers": {}}
    jp = jplan.PrecisionPlan.from_json(obj)
    tp = tplan.PrecisionPlan.from_json(obj)
    with pytest.raises(ValueError) as jerr:
        JT.cache_specs(jcfg, 1, 8, jp)
    with pytest.raises(ValueError) as terr:
        T.cache_specs(tcfg, 1, 8, tp)
    assert str(terr.value) == str(jerr.value)
    with pytest.raises(ValueError):  # the gate every cache path asks
        T.kv_formats(tcfg, tp)
