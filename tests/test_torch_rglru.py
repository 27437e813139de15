"""The port's hybrid family (``nn.rglru``, ``models.recurrentgemma``) against
the JAX package's, at ``reduced=True``.

Contracts, against the JAX package run op by op (``jax.disable_jit``) on the
same numpy inputs unless a test says otherwise:

* ``associative_scan``: bitwise ``jax.lax.associative_scan`` of the
  linear recurrence at odd and even lengths; against the jitted scan,
  where XLA may contract ``a2 * b1 + b2`` into one FMA (ROADMAP R2),
  within 4 f32 ulps of each element's magnitude scale;
* one RG-LRU block on packed weights: the bf16 output bitwise, the f32
  state within 1e-5 of its largest magnitude (the transcendental gates
  differ in the last f32 bit); the gates within 1e-6;
* recurrentgemma end to end at S = 19 against window 8, so the decode
  steps run the ring buffer past its wrap: prefill logits, the per-layer
  prefill cache and four greedy decode steps -- logits within 2% of the
  largest |logit| (bitwise in practice), equal tokens, the ring hand-off
  bitwise the reference's ``Generator._rg_cache``;
* the plain K3 (``flash_fwd_torch``) at head dim 256 with a window and one
  KV head against the reference's Pallas ``flash_fwd`` in interpret mode,
  within one bf16 ulp (plus 1e-5 near zero).
"""
import dataclasses

import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402
import numpy as np  # noqa: E402

from repro import configs as jconfigs  # noqa: E402
from repro.kernels.flashattn import ops as jflash  # noqa: E402
from repro.nn import rglru as jrglru  # noqa: E402
from repro.runtime import serve as jserve  # noqa: E402
from repro_torch import configs, convert  # noqa: E402
from repro_torch.kernels.flashattn import ops as flash  # noqa: E402
from repro_torch.launch import serve as launch  # noqa: E402
from repro_torch.models import recurrentgemma as RG  # noqa: E402
from repro_torch.nn import rglru  # noqa: E402
from repro_torch.runtime.scheduler import GenerateScheduler  # noqa: E402
from repro_torch.runtime.serve import Generator, pack_for_serving  # noqa

ARCH = "recurrentgemma-9b"
LOGIT_RTOL = 2e-2
STATE_RTOL = 1e-5
BATCH, PROMPT, NEW = 2, 19, 5


def np_tree(tree):
    return jax.tree.map(lambda a: np.array(a), tree)


def f32(x):
    if isinstance(x, torch.Tensor):
        return x.detach().to(torch.float32).numpy()
    return np.asarray(jnp.asarray(x).astype(jnp.float32))


def rel(a, b):
    a, b = f32(a), f32(b)
    return float(np.abs(a - b).max() / np.abs(b).max())


def randomize(tree, rng):
    """Non-trivial LSQ steps, conv biases and RG-LRU ``lam``."""
    if isinstance(tree, dict):
        out = {}
        for k, v in tree.items():
            if k in ("gw", "ga"):
                out[k] = jnp.asarray(rng.uniform(0.02, 0.06, np.shape(v)),
                                     jnp.float32)
            elif k in ("lam", "b"):
                out[k] = jnp.asarray(rng.normal(0, 0.5, np.shape(v)),
                                     jnp.float32)
            else:
                out[k] = randomize(v, rng)
        return out
    return tree


@pytest.fixture(scope="module")
def model():
    japi = jconfigs.get(ARCH, reduced=True)
    tapi = configs.get(ARCH, reduced=True)
    rng = np.random.default_rng(13)
    jtrain = randomize(japi.init_params(jax.random.PRNGKey(5), "train"), rng)
    jpacked = jax.jit(lambda t: jserve.pack_for_serving(japi, t))(jtrain)
    packed = convert.from_jax_lm_serve_tree(np_tree(jpacked), device="cpu")
    return japi, tapi, jtrain, jpacked, packed


@pytest.mark.parametrize("reduced", [False, True])
def test_config_api_and_workload_equal(reduced):
    j = jconfigs.get(ARCH, reduced=reduced)
    t = configs.get(ARCH, reduced=reduced)
    assert dataclasses.asdict(t.cfg) == dataclasses.asdict(j.cfg)
    assert (t.name, t.family, t.microbatches, t.long_context_ok,
            t.needs_frames) == (j.name, j.family, j.microbatches,
                                j.long_context_ok, j.needs_frames)
    assert t.plan_layer_names() == j.plan_layer_names()
    for tokens in (1, 64, 4096):
        assert [dataclasses.astuple(g) for g in t.gemm_workload(tokens)] == \
            [dataclasses.astuple(g) for g in j.gemm_workload(tokens)]
    assert t.active_params() == j.active_params()
    assert t.param_class_counts() == j.param_class_counts()
    kinds = [RG.layer_kind(t.cfg, i) for i in range(t.cfg.n_layers)]
    assert kinds.count("A") == t.cfg.n_super
    assert kinds[:3] == ["R", "R", "A"] and kinds[-1] == "R"


def _scan_inputs(n, seed):
    rng = np.random.default_rng(seed)
    a = rng.uniform(0.2, 1.0, (2, n, 24)).astype(np.float32)
    b = rng.normal(0, 1, (2, n, 24)).astype(np.float32)
    return a, b


def _jcombine(left, right):
    a1, b1 = left
    a2, b2 = right
    return a1 * a2, a2 * b1 + b2


@pytest.mark.parametrize("n", [1, 2, 7, 16, 37])
def test_associative_scan_bitwise_op_by_op(n):
    a, b = _scan_inputs(n, n)
    with jax.disable_jit():
        ja, jb = jax.lax.associative_scan(_jcombine, (jnp.asarray(a),
                                                      jnp.asarray(b)), axis=1)
    ta, tb = rglru.associative_scan(rglru.linear_combine,
                                    [torch.as_tensor(a), torch.as_tensor(b)],
                                    axis=1)
    np.testing.assert_array_equal(ta.numpy(), np.asarray(ja))
    np.testing.assert_array_equal(tb.numpy(), np.asarray(jb))


def test_associative_scan_against_jit_within_fma_bound():
    a, b = _scan_inputs(37, 1)
    ja, jb = jax.jit(lambda x, y: jax.lax.associative_scan(
        _jcombine, (x, y), axis=1))(jnp.asarray(a), jnp.asarray(b))
    ta, tb = rglru.associative_scan(rglru.linear_combine,
                                    [torch.as_tensor(a), torch.as_tensor(b)],
                                    axis=1)
    np.testing.assert_array_equal(ta.numpy(), np.asarray(ja))
    scale = np.abs(b).max() / (1 - 0.999)  # a bound on |h| and its terms
    ulp = np.spacing(np.float32(scale))
    assert np.abs(tb.numpy() - np.asarray(jb)).max() <= 4 * ulp


def test_rglru_block_matches_jax(model):
    japi, tapi, _, jpacked, packed = model
    cfg = tapi.cfg.rnn
    jp = jax.tree.map(lambda x: x[0], jpacked["supers"]["r1"]["rnn"])
    tp = packed["layers"][0]["rnn"]
    rng = np.random.default_rng(3)
    x = rng.normal(0, 1, (BATCH, 11, cfg.d_model)).astype(np.float32)
    jx = jnp.asarray(x).astype(jnp.bfloat16)
    tx = torch.as_tensor(x).to(torch.bfloat16)
    with jax.disable_jit():
        jout, jst = jrglru.rglru_block_forward(jp, jx, japi.policy, cfg,
                                               serve=True)
        jga, jgb = jrglru._gates(jp, jx, japi.policy, True, "xla")
        jo1, jst1 = jrglru.rglru_block_step(jp, jx[:, :1], jst, japi.policy,
                                            cfg)
    out, st = rglru.rglru_block_forward(tp, tx, tapi.policy, cfg)
    np.testing.assert_array_equal(f32(out), f32(jout))
    for key in ("h", "conv"):
        assert rel(st[key], jst[key]) <= STATE_RTOL, key
    ga, gb = rglru._gates(tp, tx, tapi.policy, "auto")
    assert rel(ga, jga) <= 1e-6 and rel(gb, jgb) <= 1e-6
    o1, st1 = rglru.rglru_block_step(tp, tx[:, :1], st, tapi.policy, cfg)
    np.testing.assert_allclose(f32(o1), f32(jo1), rtol=0,
                               atol=LOGIT_RTOL * np.abs(f32(jo1)).max())
    assert rel(st1["h"], jst1["h"]) <= STATE_RTOL


def test_pack_for_serving_matches(model):
    _, tapi, jtrain, _, packed = model
    train = convert.from_jax_lm_train_params(np_tree(jtrain), device="cpu")
    assert len(train["layers"]) == tapi.cfg.n_layers
    mine = pack_for_serving(tapi, train)
    leaves = lambda t: jax.tree_util.tree_leaves(  # noqa: E731
        jax.tree.map(f32, t, is_leaf=lambda x: isinstance(x, torch.Tensor)))
    assert len(leaves(mine)) == len(leaves(packed))
    for x, y in zip(leaves(mine), leaves(packed)):
        np.testing.assert_allclose(x, y, rtol=1e-6)


def test_prefill_ring_handoff_and_decode_match_jax(model):
    japi, tapi, _, jpacked, packed = model
    cfg = tapi.cfg
    assert PROMPT > cfg.window  # decode runs the ring past its wrap
    tokens = np.random.default_rng(2).integers(0, cfg.vocab,
                                               (BATCH, PROMPT))
    gen = jserve.Generator(japi, jpacked)
    with jax.disable_jit():
        logits, pre = gen._prefill(jpacked, {"tokens": jnp.asarray(tokens)})
        cache = gen._grow_cache(pre, BATCH, PROMPT, PROMPT + NEW)
        ring0 = cache
        jlogits, jtoks = [logits], [np.asarray(jnp.argmax(logits, -1))]
        for i in range(NEW - 1):
            logits, cache = gen._decode(jpacked, cache,
                                        jnp.asarray(jtoks[-1][:, None]),
                                        jnp.asarray(PROMPT + i, jnp.int32))
            jlogits.append(logits)
            jtoks.append(np.asarray(jnp.argmax(logits, -1)))
    tgen = Generator(tapi, packed, device="cpu")
    toks, tlogits = tgen.run(tokens, NEW)
    np.testing.assert_array_equal(toks, np.stack(jtoks, axis=1))
    for got, want in zip(tlogits, jlogits):
        g, w = f32(got), f32(want)
        assert g.shape == w.shape == (BATCH, cfg.vocab)
        np.testing.assert_allclose(g, w, rtol=0,
                                   atol=LOGIT_RTOL * np.abs(w).max())
    with torch.inference_mode():
        _, tpre = tgen.prefill(torch.as_tensor(tokens))
        ring = tgen._grow_cache(tpre, BATCH, PROMPT, PROMPT + NEW)
    (st1, st2, kv), rem = pre
    for j in range(cfg.n_super):
        for r, jst in ((0, st1), (1, st2)):
            for key in ("h", "conv"):
                assert rel(tpre[3 * j + r][key], jst[key][j]) <= STATE_RTOL
        for t_kv, j_kv in zip(tpre[3 * j + 2], kv):
            np.testing.assert_array_equal(f32(t_kv), f32(j_kv[j]))
        for t_ring, key in zip(ring[3 * j + 2], ("k", "v")):
            assert t_ring.shape[1] == cfg.window
            np.testing.assert_array_equal(f32(t_ring), f32(ring0[key][j]))
    for i in range(cfg.n_rem):
        for key in ("h", "conv"):
            assert rel(tpre[3 * cfg.n_super + i][key], rem[i][key]) <= \
                STATE_RTOL


def test_scheduler_tickets_equal_requests_alone(model):
    _, tapi, _, _, packed = model
    gen = Generator(tapi, packed, device="cpu")
    rng = np.random.default_rng(6)
    reqs = [(rng.integers(0, tapi.cfg.vocab, n), k)
            for n, k in ((12, 4), (12, 3), (7, 5), (12, 2))]
    alone = [gen.generate(p[None], k)[0] for p, k in reqs]
    s = GenerateScheduler(gen, slots=3, max_len=17)
    tickets = [s.submit(p, k) for p, k in reqs]
    while s.pending or s.active:
        s.step(flush=True)
    for tk, want in zip(tickets, alone):
        np.testing.assert_array_equal(tk.result, want)


@pytest.mark.parametrize("kw", [dict(sq=40, sk=40, window=16),
                                dict(sq=9, sk=41, q_offset=32, window=12)])
def test_plain_k3_at_head_dim_256_matches_jax(kw):
    """recurrentgemma's attention shape: 4 query heads on one KV head at
    D 256, bf16, causal with a window."""
    kw = dict(kw)
    sq, sk = kw.pop("sq"), kw.pop("sk")
    rng = np.random.default_rng(sq + sk)
    mk = lambda s, h: rng.normal(size=(1, s, h, 256)).astype(  # noqa: E731
        np.float32)
    arrs = [mk(sq, 4), mk(sk, 1), mk(sk, 1)]
    jq, jk, jv = (jnp.asarray(a, jnp.bfloat16) for a in arrs)
    q, k, v = (torch.from_numpy(np.asarray(x.astype(jnp.float32))).to(
        torch.bfloat16) for x in (jq, jk, jv))
    want = f32(jflash.flash_attention(jq, jk, jv, block_q=16, block_k=16,
                                      **kw))
    got = flash.flash_attention(q, k, v, block_k=16, impl="torch", **kw)
    assert got.dtype == torch.bfloat16
    g = f32(got)
    _, e = np.frexp(np.maximum(np.maximum(np.abs(g), np.abs(want)),
                               2.0 ** -126))
    bound = np.ldexp(1.0, e - 8) + 1e-5
    assert (np.abs(g - want) <= bound).all()


def test_launch_serve_on_cpu(capsys):
    assert launch.main(["--arch", ARCH, "--reduced", "--device", "cpu",
                        "--batch", "2", "--prompt-len", "11",
                        "--new-tokens", "3"]) == 0
    assert "tok/s" in capsys.readouterr().out
