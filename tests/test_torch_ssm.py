"""The port's SSM family (``nn.ssm``, ``models.mamba2``) against the JAX
package's, at ``reduced=True``.

Contracts, each against the JAX package run op by op (``jax.disable_jit``)
on the same numpy inputs:

* the causal conv's two forms (``nn.layers.causal_conv1d`` and its decode
  step) bitwise, each mirroring its own reference form;
* one SSD block on packed weights: the projections' int8 codes and int32
  accumulators bitwise, the block's bf16 output bitwise, its f32 state
  within 1e-5 of its largest magnitude (einsum sum order), and the decode
  step the same;
* mamba2 end to end at S = 16 (a multiple of ``chunk``, where the
  reference's state is right): prefill logits, the per-layer prefill
  state and four greedy decode steps -- logits within 2% of the largest
  |logit| (the LM contract; bitwise in practice) and equal tokens;
* R6: at S = 13 the reference's padded prefill returns the state after
  its pad tokens.  Its own ``ssd_forward`` with ``chunk = 13`` (no
  padding) is the correct state; the port's prefill holds it within 1e-5
  of its largest magnitude (the conv cache bitwise), the reference's
  padded prefill is more than 0.5 away from it, and the port's state is
  within ``STEP_TOL`` of feeding the prompt token by token through
  ``decode_step`` (the reference's own prefill-against-step gap is about
  0.02 at S = 16).
"""
import dataclasses
from pathlib import Path

import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402
import numpy as np  # noqa: E402

from repro import configs as jconfigs  # noqa: E402
from repro.kernels.mpmm import ops as jops  # noqa: E402
from repro.models import mamba2 as JM  # noqa: E402
from repro.nn import layers as jlayers  # noqa: E402
from repro.nn import ssm as jssm  # noqa: E402
from repro.runtime import serve as jserve  # noqa: E402
from repro_torch import configs, convert  # noqa: E402
from repro_torch.kernels.mpmm import kernel, ops  # noqa: E402
from repro_torch.core.packing import PlaneFormat  # noqa: E402
from repro_torch.launch import serve as launch  # noqa: E402
from repro_torch.models import mamba2 as M  # noqa: E402
from repro_torch.nn import layers, ssm  # noqa: E402
from repro_torch.runtime.serve import Generator, pack_for_serving  # noqa

ROOT = Path(__file__).resolve().parents[1]
ARCH = "mamba2-1.3b"
LOGIT_RTOL = 2e-2
STATE_RTOL = 1e-5
R6_RTOL = 1e-5
STEP_TOL = 0.1
BATCH, NEW = 2, 5


def np_tree(tree):
    return jax.tree.map(lambda a: np.array(a), tree)


def f32(x):
    if isinstance(x, torch.Tensor):
        return x.detach().to(torch.float32).numpy()
    return np.asarray(jnp.asarray(x).astype(jnp.float32))


def rel(a, b):
    a, b = f32(a), f32(b)
    return float(np.abs(a - b).max() / np.abs(b).max())


def bf16_pair(rng, shape, scale=1.0):
    x = (rng.normal(0, scale, shape)).astype(np.float32)
    return (jnp.asarray(x).astype(jnp.bfloat16),
            torch.as_tensor(x).to(torch.bfloat16))


def randomize(tree, rng):
    """Non-trivial LSQ steps and SSM parameters, from numpy."""
    if isinstance(tree, dict):
        out = {}
        for k, v in tree.items():
            if k in ("gw", "ga"):
                out[k] = jnp.asarray(rng.uniform(0.02, 0.06, np.shape(v)),
                                     jnp.float32)
            elif k in ("A_log", "dt_bias", "b"):
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
    rng = np.random.default_rng(11)
    jtrain = randomize(japi.init_params(jax.random.PRNGKey(3), "train"), rng)
    jpacked = jax.jit(lambda t: jserve.pack_for_serving(japi, t))(jtrain)
    packed = convert.from_jax_lm_serve_tree(np_tree(jpacked), device="cpu")
    return japi, tapi, jtrain, jpacked, packed


# --- configs and the workload ------------------------------------------------


@pytest.mark.parametrize("reduced", [False, True])
def test_config_api_and_workload_equal(reduced):
    j = jconfigs.get(ARCH, reduced=reduced)
    t = configs.get(ARCH, reduced=reduced)
    assert dataclasses.asdict(t.cfg) == dataclasses.asdict(j.cfg)
    assert (t.name, t.family, t.microbatches, t.long_context_ok,
            t.needs_frames) == (j.name, j.family, j.microbatches,
                                j.long_context_ok, j.needs_frames)
    assert t.plan_layer_names() == j.plan_layer_names()
    assert t.kv_layer_names() == j.kv_layer_names() == []
    for tokens in (1, 64, 4096):
        assert [dataclasses.astuple(g) for g in t.gemm_workload(tokens)] == \
            [dataclasses.astuple(g) for g in j.gemm_workload(tokens)]
    assert t.active_params() == j.active_params()
    assert t.param_class_counts() == j.param_class_counts()


def test_k1_routes_and_split_plans_at_the_new_shapes():
    """in_dt's N 64 and recurrentgemma's MQA k/v N 256 on both routes:
    route B's chunks cover K exactly, none empty, at every format."""
    for kdim, n in ((2048, 64), (4096, 256), (512, 512)):
        for m in (4, 2, 4096):
            route = kernel.mpmm_route(m, kdim, n)
            assert route == ("splitk" if m <= 16 else "wgmma")
            for w, k in ((4, 4), (2, 2), (8, 4), (1, 1)):
                fmt = PlaneFormat(w_bits=w, k=k, k_dim=kdim)
                plan = kernel.split_plan(m, kdim, n, fmt)
                ranges = plan.digit_ranges(fmt)
                assert ranges[0][0] == 0 and ranges[-1][1] == kdim
                assert all(b > a for a, b in ranges)
                assert all(r[1] == s[0] for r, s in zip(ranges, ranges[1:]))


# --- the causal conv ---------------------------------------------------------


def test_causal_conv1d_forms_bitwise():
    rng = np.random.default_rng(0)
    jx, tx = bf16_pair(rng, (2, 37, 48), 2.0)
    w = rng.normal(0, 0.5, (4, 48)).astype(np.float32)
    b = rng.normal(0, 0.1, (48,)).astype(np.float32)
    jp = {"w": jnp.asarray(w), "b": jnp.asarray(b)}
    tp = {"w": torch.as_tensor(w), "b": torch.as_tensor(b)}
    with jax.disable_jit():
        want = jlayers.causal_conv1d(jp, jx)
        jc, jy = jlayers.causal_conv1d_step(jp, jx[:, -3:], jx[:, 5])
    np.testing.assert_array_equal(f32(layers.causal_conv1d(tp, tx)),
                                  f32(want))
    tc, ty = layers.causal_conv1d_step(tp, tx[:, -3:], tx[:, 5])
    np.testing.assert_array_equal(f32(tc), f32(jc))
    np.testing.assert_array_equal(f32(ty), f32(jy))


# --- one SSD block -----------------------------------------------------------


def test_ssd_block_and_step_match_jax(model):
    japi, tapi, _, jpacked, packed = model
    cfg = tapi.cfg.ssm
    jp = jax.tree.map(lambda a: a[0], jpacked["layers"]["ssm"])
    tp = packed["layers"][0]["ssm"]
    rng = np.random.default_rng(1)
    jx, tx = bf16_pair(rng, (BATCH, 2 * cfg.chunk, cfg.d_model))
    # the first projection's codes and int32 accumulators, bitwise
    fmt = PlaneFormat(w_bits=4, k=4, k_dim=cfg.d_model)
    a = ops.quantize_activations(tx, tp["in_xbc"]["ga"], 8)
    ja = jops.quantize_activations(jx, jp["in_xbc"]["ga"], 8)
    np.testing.assert_array_equal(a.numpy(), np.asarray(ja))
    from repro_torch.kernels.mpmm import ref
    acc = ref.mpmm_ref_codes(a.reshape(-1, cfg.d_model),
                             tp["in_xbc"]["planes"], fmt, act_zero=128)
    from repro.kernels.mpmm import ref as jref
    from repro.core.packing import PlaneFormat as JFormat
    jacc = jref.mpmm_ref_codes(ja.reshape(-1, cfg.d_model),
                               jp["in_xbc"]["planes"],
                               JFormat(4, 4, cfg.d_model), act_zero=128)
    np.testing.assert_array_equal(acc.numpy(), np.asarray(jacc))
    with jax.disable_jit():
        jout, jst = jssm.ssd_forward(jp, jx, japi.policy, cfg, serve=True)
        jo1, jst1 = jssm.ssd_decode_step(jp, jx[:, :1], jst, japi.policy,
                                         cfg)
    out, st = ssm.ssd_forward(tp, tx, tapi.policy, cfg)
    np.testing.assert_array_equal(f32(out), f32(jout))
    for key in ("ssm", "conv"):
        assert rel(st[key], jst[key]) <= STATE_RTOL, key
    o1, st1 = ssm.ssd_decode_step(tp, tx[:, :1], st, tapi.policy, cfg)
    np.testing.assert_allclose(f32(o1), f32(jo1), rtol=0,
                               atol=LOGIT_RTOL * np.abs(f32(jo1)).max())
    for key in ("ssm", "conv"):
        assert rel(st1[key], jst1[key]) <= 1e-3, key


# --- mamba2 end to end -------------------------------------------------------


def test_pack_for_serving_matches(model):
    _, tapi, jtrain, _, packed = model
    train = convert.from_jax_lm_train_params(np_tree(jtrain), device="cpu")
    assert len(train["layers"]) == tapi.cfg.n_layers
    mine = pack_for_serving(tapi, train)
    flat = lambda t: jax.tree_util.tree_leaves(  # noqa: E731
        jax.tree.map(f32, t, is_leaf=lambda x: isinstance(x, torch.Tensor)))
    assert len(flat(mine)) == len(flat(packed))
    for x, y in zip(flat(mine), flat(packed)):
        np.testing.assert_allclose(x, y, rtol=1e-6)


def test_prefill_cache_and_decode_match_jax(model):
    japi, tapi, _, jpacked, packed = model
    s = tapi.cfg.ssm.chunk  # S % chunk == 0: the reference's state is right
    tokens = np.random.default_rng(2).integers(0, japi.cfg.vocab, (BATCH, s))
    gen = jserve.Generator(japi, jpacked)
    with jax.disable_jit():
        logits, pre = gen._prefill(jpacked, {"tokens": jnp.asarray(tokens)})
        cache = gen._grow_cache(pre, BATCH, s, s + NEW)
        jlogits, jtoks = [logits], [np.asarray(jnp.argmax(logits, -1))]
        for i in range(NEW - 1):
            logits, cache = gen._decode(jpacked, cache,
                                        jnp.asarray(jtoks[-1][:, None]),
                                        jnp.asarray(s + i, jnp.int32))
            jlogits.append(logits)
            jtoks.append(np.asarray(jnp.argmax(logits, -1)))
    tgen = Generator(tapi, packed, device="cpu")
    toks, tlogits = tgen.run(tokens, NEW)
    np.testing.assert_array_equal(toks, np.stack(jtoks, axis=1))
    for got, want in zip(tlogits, jlogits):
        g, w = f32(got), f32(want)
        assert g.shape == w.shape == (BATCH, japi.cfg.vocab)
        np.testing.assert_allclose(g, w, rtol=0,
                                   atol=LOGIT_RTOL * np.abs(w).max())
    with torch.inference_mode():
        _, tpre = tgen.prefill(torch.as_tensor(tokens))
    for i, st in enumerate(tpre):
        for key in ("ssm", "conv"):
            assert rel(st[key], pre[key][i]) <= STATE_RTOL, (i, key)


@pytest.fixture(scope="module")
def r6_states(model):
    """(the reference's chunk = 13 oracle, its padded prefill, the port's
    prefill, the port's token-by-token state) at S = 13."""
    s = 13
    assert s % model[1].cfg.ssm.chunk
    japi, tapi, _, jpacked, packed = model
    tokens = np.random.default_rng(4).integers(0, japi.cfg.vocab, (BATCH, s))
    oracle_cfg = dataclasses.replace(
        japi.cfg, ssm=dataclasses.replace(japi.cfg.ssm, chunk=s))
    with jax.disable_jit():
        _, oracle = JM.prefill(oracle_cfg, jpacked, jnp.asarray(tokens),
                               japi.policy)
        _, padded = JM.prefill(japi.cfg, jpacked, jnp.asarray(tokens),
                               japi.policy)
    with torch.inference_mode():
        _, mine = M.prefill(tapi.cfg, packed, torch.as_tensor(tokens),
                            tapi.policy)
        steps = [{k: torch.zeros(sp.shape) for k, sp in st.items()}
                 for st in M.cache_specs(tapi.cfg, BATCH, s)]
        for t in range(s):
            _, steps = M.decode_step(tapi.cfg, packed, steps,
                                     torch.as_tensor(tokens[:, t:t + 1]), t,
                                     tapi.policy)
    return oracle, padded, mine, steps


def test_r6_prefill_state_is_the_unpadded_state(r6_states):
    oracle, _, mine, steps = r6_states
    for i, st in enumerate(mine):
        assert rel(st["ssm"], oracle["ssm"][i]) <= R6_RTOL, i
        np.testing.assert_array_equal(f32(st["conv"]), f32(oracle["conv"][i]))
        for key in ("ssm", "conv"):
            assert rel(st[key], steps[i][key]) <= STEP_TOL, (i, key)


def test_r6_reference_pads_reach_its_state(model, r6_states):
    """The reference's own padded prefill at S = 13 returns the state after
    its pads: far from its chunk = 13 oracle, its conv cache the pads'
    rows (zeros in the first layer, whose pads are zero embeddings)."""
    oracle, padded, _, _ = r6_states
    assert not np.any(f32(padded["conv"][0]))
    for i in range(model[1].cfg.n_layers):
        assert rel(padded["ssm"][i], oracle["ssm"][i]) > 0.5, i
        assert rel(padded["conv"][i], oracle["conv"][i]) > 0.5, i


def test_launch_serve_on_cpu(capsys):
    assert launch.main(["--arch", ARCH, "--reduced", "--device", "cpu",
                        "--batch", "2", "--prompt-len", "13",
                        "--new-tokens", "3"]) == 0
    assert "tok/s" in capsys.readouterr().out


def test_spec_decode_is_refused():
    with pytest.raises(NotImplementedError, match="multi-token decode_steps"):
        launch.main(["--arch", ARCH, "--reduced", "--device", "cpu",
                     "--spec-decode", "2", "--draft-plan",
                     str(ROOT / "examples/plans/granite_8b_draft_w2.json")])
