"""The port's recurrentgemma QAT train path (``nn.rglru`` with
``serve=False``, ``models.recurrentgemma.forward``, the train-mode cache
path) against the JAX package's, op by op (``jax.disable_jit``), at
``reduced=True`` on weights drawn in numpy; and
``convert.from_jax_train_state`` for the three families whose layer stack
is not ``layers`` alone.

Contracts, and why:

* ``associative_scan``'s vjp (f32, a cotangent on both outputs, odd and
  even lengths) bitwise ``jax.vjp`` of ``jax.lax.associative_scan``: the
  copies into strided views go back as slices, as JAX's interleave (pads
  and an add) does, and each element's cotangent takes the same terms in
  the same order.
* One RG-LRU block's vjp (B 2, S 19, a cotangent on its output and on its
  final state): the output bitwise, the state within 1e-5 of its largest
  value; x and every projection weight within one bf16 ulp, at most 0.1%
  of a leaf off; the conv's taps and bias bitwise; ``lam`` (an f32 sum
  over B x S of terms that pass through ``exp``, ``sqrt`` and
  ``softplus``, which round differently in the two libraries) within
  1e-5 of its largest |value|; the step sizes as ``test_torch_ssm_train``
  holds them.
* recurrentgemma's train-mode and serve-mode ``forward`` logits over 19
  tokens, past the window of 8, bitwise (the serve mode's attention is
  the reference's 'xla' route here; on a card it is K3).
* One whole ``make_train_step`` (2 x 19 tokens): the loss within 1e-6,
  every gradient leaf within 2e-2 of its largest |value| (the worst
  printed), ``lam`` and the conv's gradients nonzero, the step sizes by
  their mass.  Remat (one checkpoint a superblock) off and on: bitwise.
* ``prefill(mode="train")``'s last logits bitwise ``forward(mode=
  "train")``'s last position; its last logits and cache against the
  reference's (R states within 1e-5, A's K/V bitwise), and three
  train-mode decode steps on the ring cache bitwise.
* ``convert.from_jax_train_state`` of a reference train state (mamba2,
  recurrentgemma, whisper at ``reduced=True``, moments drawn nonzero)
  gives per-layer lists, the parameters and both moments leaf by leaf
  equal to ``from_jax_lm_train_params``'s of each.
* ``launch.train`` then ``launch.serve --ckpt-dir``.
"""
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402
import numpy as np  # noqa: E402

from repro import configs as jconfigs  # noqa: E402
from repro.launch import steps as JS  # noqa: E402
from repro.nn import rglru as jrglru  # noqa: E402
from repro.runtime import serve as jserve  # noqa: E402
from repro_torch import configs, convert  # noqa: E402
from repro_torch.models import recurrentgemma as RG  # noqa: E402
from repro_torch.nn import rglru as trglru  # noqa: E402
from repro_torch.tree import flatten_with_paths  # noqa: E402
from test_torch_moe_train import draw  # noqa: E402
from test_torch_ssm_train import (assert_same_runs, check_block_grads,  # noqa
                                  check_step, remat_runs, run_launchers,
                                  step_batch, vjp_block)
from test_torch_train_step import (_f32, _leaf_err, _step_case,  # noqa: E402
                                   np_params)

ARCH = "recurrentgemma-9b"
B, S = 2, 19
PROMPT, DECODE_T = S, 3  # the prompt is the forward's tokens
RNN_LEAVES = ("['lam']", "['conv']['w']", "['conv']['b']")


@pytest.fixture(autouse=True, scope="module")
def _one_thread():
    """Small tensors: torch's CPU thread pool costs more than it saves."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _jcombine(left, right):
    a1, b1 = left
    a2, b2 = right
    return a1 * a2, a2 * b1 + b2


@pytest.mark.parametrize("n", [2, 7, 16, 37])
def test_associative_scan_vjp_bitwise(n):
    rng = np.random.default_rng(n)
    a = rng.uniform(0.2, 1.0, (2, n, 24)).astype(np.float32)
    b = rng.normal(0, 1, (2, n, 24)).astype(np.float32)
    ca, cb = (rng.normal(0, 1, (2, n, 24)).astype(np.float32)
              for _ in range(2))
    with jax.disable_jit():
        _, vjp = jax.vjp(lambda x, y: jax.lax.associative_scan(
            _jcombine, (x, y), axis=1), jnp.asarray(a), jnp.asarray(b))
        ga, gb = vjp((jnp.asarray(ca), jnp.asarray(cb)))
    ta, tb = (torch.tensor(v, requires_grad=True) for v in (a, b))
    oa, ob = trglru.associative_scan(trglru.linear_combine, [ta, tb], axis=1)
    gta, gtb = torch.autograd.grad([oa, ob], [ta, tb],
                                   [torch.from_numpy(ca),
                                    torch.from_numpy(cb)])
    np.testing.assert_array_equal(gta.numpy(), np.asarray(ga))
    np.testing.assert_array_equal(gtb.numpy(), np.asarray(gb))


# --- one RG-LRU block ----------------------------------------------------------


@pytest.fixture(scope="module")
def rglru_block():
    japi = jconfigs.get(ARCH, reduced=True)
    tapi = configs.get(ARCH, reduced=True)
    jcfg = japi.cfg.rnn
    rng = np.random.default_rng(3)
    params = draw(jrglru.rglru_block_spec(jcfg, serve=False), rng)
    params["lam"] = rng.uniform(0.3, 1.2, params["lam"].shape).astype(
        np.float32)
    x = rng.standard_normal((B, S, jcfg.d_model)).astype(np.float32)
    cts = (rng.standard_normal((B, S, jcfg.d_model)).astype(np.float32),
           rng.standard_normal((B, jcfg.d_rnn)).astype(np.float32))

    def jfn(p, xx):
        y, st = jrglru.rglru_block_forward(p, xx, japi.policy, jcfg,
                                           serve=False)
        return y, st["h"]

    def tfn(p, xx):
        y, st = trglru.rglru_block_forward(p, xx, tapi.policy,
                                           tapi.cfg.rnn, serve=False)
        return y, st["h"]
    mp = pytest.MonkeyPatch()
    out = vjp_block(jfn, tfn, params, x, cts, mp)
    mp.undo()
    return out


def test_rglru_train_forward(rglru_block):
    jy, ty, *_ = rglru_block
    np.testing.assert_array_equal(_f32(ty[0]), _f32(jy[0]))
    assert _leaf_err(ty[1], jy[1]) <= 1e-5


def test_rglru_train_vjp_matches_jax(rglru_block):
    *_, jg, tg, mass = rglru_block
    check_block_grads(jg, tg, mass, ("['lam']",),
                      bitwise=("['conv']['w']", "['conv']['b']"))
    for path in RNN_LEAVES:
        assert float(tg[path].abs().max()) > 0, path


# --- the model -----------------------------------------------------------------


@pytest.fixture(scope="module")
def model():
    """The reference's train and serve forwards over S tokens, and its
    train prefill of PROMPT tokens with DECODE_T train decode steps on the
    ring cache, op by op (once)."""
    japi = jconfigs.get(ARCH, reduced=True)
    params = np_params(japi, seed=2)
    jp = jax.tree.map(jnp.asarray, params)
    toks = np.random.default_rng(4).integers(
        0, japi.cfg.vocab, (B, S + DECODE_T)).astype(np.int32)
    jpacked = jax.jit(lambda t: jserve.pack_for_serving(japi, t))(jp)
    smax = PROMPT + DECODE_T
    with jax.disable_jit():
        train = _f32(japi.forward(jp, jnp.asarray(toks[:, :S]),
                                  mode="train"))
        serve = _f32(japi.forward(jpacked, jnp.asarray(toks[:, :S]),
                                  mode="serve"))
        last, pre = japi.prefill(jp, jnp.asarray(toks[:, :PROMPT]),
                                 mode="train")
        cache = jserve.Generator._rg_cache(
            None, pre, B, PROMPT, japi.cache_specs(B, smax))
        steps = []
        for t in range(DECODE_T):
            lg, cache = japi.decode_step(
                jp, cache, jnp.asarray(toks[:, PROMPT + t:PROMPT + t + 1]),
                jnp.asarray(PROMPT + t, jnp.int32), mode="train")
            steps.append(_f32(lg))
    return {"toks": toks, "train": train, "serve": serve,
            "packed": convert.from_jax_lm_serve_tree(
                jax.tree.map(np.asarray, jpacked), device="cpu"),
            "tp": convert.from_jax_lm_train_params(params, device="cpu"),
            "last": _f32(last), "pre": pre, "steps": steps, "smax": smax}


def test_train_forward_logits_bitwise(model):
    api = configs.get(ARCH, reduced=True)
    assert S > api.cfg.window
    with torch.no_grad():
        got = api.forward(model["tp"], torch.from_numpy(
            model["toks"][:, :S]).long(), mode="train")
    np.testing.assert_array_equal(_f32(got), model["train"])


def test_serve_forward_logits_bitwise(model):
    api = configs.get(ARCH, reduced=True)
    with torch.no_grad():
        got = api.forward(model["packed"],
                          torch.from_numpy(model["toks"][:, :S]).long(),
                          mode="serve")
    np.testing.assert_array_equal(_f32(got), model["serve"])


def test_train_prefill_matches_train_forward(model):
    api = configs.get(ARCH, reduced=True)
    with torch.no_grad():
        last, caches = api.prefill(model["tp"],
                                   torch.from_numpy(model["toks"][:, :S])
                                   .long(), mode="train")
    assert len(caches) == api.cfg.n_layers
    np.testing.assert_array_equal(_f32(last), model["train"][:, -1])


def test_train_prefill_and_decode_match_jax(model):
    api = configs.get(ARCH, reduced=True)
    cfg = api.cfg
    toks = model["toks"]
    (st1, st2, kv), rem = model["pre"]
    with torch.no_grad():
        last, pre = api.prefill(model["tp"], torch.from_numpy(
            toks[:, :PROMPT]).long(), mode="train")
        np.testing.assert_array_equal(_f32(last), model["last"])
        for j in range(cfg.n_super):
            for r, jst in ((0, st1), (1, st2)):
                assert _leaf_err(pre[3 * j + r]["h"], jst["h"][j]) <= 1e-5
            for got, want in zip(pre[3 * j + 2], kv):
                np.testing.assert_array_equal(_f32(got), _f32(want[j]))
        for i in range(cfg.n_rem):
            assert _leaf_err(pre[3 * cfg.n_super + i]["h"],
                             rem[i]["h"]) <= 1e-5
        cache = RG.ring_cache(cfg, pre, PROMPT,
                              api.cache_specs(B, model["smax"]), "cpu")
        for t in range(DECODE_T):
            lg, cache = api.decode_step(
                model["tp"], cache,
                torch.from_numpy(toks[:, PROMPT + t:PROMPT + t + 1]).long(),
                PROMPT + t, mode="train")
            np.testing.assert_array_equal(_f32(lg), model["steps"][t],
                                          err_msg=f"step {t}")


# --- one whole train step ----------------------------------------------------


@pytest.fixture(scope="module")
def step():
    return _step_case(ARCH, eager=True,
                      batch=step_batch(jconfigs.get(ARCH, reduced=True)
                                       .cfg.vocab, b=B, s=S))


def test_step_loss_and_gradients(step):
    check_step(step, RNN_LEAVES)


def test_remat_changes_no_bit(step):
    b = step["batch"]
    params = configs.get(ARCH, reduced=True).init_params(
        torch.Generator().manual_seed(0), device="cpu")
    assert_same_runs(remat_runs(ARCH, params,
                                torch.from_numpy(b["tokens"]).long(),
                                torch.from_numpy(b["labels"]).long()))


# --- convert.from_jax_train_state --------------------------------------------


@pytest.mark.parametrize("arch", ["mamba2-1.3b", "recurrentgemma-9b",
                                  "whisper-base"])
def test_from_jax_train_state_per_layer(arch):
    japi = jconfigs.get(arch, reduced=True)
    state = jax.tree.map(np.asarray, JS.init_train_state(
        japi, jax.random.PRNGKey(0)))
    rng = np.random.default_rng(7)
    for k in ("m", "v"):  # distinct nonzero moments
        state["opt"][k] = jax.tree.map(
            lambda a: rng.standard_normal(a.shape).astype(a.dtype),
            state["opt"][k])
    got = convert.from_jax_train_state(state, device="cpu")
    stack = "enc_layers" if arch == "whisper-base" else "layers"
    assert isinstance(got["params"][stack], list)
    assert len(got["params"][stack]) == japi.cfg.n_layers
    for part, tree in (("params", state["params"]), ("m", state["opt"]["m"]),
                       ("v", state["opt"]["v"])):
        want = flatten_with_paths(convert.from_jax_lm_train_params(
            tree, device="cpu"))
        have = flatten_with_paths(got["params"] if part == "params"
                                  else got["opt"][part])
        assert have.keys() == want.keys(), part
        for path, leaf in have.items():
            assert torch.equal(leaf, want[path]), (part, path)
    assert int(got["step"]) == int(state["step"])
    assert int(got["opt"]["count"]) == int(state["opt"]["count"])


def test_launch_train_then_serve(tmp_path, capsys):
    run_launchers(tmp_path, capsys, ARCH, S)
