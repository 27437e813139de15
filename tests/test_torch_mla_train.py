"""The port's MLA and deepseek QAT train path against the JAX package's,
op by op.

At the reduced deepseek-v2-lite-16b config (kv_lora 32, qk 16 + 8, v 16, 4
heads; layer 0 dense, layers 1-2 MoE with 2 shared experts), on weights
and step sizes drawn in numpy, against ``jax.disable_jit``:

* deepseek's whole ``make_train_step`` (state step 50, batch 4 x 16): the
  loss within 1e-6 (reading 1.7e-7), the train-forward logits bitwise,
  every weight, norm and router gradient within 2e-2 of its leaf's largest
  |value| (worst reading 1.35e-2, layer 1's shared ``up``: each layer is
  bitwise alone, and the routers spread a layer's last-bit differences
  over whole token rows -- ``test_torch_moe_train.py``), ``gw`` within
  1e-3 of its mass (reading 5.2e-4), ``ga`` within half (reading 0.24),
  the parameters after AdamW as ``check_params_after_adamw`` says.
* ``mla_prefill(serve=False)``: the output bitwise, the latent cache
  within one bf16 ulp, at most 1% of it off (reading: 1 of the 256
  rotary-key elements, from one element of the ``dkv`` product: bf16
  products agree but for the last bit of an occasional element); its
  vjp of one bf16 cotangent: x and every projection's weight within one
  bf16 ulp, at most 0.1% of the elements off (readings: 0 for x and every
  weight), ``kv_norm`` within 1e-5 of its largest |value| (f32 sums;
  reading 1.1e-7), each ``gw`` within 1e-5 of its gradient's terms' mass
  (reading 4.1e-8), each ``ga`` within half of it (reading 0.21).  The
  rotary key's broadcast over the heads adds their cotangents one by one
  in bf16, as XLA does (``nn.attention._HeadBroadcast``); with
  ``expand``'s backward 2% of x's elements are off
  (``test_mla_train_block_needs_the_ordered_broadcast``).

The step runs first: the block's operations are then compiled already.
The train-mode cache path is in ``test_torch_train_cache.py``.
"""
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402
import numpy as np  # noqa: E402

from repro import configs as jconfigs  # noqa: E402
from repro.nn import attention as JA  # noqa: E402
from repro.nn import layers as JL  # noqa: E402
from repro_torch import configs, convert  # noqa: E402
from repro_torch.nn import attention as TA  # noqa: E402
from repro_torch.nn import layers as TL  # noqa: E402
from repro_torch.tree import flatten_with_paths, unflatten  # noqa: E402
from test_torch_moe_train import assert_bf16_close, draw  # noqa: E402
from test_torch_train_step import (_check_steps, _f32,  # noqa: E402
                                   _leaf_err, _step_case,
                                   check_params_after_adamw, step_mass)

STEP_SIZES = ("['ga']", "['gw']")
B, S = 2, 16


@pytest.fixture(autouse=True, scope="module")
def _one_thread():
    """Small tensors: torch's CPU thread pool costs more than it saves."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


# --- deepseek's whole train step ---------------------------------------------


@pytest.fixture(scope="module")
def deepseek():
    return _step_case("deepseek-v2-lite-16b", eager=True)


def test_deepseek_step_loss_and_gradients(deepseek):
    c = deepseek
    assert float(c["tm"]["loss"]) == pytest.approx(float(c["jm"]["loss"]),
                                                   rel=1e-6)
    assert float(c["tm"]["lr"]) == float(c["jm"]["lr"]) > 0
    assert float(c["tm"]["grad_norm"]) == pytest.approx(
        float(c["jm"]["grad_norm"]), rel=1e-4)
    assert c["tg"].keys() == c["jg"].keys()
    # the dense prefix (layer 0: an MLP of width dense_ff), then MoE layers
    cfg = c["tapi"].cfg
    assert c["tg"]["['layers'][0]['mlp']['up']['w']"].shape == (
        cfg.d_model, cfg.dense_ff)
    assert "['layers'][1]['moe']['shared_up']['w']" in c["tg"]
    for path, g in c["tg"].items():
        if path.endswith(STEP_SIZES):
            continue
        assert _leaf_err(g, c["jg"][path]) <= 2e-2, path
        if path.endswith(("['w']", "['router']")):
            assert float(torch.as_tensor(g).abs().max()) > 0, path
    _check_steps(c, "ga", frac=0.5)
    _check_steps(c, "gw", frac=1e-3)


def test_deepseek_params_after_adamw(deepseek):
    check_params_after_adamw(deepseek)


def test_deepseek_train_forward_logits_bitwise(deepseek):
    c = deepseek
    toks = c["batch"]["tokens"]
    with jax.disable_jit():
        want = c["japi"].forward(c["state"]["params"], jnp.asarray(toks),
                                 mode="train")
    tp = convert.from_jax_lm_train_params(
        jax.tree.map(np.asarray, c["state"]["params"]), device="cpu")
    with torch.no_grad():
        got = c["tapi"].forward(tp, torch.as_tensor(toks).long(),
                                mode="train")
    np.testing.assert_array_equal(_f32(got), _f32(want))



# --- the MLA block ---------------------------------------------------------


def _mla_kw(cfg):
    m = cfg.mla
    return dict(n_heads=cfg.n_heads, kv_lora=m.kv_lora, qk_nope=m.qk_nope,
                qk_rope=m.qk_rope, v_head=m.v_head)


@pytest.fixture(scope="module")
def mla_vjp():
    """``mla_prefill(serve=False)`` and its vjp, JAX op by op (once)."""
    japi = jconfigs.get("deepseek-v2-lite-16b", reduced=True)
    cfg = japi.cfg
    rng = np.random.default_rng(4)
    spec = JA.mla_spec(cfg.d_model, cfg.n_heads, kv_lora=cfg.mla.kv_lora,
                       qk_nope=cfg.mla.qk_nope, qk_rope=cfg.mla.qk_rope,
                       v_head=cfg.mla.v_head)
    params = draw(spec, rng)
    x = rng.standard_normal((B, S, cfg.d_model)).astype(np.float32)
    ct = rng.standard_normal((B, S, cfg.d_model)).astype(np.float32)
    pos = np.broadcast_to(np.arange(S)[None], (B, S))
    sin, cos = JL.rotary_cache(jnp.asarray(pos), cfg.mla.qk_rope,
                               cfg.rope_base)
    with jax.disable_jit():
        (y, cache), vjp = jax.vjp(
            lambda p, xx: JA.mla_prefill(p, xx, japi.policy, sin=sin,
                                         cos=cos, serve=False,
                                         chunk=cfg.attn_chunk,
                                         **_mla_kw(cfg)),
            jax.tree.map(jnp.asarray, params), jnp.asarray(x, jnp.bfloat16))
        gp, gx = vjp((jnp.asarray(ct, jnp.bfloat16),
                      jax.tree.map(jnp.zeros_like, cache)))
    jg = flatten_with_paths(convert.from_jax_train_params(
        jax.tree.map(np.asarray, gp), {}, device="cpu")[0])
    return params, x, ct, pos, _f32(y), [_f32(c) for c in cache], _f32(gx), jg


def _port_mla(params, x, pos):
    """The port's ``mla_prefill(serve=False)`` on the same weights and x,
    every leaf live -> (tp, live, xt, apply, (y, cache))."""
    api = configs.get("deepseek-v2-lite-16b", reduced=True)
    cfg = api.cfg
    sin, cos = TL.rotary_cache(torch.as_tensor(np.array(pos)),
                               cfg.mla.qk_rope, cfg.rope_base)
    tp = convert.from_jax_train_params(params, {}, device="cpu")[0]
    live = {k: v.detach().requires_grad_(True)
            for k, v in flatten_with_paths(tp).items()}
    xt = torch.from_numpy(x).to(torch.bfloat16).requires_grad_(True)

    def apply(p, xx):
        return TA.mla_prefill(p, xx, api.policy, sin=sin, cos=cos,
                              serve=False, chunk=cfg.attn_chunk,
                              **_mla_kw(cfg))
    return tp, live, xt, apply, apply(unflatten(tp, list(live.values())),
                                      xt)


def test_mla_train_block_matches_jax(mla_vjp, monkeypatch):
    params, x, ct, pos, want, want_cache, gx, jg = mla_vjp
    tp, live, xt, apply, (y, cache) = _port_mla(params, x, pos)
    np.testing.assert_array_equal(_f32(y.detach()), want)
    for c, w in zip(cache, want_cache):
        assert_bf16_close(c.detach(), w, "cache", frac=1e-2)
    ctt = torch.from_numpy(ct).to(torch.bfloat16)
    grads = torch.autograd.grad(y, [xt] + list(live.values()),
                                grad_outputs=ctt)
    assert_bf16_close(grads[0], gx, "x")
    mass = step_mass(lambda p: (apply(p, xt.detach())[0].float()
                                * ctt.float()).sum(), tp, monkeypatch)
    for path, g in zip(live, grads[1:]):
        if path.endswith("['w']"):
            assert float(g.abs().max()) > 0, path
            assert_bf16_close(g, jg[path], path)
        elif path.endswith(STEP_SIZES):
            frac = 1e-5 if path.endswith("['gw']") else 0.5
            d = np.abs(_f32(g) - _f32(jg[path]))
            assert np.all(d <= frac * mass[path]), path
        else:  # kv_norm
            assert _leaf_err(g, jg[path]) <= 1e-5, path


def test_head_broadcast_backward_is_sequential_bf16():
    """The rotary key's broadcast: its backward is XLA's transpose of
    ``jnp.broadcast_to`` (the heads added one by one in bf16), bitwise."""
    rng = np.random.default_rng(0)
    b, s, h, r = 2, 5, 16, 8
    k = rng.standard_normal((b, s, r)).astype(np.float32)
    ct = rng.standard_normal((b, s, h, r)).astype(np.float32)
    _, vjp = jax.vjp(lambda v: jnp.broadcast_to(v[:, :, None, :],
                                                (b, s, h, r)),
                     jnp.asarray(k, jnp.bfloat16))
    (want,) = vjp(jnp.asarray(ct, jnp.bfloat16))
    kt = torch.from_numpy(k).to(torch.bfloat16).requires_grad_(True)
    (got,) = torch.autograd.grad(
        TA._HeadBroadcast.apply(kt, h), kt,
        grad_outputs=torch.from_numpy(ct).to(torch.bfloat16))
    np.testing.assert_array_equal(_f32(got), _f32(want))


def test_mla_train_block_needs_the_ordered_broadcast(mla_vjp, monkeypatch):
    """What ``_HeadBroadcast`` buys: with ``expand``'s backward (the heads'
    cotangents added in f32, rounded once) the block's x gradient is off
    ``jax.vjp``'s in more than 0.5% of its elements (reading 41 of 2048),
    where the sequential bf16 sum leaves none."""
    params, x, ct, pos, *_, gx, _ = mla_vjp
    monkeypatch.setattr(TA._HeadBroadcast, "apply", staticmethod(
        lambda k, h: k[:, :, None, :].expand(*k.shape[:2], h, k.shape[2])))
    _, _, xt, _, (y, _) = _port_mla(params, x, pos)
    (g,) = torch.autograd.grad(y, xt, grad_outputs=torch.from_numpy(ct).to(
        torch.bfloat16))
    assert np.mean(_f32(g) != gx) > 5e-3
