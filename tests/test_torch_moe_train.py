"""The port's MoE QAT train path against the JAX package's, op by op.

At the reduced olmoe-1b-7b config (8 experts, top-2, channel-wise weight
steps: one ``gw`` per expert and output column) and the reduced
deepseek-v2-lite-16b MoE block (2 shared experts), on weights and step
sizes drawn in numpy, against ``jax.disable_jit``:

* ``moe_apply(serve=False)``: the output bitwise; its vjp of one bf16
  cotangent equal to ``jax.vjp``'s -- x and the expert banks' and shared
  experts' weights within one bf16 ulp, at most 0.1% of the elements off
  (readings: 1 of 4096 for x, at most 1 element of a bank), the f32
  router within 1e-5 of its largest |value| (reading 2.9e-7: f32 sums in
  another order), each weight step ``gw`` within 1e-5 of its gradient's
  terms' mass (``step_mass``; reading 3.1e-7) and each activation step
  ``ga`` within half of it (a bf16 sum of nearly cancelling terms that
  XLA adds in bf16; reading 0.25).  The port mirrors two of XLA's bf16
  sums to get there: the dispatch's transpose (a token's expert
  cotangents added one by one, ``nn.moe._Dispatch``) and the gates'
  gradient (a sum over the model axis in windows of 32,
  ``nn.moe._Gate``); with torch's own sums 22% (olmoe) and 32%
  (deepseek) of x's elements are off
  (``test_moe_train_vjp_needs_the_ordered_sums``).
* olmoe's whole ``make_train_step`` (``test_torch_train_step._step_case``,
  state step 50, batch 4 x 16): the loss within 1e-6 (bitwise), the
  train-forward logits bitwise, every weight, norm and router gradient
  within 2e-2 of its leaf's largest |value| (worst reading 5.5e-3, layer
  0's q projection), ``gw`` within 1e-3 of its mass (reading 7.5e-5),
  ``ga`` within half (reading 0.19), the parameters after AdamW as
  ``check_params_after_adamw`` says.  One layer alone is bitwise but for
  0.05% of x's elements; the router spreads such a difference in a layer's
  input cotangent over every element of the tokens it touches (an f32
  path to each token's whole row), so the step is held by a tolerance.
* Remat: the step's loss and gradients are bitwise the same with
  ``remat`` off, ``full`` and ``dots`` (the port keeps no batched
  product under 'dots', as ``dots_with_no_batch_dims_saveable``).

deepseek's step and MLA are in ``test_torch_mla_train.py``, the
train-mode cache path of every decoder arch in
``test_torch_train_cache.py``.  The JAX side runs once per module.
"""
import dataclasses

import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402
import numpy as np  # noqa: E402

from repro import configs as jconfigs  # noqa: E402
from repro.nn import moe as jmoe  # noqa: E402
from repro.nn import param as jparam  # noqa: E402
from repro_torch import configs, convert  # noqa: E402
from repro_torch.launch import steps as TS  # noqa: E402
from repro_torch.nn import moe as tmoe  # noqa: E402
from repro_torch.tree import flatten_with_paths, unflatten  # noqa: E402
from test_torch_train_step import (_check_steps, _f32,  # noqa: E402
                                   _leaf_err, _step_case,
                                   check_params_after_adamw, step_mass)

STEP_SIZES = ("['ga']", "['gw']")
MOE_ARCHS = ["olmoe-1b-7b", "deepseek-v2-lite-16b"]
B, S = 4, 16


@pytest.fixture(autouse=True, scope="module")
def _one_thread():
    """Small tensors: torch's CPU thread pool costs more than it saves."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def draw(spec, rng):
    """A JAX spec tree drawn in numpy: fan-in scaled normal weights, the
    step sizes uniform in [0.02, 0.06] (each expert its own)."""
    def one(sp):
        if sp.init == "constant":
            return rng.uniform(0.02, 0.06, sp.shape).astype(np.float32)
        if sp.init in ("zeros", "ones"):
            return np.full(sp.shape, sp.init == "ones", np.float32)
        x = rng.standard_normal(sp.shape).astype(np.float32)
        fan = int(np.prod([sp.shape[a] for a in sp.fan_in_axes]))
        return (x / np.sqrt(max(fan, 1))).astype(np.float32)
    return jax.tree.map(one, jparam.strip_markers(spec),
                        is_leaf=jparam.is_spec)


def assert_bf16_close(got, want, label, frac=1e-3):
    """Every element within one bf16 ulp of the reference's, at most
    ``frac`` of them off at all."""
    g, w = _f32(got), _f32(want)
    np.testing.assert_allclose(g, w, rtol=2 ** -7, atol=0, err_msg=label)
    assert np.mean(g != w) <= frac, label


@pytest.fixture(scope="module")
def moe_vjp():
    """Each MoE arch's ``moe_apply(serve=False)`` and its vjp, JAX op by op
    (computed once)."""
    out = {}
    for arch in MOE_ARCHS:
        japi = jconfigs.get(arch, reduced=True)
        jcfg = japi.cfg.moe
        rng = np.random.default_rng(3)
        params = draw(jmoe.moe_spec(jcfg, serve=False), rng)
        x = rng.standard_normal((B, S, jcfg.d_model)).astype(np.float32)
        ct = rng.standard_normal((B, S, jcfg.d_model)).astype(np.float32)
        with jax.disable_jit():
            y, vjp = jax.vjp(
                lambda p, xx: jmoe.moe_apply(p, xx, japi.policy, jcfg,
                                             serve=False),
                jax.tree.map(jnp.asarray, params),
                jnp.asarray(x, jnp.bfloat16))
            gp, gx = vjp(jnp.asarray(ct, jnp.bfloat16))
        jg = flatten_with_paths(convert.from_jax_train_params(
            jax.tree.map(np.asarray, gp), {}, device="cpu")[0])
        out[arch] = (params, x, ct, _f32(y), _f32(gx), jg)
    return out


def _port_moe(arch, params, x):
    tapi = configs.get(arch, reduced=True)
    tp = convert.from_jax_train_params(params, {}, device="cpu")[0]
    flat = flatten_with_paths(tp)
    live = {k: v.detach().requires_grad_(True) for k, v in flat.items()}
    xt = torch.from_numpy(x).to(torch.bfloat16).requires_grad_(True)

    def apply(p, xx):
        return tmoe.moe_apply(p, xx, tapi.policy, tapi.cfg.moe, serve=False)
    return tapi, tp, live, xt, apply(unflatten(tp, list(live.values())), xt), \
        apply


@pytest.mark.parametrize("arch", MOE_ARCHS)
def test_moe_train_forward_bitwise(moe_vjp, arch):
    params, x, _, want, _, _ = moe_vjp[arch]
    *_, y, _ = _port_moe(arch, params, x)
    assert y.dtype == torch.bfloat16
    np.testing.assert_array_equal(_f32(y), want)


@pytest.mark.parametrize("arch", MOE_ARCHS)
def test_moe_train_vjp_matches_jax(moe_vjp, arch, monkeypatch):
    params, x, ct, _, gx, jg = moe_vjp[arch]
    tapi, tp, live, xt, y, apply = _port_moe(arch, params, x)
    ctt = torch.from_numpy(ct).to(torch.bfloat16)
    grads = torch.autograd.grad(y, [xt] + list(live.values()),
                                grad_outputs=ctt)
    assert_bf16_close(grads[0], gx, "x")
    tg = dict(zip(live, grads[1:]))
    assert tg.keys() == jg.keys()
    mass = step_mass(lambda p: (apply(p, xt.detach()).float()
                                * ctt.float()).sum(), tp, monkeypatch)
    for path, g in tg.items():
        if path.endswith("['w']"):
            assert float(g.abs().max()) > 0, path
            assert_bf16_close(g, jg[path], path)
        elif path == "['router']":
            assert _leaf_err(g, jg[path]) <= 1e-5, path
            assert float(g.abs().max()) > 0
        else:
            frac = 1e-5 if path.endswith("['gw']") else 0.5
            d = np.abs(_f32(g) - _f32(jg[path]))
            assert np.all(d <= frac * mass[path]), path


@pytest.mark.parametrize("arch", MOE_ARCHS)
def test_moe_train_vjp_needs_the_ordered_sums(moe_vjp, arch, monkeypatch):
    """What ``_Dispatch`` and ``_Gate`` buy: with torch's own backwards
    (the serve path's gather and gating under autograd: a token's expert
    cotangents and a gate's sum over D added in f32, rounded once) the
    block's x gradient is off ``jax.vjp``'s in more than 10% of its
    elements (readings 901 and 1311 of 4096), where the ordered sums
    leave 1."""
    params, x, ct, _, gx, _ = moe_vjp[arch]
    dispatch, gate = tmoe.dispatch, tmoe.gate_and_combine
    monkeypatch.setattr(tmoe, "dispatch", lambda *a, serve: dispatch(
        *a, serve=True))
    monkeypatch.setattr(tmoe, "gate_and_combine", lambda *a, serve: gate(
        *a, serve=True))
    *_, xt, y, _ = _port_moe(arch, params, x)
    (g,) = torch.autograd.grad(y, xt, grad_outputs=torch.from_numpy(ct).to(
        torch.bfloat16))
    assert np.mean(_f32(g) != gx) > 0.1


def test_dispatch_backward_adds_in_expert_order():
    """The dispatch's backward against a sequential bf16 scatter-add in
    index order (XLA's transpose of the reference's gather), with a
    capacity that drops routed tokens and pads experts with gate-0 ones:
    bitwise, where torch's gather backward (f32, rounded once) is not."""
    rng = np.random.default_rng(0)
    b, s, e, topk, c, d = 2, 12, 6, 3, 4, 16
    scores = torch.from_numpy(rng.random((b, s, e)).astype(np.float32))
    gates, idx = tmoe.top_k(scores, topk)
    sel = torch.zeros(b, s, e).scatter(2, idx, gates)
    vals, tok_idx = tmoe.top_k(sel.transpose(1, 2), c)
    x = torch.zeros(b, s, d, dtype=torch.bfloat16, requires_grad=True)
    g = torch.from_numpy(rng.standard_normal((b, e, c, d)).astype(
        np.float32)).to(torch.bfloat16)
    g = g * (vals > 0)[..., None]          # gate-0 slots get zeros
    (got,) = torch.autograd.grad(tmoe._Dispatch.apply(x, tok_idx, idx), x,
                                 grad_outputs=g)
    want = np.zeros((b, s, d), np.float32)
    gf = g.float().numpy()
    ti = tok_idx.numpy()
    for bi in range(b):
        for ei in range(e):
            for ci in range(c):
                t = ti[bi, ei, ci]
                want[bi, t] = torch.tensor(want[bi, t] + gf[bi, ei, ci]).to(
                    torch.bfloat16).float().numpy()
    np.testing.assert_array_equal(got.float().numpy(), want)


def test_xla_row_sum_matches_lax_reduce():
    """``_xla_row_sum`` of bf16 rows is ``jax.lax.reduce`` on XLA's CPU
    compiler, bitwise, at row lengths 32 * 2^j (the model widths 64 and
    2048 among them); torch's own sum is not."""
    rng = np.random.default_rng(0)
    for shape in [(3, 5, 64), (8, 96), (4, 2048), (2, 1024)]:
        a = rng.standard_normal(shape).astype(np.float32)
        t = torch.from_numpy(a).to(torch.bfloat16)
        want = _f32(jax.lax.reduce(jnp.asarray(a, jnp.bfloat16),
                                   jnp.array(0, jnp.bfloat16), jax.lax.add,
                                   (len(shape) - 1,)))
        np.testing.assert_array_equal(_f32(tmoe._xla_row_sum(t)), want)
    a = torch.from_numpy(rng.standard_normal((64, 64)).astype(
        np.float32)).to(torch.bfloat16)
    assert not torch.equal(tmoe._xla_row_sum(a), a.sum(-1))


# --- olmoe's whole train step ------------------------------------------------


@pytest.fixture(scope="module")
def olmoe():
    return _step_case("olmoe-1b-7b", eager=True)


def test_olmoe_step_loss_and_gradients(olmoe):
    c = olmoe
    assert float(c["tm"]["loss"]) == pytest.approx(float(c["jm"]["loss"]),
                                                   rel=1e-6)
    assert float(c["tm"]["lr"]) == float(c["jm"]["lr"]) > 0
    assert float(c["tm"]["grad_norm"]) == pytest.approx(
        float(c["jm"]["grad_norm"]), rel=1e-4)
    assert c["tg"].keys() == c["jg"].keys()
    routers = [p for p in c["tg"] if p.endswith("['router']")]
    assert len(routers) == c["tapi"].cfg.n_layers
    for path, g in c["tg"].items():
        if path.endswith(STEP_SIZES):
            continue
        assert _leaf_err(g, c["jg"][path]) <= 2e-2, path
        if path.endswith(("['w']", "['router']")):
            assert float(torch.as_tensor(g).abs().max()) > 0, path
    _check_steps(c, "ga", frac=0.5)
    _check_steps(c, "gw", frac=1e-3)


def test_olmoe_params_after_adamw(olmoe):
    check_params_after_adamw(olmoe)


def test_olmoe_train_forward_logits_bitwise(olmoe):
    c = olmoe
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


@pytest.mark.parametrize("arch", MOE_ARCHS)
def test_remat_changes_no_bit(olmoe, arch):
    """The train step's loss and every gradient, remat off against 'full'
    and 'dots' (the MoE blocks, deepseek's MLA and dense prefix inside)."""
    api = configs.get(arch, reduced=True)
    params = api.init_params(torch.Generator().manual_seed(0), device="cpu")
    toks = torch.from_numpy(olmoe["batch"]["tokens"] % api.cfg.vocab).long()
    labels = torch.from_numpy(olmoe["batch"]["labels"] % api.cfg.vocab).long()
    runs = {}
    for remat, policy in ((False, "full"), (True, "full"), (True, "dots")):
        a = dataclasses.replace(api, cfg=dataclasses.replace(
            api.cfg, remat=remat, remat_policy=policy))
        runs[(remat, policy)] = TS.value_and_grad(
            lambda p, t, lb, f: TS.cross_entropy(
                a.forward(p, t, mode="train"), lb), params, toks, labels,
            None)
    (l0, g0) = runs[(False, "full")]
    for key, (loss, grads) in runs.items():
        assert torch.equal(loss, l0), key
        for path, g in flatten_with_paths(grads).items():
            assert torch.equal(g, flatten_with_paths(g0)[path]), (key, path)
