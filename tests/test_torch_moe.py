"""The port's Mixture-of-Experts serve path against the JAX package's.

* An expert bank's ``qlinear_serve_apply`` (one K1 call over the bank, each
  expert's rows quantized with its own activation step) equals the JAX
  package's ``jax.vmap`` of ``qlinear_serve_apply(impl="xla")`` over the
  experts, bitwise, and the port packs a bank (per-expert steps, per-tensor
  or channel-wise) to the same bytes.
* ``moe_apply`` at the reduced olmoe and deepseek MoE configs: the expert
  selection (the router's top-k and each expert's capacity pick) is equal
  first, then the output is bitwise equal to the JAX package run op by op
  (``jax.disable_jit``: jitted XLA fuses the router's softmax and the
  combine differently).
* The tie order of both top-k passes (``jax.lax.top_k``: the lower index
  first), the capacity at decode (s = 1: every expert runs every token),
  the combine's order of sums against a sequential scatter-add in index
  order (NaN from a gate-0 token included), and the grouped plain K1
  (``mpmm_torch`` over a bank) against E separate calls at all 16 formats.
"""
import dataclasses
import itertools

import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402
import numpy as np  # noqa: E402

from repro import configs as jconfigs  # noqa: E402
from repro.core.precision import PrecisionPolicy as JPolicy  # noqa: E402
from repro.nn import moe as jmoe  # noqa: E402
from repro.nn import param as jparam  # noqa: E402
from repro.nn import quantized as JQ  # noqa: E402
from repro_torch import configs, convert  # noqa: E402
from repro_torch.core import packing  # noqa: E402
from repro_torch.core.precision import PrecisionPolicy  # noqa: E402
from repro_torch.kernels.mpmm import kernel, ops  # noqa: E402
from repro_torch.kernels.mpmm.epilogue import EpilogueSpec  # noqa: E402
from repro_torch.nn import moe as tmoe  # noqa: E402
from repro_torch.nn import quantized as Q  # noqa: E402

FORMATS = [(w, k) for w in (1, 2, 4, 8) for k in (1, 2, 4, 8)]


def _np_tree(tree):
    return jax.tree.map(lambda a: np.array(a), tree)


def _f32(x):
    if isinstance(x, torch.Tensor):
        return x.to(torch.float32).numpy()
    return np.asarray(jnp.asarray(x).astype(jnp.float32))


def _steps(tree, rng):
    """Non-trivial LSQ step sizes from numpy."""
    if isinstance(tree, dict):
        return {k: (jnp.asarray(rng.uniform(0.02, 0.06, np.shape(v)),
                                jnp.float32) if k in ("gw", "ga")
                    else _steps(v, rng)) for k, v in tree.items()}
    return tree


# --- the bank ---------------------------------------------------------------


@pytest.mark.parametrize("channel_wise", [False, True])
@pytest.mark.parametrize("w_bits,k", [(4, 4), (2, 2), (8, 4), (1, 1),
                                      (2, 4)])
def test_bank_apply_equals_vmapped_reference(w_bits, k, channel_wise):
    e, m, kdim, n = 5, 7, 40, 24
    rng = np.random.default_rng(w_bits * 10 + k + channel_wise)
    jpol = JPolicy(inner_bits=w_bits, k=k, channel_wise=channel_wise)
    tpol = PrecisionPolicy(inner_bits=w_bits, k=k, channel_wise=channel_wise)
    spec = JQ.qlinear_spec(kdim, n, lead=(e,), lead_axes=("experts",),
                           channel_wise=channel_wise)
    train = _steps(jparam.init_params(spec, jax.random.PRNGKey(1)), rng)
    jp = jax.jit(lambda p: JQ.pack_qlinear(
        {kk: v for kk, v in p.items() if kk != JQ.QMARK}, jpol))(train)
    tp = convert.from_jax_serve_tree(_np_tree(jp), device="cpu")
    mine = Q.pack_qlinear(convert.from_jax_serve_tree(
        _np_tree({kk: v for kk, v in train.items() if kk != JQ.QMARK}),
        device="cpu"), tpol)
    for key in tp:
        np.testing.assert_array_equal(_f32(mine[key]), _f32(tp[key]),
                                      err_msg=key)
    assert tuple(tp["planes"].shape)[:1] == (e,)
    x = rng.standard_normal((e, m, kdim)).astype(np.float32) * 2
    xj = jnp.asarray(x, jnp.bfloat16)
    want = jax.jit(jax.vmap(lambda p, xe: JQ.qlinear_serve_apply(
        p, xe, jpol, impl="xla")))(jp, xj)
    calls = []
    real = ops.mpmm
    try:
        ops.mpmm = lambda a, *r, **kw: calls.append(a.shape) or real(a, *r,
                                                                     **kw)
        got = Q.qlinear_serve_apply(
            tp, torch.from_numpy(x).to(torch.bfloat16), tpol, impl="torch")
    finally:
        ops.mpmm = real
    assert calls == [(e, m, kdim)]  # one call over the whole bank
    np.testing.assert_array_equal(_f32(got), _f32(want))


@pytest.mark.parametrize("w_bits,k", FORMATS)
def test_grouped_mpmm_torch_equals_separate_calls(w_bits, k):
    e, m, kdim, n = 4, 6, 45, 33
    g = torch.Generator().manual_seed(w_bits * 8 + k)
    fmt = packing.PlaneFormat(w_bits=w_bits, k=k, k_dim=kdim)
    w_int = torch.randint(-(2 ** (w_bits - 1)), 2 ** (w_bits - 1),
                          (e, kdim, n), generator=g, dtype=torch.int32)
    planes = packing.pack_planes(w_int, fmt).movedim(0, -3).contiguous()
    a = torch.randint(-128, 128, (e, m, kdim), generator=g,
                      dtype=torch.int32).to(torch.int8)
    gamma = torch.rand((e, 1, n), generator=g) * 0.01
    colsum = w_int.sum(-2, dtype=torch.int32)[:, None]
    spec = EpilogueSpec(bn=True, residual=True, relu=True)
    scale = torch.rand((e, 1, n), generator=g) + 0.5
    shift = torch.randn((e, 1, n), generator=g)
    res = torch.randn((e, m, n), generator=g).to(torch.bfloat16)
    kw = dict(fmt=fmt, act_zero=128, out_dtype=torch.bfloat16)
    got = kernel.mpmm_torch(a, planes, gamma, colsum, **kw)
    got_epi = kernel.mpmm_torch(a, planes, gamma, colsum, epilogue=spec,
                                scale=scale, shift=shift, residual=res, **kw)
    for i in range(e):
        want = kernel.mpmm_torch(a[i], planes[i], gamma[i], colsum[i], **kw)
        want_epi = kernel.mpmm_torch(a[i], planes[i], gamma[i], colsum[i],
                                     epilogue=spec, scale=scale[i],
                                     shift=shift[i], residual=res[i], **kw)
        assert torch.equal(got[i], want) and torch.equal(got_epi[i],
                                                         want_epi), i
    # column slices of the plain version give the same bits
    old = kernel.PLAIN_SLICE_VALUES
    try:
        kernel.PLAIN_SLICE_VALUES = kdim * 5
        assert torch.equal(kernel.mpmm_torch(a, planes, gamma, colsum, **kw),
                           got)
    finally:
        kernel.PLAIN_SLICE_VALUES = old


def test_split_plan_counts_the_bank():
    """Route B cuts K by the blocks of every group: a bank of 64 decode
    products splits less than one product does, and its workspace holds
    E x splits x M x N partials."""
    fmt = packing.PlaneFormat(w_bits=4, k=4, k_dim=2048)
    one = kernel.split_plan(4, 2048, 1024, fmt)
    bank = kernel.split_plan(4, 2048, 1024, fmt, 64)
    assert bank.splits < one.splits
    assert kernel.workspace_bytes(4, 2048, 1024, fmt, 64) == \
        64 * bank.splits * 4 * 1024 * 4
    assert kernel.mpmm_route(1000, 2048, 1024) == "wgmma"
    assert kernel.mpmm_route(4, 2048, 1024) == "splitk"


# --- routing, capacity, combine ----------------------------------------------


def test_top_k_tie_order_is_jax():
    rng = np.random.default_rng(0)
    v = rng.integers(0, 3, (6, 40)).astype(np.float32) / 4
    v[0] = 0.0
    for k in (1, 5, 40):
        jv, ji = jax.lax.top_k(jnp.asarray(v), k)
        tv, ti = tmoe.top_k(torch.from_numpy(v), k)
        np.testing.assert_array_equal(ti.numpy(), np.asarray(ji))
        np.testing.assert_array_equal(tv.numpy(), np.asarray(jv))


def test_capacity_at_decode_runs_every_expert():
    cfg = configs.get("olmoe-1b-7b").cfg.moe
    assert tmoe.capacity(cfg, 1) == 1
    assert tmoe.capacity(cfg, 1000) == 250
    dcfg = configs.get("deepseek-v2-lite-16b").cfg.moe
    assert tmoe.capacity(dcfg, 1000) == 187
    small = configs.get("olmoe-1b-7b", reduced=True).cfg.moe
    p = _moe_params(small, JPolicy(inner_bits=4, k=4))[1]
    x = torch.randn((3, 1, small.d_model)).to(torch.bfloat16)
    calls = []
    real = ops.mpmm
    try:
        ops.mpmm = lambda a, *r, **kw: calls.append(a.shape) or real(a, *r,
                                                                     **kw)
        y = tmoe.moe_apply(p, x, PrecisionPolicy(inner_bits=4, k=4), small)
    finally:
        ops.mpmm = real
    # three bank calls, each expert with the batch's one token a row
    assert calls == [(small.n_experts, 3, small.d_model)] * 2 + [
        (small.n_experts, 3, small.d_ff)]
    assert y.shape == x.shape and bool(torch.isfinite(y.float()).all())


def _sequential_combine(h, tok_idx, s):
    """The reference's scatter-add, in index order, in f32 numpy."""
    b, e, c, d = h.shape
    y = np.zeros((b, s, d), np.float32)
    for bi, ei, ci in itertools.product(range(b), range(e), range(c)):
        y[bi, tok_idx[bi, ei, ci]] += h[bi, ei, ci]
    return y


@pytest.mark.parametrize("poison", [False, True])
def test_combine_order_matches_sequential_scatter(poison):
    rng = np.random.default_rng(3)
    b, s, e, topk, c = 2, 9, 6, 3, 5
    scores = rng.standard_normal((b, s, e)).astype(np.float32)
    gates, idx = tmoe.top_k(torch.from_numpy(scores), topk)
    sel = torch.zeros((b, s, e)).scatter(2, idx, gates.abs() + 0.1)
    vals, tok_idx = tmoe.top_k(sel.transpose(1, 2), c)
    h = (torch.from_numpy(rng.standard_normal((b, e, c, 16)).astype(
        np.float32)) * 30).to(torch.bfloat16)
    if poison:  # a non-finite output of a gate-0 (padding) pick
        pad = (vals == 0).nonzero()[0].tolist()
        h[pad[0], pad[1], pad[2], 3] = float("inf")
    gated = h * vals[..., None].to(h.dtype)
    got = tmoe._combine(gated, tok_idx, idx, s).numpy()
    want = _sequential_combine(gated.float().numpy(), tok_idx.numpy(), s)
    np.testing.assert_array_equal(got, want)
    assert np.isnan(got).any() == poison


# --- moe_apply against the reference -----------------------------------------


def _moe_params(jcfg, jpol, seed=0):
    """Float MoE weights drawn by the JAX package, packed by it -> (JAX
    packed tree, the port's converted tree)."""
    spec = jmoe.moe_spec(jcfg, serve=False)
    rng = np.random.default_rng(seed)
    train = _steps(jparam.init_params(spec, jax.random.PRNGKey(seed)), rng)
    jp = jax.jit(lambda t: JQ.pack_tree(t, spec, jpol))(train)
    return jp, convert.from_jax_serve_tree(_np_tree(jp), device="cpu")


def _jax_selection(p, x, cfg):
    """The reference's routing and capacity pick, op for op."""
    b, s, _ = x.shape
    e = cfg.n_experts
    scores = jax.nn.softmax(jnp.einsum(
        "bsd,de->bse", x.astype(jnp.float32),
        p["router"].astype(jnp.float32)), axis=-1)
    gates, idx = jax.lax.top_k(scores, cfg.topk)
    gates = gates / jnp.sum(gates, axis=-1, keepdims=True)
    sel = jnp.zeros((b, s, e), jnp.float32).at[
        jnp.arange(b)[:, None, None], jnp.arange(s)[None, :, None],
        idx].set(gates)
    cap = min(max(int(s * cfg.topk * cfg.capacity_factor / e), 1), s)
    _, tok_idx = jax.lax.top_k(jnp.swapaxes(sel, 1, 2), cap)
    return np.asarray(idx), np.asarray(tok_idx)


@pytest.mark.parametrize("s", [1, 13])
@pytest.mark.parametrize("arch", ["olmoe-1b-7b", "deepseek-v2-lite-16b"])
def test_moe_apply_bitwise_against_reference(arch, s):
    japi = jconfigs.get(arch, reduced=True)
    tapi = configs.get(arch, reduced=True)
    jcfg, tcfg = japi.cfg.moe, tapi.cfg.moe
    assert dataclasses.asdict(jcfg) == dataclasses.asdict(tcfg)
    jp, tp = _moe_params(jcfg, japi.policy, seed=s)
    rng = np.random.default_rng(s)
    x = rng.standard_normal((3, s, jcfg.d_model)).astype(np.float32)
    xj = jnp.asarray(x, jnp.bfloat16)
    xt = torch.from_numpy(x).to(torch.bfloat16)
    with jax.disable_jit():
        j_idx, j_tok = _jax_selection(jp, xj, jcfg)
        want = jmoe.moe_apply(jp, xj, japi.policy, jcfg, serve=True,
                              impl="xla")
    t_idx, t_tok = _port_selection(tp, xt, tcfg)
    np.testing.assert_array_equal(t_idx.numpy(), j_idx)
    np.testing.assert_array_equal(t_tok.numpy(), j_tok)
    got = tmoe.moe_apply(tp, xt, tapi.policy, tcfg, impl="torch")
    np.testing.assert_array_equal(_f32(got), _f32(want))


def _port_selection(p, x, cfg):
    """The port's routing and capacity pick, as ``moe_apply`` makes them."""
    scores = torch.softmax(tmoe.router_logits(x, p["router"]), dim=-1)
    gates, idx = tmoe.top_k(scores, cfg.topk)
    gates = gates / gates.sum(-1, keepdim=True)
    sel = torch.zeros(scores.shape).scatter(2, idx, gates)
    _, tok_idx = tmoe.top_k(sel.transpose(1, 2),
                            tmoe.capacity(cfg, x.shape[1]))
    return idx, tok_idx
