"""The port's KV cache and plan schema v2 against the JAX package's.

Contract (``repro_torch/nn/kvcache.py``): codes, packed bytes and the bf16
scale/zero are bitwise equal to the JAX package's, and so is
``dequantize_kv`` (jitted and eager); inside the port
``unpack_kv(pack_kv(x)) == qdq_kv(x)`` bitwise, and the streamed decode
attention gives bitwise-equal outputs on a packed cache and on its qdq
twin.  Both shipped granite plans load and resolve every layer's weight
format, cache word-length, slice and store as the JAX package does.
"""
import json
from pathlib import Path

import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402
import numpy as np  # noqa: E402

from repro.core import plan as jplan  # noqa: E402
from repro.models import transformer as JT  # noqa: E402
from repro.nn import attention as jattn  # noqa: E402
from repro.nn import kvcache as jkv  # noqa: E402
from repro_torch import configs  # noqa: E402
from repro_torch.core import plan as tplan  # noqa: E402
from repro_torch.models import transformer as T  # noqa: E402
from repro_torch.nn import attention as attn  # noqa: E402
from repro_torch.nn import kvcache  # noqa: E402

PLANS = Path(__file__).resolve().parents[1] / "examples" / "plans"
FORMATS = [(8, 4), (8, 8), (4, 4), (4, 2), (2, 2), (2, 1), (8, 2)]


def _bf16_pair(rng, shape):
    """The same bf16 values as a JAX array and a torch tensor."""
    x = jnp.asarray(rng.normal(size=shape) * 1.5, jnp.bfloat16)
    return x, torch.from_numpy(np.asarray(x.astype(jnp.float32))).to(
        torch.bfloat16)


def _np(x):
    if isinstance(x, torch.Tensor):
        return x.to(torch.float32).numpy() if x.dtype == torch.bfloat16 \
            else x.numpy()
    x = np.asarray(x)
    return x.astype(np.float32) if x.dtype.name == "bfloat16" else x


@pytest.mark.parametrize("bits,k", FORMATS)
def test_pack_and_dequantize_bitwise(bits, k):
    rng = np.random.default_rng(bits * 8 + k)
    jx, tx = _bf16_pair(rng, (2, 9, 3, 48))
    jf, tf = jkv.KVFormat(bits, k, 48), kvcache.KVFormat(bits, k, 48)
    jcodes, js, jz = jkv.quantize_kv(jx, jf)
    codes, s, z = kvcache.quantize_kv(tx, tf)
    for a, b in ((codes, jcodes), (s, js), (z, jz)):
        np.testing.assert_array_equal(_np(a), _np(b))
    assert s.dtype == z.dtype == torch.bfloat16
    jp = jax.jit(jkv.pack_kv, static_argnums=1)(jx, jf)
    tp = kvcache.pack_kv(tx, tf)
    assert tp["p"].dtype == torch.uint8
    assert tuple(tp["p"].shape) == (tf.planes, 2, 9, 3, tf.packed_d)
    for key in ("p", "s", "z"):
        np.testing.assert_array_equal(_np(tp[key]), _np(jp[key]))
    deq = kvcache.dequantize_kv(codes, s, z)
    for want in (jax.jit(jkv.dequantize_kv)(jcodes, js, jz),
                 jkv.dequantize_kv(jcodes, js, jz)):
        np.testing.assert_array_equal(_np(deq), _np(want))
    np.testing.assert_array_equal(_np(kvcache.unpack_codes(tp["p"], tf)),
                                  _np(jcodes))


@pytest.mark.parametrize("bits,k", FORMATS)
def test_unpack_equals_qdq_inside_the_port(bits, k):
    rng = np.random.default_rng(100 + bits * 8 + k)
    _, x = _bf16_pair(rng, (2, 7, 2, 32))
    x[0, 0, 0] = 0.75  # a constant row: scale 0, every code dequantizes
    f = kvcache.KVFormat(bits, k, 32)  # to the row value
    got = kvcache.unpack_kv(kvcache.pack_kv(x, f), f)
    assert torch.equal(got, kvcache.qdq_kv(x, f))
    assert torch.equal(got[0, 0, 0], x[0, 0, 0])


def test_format_fields_and_token_bytes():
    for bits, k in FORMATS:
        for d in (48, 100, 128):
            a, b = kvcache.KVFormat(bits, k, d), jkv.KVFormat(bits, k, d)
            assert (a.planes, a.digits_per_byte, a.packed_d, a.levels) == \
                (b.planes, b.digits_per_byte, b.packed_d, b.levels)
            assert kvcache.kv_token_bytes(a, 8) == jkv.kv_token_bytes(b, 8)
    for bad in ((3, 2), (8, 3), (2, 4), (16, 4)):
        with pytest.raises(ValueError):
            kvcache.KVFormat(bad[0], bad[1], 64)


@pytest.mark.parametrize("plan_file", ["granite_8b_mixed.json",
                                       "granite_8b_draft_w2.json"])
def test_plan_v2_resolves_as_the_jax_package(plan_file):
    path = PLANS / plan_file
    mine, theirs = tplan.PrecisionPlan.load(path), jplan.PrecisionPlan.load(path)
    assert mine.to_json() == theirs.to_json()
    assert mine.kv_enabled() == theirs.kv_enabled()
    assert mine.kv_store() == theirs.kv_store()
    api = configs.get("granite-8b")
    cfg = api.cfg
    jcfg = JT.TransformerConfig(**{
        f: getattr(cfg, f) for f in ("name", "n_layers", "d_model", "n_heads",
                                     "n_kv", "d_ff", "vocab", "act")})
    assert api.kv_layer_names() == JT.kv_layer_names(jcfg)
    assert api.plan_layer_names() == JT.plan_layer_names(jcfg)
    assert api.kv_cache_workload() == JT.kv_cache_workload(jcfg)
    for name in api.kv_layer_names():
        bits = mine.kv_bits_for(name)
        assert bits == theirs.kv_bits_for(name) == tplan.resolve_kv_bits(
            mine, name), name
        if bits is not None:
            assert mine.kv_slice(bits) == theirs.kv_slice(bits)
    for name in api.plan_layer_names():
        assert dataclasses_equal(mine.policy_for(name),
                                 theirs.policy_for(name)), name
    assert T.scan_format_groups(cfg, mine) == \
        JT.scan_format_groups(jcfg, theirs)
    fmts = T.kv_formats(cfg, mine)
    jfmts = JT._kv_formats(jcfg, theirs)
    assert fmts[0] == jfmts[0]
    assert [tuple(None if f is None else (f.bits, f.k, f.d) for f in pair)
            for pair in fmts[1]] == \
        [tuple(None if f is None else (f.bits, f.k, f.d) for f in pair)
         for pair in jfmts[1]]
    stripped = tplan.strip_kv(mine)
    assert not stripped.kv_enabled()
    assert stripped.to_json() == jplan.strip_kv(theirs).to_json()
    assert T.kv_formats(cfg, stripped) is None
    tplan.validate_plan_json(path)


def dataclasses_equal(a, b) -> bool:
    fields = ("a_bits", "inner_bits", "boundary_bits", "k", "channel_wise",
              "variant", "quantize")
    return all(getattr(a, f) == getattr(b, f) for f in fields)


def test_plan_v2_refusals(tmp_path):
    obj = json.loads((PLANS / "granite_8b_mixed.json").read_text())
    obj["version"] = 1
    for plan_mod in (tplan, jplan):
        with pytest.raises(ValueError, match="version"):
            plan_mod.PrecisionPlan.from_json(obj)
    with pytest.raises(ValueError, match="kv_bits"):
        tplan.PrecisionPlan.from_json(
            {"version": 2, "default": {"w_bits": 4, "kv_bits": 4}})
    with pytest.raises(ValueError):
        tplan.KVCachePlan(bits=3)
    with pytest.raises(ValueError, match="store"):
        tplan.KVCachePlan(bits=4, store="fp8")
    bad = dict(obj, version=2, layers={"q": {"w_bits": 4, "kv_bits": 4}})
    path = tmp_path / "bad_kv_plan.json"
    path.write_text(json.dumps(bad))
    with pytest.raises(ValueError, match="no KV cache"):
        tplan.validate_plan_json(path, arch="granite-8b")


def test_streamed_decode_packed_equals_qdq_and_jax():
    rng = np.random.default_rng(7)
    b, s, h, kvh, d = 2, 48, 8, 2, 32
    jq, q = _bf16_pair(rng, (b, 1, h, d))
    jk, k = _bf16_pair(rng, (b, s, kvh, d))
    jv, v = _bf16_pair(rng, (b, s, kvh, d))
    fk, fv = kvcache.KVFormat(4, 4, d), kvcache.KVFormat(2, 2, d)
    jfk, jfv = jkv.KVFormat(4, 4, d), jkv.KVFormat(2, 2, d)
    for window in (None, 9):
        op = attn.decode_attention_streamed(
            q, kvcache.pack_kv(k, fk), kvcache.pack_kv(v, fv), fk, fv, 37,
            window=window, chunk=16)
        oq = attn.decode_attention_streamed(
            q, kvcache.qdq_kv(k, fk), kvcache.qdq_kv(v, fv), None, None, 37,
            window=window, chunk=16)
        assert torch.equal(op, oq)
        want = jattn.decode_attention_streamed(
            jq, jkv.pack_kv(jk, jfk), jkv.pack_kv(jv, jfv), jfk, jfv,
            jnp.asarray(37, jnp.int32), window=window, chunk=16)
        # f32 sums in another order can move a bf16-rounded probability by
        # one ulp: held to a bf16 ulp of the largest output
        np.testing.assert_allclose(_np(op), _np(want), rtol=0,
                                   atol=2 ** -7 * np.abs(_np(want)).max())
        full = attn.decode_attention(q, k, v, 37, window=window)
        jfull = jattn.decode_attention(jq, jk, jv, jnp.asarray(37, jnp.int32),
                                       window=window)
        np.testing.assert_allclose(_np(full), _np(jfull), rtol=0,
                                   atol=2 ** -7 * np.abs(_np(jfull)).max())


@pytest.mark.parametrize("eq", ["bkgd,bskd->bkgs", "bkgs,bskd->bkgd"])
@pytest.mark.parametrize("b,s", [(1, 7), (3, 40)])
def test_fixed_order_products_equal_einsum(eq, b, s):
    """The card's form of the decode attention's two products
    (``attn._fixed_order_einsum``, an elementwise product and one sum)
    computes the einsum: within 1e-5 of it in float64 on bf16 operands."""
    g = torch.Generator().manual_seed(b * 100 + s)
    bf = lambda *shape: torch.randn(shape, generator=g).bfloat16().float()  # noqa: E731
    y = bf(b, s, 2, 16)
    x = bf(b, 2, 4, 16) if eq.startswith("bkgd") else bf(b, 2, 4, s)
    got = attn._fixed_order_einsum(eq, x, y)
    want = torch.einsum(eq, x.double(), y.double())
    assert got.dtype == torch.float32 and got.shape == want.shape
    assert float((got.double() - want).abs().max()) <= 1e-5
    with pytest.raises(ValueError, match="no fixed-order form"):
        attn._fixed_order_einsum("bqd,bkd->bqk", x[:, 0], y[:, :, 0])
