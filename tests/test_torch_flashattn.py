"""The plain versions of K3 and K4 against the JAX package's flash attention.

The port's ``flash_attention`` / ``flash_attention_packed`` with
``impl="torch"`` (the plain versions the CPU runs, and that
``chip_smoke.py`` holds the kernels against on the card) are compared with
``repro.kernels.flashattn.ops`` run through its Pallas kernels in interpret
mode, as ``tests/test_flashattn.py`` runs them, on the same numpy inputs:
GQA, a window, ``q_offset``, ragged Sq and Sk (the reference's padding and
forced causality), and the cache formats of ``granite_8b_mixed.json``.

Tolerance: f32 I/O within 1e-5 absolute (the reference's own kernel-vs-
oracle probe found differences up to 6e-7; the sums run in another order);
bf16 I/O within one bf16 ulp of the larger of the two values, plus that
1e-5 for outputs near zero, where a weighted average that cancels shows the
f32 sum order in more than its last bf16 bit.
"""
import pytest

torch = pytest.importorskip("torch")

import jax.numpy as jnp  # noqa: E402
import numpy as np  # noqa: E402

from repro.kernels.flashattn import ops as jops  # noqa: E402
from repro.kernels.flashattn import ref as jref  # noqa: E402
from repro.nn import attention as jattn  # noqa: E402
from repro.nn import kvcache as jkv  # noqa: E402
from repro_torch.kernels.flashattn import ops, ref  # noqa: E402
from repro_torch.nn import attention as attn  # noqa: E402
from repro_torch.nn import kvcache  # noqa: E402


def _pair(rng, shape, dtype):
    x = rng.normal(size=shape).astype(np.float32)
    if dtype == "bf16":
        j = jnp.asarray(x, jnp.bfloat16)
        return j, torch.from_numpy(np.asarray(j.astype(jnp.float32))).to(
            torch.bfloat16)
    return jnp.asarray(x), torch.from_numpy(x)


def _np(x):
    if isinstance(x, torch.Tensor):
        return x.to(torch.float32).numpy()
    return np.asarray(jnp.asarray(x).astype(jnp.float32))


def _bf16_ulp(x):
    """Spacing of bf16 values at |x| (8 significant bits)."""
    _, e = np.frexp(np.maximum(np.abs(x), 2.0 ** -126))
    return np.ldexp(1.0, e - 8)


def _assert_close(got, want, dtype):
    g, w = _np(got), _np(want)
    assert g.shape == w.shape
    if dtype == "f32":
        np.testing.assert_allclose(g, w, rtol=0, atol=1e-5)
    else:
        bound = _bf16_ulp(np.maximum(np.abs(g), np.abs(w))) + 1e-5
        err = np.abs(g - w)
        assert (err <= bound).all(), (err.max(), int((err > bound).sum()))


CASES = [
    # (b, sq, sk, h, kv, d, kwargs, I/O dtype)
    (2, 64, 64, 4, 4, 32, {}, "f32"),                     # MHA, aligned
    (2, 64, 64, 8, 2, 32, {}, "bf16"),                    # GQA 8:2
    (1, 50, 50, 4, 2, 32, {}, "f32"),                     # ragged: pad + causal
    (2, 64, 64, 8, 2, 32, {"window": 20}, "bf16"),
    (1, 8, 96, 4, 2, 32, {"q_offset": 88}, "f32"),        # continuation chunk
    (1, 40, 40, 4, 1, 32, {"causal": False}, "bf16"),     # padded -> causal
    (1, 32, 32, 4, 2, 32, {"causal": False}, "f32"),      # bidirectional
]


@pytest.mark.parametrize("case", CASES)
def test_plain_k3_matches_jax(case):
    b, sq, sk, h, kvh, d, kw, dtype = case
    rng = np.random.default_rng(sq * 7 + sk + h)
    jq, q = _pair(rng, (b, sq, h, d), dtype)
    jk, k = _pair(rng, (b, sk, kvh, d), dtype)
    jv, v = _pair(rng, (b, sk, kvh, d), dtype)
    want = jops.flash_attention(jq, jk, jv, block_q=32, block_k=32, **kw)
    got = ops.flash_attention(q, k, v, block_k=32, impl="torch", **kw)
    assert got.dtype == q.dtype
    _assert_close(got, want, dtype)


# the three cache formats of granite_8b_mixed.json, then K and V apart; the
# ragged Sk = 40 pads to the 16-key block
PACKED_CASES = [((2, 2), (2, 2), {}, "f32"), ((4, 4), (4, 4), {}, "bf16"),
                ((8, 4), (8, 4), {}, "f32"), ((2, 2), (4, 4), {}, "bf16"),
                ((8, 4), (2, 2), {"window": 12}, "f32")]


@pytest.mark.parametrize("fk,fv,kw,dtype", PACKED_CASES)
def test_plain_k4_matches_jax(fk, fv, kw, dtype):
    b, sq, sk, h, kvh, d = 2, 40, 40, 8, 2, 32
    rng = np.random.default_rng(fk[0] * 10 + fv[0])
    jq, q = _pair(rng, (b, sq, h, d), dtype)
    jk, k = _pair(rng, (b, sk, kvh, d), "bf16")
    jv, v = _pair(rng, (b, sk, kvh, d), "bf16")
    jfk, jfv = jkv.KVFormat(*fk, d), jkv.KVFormat(*fv, d)
    tfk, tfv = kvcache.KVFormat(*fk, d), kvcache.KVFormat(*fv, d)
    want = jops.flash_attention_packed(
        jq, jkv.pack_kv(jk, jfk), jkv.pack_kv(jv, jfv), jfk, jfv,
        block_q=16, block_k=16, **kw)
    got = ops.flash_attention_packed(
        q, kvcache.pack_kv(k, tfk), kvcache.pack_kv(v, tfv), tfk, tfv,
        block_k=16, impl="torch", **kw)
    _assert_close(got, want, dtype)


@pytest.mark.parametrize("dtype", ["f32", "bf16"])
def test_plain_k4_continuation_matches_jax(dtype):
    b, sq, sk, h, kvh, d = 1, 4, 37, 4, 2, 32
    rng = np.random.default_rng(11)
    jq, q = _pair(rng, (b, sq, h, d), dtype)
    jk, k = _pair(rng, (b, sk, kvh, d), "bf16")
    jv, v = _pair(rng, (b, sk, kvh, d), "bf16")
    jf, tf = jkv.KVFormat(8, 4, d), kvcache.KVFormat(8, 4, d)
    want = jops.flash_attention_packed(
        jq, jkv.pack_kv(jk, jf), jkv.pack_kv(jv, jf), jf, jf, q_offset=33,
        block_q=16, block_k=16)
    got = ops.flash_attention_packed(
        q, kvcache.pack_kv(k, tf), kvcache.pack_kv(v, tf), tf, tf,
        q_offset=33, block_k=16, impl="torch")
    _assert_close(got, want, dtype)


def test_oracles_match_jax():
    rng = np.random.default_rng(3)
    b, s, h, kvh, d = 1, 24, 4, 2, 32
    jq, q = _pair(rng, (b, s, h, d), "f32")
    jk, k = _pair(rng, (b, s, kvh, d), "bf16")
    jv, v = _pair(rng, (b, s, kvh, d), "bf16")
    jfk, jfv = jkv.KVFormat(4, 4, d), jkv.KVFormat(2, 2, d)
    tfk, tfv = kvcache.KVFormat(4, 4, d), kvcache.KVFormat(2, 2, d)
    kx, jkx = ref.expand_kv_heads(k, h), jnp.repeat(jk, h // kvh, axis=2)
    vx, jvx = ref.expand_kv_heads(v, h), jnp.repeat(jv, h // kvh, axis=2)
    _assert_close(ref.attention_ref(q, kx.float(), vx.float(), window=7),
                  jref.attention_ref(jq, jkx.astype(jnp.float32),
                                     jvx.astype(jnp.float32), window=7),
                  "f32")
    qdq = ref.attention_qdq_ref(q, k, v, tfk, tfv)
    _assert_close(qdq, jref.attention_qdq_ref(jq, jk, jv, jfk, jfv), "f32")
    packed = ref.attention_packed_ref(q, kvcache.pack_kv(k, tfk),
                                      kvcache.pack_kv(v, tfv), tfk, tfv)
    assert torch.equal(packed, qdq)  # unpack_kv(pack_kv(x)) == qdq_kv(x)


@pytest.mark.parametrize("kw", [{"window": 9}, {"causal": False}])
def test_chunked_attention_matches_jax(kw):
    rng = np.random.default_rng(5)
    b, s, h, d = 2, 40, 4, 32
    jq, q = _pair(rng, (b, s, h, d), "bf16")
    jk, k = _pair(rng, (b, s, h, d), "bf16")
    jv, v = _pair(rng, (b, s, h, d), "bf16")
    want = jattn.chunked_attention(jq, jk, jv, chunk=16, **kw)
    got = attn.chunked_attention(q, k, v, chunk=16, **kw)
    g, w = _np(got), _np(want)
    # bf16 probabilities may round one ulp apart (f32 sums in another order)
    np.testing.assert_allclose(g, w, rtol=0, atol=2 ** -7 * np.abs(w).max())


def test_impl_cuda_on_cpu_tensors_raises():
    """A CPU tensor asked to run on the card raises; nothing falls back."""
    q = torch.zeros((1, 4, 2, 32))
    with pytest.raises(ValueError, match="CUDA"):
        ops.flash_attention(q, q, q, impl="cuda")
    with pytest.raises(ValueError, match="impl"):
        ops.flash_attention(q, q, q, impl="pallas")
