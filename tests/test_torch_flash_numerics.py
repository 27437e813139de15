"""The numeric design of the tensor-core flash kernels K3 and K4, on the CPU.

``csrc/flash_fwd.cu`` and ``csrc/flash_fwd_packed.cu`` run both products on
bf16 tensor cores (exact products, f32 sums) and keep f32 accuracy by
splitting f32 values into bf16 terms (``csrc/flash_common.cuh``).  The
kernels themselves run only on a card (``tests/test_torch_cuda.py``); this
file emulates their arithmetic in plain torch and holds it to the contract
the card tests hold the kernels to:

- QK^T on the raw q (bf16 I/O: one bf16 term a side; f32 I/O: three), the
  softmax scale applied to the f32 score after; K4's score
  ``scale * s_k * (q . c) + z_k * sum(q * scale)`` on the codes centred on
  ``2^(bits - 1)`` (exact bf16 values ``c``) with ``z_k`` the zero point
  moved to match;
- an online softmax over tiles of 64 keys (32 for K3's wgmma route, bf16 at
  D 128) in f32 on scores in the log2 domain
  (``score * log2 e``, the scale folded in), ``p = exp2(s - m)``, masked
  scores ``-1e30``;
- PV on the weights split into ``p_hi + p_lo`` (bf16 I/O; three terms and
  three-term V with f32 I/O), K4's weights ``p * s_v`` against the codes and
  its V zero one f32 sum per row; term pairs (i, j) with i + j <= 2.

Tolerances: bf16 I/O within one bf16 ulp of the larger value plus 1e-5 of
the plain versions ``flash_fwd_torch`` / ``flash_fwd_packed_torch`` (f32
sums in another order may round an output the other way); f32 I/O within
1e-5 of the function evaluated in float64.  The last test shows why the
split is there: the naive bf16 recipe (q * scale and p rounded to bf16)
misses the bf16 bound.
"""
import math

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro_torch.kernels.flashattn import kernel as fk  # noqa: E402
from repro_torch.nn import kvcache  # noqa: E402

BKV = 64
NEG_INF = -1e30
LOG2E = 1.4426950408889634
B, H, KV = 2, 8, 2


# --- the kernels' arithmetic ----------------------------------------------------


def _split(x: torch.Tensor, terms: int):
    """f32 -> ``terms`` bf16-valued f32 tensors summing to x (8 bits each)."""
    out = []
    for _ in range(terms):
        t = x.to(torch.bfloat16).to(torch.float32)
        out.append(t)
        x = x - t
    return out


def _product(eq: str, a_terms, b_terms) -> torch.Tensor:
    """sum over term pairs (i, j), i + j <= 2, smallest first; bf16 x bf16
    products are exact in f32, the sums are f32."""
    acc = None
    for total in (2, 1, 0):
        for i, a in enumerate(a_terms):
            j = total - i
            if 0 <= j < len(b_terms):
                t = torch.einsum(eq, a, b_terms[j])
                acc = t if acc is None else acc + t
    return acc


def _visible(sq, sk_total, kv0, kv1, *, causal, window, q_offset):
    q_pos = q_offset + torch.arange(sq)[:, None]
    key = torch.arange(kv0, kv1)[None, :]
    ok = torch.ones((sq, kv1 - kv0), dtype=torch.bool)
    if causal:
        ok &= key <= q_pos
    if window is not None:
        ok &= key > q_pos - window
    return ok


def _online(q5, sk_total, score, pv, *, causal, window, q_offset, z_of=None,
            keys=BKV):
    """The kernels' sweep: tiles of `keys` scores in the log2 domain
    (score * log2 e), running max m, sum l, f32 accumulator o (and K4's V
    zero sum z), all rescaled by alpha = 2^(m_old - m_new)."""
    b, kvh, g, sq, d = q5.shape
    m = torch.full((b, kvh, g, sq), NEG_INF)
    l = torch.zeros((b, kvh, g, sq))
    z = torch.zeros((b, kvh, g, sq))
    o = torch.zeros((b, kvh, g, sq, d))
    for kv0 in range(0, sk_total, keys):
        kv1 = min(kv0 + keys, sk_total)
        s = score(kv0, kv1)
        ok = _visible(sq, sk_total, kv0, kv1, causal=causal, window=window,
                      q_offset=q_offset)
        s = torch.where(ok, s, torch.full_like(s, NEG_INF))
        m_new = torch.maximum(m, s.amax(dim=-1))
        alpha = torch.exp2(m - m_new)
        p = torch.exp2(s - m_new[..., None])
        l = l * alpha + p.sum(dim=-1)
        o = o * alpha[..., None] + pv(p, kv0, kv1)
        if z_of is not None:
            z = z * alpha + z_of(p, kv0, kv1)
        m = m_new
    return (o + z[..., None]) / torch.clamp_min(l, 1e-30)[..., None]


def _finish(o5, like):
    b, sq, h, d = like.shape
    return o5.permute(0, 3, 1, 2, 4).reshape(b, sq, h, d).to(like.dtype)


def _terms(dtype):
    """(terms of q / K / V, terms of the PV weights) by I/O dtype."""
    return (1, 2) if dtype == torch.bfloat16 else (3, 3)


def emulate_k3(q, k, v, *, causal, window, q_offset, pad_k, naive=False):
    b, sq, h, d = q.shape
    kvh = k.shape[2]
    scale = d ** -0.5
    tq, tp = _terms(q.dtype)
    pad = lambda x: torch.nn.functional.pad(  # noqa: E731
        x.to(torch.float32), (0, 0, 0, 0, 0, pad_k)).permute(0, 2, 1, 3)
    kf, vf = pad(k), pad(v)                       # (B, KV, Sk_total, D)
    q5 = q.to(torch.float32).reshape(b, sq, kvh, h // kvh, d).permute(
        0, 2, 3, 1, 4)                            # (B, KV, G, Sq, D)
    scale2 = torch.tensor(scale * LOG2E, dtype=torch.float32)
    if naive:   # q * scale rounded to bf16, p rounded to bf16
        q_terms = [(q5 * scale).to(torch.bfloat16).float()]
        tp, scale2 = 1, torch.tensor(LOG2E, dtype=torch.float32)
    else:
        q_terms = _split(q5, tq)
    k_terms, v_terms = _split(kf, tq), _split(vf, tq)

    def score(kv0, kv1):
        raw = _product("bkgqd,bksd->bkgqs", q_terms,
                       [t[:, :, kv0:kv1] for t in k_terms])
        return raw * scale2

    def pv(p, kv0, kv1):
        return _product("bkgqs,bksd->bkgqd", _split(p, tp),
                        [t[:, :, kv0:kv1] for t in v_terms])

    # bf16 at D 128 runs on wgmma and scores 32 keys at a time
    keys = 32 if q.dtype == torch.bfloat16 and d == 128 else BKV
    o = _online(q5, kf.shape[2], score, pv, causal=causal, window=window,
                q_offset=q_offset, keys=keys)
    return _finish(o, q)


def _fma_f32(a, b, c):
    """f32 fused multiply-add: the exact a * b + c, rounded once."""
    return (a.double() * b.double() + c.double()).to(torch.float32)


def emulate_k4(q, kq, vq, fmt_k, fmt_v, *, causal, window, q_offset, pad_k):
    b, sq, h, d = q.shape
    kvh = kq["s"].shape[2]
    scale = d ** -0.5
    tq, tp = _terms(q.dtype)
    pad_codes = lambda leaf, fmt: torch.nn.functional.pad(  # noqa: E731
        kvcache.unpack_codes(leaf["p"], fmt).to(torch.float32),
        (0, 0, 0, 0, 0, pad_k)).permute(0, 2, 1, 3)
    per_key = lambda t: torch.nn.functional.pad(  # noqa: E731
        t.to(torch.float32), (0, 0, 0, pad_k)).permute(0, 2, 1)[:, :, None,
                                                                None, :]
    # codes centred on 2^(bits - 1) (exact in bf16), zero z + center * s
    ck, cv = (float(2 ** (f.planes * f.k - 1)) for f in (fmt_k, fmt_v))
    kc, vc = pad_codes(kq, fmt_k) - ck, pad_codes(vq, fmt_v) - cv
    sk_, sv_ = per_key(kq["s"]), per_key(vq["s"])
    zk_ = _fma_f32(torch.tensor(ck), sk_, per_key(kq["z"]))
    zv_ = _fma_f32(torch.tensor(cv), sv_, per_key(vq["z"]))
    q5 = q.to(torch.float32).reshape(b, sq, kvh, h // kvh, d).permute(
        0, 2, 3, 1, 4)
    q_terms = _split(q5, tq)
    log2e = torch.tensor(LOG2E, dtype=torch.float32)
    scale2 = torch.tensor(scale, dtype=torch.float32) * log2e
    q_sum = (q5 * scale).sum(dim=-1)[..., None] * log2e

    def score(kv0, kv1):
        raw = _product("bkgqd,bksd->bkgqs", q_terms, [kc[:, :, kv0:kv1]])
        return _fma_f32(q_sum, zk_[..., kv0:kv1],
                        (raw * scale2) * sk_[..., kv0:kv1])

    def pv(p, kv0, kv1):
        return _product("bkgqs,bksd->bkgqd", _split(p * sv_[..., kv0:kv1], tp),
                        [vc[:, :, kv0:kv1]])

    def z_of(p, kv0, kv1):
        return (p * zv_[..., kv0:kv1]).sum(dim=-1)

    o = _online(q5, kc.shape[2], score, pv, causal=causal, window=window,
                q_offset=q_offset, z_of=z_of)
    return _finish(o, q)


# --- references -------------------------------------------------------------------


def float64_attention(q, k, v, *, causal, window, q_offset, pad_k):
    """The function in float64 on the exact inputs; k/v (B, Sk, KV, D)."""
    b, sq, h, d = q.shape
    kvh = k.shape[2]
    pad = lambda x: torch.nn.functional.pad(  # noqa: E731
        x.double(), (0, 0, 0, 0, 0, pad_k)).repeat_interleave(h // kvh, dim=2)
    k64, v64 = pad(k), pad(v)
    s = torch.einsum("bqhd,bkhd->bhqk", q.double() * d ** -0.5, k64)
    ok = _visible(sq, k64.shape[1], 0, k64.shape[1], causal=causal,
                  window=window, q_offset=q_offset)
    s = s.masked_fill(~ok, NEG_INF)
    return torch.einsum("bhqk,bkhd->bqhd", torch.softmax(s, -1), v64)


def _bf16_ulp(x):
    _, e = torch.frexp(x.abs().clamp_min(2.0 ** -126))
    return torch.ldexp(torch.ones_like(x), e - 8)


def _excess(got, want):
    """Largest |got - want| beyond one bf16 ulp of the larger value + 1e-5
    (<= 0 when within)."""
    g, w = got.float(), want.float()
    bound = _bf16_ulp(torch.maximum(g.abs(), w.abs())) + 1e-5
    return float(((g - w).abs() - bound).max())


def _inputs(seed, sq, sk, d, dtype):
    rng = np.random.default_rng(seed)
    mk = lambda *shape: torch.from_numpy(  # noqa: E731
        rng.normal(size=shape).astype(np.float32)).to(dtype)
    return mk(B, sq, H, d), mk(B, sk, KV, d), mk(B, sk, KV, d)


# (sq, sk, q_offset): a ragged prefill and the verify chunk at an offset
SHAPES = [(200, 200, 0), (9, 200, 191)]
# masks and the reference wrapper's padding rows
MASKS = [dict(causal=True, window=None, pad_k=24),
         dict(causal=True, window=48, pad_k=0),
         dict(causal=False, window=None, pad_k=0)]
DTYPES = [torch.bfloat16, torch.float32]


def _id(x):
    if isinstance(x, tuple):
        return "sq%d_sk%d_off%d" % x
    if isinstance(x, dict):
        return ("causal" if x["causal"] else "full") + (
            f"_w{x['window']}" if x["window"] else "") + f"_pad{x['pad_k']}"
    return str(x).replace("torch.", "")


@pytest.mark.parametrize("dtype", DTYPES, ids=_id)
@pytest.mark.parametrize("mask", MASKS, ids=_id)
@pytest.mark.parametrize("d", [64, 128])
@pytest.mark.parametrize("shape", SHAPES, ids=_id)
def test_k3_arithmetic_meets_the_contract(shape, d, mask, dtype):
    sq, sk, q_offset = shape
    q, k, v = _inputs(sq + d + q_offset, sq, sk, d, dtype)
    kw = dict(mask, q_offset=q_offset)
    got = emulate_k3(q, k, v, **kw)
    assert got.dtype == dtype and got.shape == q.shape
    if dtype == torch.bfloat16:
        want = fk.flash_fwd_torch(q, k, v, **kw)
        assert _excess(got, want) <= 0.0
    else:
        err = (got.double() - float64_attention(q, k, v, **kw)).abs().max()
        assert float(err) <= 1e-5, float(err)


# the cache formats of granite_8b_mixed.json (kv2 k2, kv4 k4, kv8 k4), and K
# and V in different formats
FORMATS = [((2, 2), (2, 2)), ((4, 4), (4, 4)), ((8, 4), (8, 4)),
           ((2, 2), (4, 4)), ((8, 4), (2, 2))]


@pytest.mark.parametrize("dtype", DTYPES, ids=_id)
@pytest.mark.parametrize("shape", SHAPES, ids=_id)
@pytest.mark.parametrize("fmts", FORMATS,
                         ids=lambda f: "k%d%d_v%d%d" % (*f[0], *f[1]))
def test_k4_arithmetic_meets_the_contract(fmts, shape, dtype):
    sq, sk, q_offset = shape
    d = 128
    _check_k4(fmts, sq, sk, d, dtype,
              dict(causal=True, window=None, pad_k=24, q_offset=q_offset))


@pytest.mark.parametrize("dtype", DTYPES, ids=_id)
@pytest.mark.parametrize("mask", MASKS[1:], ids=_id)
def test_k4_arithmetic_d64_masks(mask, dtype):
    _check_k4(((4, 4), (2, 2)), 200, 200, 64, dtype, dict(mask, q_offset=0))


def _check_k4(fmts, sq, sk, d, dtype, kw):
    (bk, sk_slice), (bv, sv_slice) = fmts
    q, k, v = _inputs(bk * 10 + bv + sq + d, sq, sk, d, dtype)
    fmt_k = kvcache.KVFormat(bk, sk_slice, d)
    fmt_v = kvcache.KVFormat(bv, sv_slice, d)
    kq = kvcache.pack_kv(k.to(torch.bfloat16), fmt_k)
    vq = kvcache.pack_kv(v.to(torch.bfloat16), fmt_v)
    got = emulate_k4(q, kq, vq, fmt_k, fmt_v, **kw)
    assert got.dtype == dtype and got.shape == q.shape
    if dtype == torch.bfloat16:
        want = fk.flash_fwd_packed_torch(
            q, kq["p"], kq["s"], kq["z"], vq["p"], vq["s"], vq["z"],
            k_slice=sk_slice, v_slice=sv_slice, **kw)
        assert _excess(got, want) <= 0.0
    else:
        exact = lambda leaf, fmt: (  # noqa: E731
            kvcache.unpack_codes(leaf["p"], fmt).double()
            * leaf["s"].double()[..., None] + leaf["z"].double()[..., None])
        want = float64_attention(q, exact(kq, fmt_k), exact(vq, fmt_v), **kw)
        err = (got.double() - want).abs().max()
        assert float(err) <= 1e-5, float(err)


# --- K4's decode of the digit planes (bit operations of flash_fwd_packed.cu) -----


def _byte_perm(x, y, sel):
    """CUDA's __byte_perm on uint32 arrays: byte k of the result is byte
    (sel >> 4k) & 7 of the 8 bytes (x, y)."""
    src = [(x >> (8 * i)) & 0xFF for i in range(4)] + [
        (y >> (8 * i)) & 0xFF for i in range(4)]
    out = np.zeros_like(x)
    for k in range(4):
        out |= src[(sel >> (4 * k)) & 7] << (8 * k)
    return out


def _digits_to_nibbles(w, k):
    if k == 1:
        w = (w | (w << 12)) & 0x000F000F
        w = (w | (w << 6)) & 0x03030303
        w = (w | (w << 3)) & 0x11111111
    elif k == 2:
        w = (w | (w << 8)) & 0x00FF00FF
        w = (w | (w << 4)) & 0x0F0F0F0F
        w = (w | (w << 2)) & 0x33333333
    return w


def _bf16_halves(bits):
    """uint32 holding two bf16 -> (low, high) as float32."""
    lo = ((bits & 0xFFFF) << 16).astype(np.uint32).view(np.float32)
    hi = (bits & 0xFFFF0000).astype(np.uint32).view(np.float32)
    return lo, hi


def kernel_decode(planes, k, d):
    """The kernel's decode of planes (P, N, pd) uint8 -> (N, d) centred codes
    c - 2^(bits - 1), op for op: digits of a 16-byte chunk as k bytes of each
    plane, nibbles spread to bytes by byte permutes, and the bf16 bits
    0x4300 | (c & 127) minus bf16(128 + center) or bf16(center)."""
    n_planes = planes.shape[0]
    bits = n_planes * k
    wide = bits == 8
    center = 2 ** (bits - 1)
    sub_const = np.uint32(0x00010001 * (
        np.array([128 + center], np.float32).view(np.uint32)[0] >> 16))
    out = np.zeros((planes.shape[1], d), np.float32)
    for j in range(d // 8):
        lo = np.zeros(planes.shape[1], np.uint32)
        hi = np.zeros(planes.shape[1], np.uint32)
        for p in range(n_planes):
            w = np.zeros(planes.shape[1], np.uint64)
            for byte in range(k):        # k bytes, little-endian
                w |= planes[p, :, j * k + byte].astype(np.uint64) << (8 * byte)
            if k == 8:
                lo, hi = (w & 0xFFFFFFFF).astype(np.uint32), (w >> 32).astype(
                    np.uint32)
                continue
            w = _digits_to_nibbles(w.astype(np.uint32), k)
            even, odd = w & 0x0F0F0F0F, (w >> 4) & 0x0F0F0F0F
            lo |= _byte_perm(even, odd, 0x5140) << (k * p)
            hi |= _byte_perm(even, odd, 0x7362) << (k * p)
        for half, word in enumerate((lo, hi)):
            for pair in range(2):
                t = _byte_perm(word, np.zeros_like(word),
                               0x4342 if pair else 0x4140)
                if wide:
                    v = (t & 0x007F007F) | 0x43004300
                    sub = np.uint32(0x43804380) - (t & 0x00800080)
                else:
                    v, sub = t | 0x43004300, sub_const
                (v0, v1), (s0, s1) = _bf16_halves(v), _bf16_halves(sub)
                col = 8 * j + 4 * half + 2 * pair
                out[:, col], out[:, col + 1] = v0 - s0, v1 - s1
    return out


@pytest.mark.parametrize("bits,k", [(2, 1), (2, 2), (4, 1), (4, 2), (4, 4),
                                    (8, 1), (8, 2), (8, 4), (8, 8)])
@pytest.mark.parametrize("d", [64, 128])
def test_kernel_decode_gives_centred_codes(bits, k, d):
    """Every cache format: the kernel's bit operations give exactly
    unpack_codes - 2^(bits - 1), each an integer of at most 8 significant
    bits (exact in bf16)."""
    rng = np.random.default_rng(bits * 10 + k + d)
    fmt = kvcache.KVFormat(bits, k, d)
    x = torch.from_numpy(rng.normal(size=(3, 50, 2, d)).astype(np.float32))
    leaf = kvcache.pack_kv(x.to(torch.bfloat16), fmt)
    planes = leaf["p"].numpy().reshape(leaf["p"].shape[0], -1,
                                       leaf["p"].shape[-1])
    want = (kvcache.unpack_codes(leaf["p"], fmt).reshape(-1, d).numpy()
            .astype(np.float32) - 2 ** (bits - 1))
    got = kernel_decode(planes, k, d)
    np.testing.assert_array_equal(got, want)
    assert np.abs(got).max() <= 128
    as_bf16 = torch.from_numpy(got).to(torch.bfloat16).float().numpy()
    np.testing.assert_array_equal(as_bf16, got)


def test_split_terms_carry_f32():
    """Three bf16 terms hold an f32 value exactly; two hold 16 bits."""
    x = torch.from_numpy(np.random.default_rng(1).normal(
        size=4096).astype(np.float32))
    three = _split(x, 3)
    assert torch.equal(three[0] + three[1] + three[2], x)
    two = _split(x, 2)
    rel = ((two[0] + two[1] - x).abs() / x.abs()).max()
    assert float(rel) <= 2.0 ** -16


def test_naive_bf16_recipe_misses_the_contract():
    """Pre-scaled q rounded to bf16 and p rounded to bf16 (one PV term)
    move outputs by more than one bf16 ulp: the reason for the split."""
    q, k, v = _inputs(5, 200, 200, 128, torch.bfloat16)
    kw = dict(causal=True, window=None, pad_k=24, q_offset=0)
    want = fk.flash_fwd_torch(q, k, v, **kw)
    assert _excess(emulate_k3(q, k, v, **kw), want) <= 0.0
    assert _excess(emulate_k3(q, k, v, naive=True, **kw), want) > 0.0
    assert math.isfinite(_excess(emulate_k3(q, k, v, naive=True, **kw), want))
