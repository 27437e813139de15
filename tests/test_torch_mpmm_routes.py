"""K1's two CUDA routes, checked on the CPU through numpy twins of their
arithmetic.

The kernels themselves (``csrc/mpmm_wgmma.cu``, ``csrc/mpmm_splitk.cu``)
run only on the card, where ``test_torch_cuda.py`` and ``chip_smoke.py``
hold them bitwise against ``mpmm_torch``.  Here:

- the route rule (``kernel.mpmm_route``) at every granite-8b and ResNet-18
  shape of the serve paths, and at the M = 16 / 17 boundary;
- the split plan (``kernel.split_plan``) as a property: byte-aligned,
  non-empty chunks that cover K exactly;
- the bit assembly, as a numpy twin with the same shifts, masks, byte
  permutes and per-lane sign extension as ``csrc/mpmm_bits.cuh``, run
  through route A's thread mapping and shared-memory swizzles and route
  B's digit groups: bitwise equal to ``ref.combined_int8_weights`` for
  all 16 (w, k) formats, k > w among them, and to the JAX package's
  ``ops.combined_int8_weights`` except at k = 8 with w < 8, where that
  function skips the sign extension (its ``ref`` is held there instead);
  the Sum-Apart digit tiles equal ``unpack_planes`` of each plane;
- route B's int32 partial sums over the split plan, added, bitwise equal
  to ``ref.mpmm_ref_codes`` here and in the JAX package;
- route A's 128-byte swizzle: a tile written through the kernel's store
  addressing reads back unchanged through the descriptor's addressing.
"""
import math

import pytest

torch = pytest.importorskip("torch")

import jax.numpy as jnp  # noqa: E402
import numpy as np  # noqa: E402

try:
    from hypothesis import given, settings, strategies as st
except ImportError:  # pragma: no cover
    from _hypothesis_stub import given, settings, st

from repro.core import packing as jpacking  # noqa: E402
from repro.kernels.mpmm import ops as jops  # noqa: E402
from repro.kernels.mpmm import ref as jref  # noqa: E402
from repro_torch import configs  # noqa: E402
from repro_torch.core import packing  # noqa: E402
from repro_torch.kernels.mpmm import kernel, ref  # noqa: E402

FORMATS = [(w, k) for w in (1, 2, 4, 8) for k in (1, 2, 4, 8)]
U32 = np.uint32


def jax_combined_is_exact(w, k):
    """Whether the JAX package's ``ops.combined_int8_weights`` (and so its
    ``impl="xla"`` product) decodes this format: not at k = 8 with w < 8."""
    return not (k == 8 and w < 8)


# --- numpy twin of csrc/mpmm_bits.cuh -----------------------------------------


def prmt(a, b, sel):
    """PTX prmt.b32 (default mode): output byte i is byte (sel >> 4i) & 7
    of the pair {b, a} (a the low four bytes)."""
    a, b = np.asarray(a, U32), np.asarray(b, U32)
    src = [(a >> U32(8 * i)) & U32(0xFF) for i in range(4)]
    src += [(b >> U32(8 * i)) & U32(0xFF) for i in range(4)]
    out = np.zeros_like(a)
    for i in range(4):
        out |= src[(sel >> (4 * i)) & 7] << U32(8 * i)
    return out


def vsub4(a, b):
    """__vsub4: lane-wise byte subtraction, no borrow across lanes."""
    out = np.zeros_like(np.asarray(a, U32))
    for i in range(4):
        x = (a >> U32(8 * i)) & U32(0xFF)
        y = (b >> U32(8 * i)) & U32(0xFF)
        out |= ((x + U32(256) - y) & U32(0xFF)) << U32(8 * i)
    return out


def lane_mask(k):
    return U32(0x01010101 * ((1 << k) - 1))


def sext_lanes(u, bits):
    if bits == 8:
        return u
    s = U32(0x01010101 << (bits - 1))
    return vsub4(u ^ s, s)


def n_planes(w, k):
    """Format::P: w/k planes, or one where k > w."""
    return max(w // k, 1)


def field_bits(w, k):
    """Format::FB: the code bits of a field, k, or w where k > w."""
    return min(w, k)


def field(x, p, j, w, k):
    f = 8 // k
    return (x[p][j // f] >> U32(k * (j % f))) & lane_mask(field_bits(w, k))


def code_word(x, j, w, k):
    u = np.zeros_like(x[0][0])
    for p in range(n_planes(w, k)):
        u |= field(x, p, j, w, k) << U32(k * p)
    return sext_lanes(u, w)


def digit_word(x, p, j, w, k):
    u = field(x, p, j, w, k)
    return sext_lanes(u, field_bits(w, k)) if p == n_planes(w, k) - 1 else u


def transpose4(r):
    t0 = prmt(r[0], r[1], 0x5140)
    t1 = prmt(r[0], r[1], 0x7362)
    t2 = prmt(r[2], r[3], 0x5140)
    t3 = prmt(r[2], r[3], 0x7362)
    return [prmt(t0, t2, 0x5410), prmt(t0, t2, 0x7632),
            prmt(t1, t3, 0x5410), prmt(t1, t3, 0x7632)]


def word_bytes(word):
    """uint32 word(s) -> their four bytes as int8, lane 0 first."""
    word = np.asarray(word, U32)
    return np.stack([((word >> U32(8 * i)) & U32(0xFF)).astype(np.uint8)
                     for i in range(4)], axis=-1).view(np.int8)


def read_word(buf, off):
    return U32(int.from_bytes(bytes(buf[off:off + 4]), "little"))


# --- route A: csrc/mpmm_wgmma.cu's stage layout, decode and swizzles -----------

BK = BN = 128


def swizzled(row, k):
    """mpmm_bits.cuh wg::swz: byte k of row `row` of a 128-byte-swizzled
    K-major tile (the kernel's store addressing)."""
    return row * 128 + ((((k >> 4) ^ row) & 7) << 4) + (k & 15)


def descriptor_read(tile, rows):
    """What wgmma reads through the kernel's descriptor (128-byte swizzle,
    start advanced 32 bytes a k32 slice): the hardware XORs address bits
    4-6 with bits 7-9 of the linear address."""
    out = np.zeros((rows, BK), np.uint8)
    for kk in range(BK // 32):
        for r in range(rows):
            for j in range(32):
                lin = r * 128 + 32 * kk + j
                out[r, 32 * kk + j] = tile[lin ^ (((lin >> 7) & 7) << 4)]
    return out


def raw_off(plane_row, kb, c, k):
    f = 8 // k
    return plane_row * 128 + ((c ^ ((kb * f // 16) & 7)) << 4)


def stage_raw(planes_tile, k):
    """The packed bytes of one K-step (P, 16k rows, 128 columns) as the
    cp.async ring slot holds them: 16-byte chunks at raw_off."""
    p_, rr, _ = planes_tile.shape
    raw = np.zeros(p_ * rr * 128, np.uint8)
    for p in range(p_):
        for kb in range(rr):
            for c in range(8):
                off = raw_off(p * rr + kb, kb, c, k)
                raw[off:off + 16] = planes_tile[p, kb, 16 * c:16 * c + 16]
    return raw


def decode_stage_twin(raw, w, k, plane=None):
    """csrc/mpmm_wgmma.cu decode_stage, thread by thread: (warp h, lane
    8a + b) reads 2k words of each plane it needs, assembles 16 code words
    (or plane `plane`'s digits), transposes them and stores four 16-byte
    column rows at chunk b of the swizzled B tile."""
    f, p_ = 8 // k, n_planes(w, k)
    rr, r_ = BK // f, 2 * k
    bt = np.zeros(BN * BK, np.uint8)
    planes_read = range(p_) if plane is None else [plane]
    for h in range(8):
        for a in range(4):
            for b in range(8):
                x = [[read_word(raw, raw_off(pl * rr + b * r_ + r, b * r_ + r,
                                             h, k) + 4 * a)
                      for r in range(r_)] for pl in planes_read]
                col = [[None] * 4 for _ in range(4)]
                for q in range(4):
                    if plane is None:
                        ws = [code_word(x, 4 * q + i, w, k) for i in range(4)]
                    else:
                        ws = [field(x, 0, 4 * q + i, w, k)
                              for i in range(4)]
                        if plane == p_ - 1:
                            ws = [sext_lanes(u, field_bits(w, k))
                                  for u in ws]
                    ws = transpose4(ws)
                    for c in range(4):
                        col[c][q] = ws[c]
                for c in range(4):
                    n = 16 * h + 4 * a + c
                    off = n * 128 + (((b ^ n) & 7) << 4)
                    bt[off:off + 16] = np.concatenate(
                        [word_bytes(col[c][q]).view(np.uint8)
                         for q in range(4)])
    return bt


def random_planes(rng, kdim, n, w, k):
    codes = rng.integers(-(2 ** (w - 1)), 2 ** (w - 1), (kdim, n))
    fmt = packing.PlaneFormat(w_bits=w, k=k, k_dim=kdim)
    planes = packing.pack_planes(torch.from_numpy(codes.astype(np.int32)),
                                 fmt)
    return codes, fmt, planes


@pytest.mark.parametrize("w,k", FORMATS)
def test_route_a_decode_twin_gives_combined_weights(w, k):
    rng = np.random.default_rng(w * 16 + k)
    codes, fmt, planes = random_planes(rng, BK, BN, w, k)
    bt = decode_stage_twin(stage_raw(planes.numpy(), k), w, k)
    got = descriptor_read(bt, BN).view(np.int8).T  # (K, N)
    want = ref.combined_int8_weights(planes, fmt).numpy()
    jfmt = jpacking.PlaneFormat(w_bits=w, k=k, k_dim=BK)
    jplanes = jnp.asarray(planes.numpy())
    want_jax = (jops.combined_int8_weights(jplanes, jfmt)
                if jax_combined_is_exact(w, k)
                else jref.unpack_to_int(jplanes, jfmt).astype(jnp.int8))
    np.testing.assert_array_equal(got, want)
    np.testing.assert_array_equal(got, np.asarray(want_jax))
    np.testing.assert_array_equal(got, codes.astype(np.int8))


@pytest.mark.parametrize("w,k", FORMATS)
def test_route_a_sum_apart_digit_tiles(w, k):
    rng = np.random.default_rng(100 + w * 16 + k)
    _, fmt, planes = random_planes(rng, BK, BN, w, k)
    raw = stage_raw(planes.numpy(), k)
    digits = packing.unpack_planes(planes, fmt).numpy()  # (P, K, N)
    for p in range(fmt.planes):
        bt = decode_stage_twin(raw, w, k, plane=p)
        got = descriptor_read(bt, BN).view(np.int8).T
        np.testing.assert_array_equal(got, digits[p])


@pytest.mark.parametrize("rows", [64, 128, 256])
def test_swizzled_tile_reads_back_through_the_descriptor(rows):
    rng = np.random.default_rng(rows)
    tile = rng.integers(0, 256, (rows, BK)).astype(np.uint8)
    by_chunk = np.zeros(rows * 128, np.uint8)  # the cp.async 16-byte path
    by_byte = np.zeros(rows * 128, np.uint8)   # the byte-load path
    for r in range(rows):
        for c in range(8):
            off = r * 128 + (((c ^ r) & 7) << 4)
            by_chunk[off:off + 16] = tile[r, 16 * c:16 * c + 16]
        for kk in range(BK):
            by_byte[swizzled(r, kk)] = tile[r, kk]
    np.testing.assert_array_equal(by_chunk, by_byte)
    np.testing.assert_array_equal(descriptor_read(by_chunk, rows), tile)
    # each 64-row product's descriptor starts a multiple of 8192 bytes in
    for r0 in range(0, rows, 64):
        np.testing.assert_array_equal(
            descriptor_read(by_chunk[r0 * 128:], 64), tile[r0:r0 + 64])


@pytest.mark.parametrize("k", [1, 2, 4, 8])
def test_stage_layout_is_conflict_free_for_the_decode(k):
    """The raw-slot swizzle: the 32 lanes of a decoding warp read 32
    distinct banks for every (plane row) word they load, and each quarter
    warp's 16-byte B stores hit 8 distinct chunks."""
    r_ = 2 * k
    for h in range(8):
        for r in range(r_):
            banks = set()
            for a in range(4):
                for b in range(8):
                    kb = b * r_ + r
                    banks.add((raw_off(kb, kb, h, k) + 4 * a) // 4 % 32)
            assert len(banks) == 32
        for a in range(4):
            for c in range(4):
                n = 16 * h + 4 * a + c
                assert len({(b ^ n) & 7 for b in range(8)}) == 8


# --- route B: csrc/mpmm_splitk.cu's digit groups and partial sums -------------


def dp4a(x, y):
    """__dp4a(x, y, 0): the sum of the four signed byte products."""
    return (word_bytes(x).astype(np.int64)
            * word_bytes(y).astype(np.int64)).sum(-1)


def splitk_twin(a_biased, planes, fmt, plan, variant="st"):
    """Route B's partials (S, M, N) int32: each block's digit groups, its
    registers' bit assembly, byte transpose and dp4a, over the split plan."""
    m, kdim = a_biased.shape
    p_, kp, n = planes.shape
    w, k, f = fmt.w_bits, fmt.k, fmt.digits_per_byte
    rows = max(1, 4 // f)
    g_ = rows * f
    n4 = -(-n // 4) * 4
    pl = np.zeros((p_, kp, n4), np.uint8)  # columns past N read as zero
    pl[:, :, :n] = planes
    words = pl.reshape(p_, kp, n4 // 4, 4).view("<u4")[..., 0]
    out = np.zeros((plan.splits, m, n4), np.int64)
    for s, (b0, b1) in enumerate(plan.byte_ranges(fmt)):
        ngroups = -(-(b1 - b0) // rows)
        a_s = np.zeros((m, ngroups * g_), np.int8)
        k0, k1 = b0 * f, min(b1 * f, kdim)
        a_s[:, :k1 - k0] = a_biased[:, k0:k1]
        for g in range(ngroups):
            x = [[words[p, b0 + g * rows + r] if b0 + g * rows + r < b1
                  else np.zeros(n4 // 4, U32) for r in range(rows)]
                 for p in range(p_)]
            for d4 in range(g_ // 4):
                kk = g * g_ + 4 * d4
                av = a_s[:, kk:kk + 4].copy().view("<u4")[:, 0]
                terms = ([(0, [code_word(x, 4 * d4 + i, w, k)
                               for i in range(4)])] if variant == "st" else
                         [(p, [digit_word(x, p, 4 * d4 + i, w, k)
                               for i in range(4)]) for p in range(p_)])
                for p, ws in terms:
                    ws = transpose4(ws)
                    for c in range(4):
                        for row in range(m):
                            out[s, row, c::4] += (dp4a(ws[c], av[row])
                                                  << (k * p))
    return out[:, :, :n].astype(np.int32)


@pytest.mark.parametrize("variant", ["st", "sa"])
@pytest.mark.parametrize("w,k", FORMATS)
@pytest.mark.parametrize("m,kdim,n", [(4, 700, 70), (13, 333, 37)])
def test_split_k_partials_add_up_to_the_reference(w, k, m, kdim, n, variant):
    rng = np.random.default_rng(w * 100 + k * 10 + m)
    _, fmt, planes = random_planes(rng, kdim, n, w, k)
    a = rng.integers(-128, 128, (m, kdim)).astype(np.int8)
    plan = kernel.split_plan(m, kdim, n, fmt)
    assert plan.splits > 1
    parts = splitk_twin(a, planes.numpy(), fmt, plan, variant)
    w8 = ref.combined_int8_weights(planes, fmt).numpy().astype(np.int64)
    colsum = w8.sum(0)
    got = (parts.astype(np.int64).sum(0) + 128 * colsum).astype(np.int32)
    want = ref.mpmm_ref_codes(torch.from_numpy(a), planes, fmt,
                              act_zero=128).numpy()
    jfmt = jpacking.PlaneFormat(w_bits=w, k=k, k_dim=kdim)
    want_jax = np.asarray(jref.mpmm_ref_codes(
        jnp.asarray(a), jnp.asarray(planes.numpy()), jfmt, act_zero=128))
    np.testing.assert_array_equal(got, want)
    np.testing.assert_array_equal(got, want_jax)
    # each partial is that chunk's own product
    for (d0, d1), part in zip(plan.digit_ranges(fmt), parts):
        np.testing.assert_array_equal(
            part, a[:, d0:d1].astype(np.int64) @ w8[d0:d1])


@pytest.mark.parametrize("w,k", [(4, 4), (2, 2), (8, 4), (1, 8)])
def test_bank_partials_add_up_per_expert(w, k):
    """A bank of E products in one route-B launch: every group runs the
    bank's plan on its own operands (offset by its group), and its
    partials add up to its own product."""
    rng = np.random.default_rng(w * 10 + k)
    e, m, kdim, n = 3, 4, 1500, 40
    plan = kernel.split_plan(m, kdim, n, packing.PlaneFormat(w, k, kdim), e)
    assert plan.splits > 1
    for _ in range(e):
        _, fmt, planes = random_planes(rng, kdim, n, w, k)
        a = rng.integers(-128, 128, (m, kdim)).astype(np.int8)
        parts = splitk_twin(a, planes.numpy(), fmt, plan, "st")
        w8 = ref.combined_int8_weights(planes, fmt).numpy().astype(np.int64)
        got = (parts.astype(np.int64).sum(0) + 128 * w8.sum(0)).astype(
            np.int32)
        np.testing.assert_array_equal(got, ref.mpmm_ref_codes(
            torch.from_numpy(a), planes, fmt, act_zero=128).numpy())


# --- the route rule and the split plan -------------------------------------


def _lm_shapes():
    cfg = configs.get("granite-8b").cfg
    hd = cfg.hd
    proj = [(cfg.d_model, cfg.n_heads * hd), (cfg.d_model, cfg.n_kv * hd),
            (cfg.n_heads * hd, cfg.d_model), (cfg.d_model, cfg.d_ff),
            (cfg.d_ff, cfg.d_model)]
    head = (cfg.d_model, cfg.vocab)
    cases = [("prefill", 4 * 1000, kd, n, "wgmma") for kd, n in proj]
    cases += [(f"decode b{b}", b, kd, n, "splitk") for b in (1, 2, 3, 4)
              for kd, n in proj + [head]]
    cases += [("head after prefill", 4, *head, "splitk")]
    return cases


def _resnet_shapes():
    cfg = configs.get("resnet18").cfg
    hw = cfg.img_size // 2
    cases = []
    for b in (1, 2, 4, 8):
        cases.append((f"stem b{b}", b * hw * hw, 147, cfg.width, "wgmma"))
        cases.append((f"fc b{b}", b, cfg.fc_in, cfg.n_classes, "splitk"))
    return cases


# The expert banks' rows per expert (olmoe and deepseek prefill at 4 x 1000
# tokens: capacity 250 and 187 a row; decode: capacity 1) and MLA's uk at
# decode over the whole cache (4 x 1016 rows)
MOE_SHAPES = [("olmoe bank prefill", 1000, 2048, 1024, "wgmma"),
              ("olmoe bank decode", 4, 2048, 1024, "splitk"),
              ("deepseek bank prefill", 748, 2048, 1408, "wgmma"),
              ("deepseek bank decode", 4, 1408, 2048, "splitk"),
              ("deepseek uk decode", 4 * 1016, 512, 2048, "wgmma")]

BOUNDARY = [("M 16", 16, 4096, 4096, "splitk"),
            ("M 17", 17, 4096, 4096, "wgmma"),
            ("M 1", 1, 45, 70, "splitk")]


@pytest.mark.parametrize("name,m,kdim,n,route",
                         _lm_shapes() + _resnet_shapes() + MOE_SHAPES
                         + BOUNDARY,
                         ids=lambda v: v if isinstance(v, str) else None)
def test_route_rule(name, m, kdim, n, route):
    assert kernel.mpmm_route(m, kdim, n) == route
    fmt = packing.PlaneFormat(w_bits=8, k=4, k_dim=kdim)
    ws = kernel.workspace_bytes(m, kdim, n, fmt)
    if route == "wgmma":
        assert ws == 0
    else:
        assert ws == kernel.split_plan(m, kdim, n, fmt).splits * m * n * 4


@pytest.mark.parametrize("m,kdim,n", [(4, 14336, 4096), (4, 4096, 14336),
                                      (4, 4096, 49152), (4, 4096, 1024),
                                      (8, 512, 1000)])
def test_split_plan_fills_the_card_at_the_path_shapes(m, kdim, n):
    """granite-8b's decode projections and head, and the ResNet-18
    classifier at batch 8: enough blocks for the 132 SMs where K allows."""
    fmt = packing.PlaneFormat(w_bits=8, k=4, k_dim=kdim)
    plan = kernel.split_plan(m, kdim, n, fmt)
    blocks = math.ceil(n / kernel.strip_cols(m)) * plan.splits
    max_splits = math.ceil(fmt.packed_k / (kernel.SPLITK_MIN_GROUPS
                                           * kernel.SPLITK_WARPS * 2))
    assert blocks >= 132 or plan.splits >= max_splits


@settings(max_examples=300, deadline=None)
@given(m=st.integers(1, 16), kdim=st.integers(1, 40000),
       n=st.integers(1, 70000), fmt_i=st.integers(0, len(FORMATS) - 1),
       groups=st.sampled_from([1, 1, 2, 8, 64, 160]))
def test_split_plan_property(m, kdim, n, fmt_i, groups):
    """The plan of one product, or of a bank of ``groups`` products in one
    launch (each group runs the same chunks)."""
    w, k = FORMATS[fmt_i]
    fmt = packing.PlaneFormat(w_bits=w, k=k, k_dim=kdim)
    f = fmt.digits_per_byte
    plan = kernel.split_plan(m, kdim, n, fmt, groups)
    assert plan.splits <= kernel.split_plan(m, kdim, n, fmt).splits
    group_rows = max(1, 4 // f)
    assert plan.chunk_bytes % group_rows == 0
    assert plan.chunk_bytes * f <= kernel.SPLITK_MAX_CHUNK_DIGITS
    bytes_ = plan.byte_ranges(fmt)
    digits = plan.digit_ranges(fmt)
    assert len(bytes_) == plan.splits >= 1
    assert bytes_[0][0] == 0 and bytes_[-1][1] == fmt.packed_k
    assert digits[0][0] == 0 and digits[-1][1] == kdim
    for (b0, b1), (d0, d1) in zip(bytes_, digits):
        assert b1 > b0 and d1 > d0          # no chunk is empty
        assert d0 == b0 * f                 # starts on a whole byte
    for (_, e), (s, _) in zip(bytes_, bytes_[1:]):
        assert e == s                       # contiguous, no overlap
    for (_, e), (s, _) in zip(digits, digits[1:]):
        assert e == s


def test_route_counters_start_at_zero_per_route():
    assert set(kernel.mpmm_cuda.routes) == set(kernel.ROUTES)
    assert all(isinstance(v, int) for v in kernel.mpmm_cuda.routes.values())
