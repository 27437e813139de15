"""K2 (implicit-GEMM conv on int8 tensor cores) checked on the CPU through
numpy twins of its index math.

The kernel itself (``csrc/conv_mpmm.cu``) runs only on the card, where
``test_torch_cuda.py`` and ``chip_smoke.py`` hold it bitwise against
``conv_mpmm_torch``.  Here:

- the A-tile loader, thread by thread: each 16-byte chunk's output pixel,
  tap and channel slice from the block's row table, the ``-act_zero`` fill
  outside the image, the byte path where C % 16 != 0, and the 128-byte
  swizzle, rebuild exactly ``ref.gather_patches(ref.pad_spatial(x, ...))``
  at every ResNet-18/50/152 conv shape and at odd geometries;
- the B-tile decode at both N tiles (the shared ``tc::decode_stage`` of
  ``csrc/mpmm_bits.cuh``): at 128 columns it is route A's, at 64 two warps
  share a 16-column chunk;
- ``conv_kernel.conv_plan`` as a property: whole K-steps covering K once,
  none empty, and a grid of at least 132 blocks or at most two K-steps a
  block, asserted at every ResNet-18 conv at batches 1 and 8;
- split partials, summed in split order and by the last block to arrive,
  equal the unsplit accumulator under Sum-Together and Sum-Apart.
"""
import dataclasses
import itertools
import math

import pytest

torch = pytest.importorskip("torch")

import numpy as np  # noqa: E402

try:
    from hypothesis import given, settings, strategies as st
except ImportError:  # pragma: no cover
    from _hypothesis_stub import given, settings, st

import test_torch_mpmm_routes as k1twin  # noqa: E402
from repro_torch import configs  # noqa: E402
from repro_torch.core import packing  # noqa: E402
from repro_torch.kernels.mpmm import conv_kernel, ops, ref  # noqa: E402
from repro_torch.models import resnet as R  # noqa: E402

BM, BK, THREADS = conv_kernel.BM, conv_kernel.BK, 256
FORMATS = k1twin.FORMATS


# --- the convs K2 runs in the paper's ResNets --------------------------------


def resnet_convs(arch):
    """(cin, cout, kernel, stride, h_in) of every conv of ``arch`` at full
    size that the serve path sends to K2 (the stem goes to im2col)."""
    cfg = configs.get(arch).cfg
    h = cfg.img_size // 4  # stem stride 2, max-pool stride 2
    out = []
    for _, _, cin, cmid, stride in R._block_channels(cfg):
        ho = -(-h // stride)
        cout = cmid * cfg.expansion
        if stride != 1 or cin != cout:
            out.append((cin, cout, 1, stride, h))
        if cfg.block == "bottleneck":
            out += [(cin, cmid, 1, 1, h), (cmid, cmid, 3, stride, h),
                    (cmid, cout, 1, 1, ho)]
        else:
            out += [(cin, cmid, 3, stride, h), (cmid, cmid, 3, 1, ho)]
        h = ho
    return out


def distinct_convs():
    seen = {}
    for arch in ("resnet18", "resnet50", "resnet152"):
        for conv in resnet_convs(arch):
            seen.setdefault(conv, arch)
    return [(arch, *conv) for conv, arch in seen.items()]


def test_resnet_conv_lists():
    assert len(resnet_convs("resnet18")) == 19
    # 3 + 4 + 6 + 3 bottlenecks of three convs, plus four projections
    assert len(resnet_convs("resnet50")) == 16 * 3 + 4
    assert len(resnet_convs("resnet152")) == 50 * 3 + 4


# --- numpy twin of conv_mpmm.cu's A-tile loader ------------------------------


def row_table(m_pad, m, ho, wo, h, w, stride, pad_t, pad_l):
    """rows[r] of every block: (image base b*h*w, or -1 past M; oh*s -
    pad_top; ow*s - pad_left), for the flattened rows 0 .. m_pad - 1."""
    gm = np.arange(m_pad)
    img = gm // (ho * wo)
    rem = gm - img * (ho * wo)
    oh = rem // wo
    ow = rem - oh * wo
    base = np.where(gm < m, img * h * w, -1)
    return base, oh * stride - pad_t, ow * stride - pad_l


def a_matrix_twin(x, kh, kw, stride, padding, act_zero):
    """The (M, K) patch matrix as K2's loader stages it, K-step by K-step,
    into the 128-byte-swizzled A tiles of every block, read back through
    the products' addressing; and the padded (rows, steps * BK) matrix the
    tiles hold, to check that rows past M and digits past K are zero."""
    b, h, w, c = x.shape
    (ho, wo), (pad_t, _), (pad_l, _) = conv_kernel.conv_out_hw(
        h, w, kh, kw, stride, padding)
    m, kd = b * ho * wo, kh * kw * c
    m_tiles, k_steps = math.ceil(m / BM), math.ceil(kd / BK)
    base, ih0, iw0 = row_table(m_tiles * BM, m, ho, wo, h, w, stride, pad_t,
                               pad_l)
    fill = np.uint8(np.int8(-act_zero).view(np.uint8))
    xf = x.reshape(-1).view(np.uint8)
    vec = c % 16 == 0
    smem = np.zeros((m_tiles, k_steps, BM * 128), np.uint8)
    blocks = np.arange(m_tiles)[:, None]
    if vec:
        tid = np.arange(THREADS)
        chunk = tid & 7
        # each (row, chunk) of a tile is one thread's, once
        pairs = {(int(t >> 3) + 32 * j, int(t & 7))
                 for t in tid for j in range(BM * 8 // THREADS)}
        assert len(pairs) == BM * 8
        # first_tap: divided once, then advanced one K-step a load
        kk = 16 * chunk
        tap = kk // c
        cc = kk - tap * c
        ki = tap // kw
        kj = tap - ki * kw
        for t in range(k_steps):
            in_k = kk < kd
            for j in range(BM * 8 // THREADS):
                r = (tid >> 3) + j * (THREADS // 8)        # (THREADS,)
                gm = blocks * BM + r                        # (tiles, THREADS)
                ih, iw = ih0[gm] + ki, iw0[gm] + kj
                inside = (ih >= 0) & (ih < h) & (iw >= 0) & (iw < w)
                load = in_k & (base[gm] >= 0) & inside
                filled = in_k & (base[gm] >= 0) & ~inside
                src = (base[gm] + ih * w + iw) * c + cc
                dst = r * 128 + (((chunk ^ r) & 7) << 4)
                for byte in range(16):
                    vals = np.where(load, xf[np.where(load, src, 0) + byte],
                                    np.where(filled, fill, 0))
                    smem[blocks, t, dst + byte] = vals
            kk, cc = kk + BK, cc + BK
            while (cc >= c).any():
                wrap = cc >= c
                cc = np.where(wrap, cc - c, cc)
                kj = np.where(wrap, kj + 1, kj)
                ki = np.where(wrap & (kj == kw), ki + 1, ki)
                kj = np.where(wrap & (kj == kw), 0, kj)
    else:  # byte loads: thread tid takes bytes tid, tid + 256, ...
        i = np.arange(BM * BK)
        r, k = i // BK, i % BK
        dst = r * 128 + ((((k >> 4) ^ r) & 7) << 4) + (k & 15)  # wg::swz
        for t in range(k_steps):
            kk = t * BK + k
            in_k = kk < kd
            tap = kk // c
            cc = kk - tap * c
            ki = tap // kw
            gm = blocks * BM + r
            ih, iw = ih0[gm] + ki, iw0[gm] + tap - ki * kw
            inside = (ih >= 0) & (ih < h) & (iw >= 0) & (iw < w)
            live = in_k & (base[gm] >= 0)
            src = (base[gm] + ih * w + iw) * c + cc
            vals = np.where(live & inside,
                            xf[np.where(live & inside, src, 0)],
                            np.where(live, fill, 0))
            smem[blocks, t, dst] = vals
    # read every tile back the way wgmma's descriptor walks it
    lin = np.arange(BM * 128)
    phys = lin ^ (((lin >> 7) & 7) << 4)
    tiles = smem[:, :, phys].reshape(m_tiles, k_steps, BM, BK)
    full = tiles.transpose(0, 2, 1, 3).reshape(m_tiles * BM, k_steps * BK)
    return full.view(np.int8), m, kd


def oracle_patches(x, kh, kw, stride, padding, act_zero):
    xp = ref.pad_spatial(torch.from_numpy(x), kh, kw, stride, padding,
                         fill=-act_zero)
    p = ref.gather_patches(xp, kh, kw, stride)
    return p.reshape(-1, p.shape[-1]).numpy()


def check_loader(x, kh, stride, padding, act_zero):
    full, m, kd = a_matrix_twin(x, kh, kh, stride, padding, act_zero)
    np.testing.assert_array_equal(
        full[:m, :kd], oracle_patches(x, kh, kh, stride, padding, act_zero))
    assert not full[m:].any() and not full[:, kd:].any()


CONVS = distinct_convs()


@pytest.mark.parametrize("act_zero", [128, 0])
@pytest.mark.parametrize("arch,cin,cout,kk,stride,h", CONVS,
                         ids=[f"{a}-{c}to{o}-{k}x{k}s{s}-{h}"
                              for a, c, o, k, s, h in CONVS])
def test_a_loader_twin_rebuilds_the_patches(arch, cin, cout, kk, stride, h,
                                            act_zero):
    del arch, cout
    rng = np.random.default_rng(cin * 7 + kk * 3 + stride + h)
    x = rng.integers(-128, 128, (1, h, h, cin)).astype(np.int8)
    check_loader(x, kk, stride, "SAME", act_zero)


# odd geometries: VALID, asymmetric SAME pads, non-square, a 7x7 window,
# and C % 16 != 0 (byte loads): C = 8 (k = 4) and 24 (k = 2)
GEOMETRIES = [(2, 9, 8, 16, 3, 2, "SAME"), (2, 9, 8, 16, 3, 2, "VALID"),
              (1, 8, 8, 32, 3, 2, "SAME"), (1, 7, 7, 16, 3, 2, "SAME"),
              (2, 11, 11, 16, 7, 2, "SAME"), (1, 6, 5, 48, 1, 2, "SAME"),
              (2, 9, 8, 8, 3, 2, "SAME"), (1, 10, 10, 24, 3, 1, "SAME"),
              (2, 7, 9, 24, 3, 2, "VALID"), (1, 12, 12, 8, 1, 2, "SAME")]


@pytest.mark.parametrize("act_zero", [128, 0])
@pytest.mark.parametrize("b,h,w,c,kk,stride,padding", GEOMETRIES)
def test_a_loader_twin_odd_geometries(b, h, w, c, kk, stride, padding,
                                      act_zero):
    rng = np.random.default_rng(b * 1000 + h * 10 + c)
    x = rng.integers(-128, 128, (b, h, w, c)).astype(np.int8)
    check_loader(x, kk, stride, padding, act_zero)


def test_fill_is_the_code_of_a_float_zero():
    """Outside the image the loader stores -act_zero: biased, that is the
    unsigned code 0 (a float zero), not the code act_zero a zero byte
    would be."""
    x = np.full((1, 2, 2, 16), 5, np.int8)
    full, m, kd = a_matrix_twin(x, 3, 3, 1, "SAME", 128)
    patch = full[0, :kd].reshape(3, 3, 16)  # output (0, 0): taps at -1
    assert (patch[0] == -128).all() and (patch[:, 0] == -128).all()
    assert (patch[1:, 1:] == 5).all()
    assert (full[:m, :kd].astype(np.int32) + 128 >= 0).all()


# --- the B-tile decode at both N tiles (mpmm_bits.cuh tc::decode_stage) ------


def raw_off(plane_row, kb, c, k, bn):
    f = 8 // k
    return plane_row * bn + (((c ^ (kb * f // 16)) & (bn // 16 - 1)) << 4)


def stage_raw(planes_tile, k, bn):
    p_, rr, _ = planes_tile.shape
    raw = np.zeros(p_ * rr * bn, np.uint8)
    for p in range(p_):
        for kb in range(rr):
            for c in range(bn // 16):
                off = raw_off(p * rr + kb, kb, c, k, bn)
                raw[off:off + 16] = planes_tile[p, kb, 16 * c:16 * c + 16]
    return raw


def decode_stage_twin(raw, w, k, bn, plane=None):
    """tc::decode_stage thread by thread: thread (warp h, lane 8a + b) of
    CG = bn/16 chunks takes columns 16(h % CG) + 4a .. + 3 and DIG = 2 CG
    digits from (8 (h / CG) + b) DIG."""
    f, p_ = 8 // k, k1twin.n_planes(w, k)
    rr, cg = BK // f, bn // 16
    dig = 2 * cg
    r_ = dig // f
    bt = np.zeros(bn * BK, np.uint8)
    planes_read = range(p_) if plane is None else [plane]
    for h in range(8):
        for a in range(4):
            for b in range(8):
                ch, d0 = h % cg, (8 * (h // cg) + b) * dig
                kb0 = d0 // f
                x = [[k1twin.read_word(raw, raw_off(pl * rr + kb0 + r, kb0 + r,
                                                    ch, k, bn) + 4 * a)
                      for r in range(r_)] for pl in planes_read]
                col = [[None] * (dig // 4) for _ in range(4)]
                for q in range(dig // 4):
                    if plane is None:
                        ws = [k1twin.code_word(x, 4 * q + i, w, k)
                              for i in range(4)]
                    else:
                        ws = [k1twin.field(x, 0, 4 * q + i, w, k)
                              for i in range(4)]
                        if plane == p_ - 1:
                            ws = [k1twin.sext_lanes(u, k1twin.field_bits(w, k))
                                  for u in ws]
                    ws = k1twin.transpose4(ws)
                    for c in range(4):
                        col[c][q] = ws[c]
                for c in range(4):
                    n = 16 * ch + 4 * a + c
                    off = n * 128 + ((((d0 >> 4) ^ n) & 7) << 4) + (d0 & 15)
                    bt[off:off + dig] = np.concatenate(
                        [k1twin.word_bytes(col[c][q]).view(np.uint8)
                         for q in range(dig // 4)])
    return bt


@pytest.mark.parametrize("bn", conv_kernel.N_TILES)
@pytest.mark.parametrize("w,k", FORMATS)
def test_decode_twin_at_both_n_tiles(w, k, bn):
    rng = np.random.default_rng(w * 16 + k + bn)
    codes, fmt, planes = k1twin.random_planes(rng, BK, bn, w, k)
    raw = stage_raw(planes.numpy(), k, bn)
    bt = decode_stage_twin(raw, w, k, bn)
    got = k1twin.descriptor_read(bt, bn).view(np.int8).T  # (K, N)
    np.testing.assert_array_equal(got, ref.combined_int8_weights(
        planes, fmt).numpy())
    np.testing.assert_array_equal(got, codes.astype(np.int8))
    if bn == 128:  # the shared decode is route A's at 128 columns
        np.testing.assert_array_equal(raw,
                                      k1twin.stage_raw(planes.numpy(), k))
        np.testing.assert_array_equal(bt, k1twin.decode_stage_twin(raw, w, k))
    digits = packing.unpack_planes(planes, fmt).numpy()  # (P, K, N)
    for p in range(fmt.planes):  # Sum-Apart's digit tiles
        sa = decode_stage_twin(raw, w, k, bn, plane=p)
        np.testing.assert_array_equal(
            k1twin.descriptor_read(sa, bn).view(np.int8).T, digits[p])


# --- the plan ----------------------------------------------------------------


def check_plan(plan, b, ho, wo, n, kdim):
    assert plan.m == b * ho * wo
    assert plan.bm == BM and plan.bn in conv_kernel.N_TILES
    assert plan.bn >= min(n, 128) and (plan.bn == 64) == (n <= 64)
    assert plan.m_tiles == math.ceil(b * ho * wo / BM)
    assert plan.n_tiles == math.ceil(n / plan.bn)
    assert plan.k_steps == math.ceil(kdim / BK)
    ranges = plan.step_ranges()
    assert len(ranges) == plan.splits >= 1
    assert ranges[0][0] == 0 and ranges[-1][1] == plan.k_steps
    for t0, t1 in ranges:
        assert 0 < t1 - t0 <= plan.steps          # whole K-steps, not empty
    for (_, e), (s, _) in zip(ranges, ranges[1:]):
        assert e == s                             # contiguous, no overlap
    # the grid fills the card, or no block holds more than two K-steps
    assert plan.blocks >= conv_kernel.TARGET_BLOCKS or plan.steps <= 2
    # a split grid fits the per-tile counter buffer
    assert plan.splits == 1 or plan.tiles < conv_kernel.TARGET_BLOCKS


R18 = resnet_convs("resnet18")


@pytest.mark.parametrize("batch", [1, 8])
@pytest.mark.parametrize("cin,cout,kk,stride,h", R18)
def test_plan_fills_the_card_at_every_resnet18_conv(cin, cout, kk, stride, h,
                                                    batch):
    ho = -(-h // stride)
    kdim = kk * kk * cin
    fmt = packing.PlaneFormat(w_bits=4, k=4, k_dim=kdim)
    plan = conv_kernel.conv_plan(batch, ho, ho, cout, kdim, fmt)
    check_plan(plan, batch, ho, ho, cout, kdim)


@settings(max_examples=300, deadline=None)
@given(b=st.integers(1, 64), ho=st.integers(1, 112), wo=st.integers(1, 112),
       n=st.integers(1, 2048), taps=st.sampled_from([1, 9, 49]),
       c=st.integers(1, 128).map(lambda v: 8 * v),
       fmt_i=st.integers(0, len(FORMATS) - 1))
def test_plan_property(b, ho, wo, n, taps, c, fmt_i):
    w, k = FORMATS[fmt_i]
    kdim = taps * c
    fmt = packing.PlaneFormat(w_bits=w, k=k, k_dim=kdim)
    plan = conv_kernel.conv_plan(b, ho, wo, n, kdim, fmt)
    check_plan(plan, b, ho, wo, n, kdim)
    # the least modelled cost of every balanced split that meets the rule
    k_steps = plan.k_steps
    for splits in range(1, k_steps + 1):
        steps = math.ceil(k_steps / splits)
        other = dataclasses.replace(plan, steps=steps, splits=splits)
        if (other.fills_the_card() and math.ceil(k_steps / steps) == splits
                and (splits == 1 or plan.tiles < conv_kernel.TARGET_BLOCKS)):
            assert plan.cost_us() <= other.cost_us()


def test_plan_rejects_a_format_of_another_k():
    fmt = packing.PlaneFormat(w_bits=4, k=4, k_dim=576)
    with pytest.raises(ValueError, match="K="):
        conv_kernel.conv_plan(1, 56, 56, 64, 64, fmt)


def test_workspace_bytes():
    fmt = packing.PlaneFormat(w_bits=2, k=2, k_dim=4608)
    plan = conv_kernel.conv_plan(1, 7, 7, 512, 4608, fmt)
    assert plan.splits > 1 and plan.tiles == 4
    assert conv_kernel.workspace_bytes(plan) == (
        plan.splits * 4 * conv_kernel.BM * 128 * 4)
    fmt = packing.PlaneFormat(w_bits=8, k=4, k_dim=576)
    plan = conv_kernel.conv_plan(8, 56, 56, 64, 576, fmt)
    assert plan.splits == 1 and plan.tiles >= conv_kernel.TARGET_BLOCKS
    assert conv_kernel.workspace_bytes(plan) == 0


@pytest.mark.parametrize("bn", conv_kernel.N_TILES)
def test_split_staging_covers_the_tile(bn):
    """The split path's two maps of a 128 x bn tile: each thread's
    accumulator registers (acc_tile) and its 16-byte chunks (rows of bn/4
    chunks, thread t taking chunks t, t + 256, ...) each cover every
    element once, and the padded shared-memory rows keep 8-byte pairs
    4-byte aligned and 16-byte chunks 16-byte aligned."""
    ts = bn + 8  # conv_mpmm.cu TPAD
    by_acc = np.zeros((BM, bn), np.int32)
    for t in range(THREADS):
        lane = t & 31
        r0 = (t >> 7) * 64 + ((t >> 5) & 3) * 16 + (lane >> 2)
        for j in range(bn // 8):
            for i in range(2):
                for c in range(2):
                    by_acc[r0 + 8 * i, 8 * j + 2 * (lane & 3) + c] += 1
                off = ((r0 + 8 * i) * ts + 2 * (lane & 3) + 8 * j) * 4
                assert off % 8 == 0
    assert (by_acc == 1).all()
    cpr = bn // 4
    by_chunk = np.zeros((BM, bn), np.int32)
    for t in range(THREADS):
        for q in range(BM * cpr // THREADS):
            lin = t + q * THREADS
            r, c4 = lin // cpr, lin % cpr
            by_chunk[r, 4 * c4:4 * c4 + 4] += 1
            assert ((r * ts + 4 * c4) * 4) % 16 == 0
    assert (by_chunk == 1).all()


# --- split partials ----------------------------------------------------------


def int_mm(a, b):
    """The exact integer product of two integer matrices, through a
    float64 BLAS product: every partial sum is an integer below 2^53
    (asserted), so the float64 result is exact -- the same integers as
    an int64 product, which numpy computes without BLAS, tens of times
    slower at these shapes."""
    bound = (float(np.abs(a).max(initial=0)) * float(np.abs(b).max(initial=0))
             * a.shape[-1])
    assert bound < 2.0 ** 53, bound
    return (a.astype(np.float64) @ b.astype(np.float64)).astype(np.int64)


def split_partials(a, planes, fmt, plan, variant):
    """Each split's int32 partial as the kernel accumulates it: K-step by
    K-step, one product of the combined codes (Sum-Together) or one per
    plane shift-added (Sum-Apart)."""
    w8 = ref.combined_int8_weights(planes, fmt).numpy().astype(np.int64)
    digits = packing.unpack_planes(planes, fmt).numpy().astype(np.int64)
    a = a.astype(np.int64)
    parts = []
    for t0, t1 in plan.step_ranges():
        acc = np.zeros((a.shape[0], w8.shape[1]), np.int64)
        for t in range(t0, t1):
            sl = slice(t * BK, min((t + 1) * BK, fmt.k_dim))
            if variant == "st":
                acc += int_mm(a[:, sl], w8[sl])
            else:
                for p in range(fmt.planes):
                    acc += int_mm(a[:, sl], digits[p, sl]) * (1 << (fmt.k * p))
        parts.append(acc)
    return parts


@pytest.mark.parametrize("variant", ["st", "sa"])
@pytest.mark.parametrize("batch,h,cin,cout,kk,stride,w,k", [
    (1, 7, 512, 512, 3, 1, 2, 2),     # s3 at batch 1: 36 K-steps
    (8, 7, 512, 512, 3, 1, 2, 2),     # s3 at batch 8
    (1, 14, 256, 512, 1, 2, 4, 4),    # a 1x1/2 projection: 2 K-steps
    (1, 56, 64, 64, 3, 1, 8, 4),      # s0 at batch 1, C = 64
    (8, 56, 64, 128, 3, 2, 4, 4),     # 5 K-steps, ragged last run
])
def test_split_partials_add_up_to_the_accumulator(batch, h, cin, cout, kk,
                                                  stride, w, k, variant):
    """The fewest, the middle and the most splits a shape can take, and
    the plan's."""
    rng = np.random.default_rng(batch * 100 + h + cin)
    x = rng.integers(-128, 128, (batch, h, h, cin)).astype(np.int8)
    kdim = kk * kk * cin
    codes, fmt, planes = k1twin.random_planes(rng, kdim, cout, w, k)
    ho = -(-h // stride)
    a = oracle_patches(x, kk, kk, stride, "SAME", 128)
    want = int_mm(a, codes)
    # the plain version's accumulator is the same integers
    acc = ref.mpmm_ref_codes(torch.from_numpy(a), planes, fmt, act_zero=0)
    np.testing.assert_array_equal(acc.numpy(), want)
    plans = [p for p in conv_kernel.plan_candidates(batch, ho, ho, cout, kdim)
             if p.splits > 1]
    chosen = conv_kernel.conv_plan(batch, ho, ho, cout, kdim, fmt)
    picks = {plans[0], plans[len(plans) // 2], plans[-1]}
    for plan in sorted(picks | ({chosen} if chosen.splits > 1 else set()),
                       key=lambda p: p.splits):
        parts = split_partials(a, planes, fmt, plan, variant)
        in_order = np.zeros_like(want)
        for part in parts:                 # split order
            in_order += part
        np.testing.assert_array_equal(in_order, want)
        # the last block to arrive adds the others' partials to its own
        for last in {0, plan.splits - 1, plan.splits // 2}:
            total = parts[last].copy()
            for s, part in enumerate(parts):
                if s != last:
                    total += part
            np.testing.assert_array_equal(total.astype(np.int32),
                                          want.astype(np.int32))


# --- the fixed N tile at the ops level ---------------------------------------


@pytest.mark.parametrize("n", [8, 64, 96, 512])
def test_conv_accepts_only_the_n_tile_it_runs(n):
    rng = np.random.default_rng(n)
    _, fmt, planes = k1twin.random_planes(rng, 16, n, 4, 4)
    a = torch.from_numpy(rng.integers(-128, 128, (1, 2, 2, 16))
                         .astype(np.int8))
    gamma = torch.full((1, n), 0.01)
    colsum = torch.zeros((1, n), dtype=torch.int32)
    args = (a, planes, gamma, colsum)
    tile = conv_kernel.n_tile(n)
    want = ops.conv_mpmm(*args, fmt=fmt, kh=1, kw=1)
    assert torch.equal(ops.conv_mpmm(*args, fmt=fmt, kh=1, kw=1, bn=tile),
                       want)
    for other in set(itertools.chain(conv_kernel.N_TILES, [32])) - {tile}:
        with pytest.raises(ValueError, match="fixed N tile"):
            ops.conv_mpmm(*args, fmt=fmt, kh=1, kw=1, bn=other)
