"""The port's CUDA kernels against their plain versions, on the card.

Every test here needs an NVIDIA card and skips where torch sees none.  The
file imports no JAX, so it also runs on a machine without it:

    PYTHONPATH=src python -m pytest -q --noconftest tests/test_torch_cuda.py

The plain versions run on the CPU copy of the inputs, the version the CPU
tests hold against the JAX package.  K1 and K2 must match them bitwise
(contract in ``repro_torch/kernels/mpmm/epilogue.py``); K3 and K4 sum in
another order, so they are held to one bf16 ulp (1e-5 in f32), and with f32
I/O to within 1e-5 of a float64 evaluation.
"""
import pytest

torch = pytest.importorskip("torch")

from repro_torch.core import packing  # noqa: E402
from repro_torch.kernels.mpmm import conv_kernel, kernel, ops  # noqa: E402
from repro_torch.kernels.mpmm.epilogue import EpilogueSpec  # noqa: E402


@pytest.fixture()
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA card; torch sees none")
    return torch.device("cuda")


def _weights(gen, kdim, n, w_bits, k):
    fmt = packing.PlaneFormat(w_bits=w_bits, k=k, k_dim=kdim)
    w_int = torch.randint(-(2 ** (w_bits - 1)), 2 ** (w_bits - 1), (kdim, n),
                          generator=gen, dtype=torch.int32)
    planes = packing.pack_planes(w_int, fmt)
    gamma = torch.rand((1, n), generator=gen) * 0.01 + 1e-3
    colsum = w_int.sum(0, dtype=torch.int32).reshape(1, n)
    return fmt, planes, gamma, colsum


def _epilogue(gen, out_shape):
    n = out_shape[-1]
    return EpilogueSpec(bn=True, residual=True, relu=True), {
        "scale": torch.rand((1, n), generator=gen) + 0.5,
        "shift": torch.randn((1, n), generator=gen),
        "residual": torch.randn(out_shape, generator=gen).to(torch.bfloat16)}


def _to(d, device):
    return {k: v.to(device) for k, v in d.items()}


@pytest.mark.cuda
@pytest.mark.parametrize("variant", ["st", "sa"])
@pytest.mark.parametrize("w_bits,k", [(8, 4), (4, 4), (2, 2), (8, 1)])
def test_mpmm_cuda_matches_plain(cuda_device, w_bits, k, variant):
    gen = torch.Generator().manual_seed(w_bits * 8 + k)
    fmt, planes, gamma, colsum = _weights(gen, 147, 70, w_bits, k)
    spec, epi = _epilogue(gen, (77, 70))
    cpu = dict(a_biased=torch.randint(-128, 128, (77, 147), generator=gen,
                                      dtype=torch.int32).to(torch.int8),
               planes=planes, gamma=gamma, colsum=colsum, **epi)
    kw = dict(fmt=fmt, act_zero=128, variant=variant,
              out_dtype=torch.bfloat16, epilogue=spec)
    before = kernel.mpmm_cuda.launches
    got = kernel.mpmm_cuda(**_to(cpu, cuda_device), **kw)
    torch.cuda.synchronize()
    assert kernel.mpmm_cuda.launches == before + 1
    assert torch.equal(got.cpu(), kernel.mpmm_torch(**cpu, **kw))


@pytest.mark.cuda
@pytest.mark.parametrize("kh,stride", [(3, 1), (3, 2), (1, 2)])
def test_conv_mpmm_cuda_matches_plain(cuda_device, kh, stride):
    """Through ops.conv_mpmm and straight into the wrapper: both hand K2
    the unpadded input, which it pads itself (SAME's (0, 1) pads at stride
    2 on 14, and VALID)."""
    gen = torch.Generator().manual_seed(kh * 4 + stride)
    c, n = 64, 96
    fmt, planes, gamma, colsum = _weights(gen, kh * kh * c, n, 4, 2)
    ho = -(-14 // stride)
    spec, epi = _epilogue(gen, (2, ho, ho, n))
    cpu = dict(a_biased=torch.randint(-128, 128, (2, 14, 14, c),
                                      generator=gen,
                                      dtype=torch.int32).to(torch.int8),
               planes=planes, gamma=gamma, colsum=colsum, **epi)
    kw = dict(fmt=fmt, act_zero=128, kh=kh, kw=kh, stride=stride,
              out_dtype=torch.bfloat16, epilogue=spec)
    before = conv_kernel.conv_mpmm_cuda.launches
    got = ops.conv_mpmm(**_to(cpu, cuda_device), impl="cuda", **kw)
    torch.cuda.synchronize()
    assert conv_kernel.conv_mpmm_cuda.launches == before + 1
    assert torch.equal(got.cpu(), ops.conv_mpmm(**cpu, impl="torch", **kw))
    direct = conv_kernel.conv_mpmm_cuda(**_to(cpu, cuda_device), **kw)
    assert torch.equal(direct.cpu(), got.cpu())
    hv = (14 - kh) // stride + 1
    valid = dict(cpu, residual=epi["residual"][:, :hv, :hv].contiguous())
    got = conv_kernel.conv_mpmm_cuda(**_to(valid, cuda_device), **kw,
                                     padding="VALID")
    assert torch.equal(got.cpu(), conv_kernel.conv_mpmm_torch(
        **valid, **kw, padding="VALID"))


@pytest.mark.cuda
@pytest.mark.parametrize("variant", ["st", "sa"])
@pytest.mark.parametrize("b,h,c,n,kk,stride,w_bits,k", [
    (2, 14, 1024, 256, 1, 1, 4, 4),   # ResNet-152 bottleneck c1
    (2, 28, 512, 1024, 1, 2, 8, 4),   # ResNet-152 projection 1x1/2
    (2, 14, 256, 256, 3, 1, 2, 2),    # ResNet-152 bottleneck c2 at 14^2
    (2, 9, 24, 40, 3, 2, 4, 2),       # C % 16 != 0 (byte loads), N 40
    (1, 10, 8, 96, 3, 1, 8, 4),       # C 8, ragged N 96 on the 128 tile
    (1, 7, 512, 512, 3, 1, 2, 2),     # batch 1, 36 splits
    (1, 56, 64, 64, 3, 1, 8, 4),      # batch 1, 5 splits at N tile 64
    (1, 14, 256, 512, 1, 2, 4, 4),    # 2 splits, a 1x1/2 projection
])
def test_conv_mpmm_cuda_shapes_match_plain(cuda_device, b, h, c, n, kk,
                                           stride, w_bits, k, variant):
    gen = torch.Generator().manual_seed(b * 1000 + h * 10 + c + n)
    fmt, planes, gamma, colsum = _weights(gen, kk * kk * c, n, w_bits, k)
    ho = -(-h // stride)
    spec, epi = _epilogue(gen, (b, ho, ho, n))
    cpu = dict(a_biased=torch.randint(-128, 128, (b, h, h, c), generator=gen,
                                      dtype=torch.int32).to(torch.int8),
               planes=planes, gamma=gamma, colsum=colsum, **epi)
    kw = dict(fmt=fmt, act_zero=128, kh=kk, kw=kk, stride=stride,
              variant=variant, out_dtype=torch.bfloat16, epilogue=spec)
    before = conv_kernel.conv_mpmm_cuda.launches
    got = conv_kernel.conv_mpmm_cuda(**_to(cpu, cuda_device), **kw)
    torch.cuda.synchronize()
    assert conv_kernel.conv_mpmm_cuda.launches == before + 1
    assert torch.equal(got.cpu(), conv_kernel.conv_mpmm_torch(**cpu, **kw))
    # the int32 accumulators alone: gamma 1, act_zero 0, f32 out
    acc_kw = dict(kw, act_zero=0, out_dtype=torch.float32, epilogue=None)
    ones = dict(cpu, gamma=torch.ones_like(gamma))
    for key in ("scale", "shift", "residual"):
        ones.pop(key)
    got = conv_kernel.conv_mpmm_cuda(**_to(ones, cuda_device), **acc_kw)
    assert torch.equal(got.cpu(), conv_kernel.conv_mpmm_torch(**ones,
                                                              **acc_kw))


# The formats whose k-bit fields hold a narrower w-bit code (one plane).
K_ABOVE_W = [(w, k) for w in (1, 2, 4, 8) for k in (1, 2, 4, 8) if k > w]


@pytest.mark.cuda
@pytest.mark.parametrize("variant", ["st", "sa"])
@pytest.mark.parametrize("w_bits,k", K_ABOVE_W)
@pytest.mark.parametrize("b,h,c,n,kk,stride", [
    (2, 14, 64, 96, 3, 1),    # one split, ragged N on the 128 tile
    (1, 7, 256, 64, 3, 2),    # batch 1, split plan at N tile 64
])
def test_conv_mpmm_cuda_k_above_w_matches_plain(cuda_device, b, h, c, n, kk,
                                                stride, w_bits, k, variant):
    gen = torch.Generator().manual_seed(b * 100 + w_bits * 8 + k)
    fmt, planes, gamma, colsum = _weights(gen, kk * kk * c, n, w_bits, k)
    ho = -(-h // stride)
    spec, epi = _epilogue(gen, (b, ho, ho, n))
    cpu = dict(a_biased=torch.randint(-128, 128, (b, h, h, c), generator=gen,
                                      dtype=torch.int32).to(torch.int8),
               planes=planes, gamma=gamma, colsum=colsum, **epi)
    kw = dict(fmt=fmt, act_zero=128, kh=kk, kw=kk, stride=stride,
              variant=variant, out_dtype=torch.bfloat16, epilogue=spec)
    got = conv_kernel.conv_mpmm_cuda(**_to(cpu, cuda_device), **kw)
    torch.cuda.synchronize()
    assert torch.equal(got.cpu(), conv_kernel.conv_mpmm_torch(**cpu, **kw))


@pytest.mark.cuda
@pytest.mark.parametrize("b,h,c,n,kk", [(1, 7, 512, 512, 3),
                                        (8, 56, 64, 64, 3)])
def test_conv_mpmm_cuda_allocates_only_output_and_workspace(cuda_device, b,
                                                            h, c, n, kk):
    """No padded copy of the input, no patch matrix: a call's peak
    allocation is its output plus, where split, its int32 partials."""
    gen = torch.Generator().manual_seed(b + h)
    fmt, planes, gamma, colsum = _weights(gen, kk * kk * c, n, 2, 2)
    dev = _to(dict(a_biased=torch.randint(-128, 128, (b, h, h, c),
                                          generator=gen,
                                          dtype=torch.int32).to(torch.int8),
                   planes=planes, gamma=gamma, colsum=colsum), cuda_device)
    kw = dict(fmt=fmt, act_zero=128, kh=kk, kw=kk, out_dtype=torch.bfloat16)
    conv_kernel.conv_mpmm_cuda(**dev, **kw)  # build, load, counters
    torch.cuda.synchronize()
    base = torch.cuda.memory_allocated()
    torch.cuda.reset_peak_memory_stats()
    out = conv_kernel.conv_mpmm_cuda(**dev, **kw)
    torch.cuda.synchronize()
    plan = conv_kernel.conv_plan(b, h, h, n, kk * kk * c, fmt)
    ws = conv_kernel.workspace_bytes(plan)
    rounded = lambda v: -(-v // 512) * 512  # noqa: E731
    assert torch.cuda.max_memory_allocated() - base <= (
        rounded(out.numel() * out.element_size()) + rounded(ws))
    assert (ws > 0) == (b == 1)


@pytest.mark.cuda
def test_wrapper_rejects_what_the_kernel_does_not_take(cuda_device):
    gen = torch.Generator().manual_seed(0)
    fmt, planes, gamma, colsum = _weights(gen, 12, 8, 4, 2)
    a = torch.zeros((1, 2, 2, 3), dtype=torch.int8, device=cuda_device)
    with pytest.raises(ValueError, match="divisible"):  # C=3, 8//k=4
        conv_kernel.conv_mpmm_cuda(
            a, planes.to(cuda_device), gamma.to(cuda_device),
            colsum.to(cuda_device), fmt=fmt, act_zero=128, kh=2, kw=2,
            stride=1, padding="VALID")
    with pytest.raises(TypeError, match="dtype"):
        kernel.mpmm_cuda(torch.zeros((4, 12), device=cuda_device),
                         planes.to(cuda_device), gamma.to(cuda_device),
                         colsum.to(cuda_device), fmt=fmt, act_zero=128)


# --- K1's two routes -----------------------------------------------------------

K1_FORMATS = [(w, k) for w in (1, 2, 4, 8) for k in (1, 2, 4, 8)]


def _k1_case(gen, m, kdim, n, w_bits, k, variant, out_dtype=torch.bfloat16):
    fmt, planes, gamma, colsum = _weights(gen, kdim, n, w_bits, k)
    spec, epi = _epilogue(gen, (m, n))
    cpu = dict(a_biased=torch.randint(-128, 128, (m, kdim), generator=gen,
                                      dtype=torch.int32).to(torch.int8),
               planes=planes, gamma=gamma, colsum=colsum, **epi)
    kw = dict(fmt=fmt, act_zero=128, variant=variant, out_dtype=out_dtype,
              epilogue=spec)
    return cpu, kw


@pytest.mark.cuda
@pytest.mark.parametrize("variant", ["st", "sa"])
@pytest.mark.parametrize("w_bits,k", K1_FORMATS)
@pytest.mark.parametrize("m,kdim,n", [
    (3, 147, 70),     # route B, ragged K and N (byte loads)
    (13, 147, 70),    # route B, 16 rows a thread
    (77, 147, 70),    # route A, ragged everything (byte loads)
    (4, 256, 192),    # route B, vector loads
    (130, 384, 192),  # route A, cp.async, ragged M and N tiles
])
def test_mpmm_cuda_routes_match_plain(cuda_device, m, kdim, n, w_bits, k,
                                      variant):
    gen = torch.Generator().manual_seed(m * 1000 + w_bits * 8 + k)
    cpu, kw = _k1_case(gen, m, kdim, n, w_bits, k, variant)
    route = kernel.mpmm_route(m, kdim, n)
    before = dict(kernel.mpmm_cuda.routes)
    got = kernel.mpmm_cuda(**_to(cpu, cuda_device), **kw)
    torch.cuda.synchronize()
    assert kernel.mpmm_cuda.routes[route] == before[route] + 1
    assert torch.equal(got.cpu(), kernel.mpmm_torch(**cpu, **kw))


@pytest.mark.cuda
@pytest.mark.parametrize("m,route", [(16, "splitk"), (17, "wgmma")])
def test_mpmm_cuda_route_boundary(cuda_device, m, route):
    gen = torch.Generator().manual_seed(m)
    cpu, kw = _k1_case(gen, m, 512, 256, 8, 4, "st", torch.float32)
    launches = kernel.mpmm_cuda.launches
    routes = dict(kernel.mpmm_cuda.routes)
    got = kernel.mpmm_cuda(**_to(cpu, cuda_device), **kw)
    torch.cuda.synchronize()
    assert kernel.mpmm_cuda.launches == launches + 1
    assert kernel.mpmm_cuda.routes == dict(routes, **{route: routes[route] + 1})
    assert torch.equal(got.cpu(), kernel.mpmm_torch(**cpu, **kw))


@pytest.mark.cuda
@pytest.mark.parametrize("m", [4, 4000])
def test_mpmm_cuda_granite_down_projection(cuda_device, m):
    """granite-8b's w8k4 MLP down projection (K 14336, N 4096) at the decode
    and prefill row counts, against the plain version on the card (its
    float64 integer product is exact there too)."""
    gen = torch.Generator(device=cuda_device).manual_seed(m)
    kdim, n = 14336, 4096
    fmt = packing.PlaneFormat(w_bits=8, k=4, k_dim=kdim)
    w_int = torch.randint(-128, 128, (kdim, n), generator=gen,
                          device=cuda_device, dtype=torch.int32)
    planes = packing.pack_planes(w_int, fmt)
    args = dict(
        a_biased=torch.randint(-128, 128, (m, kdim), generator=gen,
                               device=cuda_device,
                               dtype=torch.int32).to(torch.int8),
        planes=planes,
        gamma=torch.rand((1, n), generator=gen, device=cuda_device) * 1e-3,
        colsum=w_int.sum(0, dtype=torch.int32).reshape(1, n))
    del w_int
    kw = dict(fmt=fmt, act_zero=128, out_dtype=torch.bfloat16)
    got = kernel.mpmm_cuda(**args, **kw)
    want = kernel.mpmm_torch(**args, **kw)
    torch.cuda.synchronize()
    assert torch.equal(got, want)


@pytest.mark.cuda
@pytest.mark.parametrize("m", [4, 300])
def test_mpmm_cuda_allocates_only_output_and_workspace(cuda_device, m):
    """No copy of the weights in another format: a call's peak allocation
    is its output plus the declared workspace (allocator-rounded)."""
    gen = torch.Generator().manual_seed(m)
    cpu, kw = _k1_case(gen, m, 4096, 2048, 8, 4, "st")
    dev = _to(cpu, cuda_device)
    kernel.mpmm_cuda(**dev, **kw)  # build and load first
    torch.cuda.synchronize()
    base = torch.cuda.memory_allocated()
    torch.cuda.reset_peak_memory_stats()
    out = kernel.mpmm_cuda(**dev, **kw)
    torch.cuda.synchronize()
    ws = kernel.workspace_bytes(m, 4096, 2048, kw["fmt"])
    rounded = lambda b: -(-b // 512) * 512  # noqa: E731
    assert torch.cuda.max_memory_allocated() - base <= (
        rounded(out.numel() * out.element_size()) + rounded(ws))
    assert (ws == 0) == (kernel.mpmm_route(m, 4096, 2048) == "wgmma")


# --- K3 / K4: flash attention -------------------------------------------------

from repro_torch.kernels.flashattn import kernel as fkernel  # noqa: E402
from repro_torch.kernels.flashattn import ops as fops  # noqa: E402
from repro_torch.nn import kvcache  # noqa: E402


def _bf16_ulp(x):
    """The spacing of bf16 values at |x| (8 significant bits)."""
    _, e = torch.frexp(x.abs().clamp_min(2.0 ** -126))
    return torch.ldexp(torch.ones_like(x), e - 8)


def _assert_attention_close(got, want, tol=None):
    """f32 I/O: 1e-5 absolute (f32 sums in another order); bf16 I/O: one
    bf16 ulp of the larger of the two values plus that 1e-5 for outputs
    near zero, where cancelling sums show the f32 order (more so in K4's
    affine scores); or ``tol`` absolute plus ``tol`` relative."""
    got, want = got.cpu(), want.cpu()
    assert got.dtype == want.dtype and got.shape == want.shape
    g, w = got.float(), want.float()
    if tol is not None:
        bound = tol + tol * w.abs()
    elif want.dtype == torch.float32:
        bound = torch.full_like(w, 1e-5)
    else:
        bound = _bf16_ulp(torch.maximum(g.abs(), w.abs())) + 1e-5
    err = (g - w).abs()
    assert bool((err <= bound).all()), (float(err.max()),
                                        int((err > bound).sum()))


def _qkv(gen, b, sq, sk, h, kvh, d, dtype):
    q = torch.randn((b, sq, h, d), generator=gen).to(dtype)
    k = torch.randn((b, sk, kvh, d), generator=gen).to(dtype)
    v = torch.randn((b, sk, kvh, d), generator=gen).to(dtype)
    return q, k, v


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("case", [
    dict(sq=256, sk=256),                        # aligned, causal
    dict(sq=200, sk=200),                        # ragged: pad rows + causal
    dict(sq=256, sk=256, window=48),
    dict(sq=8, sk=300, q_offset=292),            # a continuation chunk
    dict(sq=128, sk=128, causal=False),
    dict(sq=100, sk=100, causal=False, d=64),    # padded -> forced causal
    # the tile edges of the tensor-core kernels (128-row blocks, 64-key tiles)
    dict(sq=1000, sk=1000),                      # Sq % 128 != 0, pad_k 24
    dict(sq=9, sk=200, q_offset=191),            # the verify chunk: 64 rows
    dict(sq=200, sk=200, window=48),             # a window inside one tile
    dict(sq=200, sk=200, d=64),                  # D 64, ragged, causal
])
def test_flash_fwd_cuda_matches_plain(cuda_device, dtype, case):
    case = dict(case)
    d = case.pop("d", 128)
    sq, sk = case.pop("sq"), case.pop("sk")
    gen = torch.Generator().manual_seed(sq + sk + d)
    q, k, v = _qkv(gen, 2, sq, sk, 8, 2, d, dtype)
    before = fkernel.flash_fwd_cuda.launches
    got = fops.flash_attention(q.to(cuda_device), k.to(cuda_device),
                               v.to(cuda_device), impl="cuda", **case)
    torch.cuda.synchronize()
    assert fkernel.flash_fwd_cuda.launches == before + 1
    assert got.dtype == dtype and got.shape == q.shape
    _assert_attention_close(got, fops.flash_attention(q, k, v, impl="torch",
                                                      **case))


@pytest.mark.cuda
@pytest.mark.parametrize("fk,fv", [((2, 2), (2, 2)), ((4, 4), (4, 4)),
                                   ((8, 4), (8, 4)), ((2, 2), (8, 4)),
                                   ((8, 4), (2, 2))])
@pytest.mark.parametrize("case", [dict(sq=200, sk=200),
                                  dict(sq=8, sk=300, q_offset=292),
                                  dict(sq=1000, sk=1000),
                                  dict(sq=9, sk=200, q_offset=191),
                                  dict(sq=200, sk=200, window=48),
                                  dict(sq=200, sk=200, d=64)])
def test_flash_fwd_packed_cuda_matches_plain(cuda_device, fk, fv, case):
    gen = torch.Generator().manual_seed(fk[0] * 10 + fv[0])
    d = case.get("d", 128)
    q, k, v = _qkv(gen, 2, case["sq"], case["sk"], 8, 2, d, torch.bfloat16)
    fmt_k, fmt_v = kvcache.KVFormat(*fk, d), kvcache.KVFormat(*fv, d)
    kq, vq = kvcache.pack_kv(k, fmt_k), kvcache.pack_kv(v, fmt_v)
    kw = {key: val for key, val in case.items()
          if key in ("q_offset", "window")}
    dev = lambda leaf: {n: t.to(cuda_device) for n, t in leaf.items()}  # noqa
    before = fkernel.flash_fwd_packed_cuda.launches
    got = fops.flash_attention_packed(q.to(cuda_device), dev(kq), dev(vq),
                                      fmt_k, fmt_v, impl="cuda", **kw)
    torch.cuda.synchronize()
    assert fkernel.flash_fwd_packed_cuda.launches == before + 1
    _assert_attention_close(got, fops.flash_attention_packed(
        q, kq, vq, fmt_k, fmt_v, impl="torch", **kw))
    # the packed kernel against K3 on the unpacked (qdq) values
    k3 = fops.flash_attention(q.to(cuda_device),
                              kvcache.unpack_kv(kq, fmt_k).to(cuda_device),
                              kvcache.unpack_kv(vq, fmt_v).to(cuda_device),
                              impl="cuda", **kw)
    # the reference's own packed-vs-qdq tolerance (tests/test_flashattn.py):
    # K3 reads the bf16-rounded values code * s + z, K4 the exact ones
    _assert_attention_close(got, k3, tol=3e-2)


@pytest.mark.cuda
def test_flash_wrappers_reject_what_the_kernels_do_not_take(cuda_device):
    q = torch.zeros((1, 4, 4, 48), device=cuda_device)
    with pytest.raises(ValueError, match="head_dim"):
        fkernel.flash_fwd_cuda(q, q, q)
    q = torch.zeros((1, 4, 4, 64), device=cuda_device)
    with pytest.raises(TypeError, match="dtype"):
        fkernel.flash_fwd_cuda(q, q.to(torch.bfloat16), q.to(torch.bfloat16))
    with pytest.raises(ValueError, match="CUDA"):
        fkernel.flash_fwd_cuda(q.cpu(), q.cpu(), q.cpu())


@pytest.mark.cuda
@pytest.mark.parametrize("packed", [False, True])
def test_flash_kernels_f32_against_float64(cuda_device, packed):
    """With f32 I/O each kernel lands within 1e-5 of the same function
    evaluated in float64 (on the exact values code * s + z for K4)."""
    gen = torch.Generator().manual_seed(7)
    d, b, s, h, kvh = 128, 2, 200, 8, 2
    q, k, v = _qkv(gen, b, s, s, h, kvh, d, torch.float32)
    if packed:
        fmt = kvcache.KVFormat(4, 4, d)
        kq, vq = kvcache.pack_kv(k, fmt), kvcache.pack_kv(v, fmt)
        dev = {n: t.to(cuda_device) for n, t in kq.items()}
        dvv = {n: t.to(cuda_device) for n, t in vq.items()}
        got = fops.flash_attention_packed(q.to(cuda_device), dev, dvv, fmt,
                                          fmt, impl="cuda")
        exact = lambda leaf: (kvcache.unpack_codes(leaf["p"], fmt).double()  # noqa
                              * leaf["s"].double()[..., None]
                              + leaf["z"].double()[..., None])
        k64, v64 = exact(kq), exact(vq)
    else:
        got = fops.flash_attention(q.to(cuda_device), k.to(cuda_device),
                                   v.to(cuda_device), impl="cuda")
        k64, v64 = k.double(), v.double()
    k64 = k64.repeat_interleave(h // kvh, dim=2)
    v64 = v64.repeat_interleave(h // kvh, dim=2)
    scores = torch.einsum("bqhd,bkhd->bhqk", q.double() * d ** -0.5, k64)
    causal = torch.ones((s, s), dtype=torch.bool).tril()
    scores = scores.masked_fill(~causal, float("-inf"))
    want = torch.einsum("bhqk,bkhd->bqhd", torch.softmax(scores, -1), v64)
    torch.cuda.synchronize()
    err = (got.cpu().double() - want).abs().max().item()
    assert err <= 1e-5, err


# --- the decode attention's products: one row's bits at any batch -------------

from repro_torch.nn import attention as attn  # noqa: E402


@pytest.mark.cuda
@pytest.mark.parametrize("eq", ["bkgd,bskd->bkgs", "bkgs,bskd->bkgd"])
@pytest.mark.parametrize("b,s", [(2, 256), (4, 1016), (8, 100), (8, 4096)])
def test_decode_products_batch_invariant_on_card(cuda_device, eq, b, s):
    """Batch row 0 of the decode attention's products on the card is the
    same bits as the product of that row alone (cuBLAS's batched product
    is not, at most of these shapes: ``tools/decode_products.py``)."""
    g = torch.Generator(device=cuda_device).manual_seed(b * 10000 + s)
    bf = lambda *shape: torch.randn(  # noqa: E731
        shape, generator=g, device=cuda_device).bfloat16().float()
    y = bf(b, s, 8, 128)
    x = bf(b, 8, 4, 128) if eq.startswith("bkgd") else bf(b, 8, 4, s)
    got = attn._batch_invariant_einsum(eq, x, y)
    alone = attn._batch_invariant_einsum(eq, x[:1], y[:1])
    assert torch.equal(got[:1], alone)


# --- K1 over an expert bank (one launch for every expert) --------------------

K1_ALL = [(w, k) for w in (1, 2, 4, 8) for k in (1, 2, 4, 8)]


def _bank(gen, e, m, kdim, n, w_bits, k):
    fmt = packing.PlaneFormat(w_bits=w_bits, k=k, k_dim=kdim)
    w_int = torch.randint(-(2 ** (w_bits - 1)), 2 ** (w_bits - 1),
                          (e, kdim, n), generator=gen, dtype=torch.int32)
    return fmt, dict(
        a_biased=torch.randint(-128, 128, (e, m, kdim), generator=gen,
                               dtype=torch.int32).to(torch.int8),
        planes=packing.pack_planes(w_int, fmt).movedim(0, -3).contiguous(),
        gamma=torch.rand((e, 1, n), generator=gen) * 0.01 + 1e-3,
        colsum=w_int.sum(-2, dtype=torch.int32)[:, None])


@pytest.mark.cuda
@pytest.mark.parametrize("variant", ["st", "sa"])
@pytest.mark.parametrize("w_bits,k", K1_ALL)
@pytest.mark.parametrize("m", [4, 70])  # route B and route A
def test_mpmm_cuda_bank_matches_plain(cuda_device, m, w_bits, k, variant):
    """A bank of 5 experts (ragged K and N) in ONE launch, bitwise equal to
    the plain version's E products, with the residual epilogue."""
    gen = torch.Generator().manual_seed(m + w_bits * 8 + k)
    e, kdim, n = 5, 147, 70
    fmt, cpu = _bank(gen, e, m, kdim, n, w_bits, k)
    spec = EpilogueSpec(bn=True, residual=True, relu=True)
    cpu.update(scale=torch.rand((e, 1, n), generator=gen) + 0.5,
               shift=torch.randn((e, 1, n), generator=gen),
               residual=torch.randn((e, m, n), generator=gen).to(
                   torch.bfloat16))
    kw = dict(fmt=fmt, act_zero=128, variant=variant,
              out_dtype=torch.bfloat16, epilogue=spec)
    before = dict(kernel.mpmm_cuda.routes)
    got = kernel.mpmm_cuda(**_to(cpu, cuda_device), **kw)
    torch.cuda.synchronize()
    route = kernel.mpmm_route(m, kdim, n)
    assert kernel.mpmm_cuda.routes[route] == before[route] + 1
    assert torch.equal(got.cpu(), kernel.mpmm_torch(**cpu, **kw))


@pytest.mark.cuda
@pytest.mark.parametrize("m", [4, 1000])
def test_mpmm_cuda_olmoe_bank(cuda_device, m):
    """olmoe's expert bank at decode (4 rows an expert) and prefill (1000:
    4 prompts' capacity of 250), 64 experts, K 2048, N 1024, one launch."""
    gen = torch.Generator(device=cuda_device).manual_seed(m)
    fmt = packing.PlaneFormat(w_bits=4, k=4, k_dim=2048)
    w_int = torch.randint(-8, 8, (64, 2048, 1024), generator=gen,
                          device=cuda_device, dtype=torch.int32)
    dev = dict(a_biased=torch.randint(-128, 128, (64, m, 2048), generator=gen,
                                      device=cuda_device,
                                      dtype=torch.int32).to(torch.int8),
               planes=packing.pack_planes(w_int, fmt).movedim(0, -3)
               .contiguous(),
               gamma=torch.rand((64, 1, 1024), generator=gen,
                                device=cuda_device) * 0.01,
               colsum=w_int.sum(-2, dtype=torch.int32)[:, None])
    del w_int
    kw = dict(fmt=fmt, act_zero=128, out_dtype=torch.bfloat16)
    before = kernel.mpmm_cuda.launches
    got = kernel.mpmm_cuda(**dev, **kw)
    torch.cuda.synchronize()
    assert kernel.mpmm_cuda.launches == before + 1
    assert torch.equal(got, kernel.mpmm_torch(**dev, **kw))


# --- K1's accumulator-only mode (tensor-parallel row shards) -----------------


@pytest.mark.cuda
@pytest.mark.parametrize("variant", ["st", "sa"])
@pytest.mark.parametrize("w_bits,k", K1_FORMATS)
@pytest.mark.parametrize("m,kdim,n", [
    (3, 147, 70),     # route B, ragged K and N
    (13, 147, 70),    # route B, 16 rows a thread
    (77, 147, 70),    # route A, ragged everything
    (4, 256, 192),    # route B, vector loads
    (130, 384, 192),  # route A, cp.async, ragged M and N tiles
])
def test_mpmm_cuda_acc_only_matches_plain(cuda_device, m, kdim, n, w_bits, k,
                                          variant):
    """The int32 accumulator alone, bitwise its plain twin on both routes,
    and ``epilogue.finish`` after it bitwise the fused K1."""
    from repro_torch.kernels.mpmm import epilogue
    gen = torch.Generator().manual_seed(m * 1000 + w_bits * 8 + k + 7)
    cpu, kw = _k1_case(gen, m, kdim, n, w_bits, k, variant)
    route = kernel.mpmm_route(m, kdim, n)
    dev = _to(cpu, cuda_device)
    before = dict(kernel.mpmm_cuda.routes)
    acc = kernel.mpmm_cuda(dev["a_biased"], dev["planes"], None, None,
                           fmt=kw["fmt"], act_zero=0, variant=variant,
                           out_dtype=torch.int32)
    torch.cuda.synchronize()
    assert kernel.mpmm_cuda.routes[route] == before[route] + 1
    assert acc.dtype == torch.int32
    assert torch.equal(acc.cpu(), kernel.mpmm_torch_acc(
        cpu["a_biased"], cpu["planes"], fmt=kw["fmt"]))
    fused = kernel.mpmm_cuda(**dev, **kw)
    got = epilogue.finish(acc, dev["gamma"], dev["colsum"], act_zero=128,
                          spec=kw["epilogue"], scale=dev["scale"],
                          shift=dev["shift"], residual=dev["residual"],
                          out_dtype=kw["out_dtype"])
    plain = kernel.mpmm_torch(**cpu, **kw)
    assert torch.equal(fused.cpu(), plain)
    # BN's fused multiply-add: torch's addcmul on the card must round once
    assert torch.equal(got.cpu(), plain)


@pytest.mark.cuda
@pytest.mark.parametrize("m", [4, 4000])
@pytest.mark.parametrize("kdim,n", [(2048, 4096), (7168, 4096)])
def test_mpmm_cuda_acc_only_row_shards_sum(cuda_device, m, kdim, n):
    """granite-8b's o and down projections split in two on the contraction
    axis: the two shards' int32 accumulators add to the whole one, and the
    epilogue on the sum is bitwise the fused whole product."""
    from repro_torch.kernels.mpmm import epilogue
    gen = torch.Generator(device=cuda_device).manual_seed(m + kdim)
    whole = 2 * kdim
    fmt = packing.PlaneFormat(w_bits=8, k=4, k_dim=whole)
    w_int = torch.randint(-128, 128, (whole, n), generator=gen,
                          device=cuda_device, dtype=torch.int32)
    planes = packing.pack_planes(w_int, fmt)
    a = torch.randint(-128, 128, (m, whole), generator=gen,
                      device=cuda_device, dtype=torch.int32).to(torch.int8)
    gamma = torch.rand((1, n), generator=gen, device=cuda_device) * 1e-3
    colsum = w_int.sum(0, dtype=torch.int32).reshape(1, n)
    del w_int
    half = packing.PlaneFormat(w_bits=8, k=4, k_dim=kdim)
    kp = half.packed_k
    parts = [ops.mpmm_acc(a[:, i * kdim:(i + 1) * kdim].contiguous(),
                          planes[:, i * kp:(i + 1) * kp].contiguous(),
                          fmt=half, impl="cuda") for i in range(2)]
    total = parts[0] + parts[1]
    assert torch.equal(total, ops.mpmm_acc(a, planes, fmt=fmt, impl="cuda"))
    got = epilogue.finish(total, gamma, colsum, act_zero=128, spec=None,
                          out_dtype=torch.bfloat16)
    want = kernel.mpmm_cuda(a, planes, gamma, colsum, fmt=fmt, act_zero=128,
                            out_dtype=torch.bfloat16)
    torch.cuda.synchronize()
    assert torch.equal(got, want)


@pytest.mark.cuda
def test_mpmm_cuda_acc_only_bank(cuda_device):
    """An expert bank keeps working under the accumulator-only flag."""
    gen = torch.Generator().manual_seed(11)
    fmt, cpu = _bank(gen, 3, 70, 147, 70, 4, 4)
    dev = _to(cpu, cuda_device)
    got = kernel.mpmm_cuda(dev["a_biased"], dev["planes"], None, None,
                           fmt=fmt, act_zero=0, out_dtype=torch.int32)
    assert torch.equal(got.cpu(), kernel.mpmm_torch_acc(
        cpu["a_biased"], cpu["planes"], fmt=fmt))


# --- K3 / K4 at head dim 192 (nemotron-4-340b) ------------------------------


@pytest.mark.cuda
@pytest.mark.parametrize("case", [dict(sq=512, sk=512),
                                  dict(sq=9, sk=521, q_offset=512),
                                  dict(sq=200, sk=200, window=48)])
def test_flash_kernels_at_head_dim_192(cuda_device, case):
    """nemotron's attention: 96 query heads on 8 KV heads at D 192, bf16,
    through K3 and through K4 at every cache slice (1-bit digits give
    24-byte rows of packed codes)."""
    case = dict(case)
    sq, sk = case.pop("sq"), case.pop("sk")
    gen = torch.Generator().manual_seed(sq + sk)
    q, k, v = _qkv(gen, 1, sq, sk, 96, 8, 192, torch.bfloat16)
    dq, dk, dv = (t.to(cuda_device) for t in (q, k, v))
    got = fops.flash_attention(dq, dk, dv, impl="cuda", **case)
    torch.cuda.synchronize()
    _assert_attention_close(got, fops.flash_attention(q, k, v, impl="torch",
                                                      **case))
    for fk, fv in [((4, 4), (4, 4)), ((2, 2), (8, 4)), ((2, 1), (8, 8))]:
        fmt_k, fmt_v = kvcache.KVFormat(*fk, 192), kvcache.KVFormat(*fv, 192)
        kq, vq = kvcache.pack_kv(k, fmt_k), kvcache.pack_kv(v, fmt_v)
        dev = lambda leaf: {n: t.to(cuda_device)  # noqa: E731
                            for n, t in leaf.items()}
        got = fops.flash_attention_packed(dq, dev(kq), dev(vq), fmt_k, fmt_v,
                                          impl="cuda", **case)
        torch.cuda.synchronize()
        _assert_attention_close(got, fops.flash_attention_packed(
            q, kq, vq, fmt_k, fmt_v, impl="torch", **case))


@pytest.mark.cuda
def test_head_dim_192_takes_bf16_only(cuda_device):
    q = torch.zeros((1, 4, 4, 192), device=cuda_device)
    with pytest.raises(TypeError, match="bf16"):
        fkernel.flash_fwd_cuda(q, q, q)


# --- K3 at head dim 256 (recurrentgemma-9b's local MQA) ----------------------


@pytest.mark.cuda
@pytest.mark.parametrize("case", [dict(sq=600, sk=600, window=256),
                                  dict(sq=300, sk=300),
                                  dict(sq=9, sk=521, q_offset=512,
                                       window=128)])
def test_flash_fwd_at_head_dim_256(cuda_device, case):
    """recurrentgemma's attention: 16 query heads on one KV head at D 256,
    bf16, causal with a window (two blocks a head, each half of V's
    columns), within one bf16 ulp of the plain version."""
    case = dict(case)
    sq, sk = case.pop("sq"), case.pop("sk")
    gen = torch.Generator().manual_seed(sq + sk + 256)
    q, k, v = _qkv(gen, 2, sq, sk, 16, 1, 256, torch.bfloat16)
    dq, dk, dv = (t.to(cuda_device) for t in (q, k, v))
    before = fkernel.flash_fwd_cuda.launches
    got = fops.flash_attention(dq, dk, dv, impl="cuda", **case)
    torch.cuda.synchronize()
    assert fkernel.flash_fwd_cuda.launches == before + 1
    _assert_attention_close(got, fops.flash_attention(q, k, v, impl="torch",
                                                      **case))


@pytest.mark.cuda
def test_head_dim_256_is_k3_only_and_bf16_only(cuda_device):
    q = torch.zeros((1, 4, 4, 256), device=cuda_device)
    with pytest.raises(TypeError, match="bf16"):
        fkernel.flash_fwd_cuda(q, q, q)
    assert 256 not in fkernel.PACKED_HEAD_DIMS


# --- the MoE router: one token's scores at any batch -------------------------

from repro_torch.nn import moe as nnmoe  # noqa: E402


@pytest.mark.cuda
@pytest.mark.parametrize("rows", [1, 4, 16, 1000])
def test_router_batch_invariant_on_card(cuda_device, rows):
    """A token's f32 router scores are the same bits alone and among
    ``rows`` tokens (olmoe's widths: D 2048, 64 experts)."""
    gen = torch.Generator(device=cuda_device).manual_seed(rows)
    x = torch.randn((rows, 1, 2048), generator=gen, device=cuda_device).to(
        torch.bfloat16)
    router = torch.randn((2048, 64), generator=gen, device=cuda_device) \
        / 45.0
    batched = nnmoe.router_logits(x.reshape(1, rows, 2048), router)[0]
    alone = torch.cat([nnmoe.router_logits(x[i:i + 1], router)[0]
                       for i in range(rows)])
    assert torch.equal(batched, alone)


@pytest.mark.cuda
@pytest.mark.parametrize("rows", [1, 4, 16, 1000])
def test_router_gradient_batch_invariant_on_card(cuda_device, rows):
    """Under autograd, a token's gradient through the router (a sum over
    the 64 experts, in the fixed-order form) is the same bits alone and
    among ``rows`` tokens, as its scores are (olmoe's widths)."""
    gen = torch.Generator(device=cuda_device).manual_seed(rows)
    x = torch.randn((rows, 1, 2048), generator=gen, device=cuda_device).to(
        torch.bfloat16)
    router = torch.randn((2048, 64), generator=gen, device=cuda_device) \
        / 45.0
    g = torch.randn((rows, 1, 64), generator=gen, device=cuda_device)

    def dx(xs, gs):
        xs = xs.detach().requires_grad_(True)
        return torch.autograd.grad(nnmoe.router_logits(xs, router), xs,
                                   grad_outputs=gs)[0]
    batched = dx(x.reshape(1, rows, 2048), g.reshape(1, rows, 64))[0]
    alone = torch.cat([dx(x[i:i + 1], g[i:i + 1])[0] for i in range(rows)])
    assert torch.equal(batched, alone)


from repro_torch.nn import attention as nnattn  # noqa: E402

# (batch, queries, heads, q/k and v head dims, keys, causal, chunk): MLA's
# prefill at phase 12's 4 x 1000 and phase 20's 4 x 256, whisper-base's
# encoder over 1536 frames, a decoder prompt and its cross attention
HEAD_ATTENTION = [(4, 1000, 16, 192, 128, 1000, True, 1024),
                  (4, 256, 16, 192, 128, 256, True, 1024),
                  (4, 1536, 8, 64, 64, 1536, False, 512),
                  (4, 100, 8, 64, 64, 100, True, 512),
                  (4, 64, 8, 64, 64, 1536, False, 512)]


@pytest.mark.cuda
@pytest.mark.parametrize("b,s,h,d,dv,sk,causal,chunk", HEAD_ATTENTION)
def test_sharded_heads_attention_bitwise_on_card(
        cuda_device, b, s, h, d, dv, sk, causal, chunk):
    """A tensor-parallel rank's torch attention over its H/2 or H/4 heads
    (``sharded_heads_attention``, run at the one-device shape) is the
    one-device call's heads, bitwise; one head alone is not held to it."""
    gen = torch.Generator(device=cuda_device).manual_seed(s + h)
    q, k, v = (torch.randn((b, n, h, w), generator=gen, device=cuda_device)
               .to(torch.bfloat16) for n, w in ((s, d), (sk, d), (sk, dv)))
    kw = dict(causal=causal, chunk=chunk)
    whole = nnattn.chunked_attention(q, k, v, **kw)
    for m in (2, 4):
        hl = h // m
        for r in range(m):
            mine = slice(r * hl, (r + 1) * hl)
            got = nnattn.sharded_heads_attention(
                q[:, :, mine], k[:, :, mine], v[:, :, mine], r, m, **kw)
            assert torch.equal(got, whole[:, :, mine]), (m, r)


# --- QAT training on the card (slice 10) -------------------------------------


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("signed,bits", [(False, 8), (True, 4)])
def test_fake_quant_on_the_card_matches_the_cpu(cuda_device, dtype, signed,
                                                bits):
    """The forward and the gradient in v bitwise the CPU's (elementwise
    operations, each rounded once); gamma's gradient, a sum of nearly
    cancelling terms taken in another order, within a share of the terms'
    absolute sum (their mass): f32 terms 2^-19 of it (each side sums its
    6144 terms in a tree, within about log2(6144) * 2^-24 ~ 2^-20 of the
    mass), a bf16 gradient 2^-8 of it (one bf16 ulp of a sum no larger
    than its mass)."""
    from repro_torch.core import quant
    gen = torch.Generator().manual_seed(bits)
    v = torch.randn((64, 96), generator=gen).to(dtype)
    ct = torch.randn((64, 96), generator=gen)
    spec = quant.QuantSpec(bits, signed)
    grads = []
    for dev in ("cpu", cuda_device):
        vt = v.detach().to(dev).clone().requires_grad_(True)
        g = torch.tensor(0.0625, device=dev, requires_grad=True)
        out = quant.fake_quant(vt, g, spec)
        (out.float() * ct.to(dev)).sum().backward()
        grads.append((out.detach().cpu(), vt.grad.cpu(), g.grad.cpu()))
    (o0, v0, g0), (o1, v1, g1) = grads
    assert torch.equal(o0, o1) and torch.equal(v0, v1)
    qn, qp = quant.qrange(spec)
    vs = (v / torch.tensor(0.0625, dtype=dtype)).double()
    inside = ((vs > qn) & (vs < qp)).double()
    terms = ct.double() * (torch.round(vs.clamp(qn, qp)) - inside * vs)
    mass = float(terms.abs().sum()) / (v.numel() * qp) ** 0.5
    share = 2 ** -19 if dtype == torch.float32 else 2 ** -8
    assert abs(float(g0) - float(g1)) <= share * mass


@pytest.mark.cuda
def test_train_step_is_deterministic_on_the_card(cuda_device, monkeypatch):
    """Two runs of three steps from one state: bitwise the same state
    (the restart contract needs it), and the first loss near the CPU's."""
    # what launch.train sets: cuBLAS's deterministic workspace
    monkeypatch.setenv("CUBLAS_WORKSPACE_CONFIG", ":4096:8")
    from repro_torch import configs
    from repro_torch.device import tree_to
    from repro_torch.launch import steps
    from repro_torch.tree import leaves
    api = configs.get("granite-8b", reduced=True)
    api.microbatches = 2
    state0 = steps.init_train_state(api, torch.Generator().manual_seed(0),
                                    device="cpu")
    state0["step"] = state0["step"] + 50
    toks = torch.randint(0, api.cfg.vocab, (4, 17),
                         generator=torch.Generator().manual_seed(1))
    batch = {"tokens": toks[:, :-1], "labels": toks[:, 1:]}
    step = steps.make_train_step(api)
    runs = []
    for _ in range(2):
        s = tree_to(state0, cuda_device)
        b = tree_to(batch, cuda_device)
        losses = []
        for _ in range(3):
            s, m = step(s, b)
            losses.append(float(m["loss"]))
        runs.append((s, losses))
    assert runs[0][1] == runs[1][1]
    assert all(torch.equal(a, b) for a, b in zip(leaves(runs[0][0]),
                                                  leaves(runs[1][0])))
    _, m_cpu = step(state0, batch)
    assert runs[0][1][0] == pytest.approx(float(m_cpu["loss"]), rel=1e-2)


@pytest.mark.cuda
def test_checkpoint_round_trip_of_card_tensors(cuda_device, tmp_path):
    from repro_torch.checkpoint import CheckpointStore
    tree = {"w": torch.randn(5, 7, device=cuda_device).to(torch.bfloat16),
            "n": [torch.tensor(3, dtype=torch.int32, device=cuda_device)]}
    store = CheckpointStore(str(tmp_path))
    store.save(1, tree, blocking=False)
    store.wait()
    _, back = store.restore(tree, device=cuda_device)
    assert back["w"].is_cuda and torch.equal(back["w"], tree["w"])
    assert back["n"][0].shape == () and int(back["n"][0]) == 3


# --- QAT training of the MoE and MLA archs (slice 11) ------------------------

MOE_TRAIN_ARCHS = ["olmoe-1b-7b", "deepseek-v2-lite-16b"]
MOE_CARD_RELL2 = 1e-3


@pytest.mark.cuda
@pytest.mark.parametrize("arch", MOE_TRAIN_ARCHS)
def test_moe_train_step_is_deterministic_on_the_card(cuda_device, monkeypatch,
                                                     arch):
    """The reduced olmoe and deepseek steps (the router's sort, the
    dispatch and its ordered backward, the combine's scatter-add; MLA and
    deepseek's dense layer 0) under ``torch.use_deterministic_algorithms``:
    nothing raises, two runs of three steps give bitwise the same state
    and losses, and the first loss is near the CPU's."""
    monkeypatch.setenv("CUBLAS_WORKSPACE_CONFIG", ":4096:8")
    from repro_torch import configs
    from repro_torch.device import tree_to
    from repro_torch.launch import steps
    from repro_torch.tree import leaves
    api = configs.get(arch, reduced=True)
    api.microbatches = 2
    state0 = steps.init_train_state(api, torch.Generator().manual_seed(0),
                                    device="cpu")
    state0["step"] = state0["step"] + 50
    toks = torch.randint(0, api.cfg.vocab, (4, 33),
                         generator=torch.Generator().manual_seed(1))
    batch = {"tokens": toks[:, :-1], "labels": toks[:, 1:]}
    step = steps.make_train_step(api)
    runs = []
    for _ in range(2):
        s = tree_to(state0, cuda_device)
        b = tree_to(batch, cuda_device)
        losses = []
        for _ in range(3):
            s, m = step(s, b)
            losses.append(float(m["loss"]))
        runs.append((s, losses))
    assert runs[0][1] == runs[1][1]
    assert all(torch.equal(a, b) for a, b in zip(leaves(runs[0][0]),
                                                  leaves(runs[1][0])))
    _, m_cpu = step(state0, batch)
    assert runs[0][1][0] == pytest.approx(float(m_cpu["loss"]), rel=1e-2)


def _rel_l2(a, b):
    a, b = a.detach().double().cpu(), b.detach().double().cpu()
    return float((a - b).norm() / b.norm())


@pytest.mark.cuda
@pytest.mark.parametrize("arch", MOE_TRAIN_ARCHS)
def test_moe_train_on_the_card_matches_the_cpu(cuda_device, arch):
    """``moe_apply(serve=False)`` at the reduced configs (4 x 64 tokens) on
    the card against the CPU on the same inputs: the output, x's gradient
    and every weight, router and weight-step (``gw``) gradient within
    MOE_CARD_RELL2 of its L2 norm, the activation steps' (``ga``, bf16
    sums of nearly cancelling terms) finite.  Readings on an H100: the
    output bitwise, x 3.8e-5, the weights 2.5e-5, the router 1.9e-7, ``gw``
    4.0e-5 (the bank's bf16 products add in another order on cuBLAS)."""
    from repro_torch import configs
    from repro_torch.tree import flatten_with_paths, unflatten
    api = configs.get(arch, reduced=True)
    mc = api.cfg.moe
    params = api.init_params(torch.Generator().manual_seed(2), device="cpu")
    moe = params["layers"][api.cfg.dense_first_n]["moe"]
    gen = torch.Generator().manual_seed(3)
    x = torch.randn((4, 64, mc.d_model), generator=gen).to(torch.bfloat16)
    ct = torch.randn((4, 64, mc.d_model), generator=gen).to(torch.bfloat16)
    out = []
    for dev in ("cpu", cuda_device):
        flat = flatten_with_paths(moe)
        live = {k: v.detach().to(dev).clone().requires_grad_(True)
                for k, v in flat.items()}
        xt = x.to(dev).requires_grad_(True)
        y = nnmoe.moe_apply(unflatten(moe, list(live.values())), xt,
                            api.policy, mc, serve=False)
        grads = torch.autograd.grad(y, [xt] + list(live.values()),
                                    grad_outputs=ct.to(dev))
        out.append((y, grads[0], dict(zip(live, grads[1:]))))
    (y0, gx0, g0), (y1, gx1, g1) = out
    assert _rel_l2(y1, y0) <= MOE_CARD_RELL2
    assert _rel_l2(gx1, gx0) <= MOE_CARD_RELL2
    for path, g in g1.items():
        assert bool(torch.isfinite(g).all()), path
        if not path.endswith("['ga']"):
            assert _rel_l2(g, g0[path]) <= MOE_CARD_RELL2, path


# --- QAT training of mamba2, recurrentgemma and whisper (slice 12) -----------

RECURRENT_TRAIN_ARCHS = ["mamba2-1.3b", "recurrentgemma-9b", "whisper-base"]
BLOCK_CARD_RELL2 = 1e-3


@pytest.mark.cuda
@pytest.mark.parametrize("arch", RECURRENT_TRAIN_ARCHS)
def test_recurrent_train_step_is_deterministic_on_the_card(
        cuda_device, monkeypatch, arch):
    """The reduced mamba2, recurrentgemma and whisper steps (the SSD's and
    the scan's backward, the conv taps' ordered bf16 sums, the encoder
    output's ordered fan-out; whisper on synthetic frames) donated as the
    Trainer runs them, under ``torch.use_deterministic_algorithms``:
    nothing raises, two runs of three steps give bitwise the same state and
    losses, and the first loss is near the CPU's."""
    monkeypatch.setenv("CUBLAS_WORKSPACE_CONFIG", ":4096:8")
    from repro_torch import configs
    from repro_torch.device import tree_to
    from repro_torch.launch import steps
    from repro_torch.tree import leaves
    api = configs.get(arch, reduced=True)
    api.microbatches = 2
    state0 = steps.init_train_state(api, torch.Generator().manual_seed(0),
                                    device="cpu")
    state0["step"] = state0["step"] + 50
    gen = torch.Generator().manual_seed(1)
    toks = torch.randint(0, api.cfg.vocab, (4, 20), generator=gen)
    batch = {"tokens": toks[:, :-1], "labels": toks[:, 1:]}
    if api.needs_frames:
        batch["frames"] = torch.randn((4, api.cfg.n_audio, api.cfg.d_model),
                                      generator=gen)
    step = steps.make_train_step(api, donate=True)
    runs = []
    for _ in range(2):
        s = tree_to(state0, cuda_device)
        b = tree_to(batch, cuda_device)
        losses = []
        for _ in range(3):
            s, m = step(s, b)
            losses.append(float(m["loss"]))
        runs.append((s, losses))
    assert runs[0][1] == runs[1][1]
    assert all(torch.equal(a, b) for a, b in zip(leaves(runs[0][0]),
                                                  leaves(runs[1][0])))
    _, m_cpu = steps.make_train_step(api)(state0, batch)
    assert runs[0][1][0] == pytest.approx(float(m_cpu["loss"]), rel=1e-2)


@pytest.mark.cuda
@pytest.mark.parametrize("block", ["ssd", "rglru"])
def test_recurrent_block_vjp_on_the_card_matches_the_cpu(cuda_device, block):
    """An SSD block (mamba2, 2 x 32 tokens: two chunks, so the one-row
    card path and the chunk loop run) and an RG-LRU block (recurrentgemma,
    2 x 19) at the reduced widths, ``serve=False``, on the card against the
    CPU on the same inputs: the output, x's gradient and every weight,
    conv, ``A_log``/``D``/``dt_bias``/``lam`` and ``gw`` gradient within
    BLOCK_CARD_RELL2 of its L2 norm, the activation steps (``ga``) finite.
    Phase 16 of ``chip_smoke.py`` holds the same at full width."""
    from repro_torch import configs
    from repro_torch.nn import rglru, ssm
    from repro_torch.tree import flatten_with_paths, unflatten
    if block == "ssd":
        api = configs.get("mamba2-1.3b", reduced=True)
        fn = lambda p, x: ssm.ssd_forward(  # noqa: E731
            p, x, api.policy, api.cfg.ssm, serve=False)
        key, shape = "ssm", (2, 32, api.cfg.d_model)
    else:
        api = configs.get("recurrentgemma-9b", reduced=True)
        fn = lambda p, x: rglru.rglru_block_forward(  # noqa: E731
            p, x, api.policy, api.cfg.rnn, serve=False)
        key, shape = "rnn", (2, 19, api.cfg.d_model)
    params = api.init_params(torch.Generator().manual_seed(2),
                             device="cpu")["layers"][0][key]
    gen = torch.Generator().manual_seed(3)
    x = torch.randn(shape, generator=gen).to(torch.bfloat16)
    ct = torch.randn(shape, generator=gen).to(torch.bfloat16)
    out = []
    for dev in ("cpu", cuda_device):
        live = {k: v.detach().to(dev).clone().requires_grad_(True)
                for k, v in flatten_with_paths(params).items()}
        xt = x.to(dev).requires_grad_(True)
        y, _ = fn(unflatten(params, list(live.values())), xt)
        grads = torch.autograd.grad(y, [xt] + list(live.values()),
                                    grad_outputs=ct.to(dev))
        out.append((y, grads[0], dict(zip(live, grads[1:]))))
    (y0, gx0, g0), (y1, gx1, g1) = out
    assert _rel_l2(y1, y0) <= BLOCK_CARD_RELL2
    assert _rel_l2(gx1, gx0) <= BLOCK_CARD_RELL2
    for path, g in g1.items():
        assert bool(torch.isfinite(g).all()), path
        if not path.endswith("['ga']"):
            assert _rel_l2(g, g0[path]) <= BLOCK_CARD_RELL2, path


# --- the PE models (core/ppg) on the card ------------------------------------


@pytest.mark.cuda
@pytest.mark.parametrize("m,kdim,n", [(64, 256, 256), (5, 37, 9),
                                      (392, 4608, 512)])
def test_ppg_on_card_equals_cpu(cuda_device, m, kdim, n):
    """Every PE variant at every (w, k) of the Fig. 6 grid on the card:
    the int32 GEMM bitwise the CPU's (through ``torch._int_mm`` with
    unsigned bytes shifted by 128 and the shapes zero-padded), the
    statistics equal."""
    import numpy as np
    from repro_torch.core import ppg
    rng = np.random.default_rng(m + kdim + n)
    a = torch.from_numpy(rng.integers(0, 256, (m, kdim)).astype(np.int32))
    for w_bits, k in [(w, k) for w in (8, 4, 2, 1) for k in (1, 2, 4)
                      if k <= w]:
        w = torch.from_numpy(packing.random_codes(rng, (kdim, n), w_bits))
        want = (a.double() @ w.double()).to(torch.int32)
        for name, fn in ppg.PE_VARIANTS.items():
            extra = (8,) if name == "BP-ST-2D" else ()
            got, stats = fn(a.to(cuda_device), w.to(cuda_device), w_bits,
                            *extra, k)
            _, cpu_stats = fn(a[:1], w, w_bits, *extra, k)
            assert torch.equal(got.cpu(), want), (name, w_bits, k)
            assert stats == cpu_stats


# --- tensor-parallel mamba2, recurrentgemma and the fp baseline -------------


@pytest.mark.cuda
@pytest.mark.parametrize("r", [0, 1])
def test_k3_over_a_ranks_heads_d256_bitwise_on_card(cuda_device, r):
    """K3 at recurrentgemma's attention (D 256, one KV head, window 2048,
    2 x 2100 tokens) over a rank's 8 of the 16 heads is the 16-head call's
    heads, bitwise: each block of K3 computes one head."""
    from repro_torch.kernels.flashattn import ops as fops
    gen = torch.Generator().manual_seed(81)
    mk = lambda h: torch.randn((2, 2100, h, 256), generator=gen).to(  # noqa
        torch.bfloat16).to(cuda_device)
    q, k, v = mk(16), mk(1), mk(1)
    run = lambda qq: fops.flash_attention(  # noqa: E731
        qq, k, v, window=2048, block_k=1024, impl="cuda")
    whole = run(q)
    part = run(q[:, :, 8 * r:8 * (r + 1)].contiguous())
    assert torch.equal(part, whole[:, :, 8 * r:8 * (r + 1)])


@pytest.mark.cuda
@pytest.mark.parametrize("m", [2, 4])
def test_ssd_chunk_math_at_the_padded_head_count_on_card(cuda_device, m):
    """The SSD chunk math (mamba2-1.3b's 64 heads, head dim 64, state 128,
    2 chunks of 256, one row as the card path runs it) and the decode
    step's contraction over a rank's H/M heads, zero-padded to all 64 at
    their own index, are the one-device heads, bitwise."""
    from repro_torch.nn import ssm
    gen = torch.Generator().manual_seed(82 + m)
    h, p, n, s = 64, 64, 128, 512
    dev = cuda_device
    xh = torch.randn((1, s, h, p), generator=gen).to(dev)
    bm = torch.randn((1, s, h, n), generator=gen).to(dev)
    cm = torch.randn((1, s, h, n), generator=gen).to(dev)
    dtp = (torch.rand((1, s, h), generator=gen) * 0.1).to(dev)
    a = -torch.rand((h,), generator=gen).to(dev)
    y, final = ssm._ssd_chunks(xh, bm, cm, dtp, a, 256)
    cv = torch.randn((4, h, n), generator=gen).to(dev)
    st = torch.randn((4, h, n, p), generator=gen).to(dev)
    yc = ssm._contract_n(cv, st)
    hl = h // m
    for r in range(m):
        own = slice(r * hl, (r + 1) * hl)

        def pad(t, ax):
            return ssm._pad_heads(t[(slice(None),) * ax + (own,)], ax, r, m)
        y_r, f_r = ssm._ssd_chunks(pad(xh, 2), bm, cm, pad(dtp, 2),
                                   pad(a, 0), 256)
        assert torch.equal(ssm._own_heads(y_r, 2, r, m), y[:, :, own])
        assert torch.equal(ssm._own_heads(f_r, 1, r, m), final[:, own])
        assert torch.equal(ssm._contract_n(cv[:, own], st[:, own], r, m),
                           yc[:, own])


@pytest.mark.cuda
@pytest.mark.parametrize("rows", [1024, 4])
def test_fp_column_shard_at_the_padded_n_on_card(cuda_device, rows):
    """The fp baseline's column shard (granite-8b's gate, 4096 x 14336,
    bf16) at the one-device N, its weight zero-padded
    (``nn.quantized.fp_shard``), gives the whole product's columns,
    bitwise, for each half."""
    from repro_torch.core.precision import PrecisionPolicy
    from repro_torch.nn import quantized as Q
    gen = torch.Generator().manual_seed(83 + rows)
    x = torch.randn((rows, 4096), generator=gen).to(torch.bfloat16).to(
        cuda_device)
    w = (torch.randn((4096, 14336), generator=gen) * 0.02).to(
        torch.bfloat16).to(cuda_device)
    fp = PrecisionPolicy(quantize=False)
    whole = Q.qlinear_serve_apply({"w": w}, x, fp)
    n = 14336 // 2
    for r in range(2):
        shard = Q.fp_shard({"w": w}, -1, ((r * n, (r + 1) * n),))
        got = Q.qlinear_serve_apply(shard, x, fp)
        assert torch.equal(got, whole[:, r * n:(r + 1) * n])


@pytest.mark.cuda
@pytest.mark.parametrize("m,kdim,n", [(1024, 2048, 2048), (4, 2048, 2048),
                                      (4080, 2048, 4096), (2, 2048, 4096)])
def test_k1_acc_only_at_the_ssm_and_rglru_row_shards_on_card(cuda_device, m,
                                                             kdim, n):
    """K1's accumulator-only mode at a rank's row shards -- mamba2-1.3b's
    ``out`` (K 4096 / 2, N 2048) and recurrentgemma-9b's ``w_a`` (K 4096 /
    2, N 4096), at prefill and decode rows, w4k4 -- bitwise
    ``mpmm_torch_acc``."""
    gen = torch.Generator().manual_seed(m + kdim + n)
    fmt, planes, _, _ = _weights(gen, kdim, n, 4, 4)
    a = torch.randint(-128, 128, (m, kdim), generator=gen,
                      dtype=torch.int32).to(torch.int8)
    before = kernel.mpmm_cuda.acc_launches
    got = ops.mpmm_acc(a.to(cuda_device), planes.to(cuda_device), fmt=fmt,
                       impl="cuda")
    torch.cuda.synchronize()
    assert kernel.mpmm_cuda.acc_launches == before + 1
    assert torch.equal(got.cpu(), kernel.mpmm_torch_acc(a, planes, fmt=fmt))
