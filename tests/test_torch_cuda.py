"""The port's CUDA kernels against their plain versions, on the card.

Every test here needs an NVIDIA card and skips where torch sees none.  The
file imports no JAX, so it also runs on a machine without it:

    PYTHONPATH=src python -m pytest -q --noconftest tests/test_torch_cuda.py

The plain versions run on the CPU copy of the inputs, the version the CPU
tests hold bitwise against the JAX package; the kernels must match them
bitwise (contract in ``repro_torch/kernels/mpmm/epilogue.py``).
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


@pytest.mark.cuda
def test_wrapper_rejects_what_the_kernel_does_not_take(cuda_device):
    gen = torch.Generator().manual_seed(0)
    fmt, planes, gamma, colsum = _weights(gen, 12, 8, 4, 2)
    a = torch.zeros((1, 2, 2, 3), dtype=torch.int8, device=cuda_device)
    with pytest.raises(ValueError, match="divisible"):  # C=3, 8//k=4
        conv_kernel.conv_mpmm_cuda(
            a, planes.to(cuda_device), gamma.to(cuda_device),
            colsum.to(cuda_device), fmt=fmt, act_zero=128, kh=2, kw=2,
            stride=1, out_hw=(1, 1))
    with pytest.raises(TypeError, match="dtype"):
        kernel.mpmm_cuda(torch.zeros((4, 12), device=cuda_device),
                         planes.to(cuda_device), gamma.to(cuda_device),
                         colsum.to(cuda_device), fmt=fmt, act_zero=128)
