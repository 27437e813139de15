"""The port's PE models (``repro_torch.core.ppg``) against ``repro.core.ppg``.

Every variant at every (w, k) of the Fig. 6 grid (``benchmarks/fig6_pe_dse``:
w in {8, 4, 2, 1}, k in {1, 2, 4}, k <= w; a_bits 8 for the 2-D variant), at
a small M, from the same numpy codes: the int32 GEMM bitwise and the
``PEStats`` equal.
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core import packing as jpacking
from repro.core import ppg as jppg
from repro_torch.core import packing, ppg

M, K, N = 8, 96, 40
GRID = [(w, k) for w in (8, 4, 2, 1) for k in (1, 2, 4) if k <= w]


def _inputs(w_bits, seed=0):
    rng = np.random.default_rng(seed + w_bits)
    a = rng.integers(0, 256, (M, K)).astype(np.int32)
    w = packing.random_codes(rng, (K, N), w_bits)
    return a, w


def _call(mod, name, a, w, w_bits, k):
    fn = mod.PE_VARIANTS[name]
    if name == "BP-ST-2D":
        return fn(a, w, w_bits, 8, k)
    return fn(a, w, w_bits, k)


@pytest.mark.parametrize("name", list(ppg.PE_VARIANTS))
@pytest.mark.parametrize("w_bits,k", GRID)
def test_variant_bitwise_repro(name, w_bits, k):
    a, w = _inputs(w_bits)
    want, want_stats = _call(jppg, name, jnp.asarray(a), jnp.asarray(w),
                             w_bits, k)
    got, stats = _call(ppg, name, torch.from_numpy(a), torch.from_numpy(w),
                       w_bits, k)
    assert got.dtype == torch.int32
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))
    assert dataclasses_equal(stats, want_stats)
    np.testing.assert_array_equal(
        got.numpy(), ppg.matmul_exact(torch.from_numpy(a),
                                      torch.from_numpy(w)).numpy())


def dataclasses_equal(a, b):
    fields = ("mxu_passes", "serial_cycles", "accumulators", "plane_bytes")
    return all(getattr(a, f) == getattr(b, f) for f in fields)


def test_matmul_exact_bitwise_repro_signed_and_lead_axes():
    rng = np.random.default_rng(3)
    a = rng.integers(-128, 128, (2, 5, K)).astype(np.int32)
    w = packing.random_codes(rng, (K, N), 8)
    want = np.asarray(jppg.matmul_exact(jnp.asarray(a), jnp.asarray(w)))
    got = ppg.matmul_exact(torch.from_numpy(a), torch.from_numpy(w))
    np.testing.assert_array_equal(got.numpy(), want)


@pytest.mark.parametrize("kdim,n", [(256, 256), (4608, 512), (5, 3), (147, 70)])
@pytest.mark.parametrize("w_bits,k", GRID + [(8, 8), (3, 2)])
def test_packed_weight_bytes_equal(kdim, n, w_bits, k):
    assert (packing.packed_weight_bytes(kdim, n, w_bits, k)
            == jpacking.packed_weight_bytes(kdim, n, w_bits, k))


@pytest.mark.parametrize("w_bits", [1, 2, 4, 8])
def test_random_codes_equal(w_bits):
    got = packing.random_codes(np.random.default_rng(7), (33, 9), w_bits)
    want = jpacking.random_codes(np.random.default_rng(7), (33, 9), w_bits)
    assert got.dtype == want.dtype
    np.testing.assert_array_equal(got, want)


def test_int8_operand_rejects_wide_codes():
    with pytest.raises(ValueError, match="wider than 8 bits"):
        ppg._int8_operand(torch.tensor([-1, 200]))


@pytest.mark.parametrize("m,kdim,n", [(8, 96, 40), (64, 256, 256), (3, 5, 7)])
def test_card_product_identity_on_cpu(m, kdim, n):
    """The card's route (unsigned bytes shifted by 128, shapes zero-padded
    for ``torch._int_mm``), run through ``torch._int_mm`` on the CPU, equals
    the int32 product."""
    rng = np.random.default_rng(m + kdim)
    for a in (rng.integers(0, 256, (m, kdim)), rng.integers(-128, 128, (m, kdim))):
        a = torch.from_numpy(a.astype(np.int32))
        w = torch.from_numpy(packing.random_codes(rng, (kdim, n), 8))
        card = ppg._Acts(a, card=True).dot(w)  # the card's route
        np.testing.assert_array_equal(card.numpy(), (a @ w).numpy())


@pytest.mark.parametrize("name", list(ppg.PE_VARIANTS))
@pytest.mark.parametrize("w_bits,k", GRID)
def test_variant_by_card_route_on_cpu(name, w_bits, k, monkeypatch):
    """Every variant with its partial products forced onto the card's
    route (``torch._int_mm`` over int8, which the CPU runs too) equals
    ``repro``'s int32 GEMM."""
    init = ppg._Acts.__init__
    monkeypatch.setattr(ppg._Acts, "__init__",
                        lambda self, a, card=None: init(self, a, card=True))
    a, w = _inputs(w_bits, seed=11)
    want = np.asarray(jppg.matmul_exact(jnp.asarray(a), jnp.asarray(w)))
    got, _ = _call(ppg, name, torch.from_numpy(a), torch.from_numpy(w),
                   w_bits, k)
    np.testing.assert_array_equal(got.numpy(), want)
