"""The paper's PE taxonomy (Section III-A), port of ``repro.core.ppg``.

The paper (following Camus et al. [30]) spans the PE design space along
four dimensions; each point is a plain integer GEMM whose *schedule* the
statistics record:

  * input processing:  Bit-Parallel (BP)  vs  Bit-Serial (BS, k bits/cycle)
  * consolidation:     Sum-Together (ST, adder tree inside the PE)
                       vs Sum-Apart (SA, per-partial-product accumulators)
  * scaling:           1D (only weights sliced; activations full width)
                       vs 2D (both operands sliced into k x k PPGs)
  * operand slice:     k in {1, 2, 4, 8}

Every variant returns the exact int32 GEMM ``acts[M, K] @ weights[K, N]``
and the same ``PEStats`` as ``repro``'s.  The functions run on their
inputs' device.  On a card, where torch has no int32 matmul, each partial
product is ``torch._int_mm`` over int8 operands: unsigned 8-bit operands go
through K1's identity ``a @ P = (a - 128) @ P + 128 * colsum(P)`` and the
shapes are zero-padded to what ``_int_mm`` takes, both exact in int32.  On
the CPU the product is torch's integer ``mm``, exact as well.  The bit-serial
variant's ``lax.scan`` over planes is a loop over planes here.
"""
from __future__ import annotations

import dataclasses
from typing import Optional, Tuple

import torch

from repro_torch.core import packing

__all__ = [
    "PEStats",
    "matmul_bp_st_1d",
    "matmul_bp_sa_1d",
    "matmul_bp_st_2d",
    "matmul_bs_st_1d",
    "matmul_exact",
    "PE_VARIANTS",
]


@dataclasses.dataclass(frozen=True)
class PEStats:
    """Schedule statistics of one PE variant executing one GEMM.

    mxu_passes:    number of full int8 GEMM passes (the cost analogue of
                   the per-PPG area on the FPGA).
    serial_cycles: cycles per MAC for bit-serial schedules (1 for BP).
    accumulators:  live accumulator tensors (SA keeps one per plane --
                   the register overhead the paper charges SA with).
    plane_bytes:   HBM bytes of the packed weight operand.
    """

    mxu_passes: int
    serial_cycles: int
    accumulators: int
    plane_bytes: int


def _ceil(n: int, m: int) -> int:
    return -(-n // m) * m


def _pad2(x: torch.Tensor, rows: int, cols: int) -> torch.Tensor:
    return torch.nn.functional.pad(x, (0, cols - x.shape[1],
                                       0, rows - x.shape[0]))


def _int8_operand(x: torch.Tensor) -> Tuple[torch.Tensor, int]:
    """An integer operand of at most 8 bits -> (int8 tensor, offset) with
    ``x = int8 + offset``: signed codes as they are, unsigned bytes
    (0..255) shifted by 128."""
    lo, hi = torch.stack(torch.aminmax(x)).tolist()
    if -128 <= lo and hi <= 127:
        return x.to(torch.int8), 0
    if 0 <= lo and hi <= 255:
        return (x - 128).to(torch.int8), 128
    raise ValueError(f"operand range [{lo}, {hi}] is wider than 8 bits; "
                     f"the PE models multiply 8-bit codes")


class _Acts:
    """The activation operand of a variant's partial products, prepared
    once: on a card the int8 operand of ``torch._int_mm`` (unsigned bytes
    shifted by 128, zero-padded to the shapes it takes) and its offset; on
    the CPU the int32 matrix for torch's integer ``mm``.  ``card`` picks
    the route (default: the operand's device)."""

    def __init__(self, a: torch.Tensor, card: Optional[bool] = None):
        self.lead = a.shape[:-1]
        a2 = a.reshape(-1, a.shape[-1]).to(torch.int32)
        self.m, self.k = a2.shape
        self.cuda = a2.is_cuda if card is None else card
        if not self.cuda:
            self.a = a2
            return
        a8, self.offset = _int8_operand(a2)
        self.mp = max(_ceil(self.m, 8), 24)
        self.kp = max(_ceil(self.k, 8), 16)
        self.a = _pad2(a8, self.mp, self.kp)

    def dot(self, b: torch.Tensor, codes: bool = False) -> torch.Tensor:
        """Exact int32 product with ``b`` (K, N).  ``codes``: ``b`` is a
        digit plane of ``packing.split_planes``, signed 8-bit by
        construction, so its range goes unchecked."""
        n = b.shape[-1]
        if not self.cuda:
            out = torch.mm(self.a, b.to(torch.int32))
        else:
            if codes:
                b8 = b.to(torch.int8)
            else:
                b8, b_off = _int8_operand(b)
                if b_off:
                    raise ValueError("the weight operand must be signed "
                                     "8-bit codes")
            np_ = max(_ceil(n, 8), 16)
            out = torch._int_mm(self.a, _pad2(b8, self.kp, np_))[
                :self.m, :n]
            if self.offset:
                colsum = b.to(torch.int32).sum(0, dtype=torch.int32)
                out = out + self.offset * colsum[None, :]
        return out.reshape(self.lead + (n,))


def matmul_exact(a_int: torch.Tensor, w_int: torch.Tensor) -> torch.Tensor:
    """Ground-truth integer GEMM in int32."""
    return _Acts(a_int).dot(w_int.to(torch.int32))


def _zeros(a_int: torch.Tensor, w_int: torch.Tensor) -> torch.Tensor:
    return torch.zeros(a_int.shape[:-1] + (w_int.shape[-1],),
                       dtype=torch.int32, device=a_int.device)


def _plane_bytes(w_int: torch.Tensor, w_bits: int, k: int) -> int:
    return packing.packed_weight_bytes(w_int.shape[-2], w_int.shape[-1],
                                       w_bits, k)


def matmul_bp_st_1d(a_int: torch.Tensor, w_int: torch.Tensor, w_bits: int,
                    k: int) -> Tuple[torch.Tensor, PEStats]:
    """Bit-Parallel Sum-Together 1D -- the design the paper selects (Fig.
    6b): P = ceil(w_bits/k) weight planes, full-width activations, the
    adder tree's shift-add folded into a single accumulator."""
    planes = packing.split_planes(w_int, w_bits, k)  # (P, K, N)
    p = planes.shape[0]
    acts = _Acts(a_int)
    acc = _zeros(a_int, w_int)
    for i in range(p):  # unrolled adder tree: single running accumulator
        acc = acc + (acts.dot(planes[i], codes=True) << (k * i))
    return acc, PEStats(mxu_passes=p, serial_cycles=1, accumulators=1,
                        plane_bytes=_plane_bytes(w_int, w_bits, k))


def matmul_bp_sa_1d(a_int: torch.Tensor, w_int: torch.Tensor, w_bits: int,
                    k: int) -> Tuple[torch.Tensor, PEStats]:
    """Bit-Parallel Sum-Apart 1D: each plane its own accumulator, combined
    last (P partial-sum tensors live at once)."""
    planes = packing.split_planes(w_int, w_bits, k)
    p = planes.shape[0]
    acts = _Acts(a_int)
    partials = [acts.dot(planes[i], codes=True)
                for i in range(p)]  # all live simultaneously
    acc = torch.zeros_like(partials[0])
    for i in range(p):
        acc = acc + (partials[i] << (k * i))
    return acc, PEStats(mxu_passes=p, serial_cycles=1, accumulators=p,
                        plane_bytes=_plane_bytes(w_int, w_bits, k))


def matmul_bp_st_2d(a_int: torch.Tensor, w_int: torch.Tensor, w_bits: int,
                    a_bits: int, k: int) -> Tuple[torch.Tensor, PEStats]:
    """Bit-Parallel Sum-Together 2D -- BitFusion-style k x k PPGs [28]:
    both operands sliced, P_w * P_a partial GEMMs shifted by 2^{k(p+q)}.
    Activations are unsigned (every activation plane unsigned); the top
    weight plane is signed."""
    w_planes = packing.split_planes(w_int, w_bits, k)  # (Pw, K, N)
    a_planes = packing.split_planes(a_int, a_bits + 1, k)[
        : packing.num_planes(a_bits, k)]
    pw, pa = w_planes.shape[0], a_planes.shape[0]
    acc = _zeros(a_int, w_int)
    for q in range(pa):
        acts = _Acts(a_planes[q])
        for p in range(pw):
            acc = acc + (acts.dot(w_planes[p], codes=True) << (k * (p + q)))
    return acc, PEStats(mxu_passes=pw * pa, serial_cycles=1, accumulators=1,
                        plane_bytes=_plane_bytes(w_int, w_bits, k))


def matmul_bs_st_1d(a_int: torch.Tensor, w_int: torch.Tensor, w_bits: int,
                    k: int) -> Tuple[torch.Tensor, PEStats]:
    """Bit-Serial Sum-Together: weights streamed k bits a cycle (Fig. 4
    left), a serial loop over digit planes (w_bits/k cycles per MAC)."""
    planes = packing.split_planes(w_int, w_bits, k)  # (P, K, N)
    p = planes.shape[0]
    acts = _Acts(a_int)
    acc = _zeros(a_int, w_int)
    for i in range(p):
        acc = acc + acts.dot(planes[i], codes=True) * (2 ** (k * i))
    return acc, PEStats(mxu_passes=p, serial_cycles=p, accumulators=1,
                        plane_bytes=_plane_bytes(w_int, w_bits, k))


PE_VARIANTS = {
    "BP-ST-1D": matmul_bp_st_1d,
    "BP-SA-1D": matmul_bp_sa_1d,
    "BP-ST-2D": matmul_bp_st_2d,
    "BS-ST-1D": matmul_bs_st_1d,
}
