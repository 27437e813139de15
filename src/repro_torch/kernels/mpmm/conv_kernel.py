"""K2: the implicit-GEMM convolution kernel and its plain PyTorch version.

``conv_mpmm_cuda`` wraps the hand-written CUDA kernel ``csrc/conv_mpmm.cu``,
which replaces the Pallas TPU kernel
``repro.kernels.mpmm.conv_kernel.conv_mpmm_pallas``: an NHWC convolution as
implicit GEMM over the same packed digit planes the im2col path reads
(K = kh*kw*C in (kh, kw, C) order), with K1's fused epilogue.  The kernel
reads the unpadded input and applies the conv's padding itself (a pixel
outside the image is the code ``-act_zero`` of a float zero); neither the
patch matrix nor a padded copy of the input exists in device memory.  C
must be a multiple of 8//k (``ops.conv_implicit_feasible``) and k must
divide w, as for K1.

The products run on int8 tensor cores over 128-pixel x ``bn`` output
tiles; ``conv_plan`` picks ``bn`` (64 where N <= 64, else 128) and, where
the output tiles alone cannot occupy the H100's 132 SMs, a split of the
contraction into runs of whole 128-digit K-steps, by a cost model measured
on the card within a grid rule (at least 132 blocks, or at most two
K-steps a block).  A split conv writes int32 partials to a workspace; the
last block to finish an output tile adds them and runs the epilogue, so
every call is one launch.

``conv_mpmm_torch`` is the plain version (the twin of the JAX package's
``ops._xla_conv_impl``): a direct float64 convolution of the padded codes
against the recombined int8 weights, exact for these integer sums and
rounded back to int32, then ``epilogue.finish``.

``conv_mpmm_cuda.launches`` counts the kernel's launches.
"""
from __future__ import annotations

import ctypes
import dataclasses
import functools
import math
from typing import List, Optional, Tuple

import torch
import torch.nn.functional as F

from repro_torch.core.packing import PlaneFormat
from repro_torch.kernels import _build
from repro_torch.kernels.mpmm import epilogue as _epi
from repro_torch.kernels.mpmm import ref as _ref
from repro_torch.kernels.mpmm.epilogue import EpilogueSpec
from repro_torch.kernels.mpmm.kernel import (check_common, check_operand,
                                             epilogue_flags, ptr,
                                             raise_on_error)

__all__ = ["BM", "BK", "N_TILES", "TARGET_BLOCKS", "ConvPlan", "n_tile",
           "plan_candidates", "conv_plan", "conv_out_hw", "workspace_bytes",
           "kernel_info", "conv_mpmm_cuda", "conv_mpmm_torch"]

# The kernel's tile (csrc/conv_mpmm.cu): BM output pixels by an N tile of
# N_TILES, stepping the contraction by BK digits.
BM = 128
BK = 128
N_TILES = (64, 128)
TARGET_BLOCKS = 132  # the H100's SMs: a grid at least this large fills it
# conv_plan's cost model of one launch, in microseconds, fitted to K2's
# device times at ResNet-18's shapes on an H100 80GB HBM3 at 700 W (a sweep
# of forced splits, chip_smoke.py's graph_ms): a wave of blocks (one block
# an SM) costs WAVE_US plus STEP_US per K-step of its longest run, each
# wave after the first EXTRA_WAVE of that; a split adds SPLIT_US once
# (stage, store, count) and REDUCE_US for each partial the last block of a
# tile adds (scaled by the share of the tile's rows that hold pixels).
WAVE_US = 6.5
STEP_US = {64: 1.15, 128: 1.3}
EXTRA_WAVE = 0.8
SPLIT_US = 3.0
REDUCE_US = 0.65


def n_tile(n: int) -> int:
    """The N tile K2 runs for N output channels: 64 where that covers N,
    else 128 (a 128-wide product at N = 64 would be half padding)."""
    return N_TILES[0] if n <= N_TILES[0] else N_TILES[1]


@dataclasses.dataclass(frozen=True)
class ConvPlan:
    """K2's grid for one conv: ``m_tiles`` x ``n_tiles`` output tiles of
    ``bm`` x ``bn``, the ``k_steps`` K-steps of the contraction cut into
    ``splits`` runs of ``steps`` (the last one shorter)."""

    m: int
    bm: int
    bn: int
    m_tiles: int
    n_tiles: int
    k_steps: int
    steps: int
    splits: int

    @property
    def tiles(self) -> int:
        return self.m_tiles * self.n_tiles

    @property
    def blocks(self) -> int:
        return self.tiles * self.splits

    def step_ranges(self) -> List[Tuple[int, int]]:
        """[start, end) of each split in K-steps."""
        return [(s * self.steps, min((s + 1) * self.steps, self.k_steps))
                for s in range(self.splits)]

    def fills_the_card(self) -> bool:
        """The grid rule: at least TARGET_BLOCKS blocks, or no block holds
        more than two K-steps."""
        return self.blocks >= TARGET_BLOCKS or self.steps <= 2

    def cost_us(self) -> float:
        """The cost model's time of the launch (see WAVE_US)."""
        waves = math.ceil(self.blocks / TARGET_BLOCKS)
        t = ((WAVE_US + self.steps * STEP_US[self.bn])
             * (1 + EXTRA_WAVE * (waves - 1)))
        if self.splits > 1:
            rows = self.m / (self.m_tiles * self.bm)
            t += SPLIT_US + (self.splits - 1) * REDUCE_US * rows
        return t


def plan_candidates(b: int, ho: int, wo: int, n: int,
                    kdim: int) -> List[ConvPlan]:
    """Every split of the contraction into balanced runs of whole K-steps
    (no split where the output tiles alone reach TARGET_BLOCKS)."""
    bn = n_tile(n)
    m = b * ho * wo
    m_tiles = math.ceil(m / BM)
    n_tiles = math.ceil(n / bn)
    k_steps = math.ceil(kdim / BK)
    most = 1 if m_tiles * n_tiles >= TARGET_BLOCKS else k_steps
    plans = []
    for splits in range(1, most + 1):
        steps = math.ceil(k_steps / splits)
        if math.ceil(k_steps / steps) == splits:  # else fewer runs suffice
            plans.append(ConvPlan(m=m, bm=BM, bn=bn, m_tiles=m_tiles,
                                  n_tiles=n_tiles, k_steps=k_steps,
                                  steps=steps, splits=splits))
    return plans


@functools.lru_cache(maxsize=None)
def conv_plan(b: int, ho: int, wo: int, n: int, kdim: int,
              fmt: PlaneFormat) -> ConvPlan:
    """K2's tile and split for a conv with output (b, ho, wo, n) and a
    contraction of ``kdim`` digits: of the candidate splits that meet the
    grid rule (``ConvPlan.fills_the_card``), the one of least modelled
    cost, the fewest splits on a tie.  Its runs cover the K-steps exactly
    once and none is empty; a split grid has fewer than TARGET_BLOCKS
    output tiles (one arrival counter each).
    """
    if kdim != fmt.k_dim:
        raise ValueError(f"K={kdim} but the format says {fmt.k_dim}")
    plans = [p for p in plan_candidates(b, ho, wo, n, kdim)
             if p.fills_the_card()]
    return min(plans, key=lambda p: (p.cost_us(), p.splits))


def conv_out_hw(h: int, w: int, kh: int, kw: int, stride: int,
                padding: str) -> Tuple[Tuple[int, int], Tuple[int, int],
                                       Tuple[int, int]]:
    """((Ho, Wo), (top, bottom), (left, right)) of a conv on (h, w), with
    XLA's SAME pads (``ref.same_pads``: the odd pixel on the high side)."""
    ph = _ref.same_pads(h, kh, stride, padding)
    pw = _ref.same_pads(w, kw, stride, padding)
    ho = (h + ph[0] + ph[1] - kh) // stride + 1
    wo = (w + pw[0] + pw[1] - kw) // stride + 1
    return (ho, wo), ph, pw


def workspace_bytes(plan: ConvPlan) -> int:
    """Device bytes a K2 call allocates beside its output: the int32
    partials of a split, a whole tile per (split, output tile)."""
    if plan.splits == 1:
        return 0
    return plan.splits * plan.tiles * plan.bm * plan.bn * 4


@functools.cache
def _lib(w_bits: int):
    lib = _build.load(_build.format_lib("conv_mpmm", w_bits))
    lib.conv_mpmm_launch.argtypes = ([ctypes.c_void_p] * 10
                                     + [ctypes.c_int] * 22
                                     + [ctypes.c_void_p])
    lib.conv_mpmm_launch.restype = ctypes.c_int
    lib.conv_mpmm_info.argtypes = [ctypes.c_int] * 4 + [ctypes.c_void_p]
    lib.conv_mpmm_info.restype = ctypes.c_int
    return lib


@functools.cache
def _counters(device: torch.device, stream: int) -> torch.Tensor:
    """The per-tile arrival counters of split convs on ``stream`` (one
    buffer a stream, so convs on two streams never share one): zeroed once,
    and left zero by every launch (the last block of a tile resets its
    counter).  A split grid has fewer than TARGET_BLOCKS tiles."""
    return torch.zeros(TARGET_BLOCKS, dtype=torch.int32, device=device)


def kernel_info(fmt: PlaneFormat, variant: str, bn: int) -> Tuple[int, int]:
    """(dynamic shared-memory bytes, resident blocks an SM) of the K2
    instantiation for ``fmt``, ``variant`` and N tile ``bn``, on the
    current device."""
    info = (ctypes.c_int * 2)()
    err = _lib(fmt.w_bits).conv_mpmm_info(
        fmt.w_bits, fmt.k, int(variant == "sa"), bn, ctypes.addressof(info))
    raise_on_error("conv_mpmm_info", err)
    return info[0], info[1]


def conv_mpmm_cuda(a_biased: torch.Tensor, planes: torch.Tensor,
                   gamma: torch.Tensor, colsum: torch.Tensor, *,
                   fmt: PlaneFormat, act_zero: int, kh: int, kw: int,
                   stride: int = 1, padding: str = "SAME",
                   variant: str = "st", out_dtype=torch.float32,
                   epilogue: Optional[EpilogueSpec] = None,
                   scale: Optional[torch.Tensor] = None,
                   shift: Optional[torch.Tensor] = None,
                   residual: Optional[torch.Tensor] = None) -> torch.Tensor:
    """Launch K2 on CUDA tensors -> (B, Ho, Wo, N) of ``out_dtype``.

    a_biased int8 (B, H, W, C), unpadded: the kernel applies ``padding``
    ('SAME' with XLA's pads, or 'VALID') with the fill ``-act_zero``;
    planes uint8 (P, kh*kw*C/f, N); residual (B, Ho, Wo, N) f32 or bf16
    when ``epilogue.residual``.  The grid is ``conv_plan``'s.
    """
    _epi.validate_operands(epilogue, scale, shift, residual)
    out_dtype = _epi.resolve_out_dtype(epilogue, out_dtype)
    device = a_biased.device
    check_common(device, planes, fmt, gamma, colsum, scale, shift, variant,
                 out_dtype)
    check_operand("a_biased", a_biased, device, (torch.int8,))
    b, h, w, c = a_biased.shape
    n = planes.shape[-1]
    if c % fmt.digits_per_byte != 0:
        raise ValueError(
            f"implicit-GEMM conv needs C divisible by the packed "
            f"digits-per-byte: C={c}, 8//k={fmt.digits_per_byte}; route "
            f"this layer to the im2col dataflow")
    if fmt.k_dim != kh * kw * c:
        raise ValueError(f"format K={fmt.k_dim} != kh*kw*C={kh * kw * c}")
    if not 0 <= act_zero <= 128:
        raise ValueError(f"act_zero must be in [0, 128], got {act_zero}")
    if stride < 1:
        raise ValueError(f"stride must be >= 1, got {stride}")
    (ho, wo), ph, pw = conv_out_hw(h, w, kh, kw, stride, padding)
    if ho < 1 or wo < 1:
        raise ValueError(f"a {kh}x{kw} kernel at stride {stride} with "
                         f"{padding} padding leaves no output on {(h, w)}")
    if residual is not None:
        check_operand("residual", residual, device,
                      (torch.float32, torch.bfloat16), (b, ho, wo, n))
    out = torch.empty((b, ho, wo, n), dtype=out_dtype, device=device)
    if out.numel() == 0:
        return out
    plan = conv_plan(b, ho, wo, n, fmt.k_dim, fmt)
    with torch.cuda.device(device):
        stream = torch.cuda.current_stream(device).cuda_stream
        ws = counters = None
        if plan.splits > 1:
            ws = torch.empty((plan.splits, plan.tiles, plan.bm, plan.bn),
                             dtype=torch.int32, device=device)
            counters = _counters(device, stream)
        err = _lib(fmt.w_bits).conv_mpmm_launch(
            ptr(a_biased), ptr(planes), ptr(gamma), ptr(colsum), ptr(scale),
            ptr(shift), ptr(residual), ptr(out), ptr(ws), ptr(counters), b, h,
            w, c, ho, wo, n, kh, kw, stride, ph[0], pw[0], fmt.packed_k,
            fmt.planes, fmt.k, fmt.w_bits, act_zero, int(variant == "sa"),
            epilogue_flags(epilogue, residual, out_dtype), plan.bn,
            plan.steps, plan.splits, stream)
    raise_on_error("conv_mpmm_cuda", err)
    conv_mpmm_cuda.launches += 1
    return out


conv_mpmm_cuda.launches = 0


def conv_mpmm_torch(a_biased: torch.Tensor, planes: torch.Tensor,
                    gamma: torch.Tensor, colsum: torch.Tensor, *,
                    fmt: PlaneFormat, act_zero: int, kh: int, kw: int,
                    stride: int = 1, padding: str = "SAME",
                    variant: str = "st", out_dtype=torch.float32,
                    epilogue: Optional[EpilogueSpec] = None,
                    scale: Optional[torch.Tensor] = None,
                    shift: Optional[torch.Tensor] = None,
                    residual: Optional[torch.Tensor] = None) -> torch.Tensor:
    """Plain version of K2 (twin of ``ops._xla_conv_impl``) on the unpadded
    biased codes (B, H, W, C) -> (B, Ho, Wo, N).

    The float64 convolution is exact for these integer sums whatever
    algorithm the backend picks (rounding to the nearest integer removes
    any transform error), so the accumulator matches K2's bitwise.
    """
    del variant
    _epi.validate_operands(epilogue, scale, shift, residual)
    c = a_biased.shape[-1]
    n = planes.shape[-1]
    w8 = _ref.combined_int8_weights(planes, fmt)              # (K, N)
    w_oihw = w8.reshape(kh, kw, c, n).permute(3, 2, 0, 1).to(torch.float64)
    xp = _ref.pad_spatial(a_biased, kh, kw, stride, padding, fill=-act_zero)
    acc = F.conv2d(xp.permute(0, 3, 1, 2).to(torch.float64), w_oihw,
                   stride=stride)
    acc = torch.round(acc).to(torch.int32).permute(0, 2, 3, 1).contiguous()
    return _epi.finish(acc, gamma, colsum, act_zero=act_zero, spec=epilogue,
                       scale=scale, shift=shift, residual=residual,
                       out_dtype=_epi.resolve_out_dtype(epilogue, out_dtype))
