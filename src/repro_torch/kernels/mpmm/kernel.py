"""K1: the mixed-precision matmul kernel and its plain PyTorch version.

``mpmm_cuda`` wraps K1, which replaces the Pallas TPU kernel
``repro.kernels.mpmm.kernel.mpmm_pallas``:

    y[M, N] = epilogue(gamma * ((a_biased @ W_int) + act_zero * colsum))

with ``a_biased`` int8 (M, K) and ``W_int`` decoded in the kernel from the
packed uint8 digit planes (P, ceil(K/f), N), read as stored: no copy of the
weights in another format is made.  K1 has two hand-written CUDA routes,
picked from the shape by ``mpmm_route``:

  * ``wgmma`` (``csrc/mpmm_wgmma.cu``, M > 16): int8 tensor-core products
    over 256 x 128 output tiles (``TILE``), the planes decoded into int8
    weights in shared memory while the previous K-step's products run;
  * ``splitk`` (``csrc/mpmm_splitk.cu``, M <= 16): K cut into byte-aligned
    chunks across blocks (``split_plan``), the planes streamed with vector
    loads and decoded in registers, ``__dp4a`` products, int32 partials in
    a workspace added in a fixed order by a second kernel.

A grouped call -- an MoE expert bank, which the reference runs through
K1 under ``jax.vmap`` over the expert axis -- takes a_biased (E, M, K),
planes (E, P, Kp, N) and gamma/colsum with E x N values, and runs all E
products in one launch of the route that M (the rows of one group) picks:
the group is one more grid dimension, and each block offsets its operands
by its group.

``variant='st'`` turns the planes into one int8 operand (one product
whatever P is); ``'sa'`` runs one product per plane and shift-adds them.
Both give the same integers, so both routes are bitwise equal to the plain
version.  Neither route falls back to the other or to the plain version.

``mpmm_torch`` is the plain version (the twin of the JAX package's
``ops._xla_impl``): one exact integer product against the recombined int8
weights, then ``epilogue.finish``.  The CPU tests hold it against the JAX
package, and ``chip_smoke.py`` holds the kernel against it on the card.

``out_dtype=torch.int32`` is the accumulator-only mode (flag
``ACC_ONLY``): both routes store the int32 ``a_biased @ W_int`` itself,
with no zero point, dequant or post-op, and take no gamma or colsum.  A
tensor-parallel row shard (a projection whose contraction axis is split
over the 'model' ranks) runs it, the ranks sum the int32 partials, and the
shared ``epilogue.finish`` completes the whole sum; ``mpmm_torch_acc`` is
its plain version.

The wrapper checks device, dtype, shape and contiguity and raises on
anything the kernel does not take.  ``mpmm_cuda.launches`` counts calls of
K1 (a split-K call is one, though it launches two CUDA kernels),
``mpmm_cuda.routes`` counts them by route and ``mpmm_cuda.acc_launches``
those of the accumulator-only mode among them.
"""
from __future__ import annotations

import ctypes
import dataclasses
import functools
import math
from typing import List, Optional, Sequence, Tuple

import torch

from repro_torch.core.packing import PlaneFormat
from repro_torch.kernels import _build
from repro_torch.kernels.mpmm import epilogue as _epi
from repro_torch.kernels.mpmm import ref as _ref
from repro_torch.kernels.mpmm.epilogue import EpilogueSpec

__all__ = ["TILE", "ROUTES", "SPLITK_MAX_M", "SplitPlan", "mpmm_route",
           "split_plan", "workspace_bytes", "mpmm_cuda", "mpmm_torch",
           "mpmm_torch_acc", "epilogue_flags", "PLAIN_SLICE_VALUES"]

# Route A's fixed (bm, bk, bn) tile under Sum-Together (csrc/mpmm_wgmma.cu
# Smem<2>::BM, BK, BN; Sum-Apart runs bm = 128).
TILE = (256, 128, 128)

ROUTES = ("wgmma", "splitk")
# Route B takes M <= SPLITK_MAX_M rows (csrc/mpmm_splitk.cu: 4 rows x 16
# columns a thread up to M = 4, 16 x 8 above).
SPLITK_MAX_M = 16
SPLITK_WARPS = 8                # warps a block; each takes a digit group
SPLITK_TARGET_BLOCKS = 4 * 132  # four blocks for each of the H100's SMs
SPLITK_MIN_GROUPS = 2           # digit groups a warp at least
SPLITK_MAX_CHUNK_DIGITS = 2048  # csrc/mpmm_splitk.cu MAX_CHUNK_DIGITS

# Epilogue flag bits, as csrc/mpmm_common.cuh defines them.
EPI_BN, EPI_RESIDUAL, EPI_RELU, RES_BF16, OUT_BF16 = 1, 2, 4, 8, 16
ACC_ONLY = 32
OUT_DTYPES = (torch.float32, torch.bfloat16)
ACC_DTYPE = torch.int32  # out_dtype of the accumulator-only mode
VARIANTS = ("st", "sa")


def epilogue_flags(spec: Optional[EpilogueSpec],
                   residual: Optional[torch.Tensor], out_dtype) -> int:
    """The kernel's epilogue flag word for ``spec`` and the operand dtypes:
    ``ACC_ONLY`` alone for an int32 output, which takes no epilogue."""
    if out_dtype == ACC_DTYPE:
        if spec is not None:
            raise ValueError("an int32 (accumulator-only) output takes no "
                             "epilogue; finish the summed accumulator "
                             "with epilogue.finish")
        return ACC_ONLY
    flags = 0
    if spec is not None:
        flags |= (EPI_BN if spec.bn else 0) | (EPI_RELU if spec.relu else 0)
        if spec.residual:
            flags |= EPI_RESIDUAL
            if residual.dtype == torch.bfloat16:
                flags |= RES_BF16
    if out_dtype == torch.bfloat16:
        flags |= OUT_BF16
    return flags


def check_operand(name: str, t: torch.Tensor, device: torch.device,
                  dtypes: Sequence[torch.dtype],
                  shape: Optional[Sequence[int]] = None) -> None:
    """Raise unless ``t`` is a contiguous tensor of an accepted dtype (and
    shape) on the kernel's CUDA device."""
    if not isinstance(t, torch.Tensor):
        raise TypeError(f"{name} must be a torch.Tensor, got {type(t)}")
    if t.device != device:
        raise ValueError(f"{name} is on {t.device}; the kernel runs on {device}")
    if t.dtype not in dtypes:
        raise TypeError(f"{name} has dtype {t.dtype}; the kernel takes "
                        f"{[str(d) for d in dtypes]}")
    if shape is not None and tuple(t.shape) != tuple(shape):
        raise ValueError(f"{name} has shape {tuple(t.shape)}, expected "
                         f"{tuple(shape)}")
    if not t.is_contiguous():
        raise ValueError(f"{name} must be contiguous")


def check_common(device: torch.device, planes: torch.Tensor, fmt: PlaneFormat,
                 gamma: torch.Tensor, colsum: torch.Tensor,
                 scale: Optional[torch.Tensor], shift: Optional[torch.Tensor],
                 variant: str, out_dtype, groups: int = 1,
                 acc_only_ok: bool = False) -> None:
    """Checks shared by both kernel wrappers (everything but the input).
    ``groups`` products share one launch: planes then carry a leading
    group axis and each column operand holds ``groups`` x N values.  An
    int32 ``out_dtype`` (K1's accumulator-only mode, ``acc_only_ok``)
    reads no gamma, colsum, scale or shift, which must then be None."""
    if device.type != "cuda":
        raise ValueError(f"the CUDA kernel needs CUDA tensors, got {device}; "
                         f"use impl='torch' (or 'auto') for CPU tensors")
    n = planes.shape[-1]
    lead = (groups,) if planes.ndim == 4 else ()
    check_operand("planes", planes, device, (torch.uint8,),
                  lead + (fmt.planes, fmt.packed_k, n))
    if variant not in VARIANTS:
        raise ValueError(f"variant must be one of {VARIANTS}, got {variant!r}")
    if out_dtype == ACC_DTYPE and acc_only_ok:
        given = [name for name, t in (("gamma", gamma), ("colsum", colsum),
                                      ("scale", scale), ("shift", shift))
                 if t is not None]
        if given:
            raise ValueError(f"the int32 accumulator-only mode reads no "
                             f"{given}; pass None")
        return
    check_operand("gamma", gamma, device, (torch.float32,))
    check_operand("colsum", colsum, device, (torch.int32,))
    for name, t in (("gamma", gamma), ("colsum", colsum), ("scale", scale),
                    ("shift", shift)):
        if t is not None and t.numel() != groups * n:
            raise ValueError(f"{name} must hold {groups} x N={n} values, "
                             f"got {tuple(t.shape)}")
    for name, t in (("scale", scale), ("shift", shift)):
        if t is not None:
            check_operand(name, t, device, (torch.float32,))
    if out_dtype not in OUT_DTYPES:
        raise TypeError(f"out_dtype must be one of {OUT_DTYPES}"
                        + (f" or {ACC_DTYPE} (accumulator-only)"
                           if acc_only_ok else "") + f", got {out_dtype}")


def ptr(t: Optional[torch.Tensor]) -> Optional[int]:
    return None if t is None else t.data_ptr()


def raise_on_error(name: str, err: int) -> None:
    if err != 0:
        raise RuntimeError(f"{name} launch failed with CUDA error {err}")


def mpmm_route(m: int, kdim: int, n: int) -> str:
    """K1's route for an (M, K) x (K, N) product: ``splitk`` for M <= 16
    (decode, the LM head, the ResNet classifier: too few rows for a
    64-row tensor-core tile, so the parallelism has to come from K),
    ``wgmma`` above.  K and N do not change the choice."""
    del kdim, n
    return "splitk" if m <= SPLITK_MAX_M else "wgmma"


@dataclasses.dataclass(frozen=True)
class SplitPlan:
    """Route B's cut of K: ``splits`` chunks of ``chunk_bytes`` packed
    bytes (the last one shorter), one per grid row of blocks."""

    chunk_bytes: int
    splits: int

    def byte_ranges(self, fmt: PlaneFormat) -> List[Tuple[int, int]]:
        """[start, end) of each chunk in packed bytes of a plane row."""
        kp = fmt.packed_k
        return [(s * self.chunk_bytes, min((s + 1) * self.chunk_bytes, kp))
                for s in range(self.splits)]

    def digit_ranges(self, fmt: PlaneFormat) -> List[Tuple[int, int]]:
        """[start, end) of each chunk in digits of K."""
        f = fmt.digits_per_byte
        return [(b0 * f, min(b1 * f, fmt.k_dim))
                for b0, b1 in self.byte_ranges(fmt)]


def _group_rows(fmt: PlaneFormat) -> int:
    """Packed rows of a plane in one digit group of route B (4 digits, 8
    for k = 1): csrc/mpmm_splitk.cu Group::ROWS."""
    return max(1, 4 // fmt.digits_per_byte)


def strip_cols(m: int) -> int:
    """Columns of a route-B block: 32 threads x 16 columns (8 at M > 4)."""
    return 32 * (16 if m <= 4 else 8)


@functools.lru_cache(maxsize=None)
def split_plan(m: int, kdim: int, n: int, fmt: PlaneFormat,
               groups: int = 1) -> SplitPlan:
    """Route B's split of K for an (M, K) x (K, N) product, or for
    ``groups`` of them in one launch (an expert bank).

    Chunks start on whole packed bytes, are whole digit groups for each of
    the block's eight warps (a multiple of ``_group_rows``), hold at most
    ``SPLITK_MAX_CHUNK_DIGITS`` digits (the activation rows staged in
    shared memory) and at least ``SPLITK_MIN_GROUPS`` groups a warp, and
    are as many as fill ``SPLITK_TARGET_BLOCKS`` blocks with the N strips
    of every group.  They cover K exactly and none is empty.
    """
    if kdim != fmt.k_dim:
        raise ValueError(f"K={kdim} but the format says {fmt.k_dim}")
    f = fmt.digits_per_byte
    kp = fmt.packed_k
    unit = SPLITK_WARPS * _group_rows(fmt)
    strips = groups * math.ceil(n / strip_cols(m))
    want = max(1, math.ceil(SPLITK_TARGET_BLOCKS / strips))
    chunk = max(math.ceil(kp / want), SPLITK_MIN_GROUPS * unit)
    chunk = math.ceil(chunk / unit) * unit
    chunk = min(chunk, SPLITK_MAX_CHUNK_DIGITS // f // unit * unit)
    return SplitPlan(chunk_bytes=chunk, splits=math.ceil(kp / chunk))


def workspace_bytes(m: int, kdim: int, n: int, fmt: PlaneFormat,
                    groups: int = 1) -> int:
    """Device bytes a K1 call allocates beside its output: route B's int32
    partials, one per (group, split, row, column); route A none."""
    if mpmm_route(m, kdim, n) == "wgmma":
        return 0
    return groups * split_plan(m, kdim, n, fmt, groups).splits * m * n * 4


@functools.cache
def _launcher(route: str, w_bits: int):
    if route == "wgmma":
        lib = _build.load(_build.format_lib("mpmm_wgmma", w_bits))
        fn = lib.mpmm_launch
        fn.argtypes = ([ctypes.c_void_p] * 8 + [ctypes.c_int] * 11
                       + [ctypes.c_void_p])
    else:
        fn = _build.load("mpmm_splitk").mpmm_splitk_launch
        fn.argtypes = ([ctypes.c_void_p] * 9 + [ctypes.c_int] * 13
                       + [ctypes.c_void_p])
    fn.restype = ctypes.c_int
    return fn


def mpmm_cuda(a_biased: torch.Tensor, planes: torch.Tensor,
              gamma: torch.Tensor, colsum: torch.Tensor, *,
              fmt: PlaneFormat, act_zero: int, variant: str = "st",
              out_dtype=torch.float32,
              epilogue: Optional[EpilogueSpec] = None,
              scale: Optional[torch.Tensor] = None,
              shift: Optional[torch.Tensor] = None,
              residual: Optional[torch.Tensor] = None) -> torch.Tensor:
    """Launch K1 on CUDA tensors -> (M, N) of ``out_dtype``: f32 or bf16,
    or int32 for the accumulator-only mode (gamma and colsum None, no
    epilogue, ``act_zero`` unused: the raw ``a_biased @ W_int``).

    a_biased int8 (M, K) with K == fmt.k_dim; planes uint8 (P, Kp, N);
    gamma f32 and colsum int32 with N values; scale/shift f32 with N values
    when ``epilogue.bn``; residual (M, N) f32 or bf16 when
    ``epilogue.residual``.  A group of E products (an expert bank) is one
    launch: a_biased (E, M, K), planes (E, P, Kp, N), E x N values in
    every column operand, residual (E, M, N) -> (E, M, N).  Ragged M, N
    and K are masked in the kernel.  The route is ``mpmm_route(M, K, N)``,
    M the rows of one group.
    """
    _epi.validate_operands(epilogue, scale, shift, residual)
    out_dtype = _epi.resolve_out_dtype(epilogue, out_dtype)
    device = a_biased.device
    if a_biased.ndim not in (2, 3) or planes.ndim != a_biased.ndim + 1:
        raise ValueError(f"a_biased (M, K) with planes (P, Kp, N), or "
                         f"a_biased (E, M, K) with planes (E, P, Kp, N); got "
                         f"{tuple(a_biased.shape)} and {tuple(planes.shape)}")
    groups = a_biased.shape[0] if a_biased.ndim == 3 else 1
    check_common(device, planes, fmt, gamma, colsum, scale, shift, variant,
                 out_dtype, groups, acc_only_ok=True)
    m, kdim = a_biased.shape[-2:]
    n = planes.shape[-1]
    if kdim != fmt.k_dim:
        raise ValueError(f"a_biased has K={kdim}, the format says "
                         f"{fmt.k_dim}")
    check_operand("a_biased", a_biased, device, (torch.int8,))
    lead = a_biased.shape[:-2]
    if residual is not None:
        check_operand("residual", residual, device,
                      (torch.float32, torch.bfloat16), (*lead, m, n))
    out = torch.empty((*lead, m, n), dtype=out_dtype, device=device)
    if m == 0 or n == 0 or groups == 0:
        return out
    route = mpmm_route(m, kdim, n)
    fmt_args = (fmt.packed_k, fmt.planes, fmt.k, fmt.w_bits, act_zero,
                int(variant == "sa"),
                epilogue_flags(epilogue, residual, out_dtype))
    operands = (ptr(a_biased), ptr(planes), ptr(gamma), ptr(colsum),
                ptr(scale), ptr(shift), ptr(residual), ptr(out))
    launch = _launcher(route, fmt.w_bits)
    with torch.cuda.device(device):
        stream = torch.cuda.current_stream(device).cuda_stream
        if route == "wgmma":
            err = launch(*operands, m, n, kdim, *fmt_args, groups, stream)
        else:
            plan = split_plan(m, kdim, n, fmt, groups)
            ws = torch.empty((groups, plan.splits, m, n), dtype=torch.int32,
                             device=device)
            err = launch(*operands, ptr(ws), m, n, kdim, *fmt_args,
                         plan.chunk_bytes, plan.splits, groups, stream)
    raise_on_error(f"mpmm_cuda ({route})", err)
    mpmm_cuda.launches += 1
    mpmm_cuda.routes[route] += 1
    mpmm_cuda.acc_launches += out_dtype == ACC_DTYPE
    return out


mpmm_cuda.launches = 0
mpmm_cuda.routes = dict.fromkeys(ROUTES, 0)
mpmm_cuda.acc_launches = 0


# Columns of one slice of the plain version: its float64 product and its
# recombined weights stay near 2^28 values, so a weight as wide as a
# 256000-word head does not hold several copies of itself in memory.
PLAIN_SLICE_VALUES = 1 << 28


def _column_slices(fmt: PlaneFormat, lead, n: int):
    """Column slices of the plain version: about ``PLAIN_SLICE_VALUES``
    weight values each."""
    step = max(1, PLAIN_SLICE_VALUES // max(1, fmt.k_dim * math.prod(lead)))
    return [slice(c0, min(c0 + step, n)) for c0 in range(0, max(n, 1), step)]


def mpmm_torch_acc(a_biased: torch.Tensor, planes: torch.Tensor, *,
                   fmt: PlaneFormat) -> torch.Tensor:
    """Plain version of K1's accumulator-only mode: the exact int32
    ``a_biased @ W_int`` (a group as in ``mpmm_torch``), no epilogue."""
    outs = []
    for sl in _column_slices(fmt, a_biased.shape[:-2], planes.shape[-1]):
        w8 = _ref.combined_int8_weights(planes[..., sl], fmt)
        outs.append(_ref.int_matmul(a_biased, w8))
        del w8
    return outs[0] if len(outs) == 1 else torch.cat(outs, dim=-1)


def mpmm_torch(a_biased: torch.Tensor, planes: torch.Tensor,
               gamma: torch.Tensor, colsum: torch.Tensor, *,
               fmt: PlaneFormat, act_zero: int, variant: str = "st",
               out_dtype=torch.float32,
               epilogue: Optional[EpilogueSpec] = None,
               scale: Optional[torch.Tensor] = None,
               shift: Optional[torch.Tensor] = None,
               residual: Optional[torch.Tensor] = None) -> torch.Tensor:
    """Plain version of K1 (twin of ``ops._xla_impl``): one exact integer
    product against the recombined weights, then the shared epilogue; a
    group (a_biased (E, M, K), planes (E, P, Kp, N), E x N column values)
    is E such products, as the reference's ``jax.vmap`` runs them.  Wide
    weights run in column slices (``PLAIN_SLICE_VALUES``): every output
    column depends on its own weight column only, so the bits are those of
    one product.  ``variant`` does not change the integers, so it is
    accepted and unused."""
    del variant
    _epi.validate_operands(epilogue, scale, shift, residual)
    out_dtype = _epi.resolve_out_dtype(epilogue, out_dtype)
    lead = a_biased.shape[:-2]
    n = planes.shape[-1]
    cols = lambda t: (None if t is None  # noqa: E731
                      else t.reshape(*lead, 1, n))
    gamma, colsum, scale, shift = map(cols, (gamma, colsum, scale, shift))
    outs = []
    for sl in _column_slices(fmt, lead, n):
        w8 = _ref.combined_int8_weights(planes[..., sl], fmt)
        acc = _ref.int_matmul(a_biased, w8)
        del w8
        part = lambda t: None if t is None else t[..., sl]  # noqa: E731
        outs.append(_epi.finish(
            acc, gamma[..., sl], colsum[..., sl], act_zero=act_zero,
            spec=epilogue, scale=part(scale), shift=part(shift),
            residual=part(residual), out_dtype=out_dtype))
        del acc
    return outs[0] if len(outs) == 1 else torch.cat(outs, dim=-1)
