"""Holistic design-space exploration (paper Section III, Fig. 2), port of
``repro.core.dse`` with the H100 as the default device.

The paper's three boxes:

  blue  (PE DSE)        -> kernel variant (Sum-Together / Sum-Apart) x
                           slice k: matrix-unit passes, packed bytes.
  red   (PE-array DSE)  -> the tile (bm, bk, bn): Eq. 1's N_PE becomes the
                           tile's MAC count, Eq. 2's BRAM the on-chip
                           working set, Eq. 3's U(l) the ceil-division
                           waste of the padded loop nest.
  green (dataflow)      -> per-layer roofline: every candidate is scored
                           by max(compute_s, memory_s) over the model's
                           GEMM workload and the fastest wins.

Who picks the tile depends on the device (``HW.tiles``).  Under
``"grid"`` the (bm, bk, bn) grid is swept under half the on-chip budget,
as the JAX package does for its Pallas kernel.  Under ``"kernels"`` (the
H100) K1 and K2 pick their own route, tile and split by shape, and the
cost model scores exactly that tile -- the invariant that the model
scores what the kernel runs:

  * K1 route A (``wgmma``, M > 16): 256 x 128 x 128 (bm x bk x bn), 128 x
    128 x 128 under Sum-Apart (``kernel.TILE``; csrc/mpmm_wgmma.cu MI);
  * K1 route B (``splitk``, M <= 16): all M rows x one K chunk of
    ``kernel.split_plan`` x a strip of ``kernel.strip_cols(M)`` columns;
  * K2 (the implicit conv): ``conv_kernel.conv_plan``'s bm x BK x bn
    (128 x 128 x 64/128), where K2 can run the layer at all.

Under Sum-Together the H100 kernels OR the digit planes into int8 codes
and run one product a K-step whatever the plane count; Sum-Apart runs one
product a plane.  The TPU's MXU runs a pass a plane either way.
"""
from __future__ import annotations

import dataclasses
import functools
import itertools
import math
from typing import Dict, Iterable, List, Optional, Sequence, Tuple

from repro_torch.core.packing import PlaneFormat
from repro_torch.core.roofline import H100, HW

__all__ = [
    "Gemm",
    "ConvShape",
    "TileCandidate",
    "smem_working_set",
    "tile_utilization",
    "gemm_time",
    "conv_time",
    "choose_tile",
    "choose_conv_dataflow",
    "dse_sweep",
    "DseChoice",
    "ConvDataflowChoice",
    "autotune_tile",
    "digit_cache_bytes",
]


@dataclasses.dataclass(frozen=True)
class Gemm:
    """One GEMM of the workload: out[M,N] += act[M,K] @ w[K,N], ``count``
    times.  'boundary' layers run at 8 bit whatever the policy (the paper
    pins the first and last layers)."""

    name: str
    m: int
    k: int
    n: int
    count: int = 1
    layer_class: str = "inner"

    @property
    def macs(self) -> int:
        return self.m * self.k * self.n * self.count


def _ceil(a: int, b: int) -> int:
    return -(-a // b)


@dataclasses.dataclass(frozen=True)
class ConvShape:
    """One conv layer in NHWC/HWIO form, the dataflow-selection unit.  The
    GEMM view (M = B·Ho·Wo, K = kh·kw·C, N = Cout) drives the compute term;
    the conv view (B·H·W·C input bytes) the implicit dataflow's memory
    term."""

    batch: int
    h: int
    w: int
    c_in: int
    c_out: int
    kh: int
    kw: int
    stride: int = 1
    padding: str = "SAME"
    layer_class: str = "inner"

    def _out(self, size: int, win: int) -> int:
        if self.padding == "SAME":
            return _ceil(size, self.stride)
        return (size - win) // self.stride + 1

    @property
    def ho(self) -> int:
        return self._out(self.h, self.kh)

    @property
    def wo(self) -> int:
        return self._out(self.w, self.kw)

    @property
    def m(self) -> int:
        return self.batch * self.ho * self.wo

    @property
    def k(self) -> int:
        return self.kh * self.kw * self.c_in

    @property
    def patch_reuse(self) -> float:
        """How often im2col copies each input pixel: kh·kw / stride²."""
        return (self.kh * self.kw) / float(self.stride ** 2)

    def gemm(self) -> Gemm:
        return Gemm("conv", self.m, self.k, self.c_out,
                    layer_class=self.layer_class)


@dataclasses.dataclass(frozen=True)
class TileCandidate:
    bm: int
    bk: int
    bn: int

    def as_tuple(self) -> Tuple[int, int, int]:
        return (self.bm, self.bk, self.bn)


def smem_working_set(tile: TileCandidate, fmt: PlaneFormat,
                     variant: str = "st") -> int:
    """Eq. 2 analogue: on-chip bytes live per tile step (double-buffered
    activation and packed-weight tiles, the decoded digit slot, the
    accumulators, the output tile and the column operands)."""
    p = fmt.planes
    f = fmt.digits_per_byte
    act = tile.bm * tile.bk                      # int8
    wgt = p * _ceil(tile.bk, f) * tile.bn        # uint8 packed planes
    dig = p * tile.bk * tile.bn                  # decoded int8 digits
    accs = (p if variant == "sa" else 1) * tile.bm * tile.bn * 4
    out = tile.bm * tile.bn * 4
    scales = 2 * tile.bn * 8                     # gamma + colsum blocks
    return 2 * (act + wgt) + dig + accs + out + scales


def tile_utilization(g: Gemm, tile: TileCandidate) -> float:
    """Eq. 3 analogue: ideal MACs / padded MACs (ceil-division waste)."""
    padded = (_ceil(g.m, tile.bm) * tile.bm * _ceil(g.k, tile.bk) * tile.bk
              * _ceil(g.n, tile.bn) * tile.bn)
    return (g.m * g.k * g.n) / padded


def _unit_efficiency(tile: TileCandidate, hw: HW) -> float:
    """Share of the matrix unit's (m, k, n) granularity a tile feeds."""
    gm, gk, gn = hw.mma
    eff_k = tile.bk / (_ceil(tile.bk, gk) * gk)
    eff_n = tile.bn / (_ceil(tile.bn, gn) * gn)
    eff_m = tile.bm / (_ceil(tile.bm, gm) * gm)
    return eff_k * eff_n * eff_m


def _passes(fmt: PlaneFormat, variant: str, hw: HW) -> int:
    """Matrix-unit passes a K-step: one per plane, except under the H100
    kernels' Sum-Together, which combine the planes into one code first."""
    if hw.tiles == "kernels" and variant == "st":
        return 1
    return fmt.planes


def gemm_time(g: Gemm, tile: TileCandidate, fmt: PlaneFormat, hw: HW = H100,
              variant: str = "st", a_bits: int = 8) -> Tuple[float, float]:
    """(compute_s, memory_s) of one GEMM under a tile and format.

    Compute: the passes over the padded loop nest at the int8 peak.
    Memory: the tiled product's HBM traffic -- activations read once per
    N tile, packed weights once per M tile, outputs written once.
    """
    p = fmt.planes
    gm, gk, gn = _ceil(g.m, tile.bm), _ceil(g.k, tile.bk), _ceil(g.n, tile.bn)
    padded_macs = gm * tile.bm * gk * tile.bk * gn * tile.bn
    compute_s = (g.count * 2.0 * padded_macs * _passes(fmt, variant, hw)
                 / (hw.peak_ops_int8 * _unit_efficiency(tile, hw)))
    act_bytes = g.m * g.k * 1 * gn
    wgt_bytes = p * _ceil(g.k, fmt.digits_per_byte) * g.n * gm
    out_bytes = g.m * g.n * 4
    memory_s = g.count * (act_bytes + wgt_bytes + out_bytes) / hw.hbm_bw
    return compute_s, memory_s


def conv_time(conv: ConvShape, tile: TileCandidate, fmt: PlaneFormat,
              hw: HW = H100, variant: str = "st",
              dataflow: str = "im2col") -> Tuple[float, float]:
    """(compute_s, memory_s) of one conv under a tile and a dataflow.

    Compute does not depend on the dataflow.  Memory does:
      * ``im2col``: the patch matrix (B·Ho·Wo, kh·kw·C) is written to HBM
        once and read back per N tile;
      * ``implicit``: the raw (padded-extent) feature map is read per N
        tile and patches never leave the chip.
    Weights and outputs cost the same either way.
    """
    g = conv.gemm()
    compute_s, _ = gemm_time(g, tile, fmt, hw, variant)
    gm, gn = _ceil(g.m, tile.bm), _ceil(g.n, tile.bn)
    if dataflow == "im2col":
        act_bytes = (conv.batch * conv.h * conv.w * conv.c_in
                     + g.m * g.k * (1 + gn))
    elif dataflow == "implicit":
        h_pad = (conv.ho - 1) * conv.stride + conv.kh
        w_pad = (conv.wo - 1) * conv.stride + conv.kw
        act_bytes = conv.batch * h_pad * w_pad * conv.c_in * gn
    else:
        raise ValueError(f"unknown dataflow {dataflow!r}")
    wgt_bytes = fmt.planes * _ceil(g.k, fmt.digits_per_byte) * g.n * gm
    out_bytes = g.m * g.n * 4
    memory_s = (act_bytes + wgt_bytes + out_bytes) / hw.hbm_bw
    return compute_s, memory_s


@dataclasses.dataclass(frozen=True)
class ConvDataflowChoice:
    """Per-layer dataflow decision (the green box, extended to convs)."""

    dataflow: str               # 'im2col' | 'implicit'
    tile_im2col: Optional[TileCandidate]
    tile_implicit: Optional[TileCandidate]
    time_im2col_s: float
    time_implicit_s: float

    @property
    def tile(self) -> TileCandidate:
        return (self.tile_implicit if self.dataflow == "implicit"
                else self.tile_im2col)

    @property
    def speedup(self) -> float:
        return self.time_im2col_s / self.time_implicit_s


def _kernel_conv_tile(conv: ConvShape, fmt: PlaneFormat
                      ) -> Optional[TileCandidate]:
    """K2's tile for a conv, or None where K2 cannot run it."""
    from repro_torch.kernels.mpmm import conv_kernel, ops
    if not ops.conv_implicit_feasible(conv.c_in, fmt):
        return None
    plan = conv_kernel.conv_plan(conv.batch, conv.ho, conv.wo, conv.c_out,
                                 conv.k, fmt)
    return TileCandidate(plan.bm, conv_kernel.BK, plan.bn)


@functools.lru_cache(maxsize=4096)
def choose_conv_dataflow(conv: ConvShape, *, w_bits: int, k: int,
                         variant: str = "st", hw: HW = H100,
                         smem_budget: Optional[float] = None,
                         pin_tile: bool = True) -> ConvDataflowChoice:
    """im2col vs implicit GEMM for one conv, by the roofline.

    Under ``"kernels"`` each dataflow is scored at the tile its kernel
    runs: im2col at K1's (``autotune_tile`` of the patch GEMM), implicit
    at K2's (``conv_kernel.conv_plan``); a layer K2 cannot run (C not a
    multiple of the packed digits a byte) has no implicit candidate.
    Under ``"grid"`` im2col sweeps the grid; implicit pins bm = Wo and bk
    = C (one output row, one kernel position a step) with ``pin_tile``,
    else sweeps the grid too.  The faster total wins; ties go to implicit.
    """
    fmt = PlaneFormat(w_bits=w_bits, k=k, k_dim=conv.k)
    if hw.tiles == "kernels":
        tile_i = autotune_tile(conv.m, conv.k, conv.c_out, w_bits=w_bits,
                               k=k, variant=variant, hw=hw)
        t_i = max(conv_time(conv, tile_i, fmt, hw, variant, "im2col"))
        tile_d = _kernel_conv_tile(conv, fmt)
        t_d = (math.inf if tile_d is None
               else max(conv_time(conv, tile_d, fmt, hw, variant,
                                  "implicit")))
    else:
        budget = (smem_budget if smem_budget is not None
                  else 0.5 * hw.smem_bytes)
        best: Dict[str, Tuple[float, Optional[TileCandidate]]] = {
            "im2col": (math.inf, None), "implicit": (math.inf, None)}
        implicit_tiles: Iterable[TileCandidate] = (
            [TileCandidate(conv.wo, conv.c_in, bn)
             for bn in (128, 256, 512, 1024)]
            if pin_tile else _tile_grid(hw))
        for flow, tiles in (("im2col", _tile_grid(hw)),
                            ("implicit", implicit_tiles)):
            for tile in tiles:
                if smem_working_set(tile, fmt, variant) > budget:
                    continue
                c, m = conv_time(conv, tile, fmt, hw, variant, dataflow=flow)
                if max(c, m) < best[flow][0]:
                    best[flow] = (max(c, m), tile)
        t_i, tile_i = best["im2col"]
        t_d, tile_d = best["implicit"]
        if tile_i is None and tile_d is None:
            raise ValueError("no feasible conv tile under the on-chip "
                             "budget")
    flow = "implicit" if (tile_d is not None and t_d <= t_i) else "im2col"
    return ConvDataflowChoice(flow, tile_i, tile_d, t_i, t_d)


def _tile_grid(hw: HW) -> Iterable[TileCandidate]:
    """The autotuner's (bm, bk, bn) grid (``"grid"`` devices)."""
    bms = [8, 16, 32, 64, 128, 256, 512]
    bks = [128, 256, 512, 1024, 2048]
    bns = [128, 256, 512, 1024, 2048]
    for bm, bk, bn in itertools.product(bms, bks, bns):
        yield TileCandidate(bm, bk, bn)


@dataclasses.dataclass
class DseChoice:
    """Output of the red+green boxes for one (model, policy) pair."""

    tile: TileCandidate
    k: int
    variant: str
    total_time_s: float
    compute_s: float
    memory_s: float
    mean_utilization: float
    smem_bytes: int
    n_candidates: int

    def row(self) -> Dict[str, object]:
        return dataclasses.asdict(self) | {"tile": self.tile.as_tuple()}


def _route_a_tile(variant: str) -> TileCandidate:
    """K1 route A's tile: two warpgroups of two 64-row products under
    Sum-Together, of one under Sum-Apart (csrc/mpmm_wgmma.cu MI)."""
    from repro_torch.kernels.mpmm import kernel
    bm, bk, bn = kernel.TILE
    return TileCandidate(bm if variant == "st" else bm // 2, bk, bn)


def choose_tile(gemms: Sequence[Gemm], *, w_bits: int, k: int,
                variant: str = "st", hw: HW = H100,
                smem_budget: Optional[float] = None) -> DseChoice:
    """Red box: the tile minimizing the model's roofline time.

    Under ``"kernels"`` there is nothing to sweep: every GEMM is scored at
    the tile its kernel picks by shape, and the choice reports route A's
    tile (the one a tile-sized layer runs)."""
    fmt_inner = PlaneFormat(w_bits=w_bits, k=k, k_dim=1)
    fmt_bound = PlaneFormat(w_bits=8, k=min(k, 8), k_dim=1)
    if hw.tiles == "kernels":
        tot_c = tot_m = 0.0
        utils = []
        for g in gemms:
            fmt = fmt_bound if g.layer_class == "boundary" else fmt_inner
            fmt = dataclasses.replace(fmt, k_dim=g.k)
            tile = autotune_tile(g.m, g.k, g.n, w_bits=fmt.w_bits, k=fmt.k,
                                 variant=variant, hw=hw)
            c, m = gemm_time(g, tile, fmt, hw, variant)
            tot_c += c
            tot_m += m
            utils.append(tile_utilization(g, tile))
        tile = _route_a_tile(variant)
        return DseChoice(
            tile=tile, k=k, variant=variant, total_time_s=max(tot_c, tot_m),
            compute_s=tot_c, memory_s=tot_m,
            mean_utilization=sum(utils) / max(len(utils), 1),
            smem_bytes=smem_working_set(tile, fmt_inner, variant),
            n_candidates=1)
    budget = smem_budget if smem_budget is not None else 0.5 * hw.smem_bytes
    best: Optional[DseChoice] = None
    n_cand = 0
    for tile in _tile_grid(hw):
        ws = smem_working_set(tile, fmt_inner, variant)
        if ws > budget:
            continue  # does not fit on chip: the HWC gate of Fig. 2
        n_cand += 1
        tot_c = tot_m = 0.0
        utils = []
        for g in gemms:
            fmt = fmt_bound if g.layer_class == "boundary" else fmt_inner
            c, m = gemm_time(g, tile, fmt, hw, variant)
            tot_c += c
            tot_m += m
            utils.append(tile_utilization(g, tile))
        total = max(tot_c, tot_m)  # green box: roofline over the net
        if best is None or total < best.total_time_s:
            best = DseChoice(
                tile=tile, k=k, variant=variant, total_time_s=total,
                compute_s=tot_c, memory_s=tot_m,
                mean_utilization=sum(utils) / max(len(utils), 1),
                smem_bytes=ws, n_candidates=0)
    if best is None:
        raise ValueError("no feasible tile under the on-chip budget")
    best.n_candidates = n_cand
    return best


def digit_cache_bytes(k_dim: int, tile: TileCandidate,
                      fmt: PlaneFormat) -> int:
    """On-chip bytes of the full decoded digit strip of one N tile:
    ceil(K/bk) slots of (bk, P*bn) int8."""
    slots = _ceil(k_dim, tile.bk)
    return slots * tile.bk * fmt.planes * tile.bn


@functools.lru_cache(maxsize=4096)
def autotune_tile(m: int, k_dim: int, n: int, *, w_bits: int, k: int,
                  variant: str = "st", hw: HW = H100,
                  smem_budget: Optional[float] = None) -> TileCandidate:
    """One GEMM's tile.  ``"kernels"``: the tile K1 runs at this shape
    (route A's, or route B's rows x K chunk x column strip); ``"grid"``:
    the roofline's best over the grid (``choose_tile`` of one GEMM)."""
    if hw.tiles == "kernels":
        from repro_torch.kernels.mpmm import kernel
        if kernel.mpmm_route(m, k_dim, n) == "wgmma":
            return _route_a_tile(variant)
        fmt = PlaneFormat(w_bits=w_bits, k=k, k_dim=k_dim)
        plan = kernel.split_plan(m, k_dim, n, fmt)
        return TileCandidate(m, plan.chunk_bytes * fmt.digits_per_byte,
                             kernel.strip_cols(m))
    return choose_tile([Gemm("layer", m, k_dim, n)], w_bits=w_bits, k=k,
                       variant=variant, hw=hw, smem_budget=smem_budget).tile


def dse_sweep(gemms: Sequence[Gemm], *, w_bits: int,
              slices: Sequence[int] = (1, 2, 4, 8),
              variants: Sequence[str] = ("st", "sa"),
              hw: HW = H100) -> List[DseChoice]:
    """Blue+red+green: sweep the slice k and the variant; choices sorted
    by total model time, best first (the Table II analogue).  k > w_Q
    wastes plane bits, as in the paper; those points stay to show it."""
    out = []
    for k, variant in itertools.product(slices, variants):
        try:
            out.append(choose_tile(gemms, w_bits=w_bits, k=k,
                                   variant=variant, hw=hw))
        except ValueError:
            continue
    return sorted(out, key=lambda c: c.total_time_s)
