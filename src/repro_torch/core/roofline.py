"""Roofline terms and the attribution of a measured time (port of
``repro.core.roofline``), with the NVIDIA H100 as the default device.

``HW`` describes one accelerator: its peak rates, its memory, the on-chip
memory a tile may hold and the granularity of its matrix unit.  ``H100``
is the H100 SXM 80GB data sheet at 700 W: 989 TFLOP/s dense bf16, 1979
TOP/s dense int8 on the tensor cores, 3.35 TB/s of HBM3, 80 GB, 132 SMs
with 228 KB of shared memory each (227 KB a block), NVLink 4 at 18 links.
The int8 ``wgmma`` takes m64 x n(8..256, in steps of 8) x k32, so its
granularity is (m, k, n) = (64, 32, 8).

``tiles`` says who picks a GEMM's tile.  ``"grid"``: the autotuner sweeps
a (bm, bk, bn) grid under the on-chip budget and the kernel obeys, as on
a TPU.  ``"kernels"``: the port's K1 and K2 choose their own route, tile
and split by shape (``kernels/mpmm/kernel.mpmm_route``, ``split_plan``,
``conv_kernel.conv_plan``), and the cost model (``core/dse``) scores the
tile they will run.

``collective_wire_bytes`` and ``roofline_from_compiled`` of the JAX
package read XLA's compiled HLO; they have no torch counterpart until the
dry-run launcher is ported.
"""
from __future__ import annotations

import dataclasses
from typing import Dict, List, Tuple

__all__ = ["HW", "H100", "RooflineReport", "attribute_measured_time"]


@dataclasses.dataclass(frozen=True)
class HW:
    name: str
    peak_flops_bf16: float   # FLOP/s per device
    peak_ops_int8: float     # OP/s per device
    hbm_bw: float            # bytes/s per device
    ici_bw: float            # bytes/s per link and direction
    ici_links: int           # links per device
    hbm_bytes: float         # device memory
    smem_bytes: float        # on-chip memory a tile may use (per SM / core)
    mma: Tuple[int, int, int]  # (m, k, n) granularity of the matrix unit
    tiles: str               # 'grid' (autotuned) | 'kernels' (by shape)
    sm_count: int = 1        # multiprocessors (cores) per device
    smem_per_block: float = 0.0  # on-chip bytes one block may take

    def __post_init__(self):
        if self.tiles not in ("grid", "kernels"):
            raise ValueError(f"tiles must be 'grid' or 'kernels', got "
                             f"{self.tiles!r}")

    @property
    def ici_bw_per_chip(self) -> float:
        # Ring collectives drive one link pair per axis: 2 active links.
        return 2.0 * self.ici_bw


H100 = HW(
    name="h100-sxm",
    peak_flops_bf16=989e12,
    peak_ops_int8=1979e12,
    hbm_bw=3.35e12,
    ici_bw=25e9,
    ici_links=18,
    hbm_bytes=80e9,
    smem_bytes=228 * 1024,
    mma=(64, 32, 8),
    tiles="kernels",
    sm_count=132,
    smem_per_block=227 * 1024,
)


@dataclasses.dataclass
class RooflineReport:
    arch: str
    shape: str
    mesh: Tuple[Tuple[str, int], ...]
    flops_per_device: float
    bytes_per_device: float
    wire_bytes_per_device: float
    compute_s: float
    memory_s: float
    collective_s: float
    model_flops: float            # 6*N*D (or 2*N*tokens for inference)
    hw: HW = H100

    @property
    def dominant(self) -> str:
        terms = {"compute": self.compute_s, "memory": self.memory_s,
                 "collective": self.collective_s}
        return max(terms, key=terms.get)

    @property
    def bound_s(self) -> float:
        return max(self.compute_s, self.memory_s, self.collective_s)

    def _chips(self) -> int:
        chips = 1
        for _, s in self.mesh:
            chips *= s
        return chips

    @property
    def useful_flops_ratio(self) -> float:
        """MODEL_FLOPS / (counted FLOPs x devices): redundancy waste."""
        total = self.flops_per_device * self._chips()
        return self.model_flops / total if total else 0.0

    @property
    def roofline_fraction(self) -> float:
        """Useful model FLOPs per device-second of the bound over the bf16
        peak: the MFU analogue."""
        if self.bound_s <= 0:
            return 0.0
        achieved = self.model_flops / self._chips() / self.bound_s
        return achieved / self.hw.peak_flops_bf16

    def row(self) -> Dict[str, object]:
        return {
            "arch": self.arch,
            "shape": self.shape,
            "mesh": "x".join(str(s) for _, s in self.mesh),
            "compute_s": self.compute_s,
            "memory_s": self.memory_s,
            "collective_s": self.collective_s,
            "dominant": self.dominant,
            "useful_flops_ratio": self.useful_flops_ratio,
            "roofline_fraction": self.roofline_fraction,
        }


def attribute_measured_time(layers: List[Dict[str, float]],
                            measured_s: float,
                            hw: HW = H100) -> Dict[str, object]:
    """Attribute ONE measured device time across per-layer roofline times.

    ``layers`` rows carry ``name``, ``w_bits``, ``layer_class``, ``macs``,
    ``roofline_s``, ``compute_s``, ``memory_s`` and ``hbm_bytes``.  With one
    aggregate measurement the only assignment that invents no per-layer
    anomaly is the proportional one,

        attributed_s(l) = roofline_s(l) * measured_s / sum roofline_s,

    so every layer shares one slowdown and ``roofline_fraction`` (sum
    roofline / measured) is the whole model's utilization: the quantity
    the paper's 1.13 TOps/s maps onto.
    """
    total_roofline = sum(l["roofline_s"] for l in layers)
    if total_roofline <= 0.0 or measured_s <= 0.0:
        return {"measured_s": measured_s, "roofline_s": total_roofline,
                "roofline_fraction": 0.0, "layers": []}
    scale = measured_s / total_roofline
    rows = []
    for l in layers:
        attributed_s = l["roofline_s"] * scale
        flops = 2.0 * l["macs"]
        rows.append({
            "name": l["name"],
            "w_bits": int(l["w_bits"]),
            "layer_class": l.get("layer_class", "inner"),
            "bound": "compute" if l["compute_s"] >= l["memory_s"]
                     else "memory",
            "share": l["roofline_s"] / total_roofline,
            "attributed_s": attributed_s,
            "achieved_tops": flops / attributed_s / 1e12,
            "roofline_tops": flops / l["roofline_s"] / 1e12,
            "achieved_hbm_gbps": l["hbm_bytes"] / attributed_s / 1e9,
            "roofline_hbm_gbps": l["hbm_bytes"] / l["roofline_s"] / 1e9,
        })
    total_macs = sum(l["macs"] for l in layers)
    return {
        "measured_s": measured_s,
        "roofline_s": total_roofline,
        "roofline_fraction": total_roofline / measured_s,
        "achieved_tops": 2.0 * total_macs / measured_s / 1e12,
        "roofline_tops": 2.0 * total_macs / total_roofline / 1e12,
        "peak_int8_tops": hw.peak_ops_int8 / 1e12,
        "layers": rows,
    }
