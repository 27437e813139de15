"""The port's roofline module (``repro_torch.core.roofline``) against the JAX
package's: ``RooflineReport``'s derived terms and
``attribute_measured_time``, exactly equal for the same inputs and the same
device description.

The JAX package models a TPU v5e; the port holds no TPU constant, so the
TPU entry is built here from ``repro``'s ``TPU_V5E`` fields, with the
MXU's granularity (8 sublanes, 128 x 128) that ``repro.core.dse`` writes
as constants and the autotuned tile grid (``tpu_hw``; the other port test
files import it).  The H100 entry is checked against its data sheet.
"""
import dataclasses

import pytest

torch = pytest.importorskip("torch")

import numpy as np  # noqa: E402

from repro.core import roofline as jroof  # noqa: E402
from repro_torch.core import roofline as roof  # noqa: E402


def tpu_hw() -> roof.HW:
    """The port's ``HW`` for the JAX package's TPU v5e."""
    f = dataclasses.asdict(jroof.TPU_V5E)
    return roof.HW(name=f["name"], peak_flops_bf16=f["peak_flops_bf16"],
                   peak_ops_int8=f["peak_ops_int8"], hbm_bw=f["hbm_bw"],
                   ici_bw=f["ici_bw"], ici_links=f["ici_links"],
                   hbm_bytes=f["hbm_bytes"], smem_bytes=f["vmem_bytes"],
                   mma=(8, 128, 128), tiles="grid")


def test_h100_entry_is_the_data_sheet():
    h = roof.H100
    assert (h.peak_flops_bf16, h.peak_ops_int8, h.hbm_bw) == (
        989e12, 1979e12, 3.35e12)
    assert (h.sm_count, h.smem_bytes, h.smem_per_block) == (
        132, 228 * 1024, 227 * 1024)
    assert h.mma == (64, 32, 8) and h.tiles == "kernels"
    assert h.hbm_bytes == 80e9


def test_hw_rejects_unknown_tile_source():
    with pytest.raises(ValueError, match="tiles"):
        dataclasses.replace(roof.H100, tiles="auto")


def test_tpu_entry_keeps_the_reference_rates():
    t = tpu_hw()
    assert t.ici_bw_per_chip == jroof.TPU_V5E.ici_bw_per_chip
    assert t.smem_bytes == jroof.TPU_V5E.vmem_bytes


REPORTS = [
    dict(arch="resnet18", shape="b8", mesh=(("data", 1),),
         flops_per_device=3.6e10, bytes_per_device=1.2e7,
         wire_bytes_per_device=0.0, compute_s=1.8e-4, memory_s=1.4e-5,
         collective_s=0.0, model_flops=2.9e10),
    dict(arch="granite-8b", shape="prefill", mesh=(("data", 2), ("model", 4)),
         flops_per_device=6.6e13, bytes_per_device=2.1e10,
         wire_bytes_per_device=3.0e9, compute_s=0.33, memory_s=0.026,
         collective_s=0.03, model_flops=4.2e14),
    dict(arch="x", shape="idle", mesh=(), flops_per_device=0.0,
         bytes_per_device=0.0, wire_bytes_per_device=0.0, compute_s=0.0,
         memory_s=0.0, collective_s=0.0, model_flops=0.0),
    dict(arch="y", shape="wire", mesh=(("data", 4),), flops_per_device=1e9,
         bytes_per_device=1e6, wire_bytes_per_device=1e9, compute_s=1e-5,
         memory_s=1e-6, collective_s=2e-3, model_flops=3e9),
]


@pytest.mark.parametrize("kw", REPORTS, ids=[r["arch"] + r["shape"]
                                             for r in REPORTS])
def test_report_equals_reference(kw):
    mine = roof.RooflineReport(**kw, hw=tpu_hw())
    ref = jroof.RooflineReport(**kw)
    assert mine.row() == ref.row()
    assert (mine.dominant, mine.bound_s, mine.useful_flops_ratio,
            mine.roofline_fraction) == (ref.dominant, ref.bound_s,
                                        ref.useful_flops_ratio,
                                        ref.roofline_fraction)


def test_report_reads_its_own_device():
    kw = REPORTS[0]
    h = roof.RooflineReport(**kw)  # the H100 by default
    t = roof.RooflineReport(**kw, hw=tpu_hw())
    assert h.roofline_fraction * 989e12 == pytest.approx(
        t.roofline_fraction * 197e12, rel=1e-12)


def _layers(seed, n):
    rng = np.random.default_rng(seed)
    out = []
    for i in range(n):
        c, m = rng.uniform(1e-7, 1e-4, 2)
        out.append({"name": f"l{i}", "w_bits": int(rng.choice([1, 2, 4, 8])),
                    "layer_class": "boundary" if i in (0, n - 1) else "inner",
                    "macs": float(rng.integers(1e5, 1e9)),
                    "roofline_s": float(max(c, m)), "compute_s": float(c),
                    "memory_s": float(m),
                    "hbm_bytes": float(m * 819e9)})
    return out


@pytest.mark.parametrize("seed,n,measured", [
    (0, 21, 4.2e-3), (1, 5, 1e-6), (2, 1, 0.5), (3, 8, 0.0), (4, 0, 1.0)])
def test_attribution_equals_reference(seed, n, measured):
    layers = _layers(seed, n)
    assert (roof.attribute_measured_time(layers, measured, hw=tpu_hw())
            == jroof.attribute_measured_time(layers, measured,
                                             hw=jroof.TPU_V5E))


def test_attribution_shares_one_slowdown():
    layers = _layers(5, 12)
    rep = roof.attribute_measured_time(layers, 2e-3)
    assert rep["peak_int8_tops"] == 1979.0
    assert sum(r["share"] for r in rep["layers"]) == pytest.approx(1.0)
    ratios = {r["attributed_s"] / l["roofline_s"]
              for r, l in zip(rep["layers"], layers)}
    assert max(ratios) == pytest.approx(min(ratios), rel=1e-12)
