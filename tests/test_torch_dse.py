"""The port's cost model (``repro_torch.core.dse``) against the JAX
package's, and against the kernels it models.

* With the TPU entry built from ``repro``'s fields (``tpu_hw``: the tile
  grid autotuned under the VMEM budget), every function returns exactly
  what ``repro.core.dse`` returns over the GEMM and conv workloads of
  ResNet-18/50/152 and granite-8b at batches 1 and 8.
* With the H100 (the default), the model scores the tile the kernel runs:
  ``autotune_tile`` equals K1's own choice (``kernel.mpmm_route``, route
  A's tile, route B's ``split_plan`` chunk and column strip) and
  ``choose_conv_dataflow``'s implicit tile equals K2's
  (``conv_kernel.conv_plan``) at every ResNet-18 and granite-8b serve
  shape; a layer K2 cannot run never gets 'implicit'.
* ``dataflow='auto'`` serves the same logits as either forced dataflow.
"""
import dataclasses
from pathlib import Path

import pytest

torch = pytest.importorskip("torch")

import numpy as np  # noqa: E402

from repro import configs as jconfigs  # noqa: E402
from repro.core import dse as jdse  # noqa: E402
from repro.core.packing import PlaneFormat as JFormat  # noqa: E402
from repro.core.roofline import TPU_V5E  # noqa: E402
from repro_torch import configs  # noqa: E402
from repro_torch.core import dse  # noqa: E402
from repro_torch.core.packing import PlaneFormat  # noqa: E402
from repro_torch.core.plan import PrecisionPlan  # noqa: E402
from repro_torch.core.precision import PrecisionPolicy  # noqa: E402
from repro_torch.kernels.mpmm import conv_kernel, kernel, ops  # noqa: E402
from repro_torch.models import resnet as R  # noqa: E402
from repro_torch.nn import quantized as Q  # noqa: E402
from test_torch_roofline import tpu_hw  # noqa: E402

EX = Path(__file__).resolve().parents[1] / "examples"

ARCHS = ("resnet18", "resnet50", "resnet152", "granite-8b")
FORMATS = [(w, k) for w in (1, 2, 4, 8) for k in (1, 2, 4, 8)]
TPU = tpu_hw()


def _gemms(arch, batch):
    """(port Gemms, JAX Gemms) of one workload."""
    mine = configs.get(arch).gemm_workload(batch)
    ref = jconfigs.get(arch).gemm_workload(batch)
    return mine, ref


def _jg(g):
    return jdse.Gemm(g.name, g.m, g.k, g.n, g.count, g.layer_class)


def _tile(t):
    return None if t is None else t.as_tuple()


def resnet_convs(cfg, batch):
    """ConvShapes of a ResNet's convs (the stem and every block's)."""
    hw = cfg.img_size // 4
    out = [("stem", dse.ConvShape(batch, cfg.img_size, cfg.img_size, 3,
                                  cfg.width, 7, 7, 2,
                                  layer_class="boundary"))]
    for si, bi, cin, cmid, stride in R._block_channels(cfg):
        key = f"s{si}b{bi}"
        ho = -(-hw // stride)
        if cfg.block == "bottleneck":
            cout = 4 * cmid
            layers = [("c1", hw, cin, cmid, 1, 1), ("c2", hw, cmid, cmid, 3,
                                                    stride),
                      ("c3", ho, cmid, cout, 1, 1)]
        else:
            cout = cmid
            layers = [("c1", hw, cin, cmid, 3, stride),
                      ("c2", ho, cmid, cmid, 3, 1)]
        if stride != 1 or cin != cout:
            layers.append(("p", hw, cin, cout, 1, stride))
        for sfx, h, ci, co, kk, s in layers:
            out.append((key + sfx, dse.ConvShape(batch, h, h, ci, co, kk, kk,
                                                 s)))
        hw = ho
    return out


def _jconv(c):
    return jdse.ConvShape(c.batch, c.h, c.w, c.c_in, c.c_out, c.kh, c.kw,
                          c.stride, c.padding, c.layer_class)


# --- against the JAX package, on the TPU entry ------------------------------


@pytest.mark.parametrize("batch", [1, 8])
@pytest.mark.parametrize("arch", ARCHS)
def test_workload_gemms_equal_reference(arch, batch):
    mine, ref = _gemms(arch, batch)
    assert [dataclasses.astuple(g) for g in mine] == \
        [dataclasses.astuple(g) for g in ref]
    assert [g.macs for g in mine] == [g.macs for g in ref]


@pytest.mark.parametrize("batch", [1, 8])
@pytest.mark.parametrize("arch", ARCHS)
def test_gemm_terms_equal_reference(arch, batch):
    """tile_utilization, gemm_time (both variants), the working set and
    the digit cache at a few tiles and formats, then autotune_tile."""
    mine, _ = _gemms(arch, batch)
    tiles = [dse.TileCandidate(8, 128, 128), dse.TileCandidate(256, 512, 256),
             dse.TileCandidate(64, 2048, 1024)]
    for g in mine:
        for t in tiles:
            jt = jdse.TileCandidate(*t.as_tuple())
            assert dse.tile_utilization(g, t) == jdse.tile_utilization(
                _jg(g), jt)
            for w, k in ((8, 4), (2, 2), (4, 8), (1, 1)):
                f, jf = PlaneFormat(w, k, g.k), JFormat(w, k, g.k)
                for var in ("st", "sa"):
                    assert dse.gemm_time(g, t, f, TPU, var) == \
                        jdse.gemm_time(_jg(g), jt, jf, TPU_V5E, var)
                    assert dse.smem_working_set(t, f, var) == \
                        jdse.vmem_working_set(jt, jf, var)
                assert dse.digit_cache_bytes(g.k, t, f) == \
                    jdse.digit_cache_bytes(g.k, jt, jf)
        for w, k in ((8, 4), (2, 2)):
            assert dse.autotune_tile(g.m, g.k, g.n, w_bits=w, k=k,
                                     hw=TPU).as_tuple() == \
                jdse.autotune_tile(g.m, g.k, g.n, w_bits=w, k=k).as_tuple()


@pytest.mark.parametrize("batch", [1, 8])
@pytest.mark.parametrize("arch", ARCHS)
def test_choose_tile_equals_reference(arch, batch):
    mine, ref = _gemms(arch, batch)
    for w, k, var in ((2, 2, "st"), (4, 4, "sa"), (8, 4, "st")):
        a = dse.choose_tile(mine, w_bits=w, k=k, variant=var, hw=TPU).row()
        b = jdse.choose_tile(ref, w_bits=w, k=k, variant=var).row()
        b["smem_bytes"] = b.pop("vmem_bytes")
        assert a == b


@pytest.mark.parametrize("arch", ["resnet18", "granite-8b"])
def test_dse_sweep_equals_reference(arch):
    mine, ref = _gemms(arch, 8)
    a = [c.row() for c in dse.dse_sweep(mine, w_bits=4, hw=TPU)]
    b = [c.row() for c in jdse.dse_sweep(ref, w_bits=4)]
    for r in b:
        r["smem_bytes"] = r.pop("vmem_bytes")
    assert a == b


@pytest.mark.parametrize("batch", [1, 8])
@pytest.mark.parametrize("arch", ["resnet18", "resnet50", "resnet152"])
def test_conv_dataflow_equals_reference(arch, batch):
    cfg = configs.get(arch).cfg
    for name, c in resnet_convs(cfg, batch):
        jc = _jconv(c)
        assert (c.ho, c.wo, c.m, c.k, c.patch_reuse) == (
            jc.ho, jc.wo, jc.m, jc.k, jc.patch_reuse)
        for w, k in ((2, 2), (8, 4)):
            for pin in (True, False):
                a = dse.choose_conv_dataflow(c, w_bits=w, k=k, hw=TPU,
                                             pin_tile=pin)
                b = jdse.choose_conv_dataflow(jc, w_bits=w, k=k,
                                              pin_tile=pin)
                assert (a.dataflow, _tile(a.tile_im2col),
                        _tile(a.tile_implicit), a.time_im2col_s,
                        a.time_implicit_s) == (
                    b.dataflow, _tile(b.tile_im2col), _tile(b.tile_implicit),
                    b.time_im2col_s, b.time_implicit_s), name
            t, jt = dse.TileCandidate(128, 128, 128), jdse.TileCandidate(
                128, 128, 128)
            for flow in ("im2col", "implicit"):
                assert dse.conv_time(c, t, PlaneFormat(w, k, c.k), TPU,
                                     "st", flow) == jdse.conv_time(
                    jc, jt, JFormat(w, k, c.k), TPU_V5E, "st", flow)


def test_conv_time_rejects_unknown_dataflow():
    c = dse.ConvShape(1, 8, 8, 16, 16, 3, 3)
    with pytest.raises(ValueError, match="dataflow"):
        dse.conv_time(c, dse.TileCandidate(128, 128, 128),
                      PlaneFormat(8, 4, c.k), dataflow="direct")


# --- the H100: the tile the kernel runs -------------------------------------


def _lm_serve_rows():
    """granite-8b's K1 rows: prefill of 4 x 1000 tokens and 1 x 8, decode
    at batches 1-8 and the speculative verify (4 x 5)."""
    return (4000, 8, 1, 2, 4, 8, 20)


def _serve_gemms():
    out = []
    for b in (1, 2, 4, 8):
        out += configs.get("resnet18").gemm_workload(b)
    for m in _lm_serve_rows():
        out += configs.get("granite-8b").gemm_workload(m)
    return out


@pytest.mark.parametrize("variant", ["st", "sa"])
def test_h100_autotune_is_the_kernels_tile(variant):
    for g in _serve_gemms():
        for w, k in FORMATS:
            t = dse.autotune_tile(g.m, g.k, g.n, w_bits=w, k=k,
                                  variant=variant)
            if kernel.mpmm_route(g.m, g.k, g.n) == "wgmma":
                bm, bk, bn = kernel.TILE
                want = (bm if variant == "st" else bm // 2, bk, bn)
            else:
                fmt = PlaneFormat(w, k, g.k)
                plan = kernel.split_plan(g.m, g.k, g.n, fmt)
                want = (g.m, plan.chunk_bytes * fmt.digits_per_byte,
                        kernel.strip_cols(g.m))
            assert t.as_tuple() == want, (g, w, k)


@pytest.mark.parametrize("batch", [1, 2, 4, 8])
def test_h100_conv_tiles_are_the_kernels(batch):
    cfg = configs.get("resnet18").cfg
    for name, c in resnet_convs(cfg, batch):
        for w, k in FORMATS:
            fmt = PlaneFormat(w, k, c.k)
            ch = dse.choose_conv_dataflow(c, w_bits=w, k=k)
            assert ch.tile_im2col == dse.autotune_tile(c.m, c.k, c.c_out,
                                                       w_bits=w, k=k)
            if not ops.conv_implicit_feasible(c.c_in, fmt):
                assert ch.tile_implicit is None and ch.dataflow == "im2col"
                continue
            plan = conv_kernel.conv_plan(batch, c.ho, c.wo, c.c_out, c.k,
                                         fmt)
            assert ch.tile_implicit.as_tuple() == (plan.bm, conv_kernel.BK,
                                                   plan.bn), name


def test_h100_never_routes_an_infeasible_conv_to_k2():
    """The stem (C = 3) under k < 8 and odd channel counts: K2 cannot run
    them, so the model never answers 'implicit' there."""
    shapes = [dse.ConvShape(b, 224, 224, 3, 64, 7, 7, 2) for b in (1, 8)]
    shapes += [dse.ConvShape(2, 14, 14, c, 64, 3, 3, 1) for c in (3, 5, 6)]
    n_infeasible = 0
    for c in shapes:
        for w, k in FORMATS:
            ch = dse.choose_conv_dataflow(c, w_bits=w, k=k)
            if not ops.conv_implicit_feasible(c.c_in, PlaneFormat(w, k, c.k)):
                n_infeasible += 1
                assert ch.dataflow == "im2col" and ch.tile_implicit is None
    assert n_infeasible > 20


def test_h100_passes_sum_together_once():
    """Sum-Together combines the planes into one code, Sum-Apart runs a
    product a plane; the TPU entry runs a pass a plane either way."""
    g = dse.Gemm("g", 4096, 4096, 4096)
    t = dse.TileCandidate(256, 128, 128)
    f = PlaneFormat(8, 2, g.k)  # four planes
    st, sa = dse.gemm_time(g, t, f)[0], dse.gemm_time(g, t, f,
                                                      variant="sa")[0]
    assert sa == pytest.approx(4 * st)
    assert dse.gemm_time(g, t, f, TPU)[0] == dse.gemm_time(
        g, t, f, TPU, variant="sa")[0]


def test_h100_choose_tile_scores_every_layer_at_its_kernel_tile():
    gemms = configs.get("resnet18").gemm_workload(8)
    ch = dse.choose_tile(gemms, w_bits=2, k=2)
    assert ch.tile.as_tuple() == kernel.TILE and ch.n_candidates == 1
    tot = 0.0
    for g in gemms:
        w = 8 if g.layer_class == "boundary" else 2
        k = 2
        tile = dse.autotune_tile(g.m, g.k, g.n, w_bits=w, k=k)
        c, m = dse.gemm_time(g, tile, PlaneFormat(w, k, g.k))
        tot += c
    assert ch.compute_s == pytest.approx(tot, rel=1e-12)
    assert [c.k for c in dse.dse_sweep(gemms, w_bits=2)]


def test_auto_dataflow_is_the_cost_models_choice():
    plan = PrecisionPlan.load(EX / "plans" / "resnet18_mixed.json")
    cfg = configs.get("resnet18").cfg
    for name, c in resnet_convs(cfg, 8)[1:]:
        pol = plan.policy_for(name)
        got = Q.conv_serve_dataflow((8, c.h, c.w, c.c_in), pol, k=c.kh,
                                    stride=c.stride, padding="SAME",
                                    layer_class="inner", n_out=c.c_out)
        assert got == dse.choose_conv_dataflow(
            c, w_bits=pol.inner_bits, k=pol.k).dataflow


def test_auto_dataflow_serves_the_same_logits():
    """Both dataflows are bit-exact, so 'auto' (whatever it picks) equals
    each forced one on a small ResNet."""
    cfg = R.ResNetConfig(name="tiny", depth=18, n_classes=10, img_size=32,
                         width=16, stages_override=(1, 1, 1))
    pol = PrecisionPolicy(inner_bits=4, k=2)
    from repro_torch.models.api import ModelAPI
    api = ModelAPI(name="tiny", family="cnn", cfg=cfg, mod=R, policy=pol)
    params = api.init_params(torch.Generator().manual_seed(0), device="cpu")
    state = R.init_bn_state(api.specs(), device="cpu")
    packed = R.pack_for_serve(cfg, params, state, pol)
    x = torch.from_numpy(np.random.default_rng(0).normal(
        0, 1, (2, 32, 32, 3)).astype(np.float32))
    outs = [R.serve_forward(cfg, packed, x, pol, dataflow=d)
            for d in ("auto", "im2col", "implicit")]
    assert torch.equal(outs[0], outs[1]) and torch.equal(outs[0], outs[2])
