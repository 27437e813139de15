"""The port's core modules against the JAX package: packing, quantizers,
padding, im2col, plans, and the port's import and device hygiene.

Inputs are made with numpy from a seed and go through both packages;
packed bytes and integer codes must match bitwise.
"""
import os
import re
import subprocess
import sys
from pathlib import Path

import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402
import numpy as np  # noqa: E402

from repro.core import packing as jpacking  # noqa: E402
from repro.core import quant as jquant  # noqa: E402
from repro.kernels.mpmm import ops as jops  # noqa: E402
from repro.kernels.mpmm import ref as jref  # noqa: E402
from repro.nn import quantized as jQ  # noqa: E402
from repro_torch import configs  # noqa: E402
from repro_torch.core import packing, quant  # noqa: E402
from repro_torch.core.plan import (LayerPlan, PrecisionPlan,  # noqa: E402
                                   resolve_dataflow, resolve_policy,
                                   validate_plan_json)
from repro_torch.core.precision import PrecisionPolicy  # noqa: E402
from repro_torch.kernels.mpmm import ops, ref  # noqa: E402
from repro_torch.nn import quantized as Q  # noqa: E402

ROOT = Path(__file__).resolve().parent.parent
FIXTURES = ROOT / "tests" / "fixtures" / "plans"

# Every w in {1, 2, 4, 8} with every k dividing 8: k > w packs one plane
# whose k-bit fields hold the w-bit code.
FORMATS = [(w, k) for w in (1, 2, 4, 8) for k in (1, 2, 4, 8)]


def _codes(rng, shape, w_bits):
    return rng.integers(-(2 ** (w_bits - 1)), 2 ** (w_bits - 1),
                        size=shape).astype(np.int32)


@pytest.mark.parametrize("w_bits,k", FORMATS)
def test_pack_planes_byte_identical(w_bits, k):
    """Ragged K (13 is no multiple of 2, 4 or 8): packed bytes, unpacked
    digits, recombined codes and the combined int8 weights all match."""
    rng = np.random.default_rng(w_bits * 10 + k)
    w_int = _codes(rng, (13, 5), w_bits)
    jfmt = jpacking.PlaneFormat(w_bits=w_bits, k=k, k_dim=13)
    fmt = packing.PlaneFormat(w_bits=w_bits, k=k, k_dim=13)

    # At k = 8 with w < 8 the JAX package's combined_int8_weights skips
    # the sign extension (ROADMAP R4): hold the port to its ref there.
    jcombine = (jops.combined_int8_weights if not (k == 8 and w_bits < 8)
                else lambda p, f: jref.unpack_to_int(p, f).astype(jnp.int8))

    @jax.jit  # one compile instead of one per eager JAX op
    def jax_side(w):
        jp = jpacking.pack_planes(w, jfmt)
        return (jp, jpacking.unpack_planes(jp, jfmt), jcombine(jp, jfmt),
                jpacking.split_planes(w, w_bits, k))
    jp, junpacked, jcombined, jsplit = map(np.asarray,
                                           jax_side(jnp.asarray(w_int)))
    tp = packing.pack_planes(torch.from_numpy(w_int), fmt)
    assert tp.dtype == torch.uint8
    np.testing.assert_array_equal(tp.numpy(), jp)
    np.testing.assert_array_equal(packing.unpack_planes(tp, fmt).numpy(),
                                  junpacked)
    np.testing.assert_array_equal(ref.unpack_to_int(tp, fmt).numpy(), w_int)
    np.testing.assert_array_equal(ops.combined_int8_weights(tp, fmt).numpy(),
                                  jcombined)
    np.testing.assert_array_equal(
        packing.split_planes(torch.from_numpy(w_int), w_bits, k).numpy(),
        jsplit)


@pytest.mark.parametrize("signed", [False, True])
def test_quantize_activations_bf16_promotion(signed):
    """bf16 activations over an f32 step: JAX divides in f32; torch would
    keep bf16 for a 0-d f32 divisor.  Values sit on and around rounding
    boundaries, so a bf16 divide or a non-even rounding would show."""
    rng = np.random.default_rng(1)
    ga = np.float32(0.0371)
    grid = (np.arange(-300, 300, 0.5, dtype=np.float32) * ga)
    x = np.concatenate([grid, rng.normal(0, 4, 4000).astype(np.float32)])
    xb = jnp.asarray(x, jnp.bfloat16)
    want = np.asarray(jops.quantize_activations(xb, jnp.asarray(ga),
                                                signed=signed))
    xt = torch.from_numpy(np.asarray(xb, np.float32)).to(torch.bfloat16)
    got = ops.quantize_activations(xt, torch.tensor(ga), signed=signed)
    assert got.dtype == torch.int8
    np.testing.assert_array_equal(got.numpy(), want)


def test_quantize_int_matches():
    rng = np.random.default_rng(2)
    w = rng.normal(0, 0.1, (64, 16)).astype(np.float32)
    gw = rng.uniform(0.01, 0.05, (1, 16)).astype(np.float32)
    spec = jquant.weight_spec(4)
    want = np.asarray(jquant.quantize_int(jnp.asarray(w), jnp.asarray(gw),
                                          spec))
    got = quant.quantize_int(torch.from_numpy(w), torch.from_numpy(gw),
                             quant.weight_spec(4))
    np.testing.assert_array_equal(got.numpy(), want)


@pytest.mark.parametrize("h,kh,stride,padding", [
    (224, 7, 2, "SAME"), (112, 3, 2, "SAME"), (56, 3, 1, "SAME"),
    (56, 1, 2, "SAME"), (9, 3, 2, "VALID"), (7, 3, 2, "SAME")])
def test_pad_spatial_matches_xla_pads(h, kh, stride, padding):
    """XLA's SAME padding puts the odd pixel on the high side."""
    rng = np.random.default_rng(h + kh)
    a = rng.integers(-128, 128, (1, h, h + 1, 2)).astype(np.int8)
    want = np.asarray(jref.pad_spatial(jnp.asarray(a), kh, kh, stride,
                                       padding, fill=-128))
    got = ref.pad_spatial(torch.from_numpy(a), kh, kh, stride, padding,
                          fill=-128)
    np.testing.assert_array_equal(got.numpy(), want)


@pytest.mark.parametrize("kh,stride", [(7, 2), (3, 1), (3, 2), (1, 2)])
def test_im2col_order_matches(kh, stride):
    """Patch features in (kh, kw, C) order, as the HWIO weights flatten."""
    rng = np.random.default_rng(kh * 3 + stride)
    x = rng.normal(0, 1, (2, 11, 10, 3)).astype(np.float32)
    want = np.asarray(jQ.im2col(jnp.asarray(x), kh, kh, stride, "SAME"))
    got = Q.im2col(torch.from_numpy(x), kh, kh, stride, "SAME")
    np.testing.assert_array_equal(got.numpy(), want)


class TestPlans:
    def test_golden_roundtrips_byte_identical(self):
        golden = FIXTURES / "golden_resnet18_v1.json"
        plan = PrecisionPlan.load(golden)
        assert plan.dumps() == golden.read_text()
        assert plan.layer("s1b1c2") == LayerPlan(
            w_bits=2, k=2, channel_wise=True, dataflow="implicit")
        assert plan.layer("s2b0c1") == plan.default
        assert validate_plan_json(golden).name == "golden_resnet18_v1"

    def test_shipped_mixed_plan_resolves(self):
        plan = validate_plan_json(ROOT / "examples/plans/resnet18_mixed.json")
        names = configs.get("resnet18").plan_layer_names()
        assert {plan.layer(n).w_bits for n in names} == {2, 4, 8}
        assert resolve_policy(plan, "s3b1c2") == PrecisionPolicy(
            inner_bits=2, k=2)
        assert resolve_policy(plan, "stem").bits_for("boundary") == 8
        assert resolve_dataflow(plan, "s0b0c1") == "auto"
        assert resolve_dataflow(plan, "s0b0c1", "im2col") == "im2col"

    @pytest.mark.parametrize("fixture,exc,msg", [
        ("bad_unknown_key.json", ValueError,
         r"unknown plan keys: \['frobnicate'\]"),
        ("bad_dup_layer.json", ValueError,
         r"duplicate keys in plan JSON: \['s0b0c1'\]"),
        ("bad_wrong_arch.json", ValueError, "absent from the model workload"),
        ("bad_unknown_arch.json", KeyError, "resnet999"),
    ])
    def test_bad_fixtures_rejected(self, fixture, exc, msg):
        with pytest.raises(exc, match=msg):
            validate_plan_json(FIXTURES / fixture)

    def test_constructor_rejects_duplicate_layers(self):
        with pytest.raises(ValueError, match="duplicate plan layers"):
            PrecisionPlan(layers=(("q", LayerPlan()), ("q", LayerPlan())))


class TestPortHygiene:
    def test_imports_neither_jax_nor_repro(self):
        """A fresh interpreter that imports every port module loads no JAX
        and nothing of the JAX package."""
        mods = sorted(
            "repro_torch." + ".".join(p.relative_to(ROOT / "src" / "repro_torch")
                                      .with_suffix("").parts)
            for p in (ROOT / "src" / "repro_torch").rglob("*.py")
            if p.name != "__init__.py")
        code = ("import sys\n" + "".join(f"import {m}\n" for m in mods)
                + "bad = [m for m in sys.modules if m in ('jax', 'repro') or "
                  "m.startswith(('jax.', 'jaxlib', 'repro.'))]\n"
                  "print(len(sys.modules)); assert not bad, bad\n")
        env = dict(os.environ, PYTHONPATH=str(ROOT / "src"))
        r = subprocess.run([sys.executable, "-c", code], env=env,
                           capture_output=True, text=True, timeout=120)
        assert r.returncode == 0, r.stderr

    def test_sources_name_no_jax_import(self):
        pat = re.compile(r"^\s*(import jax|from jax|import repro\.|"
                         r"from repro[ .])", re.M)
        files = [*(ROOT / "src" / "repro_torch").rglob("*.py"),
                 *(ROOT / "tools").glob("*.py"), ROOT / "chip_smoke.py"]
        hits = [str(f) for f in files if pat.search(f.read_text())]
        assert not hits, hits

    def test_cuda_without_card_raises(self, monkeypatch):
        """Entry points default to CUDA and never fall back to the CPU."""
        from repro_torch.runtime.serve import ImageServer
        monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
        with pytest.raises(RuntimeError, match="no CUDA device"):
            ImageServer(api=configs.get("resnet18", reduced=True), params={})
        a = torch.zeros((4, 8), dtype=torch.int8)
        fmt = packing.PlaneFormat(w_bits=4, k=4, k_dim=8)
        planes = packing.pack_planes(torch.zeros((8, 3), dtype=torch.int32),
                                     fmt)
        g = torch.ones((1, 3))
        cs = torch.zeros((1, 3), dtype=torch.int32)
        with pytest.raises(ValueError, match="needs CUDA tensors"):
            ops.mpmm(a, planes, g, cs, fmt=fmt, impl="cuda")
