"""The port's mixed-precision matmul and implicit-GEMM conv against the JAX
package: ``mpmm_torch`` / ``conv_mpmm_torch`` (the kernels' plain
versions, which ``ops`` runs for CPU tensors) against ``ops.mpmm`` /
``ops.conv_mpmm`` with ``impl="xla"`` and the ``ref`` oracles.

Contract (``repro_torch/kernels/mpmm/epilogue.py``): int32 accumulators and
the f32 epilogue bitwise, hence bf16 outputs bitwise.  The CUDA kernels
are held against these plain versions on the card by ``test_torch_cuda.py``
and ``chip_smoke.py``.
"""
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402
import numpy as np  # noqa: E402

from repro.core import packing as jpacking  # noqa: E402
from repro.kernels.mpmm import ops as jops  # noqa: E402
from repro.kernels.mpmm import ref as jref  # noqa: E402
from repro.kernels.mpmm.epilogue import EpilogueSpec as JSpec  # noqa: E402
from repro_torch.core import packing  # noqa: E402
from repro_torch.kernels.mpmm import conv_kernel, kernel, ops, ref  # noqa: E402
from repro_torch.kernels.mpmm.epilogue import EpilogueSpec  # noqa: E402

# (name, bn, residual, relu): none; bn+relu; bn+residual+relu.
EPILOGUES = [("none", False, False, False), ("bn_relu", True, False, True),
             ("bn_res_relu", True, True, True)]


def _t(a):
    """numpy or JAX array -> torch tensor, bit for bit (bf16 via f32)."""
    a = np.array(a)  # a writable copy
    if a.dtype.name == "bfloat16":
        return torch.from_numpy(a.astype(np.float32)).to(torch.bfloat16)
    return torch.from_numpy(a)


def _np(t):
    return (t.to(torch.float32) if t.dtype == torch.bfloat16 else t).numpy()


def _jnp_f32(a):
    return np.asarray(jnp.asarray(a).astype(jnp.float32))


# One compile per shape and format instead of one per eager JAX op.
_jax_pack = jax.jit(jpacking.pack_planes, static_argnums=1)


def make_weights(rng, kdim, n, w_bits, k):
    w_int = rng.integers(-(2 ** (w_bits - 1)), 2 ** (w_bits - 1),
                         (kdim, n)).astype(np.int32)
    jfmt = jpacking.PlaneFormat(w_bits=w_bits, k=k, k_dim=kdim)
    planes = np.asarray(_jax_pack(jnp.asarray(w_int), jfmt))
    gamma = rng.uniform(1e-3, 1e-2, (1, n)).astype(np.float32)
    colsum = w_int.sum(0, dtype=np.int32).reshape(1, n)
    return planes, gamma, colsum, jfmt, packing.PlaneFormat(w_bits, k, kdim)


def make_epilogue(rng, name, bn, res, relu, res_shape, out_dtype):
    jspec = tspec = None
    ops_j, ops_t = {}, {}
    if name != "none":
        jspec = JSpec(bn=bn, residual=res, relu=relu)
        tspec = EpilogueSpec(bn=bn, residual=res, relu=relu)
    n = res_shape[-1]
    if bn:
        s = rng.uniform(0.5, 1.5, (1, n)).astype(np.float32)
        t = rng.normal(0, 0.3, (1, n)).astype(np.float32)
        ops_j.update(scale=jnp.asarray(s), shift=jnp.asarray(t))
        ops_t.update(scale=_t(s), shift=_t(t))
    if res:
        r = jnp.asarray(rng.normal(0, 1, res_shape).astype(np.float32),
                        out_dtype)
        ops_j["residual"] = r
        ops_t["residual"] = _t(r)
    return jspec, tspec, ops_j, ops_t


@pytest.mark.parametrize("epi", EPILOGUES, ids=[e[0] for e in EPILOGUES])
@pytest.mark.parametrize("w_bits,k,m,kdim,n", [
    (8, 4, 37, 147, 19),    # stem-like: K=147 ragged, P=2
    (2, 2, 9, 64, 70),      # one plane, N past one tile
    (8, 1, 5, 33, 7),       # eight planes, K ragged for f=8
])
def test_mpmm_torch_matches_jax(w_bits, k, m, kdim, n, epi):
    """Both variants (st, sa) against one JAX reference (the JAX xla path
    has no variant); f32 output, where an epilogue ulp would show, and bf16
    output on the stem-like shape."""
    rng = np.random.default_rng(m * 7 + n + k)
    planes, gamma, colsum, jfmt, fmt = make_weights(rng, kdim, n, w_bits, k)
    a = rng.integers(-128, 128, (m, kdim)).astype(np.int8)
    dtypes = [(torch.float32, jnp.float32)]
    if kdim == 147:
        dtypes.append((torch.bfloat16, jnp.bfloat16))
    for out_dtype, jdt in dtypes:
        jspec, tspec, ops_j, ops_t = make_epilogue(rng, *epi, (m, n), jdt)
        want = jops.mpmm(jnp.asarray(a), jnp.asarray(planes),
                         jnp.asarray(gamma), jnp.asarray(colsum), fmt=jfmt,
                         impl="xla", out_dtype=jdt, epilogue=jspec, **ops_j)
        oracle = jref.mpmm_ref(jnp.asarray(a), jnp.asarray(planes), jfmt,
                               jnp.asarray(gamma), act_zero=128,
                               out_dtype=jdt, epilogue=jspec, **ops_j)
        np.testing.assert_array_equal(_jnp_f32(oracle), _jnp_f32(want))
        for variant in ("st", "sa"):
            got = kernel.mpmm_torch(_t(a), _t(planes), _t(gamma), _t(colsum),
                                    fmt=fmt, act_zero=128, variant=variant,
                                    out_dtype=out_dtype, epilogue=tspec,
                                    **ops_t)
            assert got.dtype == out_dtype and tuple(got.shape) == (m, n)
            np.testing.assert_array_equal(_np(got), _jnp_f32(want))
            via_ops = ops.mpmm(_t(a), _t(planes), _t(gamma), _t(colsum),
                               fmt=fmt, variant=variant, out_dtype=out_dtype,
                               epilogue=tspec, **ops_t)
            assert torch.equal(via_ops, got)


K_ABOVE_W = [(w, k) for w in (1, 2, 4, 8) for k in (1, 2, 4, 8) if k > w]


@pytest.mark.parametrize("w_bits,k", K_ABOVE_W)
def test_mpmm_torch_k_above_w(w_bits, k):
    """One plane whose k-bit fields hold the w-bit code.  At k < 8 both the
    JAX package's ``impl="xla"`` and its ``ref`` hold the port; at k = 8 its
    ``ref`` alone (ROADMAP R4: ``impl="xla"`` skips the sign extension)."""
    rng = np.random.default_rng(w_bits * 16 + k)
    m, kdim, n = 13, 147, 37
    planes, gamma, colsum, jfmt, fmt = make_weights(rng, kdim, n, w_bits, k)
    a = rng.integers(-128, 128, (m, kdim)).astype(np.int8)
    jspec, tspec, ops_j, ops_t = make_epilogue(rng, *EPILOGUES[2], (m, n),
                                               jnp.bfloat16)
    args_j = (jnp.asarray(a), jnp.asarray(planes))
    oracle = jref.mpmm_ref(*args_j, jfmt, jnp.asarray(gamma), act_zero=128,
                           out_dtype=jnp.bfloat16, epilogue=jspec, **ops_j)
    wants = [oracle]
    if k < 8:
        wants.append(jops.mpmm(*args_j, jnp.asarray(gamma),
                               jnp.asarray(colsum), fmt=jfmt, impl="xla",
                               out_dtype=jnp.bfloat16, epilogue=jspec,
                               **ops_j))
    for variant in ("st", "sa"):
        got = kernel.mpmm_torch(_t(a), _t(planes), _t(gamma), _t(colsum),
                                fmt=fmt, act_zero=128, variant=variant,
                                out_dtype=torch.bfloat16, epilogue=tspec,
                                **ops_t)
        for want in wants:
            np.testing.assert_array_equal(_np(got), _jnp_f32(want))
    acc = ref.mpmm_ref_codes(_t(a), _t(planes), fmt, act_zero=128)
    want_acc = jref.mpmm_ref_codes(*args_j, jfmt, act_zero=128)
    np.testing.assert_array_equal(acc.numpy(), np.asarray(want_acc))


@pytest.mark.parametrize("w_bits", [2, 4])
def test_jax_xla_mpmm_is_wrong_at_k8_below_w8(w_bits):
    """ROADMAP R4: at k = 8 with w < 8 the JAX package's ``impl="xla"``
    returns the packed byte as the weight, unextended, so its product is
    not the integer product; ``ref.mpmm_ref`` of both packages and the
    port's ``mpmm_torch`` are."""
    rng = np.random.default_rng(w_bits)
    m, kdim, n = 5, 64, 24
    planes, gamma, colsum, jfmt, fmt = make_weights(rng, kdim, n, w_bits, 8)
    a = rng.integers(-128, 128, (m, kdim)).astype(np.int8)
    args_j = (jnp.asarray(a), jnp.asarray(planes))
    ones = np.ones((1, n), np.float32)
    oracle = jref.mpmm_ref(*args_j, jfmt, jnp.asarray(ones), act_zero=128)
    xla = jops.mpmm(*args_j, jnp.asarray(ones), jnp.asarray(colsum),
                    fmt=jfmt, impl="xla")
    got = kernel.mpmm_torch(_t(a), _t(planes), _t(ones), _t(colsum), fmt=fmt,
                            act_zero=128)
    port_oracle = ref.mpmm_ref(_t(a), _t(planes), fmt, _t(ones),
                               act_zero=128)
    w_int = ref.unpack_to_int(_t(planes), fmt).numpy().astype(np.int64)
    exact = (a.astype(np.int64) + 128) @ w_int
    np.testing.assert_array_equal(got.numpy(), exact.astype(np.float32))
    np.testing.assert_array_equal(port_oracle.numpy(), got.numpy())
    np.testing.assert_array_equal(np.asarray(oracle), got.numpy())
    assert not np.array_equal(np.asarray(xla), got.numpy())


def test_conv_mpmm_torch_k_above_w():
    """The implicit-GEMM conv at a k > w format (w2k4) against the JAX
    package's ``impl="xla"`` conv and its ``ref.conv_ref``."""
    rng = np.random.default_rng(24)
    b, h, c, n, kh = 2, 9, 8, 24, 3
    planes, gamma, colsum, jfmt, fmt = make_weights(rng, kh * kh * c, n, 2, 4)
    a = rng.integers(-128, 128, (b, h, h, c)).astype(np.int8)
    ho = -(-h // 2)
    jspec, tspec, ops_j, ops_t = make_epilogue(rng, *EPILOGUES[2],
                                               (b, ho, ho, n), jnp.bfloat16)
    kw = dict(kh=kh, kw=kh, stride=2, padding="SAME")
    args_j = (jnp.asarray(a), jnp.asarray(planes))
    want = jops.conv_mpmm(*args_j, jnp.asarray(gamma), jnp.asarray(colsum),
                          fmt=jfmt, impl="xla", out_dtype=jnp.bfloat16,
                          epilogue=jspec, **kw, **ops_j)
    oracle = jref.conv_ref(*args_j, jfmt, jnp.asarray(gamma), act_zero=128,
                           out_dtype=jnp.bfloat16, epilogue=jspec, **kw,
                           **ops_j)
    for variant in ("st", "sa"):
        got = conv_kernel.conv_mpmm_torch(
            _t(a), _t(planes), _t(gamma), _t(colsum), fmt=fmt, act_zero=128,
            variant=variant, out_dtype=torch.bfloat16, epilogue=tspec, **kw,
            **ops_t)
        np.testing.assert_array_equal(_np(got), _jnp_f32(want))
        np.testing.assert_array_equal(_np(got), _jnp_f32(oracle))


def test_accumulators_bitwise():
    rng = np.random.default_rng(5)
    planes, _, _, jfmt, fmt = make_weights(rng, 300, 40, 4, 2)
    a = rng.integers(-128, 128, (23, 300)).astype(np.int8)
    want = np.asarray(jref.mpmm_ref_codes(jnp.asarray(a), jnp.asarray(planes),
                                          jfmt, act_zero=128))
    got = ref.mpmm_ref_codes(_t(a), _t(planes), fmt, act_zero=128)
    assert got.dtype == torch.int32
    np.testing.assert_array_equal(got.numpy(), want)


# Every geometry with the full epilogue; all three epilogues on 3x3/2 (the
# epilogue code is the matmul's, covered above for every shape).
CONV_CASES = [(kh, s, pad, EPILOGUES[2]) for kh, s, pad in (
    (3, 1, "SAME"), (3, 2, "SAME"), (1, 2, "SAME"), (7, 2, "SAME"),
    (3, 2, "VALID"))] + [(3, 2, "SAME", e) for e in EPILOGUES[:2]]


@pytest.mark.parametrize("kh,stride,padding,epi", CONV_CASES,
                         ids=[f"{k}x{k}s{s}{p}-{e[0]}"
                              for k, s, p, e in CONV_CASES])
def test_conv_mpmm_torch_matches_jax(kh, stride, padding, epi):
    rng = np.random.default_rng(kh * 5 + stride)
    b, h, w, c, n = 2, 9, 8, 8, 24
    planes, gamma, colsum, jfmt, fmt = make_weights(rng, kh * kh * c, n, 4, 2)
    a = rng.integers(-128, 128, (b, h, w, c)).astype(np.int8)
    ho, wo = jref.conv_patches_codes(jnp.asarray(a), kh, kh, stride, padding,
                                     fill=-128).shape[1:3]
    jspec, tspec, ops_j, ops_t = make_epilogue(rng, *epi, (b, ho, wo, n),
                                               jnp.bfloat16)
    kw = dict(kh=kh, kw=kh, stride=stride, padding=padding)
    want = jops.conv_mpmm(jnp.asarray(a), jnp.asarray(planes),
                          jnp.asarray(gamma), jnp.asarray(colsum), fmt=jfmt,
                          impl="xla", out_dtype=jnp.bfloat16, epilogue=jspec,
                          **kw, **ops_j)
    oracle = jref.conv_ref(jnp.asarray(a), jnp.asarray(planes), jfmt,
                           jnp.asarray(gamma), act_zero=128,
                           out_dtype=jnp.bfloat16, epilogue=jspec, **kw,
                           **ops_j)
    got = conv_kernel.conv_mpmm_torch(
        _t(a), _t(planes), _t(gamma), _t(colsum), fmt=fmt, act_zero=128,
        out_dtype=torch.bfloat16, epilogue=tspec, **kw, **ops_t)
    assert tuple(got.shape) == (b, ho, wo, n)
    np.testing.assert_array_equal(_np(got), _jnp_f32(want))
    np.testing.assert_array_equal(_np(got), _jnp_f32(oracle))
    port_oracle = ref.conv_ref(_t(a), _t(planes), fmt, _t(gamma),
                               act_zero=128, out_dtype=torch.bfloat16,
                               epilogue=tspec, **kw, **ops_t)
    assert torch.equal(port_oracle, got)


def test_conv_signed_codes_pad_with_zero():
    """act_zero = 0 (the stem's signed codes): padding fills code 0."""
    rng = np.random.default_rng(11)
    planes, gamma, colsum, jfmt, fmt = make_weights(rng, 9 * 8, 16, 8, 4)
    a = rng.integers(-128, 128, (1, 7, 7, 8)).astype(np.int8)
    want = jref.conv_ref(jnp.asarray(a), jnp.asarray(planes), jfmt,
                         jnp.asarray(gamma), act_zero=0, kh=3, kw=3,
                         stride=2)
    got = ops.conv_mpmm(_t(a), _t(planes), _t(gamma), _t(colsum), fmt=fmt,
                        act_zero=0, kh=3, kw=3, stride=2)
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))


def test_fixed_tile_is_enforced():
    rng = np.random.default_rng(3)
    planes, gamma, colsum, _, fmt = make_weights(rng, 16, 8, 4, 4)
    a = _t(rng.integers(-128, 128, (4, 16)).astype(np.int8))
    args = (a, _t(planes), _t(gamma), _t(colsum))
    ops.mpmm(*args, fmt=fmt, tile=ops.TileShape())
    with pytest.raises(ValueError, match="fixed tile"):
        ops.mpmm(*args, fmt=fmt, tile=ops.TileShape(bm=kernel.TILE[0] * 2))
    with pytest.raises(ValueError, match="fixed N tile"):
        ops.conv_mpmm(a.reshape(1, 2, 2, 16), _t(planes), _t(gamma),
                      _t(colsum), fmt=fmt, kh=1, kw=1, bn=128)


# --- which library holds which format (kernels/_build.py) -------------------

from repro_torch.kernels import _build  # noqa: E402


@pytest.mark.parametrize("base", ["mpmm_wgmma", "conv_mpmm"])
@pytest.mark.parametrize("w_bits", [1, 2, 4, 8])
def test_format_lib_builds_the_word_length(base, w_bits):
    """The library ``format_lib`` names for a format is built with that
    word length switched on, and every other library of the source with
    it off: the split is written once, in ``FORMAT_PARTS``."""
    lib = _build.format_lib(base, w_bits)
    assert _build.KERNEL_SOURCES[lib].name == f"{base}.cu"
    for name, defines in _build.KERNEL_DEFINES.items():
        if name.startswith(base):
            on = f"-DK1_BUILD_W{w_bits}=1" in defines
            assert on == (name == lib), (name, defines)


def test_every_build_of_the_format_list_names_its_word_lengths():
    """A source that includes ``mpmm_bits.cuh`` stops at an ``#error``
    unless its build defines K1_BUILD_W1/2/4/8."""
    for name, src in _build.KERNEL_SOURCES.items():
        if '#include "mpmm_bits.cuh"' in src.read_text():
            flags = {d.split("=")[0] for d in _build.KERNEL_DEFINES[name]}
            assert flags == {f"-DK1_BUILD_W{w}" for w in (1, 2, 4, 8)}, name
