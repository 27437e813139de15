"""The port's packed ResNet serve path against the JAX package's.

Small configurations (width 16, 32x32 images, one block per stage, ten
classes), one with basic blocks under a small layer-wise plan and one with
bottleneck blocks under a uniform policy.  The JAX packed tree comes across
through ``convert.from_jax_serve_tree``.

Contract (``repro_torch/kernels/mpmm/epilogue.py``): each layer's bf16
output is bitwise equal when its input is; the port's own
``pack_for_serve`` matches on planes, colsum and gamma bitwise and on the
folded BN to rtol 1e-6; end to end, logits are held to a tolerance plus
the rate of flipped classifier-input codes, because the mean-pool's f32
sum order differs between the frameworks.
"""
import dataclasses

import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402
import numpy as np  # noqa: E402

from repro.core import plan as jplan  # noqa: E402
from repro.core.precision import PrecisionPolicy as JPolicy  # noqa: E402
from repro.kernels.mpmm import ops as jops  # noqa: E402
from repro.models import resnet as JR  # noqa: E402
from repro.nn import param as jparam  # noqa: E402
from repro.nn import quantized as JQ  # noqa: E402
from repro_torch import convert  # noqa: E402
from repro_torch.core import plan as tplan  # noqa: E402
from repro_torch.core.precision import PrecisionPolicy  # noqa: E402
from repro_torch.kernels.mpmm import ops  # noqa: E402
from repro_torch.models import resnet as R  # noqa: E402
from repro_torch.models.api import ModelAPI  # noqa: E402
from repro_torch.nn import quantized as Q  # noqa: E402
from repro_torch.runtime.serve import ImageServer  # noqa: E402

# End-to-end tolerance: at most 2% of the classifier-input codes may flip,
# and logits may move by at most 5% of their largest magnitude.
MAX_FLIP_RATE = 0.02
LOGIT_RTOL = 0.05

SMALL_PLAN = {
    "s0b0c1": {"w_bits": 2, "k": 2},
    "s0b0c2": {"w_bits": 8, "k": 4, "channel_wise": True},
    "s1b0c1": {"w_bits": 4, "k": 4, "dataflow": "im2col"},
    "s1b0p": {"w_bits": 1, "k": 1},
}


def _np_tree(tree):
    return jax.tree.map(lambda a: np.array(a), tree)


def _t(a):
    a = np.array(a)
    if a.dtype.name == "bfloat16":
        return torch.from_numpy(a.astype(np.float32)).to(torch.bfloat16)
    return torch.from_numpy(a)


def _f32(x):
    if isinstance(x, torch.Tensor):
        return x.to(torch.float32).numpy()
    return np.asarray(jnp.asarray(x).astype(jnp.float32))


def _randomize(tree, rng):
    """Non-trivial step sizes and BN affine, from numpy."""
    out = {}
    for k, v in tree.items():
        if isinstance(v, dict):
            out[k] = _randomize(v, rng)
        elif k in ("gw", "ga"):
            out[k] = jnp.asarray(rng.uniform(0.02, 0.06, v.shape), jnp.float32)
        elif k in ("scale", "bias") and v.ndim == 1:
            lo, hi = (0.5, 1.5) if k == "scale" else (-0.3, 0.3)
            out[k] = jnp.asarray(rng.uniform(lo, hi, v.shape), jnp.float32)
        else:
            out[k] = v
    return out


def _random_state(state, rng):
    return {k: (_random_state(v, rng) if "mean" not in v else
                {"mean": jnp.asarray(rng.normal(0, 0.2, v["mean"].shape),
                                     jnp.float32),
                 "var": jnp.asarray(rng.uniform(0.5, 2.0, v["var"].shape),
                                    jnp.float32)})
            for k, v in state.items()}


@dataclasses.dataclass
class Case:
    jcfg: object
    cfg: object
    jpol: object
    pol: object
    jparams: dict
    jstate: dict
    packed: dict
    images: np.ndarray
    stages: list        # JAX [(stage name, input, output)]
    jlogits: object     # JAX serve_forward(impl="xla")


def _build(block: str) -> Case:
    depth = 18 if block == "basic" else 50
    kw = dict(name=f"tiny-{block}", depth=depth, n_classes=10, img_size=32,
              width=16, stages_override=(1, 1))
    jcfg, cfg = JR.ResNetConfig(**kw), R.ResNetConfig(**kw)
    if block == "basic":
        jpol = jplan.PrecisionPlan.from_json(
            {"version": 1, "name": "small", "default": {"w_bits": 4, "k": 2},
             "layers": SMALL_PLAN})
        pol = tplan.PrecisionPlan.from_json(jpol.to_json())
    else:
        jpol = JPolicy(inner_bits=4, k=2, variant="sa")
        pol = PrecisionPolicy(inner_bits=4, k=2, variant="sa")
    rng = np.random.default_rng(depth)
    jparams = _randomize(jparam.init_params(JR.specs(jcfg, policy=jpol),
                                            jax.random.PRNGKey(depth)), rng)
    jstate = _random_state(JR.init_bn_state(JR.specs(jcfg)), rng)
    # Jitted: one compile instead of hundreds of eager dispatches.  Integer
    # outputs are unchanged; the folded BN may differ by XLA's contraction,
    # which the rtol 1e-6 contract on scale/shift covers.
    jpacked = jax.jit(lambda p, s: JR.pack_for_serve(jcfg, p, s, jpol))(
        jparams, jstate)
    packed = convert.from_jax_serve_tree(_np_tree(jpacked), device="cpu")
    images = rng.normal(0, 1, (3, 32, 32, 3)).astype(np.float32)
    # The JAX forward jitted whole, as its ImageServer serves it.
    names, fn = _jax_stages(jcfg, jpol)
    ios, jlogits = jax.jit(fn)(jpacked, jnp.asarray(images))
    stages = [(n, i, o) for n, (i, o) in zip(names, ios)]
    return Case(jcfg, cfg, jpol, pol, jparams, jstate, packed, images,
                stages, jlogits)


@pytest.fixture(scope="module", params=["basic", "bottleneck"])
def case(request):
    return _build(request.param)


def test_pack_for_serve_matches(case):
    params, state = convert.from_jax_train_params(
        _np_tree(case.jparams), _np_tree(case.jstate), device="cpu")
    mine = R.pack_for_serve(case.cfg, params, state, case.pol)
    theirs = case.packed
    assert mine.keys() == theirs.keys()

    def walk(a, b, path):
        if isinstance(a, dict):
            assert a.keys() == b.keys(), path
            for k in a:
                walk(a[k], b[k], f"{path}/{k}")
        elif isinstance(a, tuple):  # folded BN (scale, shift)
            for x, y in zip(a, b):
                np.testing.assert_allclose(x.numpy(), y.numpy(), rtol=1e-6,
                                           atol=1e-7, err_msg=path)
        else:
            assert a.dtype == b.dtype, path
            np.testing.assert_array_equal(a.numpy(), b.numpy(), err_msg=path)
    walk(mine, theirs, "")


def _jax_stages(jcfg, jpol):
    """Stage names and a function (packed, images) -> ([(input, output)]
    per stage, serve_forward logits): the JAX serve forward, stage by
    stage, beside the JAX package's own ``serve_forward``."""
    blocks = [(f"s{si}b{bi}", stride)
              for si, bi, _, _, stride in JR._block_channels(jcfg)]
    names = ["stem", "maxpool", *[k for k, _ in blocks], "mean", "fc"]
    fwd = JR._bottleneck_serve if jcfg.block == "bottleneck" \
        else JR._basic_serve

    def fn(jp, x):
        s, t = jp["bn_stem"]
        stem = JQ.qconv_serve_apply(
            jp["stem"], x, jpol, k=7, stride=2, layer_class="boundary",
            impl="xla", act_signed=True,
            epilogue=JQ.EpilogueSpec(bn=True, relu=True), scale=s, shift=t,
            name="stem")
        h = jax.lax.reduce_window(stem, -jnp.inf, jax.lax.max, (1, 3, 3, 1),
                                  (1, 2, 2, 1), "SAME")
        out = [(x, stem), (stem, h)]
        for key, stride in blocks:
            nh = fwd(jp[key], h, jpol, stride, "xla", None, "auto",
                     lname=key)
            out.append((h, nh))
            h = nh
        feats = jnp.mean(h, axis=(1, 2))
        out.append((h, feats))
        out.append((feats, JQ.qlinear_serve_apply(
            jp["fc"], feats, jpol, layer_class="boundary", impl="xla",
            name="fc")))
        return out, JR.serve_forward(jcfg, jp, x, jpol, impl="xla")
    return names, fn


def _port_stage(case, name, x):
    p = case.packed
    if name == "stem":
        s, t = p["bn_stem"]
        return Q.qconv_serve_apply(
            p["stem"], x, case.pol, k=7, stride=2, layer_class="boundary",
            act_signed=True, epilogue=Q.EpilogueSpec(bn=True, relu=True),
            scale=s, shift=t, name="stem")
    if name == "maxpool":
        return R.max_pool_same(x)
    if name == "mean":
        return x.to(torch.float32).mean(dim=(1, 2)).to(x.dtype)
    if name == "fc":
        return Q.qlinear_serve_apply(p["fc"], x, case.pol,
                                     layer_class="boundary", name="fc")
    stride = 2 if name[1] != "0" and name.endswith("b0") else 1
    fwd = R._bottleneck_serve if case.cfg.block == "bottleneck" \
        else R._basic_serve
    return fwd(p[name], x, case.pol, stride, "auto", None, "auto", name)


def test_layer_by_layer_bitwise(case):
    """Fed the JAX stage's own input, every port stage matches bitwise."""
    for name, jin, jout in case.stages:
        got = _port_stage(case, name, _t(jin))
        want = _f32(jout)
        assert got.shape == want.shape, name
        if name == "mean":  # f32 sum order differs: hold to one bf16 ulp
            np.testing.assert_allclose(_f32(got), want, rtol=2 ** -7,
                                       err_msg=name)
        else:
            np.testing.assert_array_equal(_f32(got), want, err_msg=name)


def test_end_to_end_within_contract(case):
    want = case.jlogits
    x = torch.from_numpy(case.images)
    got = R.serve_forward(case.cfg, case.packed, x, case.pol)
    assert got.dtype == torch.bfloat16 and got.shape == (3, 10)
    assert torch.isfinite(got.float()).all()
    # Flipped classifier-input codes between the two features.
    jfeat = [out for name, _, out in case.stages if name == "mean"][0]
    feat = R.serve_features(case.cfg, case.packed, x, case.pol)
    ga = case.packed["fc"]["ga"]
    codes_j = np.asarray(jops.quantize_activations(
        jfeat, jnp.asarray(ga.numpy())))
    codes_t = ops.quantize_activations(feat, ga).numpy()
    flip_rate = float(np.mean(codes_j != codes_t))
    assert flip_rate <= MAX_FLIP_RATE, flip_rate
    scale = float(np.abs(_f32(want)).max())
    np.testing.assert_allclose(_f32(got), _f32(want), rtol=0,
                               atol=LOGIT_RTOL * scale)


def test_dataflows_agree(case):
    """im2col (K1 route) and implicit (K2 route) are bitwise equal."""
    x = torch.from_numpy(case.images)
    a = R.serve_forward(case.cfg, case.packed, x, case.pol, dataflow="im2col")
    b = R.serve_forward(case.cfg, case.packed, x, case.pol,
                        dataflow="implicit")
    assert torch.equal(a, b)


def test_image_server_buckets(case):
    api = ModelAPI(name="tiny", family="cnn", cfg=case.cfg, mod=R,
                   policy=PrecisionPolicy())
    server = ImageServer(api=api, params=case.packed, batch_buckets=(4, 1, 2),
                         plan=case.pol, device="cpu")
    assert server.batch_buckets == (1, 2, 4)
    assert server.predict(case.images[:0]).shape == (0, 10)
    out = server.predict(case.images)                 # 3 requests -> bucket 4
    assert server.compiled_buckets == (4,)
    padded = np.concatenate([case.images, np.zeros_like(case.images[:1])])
    direct = R.serve_forward(case.cfg, case.packed, torch.from_numpy(padded),
                             case.pol)
    np.testing.assert_array_equal(out, direct[:3].float().numpy())
    five = np.concatenate([case.images, case.images[:2]])
    out5 = server.predict(five)                       # chunk 4, then 1
    assert server.compiled_buckets == (1, 4)
    np.testing.assert_array_equal(out5[:3], out)
