"""The port's floating-point baseline (``quantize=False``) against the JAX
package's: bf16 weights, a plain bf16 product, the f32 epilogue; convs
always through im2col.

* ``pack_qlinear`` keeps ``w`` as bf16, bitwise the reference's cast, and
  the bias as it was.
* A small ResNet (width 16, 32x32, ten classes): the port's
  ``serve_forward`` against ``repro``'s (``impl="xla"``, jitted, as its
  ``ImageServer`` serves it) within 2% of the largest |logit|: the bf16
  products accumulate in another order on each side and every layer
  rounds to bf16, so the nets are held by tolerance.
* The reduced granite-8b: prefill and teacher-forced decode logits against
  ``repro``'s Generator run op by op (``jax.disable_jit``, as
  ``test_torch_lm_serve.py`` holds the quantized path), within 2% of the
  largest |logit|, and the greedy tokens equal.
"""
import dataclasses
from pathlib import Path

import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402
import numpy as np  # noqa: E402

from repro import configs as jconfigs  # noqa: E402
from repro.core.precision import PrecisionPolicy as JPolicy  # noqa: E402
from repro.models import resnet as JR  # noqa: E402
from repro.nn import param as jparam  # noqa: E402
from repro.nn import quantized as JQ  # noqa: E402
from repro.runtime import serve as jserve  # noqa: E402
from repro_torch import configs, convert  # noqa: E402
from repro_torch.core.precision import PrecisionPolicy  # noqa: E402
from repro_torch.models import resnet as R  # noqa: E402
from repro_torch.models.api import ModelAPI  # noqa: E402
from repro_torch.nn import quantized as Q  # noqa: E402
from repro_torch.runtime.serve import (Generator, ImageServer,  # noqa: E402
                                       pack_for_serving)

EX = Path(__file__).resolve().parents[1] / "examples"

LOGIT_RTOL = 2e-2
FP, JFP = PrecisionPolicy(quantize=False), JPolicy(quantize=False)


def _np_tree(tree):
    return jax.tree.map(lambda a: np.array(a), tree)


def _f32(x):
    if isinstance(x, torch.Tensor):
        return x.to(torch.float32).numpy()
    return np.asarray(jnp.asarray(x).astype(jnp.float32))


def _close(mine, ref, rtol=LOGIT_RTOL):
    a, b = _f32(mine), _f32(ref)
    assert a.shape == b.shape and np.isfinite(a).all()
    err = float(np.abs(a - b).max())
    assert err <= rtol * float(np.abs(b).max()), err


def test_pack_qlinear_keeps_bf16_weights():
    rng = np.random.default_rng(0)
    w = rng.normal(0, 1, (48, 24)).astype(np.float32)
    b = rng.normal(0, 1, (24,)).astype(np.float32)
    p = {"w": w, "gw": np.float32(0.05), "ga": np.float32(0.05), "b": b}
    mine = Q.pack_qlinear({k: torch.as_tensor(v) for k, v in p.items()}, FP)
    ref = JQ.pack_qlinear({k: jnp.asarray(v) for k, v in p.items()}, JFP)
    assert mine.keys() == ref.keys() == {"w", "b"}
    assert mine["w"].dtype == torch.bfloat16
    np.testing.assert_array_equal(_f32(mine["w"]), _f32(ref["w"]))
    np.testing.assert_array_equal(mine["b"].numpy(), np.asarray(ref["b"]))


@pytest.mark.parametrize("epi", ["none", "bn_relu", "bn_res_relu"])
def test_qlinear_fp_apply_matches_reference(epi):
    rng = np.random.default_rng(1)
    x = rng.normal(0, 1, (7, 40)).astype(np.float32)
    w = rng.normal(0, 0.2, (40, 16)).astype(np.float32)
    kw, jkw = {}, {}
    if epi != "none":
        ops = {"scale": rng.uniform(0.5, 1.5, (1, 16)).astype(np.float32),
               "shift": rng.normal(0, 0.3, (1, 16)).astype(np.float32)}
        if epi == "bn_res_relu":
            ops["residual"] = rng.normal(0, 1, (7, 16)).astype(np.float32)
        spec = Q.EpilogueSpec(bn=True, relu=True,
                              residual=epi == "bn_res_relu")
        jspec = JQ.EpilogueSpec(bn=True, relu=True,
                                residual=epi == "bn_res_relu")
        kw = {k: torch.from_numpy(v) for k, v in ops.items()}
        kw["epilogue"] = spec
        jkw = {k: jnp.asarray(v) for k, v in ops.items()}
        jkw["epilogue"] = jspec
    mine = Q.qlinear_serve_apply({"w": torch.from_numpy(w).to(
        torch.bfloat16)}, torch.from_numpy(x), FP, **kw)
    ref = jax.jit(lambda xx: JQ.qlinear_serve_apply(
        {"w": jnp.asarray(w, jnp.bfloat16)}, xx, JFP, **jkw))(jnp.asarray(x))
    assert mine.dtype == torch.bfloat16
    # One bf16 product of K = 40 terms: equal but for the odd bf16 ulp.
    np.testing.assert_allclose(_f32(mine), _f32(ref), rtol=1e-2, atol=1e-2)


def _tiny(block):
    depth = 18 if block == "basic" else 50
    return dict(name=f"tiny-{block}", depth=depth, n_classes=10,
                img_size=32, width=16, stages_override=(1, 1))


@pytest.mark.parametrize("block", ["basic", "bottleneck"])
def test_resnet_fp_baseline_matches_reference(block):
    kw = _tiny(block)
    jcfg, cfg = JR.ResNetConfig(**kw), R.ResNetConfig(**kw)
    jparams = jparam.init_params(JR.specs(jcfg, policy=JFP),
                                 jax.random.PRNGKey(5))
    rng = np.random.default_rng(5)
    jstate = jax.tree.map(
        lambda v: jnp.asarray(rng.uniform(0.5, 1.5, v.shape), jnp.float32),
        JR.init_bn_state(JR.specs(jcfg)))
    params, state = convert.from_jax_train_params(
        _np_tree(jparams), _np_tree(jstate), device="cpu")
    jpacked = JR.pack_for_serve(jcfg, jparams, jstate, JFP)
    packed = R.pack_for_serve(cfg, params, state, FP)
    np.testing.assert_array_equal(_f32(packed["stem"]["w"]),
                                  _f32(jpacked["stem"]["w"]))
    x = rng.normal(0, 1, (3, 32, 32, 3)).astype(np.float32)
    ref = jax.jit(lambda p, xx: JR.serve_forward(
        jcfg, p, xx, JFP, impl="xla"))(jpacked, jnp.asarray(x))
    api = ModelAPI(name="tiny", family="cnn", cfg=cfg, mod=R, policy=FP)
    server = ImageServer(api=api, params=packed, batch_buckets=(4,),
                         device="cpu")
    got = server.predict(x)
    _close(got, ref)
    assert np.argmax(got, -1).tolist() == np.argmax(_f32(ref), -1).tolist()
    # every conv of the fp baseline runs through im2col, whatever was asked
    for d in ("auto", "implicit"):
        assert torch.equal(R.serve_forward(cfg, packed, torch.from_numpy(x),
                                           FP, dataflow=d),
                           R.serve_forward(cfg, packed, torch.from_numpy(x),
                                           FP, dataflow="im2col"))


def test_resnet_fp_footprint_is_the_reference_baseline():
    """The fp baseline counts 32 bits a weight (the paper's 4.9x is
    against it); under the shipped mixed plan the packed planes hold less
    than a quarter of the fp baseline's bytes."""
    from repro_torch.core.plan import PrecisionPlan, plan_footprint_report
    cfg = configs.get("resnet18").cfg
    lp, cls = R.layer_param_counts(cfg), R.layer_classes(cfg)
    fp = plan_footprint_report(lp, cls, FP)
    mixed = plan_footprint_report(lp, cls, PrecisionPlan.load(
        EX / "plans" / "resnet18_mixed.json"))
    assert fp["compression"] == 1.0
    assert mixed["fp32_bytes"] == fp["quant_bytes"]
    assert mixed["compression"] > 4.0


BATCH, PROMPT, NEW = 2, 9, 4


def _keys(tree):
    if isinstance(tree, dict):
        return set(tree) | {k for v in tree.values() for k in _keys(v)}
    if isinstance(tree, (list, tuple)):
        return {k for v in tree for k in _keys(v)}
    return set()


def test_granite_fp_baseline_matches_reference():
    japi = dataclasses.replace(jconfigs.get("granite-8b", reduced=True),
                               policy=JFP)
    tapi = configs.get("granite-8b", reduced=True, policy=FP)
    jtrain = japi.init_params(jax.random.PRNGKey(7), "train")
    jpacked = jserve.pack_for_serving(japi, jtrain)
    train = convert.from_jax_lm_train_params(_np_tree(jtrain), device="cpu")
    packed = pack_for_serving(tapi, train)
    keys = _keys(packed)
    assert "w" in keys and "planes" not in keys and "codes" not in keys
    tokens = np.random.default_rng(7).integers(0, japi.cfg.vocab,
                                               (BATCH, PROMPT))
    gen = jserve.Generator(japi, jpacked)
    with jax.disable_jit():
        logits, cache = gen._prefill(jpacked, {"tokens": jnp.asarray(tokens)})
        cache = gen._grow_cache(cache, BATCH, PROMPT, PROMPT + NEW)
        jlogits, jtokens = [logits], [np.asarray(jnp.argmax(logits, -1))]
        for i in range(NEW - 1):
            logits, cache = gen._decode(jpacked, cache,
                                        jnp.asarray(jtokens[-1][:, None]),
                                        jnp.asarray(PROMPT + i, jnp.int32))
            jlogits.append(logits)
            jtokens.append(np.asarray(jnp.argmax(logits, -1)))
    jtokens = np.stack(jtokens, axis=1)
    tgen = Generator(api=tapi, params=packed, device="cpu")
    toks, logits = tgen.run(tokens, NEW, forced=jtokens)
    for mine, ref in zip(logits, jlogits):
        _close(mine, ref)
    np.testing.assert_array_equal(toks, jtokens)
