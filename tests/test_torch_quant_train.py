"""The port's QAT forward pieces against the JAX package's.

* ``fake_quant``: the forward bitwise (f32 and bf16 values, per-tensor and
  channel-wise steps, signed and unsigned, values exactly at Q_n, Q_p and
  0), the gradient in v bitwise (the clamp's 0.5 at a bound included), the
  gradient in gamma by a stated bound (below); ``grad_scale``'s forward
  value bitwise; ``round_ste``;
* ``qlinear_apply`` / ``qconv_apply`` forward bitwise;
* remat ('full', 'dots') changing no value or gradient of the dense
  family's ``forward(mode="train")`` (its logits are held to the JAX
  package in ``test_torch_dense_train.py`` and ``test_torch_train_step.py``);
* a quantized KV cache's gradient (``qdq_kv``; packed and qdq stores give
  the same);
* ``SyntheticLM`` / ``SyntheticImages`` batches bitwise.

The JAX side runs op by op (``jax.disable_jit``, or un-jitted calls): its
jitted run fuses differently (XLA turns a division by a broadcast step
into a multiply by its reciprocal, and the train forward's logits move by
2-4% of the largest one), and the port computes what the reference's
operations compute one at a time.

The gamma-gradient bound.  An activation's step gradient is a sum over
every element of bf16 terms that nearly cancel (LSQ's vbar - v/gamma).
JAX sums the bf16 terms in bf16, in XLA's order of blocks; the port sums
them in f32 and rounds once.  The test computes the exact sum of the
terms in float64 and holds the port within 2^-7 of the terms' absolute
sum of it and JAX within a quarter (its own jitted and op-by-op runs
differ by up to 0.18 of it on the reduced granite), f32 values within
1e-5 of it; a channel-wise step over bf16 values, whose column sums both
packages take in bf16, within a half.
"""
import dataclasses

import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402
import numpy as np  # noqa: E402

from repro.core import quant as JQ  # noqa: E402
from repro.data import pipeline as jdata  # noqa: E402
from repro.nn import kvcache as JKV  # noqa: E402
from repro.nn import quantized as JQL  # noqa: E402
from repro.core.precision import PrecisionPolicy as JPolicy  # noqa: E402
from repro_torch import configs  # noqa: E402
from repro_torch.core import quant as TQ  # noqa: E402
from repro_torch.core.precision import PrecisionPolicy  # noqa: E402
from repro_torch.data import pipeline as tdata  # noqa: E402
from repro_torch.nn import kvcache as TKV  # noqa: E402
from repro_torch.nn import quantized as TQL  # noqa: E402

SPECS = [(bits, signed, cw) for bits, signed in ((8, False), (4, True),
                                                 (2, True))
         for cw in (False, True)]


@pytest.fixture(autouse=True, scope="module")
def _one_thread():
    """Small tensors: torch's CPU thread pool costs more than it saves."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _f32(x):
    if isinstance(x, torch.Tensor):
        return x.detach().to(torch.float32).numpy()
    return np.asarray(jnp.asarray(x).astype(jnp.float32))


def _fq_inputs(bits, signed, cw, n=64, rows=48, seed=0):
    """Values, steps and a cotangent; rows 0-2 hold values exactly at Q_n,
    Q_p and 0 (in step units)."""
    rng = np.random.default_rng(seed)
    v = rng.normal(0, 1, (rows, n)).astype(np.float32)
    qn, qp = JQ.qrange(JQ.QuantSpec(bits, signed))
    gam = (rng.uniform(0.05, 0.1, (n,)).astype(np.float32) if cw
           else np.float32(0.0625))
    if cw:  # steps that make the rows below exactly Q_n and Q_p in bf16
        gam[:6] = 0.0625
    gb = np.broadcast_to(gam, v.shape)
    v[0, :6] = qn * gb[0, :6]
    v[1, :6] = qp * gb[1, :6]
    v[2, :6] = 0.0
    ct = rng.normal(0, 1, v.shape).astype(np.float32)
    return v, gam, ct


@pytest.mark.parametrize("dtype", ["f32", "bf16"])
@pytest.mark.parametrize("bits,signed,cw", SPECS)
def test_fake_quant_forward_and_gradients(dtype, bits, signed, cw):
    v, gam, ct = _fq_inputs(bits, signed, cw)
    jspec = JQ.QuantSpec(bits, signed, -1 if cw else None)
    tspec = TQ.QuantSpec(bits, signed, -1 if cw else None)
    jd, td = ((jnp.bfloat16, torch.bfloat16) if dtype == "bf16"
              else (jnp.float32, torch.float32))
    vj = jnp.asarray(v).astype(jd)

    def loss(a, g):
        return jnp.sum(JQ.fake_quant(a, g, jspec).astype(jnp.float32) * ct)

    with jax.disable_jit():
        out_j = JQ.fake_quant(vj, jnp.asarray(gam), jspec)
        gv_j, gg_j = jax.grad(loss, argnums=(0, 1))(vj, jnp.asarray(gam))
    vt = torch.tensor(_f32(vj)).to(td).requires_grad_(True)
    gt = torch.tensor(gam).requires_grad_(True)
    out_t = TQ.fake_quant(vt, gt, tspec)
    (out_t.to(torch.float32) * torch.tensor(ct)).sum().backward()

    assert out_t.dtype == td
    np.testing.assert_array_equal(_f32(out_t), _f32(out_j))
    np.testing.assert_array_equal(_f32(vt.grad), _f32(gv_j))
    # the clamp's gradient at a value equal to a bound is 0.5, as jnp.clip's
    at_bound = _f32(vt.grad)[:2, :6] / _f32(torch.tensor(ct[:2, :6]).to(td))
    np.testing.assert_array_equal(at_bound, 0.5 * np.ones_like(at_bound))

    # gamma: the exact float64 sum of the per-element terms
    # ct * (vbar - clip'(v/g) * v/g), clip' 1 inside, 0.5 at a bound, 0 out
    qn, qp = JQ.qrange(jspec)
    g = np.broadcast_to(_f32(jnp.asarray(gam).astype(jd)), v.shape)
    vs = _f32(vj.astype(jnp.float32) / jnp.asarray(g)) if dtype == "f32" \
        else _f32((vj / jnp.asarray(g).astype(jd)))
    clip_d = np.where((vs > qn) & (vs < qp), 1.0,
                      np.where((vs == qn) | (vs == qp), 0.5, 0.0))
    vbar = np.round(np.clip(vs, qn, qp))
    terms = ct.astype(np.float64) * (vbar - clip_d * vs.astype(np.float64))
    n = v.shape[0] if cw else v.size
    gscale = float(1.0 / np.sqrt(np.float32(float(n) * float(qp))))
    axis = 0 if cw else None
    exact = terms.sum(axis=axis) * gscale
    mass = np.abs(terms).sum(axis=axis) * gscale
    got_t, got_j = _f32(gt.grad).astype(np.float64), _f32(gg_j).astype(
        np.float64)
    if dtype == "f32":
        assert np.all(np.abs(got_t - exact) <= 1e-5 * mass + 1e-12)
        assert np.all(np.abs(got_j - exact) <= 1e-5 * mass + 1e-12)
    else:
        # channel-wise bf16 (a combination the models never use: their
        # channel-wise steps are weights', which quantize in f32) sums
        # each column in bf16 in both packages
        bound_t, bound_j = (0.5, 0.5) if cw else (2 ** -7, 0.25)
        assert np.all(np.abs(got_t - exact) <= bound_t * mass)
        assert np.all(np.abs(got_j - exact) <= bound_j * mass)


def test_grad_scale_forward_value_and_scale():
    rng = np.random.default_rng(3)
    x = rng.uniform(1e-3, 2.0, (257,)).astype(np.float32)
    s = jnp.float32(1.0) / jnp.sqrt(jnp.float32(4096.0 * 7.0))
    with jax.disable_jit():
        want = np.asarray(JQ.grad_scale(jnp.asarray(x), s))
    xt = torch.tensor(x, requires_grad=True)
    st = 1.0 / torch.sqrt(torch.tensor(4096.0 * 7.0))
    got = TQ.grad_scale(xt, st)
    np.testing.assert_array_equal(got.detach().numpy(), want)
    got.sum().backward()
    np.testing.assert_array_equal(xt.grad.numpy(),
                                  np.full_like(x, float(st)))


def test_round_ste_half_even_and_identity_gradient():
    x = torch.tensor([-2.5, -1.5, -0.5, 0.5, 1.5, 2.5, 0.4999, 3.7],
                     requires_grad=True)
    y = TQ.round_ste(x)
    np.testing.assert_array_equal(
        y.detach().numpy(), np.asarray(jnp.round(jnp.asarray(
            x.detach().numpy()))))
    (y * torch.arange(8.0)).sum().backward()
    np.testing.assert_array_equal(x.grad.numpy(), np.arange(8.0))


@pytest.mark.parametrize("cw", [False, True])
def test_qlinear_and_qconv_apply_bitwise(cw):
    rng = np.random.default_rng(5)
    pol_j = JPolicy(inner_bits=4, k=4, channel_wise=cw)
    pol_t = PrecisionPolicy(inner_bits=4, k=4, channel_wise=cw)
    w = rng.normal(0, 0.2, (3 * 3 * 8, 16)).astype(np.float32)
    gw = (rng.uniform(0.02, 0.06, (16,)) if cw else np.float32(0.04)
          ).astype(np.float32)
    p = {"w": w, "gw": gw, "ga": np.float32(0.05)}
    x = rng.uniform(0, 8, (2, 6, 6, 8)).astype(np.float32)
    lin = rng.uniform(0, 0.6, (2, 36, 72)).astype(np.float32)
    xj = jnp.asarray(x).astype(jnp.bfloat16)
    lj = jnp.asarray(lin).astype(jnp.bfloat16)
    pj = jax.tree.map(jnp.asarray, p)
    with jax.disable_jit():
        yl = JQL.qlinear_apply(pj, lj, pol_j)
        yc = JQL.qconv_apply(pj, xj, pol_j, k=3, stride=2)
    pt = {k: torch.tensor(np.asarray(v)) for k, v in p.items()}
    to_t = lambda a: torch.tensor(_f32(a)).to(torch.bfloat16)  # noqa: E731
    np.testing.assert_array_equal(
        _f32(TQL.qlinear_apply(pt, to_t(lj), pol_t)), _f32(yl))
    np.testing.assert_array_equal(
        _f32(TQL.qconv_apply(pt, to_t(xj), pol_t, k=3, stride=2)), _f32(yc))


@pytest.mark.parametrize("policy", ["full", "dots"])
def test_remat_changes_no_value(policy):
    """Forward logits and every gradient leaf equal with remat on and off."""
    api = configs.get("granite-8b", reduced=True)
    toks = np.random.default_rng(0).integers(0, api.cfg.vocab, (2, 16))
    results = []
    for remat in (True, False):
        a = dataclasses.replace(api, cfg=dataclasses.replace(
            api.cfg, remat=remat, remat_policy=policy))
        tp = a.init_params(torch.Generator().manual_seed(1), device="cpu")
        live = {k: v for k, v in _leaves(tp)}
        for v in live.values():
            v.requires_grad_(True)
        logits = a.forward(tp, torch.as_tensor(toks).long(), mode="train")
        logits.float().square().mean().backward()
        results.append((logits.detach(), {k: v.grad for k, v in
                                          live.items()}))
    (l1, g1), (l2, g2) = results
    assert torch.equal(l1, l2)
    for k in g1:
        assert torch.equal(g1[k], g2[k]), k


def _leaves(tree, path=""):
    if isinstance(tree, dict):
        for k in sorted(tree):
            yield from _leaves(tree[k], f"{path}[{k!r}]")
    elif isinstance(tree, list):
        for i, v in enumerate(tree):
            yield from _leaves(v, f"{path}[{i}]")
    else:
        yield path, tree


def test_non_dense_train_forward_raises():
    """Every LM family has a full-sequence forward in both modes (the name
    is kept from when mamba2, recurrentgemma and whisper raised there,
    waiting for ROADMAP item 15b (b)): olmoe and the three families'
    ``forward`` run over a train tree (``mode="train"``) and over its
    packed tree (``mode="serve"``), giving (B, S, V) logits, and the three
    families' ``prefill(mode="train")`` returns the last position's
    logits and a per-layer cache; nothing raises."""
    from repro_torch.runtime.serve import pack_for_serving
    toks = torch.zeros((1, 4), dtype=torch.long)
    for arch in ("olmoe-1b-7b", "mamba2-1.3b", "recurrentgemma-9b",
                 "whisper-base"):
        api = configs.get(arch, reduced=True)
        params = api.init_params(torch.Generator().manual_seed(0),
                                 device="cpu")
        with torch.no_grad():
            train = api.forward(params, toks, mode="train")
            serve = api.forward(pack_for_serving(api, params), toks,
                                mode="serve")
            for logits in (train, serve):
                assert logits.shape == (1, 4, api.cfg.vocab), arch
                assert bool(torch.isfinite(logits.float()).all()), arch
            if arch != "olmoe-1b-7b":
                last, cache = api.prefill(params, toks, mode="train")
                assert last.shape == (1, api.cfg.vocab), arch
                assert torch.equal(last, train[:, -1]), arch
                assert len(cache["self"] if arch == "whisper-base"
                           else cache) == api.cfg.n_layers, arch


@pytest.mark.parametrize("bits", [2, 4])
def test_kv_qdq_gradient(bits):
    """The gradient of a quantized K/V row reaches it through its bf16
    scale and zero (the codes are integers): bitwise jax.grad's, nonzero
    only at each row's max and min, and the packed store's round trip
    gives the same."""
    rng = np.random.default_rng(bits)
    x = rng.normal(0, 1, (2, 5, 3, 16)).astype(np.float32)
    ct = rng.normal(0, 1, x.shape).astype(np.float32)
    jf = JKV.KVFormat(bits, 2, 16)
    tf = TKV.KVFormat(bits, 2, 16)
    xj = jnp.asarray(x).astype(jnp.bfloat16)
    with jax.disable_jit():
        want = jax.grad(lambda a: jnp.sum(
            JKV.qdq_kv(a, jf).astype(jnp.float32) * ct))(xj)
    grads = []
    for fn in (lambda a: TKV.qdq_kv(a, tf),
               lambda a: TKV.unpack_kv(TKV.pack_kv(a, tf), tf)):
        xt = torch.tensor(_f32(xj)).to(torch.bfloat16).requires_grad_(True)
        (fn(xt).float() * torch.tensor(ct)).sum().backward()
        grads.append(_f32(xt.grad))
    np.testing.assert_array_equal(grads[0], _f32(want))
    np.testing.assert_array_equal(grads[1], grads[0])
    xf = _f32(xj)
    extreme = (xf == xf.max(-1, keepdims=True)) | (xf == xf.min(
        -1, keepdims=True))
    assert np.all(grads[0][~extreme] == 0) and np.any(grads[0] != 0)


@pytest.mark.parametrize("step", [0, 3, 17])
def test_data_batches_bitwise(step):
    jl = jdata.SyntheticLM(vocab=251, seq_len=12, global_batch=3, seed=4,
                           with_frames=True, n_audio=5, d_model=8)
    tl = tdata.SyntheticLM(vocab=251, seq_len=12, global_batch=3, seed=4,
                           with_frames=True, n_audio=5, d_model=8)
    ji = jdata.SyntheticImages(n_classes=10, img_size=32, global_batch=3,
                               seed=4)
    ti = tdata.SyntheticImages(n_classes=10, img_size=32, global_batch=3,
                               seed=4)
    for a, b in ((jl.batch_at(step), tl.batch_at(step)),
                 (ji.batch_at(step), ti.batch_at(step))):
        assert a.keys() == b.keys()
        for k in a:
            assert a[k].dtype == b[k].dtype
            np.testing.assert_array_equal(a[k], b[k])
