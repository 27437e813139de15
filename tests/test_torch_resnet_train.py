"""The port's ResNet QAT training against the JAX package's.

* BatchNorm's batch statistics and running update, and the max pool's
  gradient at ties (windows of post-ReLU zeros), op by op;
* one residual block with a projection shortcut (stride 2, 16 -> 32
  channels, w2k2, BN on batch statistics): output and every gradient --
  the block's parameters and its input -- against ``jax.grad`` of the
  reference's ``_basic_fwd`` run op by op (``jax.disable_jit``): the
  output bitwise, the weights' and BN parameters' gradients within 2% of
  each leaf's largest |value|, the step sizes' within a quarter of their
  gradient's mass (``test_torch_train_step.py``): BN sums in another
  order;
* the train path's im2col (F4): its patches and its gradient bitwise
  ``jax.vjp`` of the reference's at three shapes;
* ``make_train_step`` for resnet18 at ``reduced=True`` (state step 50,
  batch 4 of ``SyntheticImages``) against the reference's jitted step, a
  second witness: ``test_torch_resnet_step.py`` holds every leaf against
  the reference op by op.  The jitted step is itself far from the op-by-
  op one: the port's loss equals the op-by-op loss bit for bit
  (3.130167007446289 at this seed), the jitted one is 1% away and its
  gradients have a cosine of 0.73 with the port's (measured on this
  seed).  So this test holds what that allows: the loss within 2%,
  ``grad_norm`` within 15%, the cosine of the weight gradients above 0.6,
  and the parameters after AdamW as ``check_params_after_adamw`` says.
"""
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402
import numpy as np  # noqa: E402

from repro.core.precision import PrecisionPolicy as JPolicy  # noqa: E402
from repro.models import resnet as JR  # noqa: E402
from repro.nn import param as jparam  # noqa: E402
from repro_torch.core.precision import PrecisionPolicy  # noqa: E402
from repro_torch.models import resnet as TR  # noqa: E402
from repro_torch.tree import flatten_with_paths  # noqa: E402
from test_torch_train_step import (_f32, _leaf_err,  # noqa: E402
                                   _step_case, check_params_after_adamw,
                                   step_mass)


@pytest.fixture(scope="module")
def resnet():
    return _step_case("resnet18", eager=False)


@pytest.fixture(autouse=True, scope="module")
def _one_thread():
    """Small tensors: torch's CPU thread pool costs more than it saves."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def test_resnet_step_against_the_jitted_reference(resnet):
    c = resnet
    assert float(c["tm"]["loss"]) == pytest.approx(float(c["jm"]["loss"]),
                                                   rel=2e-2)
    assert float(c["tm"]["grad_norm"]) == pytest.approx(
        float(c["jm"]["grad_norm"]), rel=0.15)
    assert c["tg"].keys() == c["jg"].keys()
    weights = [p for p in c["tg"] if not p.endswith(("['ga']", "['gw']"))]
    a = np.concatenate([_f32(c["tg"][p]).ravel() for p in weights])
    b = np.concatenate([_f32(c["jg"][p]).ravel() for p in weights])
    assert float(a @ b / (np.linalg.norm(a) * np.linalg.norm(b))) > 0.6
    for p in weights:
        assert np.isfinite(_f32(c["tg"][p])).all(), p
    # the stem's activation step gets no gradient: its pixels are not
    # quantized (both packages give zeros)
    assert float(c["tg"]["['stem']['ga']"]) == float(
        c["jg"]["['stem']['ga']"]) == 0.0


def test_resnet_params_after_adamw(resnet):
    check_params_after_adamw(resnet)


def test_bn_batch_statistics_and_running_update():
    rng = np.random.default_rng(7)
    x = rng.normal(0.3, 1.5, (4, 5, 5, 6)).astype(np.float32)
    p = {"scale": rng.uniform(0.5, 1.5, 6).astype(np.float32),
         "bias": rng.normal(0, 0.1, 6).astype(np.float32)}
    st = {"mean": rng.normal(0, 0.1, 6).astype(np.float32),
          "var": rng.uniform(0.5, 1.5, 6).astype(np.float32)}
    xj = jnp.asarray(x).astype(jnp.bfloat16)
    with jax.disable_jit():
        yj, sj = JR.bn_apply(p, st, xj, training=True)
        ye, _ = JR.bn_apply(p, st, xj, training=False)
    tp = {k: torch.tensor(v) for k, v in p.items()}
    ts = {k: torch.tensor(v) for k, v in st.items()}
    xt = torch.tensor(_f32(xj)).to(torch.bfloat16)
    yt, stt = TR.bn_apply(tp, ts, xt, training=True)
    yte, ste = TR.bn_apply(tp, ts, xt, training=False)
    assert yt.dtype == torch.bfloat16 and ste is ts
    for k in ("mean", "var"):  # f32 sums in another order: 2 ulp
        np.testing.assert_allclose(stt[k].numpy(), np.asarray(sj[k]),
                                   rtol=2.5e-7, atol=1e-7)
    np.testing.assert_array_equal(_f32(yte), _f32(ye))
    # a bf16 output moves by at most one ulp where the statistics do
    np.testing.assert_allclose(_f32(yt), _f32(yj), rtol=2 ** -8, atol=0)


@pytest.mark.parametrize("shape", [(2, 8, 8, 16, 3, 1), (2, 9, 9, 8, 3, 2),
                                   (2, 16, 16, 3, 7, 2)])
def test_im2col_train_gradient_is_the_xla_transpose(shape):
    """F4: the train path's im2col on bf16 x (SAME padding) against
    ``jax.vjp`` of the reference's ``im2col``: the patches and the gradient
    bitwise (the taps of a pixel added in f32, rounded once).  The plain
    gather's gradient, which adds them in bf16, is not: it was off in
    1013 / 100 / 834 of the elements at these shapes."""
    from repro.nn import quantized as JQ
    from repro_torch.nn import quantized as Q
    b, h, w, c, k, s = shape
    rng = np.random.default_rng(0)
    x = rng.standard_normal((b, h, w, c)).astype(np.float32)
    out, vjp = jax.vjp(lambda v: JQ.im2col(v, k, k, s, "SAME"),
                       jnp.asarray(x, jnp.bfloat16))
    ct = rng.standard_normal(out.shape).astype(np.float32)
    (want,) = vjp(jnp.asarray(ct, jnp.bfloat16))
    xt = torch.from_numpy(x).to(torch.bfloat16).requires_grad_(True)
    ctt = torch.from_numpy(ct).to(torch.bfloat16)
    cols = Q.im2col_train(xt, k, k, s, "SAME")
    assert cols.dtype == torch.bfloat16
    np.testing.assert_array_equal(_f32(cols.detach()), _f32(out))
    (got,) = torch.autograd.grad(cols, xt, grad_outputs=ctt)
    np.testing.assert_array_equal(_f32(got), _f32(want))
    (plain,) = torch.autograd.grad(Q.im2col(xt, k, k, s, "SAME"), xt,
                                   grad_outputs=ctt)
    assert not torch.equal(plain, got)


def test_max_pool_gradient_at_ties():
    """Windows of post-ReLU zeros and of repeated maxima: the gradient
    goes to the first maximum of each window, as jax.grad of the
    reference's reduce_window gives; values equal."""
    rng = np.random.default_rng(9)
    x = np.maximum(rng.integers(-2, 3, (2, 9, 10, 3)), 0).astype(np.float32)
    ct = rng.normal(0, 1, (2, 5, 5, 3)).astype(np.float32)

    def pool(a):
        return jax.lax.reduce_window(a, -jnp.inf, jax.lax.max, (1, 3, 3, 1),
                                     (1, 2, 2, 1), "SAME")
    want_y = np.asarray(pool(jnp.asarray(x)))
    want_g = np.asarray(jax.grad(lambda a: jnp.sum(pool(a) * ct))(
        jnp.asarray(x)))
    xt = torch.tensor(x, requires_grad=True)
    y = TR.max_pool_same(xt)
    (y * torch.tensor(ct)).sum().backward()
    np.testing.assert_array_equal(y.detach().numpy(), want_y)
    np.testing.assert_array_equal(xt.grad.numpy(), want_g)


def _block_case():
    rng = np.random.default_rng(0)
    pol = JPolicy(inner_bits=2, k=2)
    spec = JR._basic_spec(16, 32, 2, pol, "s1b0")

    def draw(s):
        if s.init in ("ones", "zeros", "constant"):
            return np.full(s.shape, {"ones": 1.0, "zeros": 0.0}.get(
                s.init, s.const), np.float32)
        return (rng.standard_normal(s.shape) / np.sqrt(s.shape[-2])
                ).astype(np.float32)
    params = jax.tree.map(draw, jparam.strip_markers(spec),
                          is_leaf=jparam.is_spec)
    x = np.maximum(rng.normal(0, 1, (2, 8, 8, 16)), 0).astype(np.float32)
    ct = rng.normal(0, 1, (2, 4, 4, 32)).astype(np.float32)
    return params, x, ct


def test_residual_block_gradients_op_by_op():
    params, x, ct = _block_case()
    jst = JR.init_bn_state(JR._basic_spec(16, 32, 2, JPolicy(inner_bits=2,
                                                             k=2), "s1b0"))
    pol = JPolicy(inner_bits=2, k=2)
    xj = jnp.asarray(x).astype(jnp.bfloat16)

    def jloss(p, a):
        y, _ = JR._basic_fwd(p, jst, a, pol, 2, True, "s1b0")
        return jnp.sum(y.astype(jnp.float32) * ct), y
    with jax.disable_jit():
        (_, yj), (gp, gx) = jax.value_and_grad(jloss, argnums=(0, 1),
                                               has_aux=True)(
            jax.tree.map(jnp.asarray, params), xj)
    tp = jax.tree.map(lambda a: torch.tensor(np.asarray(a),
                                             requires_grad=True), params)
    tst = jax.tree.map(lambda a: torch.tensor(np.asarray(a)), jst)
    xt = torch.tensor(_f32(xj)).to(torch.bfloat16).requires_grad_(True)
    tpol = PrecisionPolicy(inner_bits=2, k=2)

    def tloss(p):
        y, _ = TR._basic_fwd(p, tst, xt, tpol, 2, True, "s1b0")
        return (y.float() * torch.tensor(ct)).sum(), y
    loss, yt = tloss(tp)
    loss.backward()
    np.testing.assert_array_equal(_f32(yt), _f32(yj))
    assert _leaf_err(xt.grad, gx) <= 2e-2
    mass = step_mass(lambda p: tloss(p)[0], tp, pytest.MonkeyPatch())
    want = flatten_with_paths(jax.tree.map(np.asarray, gp))
    for path, leaf in flatten_with_paths(tp).items():
        if path.endswith(("['ga']", "['gw']")):
            d = abs(float(leaf.grad) - float(want[path]))
            assert d <= 0.25 * mass[path], path
        else:
            assert _leaf_err(leaf.grad, want[path]) <= 2e-2, path


