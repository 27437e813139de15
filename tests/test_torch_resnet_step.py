"""One ResNet QAT train step of the port against the JAX package's, op by
op.

``make_train_step`` for resnet18 at ``reduced=True`` (state step 50,
batch 4 of ``SyntheticImages``, one state drawn in numpy) against the
reference's step under ``jax.disable_jit`` (AdamW itself jitted:
elementwise f32 arithmetic).  The fixture compiles each of the
reference's operations once, about 70 s of this file's minute and a
half.  Tolerances, with this seed's readings:

* the loss within 1e-6 (it is bitwise: 3.130167007446289), the learning
  rate equal, ``grad_norm`` within 1e-3 (1.3e-4; the step sizes'
  gradients are in it);
* every weight, BN and fc gradient within 3e-2 of the leaf's largest
  |value| (worst 2.0e-2, the stem's BN bias, then 1.5e-2 its scale and
  1.4e-2 ``s0b0.conv1``; the fc layer's bitwise).  Since the im2col
  transpose adds a pixel's tap gradients in f32 and rounds once, as XLA
  does (``nn.quantized.im2col_train``, F4), the conv weights sit closer
  (``s0b0.conv1`` was 1.8e-2 with the taps added in bf16) and the stem's
  BN bias moved from 1.8e-2 to 2.0e-2: the rest is bf16 products and
  BN's f32 sums in another order, carried toward the input;
* each step size against its gradient's terms' mass (``step_mass``):
  ``ga`` within a quarter of it (worst 0.13), ``gw`` within 1e-2 (worst
  3.0e-4); the stem's ``ga`` zero on both sides (its pixels are not
  quantized);
* the parameters after AdamW as ``check_params_after_adamw`` says.

``test_torch_resnet_train.py`` holds the same step against the
reference's jitted step, a second witness further off.
"""
import pytest

torch = pytest.importorskip("torch")

import numpy as np  # noqa: E402

from test_torch_train_step import (_check_steps, _f32,  # noqa: E402
                                   _leaf_err, _step_case,
                                   check_params_after_adamw)

STEP_SIZES = ("['ga']", "['gw']")


@pytest.fixture(autouse=True, scope="module")
def _one_thread():
    """Small tensors: torch's CPU thread pool costs more than it saves."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.fixture(scope="module")
def resnet():
    return _step_case("resnet18", eager=True)


def test_resnet_step_loss_lr_and_norm(resnet):
    c = resnet
    assert float(c["tm"]["loss"]) == pytest.approx(float(c["jm"]["loss"]),
                                                   rel=1e-6)
    assert float(c["tm"]["lr"]) == float(c["jm"]["lr"]) > 0
    assert float(c["tm"]["grad_norm"]) == pytest.approx(
        float(c["jm"]["grad_norm"]), rel=1e-3)


def test_resnet_step_every_weight_gradient(resnet):
    c = resnet
    assert c["tg"].keys() == c["jg"].keys()
    weights = [p for p in c["tg"] if not p.endswith(STEP_SIZES)]
    assert weights
    for path in weights:
        g = _f32(c["tg"][path])
        assert np.abs(g).max() > 0, path
        assert _leaf_err(g, c["jg"][path]) <= 3e-2, path


def test_resnet_step_step_size_gradients(resnet):
    c = resnet
    _check_steps(c, "ga")
    _check_steps(c, "gw", frac=1e-2)
    assert float(c["tg"]["['stem']['ga']"]) == float(
        c["jg"]["['stem']['ga']"]) == 0.0


def test_resnet_step_params_after_adamw(resnet):
    check_params_after_adamw(resnet)
