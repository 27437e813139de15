"""The dense family's QAT training forward against the JAX package's.

``forward(mode="train")`` logits of granite-34b, yi-34b, chameleon-34b and
nemotron-4-340b at ``reduced=True``, on weights drawn in numpy,
bitwise against the JAX package run op by op (``jax.disable_jit``; its
jitted run fuses differently and moves the logits by 2-4% of the largest
one).  granite-8b's is held in ``test_torch_train_step.py``, beside its
train step.  Each arch's JAX run compiles its operations one by one (about
2-11 s an arch), once for the module.
"""
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402
import numpy as np  # noqa: E402

from repro import configs as jconfigs  # noqa: E402
from repro_torch import configs, convert  # noqa: E402
from test_torch_train_step import np_params  # noqa: E402

DENSE = ["granite-34b", "yi-34b", "chameleon-34b", "nemotron-4-340b"]


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


@pytest.fixture(scope="module")
def dense_logits():
    """Each dense arch's train-forward logits, JAX op by op, on weights
    drawn in numpy (computed once for the module)."""
    out = {}
    for arch in DENSE:
        japi = jconfigs.get(arch, reduced=True)
        params = np_params(japi, seed=1)
        toks = np.random.default_rng(0).integers(
            0, japi.cfg.vocab, (2, 16)).astype(np.int32)
        with jax.disable_jit():
            logits = japi.forward(jax.tree.map(jnp.asarray, params),
                                  jnp.asarray(toks), mode="train")
        out[arch] = (params, toks, _f32(logits))
    return out


@pytest.mark.parametrize("arch", DENSE)
def test_dense_train_forward_bitwise(dense_logits, arch):
    params, toks, want = dense_logits[arch]
    api = configs.get(arch, reduced=True)
    tp = convert.from_jax_lm_train_params(params, device="cpu")
    with torch.no_grad():
        got = api.forward(tp, torch.as_tensor(toks).long(), mode="train")
    assert got.dtype == torch.bfloat16
    assert got.shape == (2, 16, api.cfg.vocab)
    np.testing.assert_array_equal(_f32(got), want)


def test_config_remat_fields_match():
    for arch in DENSE + ["granite-8b"]:
        j, t = (jconfigs.get(arch).cfg, configs.get(arch).cfg)
        assert (t.remat, t.remat_policy) == (j.remat, j.remat_policy), arch
        assert configs.get(arch).microbatches == jconfigs.get(
            arch).microbatches, arch
