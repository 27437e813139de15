"""The train-mode cache path of every decoder arch, against the JAX
package's.

``ModelAPI.prefill``, ``decode_step`` and ``decode_steps`` with
``mode="train"`` run over an ``init_params("train")`` tree, fake-quant
(the reference's own train-mode cache path), at ``reduced=True`` on
weights drawn in numpy:

* every decoder arch: prefill's last logits bitwise
  ``forward(mode="train")``'s last position (the reference's own
  contract, ``tests/test_models.py``, is 2e-2);
* granite-8b (GQA), olmoe (MoE) and deepseek (MLA, its dense prefix and
  MoE), against the reference's run op by op: ``prefill(mode="train")``
  of a 5-token prompt, its last logits and every layer's cache bitwise,
  then three ``decode_step(mode="train")`` calls on that cache, bitwise
  (an MoE token is routed alone at decode, capacity 1, in both
  packages);
* deepseek's ``decode_steps(mode="train")`` over three tokens equals three
  train-mode decode steps, bitwise (each MoE token routed alone, R5).

The reference's prefill and decode run once per module (JAX compiling
its operations one by one).
"""
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402
import numpy as np  # noqa: E402

from repro import configs as jconfigs  # noqa: E402
from repro_torch import configs, convert  # noqa: E402
from test_torch_train_step import _f32, np_params  # noqa: E402

DECODER_ARCHS = ["granite-8b", "granite-34b", "yi-34b", "chameleon-34b",
                 "nemotron-4-340b", "olmoe-1b-7b", "deepseek-v2-lite-16b"]
DECODE_ARCHS = ["granite-8b", "olmoe-1b-7b", "deepseek-v2-lite-16b"]
B, PROMPT, DECODE_T, SMAX = 2, 5, 3, 8


@pytest.fixture(autouse=True, scope="module")
def _one_thread():
    """Small tensors: torch's CPU thread pool costs more than it saves."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _train_params(arch):
    japi = jconfigs.get(arch, reduced=True)
    params = np_params(japi, seed=2)
    return japi, params, convert.from_jax_lm_train_params(params,
                                                           device="cpu")


@pytest.mark.parametrize("arch", DECODER_ARCHS)
def test_train_prefill_matches_train_forward(arch):
    _, _, tp = _train_params(arch)
    api = configs.get(arch, reduced=True)
    toks = torch.from_numpy(np.random.default_rng(1).integers(
        0, api.cfg.vocab, (B, 8))).long()
    with torch.no_grad():
        full = api.forward(tp, toks, mode="train")
        last, caches = api.prefill(tp, toks, mode="train")
    assert len(caches) == api.cfg.n_layers
    np.testing.assert_array_equal(_f32(last), _f32(full[:, -1]))


def empty_cache(api):
    """The decode cache of ``cache_specs(B, SMAX)``, zeros (per layer: a
    pair of bf16 tensors here)."""
    return [tuple(torch.zeros(sp.shape, dtype=sp.dtype) for sp in pair)
            for pair in api.cache_specs(B, SMAX)]


def grow(cache):
    """A prefill's cache (per layer a pair of (B, PROMPT, ...) tensors)
    zero-padded along the sequence to SMAX."""
    return [tuple(torch.cat([c, c.new_zeros((c.shape[0], SMAX - c.shape[1])
                                            + c.shape[2:])], dim=1)
                  for c in pair) for pair in cache]


@pytest.fixture(scope="module")
def jax_train_cache():
    """The reference's train-mode cache path, op by op, for each of
    DECODE_ARCHS (once): ``prefill(mode="train")`` of a PROMPT-token
    prompt (its last logits and its cache, per layer), then DECODE_T
    ``decode_step(mode="train")`` calls on that cache grown to SMAX."""
    out = {}
    for arch in DECODE_ARCHS:
        japi, params, _ = _train_params(arch)
        toks = np.random.default_rng(6).integers(
            0, japi.cfg.vocab, (B, PROMPT + DECODE_T)).astype(np.int32)
        jp = jax.tree.map(jnp.asarray, params)
        logits = []
        with jax.disable_jit():
            last, cache = japi.prefill(jp, jnp.asarray(toks[:, :PROMPT]),
                                       mode="train")
            pre = [tuple(_f32(c[layer]) for c in cache)
                   for layer in range(japi.cfg.n_layers)]
            cache = jax.tree.map(lambda c: jnp.pad(
                c, [(0, 0), (0, 0), (0, SMAX - PROMPT)]
                + [(0, 0)] * (c.ndim - 3)), cache)
            for t in range(DECODE_T):
                lg, cache = japi.decode_step(
                    jp, cache, jnp.asarray(toks[:, PROMPT + t:PROMPT + t + 1]),
                    jnp.asarray(PROMPT + t, jnp.int32), mode="train")
                logits.append(_f32(lg))
        out[arch] = (toks, _f32(last), pre, logits)
    return out


@pytest.mark.parametrize("arch", DECODE_ARCHS)
def test_train_prefill_matches_jax(jax_train_cache, arch):
    """``prefill(mode="train")``'s last logits and every layer's cache
    (K/V; MLA's latent and rotary key) bitwise the reference's."""
    toks, want_last, want_cache, _ = jax_train_cache[arch]
    _, _, tp = _train_params(arch)
    api = configs.get(arch, reduced=True)
    with torch.no_grad():
        last, cache = api.prefill(tp, torch.from_numpy(toks[:, :PROMPT])
                                  .long(), mode="train")
    np.testing.assert_array_equal(_f32(last), want_last)
    assert len(cache) == len(want_cache)
    for layer, (got, want) in enumerate(zip(cache, want_cache)):
        assert len(got) == len(want)
        for g, w in zip(got, want):
            assert g.dtype == torch.bfloat16
            np.testing.assert_array_equal(_f32(g), w,
                                          err_msg=f"{arch} layer {layer}")


@pytest.mark.parametrize("arch", DECODE_ARCHS)
def test_train_decode_step_matches_jax(jax_train_cache, arch):
    """DECODE_T train-mode decode steps on the train prefill's cache,
    bitwise the reference's."""
    toks, _, _, want = jax_train_cache[arch]
    _, _, tp = _train_params(arch)
    api = configs.get(arch, reduced=True)
    with torch.no_grad():
        _, cache = api.prefill(tp, torch.from_numpy(toks[:, :PROMPT]).long(),
                               mode="train")
        cache = grow(cache)
        for t in range(DECODE_T):
            lg, cache = api.decode_step(
                tp, cache,
                torch.from_numpy(toks[:, PROMPT + t:PROMPT + t + 1]).long(),
                PROMPT + t, mode="train")
            np.testing.assert_array_equal(_f32(lg), want[t],
                                          err_msg=f"{arch} step {t}")


def test_train_decode_steps_equal_decode_steps():
    """``decode_steps(mode="train")`` over T tokens is T train-mode decode
    steps, bitwise (deepseek: MLA, its dense prefix and MoE, each token
    routed alone)."""
    _, _, tp = _train_params("deepseek-v2-lite-16b")
    api = configs.get("deepseek-v2-lite-16b", reduced=True)
    toks = torch.from_numpy(np.random.default_rng(7).integers(
        0, api.cfg.vocab, (B, DECODE_T))).long()
    c1, c2 = empty_cache(api), empty_cache(api)
    with torch.no_grad():
        many, c1 = api.decode_steps(tp, c1, toks, 0, mode="train")
        one = [api.decode_step(tp, c2, toks[:, t:t + 1], t,
                               mode="train")[0] for t in range(DECODE_T)]
    assert torch.equal(many, torch.stack(one, 1))
