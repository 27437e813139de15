"""The port's encoder-decoder (``models.whisper``) against the JAX package's,
at ``reduced=True``.

Contracts, against the JAX package run op by op (``jax.disable_jit``) on the
same numpy inputs (frame embeddings and tokens):

* ``nn.layers.gelu`` bitwise ``jax.nn.gelu(approximate=True)`` on bf16 (each
  operation rounded to bf16, as JAX computes it; ``F.gelu`` rounds once
  and differs in about half of the outputs);
* ``encode`` (bidirectional attention, sinusoidal positions, no rotary)
  bitwise, and one decoder layer (causal self-attention, cross-attention
  onto the encoder output) bitwise with its self and cross K/V;
* prefill with frames and four greedy decode steps: logits within 2% of
  the largest |logit| (the LM contract; bitwise in practice), equal
  tokens, the prefill cache (self and static cross K/V) bitwise;
* the serving front ends: ``Generator`` feeds zero frames when none are
  given, as the reference does; ``GenerateScheduler`` refuses the arch
  (no per-request frames), as the reference's does.
"""
import dataclasses

import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402
import numpy as np  # noqa: E402

from repro import configs as jconfigs  # noqa: E402
from repro.models import whisper as JW  # noqa: E402
from repro.nn import layers as jlayers  # noqa: E402
from repro.runtime import serve as jserve  # noqa: E402
from repro_torch import configs, convert  # noqa: E402
from repro_torch.launch import serve as launch  # noqa: E402
from repro_torch.models import whisper as W  # noqa: E402
from repro_torch.nn import layers  # noqa: E402
from repro_torch.runtime.scheduler import GenerateScheduler  # noqa: E402
from repro_torch.runtime.serve import Generator, pack_for_serving  # noqa

ARCH = "whisper-base"
LOGIT_RTOL = 2e-2
BATCH, PROMPT, NEW = 2, 7, 5


def np_tree(tree):
    return jax.tree.map(lambda a: np.array(a), tree)


def f32(x):
    if isinstance(x, torch.Tensor):
        return x.detach().to(torch.float32).numpy()
    return np.asarray(jnp.asarray(x).astype(jnp.float32))


def randomize(tree, rng):
    """Non-trivial LSQ steps and layer-norm parameters."""
    if isinstance(tree, dict):
        out = {}
        for k, v in tree.items():
            if k in ("gw", "ga"):
                out[k] = jnp.asarray(rng.uniform(0.02, 0.06, np.shape(v)),
                                     jnp.float32)
            elif k in ("scale", "bias"):
                out[k] = jnp.asarray(rng.normal(1.0 if k == "scale" else 0.0,
                                                0.2, np.shape(v)),
                                     jnp.float32)
            else:
                out[k] = randomize(v, rng)
        return out
    return tree


@pytest.fixture(scope="module")
def model():
    japi = jconfigs.get(ARCH, reduced=True)
    tapi = configs.get(ARCH, reduced=True)
    rng = np.random.default_rng(17)
    jtrain = randomize(japi.init_params(jax.random.PRNGKey(9), "train"), rng)
    jpacked = jax.jit(lambda t: jserve.pack_for_serving(japi, t))(jtrain)
    packed = convert.from_jax_lm_serve_tree(np_tree(jpacked), device="cpu")
    frames = rng.normal(0, 1, (BATCH, japi.cfg.n_audio, japi.cfg.d_model)
                        ).astype(np.float32)
    tokens = rng.integers(0, japi.cfg.vocab, (BATCH, PROMPT))
    return japi, tapi, jtrain, jpacked, packed, frames, tokens


@pytest.mark.parametrize("reduced", [False, True])
def test_config_api_and_workload_equal(reduced):
    j = jconfigs.get(ARCH, reduced=reduced)
    t = configs.get(ARCH, reduced=reduced)
    assert dataclasses.asdict(t.cfg) == dataclasses.asdict(j.cfg)
    assert (t.name, t.family, t.microbatches, t.long_context_ok,
            t.needs_frames) == (j.name, j.family, j.microbatches,
                                j.long_context_ok, j.needs_frames)
    assert t.needs_frames
    assert t.plan_layer_names() == j.plan_layer_names()
    for tokens in (1, 64, 4096):
        assert [dataclasses.astuple(g) for g in t.gemm_workload(tokens)] == \
            [dataclasses.astuple(g) for g in j.gemm_workload(tokens)]
    assert t.active_params() == j.active_params()
    assert t.param_class_counts() == j.param_class_counts()


def test_gelu_bitwise():
    x = np.random.default_rng(0).normal(0, 3, 50000).astype(np.float32)
    jx = jnp.asarray(x).astype(jnp.bfloat16)
    with jax.disable_jit():
        want = f32(jlayers.gelu(jx))
    got = f32(layers.gelu(torch.as_tensor(x).to(torch.bfloat16)))
    np.testing.assert_array_equal(got, want)


def test_encoder_and_decoder_layer_bitwise(model):
    japi, tapi, _, jpacked, packed, frames, tokens = model
    cfg = tapi.cfg
    with jax.disable_jit():
        jenc = JW.encode(japi.cfg, jpacked, jnp.asarray(frames), japi.policy,
                         serve=True, impl="xla")
        x = jnp.asarray(np.random.default_rng(1).normal(
            0, 1, (BATCH, PROMPT, cfg.d_model)), jnp.bfloat16)
        pos = jnp.broadcast_to(jnp.arange(PROMPT)[None], (BATCH, PROMPT))
        sin, cos = jlayers.rotary_cache(pos, cfg.hd)
        lp = jax.tree.map(lambda a: a[0], jpacked["dec_layers"])
        jy, (jkv, jxkv) = JW._dec_layer_fwd(japi.cfg, lp, x, jenc,
                                            japi.policy, sin, cos, True,
                                            "xla")
    enc = W.encode(cfg, packed, torch.as_tensor(frames), tapi.policy)
    np.testing.assert_array_equal(f32(enc), f32(jenc))
    tx = torch.as_tensor(np.asarray(x.astype(jnp.float32))).to(
        torch.bfloat16)
    y, (kv, xkv) = W._layer_fwd(cfg, 0, packed["dec_layers"][0], tx,
                                tapi.policy, {"enc_out": enc}, impl="auto")
    np.testing.assert_array_equal(f32(y), f32(jy))
    for got, want in zip(kv + xkv, jkv + jxkv):
        np.testing.assert_array_equal(f32(got), f32(want))


def test_pack_for_serving_matches(model):
    _, tapi, jtrain, _, packed, _, _ = model
    train = convert.from_jax_lm_train_params(np_tree(jtrain), device="cpu")
    assert len(train["enc_layers"]) == len(train["dec_layers"]) == \
        tapi.cfg.n_layers
    mine = pack_for_serving(tapi, train)
    leaves = lambda t: jax.tree_util.tree_leaves(  # noqa: E731
        jax.tree.map(f32, t, is_leaf=lambda x: isinstance(x, torch.Tensor)))
    assert len(leaves(mine)) == len(leaves(packed))
    for x, y in zip(leaves(mine), leaves(packed)):
        np.testing.assert_allclose(x, y, rtol=1e-6)


def test_prefill_with_frames_and_decode_match_jax(model):
    japi, tapi, _, jpacked, packed, frames, tokens = model
    gen = jserve.Generator(japi, jpacked)
    with jax.disable_jit():
        logits, pre = gen._prefill(jpacked, {"tokens": jnp.asarray(tokens),
                                             "frames": jnp.asarray(frames)})
        cache = gen._grow_cache(pre, BATCH, PROMPT, PROMPT + NEW)
        jlogits, jtoks = [logits], [np.asarray(jnp.argmax(logits, -1))]
        for i in range(NEW - 1):
            logits, cache = gen._decode(jpacked, cache,
                                        jnp.asarray(jtoks[-1][:, None]),
                                        jnp.asarray(PROMPT + i, jnp.int32))
            jlogits.append(logits)
            jtoks.append(np.asarray(jnp.argmax(logits, -1)))
    tgen = Generator(tapi, packed, device="cpu")
    toks, tlogits = tgen.run(tokens, NEW, frames=frames)
    np.testing.assert_array_equal(toks, np.stack(jtoks, axis=1))
    for got, want in zip(tlogits, jlogits):
        g, w = f32(got), f32(want)
        assert g.shape == w.shape == (BATCH, japi.cfg.vocab)
        np.testing.assert_allclose(g, w, rtol=0,
                                   atol=LOGIT_RTOL * np.abs(w).max())
    with torch.inference_mode():
        _, tpre = tgen.prefill(torch.as_tensor(tokens),
                               torch.as_tensor(frames))
    for part in ("self", "cross"):
        for i, pair in enumerate(tpre[part]):
            for got, want in zip(pair, pre[part]):
                np.testing.assert_array_equal(f32(got), f32(want[i]),
                                              err_msg=f"{part} {i}")


def test_zero_frames_by_default_and_no_scheduler(model):
    _, tapi, _, _, packed, frames, tokens = model
    gen = Generator(tapi, packed, device="cpu")
    zeros = np.zeros_like(frames)
    np.testing.assert_array_equal(gen.generate(tokens, 3),
                                  gen.generate(tokens, 3, frames=zeros))
    with pytest.raises(NotImplementedError, match="audio frames"):
        GenerateScheduler(gen, slots=2, max_len=16)


def test_launch_serve_on_cpu(capsys):
    assert launch.main(["--arch", ARCH, "--reduced", "--device", "cpu",
                        "--batch", "2", "--prompt-len", "5",
                        "--new-tokens", "3"]) == 0
    assert "tok/s" in capsys.readouterr().out
