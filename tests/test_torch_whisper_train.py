"""The port's whisper QAT train path (``models.whisper.encode(serve=False)``,
``forward``, the train-mode cache path) against the JAX package's, op by
op (``jax.disable_jit``), at ``reduced=True`` on weights drawn in numpy.

Contracts, and why:

* The encoder's vjp in the frames and its parameters (bounds and
  readings in ``test_encoder_vjp_matches_jax``: its first layer's q and k
  weights are off in up to 1.7% of elements), and one decoder layer with
  cross attention, its vjp in x and in the encoder
  output (a cotangent on its output): the output bitwise; x, the encoder
  output and every weight within one bf16 ulp with at most 0.1% of a leaf
  off (bitwise in practice); the layer norms' f32 scale and bias within
  1e-5 of their largest |value|; the step sizes as
  ``test_torch_ssm_train`` holds them.
* The whole forward's vjp in the parameters and the frames at three
  layers a side (so that three cotangents reach the encoder output): the
  frames' gradient bitwise, every weight within one bf16 ulp (or 2^-16
  of the leaf's largest |value|) with at most 0.2% of a leaf off, the
  norms within 1e-3 (``test_whole_forward_vjp_matches_jax`` gives the
  readings).  The reference's scan
  transpose adds the layers' cotangents of the encoder output in bf16,
  the last layer's first; torch's autograd adds them in the order their
  backwards finish, and ``_CrossFanout`` keeps the reference's
  (``test_whole_forward_needs_the_ordered_fanout``: without it the
  frames' gradient is off).
* whisper's train-mode and serve-mode ``forward`` logits (frames given)
  bitwise.
* One whole ``make_train_step`` (2 x 12 tokens and frames): the loss
  within 1e-6, every gradient leaf within 2e-2 of its largest |value|
  (the worst printed), the step sizes by their mass.  Remat (every
  encoder and decoder layer) off and on: bitwise.
* ``prefill(mode="train")``'s last logits bitwise ``forward(mode=
  "train")``'s last position; its last logits and both caches bitwise the
  reference's, then three train-mode decode steps bitwise.
* ``launch.train`` (synthetic frames) then ``launch.serve --ckpt-dir``.

The reference's side runs once per module.
"""
import dataclasses

import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402
import numpy as np  # noqa: E402

from repro import configs as jconfigs  # noqa: E402
from repro.models import whisper as JW  # noqa: E402
from repro.runtime import serve as jserve  # noqa: E402
from repro_torch import configs, convert  # noqa: E402
from repro_torch.models import whisper as W  # noqa: E402
from test_torch_moe_train import draw  # noqa: E402
from test_torch_ssm_train import (assert_same_runs, check_block_grads,  # noqa
                                  check_step, remat_runs, run_launchers,
                                  step_batch, vjp_block)
from test_torch_train_step import _f32, _step_case, np_params  # noqa: E402

ARCH = "whisper-base"
B, S = 2, 12
PROMPT, DECODE_T = S, 3  # the prompt is the forward's tokens
NORMS = ("['scale']", "['bias']")


@pytest.fixture(autouse=True, scope="module")
def _one_thread():
    """Small tensors: torch's CPU thread pool costs more than it saves."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _frames(cfg, seed, b=B):
    return np.random.default_rng(seed).standard_normal(
        (b, cfg.n_audio, cfg.d_model)).astype(np.float32)


# --- one decoder layer with cross attention -----------------------------------


def test_decoder_layer_vjp_matches_jax(monkeypatch):
    japi = jconfigs.get(ARCH, reduced=True)
    tapi = configs.get(ARCH, reduced=True)
    jcfg, tcfg = japi.cfg, tapi.cfg
    rng = np.random.default_rng(3)
    params = draw(JW._dec_layer(jcfg, (), (), False, japi.policy), rng)
    x = rng.standard_normal((B, S, jcfg.d_model)).astype(np.float32)
    enc = rng.standard_normal((B, jcfg.n_audio, jcfg.d_model)).astype(
        np.float32)
    ct = rng.standard_normal((B, S, jcfg.d_model)).astype(np.float32)

    def jfn(p, xx, e):
        return (JW._dec_layer_fwd(jcfg, p, xx, e, japi.policy, None, None,
                                  False, "xla")[0],)

    def tfn(p, xx, e):
        return (W._layer_fwd(tcfg, 0, p, xx, tapi.policy, {"enc_out": e},
                             impl="auto", serve=False)[0],)
    jy, ty, jg, tg, mass = vjp_block(jfn, tfn, params, (x, enc), (ct,),
                                     monkeypatch)
    np.testing.assert_array_equal(_f32(ty[0]), _f32(jy[0]))
    check_block_grads(jg, tg, mass, NORMS)


def test_encoder_vjp_matches_jax(monkeypatch):
    """The encoder (its two layers and the final norm) in its frames and
    parameters, a cotangent on its output: the output bitwise; the frames
    and every weight within one bf16 ulp of each element or 2^-8 of the
    leaf's largest |value|, at most 2% of a leaf off; the norms within 1e-3
    of their largest |value|.  Readings: layer 1 bitwise but for its norms'
    f32 sums (1e-7), the frames 0.03% off by one ulp; layer 0's q and k
    weights 1.5% / 1.7% off, at most 2.4e-3 of the leaf's largest value,
    and its ``ln1`` 1e-4: the attention backward's f32 products over the
    24 frames (dS K, dS^T Q) sum in another order in torch's CPU matmul
    than in XLA's dot, and a bf16 q or k gradient rounded the other way
    reaches every element of its projection's weight gradient (layer 0's
    inputs, the frames plus the sinusoid, meet it more often; over one KV
    chunk instead of two, 0.8-0.9%)."""
    japi = jconfigs.get(ARCH, reduced=True)
    tapi = configs.get(ARCH, reduced=True)
    rng = np.random.default_rng(4)
    spec = japi.specs("train")
    params = draw({k: spec[k] for k in ("enc_layers", "enc_norm")}, rng)
    frames = _frames(japi.cfg, 9)
    ct = rng.standard_normal(frames.shape).astype(np.float32)

    def jfn(p, fr):
        return (JW.encode(japi.cfg, p, fr, japi.policy, serve=False,
                          impl="xla"),)

    def tfn(p, fr):
        return (W.encode(tapi.cfg, p, fr, tapi.policy, serve=False),)
    jy, ty, jg, tg, mass = vjp_block(jfn, tfn, params, frames, (ct,),
                                     monkeypatch, lm=True)
    np.testing.assert_array_equal(_f32(ty[0]), _f32(jy[0]))
    check_block_grads(jg, tg, mass, NORMS, frac=2e-2, f32_tol=1e-3,
                      floor=2 ** -8)


# --- the whole forward at three decoder layers --------------------------------


def _three_layers(api):
    return dataclasses.replace(api, cfg=dataclasses.replace(api.cfg,
                                                            n_layers=3))


@pytest.fixture(scope="module")
def whole():
    """The whole train forward's vjp in the parameters and the frames, at
    three layers a side (once)."""
    japi = _three_layers(jconfigs.get(ARCH, reduced=True))
    tapi = _three_layers(configs.get(ARCH, reduced=True))
    rng = np.random.default_rng(5)
    params = draw(japi.specs("train"), rng)
    toks = rng.integers(0, japi.cfg.vocab, (B, S)).astype(np.int32)
    frames = _frames(japi.cfg, 6)
    ct = rng.standard_normal((B, S, japi.cfg.vocab)).astype(np.float32)

    def jfn(p, fr):
        return (japi.forward(p, jnp.asarray(toks), mode="train",
                             frames=fr),)

    def tfn(p, fr):
        return (tapi.forward(p, torch.from_numpy(toks).long(),
                             mode="train", frames=fr),)
    mp = pytest.MonkeyPatch()
    out = vjp_block(jfn, tfn, params, frames, (ct,), mp, lm=True)
    mp.undo()
    return out, (params, toks, frames, ct, tapi)


def test_whole_forward_vjp_matches_jax(whole):
    """The frames' gradient bitwise; each weight within one bf16 ulp of
    each element or 2^-16 of the leaf's largest |value|, at most 0.2% of
    it off (reading 0.12%, the cross attention's q of layer 0, whose f32
    products over the frames' two chunks sum in another order; one
    element of it, 8.4e-4 against a largest 1.76, is off by 1.1e-5); the
    norms and the embedding table within 1e-3 of their largest |value|
    (reading 2.7e-4, layer 0's ``ln_x`` bias, a sum over every token of a
    cotangent that such a bit reaches)."""
    (jy, ty, jg, tg, mass), _ = whole
    np.testing.assert_array_equal(_f32(ty[0]), _f32(jy[0]))
    np.testing.assert_array_equal(_f32(tg["x"]), _f32(jg["x"]))
    check_block_grads(jg, tg, mass, NORMS + ("['table']",), frac=2e-3,
                      f32_tol=1e-3, floor=2 ** -16)


def test_whole_forward_needs_the_ordered_fanout(whole, monkeypatch):
    """With the encoder output handed to every layer as it is (torch's own
    accumulation of its cotangents), the frames' gradient is no longer
    the reference's bitwise."""
    (_, _, jg, _, _), (params, toks, frames, ct, tapi) = whole
    monkeypatch.setattr(W._CrossFanout, "apply",
                        staticmethod(lambda x, n: [x] * n))
    tp = convert.from_jax_lm_train_params(params, device="cpu")
    fr = torch.from_numpy(frames).to(torch.bfloat16).requires_grad_(True)
    y = tapi.forward(tp, torch.from_numpy(toks).long(), mode="train",
                     frames=fr)
    (g,) = torch.autograd.grad(y, fr, torch.from_numpy(ct).to(y.dtype))
    assert not np.array_equal(_f32(g), _f32(jg["x"]))


# --- the model -----------------------------------------------------------------


@pytest.fixture(scope="module")
def model():
    """The reference's train and serve forwards, and its train prefill of
    PROMPT tokens with DECODE_T train decode steps, op by op (once)."""
    japi = jconfigs.get(ARCH, reduced=True)
    cfg = japi.cfg
    params = np_params(japi, seed=2)
    jp = jax.tree.map(jnp.asarray, params)
    toks = np.random.default_rng(4).integers(
        0, cfg.vocab, (B, S + DECODE_T)).astype(np.int32)
    frames = _frames(cfg, 7)
    jf = jnp.asarray(frames)
    jpacked = jax.jit(lambda t: jserve.pack_for_serving(japi, t))(jp)
    smax = PROMPT + DECODE_T
    with jax.disable_jit():
        train = _f32(japi.forward(jp, jnp.asarray(toks[:, :S]),
                                  mode="train", frames=jf))
        serve = _f32(japi.forward(jpacked, jnp.asarray(toks[:, :S]),
                                  mode="serve", frames=jf))
        last, cache = japi.prefill(jp, jnp.asarray(toks[:, :PROMPT]),
                                   mode="train", frames=jf)
        pre = jax.tree.map(np.asarray, cache)
        sk, sv = cache["self"]
        grow = lambda c: jnp.pad(  # noqa: E731
            c, [(0, 0), (0, 0), (0, smax - PROMPT), (0, 0), (0, 0)])
        cache = {"self": (grow(sk), grow(sv)), "cross": cache["cross"]}
        steps = []
        for t in range(DECODE_T):
            lg, cache = japi.decode_step(
                jp, cache, jnp.asarray(toks[:, PROMPT + t:PROMPT + t + 1]),
                jnp.asarray(PROMPT + t, jnp.int32), mode="train")
            steps.append(_f32(lg))
    return {"toks": toks, "frames": frames, "train": train, "serve": serve,
            "packed": convert.from_jax_lm_serve_tree(
                jax.tree.map(np.asarray, jpacked), device="cpu"),
            "tp": convert.from_jax_lm_train_params(params, device="cpu"),
            "last": _f32(last), "pre": pre, "steps": steps, "smax": smax}


def _run(model, mode, params):
    api = configs.get(ARCH, reduced=True)
    with torch.no_grad():
        return api.forward(params,
                           torch.from_numpy(model["toks"][:, :S]).long(),
                           mode=mode,
                           frames=torch.from_numpy(model["frames"]))


def test_train_forward_logits_bitwise(model):
    np.testing.assert_array_equal(_f32(_run(model, "train", model["tp"])),
                                  model["train"])


def test_serve_forward_logits_bitwise(model):
    np.testing.assert_array_equal(_f32(_run(model, "serve",
                                            model["packed"])),
                                  model["serve"])


def test_train_prefill_matches_train_forward(model):
    api = configs.get(ARCH, reduced=True)
    with torch.no_grad():
        last, cache = api.prefill(model["tp"],
                                  torch.from_numpy(model["toks"][:, :S])
                                  .long(), mode="train",
                                  frames=torch.from_numpy(model["frames"]))
    assert len(cache["self"]) == len(cache["cross"]) == api.cfg.n_layers
    np.testing.assert_array_equal(_f32(last), model["train"][:, -1])


def test_train_prefill_and_decode_match_jax(model):
    api = configs.get(ARCH, reduced=True)
    toks = model["toks"]
    with torch.no_grad():
        last, cache = api.prefill(
            model["tp"], torch.from_numpy(toks[:, :PROMPT]).long(),
            mode="train", frames=torch.from_numpy(model["frames"]))
        np.testing.assert_array_equal(_f32(last), model["last"])
        for kind in ("self", "cross"):
            for i, pair in enumerate(cache[kind]):
                for got, want in zip(pair, model["pre"][kind]):
                    np.testing.assert_array_equal(_f32(got), _f32(want[i]),
                                                  err_msg=f"{kind} {i}")
        pad = model["smax"] - PROMPT
        cache["self"] = [tuple(torch.cat([c, c.new_zeros(
            (c.shape[0], pad) + c.shape[2:])], dim=1) for c in pair)
            for pair in cache["self"]]
        for t in range(DECODE_T):
            lg, cache = api.decode_step(
                model["tp"], cache,
                torch.from_numpy(toks[:, PROMPT + t:PROMPT + t + 1]).long(),
                PROMPT + t, mode="train")
            np.testing.assert_array_equal(_f32(lg), model["steps"][t],
                                          err_msg=f"step {t}")


# --- one whole train step ----------------------------------------------------


@pytest.fixture(scope="module")
def step():
    cfg = jconfigs.get(ARCH, reduced=True).cfg
    return _step_case(ARCH, eager=True, batch=step_batch(
        cfg.vocab, b=B, s=S, frames=_frames(cfg, 8)))


def test_step_loss_and_gradients(step):
    check_step(step, ("['w']",))


def test_remat_changes_no_bit(step):
    b = step["batch"]
    params = configs.get(ARCH, reduced=True).init_params(
        torch.Generator().manual_seed(0), device="cpu")
    assert_same_runs(remat_runs(ARCH, params,
                                torch.from_numpy(b["tokens"]).long(),
                                torch.from_numpy(b["labels"]).long(),
                                frames=torch.from_numpy(b["frames"])))


def test_launch_train_then_serve(tmp_path, capsys):
    run_launchers(tmp_path, capsys, ARCH, S)
