"""The port's mamba2 QAT train path (``nn.ssm.ssd_forward(serve=False)``,
``models.mamba2.forward``, the train-mode cache path) against the JAX
package's, op by op (``jax.disable_jit``), at ``reduced=True`` on weights
drawn in numpy.

Contracts, and why:

* ``nn.layers.xla_sum`` is ``jax.lax.reduce`` of bf16 operands on XLA's
  CPU compiler, bitwise, at shapes that take its window rewrite and shapes
  that do not; torch's own sum is not.
* ``causal_conv1d``'s vjp bitwise ``jax.vjp``'s (x, each tap, the bias;
  the taps' and bias's gradients are bf16 sums over (B, S), added as XLA
  adds them); with torch's own broadcast backward 75-85% of them differ.
* ``softplus``: its gradient is JAX's, exp(x - softplus(x)): 0.5 at 0
  exactly (torch's ``clamp_min`` passes 1 there), and elsewhere within 4
  f32 ulp (``exp`` and ``log1p`` round differently in the two libraries,
  so the forward is off in the last bit of about 10% of values too).
* One SSD block's vjp (B 2, S 32: two chunks), a cotangent on its output
  and on its final state: the output bitwise, the state within 1e-5 of
  its largest value (f32 einsums summed in another order; reading 2.5e-7);
  x and every projection weight within one bf16 ulp with at most 0.1% of
  a leaf off (readings 0.02% of x, 0.03% of ``in_xbc.w``, the rest
  bitwise), the conv's taps and bias bitwise, the f32 leaves (``A_log``,
  ``D``, ``dt_bias``, the gated norm's scale) within 1e-5 of their
  largest |value| (readings below 1e-6), ``gw`` within 1e-5 of its terms'
  mass and ``ga`` within half of it (``test_torch_moe_train``'s bounds).
* R8: where the reference's SSD backward overflows (a chunk whose decay
  passes 88, as mamba2-1.3b's 256-token chunks do) and gives NaN, the
  port's output is the same and its gradients finite.
* mamba2's train-mode and serve-mode ``forward`` logits over 19 tokens (a
  ragged last chunk: the pads run through every layer), bitwise.
* One whole ``make_train_step`` (2 x 19 tokens): the loss within 1e-6,
  every gradient leaf but the step sizes within 2e-2 of the leaf's
  largest |value| (the worst printed), ``A_log``, ``D``, ``dt_bias`` and
  the conv's gradients nonzero, the step sizes by their mass.
* remat off and on: the step's loss and gradients bitwise.
* ``prefill(mode="train")``: its last logits bitwise ``forward(mode=
  "train")``'s last position (19 tokens, pads included); at 16 tokens (a
  whole chunk, where the reference's state is the right one) the last
  logits and every layer's state against the reference's (the state
  within 1e-5, the conv cache bitwise), then three train-mode decode
  steps bitwise.  At a ragged prompt the port's state is the one after
  the prompt (R6), which ``test_torch_ssm.py`` holds.
* ``launch.train --reduced --device cpu`` then ``launch.serve
  --ckpt-dir``.

The reference's side runs once per module; the whole model's, in a
process of its own started with the module's first test.
"""
import dataclasses

import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402
import numpy as np  # noqa: E402

from repro import configs as jconfigs  # noqa: E402
from repro.nn import layers as JL  # noqa: E402
from repro.nn import ssm as jssm  # noqa: E402
from repro.runtime import serve as jserve  # noqa: E402
from repro_torch import configs, convert  # noqa: E402
from repro_torch.checkpoint import CheckpointStore  # noqa: E402
from repro_torch.launch import serve as launch_serve  # noqa: E402
from repro_torch.launch import steps as TS  # noqa: E402
from repro_torch.launch import train as launch_train  # noqa: E402
from repro_torch.nn import layers as TL  # noqa: E402
from repro_torch.nn import ssm as tssm  # noqa: E402
from repro_torch.tree import flatten_with_paths, unflatten  # noqa: E402
from test_torch_moe_train import draw  # noqa: E402
from test_torch_train_step import (_check_steps, _f32,  # noqa: E402
                                   _leaf_err, _step_case, np_params,
                                   step_mass)

ARCH = "mamba2-1.3b"
B, S = 2, 32          # the block: two chunks of 16
SEQ = 19              # the model: a ragged last chunk
PROMPT, DECODE_T = 16, 3
F32_LEAVES = ("['A_log']", "['D']", "['dt_bias']", "['norm']['scale']")
SSM_LEAVES = ("['A_log']", "['D']", "['dt_bias']", "['conv']['w']",
              "['conv']['b']")


@pytest.fixture(autouse=True, scope="module")
def _one_thread():
    """Small tensors: torch's CPU thread pool costs more than it saves."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def vjp_block(jfn, tfn, params, inputs, cts, monkeypatch, lm=False):
    """A block's forward and vjp in both packages -> (JAX outputs, port
    outputs, JAX gradients {path: array} with "x" the input's, port
    gradients likewise, the step sizes' mass).  ``jfn(p, *x)`` and
    ``tfn(p, *x)`` return a tuple of outputs; ``inputs`` is one array (bf16
    on both sides) or a tuple of them (gradients "x0", "x1", ...); ``cts``
    a cotangent for each output (None: none).  ``lm``: ``params`` is an LM
    tree whose layer stack the port keeps as a list."""
    many = isinstance(inputs, tuple)
    inputs = inputs if many else (inputs,)
    names = [f"x{i}" for i in range(len(inputs))] if many else ["x"]
    to_port = ((lambda t: convert.from_jax_lm_train_params(t, device="cpu"))
               if lm else (lambda t: convert.from_jax_train_params(
                   t, {}, device="cpu")[0]))
    jp = jax.tree.map(jnp.asarray, params)
    jx = [jnp.asarray(x, jnp.bfloat16) for x in inputs]
    with jax.disable_jit():
        jy, vjp = jax.vjp(jfn, jp, *jx)
        jct = tuple(jnp.zeros_like(y) if c is None else
                    jnp.asarray(c, y.dtype) for y, c in zip(jy, cts))
        gp, *gx = vjp(jct)
    jg = flatten_with_paths(to_port(jax.tree.map(np.asarray, gp)))
    jg.update(zip(names, gx))
    tp = to_port(params)
    live = {k: v.detach().requires_grad_(True)
            for k, v in flatten_with_paths(tp).items()}
    xt = [torch.from_numpy(np.asarray(x, np.float32)).to(
        torch.bfloat16).requires_grad_(True) for x in inputs]
    ty = tfn(unflatten(tp, list(live.values())), *xt)
    outs = [y for y, c in zip(ty, cts) if c is not None]
    tcts = [torch.from_numpy(np.asarray(c)).to(y.dtype)
            for y, c in zip(ty, cts) if c is not None]
    grads = torch.autograd.grad(outs, xt + list(live.values()),
                                grad_outputs=tcts)
    tg = dict(zip(live, grads[len(xt):]), **dict(zip(names, grads)))

    def loss(p):
        ys = [y for y, c in zip(tfn(p, *[x.detach() for x in xt]), cts)
              if c is not None]
        return sum((y.float() * c.float()).sum() for y, c in zip(ys, tcts))
    mass = step_mass(loss, tp, monkeypatch)
    return jy, ty, jg, tg, mass


def check_block_grads(jg, tg, mass, f32_leaves, bitwise=(), frac=1e-3,
                      f32_tol=1e-5, floor=0.0):
    """Inputs and weights within one bf16 ulp of each element (or within
    ``floor`` of the leaf's largest |value|), at most ``frac`` of a leaf
    off; ``bitwise`` leaves equal; f32 leaves within ``f32_tol`` of their
    largest |value|; ``gw`` within 1e-5 of its mass, ``ga`` within
    half."""
    assert tg.keys() == jg.keys()
    for path, g in tg.items():
        want = jg[path]
        if path.endswith(bitwise):
            np.testing.assert_array_equal(_f32(g), _f32(want), err_msg=path)
        elif not path.startswith("[") or path.endswith("['w']"):
            got, ref = _f32(g), _f32(want)
            assert np.abs(got).max() > 0, path
            np.testing.assert_allclose(got, ref, rtol=2 ** -7,
                                       atol=floor * np.abs(ref).max(),
                                       err_msg=path)
            assert np.mean(got != ref) <= frac, path
        elif path.endswith(f32_leaves):
            assert _leaf_err(g, want) <= f32_tol, path
        else:
            bound = 1e-5 if path.endswith("['gw']") else 0.5
            d = np.abs(_f32(g) - _f32(want))
            assert np.all(d <= bound * mass[path]), path


# --- the bf16 sums and softplus ----------------------------------------------


@pytest.mark.parametrize("shape,dims", [
    ((2, 19, 64), (0, 1)), ((2, 32, 32), (0, 1)), ((3, 48, 32), (0, 1)),
    ((1, 144, 32), (0, 1)), ((4, 40, 16), (0, 1)), ((2, 1000, 8), (0, 1)),
    ((100, 3), (0,)), ((8, 96), (1,)), ((4, 2048), (1,)), ((4, 50), (1,)),
    ((2, 37, 4, 6), (0, 1, 3)), ((33, 2, 35), (0, 2))])
def test_xla_sum_matches_lax_reduce(shape, dims):
    a = np.random.default_rng(0).standard_normal(shape).astype(np.float32)
    t = torch.from_numpy(a).to(torch.bfloat16)
    want = _f32(jax.lax.reduce(jnp.asarray(a, jnp.bfloat16),
                               jnp.array(0, jnp.bfloat16), jax.lax.add, dims))
    got = TL.xla_sum(t, dims)
    np.testing.assert_array_equal(_f32(got), want)
    if max(shape[d] for d in dims) > 32:
        assert not np.array_equal(_f32(t.sum(dims)), want)


@pytest.mark.parametrize("shape", [(2, 19, 64), (2, 32, 160), (3, 48, 96)])
def test_causal_conv1d_vjp_bitwise(shape, monkeypatch):
    rng = np.random.default_rng(1)
    c = shape[-1]
    params = {"w": (rng.standard_normal((4, c)) / 2).astype(np.float32),
              "b": rng.standard_normal(c).astype(np.float32)}
    x = rng.standard_normal(shape).astype(np.float32)
    ct = rng.standard_normal(shape).astype(np.float32)
    jy, ty, jg, tg, _ = vjp_block(
        lambda p, xx: (JL.causal_conv1d(p, xx),),
        lambda p, xx: (TL.causal_conv1d(p, xx),), params, x, (ct,),
        monkeypatch)
    np.testing.assert_array_equal(_f32(ty[0]), _f32(jy[0]))
    for path in tg:
        np.testing.assert_array_equal(_f32(tg[path]), _f32(jg[path]),
                                      err_msg=path)


def test_softplus_gradient_is_jax_s():
    special = np.array([0.0, -0.0, 1e-8, -3.0, 2.5, 30.0, -30.0, 100.0],
                       np.float32)
    rnd = (np.random.default_rng(2).standard_normal(2000) * 5).astype(
        np.float32)
    for v in (special, rnd):
        with jax.disable_jit():
            y, vjp = jax.vjp(jax.nn.softplus, jnp.asarray(v))
            (g,) = vjp(jnp.ones_like(y))
        x = torch.tensor(v, requires_grad=True)
        (gt,) = torch.autograd.grad(TL.softplus(x), x, torch.ones(len(v)))
        np.testing.assert_allclose(_f32(gt), _f32(g), rtol=4 * 2 ** -23,
                                   atol=0)
    x = torch.zeros(1, requires_grad=True)
    (g0,) = torch.autograd.grad(TL.softplus(x), x, torch.ones(1))
    assert float(g0) == 0.5


# --- one SSD block -------------------------------------------------------------


@pytest.fixture(scope="module")
def ssd_block():
    japi = jconfigs.get(ARCH, reduced=True)
    tapi = configs.get(ARCH, reduced=True)
    jcfg = japi.cfg.ssm
    rng = np.random.default_rng(3)
    params = draw(jssm.ssm_spec(jcfg, serve=False), rng)
    x = rng.standard_normal((B, S, jcfg.d_model)).astype(np.float32)
    cts = (rng.standard_normal((B, S, jcfg.d_model)).astype(np.float32),
           rng.standard_normal((B, jcfg.n_heads, jcfg.d_state,
                                jcfg.head_dim)).astype(np.float32))

    def jfn(p, xx):
        y, st = jssm.ssd_forward(p, xx, japi.policy, jcfg, serve=False)
        return y, st["ssm"]

    def tfn(p, xx):
        y, st = tssm.ssd_forward(p, xx, tapi.policy, tapi.cfg.ssm,
                                 serve=False)
        return y, st["ssm"]
    mp = pytest.MonkeyPatch()
    out = vjp_block(jfn, tfn, params, x, cts, mp)
    mp.undo()
    return out


def test_ssd_train_forward(ssd_block):
    jy, ty, *_ = ssd_block
    np.testing.assert_array_equal(_f32(ty[0]), _f32(jy[0]))
    assert _leaf_err(ty[1], jy[1]) <= 1e-5


def test_ssd_train_vjp_matches_jax(ssd_block):
    *_, jg, tg, mass = ssd_block
    check_block_grads(jg, tg, mass, F32_LEAVES,
                      bitwise=("['conv']['w']", "['conv']['b']"))
    for path in SSM_LEAVES:
        assert float(tg[path].abs().max()) > 0, path


def test_ssd_gradient_finite_where_the_reference_overflows():
    """R8: the reference's ``where(mask, exp(seg), 0)`` takes exp of the
    masked entries above the diagonal too, a sum of positive decays that
    overflows f32 once a chunk's decay passes 88 (a full 256-token chunk
    of mamba2-1.3b does at its first step); ``where``'s backward then
    multiplies the inf by a zero gradient, and every gradient is NaN.  At
    ``dt_bias`` 12 the reduced block's 16-token chunk overflows: the
    reference's output is finite and its gradients are not; the port's
    output is the reference's bitwise and its gradients are finite (it
    takes exp below the diagonal only)."""
    japi = jconfigs.get(ARCH, reduced=True)
    tapi = configs.get(ARCH, reduced=True)
    jcfg = japi.cfg.ssm
    rng = np.random.default_rng(9)
    params = draw(jssm.ssm_spec(jcfg, serve=False), rng)
    params["dt_bias"] = np.full_like(params["dt_bias"], 12.0)
    x = rng.standard_normal((B, S, jcfg.d_model)).astype(np.float32)
    ct = rng.standard_normal((B, S, jcfg.d_model)).astype(np.float32)
    with jax.disable_jit():
        y, vjp = jax.vjp(lambda p, xx: jssm.ssd_forward(
            p, xx, japi.policy, jcfg, serve=False)[0],
            jax.tree.map(jnp.asarray, params), jnp.asarray(x, jnp.bfloat16))
        gp, gx = vjp(jnp.asarray(ct, jnp.bfloat16))
    assert np.isfinite(_f32(y)).all()
    assert not np.isfinite(_f32(gx)).all()
    tp = convert.from_jax_train_params(params, {}, device="cpu")[0]
    live = {k: v.detach().requires_grad_(True)
            for k, v in flatten_with_paths(tp).items()}
    xt = torch.from_numpy(x).to(torch.bfloat16).requires_grad_(True)
    yt, _ = tssm.ssd_forward(unflatten(tp, list(live.values())), xt,
                             tapi.policy, tapi.cfg.ssm, serve=False)
    np.testing.assert_array_equal(_f32(yt), _f32(y))
    grads = torch.autograd.grad(yt, [xt] + list(live.values()),
                                torch.from_numpy(ct).to(torch.bfloat16))
    assert all(bool(torch.isfinite(g).all()) for g in grads)


# --- the model -----------------------------------------------------------------


def _model_reference():
    """The reference's train and serve forwards over SEQ tokens, and its
    train prefill of PROMPT tokens with DECODE_T train decode steps, op
    by op, in a process of its own -> numpy."""
    japi = jconfigs.get(ARCH, reduced=True)
    params = np_params(japi, seed=2)
    jp = jax.tree.map(jnp.asarray, params)
    rng = np.random.default_rng(4)
    toks = rng.integers(0, japi.cfg.vocab, (B, SEQ)).astype(np.int32)
    jpacked = jax.jit(lambda t: jserve.pack_for_serving(japi, t))(jp)
    with jax.disable_jit():
        train = _f32(japi.forward(jp, jnp.asarray(toks), mode="train"))
        serve = _f32(japi.forward(jpacked, jnp.asarray(toks), mode="serve"))
        last, states = japi.prefill(jp, jnp.asarray(toks[:, :PROMPT]),
                                    mode="train")
        cache, steps = states, []
        for t in range(DECODE_T):
            lg, cache = japi.decode_step(
                jp, cache, jnp.asarray(toks[:, PROMPT + t:PROMPT + t + 1]),
                jnp.asarray(PROMPT + t, jnp.int32), mode="train")
            steps.append(_f32(lg))
    pre = [{k: np.asarray(v[i]) for k, v in states.items()}
           for i in range(japi.cfg.n_layers)]
    return {"params": params, "toks": toks, "train": train, "serve": serve,
            "jpacked": jax.tree.map(np.asarray, jpacked),
            "last": _f32(last), "states": pre, "steps": steps}


@pytest.fixture(autouse=True, scope="module")
def _model_started():
    """``_model_reference``, started with the module's first test so that
    it runs beside the block's and the step's cases."""
    import torch.multiprocessing as mp
    pool = mp.get_context("spawn").Pool(1)
    try:
        yield pool.apply_async(_model_reference)
    finally:
        pool.terminate()
        pool.join()


@pytest.fixture(scope="module")
def model(_model_started):
    """``_model_reference``'s result (once), with the port's trees of its
    weights."""
    out = _model_started.get(timeout=600)
    out["packed"] = convert.from_jax_lm_serve_tree(out.pop("jpacked"),
                                                   device="cpu")
    out["tp"] = convert.from_jax_lm_train_params(out["params"],
                                                 device="cpu")
    return out


def test_train_forward_logits_bitwise(model):
    api = configs.get(ARCH, reduced=True)
    with torch.no_grad():
        got = api.forward(model["tp"], torch.from_numpy(model["toks"]).long(),
                          mode="train")
    assert got.dtype == torch.bfloat16
    np.testing.assert_array_equal(_f32(got), model["train"])


def test_serve_forward_logits_bitwise(model):
    api = configs.get(ARCH, reduced=True)
    with torch.no_grad():
        got = api.forward(model["packed"],
                          torch.from_numpy(model["toks"]).long(),
                          mode="serve")
    np.testing.assert_array_equal(_f32(got), model["serve"])


def test_train_prefill_matches_train_forward(model):
    api = configs.get(ARCH, reduced=True)
    with torch.no_grad():
        last, states = api.prefill(model["tp"],
                                   torch.from_numpy(model["toks"]).long(),
                                   mode="train")
    assert len(states) == api.cfg.n_layers
    np.testing.assert_array_equal(_f32(last), model["train"][:, -1])


def test_train_prefill_and_decode_match_jax(model):
    api = configs.get(ARCH, reduced=True)
    toks = model["toks"]
    with torch.no_grad():
        last, cache = api.prefill(model["tp"], torch.from_numpy(
            toks[:, :PROMPT]).long(), mode="train")
        np.testing.assert_array_equal(_f32(last), model["last"])
        for got, want in zip(cache, model["states"]):
            assert _leaf_err(got["ssm"], want["ssm"]) <= 1e-5
            np.testing.assert_array_equal(_f32(got["conv"]), want["conv"])
        for t in range(DECODE_T):
            lg, cache = api.decode_step(
                model["tp"], cache,
                torch.from_numpy(toks[:, PROMPT + t:PROMPT + t + 1]).long(),
                PROMPT + t, mode="train")
            np.testing.assert_array_equal(_f32(lg), model["steps"][t],
                                          err_msg=f"step {t}")


# --- one whole train step ----------------------------------------------------


def step_batch(vocab, b=B, s=SEQ, seed=5, **extra):
    toks = np.random.default_rng(seed).integers(
        0, vocab, (b, s + 1)).astype(np.int32)
    return dict(extra, tokens=toks[:, :-1], labels=toks[:, 1:])


@pytest.fixture(scope="module")
def step():
    return _step_case(ARCH, eager=True,
                      batch=step_batch(jconfigs.get(ARCH, reduced=True)
                                       .cfg.vocab))


def check_step(c, nonzero):
    """The step's loss and every gradient leaf against the reference's
    (the worst leaf printed); ``nonzero`` leaves' gradients nonzero."""
    assert float(c["tm"]["loss"]) == pytest.approx(float(c["jm"]["loss"]),
                                                   rel=1e-6)
    assert float(c["tm"]["lr"]) == float(c["jm"]["lr"]) > 0
    assert c["tg"].keys() == c["jg"].keys()
    worst = max((_leaf_err(g, c["jg"][p]), p) for p, g in c["tg"].items()
                if not p.endswith(("['ga']", "['gw']")))
    print(f"{c['tapi'].name}: worst gradient leaf {worst[1]} {worst[0]:.3e} "
          f"of its largest |value|")
    assert worst[0] <= 2e-2, worst
    for path, g in c["tg"].items():
        assert bool(torch.isfinite(torch.as_tensor(g)).all()), path
        if path.endswith(nonzero):
            assert float(torch.as_tensor(g).abs().max()) > 0, path
    _check_steps(c, "ga", frac=0.5)
    _check_steps(c, "gw", frac=1e-3)


def test_step_loss_and_gradients(step):
    check_step(step, SSM_LEAVES)


def remat_runs(arch, params, toks, labels, **fkw):
    """The train loss and gradients with ``remat`` off and on."""
    api = configs.get(arch, reduced=True)
    runs = []
    for remat in (False, True):
        a = dataclasses.replace(api, cfg=dataclasses.replace(api.cfg,
                                                             remat=remat))
        runs.append(TS.value_and_grad(
            lambda p, t, lb, f: TS.cross_entropy(
                a.forward(p, t, mode="train", **fkw), lb), params, toks,
            labels, None))
    return runs


def assert_same_runs(runs):
    (l0, g0), (l1, g1) = runs
    assert torch.equal(l0, l1)
    f1 = flatten_with_paths(g1)
    for path, g in flatten_with_paths(g0).items():
        assert torch.equal(g, f1[path]), path


def test_remat_changes_no_bit(step):
    b = step["batch"]
    params = configs.get(ARCH, reduced=True).init_params(
        torch.Generator().manual_seed(0), device="cpu")
    assert_same_runs(remat_runs(ARCH, params,
                                torch.from_numpy(b["tokens"]).long(),
                                torch.from_numpy(b["labels"]).long()))


def run_launchers(tmp_path, capsys, arch, seq):
    """``launch.train`` for 3 steps on the CPU, then ``launch.serve
    --ckpt-dir`` serving what it trained."""
    d = str(tmp_path / "ck")
    assert launch_train.main(["--arch", arch, "--reduced", "--steps", "3",
                              "--batch", "2", "--seq", str(seq), "--device",
                              "cpu", "--ckpt-dir", d]) == 0
    assert "final step 3" in capsys.readouterr().out
    assert CheckpointStore(d).latest_step() == 3
    assert launch_serve.main(["--arch", arch, "--reduced", "--ckpt-dir", d,
                              "--device", "cpu", "--batch", "2",
                              "--prompt-len", "8", "--new-tokens", "4"]) == 0
    out = capsys.readouterr().out
    assert f"restored params from {d} (step 3)" in out
    assert "tok/s" in out


def test_launch_train_then_serve(tmp_path, capsys):
    run_launchers(tmp_path, capsys, ARCH, SEQ)
