"""One QAT train step of the port against the JAX package's.

``make_train_step`` from the same state and batch -- granite-8b at
``reduced=True``, state step 50 (the warmup's learning rate is 0 at step
0) -- compared on the loss, ``grad_norm``, every gradient leaf (each
package's ``adamw_update`` is wrapped to record the gradients it is
handed) and the parameters after AdamW; granite-8b's train-forward
logits; the gradient under a plan that quantizes the KV cache, stores
'packed' and 'qdq'; the train state's specs.  ``adamw_update``,
``compress_decompress`` and ``warmup_cosine`` alone are in
``test_torch_trainer.py``.  resnet18's step is in
``test_torch_resnet_step.py`` (op by op) and ``test_torch_resnet_train.py``
(jitted), with these helpers.

Tolerances, and why:

* granite-8b is held against the JAX step run op by op
  (``jax.disable_jit``; AdamW's elementwise update jitted): every weight
  gradient equal but for the last bit of an occasional element (at most
  0.1% of a leaf, by one bf16 ulp: a bf16 product's f32 sums), the loss
  and the norms' and embedding's gradients within 1e-6 / 1e-5 / 2e-4 of
  the leaf's largest |value| (f32 sums in another order).  The
  reference's jitted step differs from its own op-by-op step by 19-67% of
  a weight gradient's largest value (XLA fuses the fake-quant arithmetic
  and flips codes), so it is no yardstick here.
* A step size's gradient is a sum of terms that nearly cancel (LSQ's
  vbar - v/gamma), an activation step's of bf16 terms that JAX adds in
  bf16: ``ga`` is held within a quarter of the terms' absolute sum
  ("mass", measured on the port's forward) of the reference's
  (``test_torch_quant_train.py`` holds the port to the exact sum within
  2^-7 of it), ``gw`` (f32 terms) within 1e-5 of it.
* After AdamW the step's parameters are bitwise the port's AdamW of its
  own gradients at its learning rate, and the port's AdamW of the
  reference's gradients agrees with the reference's step to 2 f32 ulp (of
  the element, or of the lr-sized update near zero) on every leaf.
  Against the reference's step, a first step moves each element by about
  lr * sign(g): a gradient element whose sign differs moves by up to
  2 * lr more.
"""
import json

import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402
import numpy as np  # noqa: E402

from repro import configs as jconfigs  # noqa: E402
from repro import optim as joptim  # noqa: E402
from repro.core.plan import PrecisionPlan as JPlan  # noqa: E402
from repro.data.pipeline import SyntheticImages  # noqa: E402
from repro.launch import steps as JS  # noqa: E402
from repro.nn import param as jparam  # noqa: E402
from repro_torch import configs, convert, optim  # noqa: E402
from repro_torch.core import quant as TQ  # noqa: E402
from repro_torch.core.plan import PrecisionPlan  # noqa: E402
from repro_torch.launch import steps as TS  # noqa: E402
from repro_torch.tree import flatten_with_paths, unflatten  # noqa: E402

START_STEP = 50


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


def _port_tree(tree, family):
    host = jax.tree.map(np.asarray, tree)
    if family == "cnn":
        return convert.from_jax_train_params(host, {}, device="cpu")[0]
    return convert.from_jax_lm_train_params(host, device="cpu")


def _batch(japi):
    if japi.family == "cnn":
        b = SyntheticImages(n_classes=japi.cfg.n_classes,
                            img_size=japi.cfg.img_size, global_batch=4,
                            seed=0).batch_at(0)
        return {"tokens": b["images"], "labels": b["labels"]}
    toks = np.random.default_rng(0).integers(
        0, japi.cfg.vocab, (4, 17)).astype(np.int32)
    return {"tokens": toks[:, :-1], "labels": toks[:, 1:]}


def np_params(japi, seed=0):
    """The JAX package's ``init_params("train")`` tree, drawn in numpy from
    ``seed`` by every ParamSpec's own init (fan-in scaled normal, unit
    normal, zeros, ones, a constant): JAX's own draw compiles each of its
    operations first, seconds an arch."""
    rng = np.random.default_rng(seed)

    def draw(spec):
        if spec.init == "zeros":
            return np.zeros(spec.shape, np.float32)
        if spec.init == "ones":
            return np.ones(spec.shape, np.float32)
        if spec.init == "constant":
            return np.full(spec.shape, spec.const, np.float32)
        x = rng.standard_normal(spec.shape).astype(np.float32)
        if spec.init == "embed":
            return x
        fan_in = int(np.prod([spec.shape[a] for a in spec.fan_in_axes]))
        return (x / np.sqrt(max(fan_in, 1))).astype(np.float32)
    specs = jparam.strip_markers(japi.specs("train"))
    return jax.tree.map(draw, specs, is_leaf=jparam.is_spec)


def _np_state(japi, seed=0):
    """A JAX train state: ``np_params``, zero moments, step START_STEP."""
    params = np_params(japi, seed)
    zeros = lambda: jax.tree.map(np.zeros_like, params)  # noqa: E731
    return jax.tree.map(jnp.asarray, {
        "params": params,
        "opt": {"m": zeros(), "v": zeros(), "count": np.int32(0)},
        "step": np.int32(START_STEP)})


def _run_jax(japi, state, batch, eager, monkeypatch):
    """JAX train step -> (new state, metrics, gradients handed to AdamW).
    ``eager``: the step op by op, but for AdamW itself, jitted (elementwise
    f32 arithmetic, compiled once instead of once per leaf shape)."""
    seen = {}

    def spy(grads, *a, **kw):
        seen["g"] = grads
        if not eager:
            return joptim.adamw_update(grads, *a, **kw)
        with jax.disable_jit(False):
            return jax.jit(lambda g, s, p, lr: joptim.adamw_update(
                g, s, p, lr=lr))(grads, *a, kw["lr"])
    monkeypatch.setattr(JS, "adamw_update", spy)
    step = JS.make_train_step(japi)
    jb = {k: jnp.asarray(v) for k, v in batch.items()}
    if eager:
        with jax.disable_jit():
            new, metrics = step(state, jb)
    else:
        new, metrics, seen["g"] = jax.jit(
            lambda s, b: step(s, b) + (seen["g"],))(state, jb)
    monkeypatch.undo()
    return new, metrics, seen["g"]


def step_mass(loss_fn, params, monkeypatch):
    """{path of a step size ``gw``/``ga``: the absolute sum of its
    gradient's per-element terms (per channel for a channel-wise step, per
    expert for an expert bank's)}, on the port's ``loss_fn(params)`` and
    its backward."""
    paths = flatten_with_paths(params)
    live = {p: t.detach().requires_grad_(True) for p, t in paths.items()}
    by_id = {id(t): p for p, t in live.items()}
    mass = {}
    orig = TQ.fake_quant

    def traced(v, gamma, spec, lead=0):
        if id(gamma) not in by_id:
            return orig(v, gamma, spec, lead=lead)
        qn, qp = TQ.qrange(spec)
        cw = spec.channel_axis is not None
        n = v.numel() // int(np.prod(v.shape[:lead])) // (
            v.shape[-1] if cw else 1)
        gs = 1.0 / torch.sqrt(torch.tensor(float(n) * float(qp)))
        shape = list(v.shape[:lead]) + [1] * (v.ndim - lead)
        if cw:
            shape[-1] = v.shape[-1]
        g = TQ.grad_scale(gamma, gs).reshape(shape).to(v.dtype).expand(
            v.shape)
        key = by_id[id(gamma)]
        # per step: an expert bank's ``lead`` axes keep one each
        dims = tuple(range(lead, v.ndim - 1 if cw else v.ndim))
        g.register_hook(lambda t: mass.__setitem__(
            key, mass.get(key, 0.0) + t.double().abs().sum(dims).numpy()
            * float(gs)))
        vs = v / g
        vc = torch.minimum(torch.maximum(vs, torch.tensor(qn, dtype=vs.dtype)),
                           torch.tensor(qp, dtype=vs.dtype))
        return TQ.round_ste(vc) * g
    monkeypatch.setattr(TQ, "fake_quant", traced)
    loss = loss_fn(unflatten(params, [live[p] for p in paths]))
    torch.autograd.grad(loss, list(live.values()), allow_unused=True)
    monkeypatch.undo()
    return mass


def _step_case(arch, eager, batch=None):
    """Both packages' step from one JAX-drawn state (computed once), on
    ``batch`` (numpy ``tokens`` and ``labels``, else ``_batch``'s)."""
    japi = jconfigs.get(arch, reduced=True)
    japi.microbatches = 1
    tapi = configs.get(arch, reduced=True)
    tapi.microbatches = 1
    state = _np_state(japi)
    batch = _batch(japi) if batch is None else batch
    mp = pytest.MonkeyPatch()
    jnew, jm, jg = _run_jax(japi, state, batch, eager, mp)
    tstate = convert.from_jax_train_state(jax.tree.map(np.asarray, state),
                                          device="cpu")
    tb = {"tokens": torch.as_tensor(batch["tokens"]),
          "labels": torch.as_tensor(batch["labels"]).long()}
    if japi.family != "cnn":
        tb["tokens"] = tb["tokens"].long()
    fkw = {}
    if "frames" in batch:  # whisper
        tb["frames"] = fkw["frames"] = torch.as_tensor(batch["frames"])
    seen = {}

    def spy(grads, *a, **kw):
        seen["g"] = grads
        return optim.adamw_update(grads, *a, **kw)
    mp.setattr(TS, "adamw_update", spy)
    tnew, tm = TS.make_train_step(tapi)(tstate, tb)
    mp.undo()
    adamw_alone, _ = optim.adamw_update(seen["g"], tstate["opt"],
                                        tstate["params"], lr=tm["lr"])
    adamw_of_ref, _ = optim.adamw_update(_port_tree(jg, japi.family),
                                         tstate["opt"], tstate["params"],
                                         lr=tm["lr"])
    mass = step_mass(lambda p: TS.cross_entropy(
        tapi.forward(p, tb["tokens"], mode="train", **fkw), tb["labels"]),
        tstate["params"], mp)
    fam = japi.family
    return {"japi": japi, "tapi": tapi, "state": state, "batch": batch,
            "jm": jm, "tm": tm, "mass": mass,
            "jg": flatten_with_paths(_port_tree(jg, fam)),
            "tg": flatten_with_paths(seen["g"]),
            "jp": flatten_with_paths(_port_tree(jnew["params"], fam)),
            "tp": flatten_with_paths(tnew["params"]),
            "tp_adamw": flatten_with_paths(adamw_alone),
            "jp_adamw": flatten_with_paths(adamw_of_ref),
            "p0": flatten_with_paths(tstate["params"]),
            "lr": float(jm["lr"])}


@pytest.fixture(scope="module")
def granite():
    return _step_case("granite-8b", eager=True)


def _leaf_err(a, b):
    a, b = _f32(a).astype(np.float64), _f32(b).astype(np.float64)
    return float(np.abs(a - b).max() / max(np.abs(b).max(), 1e-30))


def _check_steps(case, kind, frac=0.25):
    """Every step size of ``kind`` ('ga' or 'gw') that the forward uses
    (all but the CNN stem's ``ga``: its pixels are not quantized) within
    ``frac`` of its gradient's mass of the reference's."""
    want = {p for p in case["tg"] if p.endswith(f"['{kind}']")} - {
        "['stem']['ga']"}
    assert want and want <= set(case["mass"])
    for path in want:
        d = np.abs(_f32(case["tg"][path]) - _f32(case["jg"][path]))
        assert np.all(d <= frac * case["mass"][path]), path


def test_granite_step_loss_and_gradients(granite):
    c = granite
    assert float(c["tm"]["loss"]) == pytest.approx(float(c["jm"]["loss"]),
                                                   rel=1e-6)
    assert float(c["tm"]["lr"]) == float(c["jm"]["lr"]) > 0
    assert float(c["tm"]["grad_norm"]) == pytest.approx(
        float(c["jm"]["grad_norm"]), rel=1e-4)
    assert c["tg"].keys() == c["jg"].keys()
    for path, g in c["tg"].items():
        want = c["jg"][path]
        if path.endswith("['w']"):  # out of bf16 products: the last bit
            got, ref = _f32(g), _f32(want)
            np.testing.assert_allclose(got, ref, rtol=2 ** -7, atol=0,
                                       err_msg=path)
            assert np.mean(got != ref) <= 1e-3, path
        elif "norm" in path or "ln" in path:
            assert _leaf_err(g, want) <= 1e-5, path
        elif "embed" in path:
            assert _leaf_err(g, want) <= 2e-4, path
    _check_steps(c, "ga")
    _check_steps(c, "gw", frac=1e-5)


def check_params_after_adamw(c):
    """The step's new parameters are the port's AdamW of the step's own
    gradients at its learning rate, bitwise; the port's AdamW of the
    reference's gradients is the reference's step within 2 f32 ulp on
    every leaf; and the step's parameters are within 2 * lr of the
    reference's."""
    lr = c["lr"]
    for path, p in c["tp"].items():
        assert torch.equal(p, c["tp_adamw"][path]), path
        got, want = _f32(p), _f32(c["jp"][path])
        moved = np.abs(got - want)
        assert moved.max() <= 2 * lr * 1.01 + 2e-7 * np.abs(want).max(), path
        np.testing.assert_allclose(_f32(c["jp_adamw"][path]), want,
                                   rtol=2.4e-7, atol=4 * lr * 2 ** -23,
                                   err_msg=path)


def test_granite_params_after_adamw(granite):
    check_params_after_adamw(granite)


def test_granite_train_forward_logits_bitwise(granite):
    c = granite
    toks = c["batch"]["tokens"]
    with jax.disable_jit():
        want = c["japi"].forward(c["state"]["params"], jnp.asarray(toks),
                                 mode="train")
    tp = _port_tree(c["state"]["params"], "dense")
    with torch.no_grad():
        got = c["tapi"].forward(tp, torch.as_tensor(toks).long(),
                                mode="train")
    np.testing.assert_array_equal(_f32(got), _f32(want))


KV_PLAN = {"version": 2, "name": "kv-train", "a_bits": 8, "boundary_bits": 8,
           "variant": "st", "quantize": True,
           "default": {"w_bits": 4, "k": 4, "channel_wise": False,
                       "dataflow": "auto"},
           "layers": {"k": {"w_bits": 4, "k": 4, "kv_bits": 2},
                      "v": {"w_bits": 4, "k": 4, "kv_bits": 4}}}


@pytest.mark.parametrize("store", ["packed", "qdq"])
def test_kv_plan_gradient(granite, store):
    """Under a plan that quantizes the cache, the train forward runs K/V
    through the cache's quantization (pack/unpack or qdq): the loss moves
    off the unquantized one, and k.w / v.w still get gradients (through
    each row's bf16 scale and zero, from its max and min), within 5% of
    the leaf's largest |value| of the JAX package's op by op."""
    plan = dict(KV_PLAN, kv={"k": 2, "store": store})
    japi = jconfigs.get("granite-8b", reduced=True,
                        policy=JPlan.loads(json.dumps(plan)))
    tapi = configs.get("granite-8b", reduced=True,
                       policy=PrecisionPlan.loads(json.dumps(plan)))
    params = granite["state"]["params"]
    b = granite["batch"]

    def jloss(p):
        return JS.cross_entropy(japi.forward(p, jnp.asarray(b["tokens"]),
                                             mode="train"),
                                jnp.asarray(b["labels"]))
    with jax.disable_jit():
        jl, jg = jax.value_and_grad(jloss)(params)
    tl, tg = TS.value_and_grad(
        lambda p, t, l, f: TS.cross_entropy(tapi.forward(p, t, mode="train"),
                                            l),
        _port_tree(params, "dense"), torch.as_tensor(b["tokens"]).long(),
        torch.as_tensor(b["labels"]).long(), None)
    assert float(tl) == pytest.approx(float(jl), rel=1e-6)
    assert abs(float(tl) - float(granite["tm"]["loss"])) > 1e-3
    jgf, tgf = flatten_with_paths(_port_tree(jg, "dense")), \
        flatten_with_paths(tg)
    for path in tgf:
        if path.endswith(("['k']['w']", "['v']['w']")):
            assert float(tgf[path].abs().max()) > 0, path
            assert _leaf_err(tgf[path], jgf[path]) <= 5e-2, path


def test_train_state_specs_and_init_match_the_reference():
    for arch, dt in (("granite-8b", None), ("nemotron-4-340b", "bfloat16")):
        japi, tapi = jconfigs.get(arch, reduced=True), configs.get(
            arch, reduced=True)
        jspec = JS.train_state_specs(japi)
        tspec = TS.train_state_specs(tapi)
        assert str(tapi.opt_dtype).endswith(dt or "float32")
        tstate = TS.init_train_state(tapi, torch.Generator().manual_seed(0),
                                     device="cpu")
        spec_leaves = flatten_with_paths(tspec)
        for path, leaf in flatten_with_paths(tstate).items():
            assert tuple(leaf.shape) == tuple(spec_leaves[path].shape), path
            assert leaf.dtype == spec_leaves[path].dtype, path
        # the reference's leaves by count and shape (its layer stack is
        # one subtree with a depth axis, the port's a per-layer list)
        n = japi.cfg.n_layers
        jcount = sum(np.prod(s.shape) for s in jax.tree.leaves(jspec))
        tcount = sum(int(np.prod(s.shape)) for s in spec_leaves.values())
        assert tcount == jcount
        assert len(spec_leaves) == len(jax.tree.leaves(jspec)) + 3 * (
            n - 1) * len(jax.tree.leaves(jspec["params"]["layers"]))
