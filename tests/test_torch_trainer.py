"""The port's checkpoint store, data pipeline, trainer and launchers (the
cases of the JAX package's ``tests/test_runtime.py`` that apply to one
device, on the port), and checkpoints crossing between the packages.

* ``CheckpointStore``: round trip (f32, bf16 through its uint16 view,
  int32), atomic publish (the latest wins), GC down to ``keep``, an
  asynchronous save, shape and missing-leaf errors; a directory the JAX
  package's store wrote (a resnet18 train state) restored by the port bit
  for bit, and one the port wrote restored by the JAX package;
* ``Trainer``: a run with finite losses, restart from the latest
  checkpoint, a restarted run bitwise equal to the uninterrupted one
  (parameters, moments and the loss trace: the reference's contract holds
  its loss trace to rtol 1e-5), the straggler hook, a SIGTERM-style stop
  with a final save;
* ``adamw_update`` (f32 and bf16 moments), ``compress_decompress`` and
  ``warmup_cosine`` against the JAX package's, op by op;
* ``make_train_step``: two microbatches against one on the same batch
  (the reference's tolerances: loss rtol 1e-5, parameters rtol 2e-4, atol
  2e-6), bf16 moments still descend, int8 error feedback carries its
  residual and descends;
* ``launch.train --reduced --device cpu`` for 4 steps, then
  ``launch.serve --ckpt-dir`` restoring and serving what it trained; the
  refusals (ResNets, R7; ``--production-mesh``, label 16; a card that is
  not there).
"""
import dataclasses
import json
import os

import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402
import ml_dtypes  # noqa: E402
import numpy as np  # noqa: E402

from repro import configs as jconfigs  # noqa: E402
from repro import optim as joptim  # noqa: E402
from repro.checkpoint import CheckpointStore as JStore  # noqa: E402
from repro_torch import configs, optim  # noqa: E402
from repro_torch.checkpoint import CheckpointStore  # noqa: E402
from repro_torch.data.pipeline import SyntheticLM  # noqa: E402
from repro_torch.launch import serve as launch_serve  # noqa: E402
from repro_torch.launch import steps as TS  # noqa: E402
from repro_torch.launch import train as launch_train  # noqa: E402
from repro_torch.optim import compress_init  # noqa: E402
from repro_torch.runtime.train import TrainLoopConfig, Trainer  # noqa: E402
from repro_torch.tree import flatten_with_paths, leaves  # noqa: E402
from test_torch_train_step import _f32, _np_state  # noqa: E402


@pytest.fixture()
def api():
    a = configs.get("granite-8b", reduced=True)
    a.microbatches = 1
    return a


@pytest.fixture(autouse=True, scope="module")
def _one_thread():
    """Small tensors: torch's CPU thread pool costs more than it saves."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _tree():
    return {"a": torch.arange(6, dtype=torch.float32).reshape(2, 3),
            "b": {"c": torch.tensor([1.5, -2.25, 3.0, 1e-3],
                                    dtype=torch.bfloat16)},
            "l": [torch.tensor(3, dtype=torch.int32),
                  torch.tensor([7, 8], dtype=torch.uint8)],
            "step": torch.tensor(7, dtype=torch.int32)}


class TestCheckpointStore:
    def test_save_restore_roundtrip(self, tmp_path):
        store = CheckpointStore(str(tmp_path))
        tree = _tree()
        store.save(7, tree)
        step, back = store.restore(tree)
        assert step == 7
        for path, leaf in flatten_with_paths(tree).items():
            got = flatten_with_paths(back)[path]
            assert got.dtype == leaf.dtype and got.shape == leaf.shape
            assert torch.equal(got, leaf), path
        meta = json.loads((tmp_path / "step_0000000007" /
                           "metadata.json").read_text())
        assert meta["leaves"]["['b']['c']"]["dtype"] == "bfloat16"
        assert np.load(tmp_path / "step_0000000007" / meta["leaves"][
            "['b']['c']"]["file"]).dtype == np.uint16

    def test_atomicity_latest_wins(self, tmp_path):
        store = CheckpointStore(str(tmp_path))
        for s in (1, 2, 3):
            store.save(s, {"x": torch.full((2,), float(s))})
        assert store.latest_step() == 3
        _, back = store.restore({"x": torch.zeros(2)})
        assert back["x"].tolist() == [3.0, 3.0]
        assert not [n for n in os.listdir(tmp_path) if n.startswith("tmp.")]

    def test_gc_keeps_last_k(self, tmp_path):
        store = CheckpointStore(str(tmp_path), keep=2)
        for s in range(5):
            store.save(s, {"x": torch.zeros(1)})
        assert store.all_steps() == [3, 4]

    def test_async_save_copies_before_returning(self, tmp_path):
        store = CheckpointStore(str(tmp_path))
        x = torch.ones(8)
        store.save(1, {"x": x}, blocking=False)
        x.add_(1.0)  # a later step writing the live tensor
        store.wait()
        assert store.latest_step() == 1
        assert store.restore({"x": x})[1]["x"].tolist() == [1.0] * 8

    def test_shape_mismatch_raises(self, tmp_path):
        store = CheckpointStore(str(tmp_path))
        store.save(1, {"x": torch.zeros(2)})
        with pytest.raises(ValueError):
            store.restore({"x": torch.zeros(3)})

    def test_missing_leaf_raises(self, tmp_path):
        store = CheckpointStore(str(tmp_path))
        store.save(1, {"x": torch.zeros(2)})
        with pytest.raises(KeyError):
            store.restore({"x": torch.zeros(2), "y": torch.zeros(1)})

    def test_no_checkpoint_raises(self, tmp_path):
        with pytest.raises(FileNotFoundError):
            CheckpointStore(str(tmp_path)).restore({"x": torch.zeros(1)})


class TestCrossPackageCheckpoints:
    def test_jax_written_train_state_restores_bitwise(self, tmp_path):
        """The reference's store writes a resnet18 train state (its tree
        is the port's: dicts only); the port restores it into its own
        ``train_state_specs`` template, every leaf bit for bit."""
        japi = jconfigs.get("resnet18", reduced=True)
        state = _np_state(japi)
        state["opt"]["m"] = jax.tree.map(
            lambda a: (a + 0.5).astype(jnp.bfloat16), state["params"])
        JStore(str(tmp_path)).save(50, state)
        tapi = dataclasses.replace(configs.get("resnet18", reduced=True),
                                   opt_dtype=torch.bfloat16)
        step, back = CheckpointStore(str(tmp_path)).restore(
            TS.train_state_specs(tapi), device="cpu")
        assert step == 50
        want = flatten_with_paths(jax.tree.map(np.asarray, state))
        got = flatten_with_paths(back)
        assert got.keys() == want.keys()
        for path, t in got.items():
            w = want[path]
            if w.dtype == ml_dtypes.bfloat16:
                assert t.dtype == torch.bfloat16, path
                w = w.view(np.uint16).astype(np.int32)
                t = t.view(torch.int16).to(torch.int32) & 0xFFFF
            np.testing.assert_array_equal(t.numpy(), w, err_msg=path)

    def test_port_written_checkpoint_restores_in_jax(self, tmp_path):
        tree = _tree()
        CheckpointStore(str(tmp_path)).save(3, tree)
        template = jax.tree.map(lambda t: jnp.zeros(
            t.shape, jnp.bfloat16 if t.dtype == torch.bfloat16 else
            np.dtype(str(t.dtype).split(".")[1])), tree)
        step, back = JStore(str(tmp_path)).restore(template)
        assert step == 3
        assert back["b"]["c"].dtype == ml_dtypes.bfloat16
        np.testing.assert_array_equal(
            np.asarray(back["b"]["c"]).astype(np.float32),
            tree["b"]["c"].float().numpy())
        np.testing.assert_array_equal(back["a"], tree["a"].numpy())
        assert int(back["l"][0]) == 3 and back["l"][1].tolist() == [7, 8]


class TestDataPipeline:
    def test_deterministic_skip_ahead(self):
        p1 = SyntheticLM(vocab=100, seq_len=8, global_batch=4, seed=1)
        p2 = SyntheticLM(vocab=100, seq_len=8, global_batch=4, seed=1)
        for step in (0, 5, 17):
            np.testing.assert_array_equal(p1.batch_at(step)["tokens"],
                                          p2.batch_at(step)["tokens"])
        assert not np.array_equal(p1.batch_at(0)["tokens"],
                                  p1.batch_at(1)["tokens"])
        b = p1.batch_at(0)
        assert b["tokens"].shape == b["labels"].shape
        assert b["labels"].max() < 100


def _mk(api, path, total=6, every=2, **kw):
    pipe = SyntheticLM(vocab=api.cfg.vocab, seq_len=16, global_batch=4,
                       seed=0)
    cfg = TrainLoopConfig(total_steps=total, ckpt_every=every,
                          ckpt_dir=str(path), log_every=100,
                          async_ckpt=False, peak_lr=1e-3)
    return Trainer(api, pipe, cfg, device="cpu", **kw)


def _gen():
    return torch.Generator().manual_seed(0)


class TestTrainer:
    def test_run_and_losses_finite(self, api, tmp_path):
        state, history = _mk(api, tmp_path).run(_gen())
        assert len(history) == 6 and all(np.isfinite(history))
        assert int(state["step"]) == 6
        assert CheckpointStore(str(tmp_path)).all_steps() == [2, 4, 6]

    def test_restart_resumes_from_checkpoint(self, api, tmp_path):
        _mk(api, tmp_path, total=6).run(_gen())
        t2 = _mk(api, tmp_path, total=10)
        state, history = t2.run(_gen())
        assert int(state["step"]) == 10
        assert len(history) == 4  # only the remaining steps ran
        assert t2.restore_seconds is not None

    def test_restart_equivalence_exact(self, api, tmp_path):
        """10 straight steps == 6 steps + restart + 4 steps, bitwise: the
        loss trace, the parameters and both moments."""
        _mk(api, tmp_path / "ab", total=6).run(_gen())
        s_ab, hist_resumed = _mk(api, tmp_path / "ab", total=10).run(_gen())
        s_full, hist_full = _mk(api, tmp_path / "full", total=10).run(_gen())
        assert hist_full[6:] == hist_resumed
        for a, b in zip(leaves(s_full), leaves(s_ab)):
            assert torch.equal(a, b)

    def test_async_checkpoints_restart_the_same(self, api, tmp_path):
        t = _mk(api, tmp_path / "a", total=4)
        t.cfg.async_ckpt = True
        s_async, _ = t.run(_gen())
        s_sync, _ = _mk(api, tmp_path / "s", total=4).run(_gen())
        _, back = CheckpointStore(str(tmp_path / "a")).restore(
            TS.train_state_specs(api))
        for a, b, c in zip(leaves(back), leaves(s_async), leaves(s_sync)):
            assert torch.equal(a, b) and torch.equal(b, c)

    def test_straggler_watchdog_fires(self, api, tmp_path):
        fired = []
        tr = _mk(api, tmp_path, total=5, every=100,
                 straggler_hook=lambda s, dt: fired.append(s))
        tr.cfg.straggler_factor = 0.0  # every step "straggles"
        tr.run(_gen())
        assert fired and min(fired) >= 3

    def test_stop_saves_the_final_state(self, api, tmp_path):
        tr = _mk(api, tmp_path, total=10, every=100)

        def stop(step, metrics):
            if step == 2:
                tr._stop = True  # what the SIGTERM/SIGINT handler sets
        state, history = tr.run(_gen(), on_metrics=stop)
        assert len(history) == 3 and int(state["step"]) == 3
        assert CheckpointStore(str(tmp_path)).latest_step() == 3

    def test_cuda_without_a_card_raises(self, api, tmp_path):
        if torch.cuda.is_available():
            pytest.skip("a card is present")
        with pytest.raises(RuntimeError, match="device='cpu'"):
            Trainer(api, None, TrainLoopConfig(ckpt_dir=str(tmp_path)))


def _batch(api, b=4, s=16):
    toks = torch.ones((b, s), dtype=torch.long)
    return {"tokens": toks, "labels": toks}


class TestTrainStep:
    def test_microbatch_equivalence(self):
        api1 = configs.get("granite-8b", reduced=True)
        api1.microbatches = 1
        api2 = dataclasses.replace(api1, microbatches=2)
        state = TS.init_train_state(api1, _gen(), device="cpu")
        state["step"] = state["step"] + 50
        n1, m1 = TS.make_train_step(api1)(state, _batch(api1))
        n2, m2 = TS.make_train_step(api2)(state, _batch(api2))
        assert float(m1["loss"]) == pytest.approx(float(m2["loss"]),
                                                  rel=1e-5)
        for a, b in zip(leaves(n1["params"]), leaves(n2["params"])):
            np.testing.assert_allclose(a.numpy(), b.numpy(), rtol=2e-4,
                                       atol=2e-6)

    def test_bf16_moments_still_descend(self):
        api = dataclasses.replace(configs.get("granite-8b", reduced=True),
                                  opt_dtype=torch.bfloat16, microbatches=1)
        step = TS.make_train_step(api, peak_lr=5e-3)
        state = TS.init_train_state(api, _gen(), device="cpu")
        assert leaves(state["opt"]["m"])[0].dtype == torch.bfloat16
        losses = []
        for _ in range(5):
            state, m = step(state, _batch(api))
            losses.append(float(m["loss"]))
        assert leaves(state["opt"]["v"])[0].dtype == torch.bfloat16
        assert losses[-1] < losses[0]

    def test_int8_error_feedback_converges(self):
        api = configs.get("granite-8b", reduced=True)
        api.microbatches = 1
        step = TS.make_train_step(api, peak_lr=5e-3, grad_compression=True)
        state = TS.init_train_state(api, _gen(), device="cpu")
        state["gc"] = compress_init(state["params"])
        losses = []
        for _ in range(5):
            state, m = step(state, _batch(api))
            losses.append(float(m["loss"]))
        assert losses[-1] < losses[0]
        assert any(float(r.abs().max()) > 0 for r in leaves(state["gc"]))


class TestLaunchers:
    def test_train_then_serve_the_checkpoint(self, tmp_path, capsys):
        d = str(tmp_path / "ck")
        assert launch_train.main(["--arch", "granite-8b", "--reduced",
                                  "--steps", "4", "--batch", "4", "--seq",
                                  "16", "--device", "cpu", "--ckpt-dir",
                                  d]) == 0
        assert "final step 4" in capsys.readouterr().out
        assert CheckpointStore(d).latest_step() == 4
        assert launch_serve.main(["--arch", "granite-8b", "--reduced",
                                  "--ckpt-dir", d, "--device", "cpu",
                                  "--batch", "2", "--prompt-len", "8",
                                  "--new-tokens", "4"]) == 0
        out = capsys.readouterr().out
        assert f"restored params from {d} (step 4)" in out
        assert "tok/s" in out

    @pytest.mark.parametrize("argv,match", [
        (["--arch", "resnet18"], "R7"),
        (["--arch", "granite-8b", "--production-mesh"], "label 16"),
        (["--arch", "granite-8b", "--multipod"], "label 16"),
        (["--arch", "granite-8b", "--production-mesh"],
         r"'model' axis of 16.*16b \(iv\)"),
        (["--arch", "granite-8b", "--multipod"],
         r"'model' axis of 16.*16b \(iv\)"),
        (["--arch", "granite-8b", "--devices", "0"], "--devices")])
    def test_train_refusals(self, argv, match):
        with pytest.raises(SystemExit, match=match):
            launch_train.main(argv + ["--device", "cpu"])

    def test_serve_refuses_a_cnn_checkpoint(self, tmp_path):
        with pytest.raises(SystemExit, match="ckpt-dir"):
            launch_serve.main(["--arch", "resnet18", "--reduced",
                               "--ckpt-dir", str(tmp_path), "--device",
                               "cpu"])


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_adamw_update_alone(dtype):
    """Three updates on the same gradients: parameters and moments within
    2 f32 ulp (f32 moments) or one bf16 ulp (bf16 moments: XLA and torch
    round the f32 moment alike, an ulp apart at most when the f32 values
    differ in their last bit)."""
    rng = np.random.default_rng(11)
    params = {"a": rng.normal(0, 1, (5, 7)).astype(np.float32),
              "b": {"gw": np.float32(0.05),
                    "w": rng.normal(0, 1, (3,)).astype(np.float32)}}
    jd, td = ((jnp.float32, torch.float32) if dtype == "float32"
              else (jnp.bfloat16, torch.bfloat16))
    jp = jax.tree.map(jnp.asarray, params)
    js = joptim.adamw_init(jp, state_dtype=jd)
    tp = jax.tree.map(torch.as_tensor, params)
    ts = optim.adamw_init(tp, state_dtype=td)
    for i in range(3):
        grads = jax.tree.map(lambda a: rng.normal(0, 1e-2, np.shape(a))
                             .astype(np.float32), params)
        lr = 1e-3 * (i + 1)
        with jax.disable_jit():
            jp, js = joptim.adamw_update(jax.tree.map(jnp.asarray, grads),
                                         js, jp, lr=lr)
        tp, ts = optim.adamw_update(jax.tree.map(torch.as_tensor, grads),
                                    ts, tp, lr=lr)
    assert int(ts["count"]) == int(js["count"]) == 3
    mom_rtol = 2.4e-7 if dtype == "float32" else 2 ** -8
    for got, want, rtol in (
            (flatten_with_paths(tp), jp, 2.4e-7),
            (flatten_with_paths(ts["m"]), js["m"], mom_rtol),
            (flatten_with_paths(ts["v"]), js["v"], mom_rtol)):
        want = flatten_with_paths(jax.tree.map(np.asarray, want))
        for path, t in got.items():
            np.testing.assert_allclose(_f32(t), _f32(want[path]), rtol=rtol,
                                       atol=1e-12, err_msg=path)
    assert flatten_with_paths(ts["m"])["['a']"].dtype == td


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_adamw_donated_update_same_bits_in_place(dtype):
    """``donate=True`` (what the Trainer's step uses, as the reference
    donates its state to the jitted step): the new parameters and moments
    are the non-donating update's bit for bit, written into the given
    tensors, which are returned."""
    rng = np.random.default_rng(12)
    params = {"a": torch.tensor(rng.normal(0, 1, (5, 7)), dtype=torch.float32),
              "b": {"gw": torch.tensor(0.05),
                    "w": torch.tensor(rng.normal(0, 1, (3,)),
                                      dtype=torch.float32)}}
    state = optim.adamw_init(params, state_dtype=dtype)
    for i in range(3):
        grads = {"a": torch.tensor(rng.normal(0, 1e-2, (5, 7)),
                                   dtype=torch.float32),
                 "b": {"gw": torch.tensor(1e-3),
                       "w": torch.tensor(rng.normal(0, 1e-2, (3,)),
                                         dtype=torch.float32)}}
        want_p, want_s = optim.adamw_update(grads, state, params, lr=1e-3)
        copies = [t.clone() for t in leaves(params)]
        got_p, got_s = optim.adamw_update(grads, state, params, lr=1e-3,
                                          donate=True)
        assert all(a is b for a, b in zip(leaves(got_p), leaves(params)))
        assert all(a is b for a, b in zip(leaves(got_s["m"]),
                                          leaves(state["m"])))
        for got, want in ((got_p, want_p), (got_s["m"], want_s["m"]),
                          (got_s["v"], want_s["v"])):
            for a, b in zip(leaves(got), leaves(want)):
                assert torch.equal(a, b)
        assert not all(torch.equal(a, b)
                       for a, b in zip(copies, leaves(params)))
        assert int(got_s["count"]) == i + 1
        params, state = got_p, got_s


def test_compress_decompress_and_error_feedback():
    """Dequantized gradients and residuals within 1 f32 ulp of the
    reference's (XLA may multiply by the reciprocal scale), carried over
    three steps; each step's error at most half a code step."""
    rng = np.random.default_rng(13)
    g0 = {"w": rng.normal(0, 1e-3, (64,)).astype(np.float32),
          "b": rng.normal(0, 1, (3, 4)).astype(np.float32)}
    jr = joptim.compress_init(jax.tree.map(jnp.asarray, g0))
    tr = optim.compress_init(jax.tree.map(torch.as_tensor, g0))
    for _ in range(3):
        g = jax.tree.map(lambda a: (a * rng.uniform(0.5, 1.5, np.shape(a)))
                         .astype(np.float32), g0)
        with jax.disable_jit():
            jd, jr_new = joptim.compress_decompress(
                jax.tree.map(jnp.asarray, g), jr)
        td, tr_new = optim.compress_decompress(
            jax.tree.map(torch.as_tensor, g), tr)
        for k in g:
            v = g[k] + _f32(tr[k])
            scale = np.abs(v).max() / 127.0
            assert np.abs(_f32(td[k]) - v).max() <= scale / 2 * (1 + 1e-6)
            np.testing.assert_allclose(_f32(td[k]), _f32(jd[k]), rtol=1.2e-7,
                                       atol=1.2e-7 * scale)
            np.testing.assert_allclose(_f32(tr_new[k]), _f32(jr_new[k]),
                                       rtol=0, atol=2.4e-7 * scale)
        jr, tr = jr_new, tr_new


@pytest.mark.parametrize("step", [0, 1, 37, 99, 100, 101, 5000, 9999, 12000])
def test_warmup_cosine(step):
    kw = dict(peak_lr=3e-4, warmup=100, total=10_000)
    with jax.disable_jit():
        want = float(joptim.warmup_cosine(jnp.int32(step), **kw))
    got = optim.warmup_cosine(torch.tensor(step, dtype=torch.int32), **kw)
    assert got.dtype == torch.float32 and got.ndim == 0
    assert float(got) == pytest.approx(want, rel=2.4e-7, abs=0)
