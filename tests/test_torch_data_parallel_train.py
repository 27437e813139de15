"""Data-parallel and FSDP training over ('pod', 'data') == one device.

The contract (README, "Training on a device mesh"): a rank of a (data, 1)
or (pod, data, 1) mesh keeps its FSDP blocks of the train state (every
leaf's 'embed' dimension over ('pod', 'data'), ``TRAIN_RULES``) and its
rows of the batch; a step gathers the parameters whole, sums the f32
gradients over the batch axes in rank order from zero and clips by the
whole gradients' norm.  With M microbatches over n batch ranks:

* M = n: bitwise the one-device step with M microbatches -- parameters,
  moments, loss, ``grad_norm``, the checkpoint's files -- for the reduced
  granite-8b, olmoe-1b-7b, deepseek-v2-lite-16b, mamba2-1.3b,
  recurrentgemma-9b and whisper-base through the ``Trainer``, ResNet-18
  through ``make_train_step`` (its 147-row stem stays whole: it does not
  split), and on a (2, 2, 1) mesh bitwise a (4, 1) one;
* M = 2n: the f32 sums in another order, every leaf within ``M2N_RTOL``
  of its largest value (the test prints the worst);
* M < n: bitwise the one-device step with n microbatches; against M
  microbatches, within the reference's microbatch tolerances in its own
  test (one step);
* B not split by the mesh (``batch_rules_for`` picks no axis): every rank
  runs the one-device step, bitwise;
* a (2, 1) checkpoint restores onto (4, 1) and onto one device, each
  restart bitwise the uninterrupted run there (B = 6: split on (2, 1),
  whole on (4, 1), so every run here is the one-device run's bits), and
  ``repro``'s store reads the files;
* SIGTERM to one rank stops every rank after the same step, with one
  final save.

``repro``'s meshed ``Trainer`` (2 forced host devices) runs once in a
process of its own, started first: the port restores its checkpoints
onto a (2, 1) mesh bit for bit, and its own (2, 1) run from the
reference's step-0 state gives the reference's losses: within 1e-6
before the first update, within 1e-3 after it (XLA's sharded program
fuses its bf16 work otherwise: the reference is 3.2e-4 from itself on
one device; a sum that drops the other rank's gradients is 5.7e-3 off).

ONE spawn of two gloo ranks and one of four (``launch.mesh.spawn``) run
every meshed case, in threads of the parent, started at once beside
``launch.train --devices 2`` (which spawns its own two); the four ranks'
restarts wait for the others' checkpoints, and the parent runs each
case's one-device side meanwhile.  The module imports no JAX at its top:
the ranks import it to find the case functions.  Every rank computes on
one thread.
"""
import dataclasses
import hashlib
import os
import signal
import time
from pathlib import Path
from types import SimpleNamespace

import numpy as np
import pytest
import torch

from repro_torch import configs
from repro_torch.checkpoint import CheckpointStore
from repro_torch.data.pipeline import SyntheticImages, SyntheticLM
from repro_torch.launch import mesh as mesh_lib
from repro_torch.launch import steps as steps_lib
from repro_torch.launch import train as launch_train
from repro_torch.nn import partitioning as part
from repro_torch.runtime.train import TrainLoopConfig, Trainer
from repro_torch.tree import flatten_with_paths

LM_ARCHS = ("granite-8b", "olmoe-1b-7b", "deepseek-v2-lite-16b",
            "mamba2-1.3b", "recurrentgemma-9b", "whisper-base")
GRANITE = "granite-8b"
SEQ, STEPS, LR = 16, 2, 0.1   # lr 0 at step 0 (warmup), 1e-3 at step 1
CKPT_B, CKPT_M = 6, 2         # split on (2, 1), whole on (4, 1)
M2N_RTOL = 1e-5
# against repro's meshed Trainer (its peak lr LR, so lr 0 at step 0): the
# losses of steps 0 and 1 read the step-0 weights (8.2e-8 and 0 apart),
# step 2's follows step 1's update (1.3e-4 apart; 5.7e-3 with the other
# rank's gradients dropped from the sum)
REF_STEPS = 3
REF_FORWARD_RTOL, REF_LOSS_RTOL = 1e-6, 1e-3


def _api(arch, m):
    return dataclasses.replace(configs.get(arch, reduced=True),
                               microbatches=m)


def _pipe(api, b):
    return SyntheticLM(vocab=api.cfg.vocab, seq_len=SEQ, global_batch=b,
                       seed=0, with_frames=api.needs_frames,
                       n_audio=getattr(api.cfg, "n_audio", 0),
                       d_model=api.cfg.d_model)


def _numpy(state):
    return {k: v.numpy().copy() for k, v in flatten_with_paths(state).items()}


def _files(d, step):
    """{file name: sha256} of checkpoint ``step`` under ``d``."""
    path = Path(d) / f"step_{step:010d}"
    return {f.name: hashlib.sha256(f.read_bytes()).hexdigest()
            for f in sorted(path.iterdir())}


def _held(state):
    """What a rank keeps: {path: shape}, its bytes."""
    flat = flatten_with_paths(state)
    return ({k: tuple(v.shape) for k, v in flat.items()},
            sum(v.numel() * v.element_size() for v in flat.values()))


def _train(mesh, d, arch, m, b, *, total=STEPS, every=100, lr=LR,
           on_metrics=None):
    """The ``Trainer`` of ``arch`` (M = ``m``, B = ``b``) to step
    ``total`` under ``d`` -> results: metrics, the whole final state (rank
    0 and one device), what the rank holds, the checkpoint's files."""
    api = _api(arch, m)
    tr = Trainer(api, _pipe(api, b), TrainLoopConfig(
        total_steps=total, ckpt_every=every, ckpt_dir=str(d), log_every=100,
        async_ckpt=False, peak_lr=lr), device="cpu", mesh=mesh)
    metrics = []

    def hook(step, mt):
        metrics.append(mt)
        if on_metrics:
            on_metrics(step, mt)
    state, history = tr.run(torch.Generator().manual_seed(0),
                            on_metrics=hook)
    held, nbytes = _held(state)
    whole = (part.gather_by(state, tr.state_sharding) if mesh is not None
             else state)
    store = CheckpointStore(str(d))
    out = {"metrics": metrics, "history": history, "held": held,
           "bytes": nbytes, "steps": store.all_steps(),
           "saves": len(tr.save_seconds),
           "rank": mesh_lib.rank_of(mesh)}
    if out["rank"] == 0:
        out["state"] = _numpy(whole)
        out["files"] = _files(d, int(state["step"]))
    return out


# --- the cases: each runs on ``mesh`` (None: one device) under ``root`` -----


def case_lm(arch):
    def run(mesh, root):
        return _train(mesh, root / f"lm-{arch}", arch, 2, 4)
    return run


def case_resnet(mesh, root):
    """ResNet-18 through ``make_train_step``: M = 2, 4 images of 32 x 32,
    the rank's rows cut from the whole batch by the 'batch' sharding."""
    del root
    api = _api("resnet18", 2)
    pipe = SyntheticImages(n_classes=api.cfg.n_classes,
                           img_size=api.cfg.img_size, global_batch=4, seed=0)
    state = steps_lib.init_train_state(api, torch.Generator().manual_seed(0),
                                       device="cpu")
    if mesh is not None:
        sh = steps_lib.train_state_shardings(api, mesh)
        state = part.shard_by(state, sh)
        rows = part.sharding_for(("batch",), mesh, part.TRAIN_RULES)
    step = steps_lib.make_train_step(api, peak_lr=LR, total_steps=STEPS,
                                     donate=True, mesh=mesh)
    metrics = []
    for i in range(STEPS):
        host = pipe.batch_at(i)
        batch = {"tokens": torch.as_tensor(host["images"]),
                 "labels": torch.as_tensor(host["labels"]).long()}
        if mesh is not None:
            batch = {k: v[part.local_index(tuple(v.shape), rows)]
                     for k, v in batch.items()}
        state, mt = step(state, batch)
        metrics.append({k: float(v) for k, v in mt.items()})
    held, nbytes = _held(state)
    if mesh is not None:
        state = part.gather_by(state, sh)
    return {"metrics": metrics, "held": held, "bytes": nbytes,
            "state": _numpy(state) if mesh_lib.rank_of(mesh) == 0 else None}


def case_gc(mesh, root):
    """``make_train_step(grad_compression=True)`` over granite, M = 2: the
    int8 error feedback on the summed gradients, its residual whole on
    every rank."""
    from repro_torch.optim import compress_init
    del root
    api = _api(GRANITE, 2)
    pipe = _pipe(api, 4)
    state = steps_lib.init_train_state(api, torch.Generator().manual_seed(0),
                                       device="cpu")
    gc = compress_init(state["params"])
    if mesh is not None:
        sh = steps_lib.train_state_shardings(api, mesh)
        state = part.shard_by(state, sh)
        rows = part.tree_shardings({"tokens": ("batch", "seq"),
                                    "labels": ("batch", "seq")}, mesh,
                                   part.TRAIN_RULES)
    state["gc"] = gc
    step = steps_lib.make_train_step(api, peak_lr=LR, total_steps=STEPS,
                                     grad_compression=True, mesh=mesh)
    metrics = []
    for i in range(STEPS):
        batch = (pipe.sharded_batch_at(i, rows) if mesh is not None else
                 {k: torch.as_tensor(v) for k, v in pipe.batch_at(i).items()})
        state, mt = step(state, {k: v.long() for k, v in batch.items()})
        metrics.append({k: float(v) for k, v in mt.items()})
    gc = state.pop("gc")
    if mesh is not None:
        state = part.gather_by(state, sh)
    return {"metrics": metrics, "gc": _numpy(gc),
            "state": _numpy(state) if mesh_lib.rank_of(mesh) == 0 else None}


def case_m2n(mesh, root):
    return _train(mesh, root / "m2n", GRANITE, 4, 4)


def case_replicated(mesh, root):
    """B = 3 does not split over 2 ranks: each runs the whole batch."""
    return _train(mesh, root / "b3", GRANITE, 3, 3)


def case_ckpt(mesh, root):
    """The checkpoint of step 2 that the (4, 1) world and the parent
    restore (one device: the comparison's own files)."""
    name = "ckpt21" if mesh is not None else "ckpt1"
    return _train(mesh, root / name, GRANITE, CKPT_M, CKPT_B, every=2)


def case_sigterm(mesh, root):
    """SIGTERM to rank 1 alone, after its step 1."""
    def kill(step, _):
        if step == 1 and mesh_lib.rank_of(mesh) == 1:
            os.kill(os.getpid(), signal.SIGTERM)
    return _train(mesh, root / "sigterm", GRANITE, 2, 4, total=6,
                  on_metrics=kill)


def case_repro(mesh, root):
    """``repro``'s checkpoints (converted to the port's tree by its
    process): step 2 restored onto this mesh, each rank's blocks against
    the whole; then 3 steps from its step 0 on this mesh."""
    _wait_for(root / "repro" / "ready", root / "repro" / "failed")
    api = _api(GRANITE, 2)
    sh = steps_lib.train_state_shardings(api, mesh)
    specs = steps_lib.train_state_specs(api)
    store = CheckpointStore(str(root / "repro" / "port2"))
    _, mine = store.restore(specs, shardings=sh)
    _, whole = store.restore(specs)
    mine_f, whole_f = flatten_with_paths(mine), flatten_with_paths(whole)
    blocks = all(torch.equal(
        v, whole_f[k][part.local_index(tuple(whole_f[k].shape),
                                       flatten_with_paths(sh)[k])])
        for k, v in mine_f.items())
    cut = sum(v.numel() != whole_f[k].numel() for k, v in mine_f.items())
    out = _train(mesh, root / "repro" / "train0", GRANITE, 2, 4,
                 total=REF_STEPS)
    out.update(blocks=blocks, cut=cut)
    return out


CASES2 = {**{f"lm:{a}": case_lm(a) for a in LM_ARCHS},
          "resnet": case_resnet, "gc": case_gc, "m2n": case_m2n,
          "replicated": case_replicated, "ckpt": case_ckpt,
          "sigterm": case_sigterm}


def _wait_for(path, failed):
    """Poll until ``path`` exists; raise where ``failed`` appears first or
    after 300 s."""
    deadline = time.monotonic() + 300
    while not path.exists():
        if failed.exists() or time.monotonic() > deadline:
            raise RuntimeError(f"{path} did not appear")
        time.sleep(0.2)


def case_m4(mesh, root):
    return _train(mesh, root / f"m4-{_shape(mesh)}", GRANITE, 4, 4)


def case_m_lt_n(mesh, root):
    """M = 2 over 4 ranks: each rank's single row a forward."""
    return _train(mesh, root / "m2-on-4", GRANITE, 2, 4)


def case_restore41(mesh, root):
    """The (2, 1) world's step-2 checkpoint onto (4, 1), to step 4; and
    the uninterrupted (4, 1) run."""
    import shutil
    d = root / "restart41"
    _wait_for(root / "ckpt21" / "step_0000000002", root / "abandon")
    if mesh_lib.rank_of(mesh) == 0:
        shutil.copytree(root / "ckpt21", d)
    mesh_lib.barrier(mesh)
    restart = _train(mesh, d, GRANITE, CKPT_M, CKPT_B, total=4, every=2)
    full = _train(mesh, root / "full41", GRANITE, CKPT_M, CKPT_B, total=4,
                  every=2)
    return {"restart": restart, "full": full}


def _shape(mesh):
    return "x".join(str(n) for n in part.axis_sizes(mesh).values())


# --- the ranks ---------------------------------------------------------------


def _cli_argv(root, steps, ranks):
    return ["--arch", GRANITE, "--reduced", "--batch", "4", "--seq",
            str(SEQ), "--device", "cpu", "--ckpt-dir", str(root / "cli"),
            "--ckpt-every", "2", "--steps", str(steps), "--devices",
            str(ranks)]


def _rank2(rank, root):
    torch.set_num_threads(1)
    mesh = mesh_lib.make_train_mesh((2, 1), device="cpu")
    root = Path(root)
    out = {name: fn(mesh, root) for name, fn in CASES2.items()}
    out["repro"] = case_repro(mesh, root)
    return out


def _rank4(rank, root):
    torch.set_num_threads(1)
    root = Path(root)
    out = {}
    for shape in ((4, 1), (2, 2, 1)):
        mesh = mesh_lib.make_train_mesh(shape, device="cpu")
        out[f"m4@{_shape(mesh)}"] = case_m4(mesh, root)
    mesh = mesh_lib.make_train_mesh((4, 1), device="cpu")
    out["m_lt_n"] = case_m_lt_n(mesh, root)
    out["restore41"] = case_restore41(mesh, root)
    # ``launch.train --devices 4`` in a world of four, as under torchrun,
    # from the checkpoint of the two ranks ``--devices 2`` spawned
    _wait_for(root / "cli" / "step_0000000002", root / "abandon")
    mesh_lib.barrier(mesh)
    out["cli"] = launch_train.main(_cli_argv(root, 4, 4))
    return out


# --- repro's meshed Trainer, in a process of its own ------------------------


def _repro_meshed(root):
    """``repro``'s ``Trainer`` on a (2, 1) ``make_local_mesh`` of 2 forced
    host devices: reduced granite-8b, M = 2, B = 4 x 16, peak lr ``LR``,
    its step-0 state saved and restored by ``run``, 3 steps -> losses.  Its checkpoints of
    steps 0 and 2 are rewritten in the port's tree (per-layer lists) by
    the port's store under ``port0``/``port2``; ``train0`` holds step 0
    for the port's own run."""
    root = Path(root)
    try:
        os.environ["XLA_FLAGS"] = " ".join(filter(None, (
            os.environ.get("XLA_FLAGS"),
            "--xla_force_host_platform_device_count=2",
            "--xla_cpu_multi_thread_eigen=false",
            "intra_op_parallelism_threads=1")))
        os.environ["JAX_PLATFORMS"] = "cpu"
        import jax
        from repro import configs as jconfigs
        from repro.checkpoint import CheckpointStore as JStore
        from repro.data.pipeline import SyntheticLM as JSyntheticLM
        from repro.launch import mesh as jmesh
        from repro.launch import steps as jsteps
        from repro.runtime.train import TrainLoopConfig as JCfg
        from repro.runtime.train import Trainer as JTrainer
        from repro_torch import convert
        api = jconfigs.get(GRANITE, reduced=True)
        api.microbatches = 2
        mesh = jmesh.make_local_mesh()
        pipe = JSyntheticLM(vocab=api.cfg.vocab, seq_len=SEQ,
                            global_batch=4, seed=0)
        ref = root / "ref"
        tr = JTrainer(api, pipe, mesh, JCfg(
            total_steps=REF_STEPS, ckpt_every=STEPS, ckpt_dir=str(ref),
            log_every=100, async_ckpt=False, peak_lr=LR))
        tr.store.save(0, tr.init_or_restore(jax.random.PRNGKey(0)))
        _, history = tr.run(jax.random.PRNGKey(0))
        for step, name in ((0, "port0"), (0, "train0"), (STEPS, "port2")):
            _, st = JStore(str(ref)).restore(jsteps.train_state_specs(api),
                                             step=step)
            port = convert.from_jax_train_state(
                jax.tree.map(np.asarray, st), device="cpu")
            CheckpointStore(str(root / name)).save(step, port)
        (root / "ready").touch()
        return {"history": [float(h) for h in history]}
    except BaseException:
        (root / "failed").touch()
        raise


# --- fixtures ----------------------------------------------------------------


@pytest.fixture(scope="module")
def root(tmp_path_factory):
    return tmp_path_factory.mktemp("dp")


@pytest.fixture(scope="module")
def repro_run(root):
    """``_repro_meshed``, started first in a process of its own."""
    import torch.multiprocessing as mp
    (root / "repro").mkdir()
    pool = mp.get_context("spawn").Pool(1)
    try:
        yield pool.apply_async(_repro_meshed, (str(root / "repro"),))
    finally:
        pool.terminate()
        pool.join()


@pytest.fixture(scope="module")
def worlds(repro_run, root):
    """The worlds, in threads of the parent, all started at once: two
    ranks, ``launch.train --devices 2`` (which spawns its own two), and
    four ranks whose restarts wait for the others' checkpoints ->
    futures {2: ``_rank2``'s results, 4: ``_rank4``'s, "cli": the
    launcher's exit code}."""
    import concurrent.futures
    store = str(root / "store")

    def guarded(fn, *args, **kw):
        try:
            return fn(*args, **kw)
        except BaseException:
            (root / "abandon").touch()  # the waiting ranks give up
            raise

    pool = concurrent.futures.ThreadPoolExecutor(3)
    with pytest.MonkeyPatch.context() as mp:
        mp.setenv("OMP_NUM_THREADS", "1")  # the launcher's ranks
        try:
            futures = {
                2: pool.submit(guarded, mesh_lib.spawn, _rank2, 2,
                               (str(root),), store_dir=store,
                               timeout_s=400),
                "cli": pool.submit(guarded, launch_train.main,
                                   _cli_argv(root, 2, 2)),
                4: pool.submit(guarded, mesh_lib.spawn, _rank4, 4,
                               (str(root),), store_dir=store,
                               timeout_s=400)}
            yield futures
        finally:
            pool.shutdown(wait=True)


@pytest.fixture(scope="module")
def single(worlds, root):
    """Each case on one device in the parent, at one thread."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    try:
        out = {name: fn(None, root / "one") for name, fn in CASES2.items()
               if name != "sigterm"}
        out["m4"] = out["m2n"]           # granite, M = 4, B = 4
        out["m2"] = out[f"lm:{GRANITE}"]  # granite, M = 2, B = 4
        out["ckpt4"] = _train(None, root / "one" / "ckpt4", GRANITE,
                              CKPT_M, CKPT_B, total=4, every=2)
        return out
    finally:
        torch.set_num_threads(threads)


@pytest.fixture(scope="module")
def meshed(worlds, single):
    return {k: f.result(timeout=600) for k, f in worlds.items()}


@pytest.fixture(scope="module")
def reference(repro_run, meshed):
    return repro_run.get(timeout=300)


def _bitwise(got, want, what):
    assert got.keys() == want.keys(), what
    bad = [k for k in want if not np.array_equal(got[k], want[k])]
    assert not bad, f"{what}: {len(bad)} leaves differ, first {bad[:3]}"


def _same_run(got, want, what):
    assert got["metrics"] == want["metrics"], what
    _bitwise(got["state"], want["state"], what)


# --- the state's axes and specs ----------------------------------------------


def _stand_in(shape):
    names = ("data", "model") if len(shape) == 2 else ("pod", "data",
                                                        "model")
    return SimpleNamespace(axis_names=names, devices=np.zeros(shape))


@pytest.mark.parametrize("arch", LM_ARCHS + ("granite-34b", "yi-34b",
                                             "chameleon-34b",
                                             "nemotron-4-340b"))
def test_train_state_axes_and_specs_equal_repro(arch, monkeypatch):
    """``train_state_axes`` is the reference's tree (its stacked layers
    unstacked as ``convert`` does), and every leaf's spec under
    ``TRAIN_RULES`` on (2, 1), (4, 1) and (2, 2, 1) stand-in meshes is
    the reference's ``logical_to_spec`` (no leaf of the reduced LMs needs
    ``fit_shardings``)."""
    from repro import configs as jconfigs
    from repro.launch import steps as jsteps
    from repro.nn import partitioning as jpart
    import test_torch_partitioning as tp
    api, japi = configs.get(arch, reduced=True), jconfigs.get(arch,
                                                             reduced=True)
    ours = steps_lib.train_state_axes(api)
    jaxes = jsteps.train_state_axes(japi)
    assert sorted(ours) == sorted(jaxes) and ours["step"] == () == \
        jaxes["step"]
    assert ours["opt"]["count"] == () == jaxes["opt"]["count"]
    ref = tp._flat_ax(tp._ref_param_counterparts(japi, "train",
                                                 monkeypatch))
    for shape in ((2, 1), (4, 1), (2, 2, 1)):
        mesh = _stand_in(shape)
        sh = flatten_with_paths(steps_lib.train_state_shardings(api, mesh))
        for group in (("params",), ("opt", "m"), ("opt", "v")):
            sub = ours
            for g in group:
                sub = sub[g]
            got = tp._leaves(sub)
            assert [p for p, _ in got] == [p for p, _ in ref]
            prefix = "".join(f"[{g!r}]" for g in group)
            for (path, axes), (_, ax) in zip(got, ref):
                assert axes == (ax.axes[1:] if ax.stacked else ax.axes)
                want = tp._ref_spec(ax.axes, ax.stacked, jpart.TRAIN_RULES,
                                    mesh.axis_names)
                assert sh[prefix + path].spec == want, (shape, path)
        assert sh["['step']"].spec == () == sh["['opt']['count']"].spec


def test_fit_shardings_keeps_an_uneven_leaf_whole():
    """ResNet-18's stem (147 rows on 'embed') stays whole on two ranks; a
    leaf that splits keeps its spec."""
    api = configs.get("resnet18", reduced=True)
    sh = flatten_with_paths(steps_lib.train_state_shardings(
        api, _stand_in((2, 1))))
    assert sh["['params']['stem']['w']"].spec == (None, "model")
    assert sh["['opt']['m']['stem']['w']"].spec == (None, "model")
    assert sh["['params']['fc']['w']"].spec[0] == "data"


@pytest.mark.parametrize("shape,rank", [((2, 1), 1), ((4, 1), 2),
                                        ((2, 2, 1), 3)])
def test_sharded_batch_at_is_the_ranks_block(shape, rank):
    """A rank's rows of ``batch_at`` (tokens, labels, whisper's frames):
    rank r of n holds rows [r B/n, (r+1) B/n), ('pod', 'data') row-major."""
    api = configs.get("whisper-base", reduced=True)
    pipe = _pipe(api, 8)
    names = ("data", "model") if len(shape) == 2 else ("pod", "data",
                                                        "model")
    coords = np.unravel_index(rank, shape)
    mesh = SimpleNamespace(
        axis_names=names, devices=np.zeros(shape),
        get_local_rank=lambda ax: int(coords[names.index(ax)]),
        repro_info=mesh_lib.MeshInfo(device=torch.device("cpu"),
                                     backend="gloo"))
    in_axes = {"tokens": ("batch", "seq"), "labels": ("batch", "seq"),
               "frames": ("batch", "frames", "act_embed")}
    sh = part.tree_shardings(in_axes, mesh, part.TRAIN_RULES)
    got = pipe.sharded_batch_at(3, sh)
    want = pipe.batch_at(3)
    per = 8 // int(np.prod(shape))
    for k in in_axes:
        assert got[k].device.type == "cpu"
        np.testing.assert_array_equal(got[k].numpy(),
                                      want[k][rank * per:(rank + 1) * per])


def test_sharded_batch_at_equals_repros_batch_at():
    """The port's ``batch_at`` is the reference's, so the blocks are."""
    from repro.data.pipeline import SyntheticLM as JSyntheticLM
    api = configs.get("whisper-base", reduced=True)
    ours = _pipe(api, 4).batch_at(5)
    theirs = JSyntheticLM(vocab=api.cfg.vocab, seq_len=SEQ, global_batch=4,
                          seed=0, with_frames=True, n_audio=api.cfg.n_audio,
                          d_model=api.cfg.d_model).batch_at(5)
    for k in theirs:
        np.testing.assert_array_equal(ours[k], theirs[k])


# --- refusals ----------------------------------------------------------------


def test_model_axis_refused_naming_16b_iv(tmp_path):
    """A 'model' axis above 1 trains the dense decoders, the ResNets, the
    MoE archs and whisper tensor-parallel
    (test_torch_tensor_parallel_train*.py); the SSM and hybrid families
    still refuse, naming ROADMAP 16b (iv) (c)."""
    api = _api("mamba2-1.3b", 2)
    fake = _stand_in((2, 2))
    for family in ("ssm", "hybrid"):
        with pytest.raises(NotImplementedError,
                           match=r"16b \(iv\) \(c\)"):
            part.require_train_mesh({"data": 2, "model": 2}, family)
    for family in ("dense", "moe", "audio"):
        part.require_train_mesh({"data": 2, "model": 2}, family)
    part.require_train_mesh({"data": 2, "model": 2})   # the mesh alone
    with pytest.raises(NotImplementedError, match=r"16b \(iv\)"):
        steps_lib.make_train_step(api, mesh=fake)
    with pytest.raises(NotImplementedError, match=r"16b \(iv\)"):
        Trainer(api, _pipe(api, 4), TrainLoopConfig(ckpt_dir=str(tmp_path)),
                mesh=fake)
    with pytest.raises(ValueError, match="covers 2 ranks but the world"):
        mesh_lib.make_train_mesh((1, 2), device="cpu")
    with part.axis_rules(part.TRAIN_RULES, fake):
        part.constrain(torch.ones(2), ("batch",))
    # a training mesh takes a 'pod' axis; serving keeps its refusal
    pod = _stand_in((2, 2, 1))
    with part.axis_rules(part.TRAIN_RULES, pod):
        part.constrain(torch.ones(2), ("batch",))
    with part.axis_rules(part.SERVE_RULES, pod):
        with pytest.raises(NotImplementedError, match="multi-pod"):
            part.constrain(torch.ones(2), ("batch",))


@pytest.mark.parametrize("b,m,n", [(4, 3, 2), (6, 2, 3), (8, 4, 3)])
def test_other_layouts_raise_naming_b_m_n(b, m, n):
    with pytest.raises(ValueError, match=f"B = {b}.*M = {m}.*n = {n}"):
        steps_lib.microbatch_layout(b, m, n)


def test_gradient_sum_takes_f32_only():
    with pytest.raises(TypeError, match="f32"):
        mesh_lib.all_reduce_batch(_stand_in((2, 1)),
                                  torch.ones(2, dtype=torch.bfloat16))


# --- the meshes against one device -------------------------------------------


@pytest.mark.parametrize("arch", LM_ARCHS)
def test_m_equals_n_bitwise_one_device(meshed, single, arch):
    """(2, 1), M = 2: both ranks' metrics, rank 0's gathered state and its
    checkpoint files bitwise one device's."""
    one = single[f"lm:{arch}"]
    ranks = meshed[2]
    for r in ranks:
        assert r[f"lm:{arch}"]["metrics"] == one["metrics"]
    _same_run(ranks[0][f"lm:{arch}"], one, arch)
    assert ranks[0][f"lm:{arch}"]["files"] == one["files"]


@pytest.mark.parametrize("arch", LM_ARCHS)
def test_each_rank_holds_only_its_blocks(meshed, single, arch):
    """Every rank holds its half of each sharded leaf and the rest whole:
    about 0.6-0.65 of one device's state bytes (0.61-0.76 of the values
    are on 'embed')."""
    one = single[f"lm:{arch}"]
    api = _api(arch, 2)
    for rank, r in enumerate(meshed[2]):
        res = r[f"lm:{arch}"]
        mesh = SimpleNamespace(axis_names=("data", "model"),
                               devices=np.zeros((2, 1)),
                               get_local_rank=lambda ax, r=rank: r)
        sh = flatten_with_paths(steps_lib.train_state_shardings(api, mesh))
        for path, shape in one["held"].items():
            want = tuple(len(range(*i.indices(n))) for i, n in zip(
                part.local_index(shape, sh[path]), shape))
            assert res["held"][path] == want, path
        assert res["bytes"] < 0.7 * one["bytes"]


def test_resnet18_m_equals_n_bitwise(meshed, single):
    ranks = meshed[2]
    for r in ranks:
        assert r["resnet"]["metrics"] == single["resnet"]["metrics"]
    _same_run(ranks[0]["resnet"], single["resnet"], "resnet18")
    assert ranks[0]["resnet"]["held"]["['params']['stem']['w']"] == (147, 64)
    assert ranks[1]["resnet"]["bytes"] < 0.51 * single["resnet"]["bytes"]


def test_grad_compression_on_the_summed_gradients_bitwise(meshed, single):
    """The int8 error feedback applies to the gradients summed over the
    ranks: metrics, state and each rank's whole residual bitwise one
    device's."""
    for r in meshed[2]:
        assert r["gc"]["metrics"] == single["gc"]["metrics"]
        _bitwise(r["gc"]["gc"], single["gc"]["gc"], "residual")
    _same_run(meshed[2][0]["gc"], single["gc"], "grad_compression")


@pytest.mark.parametrize("shape", [(2, 1), (4, 1), (2, 2, 1)])
def test_shard_tree_under_train_rules_is_shard_by(shape):
    """``shard_tree(..., TRAIN_RULES)`` cuts every leaf of the train
    state as ``shard_by`` does with ``train_state_shardings``, at every
    rank's coordinates (stand-in meshes: no collective)."""
    api = _api("whisper-base", 2)
    state = steps_lib.init_train_state(api, torch.Generator().manual_seed(0),
                                       device="cpu")
    axes = steps_lib.train_state_axes(api)
    names = ("data", "model") if len(shape) == 2 else ("pod", "data",
                                                        "model")
    for rank in range(int(np.prod(shape))):
        coords = np.unravel_index(rank, shape)
        mesh = SimpleNamespace(
            axis_names=names, devices=np.zeros(shape),
            get_local_rank=lambda ax: int(coords[names.index(ax)]))
        a = flatten_with_paths(part.shard_tree(state, axes, mesh,
                                               part.TRAIN_RULES))
        b = flatten_with_paths(part.shard_by(
            state, steps_lib.train_state_shardings(api, mesh)))
        assert a.keys() == b.keys()
        for k in a:
            assert torch.equal(a[k], b[k]), (shape, rank, k)


def test_m_twice_n_within_its_bound(meshed, single, capsys):
    """(2, 1), M = 4: two microbatches a rank, summed, then the ranks' sums
    summed: every leaf within ``M2N_RTOL`` of its largest |value| (the
    worst printed), the losses and norms within 1e-6."""
    one = single["m2n"]
    for r in meshed[2]:
        got = r["m2n"]
        for a, b in zip(got["metrics"], one["metrics"]):
            for k in ("loss", "grad_norm", "lr"):
                assert abs(a[k] - b[k]) <= 1e-6 * abs(b[k]), k
    got = meshed[2][0]["m2n"]["state"]
    worst = max(float(np.max(np.abs(got[k].astype(np.float64) - v)))
                / max(float(np.max(np.abs(v))), 1e-30)
                for k, v in one["state"].items())
    with capsys.disabled():
        print(f"\n[dp-train] M = 2n on (2, 1): worst leaf {worst:.3e} of "
              f"its largest |value|")
    assert worst <= M2N_RTOL, worst


def test_replicated_batch_bitwise(meshed, single):
    """B = 3 over 2 ranks: ``batch_rules_for`` picks no axis, each rank
    runs the one-device step over all 3 rows (M = 3); the parameters are
    FSDP blocks all the same."""
    for r in meshed[2]:
        assert r["replicated"]["metrics"] == single["replicated"]["metrics"]
    _same_run(meshed[2][0]["replicated"], single["replicated"], "B = 3")
    assert meshed[2][1]["replicated"]["bytes"] < \
        0.7 * single["replicated"]["bytes"]


def test_four_ranks_and_pod_axis_bitwise(meshed, single):
    """M = 4 on (4, 1) and on (2, 2, 1): each bitwise one device with M =
    4, so (2, 2, 1) bitwise (4, 1); a rank holds a quarter."""
    for key in ("m4@4x1", "m4@2x2x1"):
        for r in meshed[4]:
            assert r[key]["metrics"] == single["m4"]["metrics"], key
        _same_run(meshed[4][0][key], single["m4"], key)
        assert meshed[4][0][key]["files"] == single["m4"]["files"]
    assert meshed[4][3]["m4@2x2x1"]["held"] == \
        meshed[4][3]["m4@4x1"]["held"]


def test_m_below_n(meshed, single):
    """M = 2 over 4 ranks: bitwise the one-device step with n = 4
    microbatches.  Against M = 2 on one device it differs as a change of
    the microbatch count does (LSQ's gradient scale counts a microbatch's
    activations): within the reference's microbatch tolerances (loss rtol
    1e-5, parameters rtol 2e-4 atol 2e-6) after one step of its default
    schedule; checked here on the first step's loss and on the state the
    first step leaves (lr 0 at step 0)."""
    got = meshed[4]
    for r in got:
        assert r["m_lt_n"]["metrics"] == single["m4"]["metrics"]
    _same_run(got[0]["m_lt_n"], single["m4"], "M = 2 on 4 ranks")
    a, b = got[0]["m_lt_n"]["metrics"][0], single["m2"]["metrics"][0]
    np.testing.assert_allclose(a["loss"], b["loss"], rtol=1e-5)


def test_m_below_n_one_step_within_microbatch_tolerance(tmp_path):
    """The reference's microbatch test, as it runs it (one step at the
    default schedule), between the port's M = 4 (what M = 2 on 4 ranks
    is, bitwise) and M = 2 on one device: parameters rtol 2e-4, atol
    2e-6; loss rtol 1e-5."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    try:
        outs = [_train(None, tmp_path / str(m), GRANITE, m, 4, total=1,
                       lr=TrainLoopConfig.peak_lr) for m in (4, 2)]
    finally:
        torch.set_num_threads(threads)
    np.testing.assert_allclose(outs[0]["metrics"][0]["loss"],
                               outs[1]["metrics"][0]["loss"], rtol=1e-5)
    for k, v in outs[1]["state"].items():
        if k.startswith("['params']"):
            np.testing.assert_allclose(outs[0]["state"][k], v, rtol=2e-4,
                                       atol=2e-6, err_msg=k)


# --- checkpoints --------------------------------------------------------------


def test_checkpoint_files_equal_a_one_device_save(meshed, single, root):
    """(2, 1)'s step-2 checkpoint (rank 0 wrote, from gathered leaves) is
    byte for byte one device's, and ``repro``'s store reads it."""
    import jax
    import jax.numpy as jnp
    from repro.checkpoint import CheckpointStore as JStore
    assert meshed[2][0]["ckpt"]["files"] == single["ckpt"]["files"]
    assert meshed[2][0]["ckpt"]["steps"] == [2]
    api = _api(GRANITE, CKPT_M)
    specs = steps_lib.train_state_specs(api)
    template = jax.tree.map(
        lambda s: jnp.zeros(s.shape, jnp.int32 if s.dtype == torch.int32
                            else jnp.float32), specs,
        is_leaf=lambda s: hasattr(s, "shape"))
    step, back = JStore(str(root / "ckpt21")).restore(template)
    assert step == 2
    want = single["ckpt"]["state"]
    got = {k: np.asarray(v) for k, v in flatten_with_paths(back).items()}
    _bitwise(got, want, "repro's store")


def test_restore_onto_four_ranks_bitwise(meshed, single):
    """The (2, 1) checkpoint restored onto (4, 1), to step 4: bitwise the
    uninterrupted (4, 1) run, which is bitwise one device's."""
    res = meshed[4]
    full, one = res[0]["restore41"]["full"], single["ckpt4"]
    restart = res[0]["restore41"]["restart"]
    assert restart["metrics"] == full["metrics"][2:] == one["metrics"][2:]
    _bitwise(restart["state"], full["state"], "restart vs (4, 1)")
    _bitwise(full["state"], one["state"], "(4, 1) vs one device")
    assert restart["files"] == one["files"]
    for r in res:
        q = r["restore41"]["restart"]["held"]["['params']['head']['w']"]
        assert q[0] * 4 == one["held"]["['params']['head']['w']"][0]


def test_restore_onto_one_device_bitwise(meshed, single, root, tmp_path):
    """The (2, 1) checkpoint restored on one device, to step 4: bitwise the
    uninterrupted one-device run."""
    import shutil
    meshed  # the (2, 1) world wrote it
    shutil.copytree(root / "ckpt21", tmp_path / "ck")
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    try:
        got = _train(None, tmp_path / "ck", GRANITE, CKPT_M, CKPT_B,
                     total=4, every=2)
    finally:
        torch.set_num_threads(threads)
    one = single["ckpt4"]
    assert got["metrics"] == one["metrics"][2:]
    _bitwise(got["state"], one["state"], "one-device restart")


def test_sigterm_to_one_rank_stops_all_after_the_same_step(meshed):
    """Rank 1 alone got SIGTERM after step 1: both ranks ran steps 0 and 1,
    stopped, and saved step 2 once (no periodic save was due)."""
    for r in meshed[2]:
        got = r["sigterm"]
        assert len(got["history"]) == 2
        assert got["steps"] == [2] and got["saves"] == 1


def test_repro_checkpoint_restores_onto_the_mesh(meshed, reference):
    """``repro``'s meshed ``Trainer``'s step-2 state onto (2, 1): each
    rank's blocks bitwise the whole leaves' (11 leaves x 3 cut)."""
    for r in meshed[2]:
        assert r["repro"]["blocks"]
        assert r["repro"]["cut"] > 0


def test_meshed_losses_agree_with_repros_meshed_trainer(meshed, reference,
                                                       capsys):
    """The port's (2, 1) ``Trainer`` from ``repro``'s step-0 state, 3
    steps: the losses before any update within ``REF_FORWARD_RTOL`` of
    ``repro``'s (2, 1) run's, step 2's (after step 1's update at lr 1e-3)
    within ``REF_LOSS_RTOL`` (the gaps printed)."""
    got = meshed[2][0]["repro"]["history"]
    want = reference["history"]
    assert len(got) == len(want) == REF_STEPS
    gap = [abs(a - b) / abs(b) for a, b in zip(got, want)]
    with capsys.disabled():
        print(f"\n[dp-train] port (2, 1) losses {got} vs repro's meshed "
              f"Trainer {want}: relative gap {gap}")
    np.testing.assert_allclose(got[:2], want[:2], rtol=REF_FORWARD_RTOL)
    np.testing.assert_allclose(got[2:], want[2:], rtol=REF_LOSS_RTOL)


def test_launcher_two_ranks_then_four_from_the_checkpoint(meshed, root):
    """``launch.train --devices 2`` alone (it spawns two ranks) to step 2,
    then ``--devices 4`` run by four ranks as ``torchrun`` starts them,
    restoring that checkpoint re-sharded, to step 4."""
    assert meshed["cli"] == 0
    assert [r["cli"] for r in meshed[4]] == [0, 0, 0, 0]
    assert CheckpointStore(str(root / "cli")).all_steps() == [2, 4]
