"""Tensor-parallel QAT training over 'model' of the MoE archs and whisper ==
one device, by the contract.

The contract (README, "Training on a device mesh") extends the dense
decoders' (``tests/test_torch_tensor_parallel_train.py``) to olmoe-1b-7b
(expert parallelism: the router by its experts' columns, each bank by
whole experts), deepseek-v2-lite-16b (MLA by heads: q, uk and uv by
columns, o by rows, dkv and ``kv_norm`` whole; a dense first layer; two
shared experts column- and row-parallel) and whisper-base (both stacks'
attention and MLPs, the cross attention's K/V whole and cut to the rank's
heads).  It is held to the port's own one-device step on the same global
batch (itself held to ``repro`` op by op), M microbatches on one device
for M = the data ranks, at reduced configs that split over four 'model'
ranks (8 experts, 4 heads):

* bitwise: the routed-expert block -- router, dispatch, banks, gate and
  combine, without the shared experts -- its output and every gradient
  (x's, the router's, each expert's ``w``/``gw``/``ga``) on (1, 2) and
  (1, 4); every leaf whole on every 'model' rank equal across those ranks
  after every step; the checkpoint's files;
* the losses before any update (steps 0 and 1) within ``FORWARD_RTOL``
  (measured: 0.0 on every cell);
* every parameter leaf's first moment after step 0 within ``FIRST_RTOL``
  relative L2 (measured: at most 7.7e-5, a ``gw``), and every parameter
  leaf after 3 steps at peak lr 0.1 within ``LEAF_RTOL`` (measured: at
  most 6.0e-4 but on deepseek's (2, 2) cell), the LSQ step sizes there
  within ``STEP_LEAF_RTOL``: deepseek on (2, 2) reads 2.235e-2 at a
  ``ga``.  Two per-tensor ``gw`` of column shards (a sum of partial sums
  in another order) land one f32 ulp from one device's after the first
  update; at step 2 that ulp flips activation roundings and two tokens'
  routing, and a step size's gradient, a sum of LSQ terms that cancel,
  moves its AdamW update by about its size.  The weights of that cell
  stay within 1.9e-3 and the router within 2.8e-3.
* whisper trains on its frames, as ``launch.train`` and the ``Trainer``
  feed it: on zero frames its encoder sees the positions alone, the same
  in every row, its step sizes' gradients cancel to 2e-8, and the first
  moment of an encoder ``k``'s ``ga`` reads 6.25e-2 (one device's own
  arithmetic in another order moves such a sum as far);
* against ``repro``'s (1, 2) meshed ``Trainer`` (2 forced host devices,
  its own process, started first): olmoe's and deepseek's losses before
  any update within ``REF_FORWARD_RTOL`` (the gaps printed); ``repro``'s
  own (1, 2) program is up to 6.4e-4 from its (2, 1) program there.
  ``repro`` does not restart whisper on (1, 2) (ROADMAP Queue 3, R9).

Planted faults, each run against a copy of ``src`` (CPU readings):

* the router scored through ``router_logits``' gather of scores, which
  has no backward (on the CPU its parts come back as bytes): the router
  gets no gradient at all, the routed block's router and x gradients are
  not one device's, first moments up to 2.0 (a step size's; the
  router's 1.0); the whole leaves stay equal across the ranks, every
  rank dropping the same gradient;
* the dispatch's backward summed as rank partials (each rank's slots
  added in bf16, the partials summed over 'model'): the routed block's x
  cotangent differs in 183 of 2048 values at top 4 (at the reduced
  configs' top 2 the two orders give the same bits, so the whole-model
  cells pass);
* the gate cotangents left unsummed (each rank its own experts'): the
  routed block's router gradient differs, first moments up to 5.0,
  whole leaves differ;
* k_rope's cotangent left partial (each rank's heads added, no
  gather): deepseek's first moments up to 10.0 (``dkv``'s ``ga``),
  whole leaves differ;
* whisper's cross K/V cotangents left partial (a plain cut): the
  encoder's first moments up to 2.8 and more, its leaves after 3 steps
  up to 1.3 (a layernorm bias), whole leaves differ.

ONE spawn of four gloo ranks runs every meshed case: first two (1, 2)
sub-meshes side by side, then the (2, 2) and (1, 4) meshes of the whole
world; the parent runs the one-device side meanwhile.  Every rank
computes on one thread.  The module imports no JAX at its top: the ranks
import it to find the case functions.
"""
import concurrent.futures
import dataclasses
import hashlib
import os
import shutil
import time
from pathlib import Path
from types import SimpleNamespace

import numpy as np
import pytest
import torch

from repro_torch import configs
from repro_torch.checkpoint import CheckpointStore
from repro_torch.data.pipeline import SyntheticLM
from repro_torch.launch import mesh as mesh_lib
from repro_torch.launch import steps as steps_lib
from repro_torch.launch import train as launch_train
from repro_torch.models import transformer as TR
from repro_torch.nn import moe as nnmoe
from repro_torch.nn import param as nnp
from repro_torch.nn import partitioning as part
from repro_torch.runtime.train import TrainLoopConfig, Trainer
from repro_torch.tree import flatten_with_paths, unflatten

OLMOE, DEEPSEEK, WHISPER = ("olmoe-1b-7b", "deepseek-v2-lite-16b",
                            "whisper-base")
ARCHS = (OLMOE, DEEPSEEK, WHISPER)
SEQ, B, STEPS, LR = 16, 4, 3, 0.1
FORWARD_RTOL = 1e-6
FIRST_RTOL = 2e-2
LEAF_RTOL = 2e-2
STEP_LEAF_RTOL = 5e-2
# repro's (1, 2) meshed program is itself up to 6.4e-4 from its (2, 1)
# program before any update (ROADMAP 16b (iv) (b))
REF_FORWARD_RTOL = 2e-3


def _api(arch, m):
    return dataclasses.replace(configs.get(arch, reduced=True),
                               microbatches=m)


def _numpy(tree):
    return {k: v.detach().float().numpy().copy()
            for k, v in flatten_with_paths(tree).items()}


def _whole_digests(state, sh):
    """{path: sha256 of this rank's bytes} of every leaf no 'model' axis
    cuts (the leaves that must be equal across the 'model' ranks)."""
    flat, shs = flatten_with_paths(state), flatten_with_paths(sh)
    out = {}
    for k, v in flat.items():
        if not part.is_cut(shs[k], "model"):
            t = v.detach().contiguous().reshape(-1)
            out[k] = hashlib.sha256(t.view(torch.uint8).numpy()).hexdigest()
    return out


def _pipe(api):
    return SyntheticLM(vocab=api.cfg.vocab, seq_len=SEQ, global_batch=B,
                       seed=0, with_frames=api.needs_frames,
                       n_audio=getattr(api.cfg, "n_audio", 0),
                       d_model=api.cfg.d_model)


def _batches(api, mesh):
    """The steps' batches (with whisper's frames) -> [dict of tensors], the
    rank's rows."""
    out = []
    for i in range(STEPS):
        got = {k: torch.as_tensor(v)
               for k, v in _pipe(api).batch_at(i).items()}
        if mesh is not None:
            rules = steps_lib.batch_rules_for(part.TRAIN_RULES, B, mesh)
            rows = part.sharding_for(("batch",), mesh, rules)
            got = {k: v[part.local_index(tuple(v.shape), rows)]
                   for k, v in got.items()}
        out.append({k: v.long() if not v.is_floating_point() else v
                    for k, v in got.items()})
    return out


def run_steps(mesh, arch, m):
    """``make_train_step`` of ``arch`` (M = ``m``) for ``STEPS`` steps at
    peak lr ``LR`` from the seeded init, on ``mesh`` (None: one device) ->
    losses, the whole leaves' digests after each step, the rank's
    coordinates and (rank 0, one device) the first moments after step 0
    and the whole final state."""
    api = _api(arch, m)
    state = steps_lib.init_train_state(api, torch.Generator().manual_seed(0),
                                       device="cpu")
    sh = None
    if mesh is not None:
        sh = steps_lib.train_state_shardings(api, mesh)
        state = part.shard_by(state, sh)
    step = steps_lib.make_train_step(api, peak_lr=LR, total_steps=STEPS,
                                     donate=True, mesh=mesh)
    out = {"losses": [], "digests": []}
    lead = True
    if mesh is not None:
        out["coords"] = (mesh_lib.data_coords(mesh)[0],
                         mesh_lib.model_coords(mesh)[0])
        lead = out["coords"] == (0, 0)
    for i, batch in enumerate(_batches(api, mesh)):
        state, mt = step(state, batch)
        out["losses"].append(float(mt["loss"]))
        if mesh is not None:
            out["digests"].append(_whole_digests(state, sh))
        if i == 0:
            first = state["opt"]["m"]
            if mesh is not None:
                first = part.gather_by(first, sh["opt"]["m"])
            if lead:
                out["first"] = _numpy(first)
    if mesh is not None:
        state = part.gather_by(state, sh)
    if lead:
        out["state"] = _numpy(state)
    return out


# --- the routed-expert block, rank side --------------------------------------


def _moe_block(arch):
    """(the routed block's config -- the shared experts dropped, each token
    routed to 4 of the 8 experts -- its parameters at the seeded init, x,
    the output's cotangent).  Top 4, not the reduced configs' top 2: a
    token's cotangents from two slots add to the same bits in either
    order, so only three or more show the dispatch's order."""
    api = configs.get(arch, reduced=True)
    cfg = dataclasses.replace(api.cfg.moe, n_shared=0, topk=4)
    spec = nnmoe.moe_spec(cfg)
    p = nnp.init_params(spec, torch.Generator().manual_seed(3), device="cpu")
    rng = np.random.default_rng(5)
    x = torch.from_numpy(rng.standard_normal((2, SEQ, cfg.d_model)).astype(
        np.float32)).to(torch.bfloat16)
    cot = torch.from_numpy(rng.standard_normal(tuple(x.shape)).astype(
        np.float32)).to(torch.bfloat16)
    return api, cfg, spec, p, x, cot


def moe_block(arch, mesh):
    """The routed block forward and backward -> its output and every
    gradient, the rank's blocks of the parameters' (whole on one device)."""
    api, cfg, spec, p, x, cot = _moe_block(arch)
    if mesh is not None:
        p = part.shard_by(p, part.tree_shardings(nnp.axes_tree(spec), mesh,
                                                 part.TRAIN_RULES))
    live = {k: v.clone().requires_grad_()
            for k, v in flatten_with_paths(p).items()}
    x = x.clone().requires_grad_()
    y = nnmoe.moe_apply(unflatten(p, list(live.values())), x, api.policy,
                        cfg, serve=False, mesh=mesh)
    y.backward(cot)
    return {"y": y.detach().float().numpy(), "x": x.grad.float().numpy(),
            **{k: (v.grad if v.grad is not None else torch.zeros_like(v))
               .float().numpy() for k, v in live.items()}}


def case_moe_blocks(mesh):
    return {arch: moe_block(arch, mesh) for arch in (OLMOE, DEEPSEEK)}


# --- the Trainer cases, rank side --------------------------------------------


def _trainer(mesh, arch, d, total, every, m):
    api = _api(arch, m)
    tr = Trainer(api, _pipe(api), TrainLoopConfig(
        total_steps=total, ckpt_every=every, ckpt_dir=str(d),
        log_every=100, async_ckpt=False, peak_lr=LR), device="cpu",
        mesh=mesh)
    state, history = tr.run(torch.Generator().manual_seed(0))
    whole = part.gather_by(state, tr.state_sharding) if mesh else state
    return {"history": history,
            "state": _numpy(whole) if mesh_lib.rank_of(mesh) == 0 else None}


def case_repro(mesh, root):
    """The port's (1, 2) ``Trainer`` of olmoe and deepseek from ``repro``'s
    step-0 states (its process's checkpoints in the port's tree), the two
    steps before any update, on ranks 0-1 (rank 0 writes)."""
    _wait_for(root / "repro" / "ready", root / "repro" / "failed")
    out = {}
    for arch in (OLMOE, DEEPSEEK):
        d = root / "repro" / f"tp-{arch}"
        if mesh_lib.rank_of(mesh) == 0:
            shutil.copytree(root / "repro" / f"train0-{arch}", d)
        mesh_lib.barrier(mesh)
        out[arch] = _trainer(mesh, arch, d, 2, 100, 2)["history"]
    return out


def case_ckpt22(mesh, root):
    """deepseek's (2, 2) ``Trainer`` to step 2, saving there (expert banks
    cut on 'experts', MLA leaves); its files against a one-device save of
    the gathered state."""
    d = root / "ckpt22"
    out = _trainer(mesh, DEEPSEEK, d, 2, 2, 2)
    if mesh_lib.rank_of(mesh) == 0:
        api = _api(DEEPSEEK, 2)
        _, whole = CheckpointStore(str(d)).restore(
            steps_lib.train_state_specs(api))
        CheckpointStore(str(root / "ckpt22-one")).save(2, whole)
        (root / "ckpt22-ready").touch()
    return out


def case_restore14(mesh, root):
    """(2, 2)'s step-2 checkpoint restored onto (1, 4): each rank's blocks
    against the whole; then the ``Trainer`` from it to step 3."""
    _wait_for(root / "ckpt22-ready", root / "abandon")
    api = _api(DEEPSEEK, 2)
    sh = steps_lib.train_state_shardings(api, mesh)
    store = CheckpointStore(str(root / "ckpt22"))
    _, mine = store.restore(steps_lib.train_state_specs(api), shardings=sh)
    _, whole = store.restore(steps_lib.train_state_specs(api))
    wf, shf = flatten_with_paths(whole), flatten_with_paths(sh)
    blocks = all(torch.equal(v, wf[k][part.local_index(tuple(wf[k].shape),
                                                       shf[k])])
                 for k, v in flatten_with_paths(mine).items())
    cut = sorted(k for k in shf if part.is_cut(shf[k], "model"))
    d = root / "restart14"
    if mesh_lib.rank_of(mesh) == 0:
        shutil.copytree(root / "ckpt22", d)
    mesh_lib.barrier(mesh)
    out = _trainer(mesh, DEEPSEEK, d, 3, 100, 2)
    out.update(blocks=blocks, cut=cut)
    return out


def _wait_for(path, failed):
    deadline = time.monotonic() + 300
    while not path.exists():
        if failed.exists() or time.monotonic() > deadline:
            raise RuntimeError(f"{path} did not appear")
        time.sleep(0.2)


# --- the ranks ---------------------------------------------------------------


def _sub_mesh(rank):
    """The (1, 2) mesh of this rank's pair (ranks 0-1 or 2-3) of a world of
    four, each pair's host group its own."""
    import torch.distributed as dist
    from torch.distributed.device_mesh import DeviceMesh
    got = None
    for pair in ([0, 1], [2, 3]):
        m = DeviceMesh("cpu", torch.tensor([pair]),
                       mesh_dim_names=("data", "model"))
        group = dist.new_group(pair, backend="gloo")
        if rank in pair:
            m.repro_info = mesh_lib.MeshInfo(device=torch.device("cpu"),
                                             backend="gloo",
                                             host_group=group)
            got = m
    return got


PAIR_CASES = {
    0: {"moe_blocks": case_moe_blocks,
        f"lm:{OLMOE}": lambda mesh: run_steps(mesh, OLMOE, 1),
        "repro": None},
    2: {f"lm:{DEEPSEEK}": lambda mesh: run_steps(mesh, DEEPSEEK, 1),
        f"lm:{WHISPER}": lambda mesh: run_steps(mesh, WHISPER, 1)},
}


def _rank4(rank, root):
    torch.set_num_threads(1)
    root = Path(root)
    out = {}
    pair = _sub_mesh(rank)
    lead = 0 if rank < 2 else 2
    for name, fn in PAIR_CASES[lead].items():
        out[f"{name}@1x2"] = (fn(pair) if fn is not None
                              else case_repro(pair, root))
    mesh = mesh_lib.make_train_mesh((2, 2), device="cpu")
    for arch in ARCHS:
        out[f"lm:{arch}@2x2"] = run_steps(mesh, arch, 2)
    out["ckpt@2x2"] = case_ckpt22(mesh, root)
    # ``launch.train --mesh 2x2`` of whisper in the world of four
    out["cli@2x2"] = launch_train.main([
        "--arch", WHISPER, "--reduced", "--batch", str(B), "--seq",
        str(SEQ), "--device", "cpu", "--ckpt-dir", str(root / "cli22"),
        "--steps", "2", "--mesh", "2x2"])
    mesh = mesh_lib.make_train_mesh((1, 4), device="cpu")
    out["moe_blocks@1x4"] = case_moe_blocks(mesh)
    for arch in ARCHS:
        out[f"lm:{arch}@1x4"] = run_steps(mesh, arch, 1)
    out["restore@1x4"] = case_restore14(mesh, root)
    out["cli@1x4"] = launch_train.main([
        "--arch", OLMOE, "--reduced", "--batch", str(B), "--seq",
        str(SEQ), "--device", "cpu", "--ckpt-dir", str(root / "cli14"),
        "--steps", "2", "--mesh", "1x4"])
    return out


# --- repro's meshed Trainer, in a process of its own ------------------------


def _repro_env():
    os.environ["XLA_FLAGS"] = " ".join(filter(None, (
        os.environ.get("XLA_FLAGS"),
        "--xla_force_host_platform_device_count=2",
        "--xla_cpu_multi_thread_eigen=false",
        "intra_op_parallelism_threads=1")))
    os.environ["JAX_PLATFORMS"] = "cpu"


def _repro_trainer(arch, root, total, every=100):
    """``repro``'s ``Trainer`` of ``arch`` (reduced, M = 2, B = 4 x 16,
    peak lr ``LR``) on a (1, 2) ('data', 'model') mesh of 2 forced host
    devices, its checkpoints under ``root / ref-{arch}``."""
    from repro import configs as jconfigs
    from repro.data.pipeline import SyntheticLM as JSyntheticLM
    from repro.launch import mesh as jmesh
    from repro.runtime.train import TrainLoopConfig as JCfg
    from repro.runtime.train import Trainer as JTrainer
    api = jconfigs.get(arch, reduced=True)
    api.microbatches = 2
    pipe = JSyntheticLM(vocab=api.cfg.vocab, seq_len=SEQ, global_batch=B,
                        seed=0, with_frames=api.needs_frames,
                        n_audio=getattr(api.cfg, "n_audio", 0),
                        d_model=api.cfg.d_model)
    ref = root / f"ref-{arch}"
    return api, ref, JTrainer(api, pipe, jmesh._make_mesh(
        (1, 2), ("data", "model")), JCfg(
        total_steps=total, ckpt_every=every, ckpt_dir=str(ref),
        log_every=100, async_ckpt=False, peak_lr=LR))


def _repro_meshed(root):
    """``repro``'s (1, 2) ``Trainer`` of olmoe and deepseek for the two
    steps before any update, each step-0 state rewritten in the port's
    tree under ``train0-{arch}`` -> losses."""
    root = Path(root)
    try:
        _repro_env()
        import jax
        from repro.checkpoint import CheckpointStore as JStore
        from repro.launch import steps as jsteps
        from repro_torch import convert
        trainers = {}
        for arch in (OLMOE, DEEPSEEK):
            api, ref, tr = _repro_trainer(arch, root, 2)
            tr.store.save(0, tr.init_or_restore(jax.random.PRNGKey(0)))
            _, st = JStore(str(ref)).restore(jsteps.train_state_specs(api),
                                             step=0)
            CheckpointStore(str(root / f"train0-{arch}")).save(
                0, convert.from_jax_train_state(jax.tree.map(np.asarray, st),
                                                device="cpu"))
            trainers[arch] = tr
        (root / "ready").touch()
        return {arch: [float(h) for h in tr.run(jax.random.PRNGKey(0))[1]]
                for arch, tr in trainers.items()}
    except BaseException:
        (root / "failed").touch()
        raise


def _repro_whisper_restart(root):
    """``repro``'s (1, 2) ``Trainer`` of whisper one step, saving it; then
    a second ``Trainer`` there restores it and runs to step 3 -> None, or
    the error it raises (R9)."""
    root = Path(root)
    _repro_env()
    import jax
    _repro_trainer(WHISPER, root, 1, every=1)[2].run(jax.random.PRNGKey(0))
    try:
        _repro_trainer(WHISPER, root, 3)[2].run(jax.random.PRNGKey(0))
    except ValueError as e:
        return f"{type(e).__name__}: {e}"
    return None


def _into(queue, fn, *args):
    """``fn(*args)`` in a process of its own, its value (or the error's
    traceback) put on ``queue``."""
    try:
        queue.put(("ok", fn(*args)))
    except BaseException:
        import traceback
        queue.put(("error", traceback.format_exc()))


class _Started:
    """``fn(*args)`` started in a spawned process; ``get`` waits for its
    value, ``stop`` kills the process (a JAX process may not end on
    SIGTERM)."""

    def __init__(self, fn, *args):
        import torch.multiprocessing as mp
        ctx = mp.get_context("spawn")
        self.queue = ctx.Queue()
        self.proc = ctx.Process(target=_into, args=(self.queue, fn) + args)
        self.proc.start()

    def get(self, timeout):
        status, value = self.queue.get(timeout=timeout)
        if status != "ok":
            raise RuntimeError(value)
        return value

    def stop(self):
        self.proc.kill()
        self.proc.join()


# --- fixtures ----------------------------------------------------------------


@pytest.fixture(scope="module")
def root(tmp_path_factory):
    return tmp_path_factory.mktemp("tpf")


@pytest.fixture(scope="module")
def repro_run(root):
    """``_repro_meshed`` and ``_repro_whisper_restart``, started first,
    each in a process of its own."""
    (root / "repro").mkdir()
    procs = (_Started(_repro_meshed, str(root / "repro")),
             _Started(_repro_whisper_restart, str(root / "repro")))
    try:
        yield procs
    finally:
        for p in procs:
            p.stop()


@pytest.fixture(scope="module")
def world(repro_run, root):
    """The world of four, in a thread of the parent."""
    def guarded():
        try:
            return mesh_lib.spawn(_rank4, 4, (str(root),),
                                  store_dir=str(root / "store"),
                                  timeout_s=400)
        except BaseException:
            (root / "abandon").touch()
            raise
    pool = concurrent.futures.ThreadPoolExecutor(1)
    try:
        yield pool.submit(guarded)
    finally:
        pool.shutdown(wait=True)


@pytest.fixture(scope="module")
def single(world, root):
    """Each case on one device in the parent, at one thread, while the
    ranks run."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    try:
        out = {f"lm:{a}@{m}": run_steps(None, a, m)
               for a in ARCHS for m in (1, 2)}
        out["moe_blocks"] = case_moe_blocks(None)
        try:
            _wait_for(root / "ckpt22-ready", root / "abandon")
        except RuntimeError:
            world.result()   # the ranks' own error, where they failed
            raise
        d = root / "restart-one"
        shutil.copytree(root / "ckpt22", d)
        out["restart"] = _trainer(None, DEEPSEEK, d, 3, 100, 2)
        return out
    finally:
        torch.set_num_threads(threads)


@pytest.fixture(scope="module")
def ranks(world, single):
    return world.result(timeout=600)


@pytest.fixture(scope="module")
def reference(repro_run, ranks):
    return {"history": repro_run[0].get(timeout=300),
            "whisper": repro_run[1].get(timeout=300)}


# cell -> (the ranks' result key, the one-device result key)
CELLS = {f"{a} {shape}": (f"lm:{a}@{key}", f"lm:{a}@{m}")
         for a in ARCHS for shape, key, m in (("(1, 2)", "1x2", 1),
                                              ("(2, 2)", "2x2", 2),
                                              ("(1, 4)", "1x4", 1))}


def _rel(a, b):
    a, b = a.astype(np.float64), b.astype(np.float64)
    return float(np.linalg.norm(a - b) / max(np.linalg.norm(b), 1e-30))


def _step_size(path):
    return path.endswith(("['ga']", "['gw']"))


# --- the pieces --------------------------------------------------------------


def test_routed_moe_block_bitwise_one_device(ranks, single):
    """olmoe's and deepseek's routed blocks on (1, 2) and (1, 4): the
    output and x's gradient the one-device block's bitwise on every rank,
    the router's gradient its columns' and each bank's its experts'."""
    for shape in ("1x2", "1x4"):
        got = [r[f"moe_blocks@{shape}"] for r in ranks
               if f"moe_blocks@{shape}" in r]
        m = len(got)
        assert m == int(shape[-1])
        for arch in (OLMOE, DEEPSEEK):
            one = single["moe_blocks"][arch]
            for r, g in enumerate(got):
                g = g[arch]
                assert g.keys() == one.keys()
                for k, want in one.items():
                    if k in ("y", "x"):
                        np.testing.assert_array_equal(g[k], want, err_msg=k)
                    elif "router" in k:
                        e = want.shape[-1] // m
                        np.testing.assert_array_equal(
                            g[k], want[..., r * e:(r + 1) * e], err_msg=k)
                    else:   # a bank leaf: its experts
                        e = want.shape[0] // m
                        np.testing.assert_array_equal(
                            g[k], want[r * e:(r + 1) * e], err_msg=k)
                assert np.abs(g["['router']"]).max() > 0


# --- the contract, cell by cell --------------------------------------------


def test_losses_before_any_update(ranks, single, capsys):
    gaps = {}
    for cell, (mk, ok) in CELLS.items():
        got = next(r[mk] for r in ranks if mk in r)["losses"]
        want = single[ok]["losses"]
        assert [r[mk]["losses"] for r in ranks if mk in r] == \
            [got] * sum(mk in r for r in ranks), cell   # every rank alike
        gaps[cell] = max(abs(a - b) / abs(b)
                         for a, b in zip(got[:2], want[:2]))
    with capsys.disabled():
        print(f"\n[tp-train-families] losses before any update, relative "
              f"gaps: {gaps}")
    assert max(gaps.values()) <= FORWARD_RTOL, gaps


def test_first_moments_within_bound(ranks, single, capsys):
    """Every parameter leaf's first moment after step 0 (0.1 x the clipped
    gradient at the seeded init, before any update) within
    ``FIRST_RTOL`` relative L2 of one device's."""
    worst = {}
    for cell, (mk, ok) in CELLS.items():
        lead = next(r[mk] for r in ranks if "first" in r.get(mk, {}))
        want = single[ok]["first"]
        assert lead["first"].keys() == want.keys()
        worst[cell] = max((_rel(lead["first"][k], want[k]), k)
                          for k in want)
    with capsys.disabled():
        print(f"\n[tp-train-families] worst first moment after step 0 "
              f"(relative L2): " + ", ".join(f"{c} {v:.3e} {k}"
                                             for c, (v, k) in worst.items()))
    assert max(v for v, _ in worst.values()) <= FIRST_RTOL, worst


def test_every_leaf_after_three_steps_within_bound(ranks, single, capsys):
    """Every parameter leaf after 3 steps: the step sizes within
    ``STEP_LEAF_RTOL``, every other leaf within ``LEAF_RTOL``."""
    worst = {}
    for cell, (mk, ok) in CELLS.items():
        lead = next(r[mk] for r in ranks if "state" in r.get(mk, {}))
        got, want = lead["state"], single[ok]["state"]
        assert got.keys() == want.keys()
        params = [k for k in want if k.startswith("['params']")]
        worst[cell] = (
            max((_rel(got[k], want[k]), k) for k in params
                if not _step_size(k)),
            max((_rel(got[k], want[k]), k) for k in params
                if _step_size(k)))
    with capsys.disabled():
        print(f"\n[tp-train-families] worst parameter leaf after {STEPS} "
              f"steps (relative L2; step sizes apart): " + ", ".join(
                  f"{c} {w[0]:.3e} {w[1]}, {s[0]:.3e} {s[1]}"
                  for c, (w, s) in worst.items()))
    assert max(w[0] for w, _ in worst.values()) <= LEAF_RTOL, worst
    assert max(s[0] for _, s in worst.values()) <= STEP_LEAF_RTOL, worst


def test_whole_leaves_bitwise_across_model_ranks_every_step(ranks):
    for cell, (mk, _) in CELLS.items():
        by_row = {}
        for r in ranks:
            if mk in r:
                by_row.setdefault(r[mk]["coords"][0], []).append(
                    r[mk]["digests"])
        for row, steps in by_row.items():
            assert len(steps) > 1 and all(s == steps[0] for s in steps), \
                (cell, row)
            assert all(len(d) for d in steps[0])


def test_checkpoint_reshards_across_meshes(ranks, single, root):
    """deepseek's (2, 2) step-2 save: its files those of a one-device save
    of the gathered state; restored onto (1, 4) each rank's blocks bitwise
    (the expert banks cut on 'experts', MLA's q/uk/uv/o, the router); the
    (1, 4) and one-device restarts from it to step 3 within the bounds;
    ``launch.train --mesh`` trains whisper on (2, 2) and olmoe on (1, 4)."""
    def files(d):
        p = Path(d) / f"step_{2:010d}"
        return {f.name: hashlib.sha256(f.read_bytes()).hexdigest()
                for f in sorted(p.iterdir())}
    assert files(root / "ckpt22") == files(root / "ckpt22-one")
    assert all(r["restore@1x4"]["blocks"] for r in ranks)
    cut = ranks[0]["restore@1x4"]["cut"]
    for leaf in ("['moe']['gate']['w']", "['moe']['router']",
                 "['attn']['uk']['w']", "['attn']['o']['w']"):
        assert any(k.startswith("['params']") and k.endswith(leaf)
                   for k in cut), leaf
    got, want = ranks[0]["restore@1x4"], single["restart"]
    assert got["history"][0] == pytest.approx(want["history"][0],
                                              rel=FORWARD_RTOL)
    for k in want["state"]:
        if k.startswith("['params']"):
            bound = STEP_LEAF_RTOL if _step_size(k) else LEAF_RTOL
            assert _rel(got["state"][k], want["state"][k]) <= bound, k
    assert all(r["cli@2x2"] == 0 and r["cli@1x4"] == 0 for r in ranks)
    assert CheckpointStore(str(root / "cli22")).latest_step() == 2
    assert CheckpointStore(str(root / "cli14")).latest_step() == 2


def test_losses_agree_with_repros_meshed_trainer(ranks, reference, capsys):
    """The port's (1, 2) ``Trainer`` of olmoe and deepseek from ``repro``'s
    step-0 states against ``repro``'s (1, 2) ``Trainer``: the losses
    before any update within ``REF_FORWARD_RTOL``."""
    got = ranks[0]["repro@1x2"]
    gaps = {}
    for arch in (OLMOE, DEEPSEEK):
        want = reference["history"][arch]
        assert len(got[arch]) == len(want) == 2
        gaps[arch] = [abs(a - b) / abs(b) for a, b in zip(got[arch], want)]
    with capsys.disabled():
        print(f"\n[tp-train-families] vs repro's (1, 2) Trainer, losses "
              f"before any update: port {got}, repro "
              f"{reference['history']}, relative gaps {gaps}")
    assert max(max(g) for g in gaps.values()) <= REF_FORWARD_RTOL, gaps


def test_repro_does_not_restart_whisper_on_a_model_axis(reference):
    """R9: ``repro``'s ``Trainer`` trains whisper-base one step on a (1, 2)
    mesh and saves it, but a ``Trainer`` that restores that checkpoint
    there refuses to step: its jit is given a stacked encoder projection
    laid out on 'model' where it expects 'data'.  So ``repro`` gives no
    meshed whisper run to hold the port to past one step, and the port
    holds whisper to its own one-device step."""
    if reference["whisper"] is None:
        pytest.skip("repro restarts whisper-base on a (1, 2) mesh now: R9 "
                    "is gone")
    assert "Sharding passed to jit does not match" in reference["whisper"]


# --- on one process ----------------------------------------------------------


def _stand_in(shape):
    names = ("data", "model") if len(shape) == 2 else ("pod", "data",
                                                        "model")
    return SimpleNamespace(axis_names=names, devices=np.zeros(shape),
                           get_local_rank=lambda ax: 0)


def test_dense_prefix_mlp_with_a_whole_up_runs_whole():
    """deepseek's dense first layer (width ``dense_ff``) whose ``up`` was
    kept whole on a 'model' axis of 4 runs whole, as on one device: its
    width is compared with the layer's own, not with ``d_ff`` -- the
    reduced config's 128 / 4 = 32 = ``d_ff`` -- so no collective runs (a
    stand-in mesh without a process group would raise on one)."""
    api = configs.get(DEEPSEEK, reduced=True)
    cfg = api.cfg
    assert TR.mlp_width(cfg, 0) == cfg.dense_ff != cfg.d_ff
    assert TR.mlp_width(cfg, 1) == cfg.d_ff
    lp = nnp.strip_markers(api.init_params(torch.Generator().manual_seed(1),
                                           "train", device="cpu"))[
        "layers"][0]
    assert lp["mlp"]["up"]["w"].shape[-1] == cfg.dense_ff
    x = torch.from_numpy(np.random.default_rng(2).standard_normal(
        (2, 8, cfg.d_model)).astype(np.float32)).to(torch.bfloat16)
    want = TR._apply_mlp(cfg, lp, x, api.policy, "torch", "l0.",
                         serve=False, ff=cfg.dense_ff)
    got = TR._apply_mlp(cfg, lp, x, api.policy, "torch", "l0.", serve=False,
                        mesh=_stand_in((1, 4)), ff=TR.mlp_width(cfg, 0))
    assert torch.equal(got, want)
