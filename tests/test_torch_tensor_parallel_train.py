"""Tensor-parallel QAT training over 'model' == one device, by the contract.

The contract (README, "Training on a device mesh"): a rank of a (data,
model) mesh keeps its 'model' blocks of the train state under
``TRAIN_RULES`` -- q, gate, up, the head and every conv by columns, o and
down by rows, the embedding by vocabulary rows, k/v, the norms and BN
whole -- and its FSDP blocks over 'data'; every 'model' rank of a data
row runs that row's batch.  A bf16 row shard summed over the ranks, and a
sum of partial cotangents or step-size gradients, add in an order that
one device's product does not use, so the step is held to the port's own
one-device step on the same global batch (itself held to ``repro`` op by
op), M microbatches on one device for M = the data ranks:

* bitwise where data only moves: the collectives' all-gathers and owned
  sums, the embedding's forward, every leaf that is whole on every
  'model' rank after every step equal across those ranks (norm scales,
  k/v, ``gw``/``ga`` of whole layers, BN, ``step``), the checkpoint's
  files;
* the losses before any update (steps 0 and 1: the lr is 0 at step 0)
  within ``FORWARD_RTOL`` (measured: 0.0 on (1, 2) and (1, 4), 8.9e-8 on
  (2, 2), where the data rows' f32 gradient sum is one device's
  microbatch sum in another order);
* every parameter leaf's first moment after step 0 (0.1 x the first
  clipped gradient, before any update) within ``FIRST_RTOL`` relative L2
  (measured: at most 5.3e-3, a ResNet ``gw`` on (1, 2)), and every
  parameter leaf after 3 steps at peak lr 0.1 within ``LEAF_RTOL``
  (measured: at most 9.1e-3, a ``ga`` on (2, 2), whose gradient is a
  sum of LSQ terms that cancel and whose AdamW update follows its sign).
  Planted faults, each run against a copy of ``src``, read (first
  moments; leaves after 3 steps): a column shard's per-tensor ``gw``
  gradient not summed 2.2 and more; 7.8e-2 to 7.5e-1; its input
  cotangent left partial 11.6 and more; 8.1e-2 to 1.6; a row layer's
  ``ga`` gradient not summed 1.0 and more; 4.6e-2 to 7.0e-2; k/v's
  cotangents not summed 13.5 and more; 7.1e-2 to 1.1e-1 (the cells whose
  heads split); one rank's row partial dropped 4.1 and more; 8.7e-2 to
  1.2e-1, and the losses 7.2e-4 to 1.1e-2 apart.  All but the last also
  break the whole leaves' equality across the ranks;
* against ``repro``'s (1, 2) meshed ``Trainer`` (2 forced host devices,
  its own process, started first): the losses within ``REF_FORWARD_RTOL``
  before any update and ``REF_LOSS_RTOL`` after (the gaps printed).  Not
  the data-parallel file's 1e-6 before the update: ``repro``'s (1, 2)
  program is 3.3e-4 from its own one-device program there (XLA fuses the
  sharded bf16 work otherwise), where its (2, 1) program was 8.2e-8 from
  the port.

ONE spawn of four gloo ranks runs every meshed case: first two (1, 2)
sub-meshes side by side (ranks 0-1 and 2-3, each case on one of them),
then the (2, 2) and (1, 4) meshes of the whole world; the parent runs the
one-device side meanwhile.  Every rank computes on one thread.  The
module imports no JAX at its top: the ranks import it to find the case
functions.
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
from repro_torch.core import quant
from repro_torch.core.precision import PrecisionPolicy
from repro_torch.data.pipeline import SyntheticImages, SyntheticLM
from repro_torch.launch import mesh as mesh_lib
from repro_torch.launch import steps as steps_lib
from repro_torch.launch import train as launch_train
from repro_torch.nn import layers as nnl
from repro_torch.nn import partitioning as part
from repro_torch.nn import quantized as Q
from repro_torch.runtime.train import TrainLoopConfig, Trainer
from repro_torch.tree import flatten_with_paths, leaves

GRANITE, NEMOTRON, RESNET = "granite-8b", "nemotron-4-340b", "resnet18"
SEQ, B, STEPS, LR = 16, 4, 3, 0.1
FORWARD_RTOL = 1e-6
LEAF_RTOL = 2e-2
STEP_GRAD_RTOL = 1e-5
FIRST_RTOL = 2e-2
# against repro's (1, 2) Trainer: its sharded XLA program is itself 3.3e-4
# (step 0) and 1.5e-4 (step 1) from its one-device program before any
# update; the port's (1, 2) step, bitwise its one-device step there, is
# 6.9e-6 and 2.6e-4 from it, and 8.6e-5 after the first update
REF_FORWARD_RTOL, REF_LOSS_RTOL = 5e-4, 1e-3
POLICY = PrecisionPolicy(inner_bits=4, k=4)


def _api(arch, m, **cfg):
    api = dataclasses.replace(configs.get(arch, reduced=True),
                              microbatches=m)
    if cfg:
        api.cfg = dataclasses.replace(api.cfg, **cfg)
    return api


def _numpy(tree):
    return {k: v.detach().float().numpy().copy()
            for k, v in flatten_with_paths(tree).items()}


def _shape(mesh):
    return "x".join(str(n) for n in part.axis_sizes(mesh).values())


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


def _batches(api, mesh):
    """The step's batches -> [dict of tensors] (the rank's rows)."""
    if api.family == "cnn":
        pipe = SyntheticImages(n_classes=api.cfg.n_classes,
                               img_size=api.cfg.img_size, global_batch=B,
                               seed=0)
        raw = [{"tokens": pipe.batch_at(i)["images"],
                "labels": pipe.batch_at(i)["labels"]} for i in range(STEPS)]
    else:
        pipe = SyntheticLM(vocab=api.cfg.vocab, seq_len=SEQ, global_batch=B,
                           seed=0)
        raw = [pipe.batch_at(i) for i in range(STEPS)]
    out = []
    for host in raw:
        got = {k: torch.as_tensor(v) for k, v in host.items()}
        if mesh is not None:
            rules = steps_lib.batch_rules_for(part.TRAIN_RULES, B, mesh)
            rows = part.sharding_for(("batch",), mesh, rules)
            got = {k: v[part.local_index(tuple(v.shape), rows)]
                   for k, v in got.items()}
        out.append({k: v.long() if not v.is_floating_point() else v
                    for k, v in got.items()})
    return out


def run_steps(mesh, arch, m, **cfg):
    """``make_train_step`` of ``arch`` (M = ``m``) for ``STEPS`` steps at
    peak lr ``LR`` from the seeded init, on ``mesh`` (None: one device) ->
    losses, grad norms, the whole leaves' digests after each step, the
    rank's coordinates and (rank 0, one device) the whole final state."""
    api = _api(arch, m, **cfg)
    state = steps_lib.init_train_state(api, torch.Generator().manual_seed(0),
                                       device="cpu")
    sh = None
    if mesh is not None:
        sh = steps_lib.train_state_shardings(api, mesh)
        state = part.shard_by(state, sh)
    step = steps_lib.make_train_step(api, peak_lr=LR, total_steps=STEPS,
                                     donate=True, mesh=mesh)
    out = {"losses": [], "norms": [], "digests": [],
           "zero": {k for k, v in flatten_with_paths(state).items()
                    if k.startswith("['params']") and not v.any()}}
    lead = True
    if mesh is not None:
        out["coords"] = (mesh_lib.data_coords(mesh)[0],
                         mesh_lib.model_coords(mesh)[0])
        lead = out["coords"] == (0, 0)
    for i, batch in enumerate(_batches(api, mesh)):
        state, mt = step(state, batch)
        out["losses"].append(float(mt["loss"]))
        out["norms"].append(float(mt["grad_norm"]))
        if mesh is not None:
            out["digests"].append(_whole_digests(state, sh))
        if i == 0:   # the first moment: 0.1 x the first clipped gradient
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


# --- the layer and collective cases, rank side --------------------------------


def _grid(shape, seed, scale, lo, hi):
    """Values on a quantization grid: integers in [lo, hi] times
    ``scale`` (a power of two), so every product and sum below is exact."""
    rng = np.random.default_rng(seed)
    return torch.from_numpy(rng.integers(lo, hi + 1, size=shape)
                            .astype(np.float32) * scale)


def case_collectives(mesh):
    """The four collectives' forward and backward on this rank -> values
    the parent holds against the one-device math."""
    r, m = mesh_lib.model_coords(mesh)
    rng = np.random.default_rng(7)
    whole = torch.from_numpy(rng.standard_normal((m, 3, 5)).astype(
        np.float32))
    cot = torch.from_numpy(rng.standard_normal((3, 5)).astype(np.float32))
    out = {}
    x = whole[r].clone().requires_grad_(True)
    y = mesh_lib.sum_model(mesh, x)
    y.backward(cot)
    out["sum"] = (y.detach().numpy(), x.grad.numpy())
    x = whole[r].clone().requires_grad_(True)
    y = mesh_lib.copy_model(mesh, x)
    y.backward(cot * (r + 1))    # each rank's partial cotangent
    out["copy"] = (y.detach().numpy(), x.grad.numpy())
    x = whole[r].clone().requires_grad_(True)
    y = mesh_lib.gather_model(mesh, x, 1)
    big = torch.from_numpy(rng.standard_normal((3, 5 * m)).astype(
        np.float32))
    y.backward(big)
    out["gather"] = (y.detach().numpy(), x.grad.numpy())
    owner = torch.from_numpy(rng.integers(0, m, size=(3, 1)))
    x = torch.where(owner == r, whole[r], torch.zeros(())).requires_grad_()
    y = mesh_lib.owned_model(mesh, x, owner)
    y.backward(cot)
    out["owned"] = (y.detach().numpy(), x.grad.numpy(), owner.numpy())
    return out


def _layer_data():
    # f32 activations (their step's gradient sums in f32, exactly) and
    # weights on the grids of ga 2^-4 and gw 2^-3, some past the clip
    # bounds (255; -8 and 7) so that the steps' gradients are not zero
    x = _grid((2, 3, 32), 1, 2.0 ** -4, 0, 300)
    w = _grid((32, 16), 2, 2.0 ** -3, -10, 10)
    cot = _grid((2, 3, 16), 3, 2.0 ** -6, -8, 8)
    return x, w, cot


def _layer(x, w, cot, channel=False, **kw):
    """A fake-quant linear at steps on the grid (ga 2^-4, gw 2^-3) -> its
    output and the gradients of x, w, gw and ga."""
    gw = torch.full((w.shape[-1],) if channel else (), 2.0 ** -3)
    p = {"w": w.clone().requires_grad_(), "gw": gw.requires_grad_(),
         "ga": torch.tensor(2.0 ** -4, requires_grad=True)}
    x = x.clone().requires_grad_()
    policy = dataclasses.replace(POLICY, channel_wise=channel)
    y = Q.qlinear_apply(p, x, policy, **kw)
    y.backward(cot.to(torch.bfloat16))
    return {"y": y.detach().float().numpy(), "x": x.grad.numpy(),
            "w": p["w"].grad.numpy(), "gw": p["gw"].grad.numpy(),
            "ga": p["ga"].grad.numpy()}


def case_layers(mesh):
    """Column- and row-parallel fake-quant linears (per-tensor and
    channel-wise ``gw``) and a column-parallel conv on this rank."""
    r, m = mesh_lib.model_coords(mesh)
    x, w, cot = _layer_data()
    n, k = w.shape[1] // m, w.shape[0] // m
    cols, rows = slice(r * n, (r + 1) * n), slice(r * k, (r + 1) * k)
    out = {}
    for channel in (False, True):
        out[f"col{int(channel)}"] = _layer(x, w[:, cols], cot[..., cols],
                                           channel, col_mesh=mesh)
        # a channel-wise gw is the rank's own columns' (col) or whole (row)
        out[f"row{int(channel)}"] = _layer(x[..., rows], w[rows], cot,
                                           channel, row_mesh=mesh)
    img, conv = _conv_data()
    c = 8 // m
    mine_conv = {k_: (v[:, r * c:(r + 1) * c] if k_ == "w" else v).clone()
                 .requires_grad_() for k_, v in conv.items()}
    img = img.requires_grad_()
    y = Q.qconv_apply(mine_conv, img, POLICY, k=3, mesh=mesh, cout=8)
    ycot = _grid(tuple(y.shape), 6, 2.0 ** -6, -8, 8).to(torch.bfloat16)
    y.backward(ycot)
    out["conv"] = {"y": y.detach().float().numpy(),
                   "x": img.grad.numpy(),
                   "w": mine_conv["w"].grad.numpy(),
                   "gw": mine_conv["gw"].grad.numpy(),
                   "ga": mine_conv["ga"].grad.numpy()}
    return out


def _conv_data():
    return (_grid((2, 5, 5, 4), 4, 2.0 ** -4, 0, 300),
            {"w": _grid((36, 8), 5, 2.0 ** -3, -10, 10),
             "gw": torch.tensor(2.0 ** -3), "ga": torch.tensor(2.0 ** -4)})


def one_device_conv():
    img, conv = _conv_data()
    conv = {k: v.clone().requires_grad_() for k, v in conv.items()}
    img = img.requires_grad_()
    y = Q.qconv_apply(conv, img, POLICY, k=3)
    y.backward(_grid(tuple(y.shape), 6, 2.0 ** -6, -8, 8).to(
        torch.bfloat16))
    return {"y": y.detach().float().numpy(), "x": img.grad.numpy(),
            "w": conv["w"].grad.numpy(), "gw": conv["gw"].grad.numpy(),
            "ga": conv["ga"].grad.numpy()}


def case_vocab_loss(mesh):
    """The vocabulary-parallel loss and its logits' gradient on this rank:
    a padded vocabulary of 16 (12 real), the padding's logits huge."""
    r, m = mesh_lib.model_coords(mesh)
    rng = np.random.default_rng(11)
    logits = torch.from_numpy(rng.standard_normal((2, 3, 16)).astype(
        np.float32)).to(torch.bfloat16)
    logits[..., 12:] = 60.0
    labels = torch.from_numpy(rng.integers(0, 12, size=(2, 3)))
    n = 16 // m
    mine = logits[..., r * n:(r + 1) * n].clone().requires_grad_()
    loss = steps_lib.cross_entropy(nnl.VocabShard(mine, mesh, r * n, 12),
                                   labels)
    loss.backward()
    return float(loss), mine.grad.float().numpy()


def case_norm(mesh):
    """The clip's norm over a tree of a 'model' shard and two whole
    leaves, on this rank."""
    r, m = mesh_lib.model_coords(mesh)
    g = _norm_tree()
    shard = g["cut"].shape[1] // m
    mine = {"cut": g["cut"][:, r * shard:(r + 1) * shard],
            "whole": g["whole"], "scale": g["scale"]}
    axes = {"cut": ("embed", "mlp"), "whole": ("embed", "kv_heads"),
            "scale": ("act_embed",)}
    sh = part.tree_shardings(axes, mesh, part.TRAIN_RULES)
    return float(steps_lib._model_global_norm(mesh, mine, sh))


def _norm_tree():
    rng = np.random.default_rng(5)
    f = lambda *s: torch.from_numpy(  # noqa: E731
        rng.standard_normal(s).astype(np.float32))
    return {"cut": f(8, 16), "whole": f(8, 4) * 3, "scale": f(8)}


def case_remat(mesh):
    """granite's step with remat off, 'full' and 'dots' -> losses and the
    whole final state of each (rank 0)."""
    return {pol: run_steps(mesh, GRANITE, 1, **kw) for pol, kw in (
        ("off", {"remat": False}), ("full", {"remat_policy": "full"}),
        ("dots", {"remat_policy": "dots"}))}


def _trainer(mesh, d, total, every, m=2):
    api = _api(GRANITE, m)
    pipe = SyntheticLM(vocab=api.cfg.vocab, seq_len=SEQ, global_batch=B,
                       seed=0)
    tr = Trainer(api, pipe, TrainLoopConfig(
        total_steps=total, ckpt_every=every, ckpt_dir=str(d),
        log_every=100, async_ckpt=False, peak_lr=LR), device="cpu",
        mesh=mesh)
    state, history = tr.run(torch.Generator().manual_seed(0))
    whole = part.gather_by(state, tr.state_sharding) if mesh else state
    return {"history": history,
            "state": _numpy(whole) if mesh_lib.rank_of(mesh) == 0 else None}


def case_repro(mesh, root):
    """The port's (1, 2) ``Trainer`` from ``repro``'s step-0 state (its
    process's checkpoint in the port's tree), 3 steps, on ranks 0-1 (rank
    0 writes the checkpoints)."""
    _wait_for(root / "repro" / "ready", root / "repro" / "failed")
    d = root / "repro" / "tp"
    if mesh_lib.rank_of(mesh) == 0:
        shutil.copytree(root / "repro" / "train0", d)
    mesh_lib.barrier(mesh)
    return _trainer(mesh, d, STEPS, 100)


def case_ckpt22(mesh, root):
    """The (2, 2) ``Trainer`` to step 2, saving there; the saved files
    against a one-device save of the gathered state."""
    d = root / "ckpt22"
    out = _trainer(mesh, d, 2, 2)
    if mesh_lib.rank_of(mesh) == 0:
        api = _api(GRANITE, 2)
        _, whole = CheckpointStore(str(d)).restore(
            steps_lib.train_state_specs(api))
        CheckpointStore(str(root / "ckpt22-one")).save(2, whole)
        (root / "ckpt22-ready").touch()
    return out


def case_restore14(mesh, root):
    """(2, 2)'s step-2 checkpoint restored onto (1, 4): each rank's blocks
    against the whole; then the ``Trainer`` from it to step 3."""
    _wait_for(root / "ckpt22-ready", root / "abandon")
    api = _api(GRANITE, 2)
    sh = steps_lib.train_state_shardings(api, mesh)
    store = CheckpointStore(str(root / "ckpt22"))
    _, mine = store.restore(steps_lib.train_state_specs(api), shardings=sh)
    _, whole = store.restore(steps_lib.train_state_specs(api))
    wf, shf = flatten_with_paths(whole), flatten_with_paths(sh)
    blocks = all(torch.equal(v, wf[k][part.local_index(tuple(wf[k].shape),
                                                       shf[k])])
                 for k, v in flatten_with_paths(mine).items())
    d = root / "restart14"
    if mesh_lib.rank_of(mesh) == 0:
        shutil.copytree(root / "ckpt22", d)
    mesh_lib.barrier(mesh)
    out = _trainer(mesh, d, 3, 100)
    out["blocks"] = blocks
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
    pairs = ([0, 1], [2, 3])
    got = None
    for pair in pairs:
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
    0: {"collectives": case_collectives, "layers": case_layers,
        "vocab_loss": case_vocab_loss, "norm": case_norm,
        f"lm:{GRANITE}": lambda mesh: run_steps(mesh, GRANITE, 1),
        "remat": case_remat, "repro": None},
    2: {f"lm:{NEMOTRON}": lambda mesh: run_steps(mesh, NEMOTRON, 1),
        "resnet": lambda mesh: run_steps(mesh, RESNET, 1)},
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
    out["lm:granite@2x2"] = run_steps(mesh, GRANITE, 2)
    out["resnet@2x2"] = run_steps(mesh, RESNET, 2)
    out["ckpt@2x2"] = case_ckpt22(mesh, root)
    mesh = mesh_lib.make_train_mesh((1, 4), device="cpu")
    out["collectives@1x4"] = case_collectives(mesh)
    out["layers@1x4"] = case_layers(mesh)
    out["lm:granite@1x4"] = run_steps(mesh, GRANITE, 1)
    out["lm:nemotron@1x4"] = run_steps(mesh, NEMOTRON, 1)
    out["resnet@1x4"] = run_steps(mesh, RESNET, 1)
    out["restore@1x4"] = case_restore14(mesh, root)
    # ``launch.train --mesh 1x4`` in the world of four, as under torchrun
    out["cli"] = launch_train.main([
        "--arch", GRANITE, "--reduced", "--batch", str(B), "--seq",
        str(SEQ), "--device", "cpu", "--ckpt-dir", str(root / "cli"),
        "--steps", "2", "--mesh", "1x4"])
    return out


# --- repro's meshed Trainer, in a process of its own ------------------------


def _repro_meshed(root):
    """``repro``'s ``Trainer`` on a (1, 2) ('data', 'model') mesh of 2
    forced host devices: reduced granite-8b, M = 2, B = 4 x 16, peak lr
    ``LR``, its step-0 state saved, 3 steps -> losses; step 0 rewritten
    in the port's tree under ``train0``."""
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
        mesh = jmesh._make_mesh((1, 2), ("data", "model"))
        pipe = JSyntheticLM(vocab=api.cfg.vocab, seq_len=SEQ,
                            global_batch=B, seed=0)
        ref = root / "ref"
        tr = JTrainer(api, pipe, mesh, JCfg(
            total_steps=STEPS, ckpt_every=100, ckpt_dir=str(ref),
            log_every=100, async_ckpt=False, peak_lr=LR))
        tr.store.save(0, tr.init_or_restore(jax.random.PRNGKey(0)))
        _, st = JStore(str(ref)).restore(jsteps.train_state_specs(api),
                                         step=0)
        CheckpointStore(str(root / "train0")).save(
            0, convert.from_jax_train_state(jax.tree.map(np.asarray, st),
                                            device="cpu"))
        (root / "ready").touch()
        _, history = tr.run(jax.random.PRNGKey(0))
        return {"history": [float(h) for h in history],
                "head": str(tr.state_sharding["params"]["head"]["w"].spec)}
    except BaseException:
        (root / "failed").touch()
        raise


# --- fixtures ----------------------------------------------------------------


@pytest.fixture(scope="module")
def root(tmp_path_factory):
    return tmp_path_factory.mktemp("tp")


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
               for a, m in ((GRANITE, 1), (GRANITE, 2), (NEMOTRON, 1))}
        out.update({f"resnet@{m}": run_steps(None, RESNET, m)
                    for m in (1, 2)})
        out["remat"] = {"off": run_steps(None, GRANITE, 1, remat=False)}
        out["conv"] = one_device_conv()
        _wait_for(root / "ckpt22-ready", root / "abandon")
        d = root / "restart-one"
        shutil.copytree(root / "ckpt22", d)
        out["restart"] = _trainer(None, d, 3, 100)
        return out
    finally:
        torch.set_num_threads(threads)


@pytest.fixture(scope="module")
def ranks(world, single):
    return world.result(timeout=600)


@pytest.fixture(scope="module")
def reference(repro_run, ranks):
    return repro_run.get(timeout=300)


# cell -> (the ranks' result key, the one-device result key)
CELLS = {
    "granite (1, 2)": ("lm:granite-8b@1x2", "lm:granite-8b@1"),
    "nemotron (1, 2)": ("lm:nemotron-4-340b@1x2", "lm:nemotron-4-340b@1"),
    "resnet18 (1, 2)": ("resnet@1x2", "resnet@1"),
    "granite (2, 2)": ("lm:granite@2x2", "lm:granite-8b@2"),
    "resnet18 (2, 2)": ("resnet@2x2", "resnet@2"),
    "granite (1, 4)": ("lm:granite@1x4", "lm:granite-8b@1"),
    "nemotron (1, 4)": ("lm:nemotron@1x4", "lm:nemotron-4-340b@1"),
    "resnet18 (1, 4)": ("resnet@1x4", "resnet@1"),
}


def _rel(a, b):
    a, b = a.astype(np.float64), b.astype(np.float64)
    return float(np.linalg.norm(a - b) / max(np.linalg.norm(b), 1e-30))


def _worst(got, want):
    assert got.keys() == want.keys()
    return max((_rel(got[k], want[k]), k) for k in want
               if k.startswith("['params']"))


# --- the pieces ----------------------------------------------------------------


def test_collectives_forward_and_backward_match_one_device_math(ranks):
    for shape in ("1x2", "1x4"):
        got = [r[f"collectives@{shape}"] for r in ranks
               if f"collectives@{shape}" in r]
        m = len(got)
        rng = np.random.default_rng(7)
        whole = rng.standard_normal((m, 3, 5)).astype(np.float32)
        cot = rng.standard_normal((3, 5)).astype(np.float32)
        big = rng.standard_normal((3, 5 * m)).astype(np.float32)
        want_sum = np.zeros((3, 5), np.float32)
        want_cot = np.zeros((3, 5), np.float32)
        for r in range(m):
            want_sum += whole[r]
            want_cot += cot * (r + 1)
        for r, g in enumerate(got):
            np.testing.assert_array_equal(g["sum"][0], want_sum)
            np.testing.assert_array_equal(g["sum"][1], cot)      # identity
            np.testing.assert_array_equal(g["copy"][0], whole[r])
            np.testing.assert_array_equal(g["copy"][1], want_cot)
            np.testing.assert_array_equal(
                g["gather"][0], np.concatenate(list(whole), axis=1))
            np.testing.assert_array_equal(g["gather"][1],
                                          big[:, r * 5:(r + 1) * 5])
            y, dx, owner = g["owned"]
            np.testing.assert_array_equal(y, np.where(
                owner == np.arange(m)[:, None, None], whole, 0).sum(0))
            np.testing.assert_array_equal(dx, np.where(owner == r, cot, 0))


def test_lsq_step_gradient_counts_the_whole_tensor():
    """A column shard's step gradient, summed over the shards, is one
    device's only with N counted over the whole tensor; the shard's own
    count makes it sqrt(M) times too large (the trap)."""
    rng = np.random.default_rng(3)
    w = torch.from_numpy(rng.standard_normal((24, 16)).astype(np.float32))
    spec = quant.weight_spec(4)

    def grad(v, whole=None):
        g = torch.tensor(0.05, requires_grad=True)
        quant.fake_quant(v, g, spec, whole=whole).sum().backward()
        return float(g.grad)
    one = grad(w)
    for m in (2, 4):
        n = 16 // m
        blocks = [w[:, r * n:(r + 1) * n] for r in range(m)]
        right = sum(grad(b, whole=w.shape) for b in blocks)
        wrong = sum(grad(b) for b in blocks)
        assert right == pytest.approx(one, rel=1e-6)
        assert wrong == pytest.approx(one * m ** 0.5, rel=1e-6)
        assert abs(wrong - one) > 0.1 * abs(one)


def _steps_close(got, want, what):
    """A step size's gradient: whole on every rank, its partial sums added
    across the ranks after LSQ's gradient scale multiplied each (f32
    roundings apart, relative to the largest element); a partial left
    unsummed is about 1/M of it."""
    want = np.asarray(want)
    np.testing.assert_allclose(got, want, rtol=STEP_GRAD_RTOL,
                               atol=STEP_GRAD_RTOL * np.abs(want).max(),
                               err_msg=what)


def test_tensor_parallel_layers_bitwise_one_device_on_the_grid(ranks, single):
    """On grid values every product and sum is exact, so the column- and
    row-parallel linears and the column-parallel conv give one
    device's output and gradients bitwise: each rank its block of w's and
    the whole of x's (its K block for a row shard); the step sizes'
    gradients whole, within ``STEP_GRAD_RTOL`` (``_steps_close``)."""
    x, w, cot = _layer_data()
    one = {c: _layer(x, w, cot, bool(c)) for c in (0, 1)}
    for shape in ("1x2", "1x4"):
        got = [r[f"layers@{shape}"] for r in ranks
               if f"layers@{shape}" in r]
        m = len(got)
        n, k = w.shape[1] // m, w.shape[0] // m
        for r, g in enumerate(got):
            cols, rows = slice(r * n, (r + 1) * n), slice(r * k, (r + 1) * k)
            for c in (0, 1):
                col, row, o = g[f"col{c}"], g[f"row{c}"], one[c]
                np.testing.assert_array_equal(col["y"], o["y"][..., cols])
                np.testing.assert_array_equal(col["x"], o["x"])
                np.testing.assert_array_equal(col["w"], o["w"][:, cols])
                _steps_close(col["gw"], o["gw"][cols] if c else o["gw"],
                             f"col gw {shape} {r}")
                _steps_close(col["ga"], o["ga"], f"col ga {shape} {r}")
                np.testing.assert_array_equal(row["y"], o["y"])
                np.testing.assert_array_equal(row["x"], o["x"][..., rows])
                np.testing.assert_array_equal(row["w"], o["w"][rows])
                _steps_close(row["gw"], o["gw"], f"row gw {shape} {r}")
                _steps_close(row["ga"], o["ga"], f"row ga {shape} {r}")
            conv, oc = g["conv"], single["conv"]
            c8 = 8 // m
            np.testing.assert_array_equal(conv["y"], oc["y"])
            np.testing.assert_array_equal(conv["x"], oc["x"])
            np.testing.assert_array_equal(conv["w"],
                                          oc["w"][:, r * c8:(r + 1) * c8])
            _steps_close(conv["gw"], oc["gw"], "conv gw")
            _steps_close(conv["ga"], oc["ga"], "conv ga")


def test_vocab_parallel_loss_masks_the_padding(ranks):
    rng = np.random.default_rng(11)
    logits = torch.from_numpy(rng.standard_normal((2, 3, 16)).astype(
        np.float32)).to(torch.bfloat16)
    logits[..., 12:] = 60.0
    labels = torch.from_numpy(rng.integers(0, 12, size=(2, 3)))
    real = logits[..., :12].clone().requires_grad_()
    want = steps_lib.cross_entropy(real, labels)
    want.backward()
    got = [r["vocab_loss@1x2"] for r in ranks if "vocab_loss@1x2" in r]
    assert [g[0] for g in got] == [got[0][0]] * 2   # every rank alike
    assert got[0][0] == pytest.approx(float(want), rel=1e-6)
    grad = np.concatenate([g[1] for g in got], axis=-1)
    np.testing.assert_array_equal(grad[..., 12:], 0.0)
    np.testing.assert_allclose(grad[..., :12], real.grad.float().numpy(),
                               rtol=0, atol=2 ** -12)
    # the padding's logits of 60 would move the loss by about 60
    assert abs(got[0][0] - float(torch.logsumexp(logits.float(), -1).mean()
                             - 60)) > 1


def test_clip_norm_counts_whole_leaves_once(ranks):
    g = _norm_tree()
    want = float(torch.sqrt(sum(torch.sum(v * v) for v in g.values())))
    got = [r["norm@1x2"] for r in ranks if "norm@1x2" in r]
    assert got == [got[0]] * 2
    assert got[0] == pytest.approx(want, rel=1e-6)
    twice = float(torch.sqrt(sum(torch.sum(v * v) * (1 if k == "cut" else 2)
                                 for k, v in g.items())))
    assert abs(got[0] - twice) > 0.1 * want


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
        print(f"\n[tp-train] losses before any update, relative gaps: "
              f"{gaps}")
    assert max(gaps.values()) <= FORWARD_RTOL, gaps


def test_every_leaf_after_three_steps_within_bound(ranks, single, capsys):
    worst, zero = {}, {}
    for cell, (mk, ok) in CELLS.items():
        lead = next(r[mk] for r in ranks if "state" in r.get(mk, {}))
        worst[cell] = _worst(lead["state"], single[ok]["state"])
        zero[cell] = max(((_rel(lead["state"][k], single[ok]["state"][k]),
                           k) for k in single[ok]["zero"]),
                         default=(0.0, None))
    with capsys.disabled():
        print(f"\n[tp-train] worst parameter leaf after {STEPS} steps "
              f"(relative L2): " + ", ".join(
                  f"{c} {v:.3e} {k}" for c, (v, k) in worst.items()))
        print(f"[tp-train] of them zero at init: " + ", ".join(
            f"{c} {v:.3e} {k}" for c, (v, k) in zero.items()))
    assert max(v for v, _ in worst.values()) <= LEAF_RTOL, worst


def test_first_gradient_within_tight_bound(ranks, single, capsys):
    """Every parameter leaf's first moment after step 0 (0.1 x the clipped
    gradient at the seeded init, before any update) within
    ``FIRST_RTOL`` relative L2 of one device's: only the order of the
    sums differs there, where after three steps AdamW's sign-like updates
    have amplified it (``LEAF_RTOL``)."""
    worst = {}
    for cell, (mk, ok) in CELLS.items():
        lead = next(r[mk] for r in ranks if "first" in r.get(mk, {}))
        want = single[ok]["first"]
        assert lead["first"].keys() == want.keys()
        worst[cell] = max((_rel(lead["first"][k], want[k]), k)
                          for k in want)
    with capsys.disabled():
        print(f"\n[tp-train] worst first moment after step 0 (relative "
              f"L2): " + ", ".join(f"{c} {v:.3e} {k}"
                                   for c, (v, k) in worst.items()))
    assert max(v for v, _ in worst.values()) <= FIRST_RTOL, worst


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


def test_remat_recomputes_the_collectives_alike(ranks, single):
    """remat off, 'full' and 'dots' on (1, 2): the same bits (a 'dots'
    that kept a row partial in place of its sum would not be)."""
    got = ranks[0]["remat@1x2"]
    for pol in ("full", "dots"):
        assert got[pol]["losses"] == got["off"]["losses"], pol
        bad = [k for k in got["off"]["state"]
               if not np.array_equal(got[pol]["state"][k],
                                     got["off"]["state"][k])]
        assert not bad, (pol, bad[:3])
    worst = _worst(got["off"]["state"], single["remat"]["off"]["state"])
    assert worst[0] <= LEAF_RTOL, worst


def test_checkpoint_reshards_across_meshes(ranks, single, root):
    """(2, 2)'s step-2 save: its files those of a one-device save of the
    gathered state; restored onto (1, 4) each rank's blocks bitwise, and
    the (1, 4) and one-device restarts from it to step 3 within the
    leaf bound; ``launch.train --mesh 1x4`` trains."""
    def files(d):
        p = Path(d) / f"step_{2:010d}"
        return {f.name: hashlib.sha256(f.read_bytes()).hexdigest()
                for f in sorted(p.iterdir())}
    assert files(root / "ckpt22") == files(root / "ckpt22-one")
    assert all(r["restore@1x4"]["blocks"] for r in ranks)
    got, want = ranks[0]["restore@1x4"], single["restart"]
    assert got["history"][0] == pytest.approx(want["history"][0],
                                              rel=FORWARD_RTOL)
    assert _worst(got["state"], want["state"])[0] <= LEAF_RTOL
    assert all(r["cli"] == 0 for r in ranks)
    assert CheckpointStore(str(root / "cli")).latest_step() == 2


def test_losses_agree_with_repros_meshed_trainer(ranks, reference, capsys):
    """The port's (1, 2) ``Trainer`` from ``repro``'s step-0 state against
    ``repro``'s (1, 2) ``Trainer``: before any update within
    ``REF_FORWARD_RTOL``, after within ``REF_LOSS_RTOL``."""
    got = ranks[0]["repro@1x2"]["history"]
    want = reference["history"]
    gaps = [abs(a - b) / abs(b) for a, b in zip(got, want)]
    with capsys.disabled():
        print(f"\n[tp-train] vs repro's (1, 2) Trainer (head "
              f"{reference['head']}): port {got}, repro {want}, relative "
              f"gaps {gaps}")
    assert len(got) == len(want) == STEPS
    np.testing.assert_allclose(got[:2], want[:2], rtol=REF_FORWARD_RTOL)
    np.testing.assert_allclose(got[2:], want[2:], rtol=REF_LOSS_RTOL)


# --- refusals ------------------------------------------------------------------


def _stand_in(shape):
    names = ("data", "model") if len(shape) == 2 else ("pod", "data",
                                                        "model")
    return SimpleNamespace(axis_names=names, devices=np.zeros(shape),
                           get_local_rank=lambda ax: 0)


LATER = (("mamba2-1.3b", "c"), ("recurrentgemma-9b", "c"))
NOW = ("olmoe-1b-7b", "deepseek-v2-lite-16b", "whisper-base")


def test_other_families_refuse_naming_their_part(tmp_path):
    """mamba2 and recurrentgemma refuse a 'model' axis above 1, naming
    ROADMAP 16b (iv) (c); the MoE archs and whisper train on it
    (``tests/test_torch_tensor_parallel_train_families.py``), so their
    production mesh says the world it needs, as the dense decoders' does."""
    for arch, label in LATER:
        api = configs.get(arch, reduced=True)
        match = r"16b \(iv\) \(" + label + r"\)"
        with pytest.raises(NotImplementedError, match=match):
            steps_lib.make_train_step(api, mesh=_stand_in((1, 2)))
        pipe = SyntheticLM(vocab=api.cfg.vocab, seq_len=SEQ, global_batch=B)
        with pytest.raises(NotImplementedError, match=match):
            Trainer(api, pipe, TrainLoopConfig(ckpt_dir=str(tmp_path)),
                    mesh=_stand_in((2, 2)))
        with pytest.raises(SystemExit, match=match):
            launch_train.main(["--arch", arch, "--reduced", "--device",
                               "cpu", "--production-mesh"])
    for arch in NOW:
        api = configs.get(arch, reduced=True)
        part.require_train_mesh({"data": 2, "model": 2}, api.family)
        assert callable(steps_lib.make_train_step(api,
                                                  mesh=_stand_in((1, 2))))
        with pytest.raises(SystemExit, match="needs a world of 512 ranks"):
            launch_train.main(["--arch", arch, "--reduced", "--device",
                               "cpu", "--multipod"])
    # the dense decoders' production mesh says the world it needs
    with pytest.raises(SystemExit, match="needs a world of 256 ranks"):
        launch_train.main(["--arch", GRANITE, "--reduced", "--device",
                           "cpu", "--production-mesh"])
