"""Fault-tolerant training loop (port of ``repro.runtime.train``), on one
device or on a training mesh:

* restart-safe: ``run`` restores the latest atomic checkpoint and resumes
  the data stream by pure skip-ahead (``data.pipeline`` batches are a
  function of (seed, step)), so a restarted run repeats the uninterrupted
  one bit for bit;
* preemption-safe: SIGTERM/SIGINT stop the loop after the step in flight,
  and the final state is saved before ``run`` returns;
* straggler watchdog: an EMA of the step's wall time calls
  ``straggler_hook(step, seconds)`` when a step exceeds
  ``straggler_factor`` times it;
* checkpoints every ``ckpt_every`` steps, written in the background when
  ``async_ckpt``;
* the step updates the train state in place (``make_train_step(...,
  donate=True)``), as the reference donates it to its jitted step, so a
  step holds one state and its gradients, not two states;
* on a mesh (``mesh=``, a (data, model) or (pod, data, model) training
  mesh, one process a rank): the batch over ('pod', 'data') as
  ``batch_rules_for`` fits it to the pipeline's global batch (every
  'model' rank of a data row gets that row's batch), each rank's train
  state its FSDP blocks and, on a 'model' axis above 1, its
  tensor-parallel shards (``launch.steps.train_state_shardings``), made by
  cutting
  the whole state every rank initialises from the one generator (so the
  blocks are the one-device init's bits), checkpoints gathered and
  written by rank 0, and a restore that re-shards onto whatever mesh the
  run has (elastic).  The loop's decisions are collective: a signal any
  rank received stops every rank after the same step
  (``launch.mesh.any_rank``), and rank 0, once its writes are done, says
  whether the final state still needs a save (``broadcast_value``).
"""
from __future__ import annotations

import dataclasses
import signal
import time
from typing import Any, Callable, Dict, Optional

import torch

from repro_torch.checkpoint import CheckpointStore
from repro_torch.device import resolve_device
from repro_torch.launch import mesh as mesh_lib
from repro_torch.launch import steps as steps_lib
from repro_torch.nn import partitioning as part

__all__ = ["TrainLoopConfig", "Trainer"]


@dataclasses.dataclass
class TrainLoopConfig:
    total_steps: int = 100
    ckpt_every: int = 50
    ckpt_dir: str = "build/ckpt"
    log_every: int = 10
    straggler_factor: float = 3.0
    async_ckpt: bool = True
    peak_lr: float = 3e-4


class Trainer:
    """Train ``api`` on ``pipeline`` (``batch_at(step)`` -> numpy arrays)
    on ``device``: CUDA by default, which raises without a card unless
    ``device="cpu"``; with ``mesh`` (``launch.mesh.make_train_mesh``) on
    this rank's device of it, under ``rules`` (default ``TRAIN_RULES``; a
    'model' axis above 1 trains tensor-parallel where
    ``nn.partitioning.require_train_mesh`` takes the arch's family, and
    raises naming ROADMAP 16b (iv) (c) elsewhere).
    ``step_seconds``, ``save_seconds`` and ``restore_seconds`` hold the
    host time of this run's steps (each ends when its metrics reach the
    host), of its checkpoint saves (the caller's share of an asynchronous
    one) and of its restore."""

    def __init__(self, api, pipeline, cfg: TrainLoopConfig, *,
                 device="cuda", mesh=None, rules: Optional[Dict] = None,
                 straggler_hook: Optional[Callable[[int, float], None]] = None):
        self.api = api
        self.pipe = pipeline
        self.cfg = cfg
        self.mesh = mesh
        self.state_sharding = self.batch_sharding = None
        if mesh is not None:
            part.require_train_mesh(part.axis_sizes(mesh), api.family)
            self.device = mesh_lib.local_device(mesh)
            self.rules = steps_lib.batch_rules_for(
                part.TRAIN_RULES if rules is None else rules,
                pipeline.global_batch, mesh)
            self.state_sharding = steps_lib.train_state_shardings(
                api, mesh, self.rules)
            in_axes = {"tokens": ("batch", "seq"),
                       "labels": ("batch", "seq")}
            if api.needs_frames:
                in_axes["frames"] = ("batch", "frames", "act_embed")
            self.batch_sharding = part.tree_shardings(in_axes, mesh,
                                                      self.rules)
        else:
            self.device = resolve_device(device)
            self.rules = None
        self.rank = mesh_lib.rank_of(mesh)
        self.store = CheckpointStore(cfg.ckpt_dir)
        self.straggler_hook = straggler_hook or (
            lambda step, dt: print(f"[watchdog] step {step} straggling: "
                                   f"{dt:.3f}s"))
        # the reference jits the step with its state donated
        # (``donate_argnums``): the new state takes the old one's memory
        self.train_step = steps_lib.make_train_step(
            api, peak_lr=cfg.peak_lr, total_steps=cfg.total_steps,
            donate=True, mesh=mesh, rules=self.rules)
        self.step_seconds = []
        self.save_seconds = []
        self.restore_seconds: Optional[float] = None
        self._stop = False

    # -- lifecycle -----------------------------------------------------------

    def _install_signals(self) -> Dict[int, Any]:
        def handler(signum, frame):
            self._stop = True
        previous = {}
        for sig in (signal.SIGTERM, signal.SIGINT):
            try:
                previous[sig] = signal.signal(sig, handler)
            except ValueError:
                pass  # not on the main thread
        return previous

    def _log(self, msg: str) -> None:
        if self.rank == 0:
            print(msg)

    def init_or_restore(self, generator: torch.Generator) -> Dict[str, Any]:
        """The latest checkpoint's state, else a fresh one from
        ``generator``; on a mesh, this rank's blocks of it."""
        mesh_lib.barrier(self.mesh)  # no rank reads while rank 0 writes
        if self.store.latest_step() is not None:
            t0 = time.perf_counter()
            _, state = self.store.restore(
                steps_lib.train_state_specs(self.api), device=self.device,
                shardings=self.state_sharding)
            self.restore_seconds = time.perf_counter() - t0
            self._log(f"[trainer] restored step {int(state['step'])} from "
                      f"{self.cfg.ckpt_dir}")
            return state
        state = steps_lib.init_train_state(self.api, generator,
                                           device=self.device)
        if self.mesh is not None:
            state = part.shard_by(state, self.state_sharding)
        return state

    def _save(self, step: int, state, blocking: bool) -> None:
        t0 = time.perf_counter()
        self.store.save(step, state, blocking=blocking,
                        shardings=self.state_sharding)
        self.save_seconds.append(time.perf_counter() - t0)

    def _batch(self, step: int) -> Dict[str, torch.Tensor]:
        # skip-ahead by construction
        if self.mesh is not None:
            got = self.pipe.sharded_batch_at(step, self.batch_sharding)
        else:
            got = {k: torch.as_tensor(v, device=self.device)
                   for k, v in self.pipe.batch_at(step).items()}
        return {k: v.to(torch.long if not v.is_floating_point()
                        else torch.float32) for k, v in got.items()}

    # -- loop ------------------------------------------------------------------

    def run(self, generator: torch.Generator,
            on_metrics: Optional[Callable] = None):
        """Train up to ``total_steps`` -> (final state, losses of the steps
        this run took)."""
        previous = self._install_signals()
        try:
            state = self.init_or_restore(generator)
            start = int(state["step"])
            ema = None
            history = []
            for step in range(start, self.cfg.total_steps):
                if mesh_lib.any_rank(self.mesh, self._stop):
                    break
                batch = self._batch(step)
                t0 = time.perf_counter()
                state, metrics = self.train_step(state, batch)
                metrics = {k: float(v) for k, v in metrics.items()}
                dt = time.perf_counter() - t0
                self.step_seconds.append(dt)
                if ema is None:
                    ema = dt
                elif dt > self.cfg.straggler_factor * ema and step > start + 2:
                    self.straggler_hook(step, dt)
                else:
                    ema = 0.9 * ema + 0.1 * dt
                history.append(metrics["loss"])
                if on_metrics:
                    on_metrics(step, metrics)
                if step % self.cfg.log_every == 0:
                    self._log(f"[trainer] step {step} loss "
                              f"{metrics['loss']:.4f} ({dt * 1e3:.0f} ms)")
                if (step + 1) % self.cfg.ckpt_every == 0:
                    self._save(step + 1, state,
                               blocking=not self.cfg.async_ckpt)
            self.store.wait()
            final = int(state["step"])
            # the reference saves the final state again even when the last
            # periodic save holds it; the port skips that second copy.  Rank
            # 0 alone writes, so its answer, taken once its writes are done,
            # is every rank's
            need = self.rank == 0 and self.store.latest_step() != final
            if self.mesh is not None:
                need = bool(mesh_lib.broadcast_value(self.mesh, float(need)))
            if need:
                self._save(final, state, blocking=True)
            return state, history
        finally:
            for sig, h in previous.items():
                signal.signal(sig, h)
