"""Fault-tolerant training loop (port of ``repro.runtime.train``), on one
device:

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
  step holds one state and its gradients, not two states.

The reference's device mesh, its sharded state and the elastic re-shard on
restore wait for multi-device training (ROADMAP 16b (iii)).
"""
from __future__ import annotations

import dataclasses
import signal
import time
from typing import Any, Callable, Dict, Optional

import torch

from repro_torch.checkpoint import CheckpointStore
from repro_torch.device import resolve_device
from repro_torch.launch import steps as steps_lib

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
    ``device="cpu"``.  ``step_seconds``, ``save_seconds`` and
    ``restore_seconds`` hold the host time of this run's steps (each ends
    when its metrics reach the host), of its checkpoint saves (the
    caller's share of an asynchronous one) and of its restore."""

    def __init__(self, api, pipeline, cfg: TrainLoopConfig, *,
                 device="cuda",
                 straggler_hook: Optional[Callable[[int, float], None]] = None):
        self.api = api
        self.pipe = pipeline
        self.cfg = cfg
        self.device = resolve_device(device)
        self.store = CheckpointStore(cfg.ckpt_dir)
        self.straggler_hook = straggler_hook or (
            lambda step, dt: print(f"[watchdog] step {step} straggling: "
                                   f"{dt:.3f}s"))
        # the reference jits the step with its state donated
        # (``donate_argnums``): the new state takes the old one's memory
        self.train_step = steps_lib.make_train_step(
            api, peak_lr=cfg.peak_lr, total_steps=cfg.total_steps,
            donate=True)
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

    def init_or_restore(self, generator: torch.Generator) -> Dict[str, Any]:
        """The latest checkpoint's state, else a fresh one from
        ``generator``."""
        if self.store.latest_step() is not None:
            t0 = time.perf_counter()
            _, state = self.store.restore(
                steps_lib.train_state_specs(self.api), device=self.device)
            self.restore_seconds = time.perf_counter() - t0
            print(f"[trainer] restored step {int(state['step'])} from "
                  f"{self.cfg.ckpt_dir}")
            return state
        return steps_lib.init_train_state(self.api, generator,
                                          device=self.device)

    def _save(self, step: int, state, blocking: bool) -> None:
        t0 = time.perf_counter()
        self.store.save(step, state, blocking=blocking)
        self.save_seconds.append(time.perf_counter() - t0)

    def _batch(self, step: int) -> Dict[str, torch.Tensor]:
        host = self.pipe.batch_at(step)  # skip-ahead by construction
        return {k: torch.as_tensor(v, device=self.device).to(
                    torch.long if v.dtype.kind in "iu" else torch.float32)
                for k, v in host.items()}

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
                if self._stop:
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
                    print(f"[trainer] step {step} loss {metrics['loss']:.4f} "
                          f"({dt * 1e3:.0f} ms)")
                if (step + 1) % self.cfg.ckpt_every == 0:
                    self._save(step + 1, state,
                               blocking=not self.cfg.async_ckpt)
            self.store.wait()
            final = int(state["step"])
            # the reference saves the final state again even when the last
            # periodic save holds it; the port skips that second copy
            if self.store.latest_step() != final:
                self._save(final, state, blocking=True)
            return state, history
        finally:
            for sig, h in previous.items():
                signal.signal(sig, h)
