"""Deterministic synthetic data with O(1) skip-ahead (port of
``repro.data.pipeline``; numpy only, the same batches bit for bit).

A batch is a pure function of (seed, step), so resuming from checkpoint
step S needs no replay.  ``SyntheticLM.sharded_batch_at`` gives a rank of
a training mesh its own rows of ``batch_at(step)`` on its device.
"""
from __future__ import annotations

import dataclasses
from typing import Dict

import numpy as np
import torch

from repro_torch.launch.mesh import local_device
from repro_torch.nn.partitioning import local_index

__all__ = ["SyntheticLM", "SyntheticImages"]


def _rng_for(seed: int, step: int) -> np.random.Generator:
    return np.random.default_rng(np.random.SeedSequence([seed, step]))


@dataclasses.dataclass
class SyntheticLM:
    """Zipf-ish token stream; labels are the tokens shifted by one."""

    vocab: int
    seq_len: int
    global_batch: int
    seed: int = 0
    with_frames: bool = False       # whisper: stub audio embeddings
    n_audio: int = 0
    d_model: int = 0

    def batch_at(self, step: int) -> Dict[str, np.ndarray]:
        rng = _rng_for(self.seed, step)
        raw = rng.zipf(1.3, size=(self.global_batch, self.seq_len + 1))
        toks = (raw % self.vocab).astype(np.int32)
        out = {"tokens": toks[:, :-1], "labels": toks[:, 1:]}
        if self.with_frames:
            out["frames"] = rng.standard_normal(
                (self.global_batch, self.n_audio, self.d_model),
                dtype=np.float32)
        return out

    def sharded_batch_at(self, step: int, shardings
                         ) -> Dict[str, torch.Tensor]:
        """This rank's block of every array of ``batch_at(step)`` (tokens,
        labels, whisper's frames) by ``shardings`` ({name:
        ``NamedSharding``}, ``nn.partitioning``; the rows of the 'batch'
        axis), as tensors of the arrays' dtypes on the rank's device
        (``launch.mesh.local_device``)."""
        out = {}
        for k, v in self.batch_at(step).items():
            sh = shardings[k]
            block = np.array(v[local_index(v.shape, sh, k)], order="C")
            out[k] = torch.from_numpy(block).to(local_device(sh.mesh))
        return out


@dataclasses.dataclass
class SyntheticImages:
    """Class-conditional Gaussian blobs (NHWC float32 images, int32
    labels): learnable, so QAT accuracy trends show at toy scale."""

    n_classes: int
    img_size: int
    global_batch: int
    seed: int = 0

    def batch_at(self, step: int) -> Dict[str, np.ndarray]:
        rng = _rng_for(self.seed, step)
        labels = rng.integers(0, self.n_classes, self.global_batch)
        protos = _rng_for(self.seed, 2**31 - 1).standard_normal(
            (self.n_classes, 8, 8, 3)).astype(np.float32)
        base = protos[labels]
        up = np.repeat(np.repeat(base, self.img_size // 8, 1),
                       self.img_size // 8, 2)
        noise = rng.standard_normal(
            (self.global_batch, self.img_size, self.img_size, 3)
        ).astype(np.float32)
        return {"images": up + 0.5 * noise,
                "labels": labels.astype(np.int32)}
