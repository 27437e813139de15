"""Bucketed image serving (port of ``repro.runtime.serve.ImageServer``).

The LM ``Generator``, meshes and telemetry of the JAX module are not
ported yet.
"""
from __future__ import annotations

import dataclasses
from typing import Any, List

import numpy as np
import torch

from repro_torch.device import resolve_device, tree_to

__all__ = ["ImageServer"]


@dataclasses.dataclass
class ImageServer:
    """Batched CNN serving over a packed ``serve_forward`` tree.

    Incoming batches of any size are chunked to the largest bucket and the
    remainder padded with zero images up to the smallest bucket that fits,
    so the network only ever runs at ``len(batch_buckets)`` batch sizes
    (one captured CUDA graph per bucket is later work).  Padded rows'
    outputs are discarded; batch entries never mix.

    ``params`` is a ``models.resnet.pack_for_serve`` tree; it is moved to
    ``device``, which defaults to CUDA and raises when there is no card.
    ``plan`` overrides the api's uniform policy with a layer-wise one;
    ``params`` must then be packed under the same plan.
    """

    api: Any
    params: Any
    batch_buckets: tuple = (1, 2, 4, 8)
    impl: str = "auto"
    dataflow: str = "auto"
    plan: Any = None
    device: Any = "cuda"

    def __post_init__(self):
        if self.api.family != "cnn":
            raise ValueError(f"ImageServer serves CNNs, got family "
                             f"{self.api.family!r}")
        self.device = resolve_device(self.device)
        self.params = tree_to(self.params, self.device)
        self.batch_buckets = tuple(sorted(set(self.batch_buckets)))
        self._served = set()

    def _forward(self, bucket: int, chunk: torch.Tensor) -> torch.Tensor:
        """One network forward at a bucket's batch size."""
        self._served.add(bucket)
        pol = self.plan if self.plan is not None else self.api.policy
        return self.api.mod.serve_forward(
            self.api.cfg, self.params, chunk, pol, impl=self.impl,
            dataflow=self.dataflow)

    def _bucket_for(self, n: int) -> int:
        for b in self.batch_buckets:
            if b >= n:
                return b
        return self.batch_buckets[-1]

    def predict(self, images: np.ndarray) -> np.ndarray:
        """(N, H, W, 3) float images -> (N, n_classes) f32 logits (the
        network's bf16 logits, widened exactly)."""
        n = images.shape[0]
        if n == 0:  # a drained request queue is not an error
            return np.zeros((0, self.api.cfg.n_classes), np.float32)
        outs: List[np.ndarray] = []
        i = 0
        with torch.inference_mode():
            while i < n:
                bucket = self._bucket_for(n - i)
                take = min(n - i, bucket)
                chunk = np.asarray(images[i:i + take], np.float32)
                if take < bucket:  # pad the tail up to the bucket
                    pad = np.zeros((bucket - take,) + chunk.shape[1:],
                                   chunk.dtype)
                    chunk = np.concatenate([chunk, pad])
                x = torch.from_numpy(chunk).to(self.device)
                y = self._forward(bucket, x)
                outs.append(y[:take].to(torch.float32).cpu().numpy())
                i += take
        return np.concatenate(outs)

    @property
    def compiled_buckets(self) -> tuple:
        """Batch sizes the network has run at so far."""
        return tuple(sorted(self._served))
