"""Atomic, asynchronous checkpoints (port of ``repro.checkpoint.store``),
in the same on-disk format, so either package reads the other's.

* atomic: a checkpoint is written into ``<dir>/tmp.<step>`` and
  ``os.replace``d to ``<dir>/step_<step:010d>``; a crash mid-save never
  corrupts the latest good checkpoint;
* asynchronous: the device-to-host copy runs on the caller's thread, the
  files are written on a background thread while training goes on; a
  blocking save copies and writes one leaf at a time, so the host never
  holds more than one leaf of it;
* self-describing: ``metadata.json`` records the step and, per leaf, its
  tree path (as ``jax.tree_util.keystr`` writes it), file, shape and dtype;
  each leaf is one ``leaf_%05d.npy``, numbered in sorted path order;
* garbage-collected down to the last ``keep`` checkpoints.

numpy has no bfloat16: a bf16 leaf is stored as its uint16 bit pattern
with ``"bfloat16"`` as its dtype, as the reference stores it, and read back
through torch's own bf16 view (no ``ml_dtypes``).

On a training mesh (``shardings=``, a ``NamedSharding`` tree, as
``launch.steps.train_state_shardings`` gives it): ``save`` gathers each
sharded leaf whole on the caller's thread, in the same leaf order on
every rank, and only the world's rank 0 writes (in the background when
asynchronous), so the files are byte for byte those of a one-device save
of the same state; ``restore`` gives each rank its block of every leaf on
its device, read from a memory map of the file.  A checkpoint written on
any mesh restores onto any other or onto one device (the elastic
re-shard).  Ranks read ``latest_step`` after a barrier
(``launch.mesh.barrier``), so none reads the directory while rank 0
writes it.
"""
from __future__ import annotations

import json
import os
import shutil
import threading
from typing import Any, Optional, Tuple

import numpy as np
import torch

from repro_torch.launch.mesh import local_device, rank_of
from repro_torch.nn.partitioning import (BUCKET_BYTES, bucket, gather_by,
                                         local_index)
from repro_torch.tree import flatten_with_paths, unflatten

__all__ = ["CheckpointStore"]


def _to_host(x) -> np.ndarray:
    """A leaf as a numpy array of its own bits (bf16 as uint16), copied
    off the device and out of any tensor a later step may write."""
    if isinstance(x, torch.Tensor):
        t = x.detach().to("cpu", copy=True)
        if t.dtype == torch.bfloat16:
            return t.view(torch.int16).numpy().view(np.uint16)
        return t.numpy()
    return np.array(x)


def _from_host(arr: np.ndarray, dtype_name: str, device) -> torch.Tensor:
    if dtype_name == "bfloat16":
        t = torch.from_numpy(arr.view(np.int16)).view(torch.bfloat16)
    elif arr.dtype.kind in "biuf":
        t = torch.from_numpy(np.asarray(arr, order="C"))  # a 0-d stays 0-d
    else:
        raise TypeError(f"cannot restore a leaf of dtype {dtype_name!r}")
    return t.to(device)


def _whole(flat, paths, shard):
    """(path, whole leaf) in ``paths`` order: the leaves that ``shard``
    ({path: ``NamedSharding``}) names gathered on every rank, in groups of
    consecutive paths of at most ``BUCKET_BYTES`` or the largest leaf
    (``nn.partitioning.gather_by``)."""
    if not shard:
        yield from ((p, flat[p]) for p in paths)
        return
    sizes = [flat[p].numel() * flat[p].element_size() for p in paths]
    for group in bucket(sizes, max(max(sizes), BUCKET_BYTES)):
        ps = [paths[i] for i in group]
        got = gather_by([flat[p] for p in ps], [shard[p] for p in ps])
        yield from zip(ps, got)


class CheckpointStore:
    def __init__(self, directory: str, keep: int = 3):
        self.dir = directory
        self.keep = keep
        os.makedirs(directory, exist_ok=True)
        self._thread: Optional[threading.Thread] = None

    # -- save ---------------------------------------------------------------

    def save(self, step: int, tree, *, blocking: bool = True,
             shardings=None) -> None:
        """Write ``tree`` as checkpoint ``step``; ``blocking=False`` returns
        once the leaves are on the host and writes them in the background
        (after any write still in flight).  ``shardings``: ``tree`` holds
        this rank's blocks by that ``NamedSharding`` tree; every rank of
        its mesh must call ``save`` alike (the leaves are gathered whole,
        a group of at most ``BUCKET_BYTES`` at a time), and rank 0
        writes."""
        flat = flatten_with_paths(tree)
        paths = sorted(flat)
        shard = (flatten_with_paths(shardings) if shardings is not None
                 else {})
        mesh = next(iter(shard.values())).mesh if shard else None
        writer = rank_of(mesh) == 0

        def host():
            for path, leaf in _whole(flat, paths, shard):
                if writer:
                    yield path, (_to_host(leaf), "bfloat16" if getattr(
                        leaf, "dtype", None) == torch.bfloat16 else None)
        if not writer:
            for _ in host():  # the gathers, in rank 0's order
                pass
        elif blocking:
            self.wait()
            self._write(step, host())
        else:
            copies = list(host())
            self.wait()
            self._thread = threading.Thread(
                target=self._write, args=(step, copies), daemon=True)
            self._thread.start()

    def wait(self) -> None:
        """Join the write in flight, if any."""
        if self._thread is not None:
            self._thread.join()
            self._thread = None

    def _write(self, step: int, items) -> None:
        """``items``: (path, (array, dtype name)) in sorted path order."""
        tmp = os.path.join(self.dir, f"tmp.{step}")
        final = os.path.join(self.dir, f"step_{step:010d}")
        if os.path.exists(tmp):
            shutil.rmtree(tmp)
        os.makedirs(tmp)
        meta = {"step": step, "leaves": {}}
        for i, (path, (arr, name)) in enumerate(items):
            fname = f"leaf_{i:05d}.npy"
            np.save(os.path.join(tmp, fname), arr)
            meta["leaves"][path] = {"file": fname, "shape": list(arr.shape),
                                    "dtype": name or str(arr.dtype)}
        with open(os.path.join(tmp, "metadata.json"), "w") as f:
            json.dump(meta, f, indent=1)
        if os.path.exists(final):
            shutil.rmtree(final)
        os.replace(tmp, final)  # the atomic publish
        self._gc()

    def _gc(self) -> None:
        for s in self.all_steps()[: -self.keep]:
            shutil.rmtree(os.path.join(self.dir, f"step_{s:010d}"),
                          ignore_errors=True)

    # -- restore ------------------------------------------------------------

    def all_steps(self):
        return sorted(int(name.split("_")[1]) for name in os.listdir(self.dir)
                      if name.startswith("step_"))

    def latest_step(self) -> Optional[int]:
        steps = self.all_steps()
        return steps[-1] if steps else None

    def restore(self, template, step: Optional[int] = None,
                device="cpu", shardings=None) -> Tuple[int, Any]:
        """(step, tree) in the structure of ``template`` (leaves with a
        ``shape``: tensors or ``ParamSpec``s), every leaf on ``device``;
        with ``shardings`` (a ``NamedSharding`` tree of ``template``'s
        structure) each leaf is this rank's block on its mesh device.
        A leaf missing from the checkpoint raises ``KeyError``, one of
        another shape ``ValueError``."""
        step = step if step is not None else self.latest_step()
        if step is None:
            raise FileNotFoundError(f"no checkpoints under {self.dir}")
        path = os.path.join(self.dir, f"step_{step:010d}")
        with open(os.path.join(path, "metadata.json")) as f:
            meta = json.load(f)
        shard = (flatten_with_paths(shardings) if shardings is not None
                 else {})
        values = []
        for key, tleaf in flatten_with_paths(template).items():
            if key not in meta["leaves"]:
                raise KeyError(f"checkpoint {step} missing leaf {key}")
            entry = meta["leaves"][key]
            want = tuple(getattr(tleaf, "shape", ()))
            index = (local_index(want, shard[key], key) if key in shard
                     else ())
            # a leaf the mesh cuts is read through a memory map, its block
            # copied out; any other is read whole at once (a copy out of a
            # map faults its pages in one by one, several times slower)
            cut = any(i != slice(None) for i in index)
            arr = np.load(os.path.join(path, entry["file"]),
                          mmap_mode="r" if cut else None)
            if tuple(arr.shape) != want:
                raise ValueError(
                    f"leaf {key}: checkpoint shape {arr.shape} != {want}")
            if cut:
                arr = np.array(arr[index], order="C")
            dev = local_device(shard[key].mesh) if key in shard else device
            values.append(_from_host(arr, entry["dtype"], dev))
        return step, unflatten(template, values)
