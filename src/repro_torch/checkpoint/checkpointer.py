"""Fault-tolerant checkpointing of trees of tensors (the port of
``repro.checkpoint``, on the same on-disk protocol).

Layout:  <dir>/step_<N>/
            manifest.json   — tree structure, shapes, dtypes, hashes
            arr_<i>.npy     — one file per leaf (np.save)
         <dir>/step_<N>.COMMITTED   — atomic commit marker

Guarantees:
  * atomicity — writes go to step_<N>.tmp_<nonce>/, fsync'd, renamed, then
    the COMMITTED marker is created; restore only reads committed steps, so
    a mid-save crash never corrupts the latest checkpoint;
  * integrity — per-leaf crc32 verified on restore;
  * async save — the device->host copy is synchronous, the disk write
    happens on a worker thread so training overlaps I/O;
  * restore onto any device (``device=``): leaves are loaded on the host
    and placed there;
  * retention — keep the newest K checkpoints;
  * sharded state — a DTensor leaf is gathered whole (every rank of its
    mesh takes part) and written as one array, so the files are the same
    whatever the mesh; only rank 0 of the process group writes.
    Restoring into a target tree of DTensors places each leaf as its
    target is placed.

Leaves are numbered in ``torch.utils._pytree``'s order (a dict's
insertion order; JAX sorts dict keys, so a tree whose dicts are built in
sorted key order is numbered alike by both packages). numpy has no
bfloat16: a bf16 leaf is written as its 2-byte words (``|V2``, as the
JAX package's ml_dtypes arrays land on disk) with ``"dtype":
"bfloat16"`` in the manifest, and viewed back on restore.
"""

from __future__ import annotations

import json
import os
import shutil
import tempfile
import threading
import zlib

import numpy as np
import torch
import torch.distributed as dist
from torch.utils import _pytree as pytree

from repro_torch.sharding.ctx import is_dtensor

_BF16 = "bfloat16"


def _to_numpy(t: torch.Tensor) -> np.ndarray:
    if is_dtensor(t):
        t = t.full_tensor()
    t = t.detach().cpu().contiguous()
    if t.dtype == torch.bfloat16:
        return t.view(torch.int16).numpy().view(np.dtype("V2"))
    return t.numpy()


def _crc32(arr: np.ndarray) -> int:
    """crc32 of the array's bytes (the JAX package's ``arr.tobytes()``),
    read in place."""
    return zlib.crc32(np.ascontiguousarray(arr).reshape(-1).view(
        np.uint8)) & 0xFFFFFFFF


def _dtype_name(arr: np.ndarray) -> str:
    return _BF16 if arr.dtype == np.dtype("V2") else str(arr.dtype)


def _to_tensor(arr: np.ndarray, dtype: str) -> torch.Tensor:
    """A tensor over ``arr``'s memory (a fresh array from ``np.load``)."""
    if dtype == _BF16:
        return torch.from_numpy(arr.view(np.int16)).view(torch.bfloat16)
    return torch.from_numpy(arr.astype(np.dtype(dtype), copy=False))


def save_checkpoint(directory: str, step: int, tree, *, keep: int = 3,
                    blocking: bool = True):
    """Save a tree of tensors. Returns a join() callable when async. In a
    process group every rank gathers the leaves (a DTensor's gather is a
    collective that every rank joins) and rank 0 alone writes them."""
    leaves, spec = pytree.tree_flatten(tree)
    host_leaves = [_to_numpy(x) for x in leaves]  # device -> host now
    if dist.is_initialized() and dist.get_rank() != 0:
        return lambda: None
    os.makedirs(directory, exist_ok=True)

    def _write():
        tmp = tempfile.mkdtemp(prefix=f"step_{step}.tmp_", dir=directory)
        manifest = {"step": step, "treedef": str(spec), "leaves": []}
        for i, arr in enumerate(host_leaves):
            np.save(os.path.join(tmp, f"arr_{i}.npy"), arr)
            manifest["leaves"].append({
                "file": f"arr_{i}.npy",
                "shape": list(arr.shape),
                "dtype": _dtype_name(arr),
                "crc32": _crc32(arr),
            })
        with open(os.path.join(tmp, "manifest.json"), "w") as f:
            json.dump(manifest, f)
            f.flush()
            os.fsync(f.fileno())
        final = os.path.join(directory, f"step_{step}")
        if os.path.exists(final):
            shutil.rmtree(final)
        os.rename(tmp, final)
        with open(final + ".COMMITTED", "w") as f:
            f.write("ok")
        _gc(directory, keep)

    if blocking:
        _write()
        return lambda: None
    th = threading.Thread(target=_write, daemon=True)
    th.start()
    return th.join


def _gc(directory: str, keep: int):
    steps = committed_steps(directory)
    for s in steps[:-keep] if keep else []:
        shutil.rmtree(os.path.join(directory, f"step_{s}"), ignore_errors=True)
        try:
            os.remove(os.path.join(directory, f"step_{s}.COMMITTED"))
        except FileNotFoundError:
            pass


def committed_steps(directory: str) -> list[int]:
    if not os.path.isdir(directory):
        return []
    out = []
    for name in os.listdir(directory):
        if name.endswith(".COMMITTED"):
            try:
                out.append(int(name[len("step_"):-len(".COMMITTED")]))
            except ValueError:
                pass
    return sorted(out)


def latest_step(directory: str) -> int | None:
    steps = committed_steps(directory)
    return steps[-1] if steps else None


def restore_checkpoint(directory: str, step: int, target_tree, device=None):
    """Restore into the structure of ``target_tree`` (its leaves give the
    structure, and a DTensor leaf its placements). Each leaf is placed on
    ``device``, or stays on the host where it is None: a restore onto
    another device than the one that saved is the same call."""
    path = os.path.join(directory, f"step_{step}")
    with open(os.path.join(path, "manifest.json")) as f:
        manifest = json.load(f)
    leaves, spec = pytree.tree_flatten(target_tree)
    if len(leaves) != len(manifest["leaves"]):
        raise ValueError(f"{path}: {len(manifest['leaves'])} leaves, the "
                         f"target tree has {len(leaves)}")
    out = []
    for meta in manifest["leaves"]:
        arr = np.load(os.path.join(path, meta["file"]))
        crc = _crc32(arr)
        if crc != meta["crc32"]:
            raise IOError(
                f"checkpoint corruption in {path}/{meta['file']}: "
                f"crc {crc:#x} != {meta['crc32']:#x}")
        t = _to_tensor(arr, meta["dtype"])
        out.append(t if device is None else t.to(device))
    out = [_placed_as(t, like) for t, like in zip(out, leaves)]
    return pytree.tree_unflatten(out, spec)


def _placed_as(t, like):
    """``t`` as a DTensor placed as ``like`` where that is one (each rank
    keeps its shard of the same whole array)."""
    if not is_dtensor(like):
        return t
    from torch.distributed.tensor import distribute_tensor

    return distribute_tensor(t.to(like.device), like.device_mesh,
                             like.placements, src_data_rank=None)


class Checkpointer:
    """Async checkpoint manager with save-interval + emergency save."""

    def __init__(self, directory: str, keep: int = 3, interval: int = 100):
        self.directory = directory
        self.keep = keep
        self.interval = interval
        self._pending = None

    def maybe_save(self, step: int, tree, force: bool = False):
        if not force and (self.interval <= 0 or step % self.interval):
            return False
        self.wait()
        self._pending = save_checkpoint(
            self.directory, step, tree, keep=self.keep, blocking=False)
        return True

    def wait(self):
        if self._pending is not None:
            self._pending()
            self._pending = None

    def restore_latest(self, target_tree, device=None):
        step = latest_step(self.directory)
        if step is None:
            return None, None
        return step, restore_checkpoint(self.directory, step, target_tree,
                                        device)
