"""Atomic, fault-tolerant checkpoints in the reference's on-disk format
(the counterpart of ``repro.checkpoint.ckpt``; either package restores
the other's).

Layout:
  <dir>/step_<N>/manifest.json   -- paths, shapes, dtypes, byte sizes,
                                    data-iterator state ("extra"), and the
                                    versioned PackedTensor aux (format,
                                    logical shape, scale group, version)
  <dir>/step_<N>/<leaf-path>.npy -- one file per leaf, in
                                    ``flatten_with_paths`` order

Leaves cross the format as the reference writes them: a bf16 leaf as its
uint16 view with the dtype string ``"bfloat16"``, a packed tensor's
words as ``uint32`` (the port holds them as an int32 view; restore views
them back).  Guarantees:
  * atomic commit: writes go to ``step_N.tmp``, then ``os.rename``; a
    crash mid-save never corrupts the newest checkpoint;
  * exact resume: the data iterator's state rides in the manifest;
  * corruption detection: each leaf's byte size is recorded and checked;
  * retention: the newest ``keep`` checkpoints stay.

``CheckpointManager(async_save=True)`` copies the tree to host memory
before ``save`` returns and writes it on a background thread, whose
error surfaces on the next ``save`` or ``wait``.  ``restore_checkpoint``
puts each leaf on ``device`` (None: the device of the template's leaf),
or, given ``shardings`` (a tree of ``sharding.NamedSharding``), lays it
out as a DTensor on their mesh: a checkpoint saved from one mesh
restores onto another (elastic restore) or unsharded.

A tree with DTensor leaves (the sharded train state) is saved by every
rank of its mesh together: each leaf is gathered whole, rank 0 writes,
and the ranks meet at a barrier (``CheckpointManager.wait`` for an
async save), so the format on disk does not depend on the mesh.
"""

from __future__ import annotations

import dataclasses
import json
import os
import shutil
import threading
from typing import Any, Dict, Optional

import numpy as np
import torch
import torch.distributed

from ..core.formats import format_by_name
from ..core.policy import flatten_with_paths

__all__ = ["save_checkpoint", "restore_checkpoint", "latest_step",
           "CheckpointManager"]


def _is_packed(node) -> bool:
    return hasattr(node, "words") and hasattr(node, "scales")


def _packed_aux(tree) -> Dict[str, Dict[str, Any]]:
    """The aux of every PackedTensor node (what its array leaves cannot
    reconstruct), keyed by the same traversal as the leaf files."""
    return {
        path: {"spec": node.spec.name, "shape": list(node.shape),
               "group": node.group, "version": getattr(node, "version", 1)}
        for path, node in flatten_with_paths(tree, keep_packed=True)
        if _is_packed(node)
    }


def _leaf_file(path: str) -> str:
    return path.replace("/", "__") + ".npy"


def _to_numpy(leaf, words: bool):
    """(array as written, dtype string of the manifest)."""
    if isinstance(leaf, torch.Tensor):
        t = leaf.detach().cpu()
        if t.dtype == torch.bfloat16:
            return t.view(torch.int16).numpy().view(np.uint16), "bfloat16"
        arr = t.numpy()
    else:
        arr = np.asarray(leaf)
        if arr.dtype.name == "bfloat16":
            return arr.view(np.uint16), "bfloat16"
    if words and arr.dtype == np.int32:
        arr = arr.view(np.uint32)
    return arr, str(arr.dtype)


def _is_sharded(tree) -> bool:
    from torch.distributed.tensor import DTensor
    return any(isinstance(t, DTensor) for _, t in flatten_with_paths(tree))


def save_checkpoint(directory: str, step: int, tree,
                    extra: Optional[Dict] = None, keep: int = 3) -> str:
    if not _is_sharded(tree):
        return _write(directory, step, tree, extra, keep)
    host = _host_copy(tree)                  # every rank gathers
    try:
        if torch.distributed.get_rank() == 0:
            _write(directory, step, host, extra, keep)
    finally:
        torch.distributed.barrier()
    return os.path.join(directory, f"step_{step:08d}")


def _write(directory: str, step: int, tree, extra: Optional[Dict],
           keep: int) -> str:
    os.makedirs(directory, exist_ok=True)
    final = os.path.join(directory, f"step_{step:08d}")
    tmp = final + ".tmp"
    if os.path.exists(tmp):
        shutil.rmtree(tmp)
    os.makedirs(tmp)
    packed = _packed_aux(tree)
    manifest: Dict[str, Any] = {"step": step, "leaves": {},
                                "extra": extra or {}, "packed": packed}
    for path, leaf in flatten_with_paths(tree):
        words = path.endswith("/words") and path[:-len("/words")] in packed
        arr, dtype_str = _to_numpy(leaf, words)
        fname = _leaf_file(path)
        np.save(os.path.join(tmp, fname), arr)
        manifest["leaves"][path] = {
            "file": fname, "shape": list(arr.shape), "dtype": dtype_str,
            "nbytes": int(arr.nbytes),
        }
    with open(os.path.join(tmp, "manifest.json"), "w") as f:
        json.dump(manifest, f)
    if os.path.exists(final):
        shutil.rmtree(final)
    os.rename(tmp, final)          # atomic commit
    _apply_retention(directory, keep)
    return final


def _apply_retention(directory: str, keep: int) -> None:
    for s in sorted(_list_steps(directory))[:-keep]:
        shutil.rmtree(os.path.join(directory, f"step_{s:08d}"),
                      ignore_errors=True)


def _list_steps(directory: str):
    out = []
    if not os.path.isdir(directory):
        return out
    for name in os.listdir(directory):
        if name.startswith("step_") and not name.endswith(".tmp"):
            try:
                out.append(int(name[5:]))
            except ValueError:
                pass
    return out


def latest_step(directory: str) -> Optional[int]:
    steps = _list_steps(directory)
    return max(steps) if steps else None


def _from_numpy(arr: np.ndarray, dtype_str: str) -> torch.Tensor:
    if dtype_str == "bfloat16":
        return torch.from_numpy(arr.view(np.int16)).view(torch.bfloat16)
    if arr.dtype == np.uint32:
        arr = arr.view(np.int32)
    return torch.from_numpy(arr)


def restore_checkpoint(directory: str, template, step: Optional[int] = None,
                       device=None, shardings=None):
    """Restore into the structure of ``template`` (nested dicts, lists,
    PackedTensors, dataclasses such as ``TrainState``).  ``shardings``:
    an optional matching tree of ``NamedSharding`` (None leaves, or no
    tree, restore whole); each leaf is laid out on its mesh's device.
    Returns (tree, extra, step)."""
    from ..parallel.sharding import place
    shard_of = dict(flatten_with_paths(shardings)) \
        if shardings is not None else {}
    if step is None:
        step = latest_step(directory)
        if step is None:
            raise FileNotFoundError(f"no checkpoints in {directory}")
    base = os.path.join(directory, f"step_{step:08d}")
    with open(os.path.join(base, "manifest.json")) as f:
        manifest = json.load(f)
    restored = {}
    for path, tleaf in flatten_with_paths(template):
        meta = manifest["leaves"].get(path)
        if meta is None:
            raise KeyError(f"checkpoint missing leaf {path}")
        arr = np.load(os.path.join(base, meta["file"]))
        if int(arr.nbytes) != meta["nbytes"]:
            raise IOError(f"corrupted checkpoint leaf {path}: "
                          f"{arr.nbytes} != {meta['nbytes']}")
        sh = shard_of.get(path)
        if sh is not None:
            dev = sh.mesh.device_type
        elif device is not None:
            dev = device
        else:
            dev = getattr(tleaf, "device", "cpu")
        t = _from_numpy(arr, meta["dtype"]).to(dev)
        restored[path] = place(t, sh) if sh is not None else t
    packed_meta = manifest.get("packed", {})

    return (_rebuild(template, "", restored, packed_meta),
            manifest["extra"], step)


def _rebuild(node, path: str, restored, packed_meta):
    """``node``'s structure with the restored leaves (a module-level walk:
    a nested recursive closure would keep ``restored`` alive until the
    cyclic garbage collector runs)."""
    if isinstance(node, dict):
        return {k: _rebuild(v, f"{path}/{k}" if path else k, restored,
                            packed_meta) for k, v in node.items()}
    if isinstance(node, (list, tuple)):
        return type(node)(_rebuild(v, f"{path}/{i}" if path else str(i),
                                   restored, packed_meta)
                          for i, v in enumerate(node))
    if node is None:
        return None
    if _is_packed(node):
        # the saved layout wins over the template's
        new = dataclasses.replace(node,
                                  words=restored[f"{path}/words"],
                                  scales=restored[f"{path}/scales"],
                                  mask=restored[f"{path}/mask"])
        meta = packed_meta.get(path)
        if meta is not None:
            new = dataclasses.replace(
                new, spec=format_by_name(meta["spec"]),
                shape=tuple(meta["shape"]), group=meta.get("group"),
                version=meta.get("version", 1))
        return new
    if dataclasses.is_dataclass(node) and not isinstance(node, type):
        return type(node)(**{
            f.name: _rebuild(getattr(node, f.name),
                             f"{path}/{f.name}" if path else f.name,
                             restored, packed_meta)
            for f in dataclasses.fields(node)})
    return restored[path]


def _host_copy(node):
    """A snapshot of ``node`` in host memory, taken now: every tensor is
    copied (a CPU tensor too, so an in-place update after ``save``
    returns cannot reach the writer)."""
    if isinstance(node, dict):
        return {k: _host_copy(v) for k, v in node.items()}
    if isinstance(node, (list, tuple)):
        return type(node)(_host_copy(v) for v in node)
    if isinstance(node, torch.Tensor):
        from torch.distributed.tensor import DTensor
        if isinstance(node, DTensor):
            return node.detach().full_tensor().to("cpu", copy=True)
        return node.detach().to("cpu", copy=True)
    if isinstance(node, np.ndarray):
        return node.copy()
    if dataclasses.is_dataclass(node) and not isinstance(node, type):
        if _is_packed(node):
            return dataclasses.replace(node, words=_host_copy(node.words),
                                       scales=_host_copy(node.scales),
                                       mask=_host_copy(node.mask))
        return type(node)(**{f.name: _host_copy(getattr(node, f.name))
                             for f in dataclasses.fields(node)})
    return node


class CheckpointManager:
    """Retention + optional async save + resume helper."""

    def __init__(self, directory: str, keep: int = 3,
                 async_save: bool = False):
        self.directory = directory
        self.keep = keep
        self.async_save = async_save
        self._thread: Optional[threading.Thread] = None
        self._error: Optional[BaseException] = None
        self._sharded = False      # the last save was of a sharded tree

    def save(self, step: int, tree, extra: Optional[Dict] = None) -> None:
        self.wait()
        self._sharded = _is_sharded(tree)
        host_tree = _host_copy(tree)   # snapshot now (sharded leaves whole)
        extra = json.loads(json.dumps(extra or {}))

        def work():
            try:
                _write(self.directory, step, host_tree, extra, self.keep)
            except Exception as e:  # surfaced on the next save / wait
                self._error = e

        if self._sharded and torch.distributed.get_rank() != 0:
            pass                       # rank 0 writes a sharded tree
        elif self.async_save:
            self._thread = threading.Thread(target=work, daemon=True)
            self._thread.start()
        else:
            work()
        if not self.async_save:
            self.wait()

    def wait(self) -> None:
        """Join the writer (after a sharded save, every rank meets the
        writer here); raise its error, if it had one."""
        if self._thread is not None:
            self._thread.join()
            self._thread = None
        if self._sharded:
            self._sharded = False
            torch.distributed.barrier()
        if self._error is not None:
            err, self._error = self._error, None
            raise err

    def restore(self, template):
        return restore_checkpoint(self.directory, template)

    def latest_step(self):
        return latest_step(self.directory)
