"""Atomic, resumable checkpoints in the JAX package's on-disk format (a
port of its ``train/checkpoint.py``); a checkpoint written by either
package restores in the other.

Layout::

    <dir>/step_00001200/manifest.json   # step, keys, shapes, dtypes, digest
    <dir>/step_00001200/arrays.npz      # the flattened tree

* Keys are the tree's paths as JAX prints them (``core.tree``: dict keys
  in sorted order, ``[i]`` for a list or tuple index) joined by ``/``.
* A bfloat16 leaf is stored as its raw bits (numpy void ``V2``, which is
  how ``np.savez`` writes JAX's bfloat16) with ``"bfloat16"`` in the
  manifest.  The port's int32 threefry key words restore into JAX's uint32
  keys and back with the same bits.
* **Atomicity**: payload and manifest go into a ``.tmp-<pid>`` directory
  that is renamed into place, so a crash mid-write leaves no half-valid
  checkpoint.
* **Validity**: the manifest holds a digest of the payload;
  ``latest_step`` skips checkpoints whose digest does not verify.
* **Async**: ``save`` copies the tree to the host before it returns and
  writes it in a background thread; the next save joins the previous.
* Restore places each leaf on the device of the matching leaf of
  ``like`` (card or CPU), or as a DTensor by ``shardings`` (or by a DTensor
  ``like`` leaf's placements): the reference's resharding restore, so a
  checkpoint moves between meshes and one device.
* **Sharded trees**: a tree of DTensors saves its logical arrays in the
  same format, unsharded: every rank of their mesh gathers, the mesh's
  first rank writes, and a barrier over the mesh follows the rename.
"""
from __future__ import annotations

import hashlib
import json
import os
import shutil
import threading
from typing import Any, Optional

import numpy as np
import torch
import torch.distributed as dist

from .. import distributed
from ..core.tree import tree_flatten, tree_flatten_with_path, tree_unflatten

PyTree = Any
_SEP = "/"
_BF16_BITS = np.dtype("V2")  # np.savez's storage of a bfloat16 array


def _key(path: tuple) -> str:
    return _SEP.join(path)


def _is_dtensor(x) -> bool:
    from torch.distributed.tensor import DTensor

    return isinstance(x, DTensor)


def _to_numpy(leaf) -> np.ndarray:
    if _is_dtensor(leaf):
        leaf = leaf.full_tensor()  # a collective: every rank gathers
    if isinstance(leaf, torch.Tensor):
        # A copy even on the CPU: the caller may write the tensor in place
        # (the serving VM's state) while an async save is writing it.
        t = leaf.detach().to("cpu", copy=True)
        if t.dtype == torch.bfloat16:
            return t.contiguous().view(torch.int16).numpy().view(_BF16_BITS)
        return t.numpy()
    return np.array(leaf)


def _dtype_name(a: np.ndarray) -> str:
    return "bfloat16" if a.dtype == _BF16_BITS else str(a.dtype)


def flatten_with_paths(tree: PyTree) -> dict[str, np.ndarray]:
    """Every leaf of ``tree`` as a host numpy array, keyed by its path."""
    return {_key(path): _to_numpy(leaf) for path, leaf in tree_flatten_with_path(tree)[0]}


def _digest(flat: dict[str, np.ndarray]) -> str:
    h = hashlib.sha256()
    for k in sorted(flat):
        h.update(k.encode())
        h.update(np.ascontiguousarray(flat[k]).tobytes()[:65536])
        h.update(str(flat[k].shape).encode())
    return h.hexdigest()


def _as_tensor(arr: np.ndarray) -> torch.Tensor:
    """A stored array as a CPU tensor of its own dtype (bfloat16 from its
    bits; uint32, which JAX keeps keys in, as int32 of the same bits)."""
    arr = np.array(arr, order="C")  # (np.ascontiguousarray would make a 0-d array 1-d)
    if arr.dtype == _BF16_BITS:
        return torch.from_numpy(arr.view(np.int16)).view(torch.bfloat16)
    if arr.dtype == np.uint32:
        arr = arr.view(np.int32)
    return torch.from_numpy(arr)


def _restore_leaf(key: str, arr: np.ndarray, like, sharding=None):
    shape = tuple(like.shape) if hasattr(like, "shape") else ()
    if arr.shape != shape:
        raise ValueError(f"{key}: checkpoint shape {arr.shape} != {shape}")
    mesh = None
    if sharding is not None:
        mesh, placements = sharding.mesh, sharding.placements
    elif _is_dtensor(like):
        mesh, placements = like.device_mesh, like.placements
    if mesh is not None:
        from torch.distributed.tensor import distribute_tensor

        # Every rank reads the same file, so each keeps its own shard.
        return distribute_tensor(_as_tensor(arr).to(dtype=like.dtype), mesh, placements,
                                 src_data_rank=None)
    if isinstance(like, torch.Tensor):
        return _as_tensor(arr).to(dtype=like.dtype).to(like.device)
    if isinstance(like, np.ndarray):
        return arr.astype(like.dtype)
    return type(like)(arr.item())  # a Python scalar


class Checkpointer:
    def __init__(self, directory: str, keep: int = 3, async_save: bool = True):
        self.dir = directory
        self.keep = keep
        self.async_save = async_save
        self._thread: Optional[threading.Thread] = None
        os.makedirs(directory, exist_ok=True)

    # ------------------------------------------------------------- save

    def save(self, step: int, tree: PyTree, extra: Optional[dict] = None) -> None:
        """Write ``tree`` as the checkpoint of ``step``.  A tree with DTensor
        leaves is a collective over their one mesh: every rank of it calls
        ``save``, its first rank writes synchronously, and every rank
        returns once it is published."""
        meshes = {x.device_mesh for x in tree_flatten(tree)[0] if _is_dtensor(x)}
        if len(meshes) > 1:
            raise ValueError(f"a saved tree's DTensors lie on one mesh, got {len(meshes)}")
        flat = flatten_with_paths(tree)  # the host copy happens here, synchronously
        self.wait()  # join any in-flight save
        if meshes:
            (mesh,) = meshes
            if dist.get_rank() == distributed.mesh_ranks(mesh)[0]:
                self._write(step, flat, extra or {})
            distributed.mesh_barrier(mesh)
        elif self.async_save:
            self._thread = threading.Thread(target=self._write, args=(step, flat, extra or {}))
            self._thread.start()
        else:
            self._write(step, flat, extra or {})

    def wait(self) -> None:
        if self._thread is not None:
            self._thread.join()
            self._thread = None

    def _write(self, step: int, flat: dict, extra: dict) -> None:
        name = f"step_{step:08d}"
        tmp = os.path.join(self.dir, f".tmp-{os.getpid()}-{name}")
        final = os.path.join(self.dir, name)
        if os.path.exists(tmp):
            shutil.rmtree(tmp)
        os.makedirs(tmp)
        np.savez(os.path.join(tmp, "arrays.npz"), **flat)
        manifest = {
            "step": step,
            "keys": {k: {"shape": list(v.shape), "dtype": _dtype_name(v)}
                     for k, v in flat.items()},
            "digest": _digest(flat),
            "extra": extra,
        }
        with open(os.path.join(tmp, "manifest.json"), "w") as f:
            json.dump(manifest, f)
        if os.path.exists(final):
            shutil.rmtree(final)
        os.rename(tmp, final)  # atomic publish
        self._gc()

    def _gc(self) -> None:
        for s in self.all_steps()[: -self.keep]:
            shutil.rmtree(os.path.join(self.dir, f"step_{s:08d}"), ignore_errors=True)

    # ------------------------------------------------------------- load

    def all_steps(self) -> list[int]:
        out = []
        for name in os.listdir(self.dir):
            if name.startswith("step_"):
                try:
                    out.append(int(name[5:]))
                except ValueError:
                    continue
        return sorted(out)

    def _valid(self, step: int) -> bool:
        path = os.path.join(self.dir, f"step_{step:08d}")
        mpath = os.path.join(path, "manifest.json")
        apath = os.path.join(path, "arrays.npz")
        if not (os.path.exists(mpath) and os.path.exists(apath)):
            return False
        try:
            with open(mpath) as f:
                manifest = json.load(f)
            with np.load(apath) as npz:
                flat = dict(npz)
            return manifest["digest"] == _digest(flat)
        except Exception:  # any unreadable payload or manifest is invalid
            return False

    def latest_step(self) -> Optional[int]:
        """Newest checkpoint that passes digest validation."""
        for s in reversed(self.all_steps()):
            if self._valid(s):
                return s
        return None

    def restore(self, step: int, like: PyTree, shardings: Optional[PyTree] = None) -> PyTree:
        """The checkpoint of ``step`` in the structure of ``like``: each leaf
        in the dtype of ``like``'s, placed by the matching
        ``launch.sharding.NamedSharding`` of ``shardings`` (a tree like
        ``like``'s) as a DTensor, else as its ``like`` leaf is (a DTensor's
        placements, or a tensor's device): an elastic restart onto another
        mesh, or onto one device."""
        path = os.path.join(self.dir, f"step_{step:08d}")
        with np.load(os.path.join(path, "arrays.npz")) as npz:
            flat = dict(npz)
        leaves, treedef = tree_flatten_with_path(like)
        shards = [None] * len(leaves) if shardings is None else tree_flatten(shardings)[0]
        if len(shards) != len(leaves):
            raise ValueError(f"{len(shards)} shardings for {len(leaves)} leaves")
        out = []
        for (pth, leaf), sharding in zip(leaves, shards):
            key = _key(pth)
            if key not in flat:
                raise KeyError(f"checkpoint missing {key!r}")
            out.append(_restore_leaf(key, flat[key], leaf, sharding))
        return tree_unflatten(treedef, out)

    def manifest(self, step: int) -> dict:
        with open(os.path.join(self.dir, f"step_{step:08d}", "manifest.json")) as f:
            return json.load(f)
