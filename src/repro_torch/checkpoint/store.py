"""Checkpoint store: per-leaf raw binaries and a JSON manifest, atomic and async.

Port of ``repro.checkpoint.store``, in the reference's on-disk format, so a
checkpoint written by either package is read by the other:

* ``directory/step_XXXXXXXX/`` holds ``leaf_00000.bin``, … (each leaf's raw
  bytes, C order) and ``manifest.json``: {"step", "leaves": [{"path", "file",
  "shape", "dtype"}]}, the leaves in the reference's order and with its path
  strings (``utils.tree.path_str``); bfloat16 is stored as uint16 with
  "bfloat16" as its dtype. A :class:`~repro_torch.utils.tree.Stacked` leaf
  (the port's per-layer tensors of one stacked reference leaf) is written as
  the stacked array: shape (L, …), its layers one after another.
* atomic: a checkpoint is written into ``step_XXXXXXXX.tmp``, each file
  fsynced, and ``os.replace``d into place; a ``.tmp`` is never a step.
* async: :class:`AsyncCheckpointer` copies the tree to host memory before
  ``save`` returns and writes it on a thread.
* restore validates paths and shapes against the expected tree and fails
  loudly. With ``mesh`` and ``placements`` it restores onto a device mesh
  (``distributed.fault_tolerance.elastic_restore``): each rank reads only its
  own slice of each leaf file (``np.memmap`` over the raw C-order bytes) and
  builds the DTensor from it (``DTensor.from_local``). The reference reads
  each array whole and then places it; the result is the same, leaf for leaf.
"""
from __future__ import annotations

import json
import os
import re
import shutil
import threading
from typing import Optional

import numpy as np
import torch

from repro_torch.utils import tree as tu

_STEP_RE = re.compile(r"^step_(\d{8})$")


def _leaf_filename(i: int) -> str:
    return f"leaf_{i:05d}.bin"


def _host_bytes(t) -> tuple:
    """(raw bytes, manifest dtype) of a tensor or numpy array."""
    if isinstance(t, torch.Tensor):
        t = t.detach().to("cpu").contiguous()
        if t.dtype == torch.bfloat16:
            return t.view(torch.int16).numpy().tobytes(), "bfloat16"
        arr = t.numpy()
    else:
        arr = np.ascontiguousarray(np.asarray(t))
    return arr.tobytes(), str(arr.dtype)


def save_checkpoint(directory: str, step: int, tree) -> str:
    """Write ``tree`` as ``directory/step_XXXXXXXX``. Returns the final path."""
    os.makedirs(directory, exist_ok=True)
    final = os.path.join(directory, f"step_{step:08d}")
    tmp = final + ".tmp"
    if os.path.exists(tmp):
        shutil.rmtree(tmp)
    os.makedirs(tmp)
    manifest = {"step": step, "leaves": []}
    for i, (path, leaf) in enumerate(tu.tree_flatten_with_path(tree)[0]):
        fname = _leaf_filename(i)
        parts = leaf.parts if isinstance(leaf, tu.Stacked) else (leaf,)
        with open(os.path.join(tmp, fname), "wb") as f:
            for part in parts:
                raw, dtype = _host_bytes(part)
                f.write(raw)
            f.flush()
            os.fsync(f.fileno())
        manifest["leaves"].append({"path": tu.path_str(path), "file": fname,
                                   "shape": [int(x) for x in leaf.shape], "dtype": dtype})
    with open(os.path.join(tmp, "manifest.json"), "w") as f:
        json.dump(manifest, f)
        f.flush()
        os.fsync(f.fileno())
    if os.path.exists(final):
        shutil.rmtree(final)
    os.replace(tmp, final)
    return final


def latest_step(directory: str) -> Optional[int]:
    """Highest complete step in ``directory`` (tmp dirs are ignored), or None."""
    if not os.path.isdir(directory):
        return None
    steps = []
    for name in os.listdir(directory):
        m = _STEP_RE.match(name)
        if m and os.path.exists(os.path.join(directory, name, "manifest.json")):
            steps.append(int(m.group(1)))
    return max(steps) if steps else None


def _from_raw(raw: bytes, shape: list, dtype: str) -> torch.Tensor:
    if dtype == "bfloat16":
        return torch.from_numpy(np.frombuffer(raw, np.int16).reshape(shape).copy()).view(torch.bfloat16)
    return torch.from_numpy(np.frombuffer(raw, np.dtype(dtype)).reshape(shape).copy())


def _np_dtype(dtype: str):
    return np.dtype(np.uint16) if dtype == "bfloat16" else np.dtype(dtype)


def _to_torch(arr: np.ndarray, dtype: str) -> torch.Tensor:
    t = torch.from_numpy(np.array(arr, order="C", copy=True))
    return t.view(torch.bfloat16) if dtype == "bfloat16" else t


def _restore_sharded(path: str, entry: dict, leaf, mesh, placements, device):
    """This rank's DTensor of one leaf file: its slice read through a memmap (a
    Stacked leaf: one DTensor a layer, the placements of the stacked array
    without its leading L axis, which must not be sharded)."""
    from torch.distributed.tensor import Shard

    from repro_torch.distributed import sharding

    shape = tuple(entry["shape"])
    placements = tuple(placements)
    slices = sharding.local_slices(shape, mesh, placements)
    mm = np.memmap(path, dtype=_np_dtype(entry["dtype"]), mode="r", shape=shape or (1,))
    if not isinstance(leaf, tu.Stacked):
        arr = np.array(mm[slices]) if shape else np.array(mm).reshape(())
        local = _to_torch(arr, entry["dtype"]).to(device)
        return sharding.from_local(local, mesh, placements, shape)
    if any(isinstance(p, Shard) and p.dim == 0 for p in placements):
        raise ValueError(f"placements {placements} shard the layer axis of a stacked leaf of shape {shape}")
    part = tuple(Shard(p.dim - 1) if isinstance(p, Shard) else p for p in placements)
    return tu.Stacked(tuple(
        sharding.from_local(_to_torch(np.array(mm[l][slices[1:]]), entry["dtype"]).to(device), mesh, part, shape[1:])
        for l in range(shape[0])))


def restore_checkpoint(directory: str, step: int, like, *, device=None, mesh=None, placements=None):
    """Load ``step`` into the structure of ``like`` (tensors, meta tensors or
    anything with a ``shape``; a :class:`~repro_torch.utils.tree.Stacked` leaf
    comes back as a Stacked of per-layer tensors). Leaves keep the stored
    dtype and land on ``device`` (default: the CPU). A missing path raises
    KeyError, a shape other than ``like``'s ValueError.

    ``mesh`` and ``placements`` (a tree of nested dicts like ``like``'s, each
    leaf the DTensor placements of that leaf's whole array) restore onto the
    mesh: every leaf a DTensor whose local shard this rank read alone, on
    ``device`` (default: the mesh's device). DTensor's split is
    ``torch.chunk``'s: an uneven dimension gives the first shards ⌈n/k⌉ and
    the last what is left, where jax pads each shard to ⌈n/k⌉. Placements
    that do not fit a leaf (their count, a dimension it lacks, a sharded layer
    axis) raise ValueError."""
    d = os.path.join(directory, f"step_{step:08d}")
    with open(os.path.join(d, "manifest.json")) as f:
        manifest = json.load(f)
    by_path = {e["path"]: e for e in manifest["leaves"]}
    pairs, spec = tu.tree_flatten_with_path(like)
    if (mesh is None) != (placements is None):
        raise ValueError("a restore onto a mesh takes both mesh= and placements=")
    if mesh is not None:
        from repro_torch.distributed import sharding

        by_leaf = sharding.spec_leaves(placements)
        if device is None:
            device = (torch.device("cuda", torch.cuda.current_device()) if mesh.device_type == "cuda"
                      else torch.device(mesh.device_type))
    out = []
    for path, leaf in pairs:
        ps = tu.path_str(path)
        if ps not in by_path:
            raise KeyError(f"checkpoint {d} is missing leaf {ps!r}")
        entry = by_path[ps]
        if list(leaf.shape) != entry["shape"]:
            raise ValueError(f"shape mismatch for {ps}: ckpt {entry['shape']} vs expected {list(leaf.shape)}")
        if mesh is not None:
            if ps not in by_leaf:
                raise KeyError(f"no placements for leaf {ps!r}")
            out.append(_restore_sharded(os.path.join(d, entry["file"]), entry, leaf, mesh, by_leaf[ps], device))
            continue
        with open(os.path.join(d, entry["file"]), "rb") as f:
            t = _from_raw(f.read(), entry["shape"], entry["dtype"])
        if device is not None:
            t = t.to(device)
        out.append(tu.Stacked(tuple(t.unbind(0))) if isinstance(leaf, tu.Stacked) else t)
    return tu.tree_unflatten(spec, out)


def _snapshot(tree):
    """A host copy of every tensor leaf (Stacked leaves part by part)."""
    def copy(x):
        if isinstance(x, tu.Stacked):
            return tu.Stacked(tuple(copy(p) for p in x.parts))
        if isinstance(x, torch.Tensor):
            return x.detach().to("cpu", copy=True)
        return np.array(x)

    return tu.tree_map(copy, tree)


class AsyncCheckpointer:
    """Overlap checkpoint I/O with training: snapshot now, write on a thread."""

    def __init__(self, directory: str, *, keep: int = 3):
        self.directory = directory
        self.keep = keep
        self._thread: Optional[threading.Thread] = None
        self._error: Optional[BaseException] = None

    def save(self, step: int, tree) -> None:
        self.wait()
        # A host copy now: the training loop updates the tensors in place right
        # after this returns.
        host = _snapshot(tree)

        def work():
            try:
                save_checkpoint(self.directory, step, host)
                self._gc()
            except BaseException as e:  # surfaced on next wait()
                self._error = e

        self._thread = threading.Thread(target=work, daemon=True)
        self._thread.start()

    def wait(self) -> None:
        if self._thread is not None:
            self._thread.join()
            self._thread = None
        if self._error is not None:
            err, self._error = self._error, None
            raise err

    def _gc(self) -> None:
        steps = sorted(int(m.group(1)) for m in (_STEP_RE.match(n) for n in os.listdir(self.directory)) if m)
        for s in steps[: -self.keep]:
            shutil.rmtree(os.path.join(self.directory, f"step_{s:08d}"), ignore_errors=True)
