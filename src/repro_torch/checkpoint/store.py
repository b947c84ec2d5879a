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
  loudly. Elastic restore onto another sharding waits for
  ``distributed/sharding.py`` (ROADMAP Queue 1 item 9g).
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


def restore_checkpoint(directory: str, step: int, like, *, device=None):
    """Load ``step`` into the structure of ``like`` (tensors, meta tensors or
    anything with a ``shape``; a :class:`~repro_torch.utils.tree.Stacked` leaf
    comes back as a Stacked of per-layer tensors). Leaves keep the stored
    dtype and land on ``device`` (default: the CPU). A missing path raises
    KeyError, a shape other than ``like``'s ValueError."""
    d = os.path.join(directory, f"step_{step:08d}")
    with open(os.path.join(d, "manifest.json")) as f:
        manifest = json.load(f)
    by_path = {e["path"]: e for e in manifest["leaves"]}
    pairs, spec = tu.tree_flatten_with_path(like)
    out = []
    for path, leaf in pairs:
        ps = tu.path_str(path)
        if ps not in by_path:
            raise KeyError(f"checkpoint {d} is missing leaf {ps!r}")
        entry = by_path[ps]
        if list(leaf.shape) != entry["shape"]:
            raise ValueError(f"shape mismatch for {ps}: ckpt {entry['shape']} vs expected {list(leaf.shape)}")
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
