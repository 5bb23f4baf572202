"""Fault-tolerant checkpoints of the PyTorch port: numpy leaves and a JSON
manifest, the JAX package's on-disk layout.

A copy of the reference's ``training/checkpoint.py`` over the port's trees
(nested dicts, tuples, lists and NamedTuples of tensors, such as the
launcher's ``(model.state_dict(), OptState)``):

  * atomic   -- a checkpoint is written to ``<dir>/tmp.<step>.<pid>`` and
                renamed to ``<dir>/step_<step>`` only when complete, so a
                reader never sees a partial one; ``keep`` bounds how many
                stay.
  * complete -- every leaf round-trips bit for bit, with its path (the
                reference's key strings: ``[0]['blocks.0.attn.wq']``,
                ``[1].step``), shape and dtype in the manifest.
  * async    -- ``save(..., blocking=False)`` copies every leaf to the host
                before it returns (the next step may overwrite the
                tensors in place), then writes in a background thread.

numpy has no bfloat16: such a leaf is stored as its int16 bits, with
``"dtype": "bfloat16"`` and ``"bits": "int16"`` in its manifest entry.
"""
from __future__ import annotations

import json
import os
import shutil
import threading
from typing import Any, List, Optional, Tuple

import numpy as np
import torch

_MANIFEST = "manifest.json"


def _flatten(tree, path="") -> List[Tuple[str, Any]]:
    """(path, leaf) pairs in order: dict keys as ``['k']``, NamedTuple
    fields as ``.f``, other sequence items as ``[i]``."""
    if isinstance(tree, dict):
        return [x for k, v in tree.items()
                for x in _flatten(v, f"{path}['{k}']")]
    if isinstance(tree, tuple) and hasattr(tree, "_fields"):
        return [x for f in tree._fields
                for x in _flatten(getattr(tree, f), f"{path}.{f}")]
    if isinstance(tree, (tuple, list)):
        return [x for i, v in enumerate(tree)
                for x in _flatten(v, f"{path}[{i}]")]
    return [(path, tree)]


def _unflatten(like, leaves):
    """``like``'s structure with its leaves taken in order from the
    iterator ``leaves``."""
    if isinstance(like, dict):
        return type(like)((k, _unflatten(v, leaves))
                          for k, v in like.items())
    if isinstance(like, tuple) and hasattr(like, "_fields"):
        return type(like)(*(_unflatten(getattr(like, f), leaves)
                            for f in like._fields))
    if isinstance(like, (tuple, list)):
        return type(like)(_unflatten(v, leaves) for v in like)
    return next(leaves)


def _to_host(leaf) -> np.ndarray:
    """A host copy of a leaf, bfloat16 as its int16 bits."""
    if isinstance(leaf, torch.Tensor):
        t = leaf.detach().to("cpu", copy=True)
        if t.dtype == torch.bfloat16:
            t = t.view(torch.int16)
        return t.numpy()
    return np.array(leaf)


class _Writer(threading.Thread):
    """The background writer; :meth:`join` re-raises what it raised."""

    def __init__(self, fn):
        super().__init__(daemon=True)
        self._fn, self._error = fn, None

    def run(self):
        try:
            self._fn()
        except BaseException as e:      # handed to the joining thread
            self._error = e

    def join(self, timeout=None):
        super().join(timeout)
        if self._error is not None:
            raise self._error


def save(directory: str, step: int, tree: Any,
         meta: Optional[dict] = None, *, blocking: bool = True,
         keep: int = 3) -> Optional[threading.Thread]:
    """Write checkpoint ``<directory>/step_<step>`` atomically.  With
    ``blocking=False`` returns the writer thread (join it before the
    process ends or saves again)."""
    os.makedirs(directory, exist_ok=True)
    flat = _flatten(tree)
    # Snapshot to the host now: the next step updates the tensors in place.
    host = [(path, _to_host(leaf),
             str(leaf.dtype).rsplit(".", 1)[-1]
             if isinstance(leaf, torch.Tensor) else None)
            for path, leaf in flat]

    def _write():
        tmp = os.path.join(directory, f"tmp.{step}.{os.getpid()}")
        final = os.path.join(directory, f"step_{step:010d}")
        if os.path.exists(tmp):
            shutil.rmtree(tmp)
        os.makedirs(tmp)
        manifest = {"step": step, "meta": meta or {}, "leaves": []}
        for i, (path, arr, dt) in enumerate(host):
            fname = f"leaf_{i:05d}.npy"
            np.save(os.path.join(tmp, fname), arr)
            entry = {"path": path, "file": fname, "shape": list(arr.shape),
                     "dtype": dt or str(arr.dtype)}
            if dt == "bfloat16":
                entry["bits"] = "int16"
            manifest["leaves"].append(entry)
        with open(os.path.join(tmp, _MANIFEST), "w") as f:
            json.dump(manifest, f)
        if os.path.exists(final):
            shutil.rmtree(final)
        os.rename(tmp, final)
        _cleanup(directory, keep)

    if blocking:
        _write()
        return None
    t = _Writer(_write)
    t.start()
    return t


def _cleanup(directory: str, keep: int):
    steps = sorted(d for d in os.listdir(directory)
                   if d.startswith("step_"))
    for d in steps[:-keep]:
        shutil.rmtree(os.path.join(directory, d), ignore_errors=True)


def latest_step(directory: str) -> Optional[int]:
    """The newest complete checkpoint's step (``tmp.*`` ignored), or
    None."""
    if not os.path.isdir(directory):
        return None
    steps = sorted(d for d in os.listdir(directory)
                   if d.startswith("step_")
                   and os.path.exists(os.path.join(directory, d, _MANIFEST)))
    if not steps:
        return None
    return int(steps[-1].split("_")[1])


def restore(directory: str, like: Any, step: Optional[int] = None):
    """Restore into the structure of ``like``: each tensor leaf comes back
    on the device and in the dtype of ``like``'s leaf there, other leaves
    as numpy arrays.  Returns (tree, step, meta)."""
    step = latest_step(directory) if step is None else step
    if step is None:
        raise FileNotFoundError(f"no checkpoints under {directory}")
    cdir = os.path.join(directory, f"step_{step:010d}")
    with open(os.path.join(cdir, _MANIFEST)) as f:
        manifest = json.load(f)
    by_path = {e["path"]: e for e in manifest["leaves"]}
    out = []
    for path, leaf in _flatten(like):
        entry = by_path.get(path)
        if entry is None:
            raise KeyError(f"checkpoint missing leaf {path}")
        arr = np.load(os.path.join(cdir, entry["file"]))
        if tuple(arr.shape) != tuple(np.shape(leaf)):
            raise ValueError(
                f"shape mismatch for {path}: ckpt {arr.shape} vs "
                f"restore target {tuple(np.shape(leaf))}")
        if not isinstance(leaf, torch.Tensor):
            out.append(arr)
            continue
        t = torch.from_numpy(arr)
        if entry.get("bits") == "int16":
            t = t.view(torch.bfloat16)
        out.append(t.to(device=leaf.device, dtype=leaf.dtype))
    return _unflatten(like, iter(out)), step, manifest["meta"]
