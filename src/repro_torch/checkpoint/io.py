"""Minimal dependency-free checkpoints of the port's trees.

Port of ``repro/checkpoint/io.py``, in its on-disk layout: one directory
per step, ``<directory>/step_<n>``, holding

* ``arrays.npz`` -- the leaves, keyed by their ``/``-joined paths (dict
  keys, list indices and dataclass field names, e.g. ``params/embed/table``
  or ``opt_state/m/layers/0/attn/wq/w``);
* ``tree.json`` -- ``{"step", "keys", "dtypes"}``: the step, the keys in
  tree order and each leaf's dtype.

Both files are written to a temporary file in the step's directory and
moved into place with ``os.replace``.  A tree is nested dicts, lists and
dataclasses (``TrainState``, the optimizers' states) over tensors and
Python numbers; ``None`` is an empty subtree, as in the reference.  numpy
has no bfloat16, so a bf16 tensor is stored as its raw 16 bits
(``uint16``) and ``tree.json`` names its dtype ``bfloat16``; every other
tensor is stored in its own dtype, so a round trip is bitwise.  The
training state's leaves are fp32 (parameters and moments) and ints (the
step counts).

:func:`load_checkpoint` reads a step into the structure of a tree like the
one saved: each tensor in that tree's dtype on that tree's device.  The
keys are those of ``repro``'s checkpoints for the same tree; the port's
parameters keep one entry per layer where ``repro`` stacks them, so an
``arrays.npz`` of ``repro``'s parameters loads into the port through
``repro_torch.bridge.params_from_repro``.
"""

from __future__ import annotations

import dataclasses
import json
import os
import re
import tempfile
from typing import Any

import numpy as np
import torch

__all__ = ["save_checkpoint", "load_checkpoint", "latest_step"]

_STEP_RE = re.compile(r"^step_(\d+)$")


def _children(node):
    """``(name, child)`` pairs of a dict, list or dataclass; None for a leaf."""
    if isinstance(node, dict):
        return [(str(k), v) for k, v in node.items()]
    if isinstance(node, list):
        return [(str(i), v) for i, v in enumerate(node)]
    if dataclasses.is_dataclass(node) and not isinstance(node, type):
        return [(f.name, getattr(node, f.name)) for f in dataclasses.fields(node)]
    return None


def _leaves(tree, prefix: str = ""):
    """``(path, leaf)`` of every leaf in tree order; ``None`` has none."""
    if tree is None:
        return
    children = _children(tree)
    if children is None:
        yield prefix, tree
        return
    for name, child in children:
        yield from _leaves(child, f"{prefix}/{name}" if prefix else name)


def _to_numpy(leaf) -> tuple[np.ndarray, str]:
    if isinstance(leaf, torch.Tensor):
        t = leaf.detach().cpu()
        if t.dtype == torch.bfloat16:
            return t.view(torch.uint16).numpy(), "bfloat16"
        return t.numpy(), str(t.dtype).removeprefix("torch.")
    arr = np.asarray(leaf)
    return arr, arr.dtype.name


def _write_atomically(path: str, write) -> None:
    fd, tmp = tempfile.mkstemp(dir=os.path.dirname(path), suffix=".tmp")
    try:
        with os.fdopen(fd, "wb") as f:
            write(f)
        os.replace(tmp, path)
    except BaseException:
        os.unlink(tmp)
        raise


def save_checkpoint(directory: str, step: int, tree: Any) -> str:
    """Write ``tree`` under ``directory/step_{step}``; returns the path."""
    ckpt_dir = os.path.join(directory, f"step_{step}")
    os.makedirs(ckpt_dir, exist_ok=True)
    arrays, dtypes = {}, {}
    for key, leaf in _leaves(tree):
        arrays[key], dtypes[key] = _to_numpy(leaf)
    _write_atomically(os.path.join(ckpt_dir, "arrays.npz"), lambda f: np.savez(f, **arrays))
    meta = {"step": step, "keys": list(arrays), "dtypes": dtypes}
    _write_atomically(os.path.join(ckpt_dir, "tree.json"), lambda f: f.write(json.dumps(meta).encode()))
    return ckpt_dir


def _restore(like, key: str, data, dtypes: dict):
    if key not in data:
        raise KeyError(f"checkpoint missing leaf {key!r}")
    arr = data[key]
    if isinstance(like, torch.Tensor):
        t = torch.from_numpy(np.ascontiguousarray(arr))
        if dtypes.get(key) == "bfloat16":
            t = t.view(torch.bfloat16)
        return t.to(device=like.device, dtype=like.dtype).reshape(like.shape)
    return type(like)(arr.item())


def _rebuild(like, prefix: str, data, dtypes: dict):
    if like is None:
        return None
    children = _children(like)
    if children is None:
        return _restore(like, prefix, data, dtypes)
    built = {name: _rebuild(child, f"{prefix}/{name}" if prefix else name, data, dtypes) for name, child in children}
    if isinstance(like, dict):
        return {k: built[str(k)] for k in like}
    if isinstance(like, list):
        return [built[str(i)] for i in range(len(like))]
    return dataclasses.replace(like, **built)


def load_checkpoint(directory: str, step: int, like: Any) -> Any:
    """Load the checkpoint at ``step`` into the structure of ``like``."""
    ckpt_dir = os.path.join(directory, f"step_{step}")
    with open(os.path.join(ckpt_dir, "tree.json")) as f:
        dtypes = json.load(f).get("dtypes", {})
    with np.load(os.path.join(ckpt_dir, "arrays.npz")) as data:
        return _rebuild(like, "", data, dtypes)


def latest_step(directory: str) -> int | None:
    if not os.path.isdir(directory):
        return None
    steps = [int(m.group(1)) for name in os.listdir(directory) if (m := _STEP_RE.match(name))]
    return max(steps) if steps else None
