"""Parameter trees: nested dicts and lists of tensors, as the port keeps them.

Paths use the key scheme of ``repro/checkpoint/io.py::_path_str`` (dict keys
and list indices joined by ``/``), e.g. ``layers/0/mamba/A_log``.  Both
functions walk dicts in insertion order and lists in index order, so
``flatten(t).values()`` and the leaves ``tree_map`` visits come in one order.
"""

from __future__ import annotations

__all__ = ["flatten", "tree_map"]


def flatten(tree, prefix: str = "") -> dict:
    """``{path: leaf}`` of a tree of dicts and lists."""
    if isinstance(tree, dict):
        items = tree.items()
    elif isinstance(tree, list):
        items = enumerate(tree)
    else:
        return {prefix: tree}
    out = {}
    for k, v in items:
        out.update(flatten(v, f"{prefix}/{k}" if prefix else str(k)))
    return out


def tree_map(fn, tree, *rest):
    """A tree of the same structure with ``fn(leaf, *leaves_of_rest)`` at each leaf."""
    if isinstance(tree, dict):
        return {k: tree_map(fn, v, *(r[k] for r in rest)) for k, v in tree.items()}
    if isinstance(tree, list):
        return [tree_map(fn, v, *(r[i] for r in rest)) for i, v in enumerate(tree)]
    return fn(tree, *rest)
