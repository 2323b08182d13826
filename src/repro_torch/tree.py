"""Parameter trees as dotted names.

The port keeps the JAX parameter tree's key paths as flat dotted names —
what ``repro/checkpoint/checkpoint.py:_path_str`` writes, e.g.
``layers.b1.moe.w1`` — with the stacked layout kept: leaves under
``layers`` carry a leading ``n_periods`` axis.  Model code works on the
nested form; these helpers convert.
"""

from __future__ import annotations

from typing import Any

__all__ = ["flatten", "unflatten", "index"]


def flatten(tree, prefix: str = "") -> dict[str, Any]:
    """Nested dicts/lists -> {dotted name: leaf}; list items by index."""
    out: dict[str, Any] = {}
    if isinstance(tree, dict):
        items = tree.items()
    elif isinstance(tree, (list, tuple)):
        items = enumerate(tree)
    else:
        return {prefix: tree}
    for key, sub in items:
        name = f"{prefix}.{key}" if prefix else str(key)
        out.update(flatten(sub, name))
    return out


def unflatten(flat: dict[str, Any]) -> dict:
    """{dotted name: leaf} -> nested dicts (list levels become dicts keyed
    by the index as a string)."""
    tree: dict = {}
    for name, leaf in flat.items():
        *path, last = name.split(".")
        node = tree
        for part in path:
            node = node.setdefault(part, {})
        node[last] = leaf
    return tree


def index(tree, i: int):
    """The i-th slice of every leaf of a stacked subtree."""
    if isinstance(tree, dict):
        return {k: index(v, i) for k, v in tree.items()}
    return tree[i]
