"""Pytrees in ``jax.tree.flatten``'s order, with no JAX.

A checkpoint numbers its leaves in flatten order (``io/sharded.py``'s
``leaf0000``...), so a checkpoint written by one package restores in the
other only if both flatten alike. ``torch.utils._pytree`` keeps a dict's
insertion order; JAX sorts a dict's keys. Containers here are JAX's
built-in nodes: dict (sorted keys), list, tuple and None (a node with no
leaves); everything else is a leaf.
"""

from __future__ import annotations

from typing import Any, List, Tuple

#: a treedef: ("dict", keys, children) | ("list"/"tuple", children) |
#: ("none",) | ("leaf",)
TreeDef = Tuple


def flatten(tree: Any) -> Tuple[List[Any], TreeDef]:
    """(leaves in JAX's order, treedef)."""
    leaves: List[Any] = []

    def walk(t):
        if isinstance(t, dict):
            keys = sorted(t)
            return ("dict", tuple(keys), tuple(walk(t[k]) for k in keys))
        if isinstance(t, (list, tuple)):
            return (type(t).__name__, tuple(walk(c) for c in t))
        if t is None:
            return ("none",)
        leaves.append(t)
        return ("leaf",)

    return leaves, walk(tree)


def leaves(tree: Any) -> List[Any]:
    return flatten(tree)[0]


def unflatten(treedef: TreeDef, values: List[Any]) -> Any:
    """Rebuild a tree of ``treedef``'s shape from ``values`` in order."""
    it = iter(values)

    def build(d):
        kind = d[0]
        if kind == "leaf":
            return next(it)
        if kind == "none":
            return None
        if kind == "dict":
            return {k: build(c) for k, c in zip(d[1], d[2])}
        children = [build(c) for c in d[1]]
        return children if kind == "list" else tuple(children)

    return build(treedef)


def treedef_str(treedef: TreeDef) -> str:
    """A readable form of ``treedef``, in the style of JAX's
    ``str(PyTreeDef)`` (the two may differ)."""
    def show(d):
        kind = d[0]
        if kind == "leaf":
            return "*"
        if kind == "none":
            return "None"
        if kind == "dict":
            return "{" + ", ".join(f"{k!r}: {show(c)}"
                                   for k, c in zip(d[1], d[2])) + "}"
        inner = ", ".join(show(c) for c in d[1])
        if kind == "list":
            return f"[{inner}]"
        return f"({inner},)" if len(d[1]) == 1 else f"({inner})"

    return f"PyTreeDef({show(treedef)})"
