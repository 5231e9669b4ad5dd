"""Nested dicts as the reference's pytrees: paths and leaves in its order.

The reference flattens a state (nested dicts, lists, tuples) with
``jax.tree_util``: dict keys sorted at every level, sequences in order,
``None`` an empty subtree, and a leaf's path the ``/``-joined keys and
indices (``repro/checkpoint/manager.py::_path_str``). The port's train
state and checkpoints keep that order and those paths, so a leaf has the
same name and place in both packages. Plain Python.
"""
from __future__ import annotations


def flatten(tree, prefix: str = "") -> list[tuple[str, object]]:
    """``[(path, leaf), ...]`` in the reference's order."""
    if tree is None:
        return []
    if isinstance(tree, dict):
        keys = sorted(tree)
    elif isinstance(tree, (list, tuple)):
        keys = range(len(tree))
    else:
        return [(prefix, tree)]
    out = []
    for k in keys:
        out.extend(flatten(tree[k], f"{prefix}/{k}" if prefix else str(k)))
    return out


def unflatten_like(example, leaves: list):
    """``example``'s structure (dicts, lists, tuples) with its leaves
    replaced, in :func:`flatten`'s order, by ``leaves``."""
    it = iter(leaves)

    def build(t):
        if t is None:
            return None
        if isinstance(t, dict):
            out = {k: None for k in t}  # the example's key order
            for k in sorted(t):
                out[k] = build(t[k])
            return out
        if isinstance(t, (list, tuple)):
            return type(t)(build(x) for x in t)
        return next(it)

    n = len(flatten(example))
    if n != len(leaves):
        raise ValueError(f"{len(leaves)} leaves for a tree of {n}")
    return build(example)


def nest(flat: dict) -> dict:
    """``{"a/b": x}`` → ``{"a": {"b": x}}``."""
    out: dict = {}
    for path, leaf in flat.items():
        *head, last = path.split("/")
        d = out
        for k in head:
            d = d.setdefault(k, {})
        d[last] = leaf
    return out
