"""Parameter trees: nested dicts, lists and tuples with tensors (or arrays)
as leaves, walked in JAX's flatten order.

A dict's keys are taken sorted and a list's or tuple's items by index, as
``jax.tree_util.tree_flatten`` takes them, and a leaf's path is the string
``jax.tree_util.keystr`` gives it: ``"['blocks'][0]['conv1']"``. So the
packed layout (core/packing.py), the prunable decision on each path
(core/pruning.py) and the checkpoints' npz keys (checkpoint/io.py) are the
JAX package's, leaf for leaf.
"""
from __future__ import annotations

from typing import Any, Callable

PyTree = Any


def flatten_with_path(tree: PyTree, prefix: str = "", *,
                      is_leaf: Callable | None = None) -> list:
    """[(keystr path, leaf)] in JAX's flattening order; a node for which
    `is_leaf` is true is a leaf (a sharding spec, which is a tuple)."""
    if is_leaf is not None and is_leaf(tree):
        return [(prefix, tree)]
    if isinstance(tree, dict):
        out = []
        for k in sorted(tree):
            out += flatten_with_path(tree[k], f"{prefix}[{k!r}]",
                                     is_leaf=is_leaf)
        return out
    if isinstance(tree, (list, tuple)):
        out = []
        for i, v in enumerate(tree):
            out += flatten_with_path(v, f"{prefix}[{i}]", is_leaf=is_leaf)
        return out
    return [(prefix, tree)]


def leaves(tree: PyTree) -> list:
    """The leaves in flattening order."""
    return [leaf for _, leaf in flatten_with_path(tree)]


def unflatten(like: PyTree, new_leaves, *,
              is_leaf: Callable | None = None) -> PyTree:
    """`like`'s structure with its leaves, in flattening order, replaced;
    a dict comes back with its keys in sorted order."""
    it = iter(new_leaves)

    def build(node):
        if is_leaf is not None and is_leaf(node):
            return next(it)
        if isinstance(node, dict):
            return {k: build(node[k]) for k in sorted(node)}
        if isinstance(node, (list, tuple)):
            return type(node)(build(v) for v in node)
        return next(it)
    return build(like)


def tree_map(fn: Callable, tree: PyTree, *rest: PyTree) -> PyTree:
    """fn over the leaves of `tree` and of the trees of the same structure
    in `rest`, leaf by leaf."""
    others = [leaves(r) for r in rest]
    return unflatten(tree, [fn(leaf, *(o[i] for o in others))
                            for i, leaf in enumerate(leaves(tree))])
