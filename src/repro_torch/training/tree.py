"""Parameter trees: nested dicts, lists, tuples and named tuples with
tensors at the leaves (what the port's models and optimizer state are),
flattened in a fixed order and named by path, as ``jax.tree_util`` does
for the JAX package."""

from __future__ import annotations

import torch

SEP = "/"


def named_leaves(tree, prefix: str = "") -> list:
    """``[(path, leaf), ...]`` in flattening order: dict keys in insertion
    order, sequence entries by index, named-tuple fields by name."""
    if isinstance(tree, torch.Tensor):
        return [(prefix, tree)]
    if isinstance(tree, dict):
        items = tree.items()
    elif hasattr(tree, "_fields"):
        items = zip(tree._fields, tree)
    elif isinstance(tree, (list, tuple)):
        items = enumerate(tree)
    else:
        raise TypeError(f"not a tree of tensors: {type(tree).__name__} at "
                        f"{prefix or 'the root'}")
    out = []
    for key, sub in items:
        out += named_leaves(sub, f"{prefix}{SEP}{key}" if prefix
                            else str(key))
    return out


def leaves(tree) -> list:
    """The tensors of ``tree`` in flattening order."""
    return [leaf for _, leaf in named_leaves(tree)]


def rebuild(tree, new_leaves):
    """``tree``'s structure with ``new_leaves`` (in flattening order) at
    its leaves."""
    it = iter(new_leaves)

    def build(t):
        if isinstance(t, torch.Tensor):
            return next(it)
        if isinstance(t, dict):
            return {k: build(v) for k, v in t.items()}
        if hasattr(t, "_fields"):
            return type(t)(*(build(v) for v in t))
        return type(t)(build(v) for v in t)

    out = build(tree)
    if next(it, None) is not None:
        raise ValueError("more leaves than the tree has")
    return out


def map_tree(fn, tree):
    """``tree`` with ``fn(leaf)`` at every leaf."""
    return rebuild(tree, [fn(leaf) for leaf in leaves(tree)])
