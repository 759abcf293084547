"""Nests of dicts, lists and tuples of tensors (the port's parameter,
optimizer and checkpoint trees) walked in the reference's pytree order:
dict keys sorted, sequences in order.  A ``None`` is an empty subtree, as
in JAX."""

from __future__ import annotations

from typing import Any, Callable

Tree = Any


def flatten_with_paths(tree: Tree, prefix: tuple = ()) -> list:
    """``[(path, leaf)]``: ``path`` is the tuple of dict keys and sequence
    indices down to the leaf."""
    if isinstance(tree, dict):
        out = []
        for k in sorted(tree):
            out += flatten_with_paths(tree[k], prefix + (k,))
        return out
    if isinstance(tree, (list, tuple)):
        out = []
        for i, v in enumerate(tree):
            out += flatten_with_paths(v, prefix + (i,))
        return out
    if tree is None:
        return []
    return [(prefix, tree)]


def path_name(path: tuple) -> str:
    """A leaf's name as the reference's checkpoints write it
    (``"params/layers/0/wq"``)."""
    return "/".join(str(k) for k in path)


def leaves(tree: Tree) -> list:
    return [leaf for _, leaf in flatten_with_paths(tree)]


def tree_map(fn: Callable, tree: Tree, *rest: Tree) -> Tree:
    """``fn`` over the leaves of ``tree`` and the leaves at the same places
    of ``rest`` (trees of the same structure)."""
    if isinstance(tree, dict):
        return {k: tree_map(fn, v, *(r[k] for r in rest))
                for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return type(tree)(tree_map(fn, v, *(r[i] for r in rest))
                          for i, v in enumerate(tree))
    if tree is None:
        return None
    return fn(tree, *rest)


def unflatten_like(tree: Tree, values: list) -> Tree:
    """The structure of ``tree`` with its leaves replaced, in
    :func:`flatten_with_paths` order, by ``values``."""
    it = iter(values)

    def build(t):
        if isinstance(t, dict):
            return {k: build(t[k]) for k in sorted(t)}
        if isinstance(t, (list, tuple)):
            return type(t)(build(v) for v in t)
        if t is None:
            return None
        return next(it)

    out = build(tree)
    if next(it, None) is not None:
        raise ValueError("more values than leaves")
    return out
