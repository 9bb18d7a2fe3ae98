"""Nested trees of tensors: the port's counterpart of ``jax.tree``'s
flatten, map and unflatten over the nested dicts that the trainer, the
optimizers, the gradient compressor and the checkpoint pass around.

A tree is a dict (its keys taken in sorted order, as ``jax.tree``
flattens a dict) of trees or leaves.  A leaf is anything else; ``None``
is a leaf here too.  Every function keeps one order, so a tree and its
gradient, moments or codebooks flatten alike.
"""
from __future__ import annotations

from typing import Any, Callable, Iterator


def items(tree, prefix: tuple = ()) -> Iterator[tuple[tuple, Any]]:
    """(path, leaf) for every leaf, keys in sorted order at every level."""
    if isinstance(tree, dict):
        for key in sorted(tree):
            yield from items(tree[key], prefix + (key,))
    else:
        yield prefix, tree


def leaves(tree) -> list:
    return [leaf for _, leaf in items(tree)]


def key_of(path: tuple) -> str:
    """A path as the checkpoint names it: its keys joined by ``/``."""
    return "/".join(str(p) for p in path)


def map_(fn: Callable, tree, *rest):
    """``fn`` of each leaf of ``tree`` and the leaves at the same paths
    of ``rest``, in a tree of ``tree``'s structure."""
    if isinstance(tree, dict):
        return {k: map_(fn, v, *(r[k] for r in rest))
                for k, v in tree.items()}
    return fn(tree, *rest)


def map_with_path(fn: Callable, tree, prefix: tuple = ()):
    """``fn(path, leaf)`` of each leaf, in a tree of ``tree``'s
    structure (``jax.tree_util.tree_map_with_path``)."""
    if isinstance(tree, dict):
        return {k: map_with_path(fn, v, prefix + (k,))
                for k, v in tree.items()}
    return fn(prefix, tree)


def unflatten(paths: list, values: list) -> dict:
    """The nested dict with ``values[i]`` at ``paths[i]``."""
    out: dict = {}
    for path, value in zip(paths, values):
        node = out
        for key in path[:-1]:
            node = node.setdefault(key, {})
        node[path[-1]] = value
    return out


def get(tree, path: tuple):
    for key in path:
        tree = tree[key]
    return tree
