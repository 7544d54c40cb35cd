"""Nested dicts of tensors (the port's parameter trees): the two walks the
port needs where the reference calls ``jax.tree_util``."""

from __future__ import annotations

from typing import Callable, Iterator


def leaves_with_path(tree: dict, prefix: tuple = ()) -> Iterator[tuple]:
    """``(path, leaf)`` for every leaf, depth first in insertion order."""
    for name, node in tree.items():
        if isinstance(node, dict):
            yield from leaves_with_path(node, prefix + (name,))
        else:
            yield prefix + (name,), node


def leaves(tree: dict) -> list:
    return [leaf for _, leaf in leaves_with_path(tree)]


def map_tree(fn: Callable, tree: dict, *rest: dict) -> dict:
    """``fn`` on the matching leaves of trees of one structure."""
    return {name: (map_tree(fn, node, *(r[name] for r in rest))
                   if isinstance(node, dict)
                   else fn(node, *(r[name] for r in rest)))
            for name, node in tree.items()}
