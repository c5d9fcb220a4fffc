"""Nested-``dict`` parameter trees: the port's stand-in for ``jax.tree_util``.

Parameter and storage trees are nested dicts keyed like the reference's; any
non-dict value (a tensor, a ``CompressedVariable``) is a leaf.  Keys are
visited in sorted order, which is JAX's order for dict pytrees, so leaf
orders and ``path_str`` names line up with the reference.
"""

from __future__ import annotations

from typing import Any, Callable, Iterator, Tuple


def tree_items(tree, path: Tuple[str, ...] = ()) -> Iterator[Tuple[Tuple[str, ...], Any]]:
    """Yield ``(path, leaf)`` in JAX's leaf order."""
    if isinstance(tree, dict):
        for k in sorted(tree):
            yield from tree_items(tree[k], path + (k,))
    else:
        yield path, tree


def tree_map(fn: Callable[..., Any], tree, *rest):
    """Map ``fn(leaf, *rest_leaves)`` over trees of the same structure."""
    return tree_map_with_path(lambda _, *leaves: fn(*leaves), tree, *rest)


def tree_map_with_path(fn: Callable[..., Any], tree, *rest, path: Tuple[str, ...] = ()):
    """Map ``fn(path, leaf, *rest_leaves)``; structure follows ``tree``."""
    if isinstance(tree, dict):
        return {k: tree_map_with_path(fn, tree[k], *(r[k] for r in rest), path=path + (k,))
                for k in tree}
    return fn(path, tree, *rest)
