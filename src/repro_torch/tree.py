"""Nested-dict trees, flattened in the reference's order.

Parameters, gradients and optimizer state are nested dicts with string keys,
as the JAX reference's pytrees are. `jax.tree_util` flattens a dict in
sorted-key order, and bucket boundaries, fusability and the error-feedback
residual layout all follow that order, so the port flattens the same way
(never in `named_parameters()` registration order). A path is the tuple of
keys from the root to a leaf; anything that is not a dict is a leaf.
"""

from __future__ import annotations

from typing import Any, Callable


def leaves_with_paths(tree, prefix: tuple = ()) -> list:
    """[(path, leaf)] in sorted-key depth-first order."""
    if not isinstance(tree, dict):
        return [(prefix, tree)]
    out = []
    for k in sorted(tree):
        out.extend(leaves_with_paths(tree[k], prefix + (k,)))
    return out


def leaves(tree) -> list:
    return [leaf for _, leaf in leaves_with_paths(tree)]


def paths(tree) -> list:
    return [path for path, _ in leaves_with_paths(tree)]


def unflatten(paths_: list, leaves_: list) -> Any:
    """Rebuild a nested dict from (path, leaf) pairs; () is a bare leaf."""
    if len(paths_) == 1 and paths_[0] == ():
        return leaves_[0]
    root: dict = {}
    for path, leaf in zip(paths_, leaves_):
        node = root
        for k in path[:-1]:
            node = node.setdefault(k, {})
        node[path[-1]] = leaf
    return root


def map_with_path(fn: Callable, tree, *rest) -> Any:
    """fn(path, leaf, *rest_leaves) over every leaf; `rest` trees share
    `tree`'s structure."""
    pl = leaves_with_paths(tree)
    others = [leaves(r) for r in rest]
    return unflatten([p for p, _ in pl],
                     [fn(p, leaf, *(o[i] for o in others))
                      for i, (p, leaf) in enumerate(pl)])


def tree_map(fn: Callable, tree, *rest) -> Any:
    return map_with_path(lambda _, *xs: fn(*xs), tree, *rest)
