"""Parameter and train-state trees: nested dicts and lists of tensors.

The JAX package keeps these as pytrees; the port keeps plain containers
(per-block lists where the JAX package stacks blocks along a leading
axis, ``STACKED``; ``models.convert``).  A leaf's path is the tuple of
dict keys and list indices that reach it, in the containers' own order.
"""
from __future__ import annotations

from typing import Any, Callable, Iterator, List, Tuple

Path = Tuple[Any, ...]
#: the block lists that the JAX package stacks along a leading axis
STACKED = ("layers", "shared", "enc_layers", "dec_layers")


def tree_map_with_path(fn: Callable, tree, *rest, path: Path = ()):
    """``fn(path, leaf, *leaves of rest)`` over every leaf of ``tree``
    (``rest``: trees of the same structure), in the same containers."""
    if isinstance(tree, dict):
        return {k: tree_map_with_path(fn, v, *(r[k] for r in rest),
                                      path=path + (k,))
                for k, v in tree.items()}
    if isinstance(tree, list):
        return [tree_map_with_path(fn, v, *(r[i] for r in rest),
                                   path=path + (i,))
                for i, v in enumerate(tree)]
    return fn(path, tree, *rest)


def tree_map(fn: Callable, tree, *rest):
    """``fn(leaf, *leaves of rest)`` over every leaf of ``tree``."""
    return tree_map_with_path(lambda _, *leaves: fn(*leaves), tree, *rest)


def tree_paths(tree, path: Path = ()) -> Iterator[Tuple[Path, Any]]:
    """(path, leaf) of every leaf, in ``tree_map``'s order."""
    if isinstance(tree, dict):
        for k, v in tree.items():
            yield from tree_paths(v, path + (k,))
    elif isinstance(tree, list):
        for i, v in enumerate(tree):
            yield from tree_paths(v, path + (i,))
    else:
        yield path, tree


def jax_leaf(path: Path) -> Path:
    """The JAX package's leaf that holds the port's leaf at ``path``: a
    block list's leaves of one name, across its blocks, are one stacked
    JAX leaf (``("layers", "ln1")`` for ``("layers", i, "ln1")``)."""
    if path and path[0] in STACKED:
        return (path[0],) + path[2:]
    return path


def tree_leaves(tree) -> List[Any]:
    return [leaf for _, leaf in tree_paths(tree)]


def tree_unflatten(like, leaves) -> Any:
    """``leaves`` (in ``tree_paths`` order) in the containers of
    ``like``."""
    it = iter(leaves)
    return tree_map(lambda _: next(it), like)
