"""Nested parameter and state trees: dicts, lists and the two node types
of the optimizer (``AdamWState``, ``QTensor``), with tensors (or arrays)
at the leaves.

Paths name a leaf as the reference's checkpoint store names it from
``jax.tree_util.tree_flatten_with_path``: dict keys and list indices as
they are, a ``NamedTuple`` field as ``.name``, a ``QTensor``'s payload and
scales as ``0`` and ``1``, joined by ``/`` (``opt_state/.m/layers/0/mixer/
wq/0``), so both stores write the same keys for the same tree.
"""
from __future__ import annotations

from typing import Any, Callable, Iterator, List, Optional, Tuple


def _children(node) -> Optional[Tuple[List[Tuple[str, Any]], Callable]]:
    """(named children, rebuild from their new values) of an inner node;
    None for a leaf.  A node type other than dict and list names its own
    children (``tree_children``, ``tree_rebuild``)."""
    if isinstance(node, dict):
        keys = list(node)
        return ([(str(k), node[k]) for k in keys],
                lambda vals: dict(zip(keys, vals)))
    if isinstance(node, list):
        return [(str(i), c) for i, c in enumerate(node)], list
    if hasattr(node, "tree_children"):
        return node.tree_children(), node.tree_rebuild
    return None


def leaves_with_paths(tree, prefix: str = "") -> Iterator[Tuple[str, Any]]:
    """Every (path, leaf), depth first, dict keys in insertion order."""
    kids = _children(tree)
    if kids is None:
        yield prefix, tree
        return
    for name, child in kids[0]:
        yield from leaves_with_paths(child, f"{prefix}/{name}" if prefix else name)


def leaves(tree) -> List[Any]:
    return [leaf for _, leaf in leaves_with_paths(tree)]


def map_with_paths(fn: Callable[[str, Any], Any], tree, prefix: str = ""):
    """The tree rebuilt with ``fn(path, leaf)`` at every leaf."""
    kids = _children(tree)
    if kids is None:
        return fn(prefix, tree)
    named, rebuild = kids
    return rebuild([map_with_paths(fn, c, f"{prefix}/{n}" if prefix else n)
                    for n, c in named])


def tree_map(fn: Callable, tree, *rest):
    """``fn`` over the leaves of ``tree`` and, at the same places, the
    subtrees of ``rest`` (trees with at least ``tree``'s structure: a
    ``QTensor`` moment beside a parameter is passed whole)."""
    kids = _children(tree)
    if kids is None:
        return fn(tree, *rest)
    named, rebuild = kids
    others = [_children(r)[0] for r in rest]
    return rebuild([tree_map(fn, child, *(o[i][1] for o in others))
                    for i, (_, child) in enumerate(named)])
