"""Nested-dict trees of tensors: flatten, unflatten and map.

Leaves are ordered as JAX orders a dict pytree — keys sorted at every
level — so leaf ``i`` here is leaf ``i`` in the JAX package, which the
write plan's ``fold_in(key, i)`` schedule depends on.

``map_with_path`` also walks NamedTuples, lists and tuples (an
optimiser's state), with the key paths JAX gives them: a dict key, a
sequence index, or a NamedTuple field as a ``GetAttrKey``.
"""
from __future__ import annotations

from typing import Any, Callable, Dict, List, NamedTuple, Tuple

Path = Tuple[Any, ...]


def flatten(tree: Any, prefix: Path = ()) -> List[Tuple[Path, Any]]:
    if isinstance(tree, dict):
        out: List[Tuple[Path, Any]] = []
        for k in sorted(tree):
            out.extend(flatten(tree[k], prefix + (k,)))
        return out
    return [(prefix, tree)]


def unflatten(paths: List[Path], leaves: List[Any]) -> Any:
    if len(paths) == 1 and paths[0] == ():
        return leaves[0]
    root: Dict[Any, Any] = {}
    for path, leaf in zip(paths, leaves):
        node = root
        for k in path[:-1]:
            node = node.setdefault(k, {})
        node[path[-1]] = leaf
    return root


def leaves(tree: Any) -> List[Any]:
    return [leaf for _, leaf in flatten(tree)]


def tree_map(fn: Callable[..., Any], tree: Any, *rest: Any) -> Any:
    if isinstance(tree, dict):
        return {k: tree_map(fn, tree[k], *(r[k] for r in rest))
                for k in tree}
    return fn(tree, *rest)


class GetAttrKey(NamedTuple):
    """A NamedTuple field in a key path (JAX renders it ``.name``)."""
    name: str


def map_with_path(fn: Callable[[Path, Any], Any], tree: Any,
                  prefix: Path = ()) -> Any:
    """``fn(path, leaf)`` over every leaf of a tree of dicts, NamedTuples,
    lists and tuples, into a tree of the same structure (``None`` is an
    empty subtree, as in JAX)."""
    if tree is None:
        return None
    if isinstance(tree, dict):
        return {k: map_with_path(fn, tree[k], prefix + (k,))
                for k in sorted(tree)}
    if isinstance(tree, tuple) and hasattr(tree, "_fields"):
        return type(tree)(*(map_with_path(fn, v, prefix + (GetAttrKey(f),))
                            for f, v in zip(tree._fields, tree)))
    if isinstance(tree, (list, tuple)):
        return type(tree)(map_with_path(fn, v, prefix + (i,))
                          for i, v in enumerate(tree))
    return fn(prefix, tree)
