"""Trees of tensors: flatten, unflatten and map, in JAX's leaf order.

A tree is built from dicts (walked in sorted-key order), NamedTuples
(field order), lists and tuples (index order) and ``None`` (an empty
subtree); anything else is a leaf. Leaf ``i`` here is leaf ``i`` in the
JAX package, which the write plan's and the checkpointer's
``fold_in(key, i)`` schedules depend on.

Key paths are the ones JAX gives: a dict key, a sequence index, or a
NamedTuple field as a ``GetAttrKey``; ``core.priority.keystr`` renders
them as ``jax.tree_util.keystr`` does (``"['opt'].m['w']"``).

``structure(tree)`` returns a ``TreeDef`` that rebuilds the same
structure from a list of leaves (``unflatten``) and cuts a tree of the
same structure at this one's leaves (``flatten_up_to``: a tree of
logical-axis tuples, or of devices, one per leaf).
"""
from __future__ import annotations

from typing import Any, Callable, List, NamedTuple, Tuple

Path = Tuple[Any, ...]


class GetAttrKey(NamedTuple):
    """A NamedTuple field in a key path (JAX renders it ``.name``)."""
    name: str


def _is_namedtuple_type(typ: type) -> bool:
    return issubclass(typ, tuple) and hasattr(typ, "_fields")


def _children(tree: Any):
    """(kind, [(path key, child)]) of an inner node, or None for a leaf."""
    if isinstance(tree, dict):
        return "dict", [(k, tree[k]) for k in sorted(tree)]
    if _is_namedtuple_type(type(tree)):
        return "namedtuple", [(GetAttrKey(f), v)
                              for f, v in zip(tree._fields, tree)]
    if isinstance(tree, (list, tuple)):
        return "sequence", list(enumerate(tree))
    return None


class TreeDef:
    """The structure of a tree: ``unflatten`` puts leaves back into it."""

    def __init__(self, node: Any):
        # node: None (a None subtree), "*" (a leaf) or (type, keys, kids)
        self._node = node

    def unflatten(self, leaves: List[Any]) -> Any:
        it = iter(leaves)
        out = _build(self._node, it)
        assert next(it, None) is None, "more leaves than the structure holds"
        return out

    def flatten_up_to(self, tree: Any) -> List[Any]:
        """The subtrees of ``tree`` (a tree of this structure, or a
        deeper one) at this structure's leaves, in leaf order."""
        out: List[Any] = []
        _collect(self._node, tree, out)
        return out


# The recursions are module functions, not closures: a closure that calls
# itself holds a reference cycle through its own cell, and the cycle would
# keep the leaves it reached (whole KV caches on the card) alive until the
# garbage collector next runs.
def _build(node: Any, it) -> Any:
    if node is None:
        return None
    if node == "*":
        return next(it)
    typ, keys, kids = node
    vals = [_build(k, it) for k in kids]
    if typ is dict:
        return dict(zip(keys, vals))
    if _is_namedtuple_type(typ):
        return typ(*vals)
    return typ(vals)


def _collect(node: Any, t: Any, out: List[Any]) -> None:
    if node is None:
        return
    if node == "*":
        out.append(t)
        return
    typ, keys, kids = node
    if typ is dict:
        assert sorted(t) == list(keys), (sorted(t), keys)
        vals = [t[k] for k in keys]
    else:
        assert len(t) == len(kids), (len(t), len(kids))
        vals = list(t)
    for k, v in zip(kids, vals):
        _collect(k, v, out)


def _walk(tree: Any, prefix: Path, out: List[Tuple[Path, Any]]) -> Any:
    if tree is None:
        return None
    kids = _children(tree)
    if kids is None:
        out.append((prefix, tree))
        return "*"
    kind, items = kids
    nodes = [_walk(v, prefix + (k,), out) for k, v in items]
    keys = tuple(k for k, _ in items) if kind == "dict" else None
    return (dict if kind == "dict" else type(tree), keys, nodes)


def flatten_with_def(tree: Any) -> Tuple[List[Tuple[Path, Any]], TreeDef]:
    """(list of (key path, leaf) in JAX's order, the tree's ``TreeDef``)."""
    out: List[Tuple[Path, Any]] = []
    node = _walk(tree, (), out)
    return out, TreeDef(node)


def flatten(tree: Any) -> List[Tuple[Path, Any]]:
    return flatten_with_def(tree)[0]


def structure(tree: Any) -> TreeDef:
    return flatten_with_def(tree)[1]


def leaves(tree: Any) -> List[Any]:
    return [leaf for _, leaf in flatten(tree)]


def tree_map(fn: Callable[..., Any], tree: Any, *rest: Any) -> Any:
    """``fn`` over the leaves of ``tree`` and the same-structure ``rest``,
    into a tree of the same structure."""
    flat, tdef = flatten_with_def(tree)
    others = [tdef.flatten_up_to(r) for r in rest]
    return tdef.unflatten([fn(leaf, *(o[i] for o in others))
                           for i, (_, leaf) in enumerate(flat)])


def map_with_path(fn: Callable[[Path, Any], Any], tree: Any) -> Any:
    """``fn(path, leaf)`` over every leaf, into a tree of the same
    structure (``None`` is an empty subtree, as in JAX)."""
    flat, tdef = flatten_with_def(tree)
    return tdef.unflatten([fn(p, leaf) for p, leaf in flat])
