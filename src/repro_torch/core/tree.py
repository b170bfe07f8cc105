"""Pytree flattening with JAX's semantics, for the public API's arguments,
specs and results.

``torch.utils._pytree`` differs from JAX in two ways that change which IR
parameter a leaf binds to: it flattens a dict in insertion order (JAX sorts
the keys, so two dicts with the same keys in another order have one
structure), and it treats ``None`` as a leaf (JAX: an empty subtree).  This
module follows JAX's default registry:

* ``dict``: children in sorted-key order; rebuilt with the keys sorted;
* ``collections.OrderedDict``: children in insertion order;
* ``list``, ``tuple`` and namedtuples: children in order;
* ``None``: a node with no children;
* anything else (tensors, arrays, scalars, specs, strings) is a leaf.
"""
from __future__ import annotations

import collections
from typing import Any, Iterable

__all__ = ["TreeDef", "tree_flatten", "tree_flatten_with_path", "tree_map",
           "tree_unflatten"]

_LEAF = "*"


class TreeDef:
    """The structure of a pytree: a node type, its static data (a dict's
    keys, a namedtuple's class) and its children's structures."""

    __slots__ = ("kind", "keys", "children")

    def __init__(self, kind: Any, keys: tuple = (), children: tuple = ()):
        self.kind = kind
        self.keys = keys
        self.children = children

    @property
    def num_leaves(self) -> int:
        if self.kind is _LEAF:
            return 1
        return sum(c.num_leaves for c in self.children)

    def _tuple(self) -> tuple:
        return (self.kind, self.keys, tuple(c._tuple() for c in self.children))

    def __eq__(self, other: object) -> bool:
        return isinstance(other, TreeDef) and self._tuple() == other._tuple()

    def __hash__(self) -> int:
        return hash(self._tuple())

    def _str(self) -> str:
        kids = [c._str() for c in self.children]
        if self.kind is _LEAF:
            return "*"
        if self.kind is None:
            return "None"
        if self.kind is tuple:
            return "(" + ", ".join(kids) + ("," if len(kids) == 1 else "") + ")"
        if self.kind is list:
            return "[" + ", ".join(kids) + "]"
        if self.kind is dict:
            return "{" + ", ".join(f"{k!r}: {c}" for k, c in zip(self.keys, kids)) + "}"
        if self.kind is collections.OrderedDict:
            return f"CustomNode(OrderedDict[{self.keys!r}], [{', '.join(kids)}])"
        return f"CustomNode(namedtuple[{self.kind.__name__}], [{', '.join(kids)}])"

    def __repr__(self) -> str:
        return f"PyTreeDef({self._str()})"


def _is_namedtuple(x: Any) -> bool:
    return isinstance(x, tuple) and hasattr(type(x), "_fields")


def _flatten(x: Any, leaves: list, path: tuple | None = None,
             paths: list | None = None) -> TreeDef:
    # With ``paths`` given, each leaf's path (its keys from the root, as
    # JAX prints them) is appended to it beside the leaf.
    if x is None:
        return TreeDef(None)
    t = type(x)
    if t is tuple or t is list or _is_namedtuple(x):
        names = ([f".{n}" for n in t._fields] if _is_namedtuple(x)
                 else [f"[{i}]" for i in range(len(x))])
        return TreeDef(t, (), tuple(_flatten(c, leaves, _sub(path, n), paths)
                                    for c, n in zip(x, names)))
    if t is dict or t is collections.OrderedDict:
        keys = tuple(sorted(x)) if t is dict else tuple(x)
        return TreeDef(t, keys, tuple(_flatten(x[k], leaves, _sub(path, str(k)), paths)
                                      for k in keys))
    leaves.append(x)
    if paths is not None:
        paths.append(path)
    return TreeDef(_LEAF)


def _sub(path: tuple | None, key: str) -> tuple | None:
    return None if path is None else path + (key,)


def tree_flatten(x: Any) -> tuple[list, TreeDef]:
    """``(leaves, treedef)`` in JAX's flatten order."""
    leaves: list = []
    treedef = _flatten(x, leaves)
    return leaves, treedef


def _build(td: TreeDef, it) -> Any:
    if td.kind is _LEAF:
        return next(it)
    if td.kind is None:
        return None
    kids = [_build(c, it) for c in td.children]
    if td.kind is tuple or td.kind is list:
        return td.kind(kids)
    if td.kind is dict or td.kind is collections.OrderedDict:
        return td.kind(zip(td.keys, kids))
    return td.kind(*kids)  # a namedtuple


def tree_unflatten(treedef: TreeDef, leaves: Iterable) -> Any:
    """The pytree of ``treedef``'s structure over ``leaves`` (flatten order)."""
    leaves = list(leaves)
    if len(leaves) != treedef.num_leaves:
        raise ValueError(
            f"tree_unflatten: {treedef} takes {treedef.num_leaves} leaves, "
            f"got {len(leaves)}"
        )
    return _build(treedef, iter(leaves))


def tree_flatten_with_path(x: Any) -> tuple[list[tuple[tuple, Any]], TreeDef]:
    """``([(path, leaf), ...], treedef)`` in flatten order; a path is a
    tuple of strings as JAX prints its keys: a dict key, ``[i]`` for a
    list or tuple index, ``.name`` for a namedtuple field."""
    leaves: list = []
    paths: list = []
    treedef = _flatten(x, leaves, (), paths)
    return list(zip(paths, leaves)), treedef


def tree_map(fn, tree: Any, *rest: Any) -> Any:
    """``fn`` over the leaves of ``tree`` (and the matching leaves of
    ``rest``, which must have its structure), rebuilt in its structure."""
    leaves, treedef = tree_flatten(tree)
    others = []
    for r in rest:
        r_leaves, r_def = tree_flatten(r)
        if r_def != treedef:
            raise ValueError(f"tree_map: structures differ: {treedef} and {r_def}")
        others.append(r_leaves)
    return tree_unflatten(treedef, [fn(*xs) for xs in zip(leaves, *others)])
