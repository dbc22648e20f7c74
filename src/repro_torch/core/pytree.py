"""Trees of tensors: nested ``dict``, ``list``, ``tuple`` and ``None`` nodes.

The port's stand-in for the part of ``jax.tree_util`` the JAX package uses.
Leaves come out in ``tree_flatten`` order: a dict's children by sorted key,
a list's or tuple's in order, and ``None`` holds no leaf.  Anything else is
a leaf, except subclasses of dict, list and tuple (``OrderedDict``,
named tuples, ...), which ``jax.tree_util`` treats as other node kinds: they
raise ``TypeError`` instead of being flattened in some other order.
"""

from __future__ import annotations

from typing import Any, Callable, Iterator, List, Tuple, Union

KeyPath = Tuple[Union[str, int], ...]


class _Leaf:
    __slots__ = ()

    def __repr__(self) -> str:
        return "*"


_LEAF = _Leaf()


def _kind(node) -> str:
    """"dict", "list", "tuple", "none" or "leaf"; subclasses raise."""
    if node is None:
        return "none"
    t = type(node)
    if t is dict:
        return "dict"
    if t is list:
        return "list"
    if t is tuple:
        return "tuple"
    if isinstance(node, (dict, list, tuple)):
        raise TypeError(f"{t.__name__} nodes are not supported (only dict, "
                        "list, tuple and None)")
    return "leaf"


class TreeDef:
    """A tree's structure: the tree with every leaf replaced by ``*``."""

    def __init__(self, skeleton: Any):
        self.skeleton = skeleton

    def __repr__(self) -> str:
        return f"TreeDef({self.skeleton!r})"

    def unflatten(self, leaves) -> Any:
        it: Iterator = iter(leaves)

        def build(node):
            kind = _kind(node)
            if kind == "dict":
                return {key: build(node[key]) for key in node}
            if kind in ("list", "tuple"):
                return type(node)(build(child) for child in node)
            if kind == "none":
                return None
            try:
                return next(it)
            except StopIteration:
                raise ValueError("too few leaves for the tree") from None

        out = build(self.skeleton)
        if next(it, _LEAF) is not _LEAF:
            raise ValueError("too many leaves for the tree")
        return out

    def flatten_up_to(self, tree) -> List[Any]:
        """``tree``'s subtrees at this structure's leaves, in leaf order;
        raises ``ValueError`` where the two structures differ."""
        out: List[Any] = []

        def walk(node, other, path):
            kind = _kind(node)
            if kind == "leaf":
                out.append(other)
                return
            if _kind(other) != kind:
                raise ValueError(f"tree structures differ at {path}: "
                                 f"{kind} vs {type(other).__name__}")
            if kind == "dict":
                if sorted(other) != list(node):
                    raise ValueError(f"dict keys differ at {path}: "
                                     f"{list(node)} vs {sorted(other)}")
                for key in node:
                    walk(node[key], other[key], path + (key,))
            elif kind in ("list", "tuple"):
                if len(other) != len(node):
                    raise ValueError(f"lengths differ at {path}: "
                                     f"{len(node)} vs {len(other)}")
                for i, (a, b) in enumerate(zip(node, other)):
                    walk(a, b, path + (i,))

        walk(self.skeleton, tree, ())
        return out


def tree_flatten(tree) -> Tuple[List[Any], TreeDef]:
    """``(leaves, treedef)`` in ``jax.tree_util.tree_flatten`` order."""
    leaves: List[Any] = []

    def walk(node):
        kind = _kind(node)
        if kind == "dict":
            return {key: walk(node[key]) for key in sorted(node)}
        if kind in ("list", "tuple"):
            return type(node)(walk(child) for child in node)
        if kind == "none":
            return None
        leaves.append(node)
        return _LEAF

    return leaves, TreeDef(walk(tree))


def tree_flatten_with_path(tree) -> List[Tuple[KeyPath, Any]]:
    """``[(key path, leaf), ...]`` in leaf order; a key path holds dict keys
    and list / tuple indices, as ``jax.tree_util.tree_flatten_with_path``
    gives them."""
    out: List[Tuple[KeyPath, Any]] = []

    def walk(node, path):
        kind = _kind(node)
        if kind == "dict":
            for key in sorted(node):
                walk(node[key], path + (key,))
        elif kind in ("list", "tuple"):
            for i, child in enumerate(node):
                walk(child, path + (i,))
        elif kind == "leaf":
            out.append((path, node))

    walk(tree, ())
    return out


def tree_leaves(tree) -> List[Any]:
    return tree_flatten(tree)[0]


def tree_map(fn: Callable, tree, *rest) -> Any:
    """``fn`` over the leaves of ``tree`` and the matching subtrees of each
    of ``rest``; the result has ``tree``'s structure."""
    leaves, treedef = tree_flatten(tree)
    others = [treedef.flatten_up_to(r) for r in rest]
    return treedef.unflatten([fn(*xs) for xs in zip(leaves, *others)])
