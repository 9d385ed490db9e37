"""Pytrees of tensors in the reference package's flattening order.

The port keeps the reference's parameter layout — nested dicts, tuples,
lists and named tuples with tensors at the leaves — so that traced
programs name their inputs with the same key paths (``"[0][0]['embed']"``,
``"[0][0].opt.step"``) and plans map between the two packages.  Dicts
flatten in sorted key order, sequences by index, named tuples by field
(spelled ``.field``), and ``None`` holds no leaf, as in the reference.
"""

from __future__ import annotations

from typing import Any, Callable, Iterator


def _is_namedtuple(node) -> bool:
    return isinstance(node, tuple) and hasattr(node, "_fields")


def _rebuild(node, children):
    """A sequence of ``node``'s type holding ``children``."""
    if _is_namedtuple(node):
        return type(node)(*children)
    return type(node)(children)


def _children(node) -> list[tuple[str, Any]] | None:
    """``[(keystr piece, child), ...]`` of a container, else ``None``."""
    if isinstance(node, dict):
        return [(f"[{k!r}]", node[k]) for k in sorted(node)]
    if _is_namedtuple(node):
        return [(f".{f}", getattr(node, f)) for f in node._fields]
    if isinstance(node, (tuple, list)):
        return [(f"[{i}]", c) for i, c in enumerate(node)]
    return None


def _walk(node, path: str, leaves: list, paths: list) -> None:
    if node is None:
        return
    kids = _children(node)
    if kids is None:
        leaves.append(node)
        paths.append(path)
        return
    for piece, child in kids:
        _walk(child, path + piece, leaves, paths)


def flatten_with_paths(tree) -> tuple[list, list[str]]:
    """Leaves of ``tree`` and their key paths, in flattening order.

    Args:
        tree: nested dicts / tuples / lists; ``None`` holds no leaf.

    Returns:
        ``(leaves, paths)`` with paths in the reference's ``keystr``
        spelling.
    """
    # the recursion is a module function, not a closure: a closure that
    # calls itself is a reference cycle, and it would keep the leaves
    # (whole train states, gradients) alive until the garbage collector
    # runs
    leaves: list = []
    paths: list[str] = []
    _walk(tree, "", leaves, paths)
    return leaves, paths


def tree_leaves(tree) -> list:
    """The leaves of ``tree`` in flattening order."""
    return flatten_with_paths(tree)[0]


def treedef(tree) -> Any:
    """A hashable description of ``tree``'s structure (the reference's
    treedef): container types and dict keys, with ``"*"`` at each leaf."""
    if tree is None:
        return None
    kids = _children(tree)
    if kids is None:
        return "*"
    return (type(tree), tuple(piece for piece, _ in kids),
            tuple(treedef(child) for _, child in kids))


def _build(node, it: Iterator):
    if node is None:
        return None
    if isinstance(node, dict):
        built = {k: _build(node[k], it) for k in sorted(node)}
        return {k: built[k] for k in node}
    if isinstance(node, (tuple, list)):
        return _rebuild(node, [_build(c, it) for c in node])
    try:
        return next(it)
    except StopIteration:
        raise ValueError("too few leaves for the template") from None


def unflatten(template, leaves) -> Any:
    """Rebuild ``template``'s structure with ``leaves`` in flatten order.

    Args:
        template: a tree with the target structure (its leaves are
            ignored).
        leaves: replacement leaves, in :func:`flatten_with_paths` order.

    Returns:
        A tree shaped like ``template``.

    Raises:
        ValueError: when the number of leaves does not match.
    """
    it: Iterator = iter(leaves)
    out = _build(template, it)
    if next(it, None) is not None:
        raise ValueError("too many leaves for the template")
    return out


def tree_map(fn: Callable, tree) -> Any:
    """Apply ``fn`` to every leaf, keeping the structure."""
    return unflatten(tree, [fn(x) for x in tree_leaves(tree)])


def _walk_keys(fn: Callable, node, keys: tuple):
    if node is None:
        return None
    if isinstance(node, dict):
        return {k: _walk_keys(fn, v, keys + (k,)) for k, v in node.items()}
    if isinstance(node, (tuple, list)):
        return _rebuild(node, [_walk_keys(fn, c, keys + (i,))
                               for i, c in enumerate(node)])
    return fn(keys, node)


def tree_map_with_path(fn: Callable, tree) -> Any:
    """Apply ``fn(keys, leaf)`` to every leaf, keeping the structure.

    Args:
        fn: called with the tuple of dict keys / sequence indices leading
            to the leaf, and the leaf.
        tree: the tree to map over.

    Returns:
        A tree shaped like ``tree`` holding ``fn``'s results.
    """
    return _walk_keys(fn, tree, ())
