"""Nested containers of tensors (dicts, lists, tuples and named tuples, with
``None`` as an empty subtree): the few tree operations the training path
needs, in the reference's leaf order (dict keys sorted, sequences by
index), where the reference uses ``jax.tree``."""

from __future__ import annotations


def _children(tree):
    if isinstance(tree, dict):
        return [(k, tree[k]) for k in sorted(tree)]
    if isinstance(tree, (list, tuple)):
        return list(enumerate(tree))
    return None


def leaves_with_paths(tree, prefix: tuple = ()) -> list:
    """``[(path, leaf), ...]``; a path is the tuple of keys and indices."""
    if tree is None:
        return []
    kids = _children(tree)
    if kids is None:
        return [(prefix, tree)]
    out = []
    for k, v in kids:
        out += leaves_with_paths(v, prefix + (k,))
    return out


def leaves(tree) -> list:
    return [leaf for _, leaf in leaves_with_paths(tree)]


def map_(fn, tree, *rest):
    """``fn`` over the leaves of ``tree`` and the matching leaves of
    ``rest`` (trees of the same structure); a new tree of the results."""
    if tree is None:
        return None
    if isinstance(tree, dict):
        return {k: map_(fn, v, *(r[k] for r in rest)) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        out = [map_(fn, v, *(r[i] for r in rest)) for i, v in enumerate(tree)]
        if hasattr(tree, "_fields"):  # a named tuple
            return type(tree)(*out)
        return type(tree)(out)
    return fn(tree, *rest)


def unflatten(like, new_leaves):
    """A tree of ``like``'s structure holding ``new_leaves`` (in the order
    ``leaves(like)`` gives)."""
    it = iter(new_leaves)

    def build(t):
        if t is None:
            return None
        if isinstance(t, dict):
            return {k: build(t[k]) for k in sorted(t)}
        if isinstance(t, (list, tuple)):
            out = [build(v) for v in t]
            return type(t)(*out) if hasattr(t, "_fields") else type(t)(out)
        return next(it)

    return build(like)
