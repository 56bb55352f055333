"""Nested dicts/lists/tuples of tensors (the port's parameter and
optimizer-state trees), walked in JAX's pytree order: dict keys sorted,
sequences in order. Leaves are whatever is not a dict, list or tuple.

``leaves`` and ``paths`` give the same order as ``jax.tree.leaves`` and
``jax.tree_util.tree_flatten_with_path``, so sums over leaves add in the
reference's order and checkpoint keys are the reference's.
"""
from __future__ import annotations


def _children(tree):
    if isinstance(tree, dict):
        return [(k, tree[k]) for k in sorted(tree)]
    if isinstance(tree, (list, tuple)):
        return list(enumerate(tree))
    return None


def paths(tree, prefix=()):
    """[(path tuple, leaf)] in pytree order."""
    kids = _children(tree)
    if kids is None:
        return [(prefix, tree)]
    out = []
    for k, v in kids:
        out.extend(paths(v, prefix + (k,)))
    return out


def leaves(tree):
    return [leaf for _, leaf in paths(tree)]


def tree_map(fn, tree, *rest):
    """``fn`` over the leaves of ``tree`` and the matching leaves of
    ``rest`` (same structure), keeping the structure of ``tree``."""
    if isinstance(tree, dict):
        return {k: tree_map(fn, tree[k], *(r[k] for r in rest)) for k in tree}
    if isinstance(tree, (list, tuple)):
        return type(tree)(tree_map(fn, v, *(r[i] for r in rest))
                          for i, v in enumerate(tree))
    return fn(tree, *rest)


def unflatten(tree, new_leaves):
    """The structure of ``tree`` (keys in its own order) with
    ``new_leaves``, which come in pytree order."""
    it = iter(new_leaves)

    def build(t):
        if isinstance(t, dict):
            built = {k: build(t[k]) for k in sorted(t)}
            return {k: built[k] for k in t}
        if isinstance(t, (list, tuple)):
            return type(t)(build(v) for v in t)
        return next(it)
    out = build(tree)
    if next(it, None) is not None:
        raise ValueError("more leaves than the tree holds")
    return out
