"""Parameter trees: nested dicts, tuples and named tuples of tensors.

Leaves come out in the JAX package's ``jax.tree`` order: a dict's keys
sorted at each level, a tuple's or named tuple's items in order, ``None``
holding no leaf.  Checkpoints store leaves in that order, so the two
packages can read each other's; the optimizers walk params, gradients and
moments in it.
"""
from __future__ import annotations


def leaves(tree) -> list:
    """The leaves of ``tree`` in ``jax.tree.leaves`` order."""
    if isinstance(tree, dict):
        return [x for k in sorted(tree) for x in leaves(tree[k])]
    if isinstance(tree, (tuple, list)):
        return [x for item in tree for x in leaves(item)]
    if tree is None:
        return []
    return [tree]


def unflatten(like, flat) -> object:
    """A tree of ``like``'s structure holding ``flat`` (in :func:`leaves`
    order); raises when the counts differ."""
    it = iter(flat)

    def build(t):
        if isinstance(t, dict):
            built = {k: build(t[k]) for k in sorted(t)}
            return {k: built[k] for k in t}
        if isinstance(t, tuple) and hasattr(t, "_fields"):
            return type(t)(*(build(x) for x in t))
        if isinstance(t, (tuple, list)):
            return type(t)(build(x) for x in t)
        if t is None:
            return None
        return next(it)

    out = build(like)
    if next(it, None) is not None:
        raise ValueError("more leaves than the tree holds")
    return out


def map(fn, tree, *rest):
    """``fn`` applied leaf by leaf to ``tree`` and trees of its structure."""
    flat = [leaves(t) for t in (tree, *rest)]
    n = len(flat[0])
    if any(len(f) != n for f in flat):
        raise ValueError("trees differ in their number of leaves")
    return unflatten(tree, [fn(*xs) for xs in zip(*flat)])


def named(tree, prefix: str = "") -> list:
    """``[(dotted path, leaf)]`` in :func:`leaves` order."""
    if isinstance(tree, dict):
        return [x for k in sorted(tree)
                for x in named(tree[k], f"{prefix}.{k}" if prefix else str(k))]
    if isinstance(tree, (tuple, list)):
        names = getattr(tree, "_fields", None) or range(len(tree))
        return [x for k, item in zip(names, tree)
                for x in named(item, f"{prefix}.{k}" if prefix else str(k))]
    if tree is None:
        return []
    return [(prefix, tree)]
