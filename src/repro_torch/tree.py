"""Minimal pytree helpers over the port's parameter trees: nested dicts and
lists, with everything else (tensors, ``None``, named tuples, wraps, plans)
a leaf. Paths are tuples of dict keys and list indices, the same components
the JAX package's key paths carry."""
from __future__ import annotations


def map_with_path(fn, tree, *rest, path: tuple = ()):
    """``fn(path, leaf, *rest_leaves)`` over ``tree``; ``rest`` trees share
    its structure down to its leaves."""
    if isinstance(tree, dict):
        return {k: map_with_path(fn, v, *[r[k] for r in rest], path=path + (k,))
                for k, v in tree.items()}
    if isinstance(tree, list):
        return [map_with_path(fn, v, *[r[i] for r in rest], path=path + (i,))
                for i, v in enumerate(tree)]
    return fn(path, tree, *rest)


def map(fn, tree, *rest):  # noqa: A001 - mirrors jax.tree.map
    return map_with_path(lambda _, leaf, *r: fn(leaf, *r), tree, *rest)


def leaves_with_path(tree, path: tuple = ()) -> list:
    """``[(path, leaf), ...]`` in insertion order."""
    if isinstance(tree, dict):
        return [pl for k, v in tree.items() for pl in leaves_with_path(v, path + (k,))]
    if isinstance(tree, list):
        return [pl for i, v in enumerate(tree) for pl in leaves_with_path(v, path + (i,))]
    return [(path, tree)]


def leaves_sorted(tree, path: tuple = ()) -> list:
    """``[(path, leaf), ...]`` in ``jax.tree.flatten``'s order: dict keys
    sorted, lists in order. The update keys each leaf by its index in this
    order, as the reference does."""
    if isinstance(tree, dict):
        return [pl for k in sorted(tree) for pl in leaves_sorted(tree[k], path + (k,))]
    if isinstance(tree, list):
        return [pl for i, v in enumerate(tree) for pl in leaves_sorted(v, path + (i,))]
    return [(path, tree)]
