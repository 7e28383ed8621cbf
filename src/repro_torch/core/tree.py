"""Nested-container maps over tensors (the port's stand-in for ``jax.tree``).

Parameters, optimizer states and replay items are plain dicts, tuples and
NamedTuples of tensors, laid out as in the JAX package, so they convert
one to one (:mod:`repro_torch.core.params`).
"""

from __future__ import annotations

from typing import Any, Callable


def tree_map(fn: Callable, tree: Any, *rest: Any) -> Any:
    """Apply ``fn`` leafwise over ``tree`` and same-shaped ``rest`` trees."""
    if tree is None:
        return None
    if isinstance(tree, dict):
        return {k: tree_map(fn, tree[k], *(r[k] for r in rest)) for k in tree}
    if isinstance(tree, tuple) and hasattr(tree, "_fields"):
        return type(tree)(*(tree_map(fn, *xs) for xs in zip(tree, *rest)))
    if isinstance(tree, (list, tuple)):
        return type(tree)(tree_map(fn, *xs) for xs in zip(tree, *rest))
    return fn(tree, *rest)


def tree_leaves(tree: Any) -> list:
    """The leaves of ``tree`` in :func:`tree_map` order."""
    out: list = []
    tree_map(out.append, tree)
    return out
