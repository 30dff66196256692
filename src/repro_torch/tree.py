"""``tree_map`` over the port's state containers: dicts of tensors (params,
Adam moments) and tuples or NamedTuples of them (``AdamState``) — the
subset of ``jax.tree_util.tree_map`` the packed engine needs."""
from __future__ import annotations


def tree_map(fn, tree, *rest):
    """``fn`` applied leaf by leaf over ``tree`` and the same-structured
    ``rest``; dicts keep their keys, NamedTuples their type."""
    if isinstance(tree, dict):
        return {k: tree_map(fn, v, *(r[k] for r in rest))
                for k, v in tree.items()}
    if isinstance(tree, (tuple, list)):
        vals = [tree_map(fn, v, *(r[i] for r in rest))
                for i, v in enumerate(tree)]
        if hasattr(tree, "_fields"):
            return type(tree)(*vals)
        return type(tree)(vals)
    return fn(tree, *rest)
