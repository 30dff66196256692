"""``tree_map`` over the port's state containers: dicts of tensors (params,
Adam moments) and tuples or NamedTuples of them (``AdamState``) — the
subset of ``jax.tree_util.tree_map`` the packed engine needs — and
``flatten`` / ``unflatten`` between a language model's nested params and
the flat dotted-key dicts the optimizers take."""
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


def flatten(tree, prefix: str = "") -> dict:
    """A nest of dicts -> ``{dotted key: leaf}``, the keys named as
    ``convert.py`` names them (``layers.attn.wq``); the leaves themselves,
    not copies.  A flat dict comes back with the same keys."""
    if not isinstance(tree, dict):
        return {prefix[:-1]: tree}
    out = {}
    for k, v in tree.items():
        out.update(flatten(v, f"{prefix}{k}."))
    return out


def unflatten(flat: dict) -> dict:
    """The inverse of ``flatten``: ``{dotted key: leaf}`` -> nested dicts."""
    root: dict = {}
    for key, leaf in flat.items():
        *path, last = key.split(".")
        node = root
        for p in path:
            node = node.setdefault(p, {})
        node[last] = leaf
    return root
