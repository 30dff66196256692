"""Placements of the packed engine's slot stacks on the client mesh: the
port of the client half of ``repro.launch.shardings``
(``client_stack_specs``, ``check_divisible``) and the helper that cuts a
rank's block out of a full slot stack.

Every leaf the packed round programs take (params, optimizer state, staged
batches, per-slot budgets and seeds) carries a leading ``(S,)`` slot axis
sharded over the ``clients`` axis, the other dims replicated: placement
``(Shard(0),)`` on the 1-D mesh.  The engine holds each rank's block as a
plain local tensor (``rank_slots`` / ``local_block``) and runs its
collectives over the mesh's process group itself
(``core.cluster_collectives``), as JAX's ``shard_map`` body does.
"""
from __future__ import annotations

from repro_torch.launch.mesh import CLIENT_AXIS
from repro_torch.tree import tree_map


def client_stack_specs(tree, mesh, *, axis: str = CLIENT_AXIS):
    """Placements for client-stacked pytrees: ``(Shard(0),)`` a leaf (the
    leading slot axis over ``axis``).  Raises when the mesh has no such
    axis."""
    names = tuple(mesh.mesh_dim_names or ())
    if axis not in names:
        raise ValueError(f"mesh has axes {names}, no {axis!r}")
    from torch.distributed.tensor import Shard
    return tree_map(lambda leaf: (Shard(0),), tree)


def _paths(tree, prefix="", is_leaf=lambda x: False):
    """(path, leaf) of every leaf, the path's parts joined by ``/``."""
    if is_leaf(tree):
        yield prefix[:-1], tree
    elif isinstance(tree, dict):
        for k, v in tree.items():
            yield from _paths(v, f"{prefix}{k}/", is_leaf)
    elif isinstance(tree, (tuple, list)):
        names = getattr(tree, "_fields", range(len(tree)))
        for k, v in zip(names, tree):
            yield from _paths(v, f"{prefix}{k}/", is_leaf)
    else:
        yield prefix[:-1], tree


def _is_placements(x) -> bool:
    from torch.distributed.tensor import Placement
    return isinstance(x, tuple) and all(isinstance(p, Placement) for p in x)


def check_divisible(shape_tree, spec_tree, mesh) -> list[str]:
    """Sanity: every sharded dim divides its mesh axis; returns the
    offending leaves' paths (empty = ok).  ``spec_tree`` holds a tuple of
    placements a leaf, one a mesh dim (``client_stack_specs``)."""
    specs = dict(_paths(spec_tree, is_leaf=_is_placements))
    bad = []
    for path, leaf in _paths(shape_tree):
        for mesh_dim, placement in enumerate(specs[path]):
            if (placement.is_shard()
                    and leaf.shape[placement.dim] % mesh.size(mesh_dim)):
                bad.append(path)
    return bad


def rank_slots(n_slots: int, mesh) -> slice:
    """This rank's contiguous block of ``n_slots`` slots on the 1-D mesh
    (every slot without a mesh)."""
    if mesh is None:
        return slice(0, n_slots)
    world = mesh.size()
    if n_slots % world:
        raise ValueError(f"a world of {world} ranks cannot hold "
                         f"{n_slots} slots in equal blocks")
    per = n_slots // world
    r = mesh.get_local_rank()
    return slice(r * per, (r + 1) * per)


def local_block(tree, mesh):
    """This rank's block of every full ``(S, ...)`` slot stack in ``tree``
    (tensors or numpy arrays), cut where ``client_stack_specs`` shards it;
    the tree itself without a mesh."""
    if mesh is None:
        return tree
    specs = client_stack_specs(tree, mesh)

    def cut(a, placements):
        (shard,) = placements
        index = [slice(None)] * a.ndim
        index[shard.dim] = rank_slots(a.shape[shard.dim], mesh)
        return a[tuple(index)]

    return tree_map(cut, tree, specs)
