"""FedSiKD's grouped aggregation over the client slots: the port of
``repro.core.cluster_collectives`` (``cluster_groups``, the ``packed_*``
operators the packed engine calls and the unpacked mesh operators).

In the JAX package each device holds a ``(pack,)`` block of client slots
and the grouped means are an ``all_gather`` plus a per-device weighted-row
contraction inside ``shard_map``.  The port does the same over a
``torch.distributed`` client mesh (``launch.mesh``): each rank holds its
``(S / W, ...)`` block of every leaf, all-gathers the blocks of all
leaves in float32 (one collective a call: the leaves' rows concatenated),
and contracts its own rows of the ``(S, S)`` table, or the ``(S,)`` row.
With no mesh, every slot lives in one ``(S, ...)`` stack per leaf and the
operators collapse to one product per leaf: ``table @ stack`` or
``row @ stack``, contracted in float32 and cast back to the leaf's dtype.
These are plain products that the JAX package leaves to XLA outside any
Pallas kernel, so they are ``torch.matmul`` here.  The teacher sync
averages about each slot's first cluster member, so equal replicas stay
equal bit for bit.  The operators are runtime tensors built from a
``RoundPlan`` (``sync_matrix``, ``agg_row``), as in JAX.

The unpacked operators (``intra_cluster_mean``, ``fedsikd_global_mean``,
``teacher_sync``, ``fedavg_mean``, ``broadcast_from``) hold one client a
rank, with the cluster groups baked in from its labels: the readable form
of the mapping, which the example and the tests drive.

Every collective here is ``all_gather``, ``all_reduce`` or ``broadcast``
over the mesh's process group, which gloo (on the CPU, or CUDA tensors)
and NCCL both take.
"""
from __future__ import annotations

from typing import Sequence

import numpy as np
import torch
import torch.distributed as dist

from repro_torch.launch.shardings import rank_slots
from repro_torch.tree import tree_map


def cluster_groups(assignments: Sequence[int]) -> list[list[int]]:
    """Partition of slot (or rank) indices by cluster id."""
    labels = np.asarray(assignments)
    return [np.flatnonzero(labels == k).tolist() for k in np.unique(labels)]


def _leaves(tree) -> list:
    out: list = []
    tree_map(out.append, tree)
    return out


def _replace_leaves(tree, new: list):
    it = iter(new)
    return tree_map(lambda _: next(it), tree)


def _gather_rows(leaves: list, mesh) -> list:
    """Each leaf's ``(S, n)`` float32 rows over every slot of the mesh.
    Each rank's ``(S / W, ...)`` blocks of all ``leaves`` are concatenated
    along their rows into one buffer and all-gathered once; each leaf's
    rows come back contiguous.  Without a mesh: each leaf's own rows."""
    flat = [x.reshape(x.shape[0], -1).to(torch.float32) for x in leaves]
    if mesh is None or not flat:
        return flat
    buf = torch.cat(flat, dim=1).contiguous()
    parts = [torch.empty_like(buf) for _ in range(mesh.size())]
    dist.all_gather(parts, buf, group=mesh.get_group())
    full = torch.cat(parts)
    out, at = [], 0
    for f in flat:
        out.append(full[:, at:at + f.shape[1]].contiguous())
        at += f.shape[1]
    return out


# -------------------------------------------------- client-packed operators
def packed_weighted_gather(tree, table, *, mesh=None):
    """Each slot's weighted sum of the slot stack: leaves are this rank's
    ``(S / W, ...)`` blocks (``(S, ...)`` without a mesh); ``table`` is an
    (S, S) matrix over global slot ids (slot ``i`` gets ``table[i] @
    stack``) or an (S,) row (every slot gets ``row @ stack``, returned as
    a broadcast view of the one result)."""
    table = torch.as_tensor(table, dtype=torch.float32)
    xs = _leaves(tree)
    rows = rank_slots(table.shape[-1], mesh)

    def contract(x, xf):
        w = table.to(xf.device)
        if w.dim() == 2:
            return (w[rows] @ xf).to(x.dtype).reshape(x.shape)
        return (w @ xf).to(x.dtype).reshape(x.shape[1:]).expand(x.shape)

    return _replace_leaves(tree, [contract(x, g) for x, g in
                                  zip(xs, _gather_rows(xs, mesh))])


def packed_teacher_sync(tree, sync_matrix, *, mesh=None):
    """Intra-cluster teacher-replica sync with the runtime row-stochastic
    (S, S) operator (``RoundPlan.sync_matrix()``: cluster members average
    over the cluster's active slots, idle slots keep an identity row).
    Integer leaves (Adam step counts) stay per slot: a float mean truncated
    back to int would corrupt a count whenever members ran unequal step
    budgets.

    The mean is taken about each slot's reference, the first slot of its
    row (the cluster's first member): ``x[ref] + table @ (x - x[ref])``,
    which is ``table @ x`` for an operator whose rows average over blocks
    of a partition of the slots, as the plan's does.  Replicas that are
    equal (leader mode trains them on identical batches) then sync to
    themselves bit for bit, whatever the number of members; ``table @ x``
    rounds ``n`` copies of ``x / n`` differently for each ``n``, so the
    same cohort would train different teachers in one wave and in
    several.  On a mesh the reference rows are read from the gathered
    stack, wherever they live."""
    table = torch.as_tensor(sync_matrix, dtype=torch.float32)
    ref = torch.argmax((table != 0).to(torch.int32), dim=1)
    rows = rank_slots(table.shape[0], mesh)
    xs = [x for x in _leaves(tree) if x.is_floating_point()]
    synced = iter(_gather_rows(xs, mesh))

    def leaf(x):
        if not x.is_floating_point():
            return x
        xf = next(synced)
        base = xf[ref.to(xf.device)]
        out = base[rows] + table.to(xf.device)[rows] @ (xf - base)
        return out.to(x.dtype).reshape(x.shape)

    return tree_map(leaf, tree)


def packed_weighted_mean(tree, weights, *, mesh=None):
    """Global weighted mean over slots with the runtime (S,) row
    (``RoundPlan.agg_row()``; weights sum to 1, idle slots weigh 0).  Every
    slot ends holding the same aggregate, which is how the packed engine
    broadcasts the new global student (on a mesh: every rank, bit for
    bit, as each contracts the same gathered stack)."""
    return packed_weighted_gather(tree, weights, mesh=mesh)


def gather_slots(tree, slots, *, mesh=None):
    """Rows ``slots`` (global slot ids) of every leaf, on every rank: a
    ``(len(slots), ...)`` stack a leaf, each row as the rank that holds it
    has it.  On a mesh, each rank writes the rows it holds into a buffer of
    zeros and one ``all_reduce`` a dtype sums them: every row has one
    nonzero term, so it arrives bit for bit.  Without a mesh: ``x[slots]``.
    The packed engines read each refreshed cluster's teacher from its
    first active slot, and a straggler's student from its lane, this way."""
    slots = np.asarray(slots, np.int64)
    xs = _leaves(tree)
    if mesh is None:
        idx = torch.as_tensor(slots, device=xs[0].device)
        return tree_map(lambda x: x[idx], tree)
    per = xs[0].shape[0]
    lo = mesh.get_local_rank() * per
    mine = np.flatnonzero((slots >= lo) & (slots < lo + per))
    out = []
    for x in xs:
        buf = x.new_zeros((len(slots),) + x.shape[1:])
        if len(mine):
            dst = torch.as_tensor(mine, device=x.device)
            buf[dst] = x[torch.as_tensor(slots[mine] - lo, device=x.device)]
        out.append(buf)
    by_dtype: dict = {}
    for i, b in enumerate(out):
        by_dtype.setdefault(b.dtype, []).append(i)
    for idx in by_dtype.values():
        flat = torch.cat([out[i].reshape(-1) for i in idx])
        dist.all_reduce(flat, group=mesh.get_group())
        at = 0
        for i in idx:
            n = out[i].numel()
            out[i] = flat[at:at + n].reshape(out[i].shape)
            at += n
    return _replace_leaves(tree, out)


# ------------------------------------------ one client a rank (static groups)
def _intra_matrix(groups: list[list[int]]) -> np.ndarray:
    D = sum(len(g) for g in groups)
    w = np.zeros((D, D), np.float32)
    for g in groups:
        for d in g:
            w[d, list(g)] = 1.0 / len(g)
    return w


def _global_row(groups: list[list[int]]) -> np.ndarray:
    D = sum(len(g) for g in groups)
    K = len(groups)
    row = np.zeros((D,), np.float32)
    for g in groups:
        row[list(g)] = 1.0 / (K * len(g))
    return row


def _weighted_gather(tree, mesh, table):
    """out = sum_e w[e] * x_e with x_e each rank's leaf, gathered across
    the mesh: the packed gather over a block of one slot a rank.
    ``table`` is a (W,) row, or a (W, W) matrix whose row for this rank's
    mesh position is taken."""
    out = packed_weighted_gather(tree_map(lambda x: x.unsqueeze(0), tree),
                                 table, mesh=mesh)
    return tree_map(lambda x: x[0], out)


def intra_cluster_mean(tree, mesh, groups: list[list[int]]):
    """Per-cluster mean across the client axis (Alg. 1 line 16): after this
    call every rank holds the mean over ITS OWN cluster."""
    return _weighted_gather(tree, mesh, _intra_matrix(groups))


def fedsikd_global_mean(tree, mesh, groups: list[list[int]], *,
                        weighting: str = "uniform"):
    """Two-level FedSiKD mean: (1/K) sum_k (1/|C_k|) sum_{i in C_k} w_i
    (Alg. 1 line 18) — every rank ends with the same global model.

    ``weighting="size"`` applies §IV-C.5's |C_k|/N cluster weights instead
    of the literal 1/K, which collapses to the flat mean over all
    clients."""
    if weighting == "size":
        D = sum(len(g) for g in groups)
        return _weighted_gather(tree, mesh,
                                np.full((D,), 1.0 / D, np.float32))
    if weighting != "uniform":
        raise ValueError(
            f"weighting must be 'uniform' or 'size', got {weighting!r}")
    return _weighted_gather(tree, mesh, _global_row(groups))


def teacher_sync(tree, mesh, groups: list[list[int]]):
    """Intra-cluster teacher-replica sync (Alg. 1 line 12, mesh-mapped):
    each rank's teacher copy becomes its cluster's mean.  Integer leaves
    (the Adam step count) stay per rank, as in ``packed_teacher_sync``."""
    synced = intra_cluster_mean(tree, mesh, groups)
    return tree_map(lambda orig, new: new if orig.is_floating_point()
                    else orig, tree, synced)


def fedavg_mean(tree, mesh, num_examples):
    """Example-weighted FedAvg all-reduce: sum_i (d_i/d) w_i, with
    ``num_examples`` this rank's client dataset size; every leaf's
    weighted term is reduced in one ``all_reduce``."""
    xs = _leaves(tree)
    dev = xs[0].device
    total = torch.as_tensor(num_examples, dtype=torch.float32,
                            device=dev).reshape(1).clone()
    dist.all_reduce(total, group=mesh.get_group())
    w = torch.as_tensor(num_examples, dtype=torch.float32, device=dev) / total
    flat = torch.cat([(x.to(torch.float32) * w).reshape(-1) for x in xs])
    dist.all_reduce(flat, group=mesh.get_group())
    out, at = [], 0
    for x in xs:
        out.append(flat[at:at + x.numel()].reshape(x.shape).to(x.dtype))
        at += x.numel()
    return _replace_leaves(tree, out)


def broadcast_from(tree, mesh, src: int,
                   groups: list[list[int]] | None = None):
    """Broadcast a rank's leaves along the client axis.  With ``groups``,
    ``src`` indexes WITHIN each group's rank list, implementing per-cluster
    teacher broadcast."""
    if groups is None:
        group = mesh.get_group()
        root = dist.get_global_rank(group, src)

        def leaf(x):
            y = x.clone()
            dist.broadcast(y, src=root, group=group)
            return y

        return tree_map(leaf, tree)
    D = sum(len(g) for g in groups)
    w = np.zeros((D, D), np.float32)
    for g in groups:
        leader = g[min(src, len(g) - 1)]
        for d in g:
            w[d, leader] = 1.0
    return _weighted_gather(tree, mesh, w)
