"""FedSiKD's grouped aggregation over a stack of client slots: the port of
``repro.core.cluster_collectives`` (``cluster_groups`` and the ``packed_*``
operators the packed engine calls).

In the JAX package each device holds a ``(pack,)`` block of client slots and
the grouped means are an ``all_gather`` plus a per-device weighted-row
contraction inside ``shard_map``.  On one card every slot lives in one
``(S, ...)`` stack per leaf, so the operators collapse to one product per
leaf: ``table (S, S) @ stack`` (a row per slot) or ``row (S,) @ stack``,
contracted in float32 and cast back to the leaf's dtype (the teacher sync
about each slot's first cluster member, so equal replicas stay equal bit
for bit).  These are plain
products that the JAX package leaves to XLA outside any Pallas kernel, so
they are ``torch.matmul`` here.  The operators are runtime tensors built
from a ``RoundPlan`` (``sync_matrix``, ``agg_row``), as in JAX.
"""
from __future__ import annotations

from typing import Sequence

import numpy as np
import torch

from repro_torch.tree import tree_map


def cluster_groups(assignments: Sequence[int]) -> list[list[int]]:
    """Partition of slot indices by cluster id."""
    labels = np.asarray(assignments)
    return [np.flatnonzero(labels == k).tolist() for k in np.unique(labels)]


def packed_weighted_gather(tree, table):
    """Each slot's weighted sum of the slot stack: leaves are ``(S, ...)``;
    ``table`` is an (S, S) matrix (slot ``i`` gets ``table[i] @ stack``) or
    an (S,) row (every slot gets ``row @ stack``, returned as a broadcast
    view of the one result)."""
    table = torch.as_tensor(table, dtype=torch.float32)

    def leaf(x):
        S = x.shape[0]
        xf = x.reshape(S, -1).to(torch.float32)
        w = table.to(xf.device)
        if w.dim() == 2:
            return (w @ xf).to(x.dtype).reshape(x.shape)
        return (w @ xf).to(x.dtype).reshape(x.shape[1:]).expand(x.shape)

    return tree_map(leaf, tree)


def packed_teacher_sync(tree, sync_matrix):
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
    several."""
    table = torch.as_tensor(sync_matrix, dtype=torch.float32)
    ref = torch.argmax((table != 0).to(torch.int32), dim=1)

    def leaf(x):
        if not x.is_floating_point():
            return x
        S = x.shape[0]
        xf = x.reshape(S, -1).to(torch.float32)
        base = xf[ref.to(xf.device)]
        out = base + table.to(xf.device) @ (xf - base)
        return out.to(x.dtype).reshape(x.shape)

    return tree_map(leaf, tree)


def packed_weighted_mean(tree, weights):
    """Global weighted mean over slots with the runtime (S,) row
    (``RoundPlan.agg_row()``; weights sum to 1, idle slots weigh 0).  Every
    slot ends holding the same aggregate, which is how the packed engine
    broadcasts the new global student."""
    return packed_weighted_gather(tree, weights)
