"""Dirichlet non-i.i.d. client partitioner (paper §V-A: alpha in {2,1,0.5,0.1},
40 clients).  Lower alpha -> more heterogeneous label distribution.
"""
from __future__ import annotations

import numpy as np


def dirichlet_partition(
    labels: np.ndarray,
    num_clients: int,
    alpha: float,
    *,
    seed: int = 0,
    min_per_client: int = 8,
) -> list[np.ndarray]:
    """Split example indices across clients with per-class Dirichlet draws.

    For every class c, draw p ~ Dir(alpha * 1_N) and deal class-c examples to
    clients proportionally to p.  Retries until every client has at least
    ``min_per_client`` examples (standard practice so each client can train).
    Returns a list of index arrays, one per client.
    """
    labels = np.asarray(labels)
    rng = np.random.default_rng(seed)
    classes = np.unique(labels)
    for _attempt in range(100):
        shards: list[list[int]] = [[] for _ in range(num_clients)]
        for c in classes:
            idx = np.flatnonzero(labels == c)
            rng.shuffle(idx)
            p = rng.dirichlet(np.full(num_clients, alpha))
            cuts = (np.cumsum(p)[:-1] * len(idx)).astype(int)
            for shard, part in zip(shards, np.split(idx, cuts)):
                shard.extend(part.tolist())
        sizes = np.array([len(s) for s in shards])
        if sizes.min() >= min_per_client:
            break
    else:
        # Returning the last failed attempt would hand downstream training a
        # near-empty client (crash at best, a silently useless shard at
        # worst) — refuse with the numbers that make the draw infeasible.
        raise ValueError(
            "dirichlet_partition could not give every client >= "
            f"min_per_client={min_per_client} examples in 100 attempts "
            f"(alpha={alpha}, num_clients={num_clients}, "
            f"{len(labels)} examples, smallest shard {sizes.min()}); "
            "raise alpha, lower num_clients, or lower min_per_client")
    out = []
    for s in shards:
        a = np.asarray(sorted(s), np.int64)
        out.append(a)
    return out


def heterogeneity(parts: list[np.ndarray], labels: np.ndarray, num_classes: int) -> float:
    """Mean total-variation distance between client label dists and the global
    label dist — a scalar summary of how non-iid the partition is (1=disjoint)."""
    labels = np.asarray(labels)
    glob = np.bincount(labels, minlength=num_classes) / len(labels)
    tvs = []
    for p in parts:
        if len(p) == 0:
            tvs.append(1.0)
            continue
        d = np.bincount(labels[p], minlength=num_classes) / len(p)
        tvs.append(0.5 * np.abs(d - glob).sum())
    return float(np.mean(tvs))
