"""FL+HC baseline (Briggs et al. 2020): agglomerative clustering of client
model updates with 'average' linkage and Euclidean distances, cut at a
distance threshold (or at a target number of clusters).  A copy of the
numpy module ``repro.core.hierarchical``; only ``flatten_update`` differs,
reading the port's dict of tensors.

This runs server-side on (N_clients, P) flattened update vectors; N is small
(tens), so a plain O(N^3) numpy implementation is appropriate.
"""
from __future__ import annotations

import numpy as np


def _pairwise(x: np.ndarray) -> np.ndarray:
    x2 = np.sum(x * x, axis=1)
    d2 = x2[:, None] + x2[None, :] - 2.0 * (x @ x.T)
    return np.sqrt(np.maximum(d2, 0.0))


def agglomerative(
    updates: np.ndarray,
    *,
    distance_threshold: float | None = None,
    n_clusters: int | None = None,
) -> np.ndarray:
    """Average-linkage agglomerative clustering.

    Exactly one of ``distance_threshold`` / ``n_clusters`` must be given.
    Returns int32 labels (N,), compacted to 0..K-1.
    """
    if (distance_threshold is None) == (n_clusters is None):
        raise ValueError("give exactly one of distance_threshold / n_clusters")
    x = np.asarray(updates, np.float64)
    n = x.shape[0]
    d = _pairwise(x)
    np.fill_diagonal(d, np.inf)
    active = list(range(n))
    members: dict[int, list[int]] = {i: [i] for i in range(n)}
    dist = d.copy()

    while len(active) > (n_clusters or 1):
        # find closest active pair
        sub = dist[np.ix_(active, active)]
        ij = np.unravel_index(np.argmin(sub), sub.shape)
        a, b = active[ij[0]], active[ij[1]]
        if distance_threshold is not None and dist[a, b] > distance_threshold:
            break
        # average linkage: d(new, k) = (|a| d(a,k) + |b| d(b,k)) / (|a|+|b|)
        na, nb = len(members[a]), len(members[b])
        for k in active:
            if k in (a, b):
                continue
            dist[a, k] = dist[k, a] = (na * dist[a, k] + nb * dist[b, k]) / (na + nb)
        members[a].extend(members[b])
        del members[b]
        active.remove(b)

    labels = np.empty(n, np.int32)
    for lab, (_, idxs) in enumerate(sorted(members.items())):
        for i in idxs:
            labels[i] = lab
    return labels


def flatten_update(update: dict) -> np.ndarray:
    """Flatten a model update (a dict of tensors) to the vector FL+HC
    clusters on: the leaves in sorted key order, read to the host as
    float32.  Distances do not depend on the order, but every client's
    vector must use the same one."""
    return np.concatenate([update[k].detach().float().cpu().numpy().ravel()
                           for k in sorted(update)])
