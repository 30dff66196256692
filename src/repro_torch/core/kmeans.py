"""Server-side k-means clustering of client statistics (paper §IV-A, Eq. 2)
plus the three cluster-quality metrics the paper uses to pick K
(Silhouette, Calinski-Harabasz, Davies-Bouldin): the port of
``repro.core.kmeans``.

The JAX sweep vmaps one masked ``k_cap``-wide program over the candidate K
values; here the same masked computation runs once per K in a Python loop,
so each candidate sees exactly the JAX arithmetic (invalid centroid slots
carry +inf distance, metrics use ``k_cap``-wide one-hots).  k-means++
seeding draws from a CPU ``torch.Generator`` seeded from an integer (the
JAX key's place; ``select_k`` folds each candidate K into it as JAX does),
so seeds — and with them clusters — can differ from the JAX package's on
the same seed.  Lloyd from given centroids (``kmeans_warm``) and the
metrics on given assignments are deterministic and match it.  Lloyd's
assignment steps run the ``kmeans_assign`` kernel; the seeding and the
metrics keep ``_sq_dists`` (seeding samples from the distances, and a
float-level change there could flip a sampled seed).
"""
from __future__ import annotations

from typing import NamedTuple

import torch
import torch.nn.functional as F

from repro_torch import rng
from repro_torch.kernels import ops

_EPS = 1e-9


class KMeansResult(NamedTuple):
    centroids: torch.Tensor    # (K, F)
    assignments: torch.Tensor  # (N,) int32
    inertia: torch.Tensor      # () — J of Eq. (2)


def _sq_dists(x, c):
    """(N, K) squared euclidean distances via the expansion trick."""
    x2 = torch.sum(x * x, dim=-1, keepdim=True)
    c2 = torch.sum(c * c, dim=-1)[None, :]
    return torch.clamp(x2 + c2 - 2.0 * (x @ c.T), min=0.0)


def _plus_plus_init(gen: torch.Generator, x, k: int, k_cap: int):
    """k-means++ seeding into a ``(k_cap, F)`` buffer of which the first
    ``k`` rows are populated (the masked form ``select_k`` shares)."""
    n = x.shape[0]
    first = int(torch.randint(0, n, (), generator=gen))
    cents = torch.zeros((k_cap, x.shape[1]), dtype=x.dtype, device=x.device)
    cents[0] = x[first]
    slots = torch.arange(k_cap, device=x.device)
    for i in range(1, k_cap):
        d = _sq_dists(x, cents)
        valid = slots < min(i, k)
        d = torch.where(valid[None, :], d, torch.inf).min(dim=1).values
        total = d.sum()
        # zero-mass guard (duplicate rows): uniform over the points
        probs = torch.where(total > _EPS, d / torch.clamp(total, min=_EPS),
                            torch.full((n,), 1.0 / n, dtype=x.dtype,
                                       device=x.device))
        idx = int(torch.multinomial(probs.cpu(), 1, generator=gen))
        if i < k:
            cents[i] = x[idx]
    return cents


def _lloyd(x, cents0, k: int, k_cap: int, iters: int) -> KMeansResult:
    """Lloyd's algorithm over the first ``k`` of ``k_cap`` centroid slots
    (invalid slots never win an assignment).

    Every E-step and the final assignment go through ``ops.kmeans_assign``
    (the CUDA kernel for a CUDA tensor) on the first ``k`` centroids only:
    the argmin over them is the JAX package's argmin over all ``k_cap``
    slots with the rest masked to +inf."""
    kmask = torch.arange(k_cap, device=x.device) < k
    cents = cents0
    for _ in range(iters):
        assign, _ = ops.kmeans_assign(x, cents[:k])
        onehot = F.one_hot(assign.long(), k_cap).to(x.dtype)
        counts = onehot.sum(dim=0)
        new = (onehot.T @ x) / torch.clamp(counts, min=1.0)[:, None]
        # keep the old centroid for empty clusters
        cents = torch.where(((counts > 0) & kmask)[:, None], new, cents)
    assign, dist = ops.kmeans_assign(x, cents[:k])
    return KMeansResult(cents, assign, dist.sum())


def kmeans(seed: int, x, k: int, iters: int = 50) -> KMeansResult:
    """k-means++ seeding (stream ``seed``) + Lloyd's algorithm (Eq. 2)."""
    return _lloyd(x, _plus_plus_init(rng.generator(seed), x, k, k), k, k,
                  iters)


def kmeans_warm(x, centroids, iters: int = 50) -> KMeansResult:
    """Lloyd's algorithm warm-started from ``centroids`` (K, F): no seeding
    pass, deterministic in its inputs."""
    k = centroids.shape[0]
    return _lloyd(x, centroids, k, k, iters)


# ------------------------------------------------------ cluster quality
def _silhouette_impl(x, assign, k_cap: int):
    assign = assign.long()
    d = torch.sqrt(_sq_dists(x, x))
    same = assign[:, None] == assign[None, :]
    onehot = F.one_hot(assign, k_cap).to(x.dtype)
    counts = onehot.sum(dim=0)
    sums = d @ onehot
    own = counts[assign]
    a = torch.where(own > 1,
                    torch.where(same, d, 0.0).sum(dim=1)
                    / torch.clamp(own - 1, min=1.0), 0.0)
    mean_to = sums / torch.clamp(counts[None, :], min=1.0)
    other = torch.where(onehot.bool(), torch.inf, mean_to)
    b = torch.where(counts[None, :] > 0, other, torch.inf).min(dim=1).values
    # empty-cluster guard: no other occupied cluster -> the 0 convention
    s = torch.where((own > 1) & torch.isfinite(b),
                    (b - a) / torch.clamp(torch.maximum(a, b), min=_EPS), 0.0)
    return s.mean()


def silhouette_score(x, assign, k: int):
    """Mean silhouette coefficient; higher is better."""
    return _silhouette_impl(x, assign, k)


def _calinski_impl(x, assign, k: int, k_cap: int):
    n = x.shape[0]
    assign = assign.long()
    onehot = F.one_hot(assign, k_cap).to(x.dtype)
    counts = onehot.sum(dim=0)
    cents = (onehot.T @ x) / torch.clamp(counts, min=1.0)[:, None]
    overall = x.mean(dim=0)
    ssb = torch.sum(counts * torch.sum((cents - overall) ** 2, dim=1))
    ssw = torch.sum((x - cents[assign]) ** 2)
    return (ssb / max(k - 1, 1)) / torch.clamp(ssw / max(n - k, 1), min=_EPS)


def calinski_harabasz(x, assign, k: int):
    """Between/within dispersion ratio; higher is better."""
    return _calinski_impl(x, assign, k, k)


def _davies_impl(x, assign, k_cap: int):
    assign = assign.long()
    onehot = F.one_hot(assign, k_cap).to(x.dtype)
    counts = onehot.sum(dim=0)
    cents = (onehot.T @ x) / torch.clamp(counts, min=1.0)[:, None]
    dist = torch.sqrt(torch.sum((x - cents[assign]) ** 2, dim=1))
    s = (onehot.T @ dist) / torch.clamp(counts, min=1.0)
    m = torch.sqrt(_sq_dists(cents, cents))
    ratio = (s[:, None] + s[None, :]) / torch.clamp(m, min=_EPS)
    eye = torch.eye(k_cap, dtype=torch.bool, device=x.device)
    ratio = torch.where(eye, -torch.inf, ratio)
    valid = (counts[:, None] > 0) & (counts[None, :] > 0)
    ratio = torch.where(valid, ratio, -torch.inf)
    worst = torch.where(counts > 0, ratio.max(dim=1).values, 0.0)
    return worst.sum() / torch.clamp((counts > 0).sum(), min=1)


def davies_bouldin(x, assign, k: int):
    """Mean worst-case cluster similarity; LOWER is better."""
    return _davies_impl(x, assign, k)


def _select_k_sweep(seed: int, x, ks: list[int], k_cap: int, iters: int):
    """(silhouette, calinski, davies, inertia) lists over the candidate K:
    the masked ``k_cap``-wide k-means per K, seeded on stream (seed, K)."""
    out = ([], [], [], [])
    for k in ks:
        cents0 = _plus_plus_init(rng.generator(seed, k), x, k, k_cap)
        res = _lloyd(x, cents0, k, k_cap, iters)
        vals = (_silhouette_impl(x, res.assignments, k_cap),
                _calinski_impl(x, res.assignments, k, k_cap),
                _davies_impl(x, res.assignments, k_cap), res.inertia)
        for lst, v in zip(out, vals):
            lst.append(float(v))
    return out


def vote(table: dict, ks: list[int]) -> int:
    """Each metric votes for its best K (max silhouette, max CH, min DB);
    the most votes wins and ties go to the smaller K."""
    votes = [
        max(ks, key=lambda k: table[k]["silhouette"]),
        max(ks, key=lambda k: table[k]["calinski_harabasz"]),
        min(ks, key=lambda k: table[k]["davies_bouldin"]),
    ]
    return max(set(votes), key=lambda k: (votes.count(k), -k))


def select_k(seed: int, x, k_min: int = 2, k_max: int = 8,
             iters: int = 50) -> tuple[int, dict[int, dict[str, float]]]:
    """Paper's K selection: sweep K, score with the three metrics, majority
    vote.  Returns (chosen_k, per-k metric table).  With fewer than
    ``k_min + 1`` points the answer is a single cluster (K=1)."""
    n = x.shape[0]
    if n < 1:
        raise ValueError("select_k needs at least one point")
    if k_max < k_min:
        raise ValueError(f"k_max ({k_max}) < k_min ({k_min})")
    ks = list(range(k_min, min(k_max, n - 1) + 1))
    if not ks:
        res = kmeans(seed, x, 1, iters)
        return 1, {1: {"silhouette": 0.0, "calinski_harabasz": 0.0,
                       "davies_bouldin": 0.0, "inertia": float(res.inertia)}}
    sil, ch, db, inertia = _select_k_sweep(seed, x, ks, max(ks), iters)
    table = {k: {"silhouette": sil[i], "calinski_harabasz": ch[i],
                 "davies_bouldin": db[i], "inertia": inertia[i]}
             for i, k in enumerate(ks)}
    return vote(table, ks), table
