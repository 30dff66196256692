"""Weight aggregation operators: the port of ``repro.core.aggregation``.

FedAvg:        w_g = sum_i (d_i / d) w_i                        (McMahan '17)
FedSiKD (Alg. 1, lines 16-18):
               wbar_k = (1/|C_k|) sum_{i in C_k} w_i
               w_g    = (1/K)    sum_k          wbar_k
Staleness (semi-async rounds): an update merged ``s`` rounds late counts
with its base weight decayed by (1 + s)^(-a), renormalised over the round's
contributions.

Parameters are dicts of tensors.  Every weighted merge goes through ONE
fused contraction over all leaves (``_fused_merge`` ->
``kernels.ops.fused_merge_leaves``): one CUDA kernel launch a dtype for
tensors on the card, its plain version leaf by leaf on the CPU.
"""
from __future__ import annotations

from typing import Sequence

import numpy as np

from repro_torch.kernels import ops as _kops


def _fused_merge(params: Sequence[dict], base_weights, staleness=None, *,
                 decay: float = 0.0) -> dict:
    """Merge N param dicts under staleness-decayed, renormalised weights:
    out = sum_i w_i(1+s_i)^-decay p_i / sum_j w_j(1+s_j)^-decay, every leaf
    in one fused contraction (one kernel launch a dtype on the card, each
    client's leaf read where it lies), cast back to each leaf's dtype."""
    keys = list(params[0])
    merged = _kops.fused_merge_leaves([[p[k] for k in keys] for p in params],
                                      base_weights, staleness, decay=decay)
    return {k: m.to(params[0][k].dtype) for k, m in zip(keys, merged)}


def weighted_average(params: Sequence[dict], weights: Sequence[float]):
    """sum_i weights_i * params_i / sum(weights) over param dicts."""
    return _fused_merge(params, weights)


def fedavg(params: Sequence[dict], num_examples: Sequence[int]):
    """Example-weighted mean (McMahan '17): ``weighted_average`` over the
    clients' example counts, one fused merge (one launch on the card)."""
    return weighted_average(params, [float(n) for n in num_examples])


def uniform_average(params: Sequence[dict]):
    return weighted_average(params, [1.0] * len(params))


def hierarchical_average(params: Sequence[dict], cluster_of: Sequence[int],
                         *, weighting: str = "size"):
    """FedSiKD two-level mean (Alg.1 lines 16-18): cluster means combined
    uniformly (``weighting="uniform"``, Alg. 1 literal) or by cluster size
    (``"size"``, §IV-C.5)."""
    labels = np.asarray(cluster_of)
    ks = sorted(set(labels.tolist()))
    cluster_means, sizes = [], []
    for k in ks:
        members = [p for p, c in zip(params, labels) if c == k]
        cluster_means.append(uniform_average(members))
        sizes.append(len(members))
    if weighting == "uniform":
        return uniform_average(cluster_means)
    if weighting != "size":
        raise ValueError(
            f"weighting must be 'uniform' or 'size', got {weighting!r}")
    return weighted_average(cluster_means, [float(s) for s in sizes])


def staleness_factor(staleness, decay: float):
    """Polynomial staleness decay ``(1 + s)^(-decay)``."""
    s = np.asarray(staleness, np.float64)
    if np.any(s < 0):
        raise ValueError(f"staleness must be >= 0, got {staleness}")
    if decay < 0:
        raise ValueError(f"staleness decay must be >= 0, got {decay}")
    return (1.0 + s) ** (-decay)


def staleness_weights(base_weights, staleness, decay: float) -> np.ndarray:
    """Normalised merge weights: each base weight decayed by its update's
    staleness, renormalised to sum to 1."""
    w = np.asarray(base_weights, np.float64)
    if w.size == 0:
        return w.astype(np.float32)
    if np.any(w < 0):
        raise ValueError(f"base weights must be >= 0, got {base_weights}")
    w = w * staleness_factor(staleness, decay)
    total = w.sum()
    if total <= 0:
        raise ValueError("no contributing update has positive weight")
    return (w / total).astype(np.float32)


def staleness_weighted_average(params: Sequence[dict], base_weights,
                               staleness, *, decay: float):
    """Bounded-staleness merge under the decayed, renormalised weights, in
    the same fused contraction as ``weighted_average``
    (``staleness_weights`` is called first for its validation errors)."""
    staleness_weights(base_weights, staleness, decay)
    return _fused_merge(params, base_weights, staleness, decay=decay)


def tree_sub(a: dict, b: dict) -> dict:
    """Leaf-wise ``a - b`` of two param dicts (FL+HC's model updates)."""
    return {k: v - b[k] for k, v in a.items()}
