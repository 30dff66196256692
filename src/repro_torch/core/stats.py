"""Client dataset-distribution statistics (paper §IV-A, Eq. 1): the port of
the batched front-end of ``repro.core.stats``.

Each client's per-feature mean, standard deviation and skewness, for every
roster client at once: the JAX segment sums become ``index_add_`` over the
row-owner ids.  The DP hook (``privatize_batched``) is not ported yet:
``FedConfig.dp_noise > 0`` raises in ``run_federated``.
"""
from __future__ import annotations

import torch

_EPS = 1e-8


def batched_moments(x, client_ids, num_segments: int):
    """(mean, std, skew), each (num_segments, F), of the (N_total, F) rows
    ``x`` grouped by ``client_ids`` (N_total,) in [0, num_segments): two-pass
    (mean first, then centred second and third moments)."""
    x = x.to(torch.float32)
    ids = client_ids.long()

    def seg_sum(v):
        out = torch.zeros((num_segments,) + v.shape[1:], dtype=v.dtype,
                          device=v.device)
        return out.index_add_(0, ids, v)

    cnt = seg_sum(torch.ones(x.shape[0], dtype=x.dtype, device=x.device))
    denom = torch.clamp(cnt, min=1.0)[:, None]
    mean = seg_sum(x) / denom
    centered = x - mean[ids]
    var = seg_sum(centered ** 2) / denom
    third = seg_sum(centered ** 3) / denom
    std = torch.sqrt(var)
    skew = third / torch.clamp(std, min=_EPS) ** 3
    return mean, std, skew


def standardize_params(features):
    """Column (mu, sd) of the stats matrix (population sd, as ``jnp.std``)."""
    return (features.mean(dim=0, keepdim=True),
            features.std(dim=0, correction=0, keepdim=True))


def apply_standardize(features, mu, sd):
    return (features - mu) / torch.clamp(sd, min=_EPS)


def standardize(features):
    """Column-standardise the stats matrix so k-means treats mu/sigma/gamma
    on equal footing."""
    return apply_standardize(features, *standardize_params(features))
