"""Client dataset-distribution statistics (paper §IV-A, Eq. 1): the port of
the batched front-end of ``repro.core.stats``.

Each client's per-feature mean, standard deviation and skewness, for every
roster client at once: the JAX segment sums become ``index_add_`` over the
row-owner ids.  The Gaussian-mechanism DP hook is split in two:
``dp_noise_draws`` draws each client's standard normals from its own
generator, and ``privatize_batched`` clips, scales and adds them.
"""
from __future__ import annotations

import numpy as np
import torch

from repro_torch import rng

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


def dp_noise_draws(seed: int, clients, num_features: int, *,
                   device="cpu") -> torch.Tensor:
    """(R, 3, F) standard normal draws for the ``clients`` (global ids): row
    r holds client ``clients[r]``'s noise for its mean, std and skewness,
    drawn from the generator ``rng.generator(seed, client)`` on the CPU.  A
    client's draws depend only on (seed, its id), never on the roster it is
    drawn with, so they are the same at setup and at any later join."""
    out = torch.empty((len(clients), 3, num_features), dtype=torch.float32)
    for r, c in enumerate(np.asarray(clients).tolist()):
        out[r] = torch.randn((3, num_features), dtype=torch.float32,
                             generator=rng.generator(seed, int(c)))
    return out.to(device)


def privatize_batched(mean, std, skew, *, noise_multiplier: float,
                      clip: float = 10.0, noise):
    """Gaussian-mechanism DP on every client's statistics (the paper leaves
    the exact DP model out of scope): each statistic is clipped to
    [-clip, clip] and perturbed by ``noise_multiplier * clip`` times its
    draw in ``noise`` ((R, 3, F), ``dp_noise_draws``).  ``std`` is clamped
    at >= 0 AFTER noising (post-processing, no privacy cost).  A zero
    multiplier returns the statistics unchanged."""
    if noise_multiplier <= 0.0:
        return mean, std, skew
    sigma = noise_multiplier * clip

    def noisy(x, n):
        return torch.clamp(x, -clip, clip) + sigma * n

    return (noisy(mean, noise[:, 0]),
            torch.clamp(noisy(std, noise[:, 1]), min=0.0),
            noisy(skew, noise[:, 2]))


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
