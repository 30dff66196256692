"""k-means assignment (the Lloyd E-step): the CUDA kernel's wrapper and its
plain PyTorch version.

Replaces the Pallas TPU kernel ``src/repro/kernels/kmeans_assign.py::
_kernel`` (via ``kmeans_assign``); the CUDA source is
``csrc/kmeans_assign.cu``.

    d[n, k] = max(||x_n||^2 + ||c_k||^2 - 2 x_n . c_k, 0)
    assign[n] = argmin_k d[n, k]  (ties to the lowest k),  dist[n] = min_k d

Bound on the H100: at the clustering step's (40, 2352) x K <= 5 a call
moves 0.4 MB and costs its launch; at large N the bytes of ``x`` bound it.
The first design is one warp per point with the centroids staged in shared
memory in F-chunks (see the ``.cu`` note).  ``K`` is at most ``MAX_K``; a
larger K raises.

Dispatch: a tensor on the CPU goes to the plain version below; a CUDA
tensor goes to the kernel, or the wrapper raises.  ``kmeans_assign.
launches`` counts kernel launches (never plain calls).
"""
from __future__ import annotations

import torch

from repro_torch.kernels import _build

MAX_K = 16     # kMaxK of csrc/kmeans_assign.cu


def kmeans_assign_plain(x, cents):
    """(N, F), (K, F) -> (assign (N,) int32, dist (N,) f32): the kernel's
    arithmetic in the expansion form, step by step."""
    x, c = x.float(), cents.float()
    d = torch.clamp(torch.sum(x * x, -1, keepdim=True)
                    + torch.sum(c * c, -1)[None, :] - 2.0 * (x @ c.T),
                    min=0.0)
    a = torch.argmin(d, dim=-1)
    return a.to(torch.int32), torch.gather(d, 1, a[:, None])[:, 0]


def kmeans_assign(x, cents):
    """Nearest centroid of every row of ``x`` (N, F) among ``cents`` (K, F),
    both float32: ``(assign (N,) int32, squared distance (N,) f32)``."""
    if x.dim() != 2 or cents.dim() != 2 or x.shape[1] != cents.shape[1]:
        raise ValueError(f"kmeans_assign: x (N, F) and cents (K, F) must "
                         f"share F, got {tuple(x.shape)} and "
                         f"{tuple(cents.shape)}")
    if x.device != cents.device:
        raise ValueError("kmeans_assign: tensors on different devices")
    if x.device.type == "cpu":
        return kmeans_assign_plain(x, cents)
    if x.device.type != "cuda":
        raise ValueError(f"kmeans_assign: no kernel or plain path for "
                         f"{x.device}")
    if x.dtype != torch.float32 or cents.dtype != torch.float32:
        raise TypeError(f"kmeans_assign: x and cents must be float32, got "
                        f"{x.dtype} and {cents.dtype}")
    for name, t in (("x", x), ("cents", cents)):
        if not t.is_contiguous():
            raise ValueError(f"kmeans_assign: {name} must be contiguous")
    N, F = x.shape
    K = cents.shape[0]
    if not 1 <= K <= MAX_K:
        raise ValueError(f"kmeans_assign: the kernel takes 1 <= K <= {MAX_K} "
                         f"centroids, got K={K}")
    if N == 0 or F == 0:
        raise ValueError(f"kmeans_assign: empty points {tuple(x.shape)}")
    assign = torch.empty(N, dtype=torch.int32, device=x.device)
    dist = torch.empty(N, dtype=torch.float32, device=x.device)
    lib = _build.library()
    with torch.cuda.device(x.device):
        err = lib.fedsikd_kmeans_assign(
            x.data_ptr(), cents.data_ptr(), assign.data_ptr(),
            dist.data_ptr(), N, F, K, _build.stream_handle(x))
    _build.check(err, "kmeans_assign")
    kmeans_assign.launches += 1
    return assign, dist


kmeans_assign.launches = 0
