"""k-means assignment (the Lloyd E-step): the CUDA kernel's wrapper, its
planner and its plain PyTorch version.

Replaces the Pallas TPU kernel ``src/repro/kernels/kmeans_assign.py::
_kernel`` (via ``kmeans_assign``); the CUDA source is
``csrc/kmeans_assign.cu``.

    d[n, k] = max((||x_n||^2 + ||c_k||^2) - 2 x_n . c_k, 0)
    assign[n] = argmin_k d[n, k]  (ties to the lowest k),  dist[n] = min_k d

Bound on the H100: at the clustering step's (40, 2352) x K <= 5 a call
moves 0.4 MB and costs its latency; at large N the bytes of ``x`` bound it.
``plan`` picks one of two shapes of work (one launch a call either way):
``split`` cuts F across the 8 blocks of a thread-block cluster, 4 points a
block, and the cluster's rank-0 block adds the slices' partial sums from
the others' shared memory; ``stream`` stages all centroids in each
persistent block's shared memory and walks the points, two a warp.  ``K``
is at most ``MAX_K``; a larger K raises.

Dispatch: a tensor on the CPU goes to the plain version below; a CUDA
tensor goes to the kernel, or the wrapper raises.  ``kmeans_assign.
launches`` counts kernel launches (never plain calls), ``kmeans_assign.
variant_launches`` the same launches by regime (``split``, ``stream``).
"""
from __future__ import annotations

import functools

import torch

from repro_torch.kernels import _build

MAX_K = 16     # kMaxK of csrc/kmeans_assign.cu
VARIANTS = ("split", "stream")
# csrc/kmeans_assign.cu: blocks a cluster (the portable size) and points a
# block of the split regime; warps a block and points a warp of the stream
# regime
CLUSTER = 8
CLUSTER_POINTS = 4
STREAM_WARPS = 8
STREAM_PAIR = 2
STREAM_BLOCKS_PER_SM = 4
# H100 shared memory: a block may opt in to 227 KB, an SM holds 228 KB, and
# the runtime reserves 1 KB a block
SMEM_BLOCK_MAX = 232448
SMEM_SM = 233472
SMEM_RESERVED = 1024
H100_SMS = 132


def plan(N: int, F: int, K: int, sms: int = H100_SMS) -> dict:
    """The kernel's shape of work for (N, F) points and K centroids on a
    card of ``sms`` SMs.  ``stream`` when every SM gets a block of
    STREAM_WARPS x STREAM_PAIR points and the K x F centroids fit in a
    block's shared memory: ``blocks`` persistent blocks, ``per_sm`` an SM by
    shared memory, ``smem`` bytes each.  Otherwise ``split``: ``groups``
    clusters of CLUSTER blocks (``blocks`` in all), CLUSTER_POINTS points a
    cluster, F cut into CLUSTER ``slices`` (start, length) of ``slice_len``
    columns, a multiple of 4 (the last ones shorter or empty)."""
    smem = 4 * K * (F + 1)
    need = -(-N // (STREAM_WARPS * STREAM_PAIR))
    if need >= sms and smem <= SMEM_BLOCK_MAX:
        per_sm = max(1, min(STREAM_BLOCKS_PER_SM,
                            SMEM_SM // (smem + SMEM_RESERVED)))
        return {"regime": "stream", "blocks": min(need, sms * per_sm),
                "per_sm": per_sm, "threads": 32 * STREAM_WARPS,
                "smem": smem}
    slice_len = 4 * -(-F // (4 * CLUSTER))
    slices = [(min(F, r * slice_len),
               max(0, min(slice_len, F - r * slice_len)))
              for r in range(CLUSTER)]
    groups = -(-N // CLUSTER_POINTS)
    return {"regime": "split", "cluster": CLUSTER, "groups": groups,
            "blocks": groups * CLUSTER, "threads": 32 * CLUSTER_POINTS,
            "slice_len": slice_len, "slices": slices, "smem": 0}


@functools.lru_cache(maxsize=256)
def _launch_plan(N: int, F: int, K: int, device_index: int):
    """``plan`` on this card, kept per shape: (regime, blocks, slice_len)
    (the clustering step makes 255 calls at a handful of shapes)."""
    p = plan(N, F, K, torch.cuda.get_device_properties(device_index)
             .multi_processor_count)
    return p["regime"], p["blocks"], p.get("slice_len", 0)


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
    regime, blocks, slice_len = _launch_plan(N, F, K, x.device.index)
    vec = int(F % 4 == 0 and x.data_ptr() % 16 == 0
              and cents.data_ptr() % 16 == 0)
    assign = torch.empty(N, dtype=torch.int32, device=x.device)
    dist = torch.empty(N, dtype=torch.float32, device=x.device)
    lib = _build.library()
    with torch.cuda.device(x.device):
        err = lib.fedsikd_kmeans_assign(
            x.data_ptr(), cents.data_ptr(), assign.data_ptr(),
            dist.data_ptr(), N, F, K, VARIANTS.index(regime), blocks,
            slice_len, vec, _build.stream_handle(x))
    _build.check(err, f"kmeans_assign ({regime})")
    kmeans_assign.launches += 1
    kmeans_assign.variant_launches[regime] += 1
    return assign, dist


kmeans_assign.launches = 0
kmeans_assign.variant_launches = dict.fromkeys(VARIANTS, 0)
