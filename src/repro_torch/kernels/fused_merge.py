"""Fused grouped weighted-mean merge with staleness decay: the CUDA kernel's
two entries and their plain PyTorch versions.

Replaces the Pallas TPU kernel ``src/repro/kernels/fused_merge.py::_kernel``
(via ``fused_merge``); the CUDA source is ``csrc/fused_merge.cu``.

    out[d] = sum_n w_n (1+s_n)^-decay x[n, d] / sum_m w_m (1+s_m)^-decay

Two entries launch the same kernel:

- ``fused_merge(x, w, s)`` merges the N rows of one (N, D) stack (one leaf);
- ``fused_merge_leaves(rows, w, s)`` merges every leaf of N clients'
  parameter lists in ONE launch a dtype, reading each client's leaf where it
  lies (a device table of row pointers; nothing is stacked).

Bound on the H100: bytes (x read once, one multiply-add per element).  On
the main path each round merges the ten leaves of the MNIST student over
N = 40 clients, 3.06 MB in all: about 0.9 us at 3.35 TB/s.  The kernel's
blocks take tiles of 32 x 16 bytes of columns that never cross a leaf, the
warps split N with several 16-byte loads in flight a thread, and the
warps' sums are added in a fixed order (see the ``.cu`` note).

Dispatch: a tensor on the CPU goes to the plain version; a CUDA tensor goes
to the kernel, or the wrapper raises.  ``fused_merge.launches`` counts
kernel launches of both entries; ``fused_merge.variant_launches`` counts
them by entry (``leaf``, ``leaves``), and ``fused_merge.stale_launches``
the ``leaves`` launches whose staleness has an s >= 1 (a semi-async
round's merge of a late update).
"""
from __future__ import annotations

import functools
from typing import Sequence

import numpy as np
import torch

from repro_torch.kernels import _build

VARIANTS = ("leaf", "leaves")
TILE_BYTES = 32 * 16     # a tile: 32 lanes x 16 bytes of one leaf's columns
OUT_ALIGN = 4            # each leaf's output starts on 16 bytes (4 floats)


def fused_merge_plain(x, w, s, *, decay: float = 0.0):
    """(N, D), (N,), (N,) -> (D,) f32: the kernel's arithmetic, step by step."""
    wn = w.float() * (1.0 + s.float()) ** (-decay)
    wn = wn / wn.sum()
    return (wn[:, None] * x.float()).sum(0)


def fused_merge_leaves_plain(rows, w, s, *, decay: float = 0.0):
    """The multi-leaf entry's function, leaf by leaf: ``rows[n][l]`` is
    client n's leaf l; returns each leaf's float32 merge in its shape."""
    w = torch.as_tensor(np.asarray(w, np.float32))
    s = torch.as_tensor(np.asarray(s, np.float32))
    N = len(rows)
    return [fused_merge_plain(torch.stack([r[l] for r in rows]).reshape(N, -1),
                              w.to(rows[0][l].device), s.to(rows[0][l].device),
                              decay=decay).reshape(rows[0][l].shape)
            for l in range(len(rows[0]))]


@functools.lru_cache(maxsize=64)
def _merge_plan(sizes: tuple, elt: int, aligned: tuple):
    """``merge_plan`` kept per layout (a model's leaves repeat every
    round); what it hands out is read-only."""
    tiles, offsets, total = merge_plan(sizes, elt, aligned)
    tiles.flags.writeable = False
    return tiles, tuple(offsets), total


def merge_plan(sizes: Sequence[int], elt: int, aligned: Sequence[bool]):
    """The kernel's tiles for leaves of ``sizes`` columns of ``elt``-byte
    elements.  Returns ``(tiles, offsets, total)``: tiles an (n_tiles, 4)
    int64 array in the layout of ``csrc/fused_merge.cu``'s ``Tile`` (out
    column, column in the leaf, leaf | width << 32, 16-byte flag); offsets
    each leaf's first column in the flat (total,) output, rounded up to
    OUT_ALIGN columns.  A tile never crosses a leaf boundary."""
    cols = TILE_BYTES // elt
    tiles, offsets, total = [], [], 0
    for leaf, (D, vec) in enumerate(zip(sizes, aligned)):
        offsets.append(total)
        c0 = np.arange(0, D, cols, dtype=np.int64)
        width = np.minimum(cols, D - c0)
        tiles.append(np.stack([total + c0, c0, leaf + (width << 32),
                               np.full_like(c0, int(bool(vec)))], axis=1))
        total += -(-D // OUT_ALIGN) * OUT_ALIGN
    return np.concatenate(tiles), offsets, total


def _launch(table: np.ndarray, sizes, dtype, device, decay: float, kind: str,
            *, w=None, s=None, ws=None, stale: bool = False):
    """One kernel launch over the (L, N) row-pointer ``table`` of leaves of
    ``sizes`` columns.  ``w`` and ``s`` are (N,) float32 device tensors, or
    ``ws`` a (2, N) float32 host array uploaded with the tables.  The
    tables go up in one non-blocking copy from pinned memory on the current
    stream (the caching host allocator keeps the pinned block until that
    copy has run).  ``stale`` says the staleness has an s >= 1.  Returns
    the flat float32 output and the leaves' offsets in it."""
    N = table.shape[1]
    tiles, offsets, total = _merge_plan(
        tuple(sizes), dtype.itemsize, tuple((table % 16 == 0).all(1).tolist()))
    parts = [table.ravel(), tiles.ravel()]
    if ws is not None:
        parts.append(np.ascontiguousarray(ws, np.float32).ravel().view(np.int64))
    host_arr = np.concatenate(parts)
    host = torch.empty(host_arr.size, dtype=torch.int64, pin_memory=True)
    host.numpy()[:] = host_arr
    out = torch.empty(total, dtype=torch.float32, device=device)
    with torch.cuda.device(device):
        dev = host.to(device, non_blocking=True)
        base = dev.data_ptr()
        tiles_ptr = base + 8 * table.size
        if ws is not None:
            w_ptr = tiles_ptr + 8 * tiles.size
            s_ptr = w_ptr + 4 * N
        else:
            w_ptr, s_ptr = w.data_ptr(), s.data_ptr()
        err = _build.library().fedsikd_fused_merge(
            base, tiles_ptr, w_ptr, s_ptr, out.data_ptr(), N, len(tiles),
            _build.DTYPE_CODES[dtype], float(decay), _build.stream_handle(out))
    _build.check(err, f"fused_merge ({kind})")
    fused_merge.launches += 1
    fused_merge.variant_launches[kind] += 1
    fused_merge.stale_launches += int(stale)
    return out, offsets


def fused_merge(x, w, s, *, decay: float = 0.0):
    """Decayed, renormalised weighted mean of the N rows of ``x`` (N, D):
    ``w`` and ``s`` are (N,) float32 base weights and staleness.  Returns
    (D,) float32.  On the card: one launch (``leaf``)."""
    if x.dim() != 2:
        raise ValueError(f"fused_merge: x must be (N, D), got {tuple(x.shape)}")
    N, D = x.shape
    if w.shape != (N,) or s.shape != (N,):
        raise ValueError(f"fused_merge: w {tuple(w.shape)} / s "
                         f"{tuple(s.shape)} must be ({N},)")
    if not (x.device == w.device == s.device):
        raise ValueError("fused_merge: tensors on different devices")
    if x.device.type == "cpu":
        return fused_merge_plain(x, w, s, decay=decay)
    if x.device.type != "cuda":
        raise ValueError(f"fused_merge: no kernel or plain path for {x.device}")
    if w.dtype != torch.float32 or s.dtype != torch.float32:
        raise TypeError("fused_merge: w and s must be float32")
    for name, t in (("x", x), ("w", w), ("s", s)):
        if not t.is_contiguous():
            raise ValueError(f"fused_merge: {name} must be contiguous")
    if N == 0 or D == 0:
        raise ValueError(f"fused_merge: empty stack {tuple(x.shape)}")
    _build.dtype_code(x, "fused_merge")
    rows = x.data_ptr() + np.arange(N, dtype=np.int64) * (D * x.element_size())
    out, _ = _launch(rows[None], [D], x.dtype, x.device, decay, "leaf",
                     w=w, s=s)
    return out[:D]


def fused_merge_leaves(rows: Sequence[Sequence[torch.Tensor]], w, s=None, *,
                       decay: float = 0.0) -> list[torch.Tensor]:
    """Decayed, renormalised weighted mean of every leaf over N clients.

    rows: N sequences of L tensors (client n's leaves, one order for all
    clients; leaf l has one shape and dtype across clients); w, s: (N,)
    host-side base weights and staleness (numpy-convertible; s None = all
    zeros).  Returns L float32 tensors in the leaves' shapes.  On the card
    the leaves of each dtype (f32, bf16, f16) are merged in ONE launch
    (``leaves``), read where they lie; the results are views of one flat
    buffer, each 16-byte aligned."""
    N = len(rows)
    if N == 0:
        raise ValueError("fused_merge_leaves: no clients")
    first = list(rows[0])
    L = len(first)
    if L == 0:
        raise ValueError("fused_merge_leaves: no leaves")
    for n, r in enumerate(rows):
        if len(r) != L:
            raise ValueError(f"fused_merge_leaves: client {n} has {len(r)} "
                             f"leaves, client 0 has {L}")
    # one leaf's N copies at a time, every check in one pass (this loop is
    # the call's host cost on the card: 400 tensors a FedSiKD round)
    cols = [[r[l] for r in rows] for l in range(L)]
    device = first[0].device
    for l, (col, t0) in enumerate(zip(cols, first)):
        shape, dtype = t0.shape, t0.dtype
        if not all(t.shape == shape and t.dtype == dtype
                   and t.device == device for t in col):
            bad = next(n for n, t in enumerate(col) if t.shape != shape
                       or t.dtype != dtype or t.device != device)
            t = col[bad]
            raise ValueError(f"fused_merge_leaves: client {bad} leaf {l} is "
                             f"{tuple(t.shape)} {t.dtype} on {t.device}, "
                             f"client 0's leaf {l} {tuple(shape)} {dtype}, "
                             f"client 0's leaf 0 on {device}")
    w = np.asarray(w, np.float32)
    s = np.zeros(N, np.float32) if s is None else np.asarray(s, np.float32)
    if w.shape != (N,) or s.shape != (N,):
        raise ValueError(f"fused_merge_leaves: w {w.shape} / s {s.shape} must "
                         f"be ({N},)")
    if device.type == "cpu":
        return fused_merge_leaves_plain(rows, w, s, decay=decay)
    if device.type != "cuda":
        raise ValueError(f"fused_merge_leaves: no kernel or plain path for "
                         f"{device}")
    by_dtype: dict[torch.dtype, list[int]] = {}
    for l, (col, t0) in enumerate(zip(cols, first)):
        _build.dtype_code(t0, "fused_merge_leaves")
        if t0.numel() == 0:
            raise ValueError(f"fused_merge_leaves: leaf {l} is empty")
        if not all(t.is_contiguous() for t in col):
            raise ValueError(f"fused_merge_leaves: leaf {l} of every client "
                             "must be contiguous")
        by_dtype.setdefault(t0.dtype, []).append(l)
    ws = np.stack([w, s])
    stale = bool((s >= 1).any())
    merged: list[torch.Tensor | None] = [None] * L
    for dtype, leaves in by_dtype.items():
        table = np.array([[t.data_ptr() for t in cols[l]] for l in leaves],
                         dtype=np.int64)
        sizes = [first[l].numel() for l in leaves]
        out, offsets = _launch(table, sizes, dtype, device, decay, "leaves",
                               ws=ws, stale=stale)
        for l, off, D in zip(leaves, offsets, sizes):
            merged[l] = out[off:off + D].view(first[l].shape)
    return merged


fused_merge.launches = 0
fused_merge.variant_launches = dict.fromkeys(VARIANTS, 0)
fused_merge.stale_launches = 0
