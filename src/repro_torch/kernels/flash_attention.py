"""Block flash attention (forward, grouped-query heads): the CUDA kernel's
wrapper and its plain PyTorch version.

Replaces the Pallas TPU kernel ``src/repro/kernels/flash_attention.py::
_fa_kernel`` (via ``flash_attention``); the CUDA source is
``csrc/flash_attention.cu``.

    q (B, T, H, hd), k and v (B, S, KVH, hd) -> out (B, T, H, hd)
    out[b, t, h] = softmax_s(scale * q[b, t, h] . k[b, s, h // G]) @ v[..]

with G = H / KVH, the right-aligned causal mask (query t sees key s iff
s <= t + S - T; with ``window`` > 0 also s > t + S - T - window), masked
scores set to -1e30 as the TPU kernel does (a query that sees no key
averages V over all S keys), float32 softmax and products, and the output
in the input dtype.

Bound on the H100: operations at the serving path's prefill (137 GFLOP
causal at B 2, H 16, T = S = 4096, hd 128: 0.139 ms at 989 TFLOP/s bf16),
bytes in a decode step (8.5 MB of cache at S = 4128: 2.5 us).  The first
design is simple (see the ``.cu`` note): 64 (position, head) rows a block,
the heads of a GQA group together, keys staged in shared memory, online
softmax in float32 registers, the key axis split across blocks when the
grid alone cannot fill the card.

Dispatch: a tensor on the CPU goes to the plain version; a CUDA tensor goes
to the kernel, or the wrapper raises.  ``flash_attention.launches`` counts
kernel launches (a launch with split keys is one launch of the pair of
kernels that computes it).
"""
from __future__ import annotations

import torch

from repro_torch.kernels import _build

NEG = -1e30          # the TPU kernel's mask value
HEAD_DIMS = (32, 64, 128)
DTYPES = (torch.float32, torch.bfloat16)
# layout constants of csrc/flash_attention.cu (kRows, kBK)
ROWS = 64
BLOCK_K = 64
# split the key axis, in spans of whole BLOCK_K-key blocks, until the grid
# has this many blocks (four per SM of the H100's 132)
TARGET_BLOCKS = 528


def causal_mask(T: int, S: int, *, offset: int = 0, window: int = 0,
                device=None):
    """(T, S) bool: query t sees key s iff s <= t + offset and (window == 0
    or s > t + offset - window).  The kernel's mask is ``offset = S - T``
    (right-aligned)."""
    tq = torch.arange(T, device=device)[:, None] + offset
    ts = torch.arange(S, device=device)[None, :]
    m = ts <= tq
    if window:
        m &= ts > tq - window
    return m


def flash_attention_plain(q, k, v, *, causal: bool = True, window: int = 0):
    """The kernel's function in plain torch, in the layer layout: float32
    scores of each query head against its kv head's keys, masked to -1e30,
    softmax and the product with V in float32, cast to ``q.dtype``."""
    B, T, H, hd = q.shape
    S, KVH = k.shape[1], k.shape[2]
    G = H // KVH
    qg = q.float().reshape(B, T, KVH, G, hd)
    scores = torch.einsum("btkgh,bskh->bkgts", qg, k.float()) * hd ** -0.5
    if causal:
        scores = scores.masked_fill(
            ~causal_mask(T, S, offset=S - T, window=window,
                         device=q.device), NEG)
    w = torch.softmax(scores, dim=-1)
    out = torch.einsum("bkgts,bskh->btkgh", w, v.float())
    return out.reshape(B, T, H, hd).to(q.dtype)


def plan(B: int, T: int, S: int, H: int, KVH: int) -> dict:
    """The kernel's grid for these shapes: 64 rows a block (``Tq`` query
    positions of ``Gb`` heads of one group), and the split of the key axis
    (``n_split`` spans of ``split_len`` keys) that gives the grid about
    ``TARGET_BLOCKS`` blocks when it has fewer."""
    G = H // KVH
    Gb = min(G, ROWS)
    n_gblk = -(-G // Gb)
    Tq = max(1, ROWS // Gb)
    grid_x, grid_y = -(-T // Tq), KVH * n_gblk
    blocks = B * grid_x * grid_y
    key_blocks = -(-S // BLOCK_K)
    n_split = max(1, min(-(-TARGET_BLOCKS // blocks), key_blocks))
    split_len = -(-key_blocks // n_split) * BLOCK_K
    n_split = -(-S // split_len)
    return {"grid_x": grid_x, "grid_y": grid_y, "blocks": blocks,
            "n_split": n_split, "split_len": split_len}


def _check(q, k, v, window):
    if q.dim() != 4 or k.dim() != 4 or v.dim() != 4:
        raise ValueError(f"flash_attention: q (B, T, H, hd) and k, v (B, S, "
                         f"KVH, hd), got {tuple(q.shape)}, {tuple(k.shape)}, "
                         f"{tuple(v.shape)}")
    B, T, H, hd = q.shape
    if k.shape != v.shape or k.shape[0] != B or k.shape[3] != hd:
        raise ValueError(f"flash_attention: k {tuple(k.shape)} and v "
                         f"{tuple(v.shape)} must be ({B}, S, KVH, {hd})")
    if H % k.shape[2]:
        raise ValueError(f"flash_attention: KVH={k.shape[2]} must divide "
                         f"H={H}")
    if T == 0 or k.shape[1] == 0:
        raise ValueError(f"flash_attention: empty T={T} or S={k.shape[1]}")
    if window < 0:
        raise ValueError(f"flash_attention: window={window} < 0")
    if not (q.device == k.device == v.device):
        raise ValueError("flash_attention: tensors on different devices")


def flash_attention(q, k, v, *, causal: bool = True, window: int = 0):
    """Attention of ``q`` (B, T, H, hd) over ``k``, ``v`` (B, S, KVH, hd):
    right-aligned causal mask (optional ``window``), float32 accumulation,
    output (B, T, H, hd) in ``q.dtype``.  Any strides with a contiguous hd
    axis are taken as they are (a KV cache's visible prefix is passed as a
    view); any T and S, with nothing padded."""
    _check(q, k, v, window)
    if q.device.type == "cpu":
        return flash_attention_plain(q, k, v, causal=causal, window=window)
    if q.device.type != "cuda":
        raise ValueError(f"flash_attention: no kernel or plain path for "
                         f"{q.device}")
    if q.dtype not in DTYPES or k.dtype != q.dtype or v.dtype != q.dtype:
        raise TypeError(f"flash_attention: q, k, v must share one dtype of "
                        f"{[str(d) for d in DTYPES]}, got {q.dtype}, "
                        f"{k.dtype}, {v.dtype}")
    B, T, H, hd = q.shape
    S, KVH = k.shape[1], k.shape[2]
    if hd not in HEAD_DIMS:
        raise ValueError(f"flash_attention: the kernel takes head_dim in "
                         f"{HEAD_DIMS}, got {hd}")
    for name, t in (("q", q), ("k", k), ("v", v)):
        if t.stride(-1) != 1:
            raise ValueError(f"flash_attention: {name}'s head_dim axis must "
                             "be contiguous")
    vec = 16 // q.element_size()        # the kernel's 16-byte K/V copies
    for name, t in (("k", k), ("v", v)):
        if t.data_ptr() % 16 or any(st % vec for st in t.stride()[:3]):
            raise ValueError(f"flash_attention: {name} must be 16-byte "
                             f"aligned with strides in multiples of {vec} "
                             f"elements, got strides {t.stride()}")
    p = plan(B, T, S, H, KVH)
    out = torch.empty((B, T, H, hd), dtype=q.dtype, device=q.device)
    part_acc = part_ml = None
    if p["n_split"] > 1:
        rows = p["blocks"] * p["n_split"] * ROWS
        part_acc = torch.empty(rows * hd, dtype=torch.float32,
                               device=q.device)
        part_ml = torch.empty(rows * 2, dtype=torch.float32, device=q.device)
    lib = _build.library()
    with torch.cuda.device(q.device):
        err = lib.fedsikd_flash_attention(
            q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(),
            None if part_acc is None else part_acc.data_ptr(),
            None if part_ml is None else part_ml.data_ptr(),
            *q.stride()[:3], *k.stride()[:3], *v.stride()[:3],
            *out.stride()[:3], B, T, S, H, KVH, hd, int(causal), int(window),
            hd ** -0.5, p["n_split"], p["split_len"],
            _build.dtype_code(q, "flash_attention"), _build.stream_handle(q))
    _build.check(err, "flash_attention")
    flash_attention.launches += 1
    return out


flash_attention.launches = 0
