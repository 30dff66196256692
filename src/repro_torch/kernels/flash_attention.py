"""Block flash attention (forward, grouped-query heads): the CUDA kernels'
wrapper and their plain PyTorch version.

Replaces the Pallas TPU kernel ``src/repro/kernels/flash_attention.py::
_fa_kernel`` (via ``flash_attention``) with three hand-written CUDA
kernels of one function:

    q (B, T, H, hd), k and v (B, S, KVH, hd) -> out (B, T, H, hd)
    out[b, t, h] = softmax_s(scale * q[b, t, h] . k[b, s, h // G]) @ v[..]

with G = H / KVH, the right-aligned causal mask (query t sees key s iff
s <= t + S - T; with ``window`` > 0 also s > t + S - T - window), masked
scores set to -1e30 as the TPU kernel does (a query that sees no key
averages V over all S keys), softmax and products to float32 accuracy,
and the output in the input dtype.

Dispatch of a CUDA tensor, by dtype and T only (``variant``):

- T == 1, float32 or bfloat16: ``decode`` (``csrc/flash_attention_decode.cu``),
  one block per (b, kv head, key span) for the G heads of the group, the
  spans merged in the same launch;
- T > 1, bfloat16: ``tensor_core`` (``csrc/flash_attention_tc.cu``),
  ``mma.sync`` bf16 products with float32 sums and the softmax weights
  split into two bf16 terms (P = P_hi + P_lo), so the weights keep float32
  accuracy;
- T > 1, float32: ``v1`` (``csrc/flash_attention.cu``), float32 products on
  the CUDA cores.

A tensor on the CPU goes to the plain version; a CUDA tensor goes to its
kernel, or the wrapper raises (there is no fallback).  A fake tensor
(``FakeTensorMode``, on either device) gets an output of the kernel's
shape and dtype and its work added to ``launch/roofline.py``'s count, and
launches nothing.  The kernels have no
backward, and need none: training takes the JAX package's plain
attention (``models.layers.attention_fwd(..., train=True)``), as the
reference trains through jnp and never through its Pallas kernel.  A
direct call off the CPU with grad mode on and an input that requires grad
raises (``refuse_grad``) rather than return an output with no grad
history; the CPU plain version stays differentiable.
``flash_attention.launches`` counts wrapper calls that launched a kernel,
``flash_attention.variant_launches`` the same calls by kernel.

Bound on the H100: operations at the serving path's prefill (137 GFLOP
causal at B 2, H 16, T = S = 4096, hd 128: 0.139 ms at 989 TFLOP/s bf16),
bytes in a decode step (8.5 MB of cache at S = 4128: 2.5 us).
"""
from __future__ import annotations

import torch
from torch._subclasses.fake_tensor import FakeTensor

from repro_torch.kernels import _build

NEG = -1e30          # the TPU kernel's mask value
# the head dims every kernel is built for (each a template instance of the
# three sources; any other, 48 say, raises)
HEAD_DIMS = (32, 64, 96, 128, 192)
DTYPES = (torch.float32, torch.bfloat16)
VARIANTS = ("v1", "tensor_core", "decode")
# layout constants of csrc/flash_attention.cu (kRows, kBK)
ROWS = 64
BLOCK_K = 64
# split the key axis, in spans of whole BLOCK_K-key blocks, until the grid
# has this many blocks (four per SM of the H100's 132)
TARGET_BLOCKS = 528
# csrc/flash_attention_tc.cu: query positions a block (kBM), keys a tile (kBN)
TC_ROWS = 64
TC_BLOCK_K = 64
# csrc/flash_attention_decode.cu: query heads a block at most, spans the
# merge takes (kMaxSpans) and merges at its first level (kFan); the plan
# cuts the visible keys into spans of a multiple of DECODE_SPAN_ALIGN keys
# until the grid has DECODE_TARGET_BLOCKS blocks (two per SM of the 132)
DECODE_HEADS = 8
DECODE_MAX_SPANS = 512
DECODE_FAN = 8
DECODE_SPAN_ALIGN = 16
DECODE_TARGET_BLOCKS = 264


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
    """The first (``v1``) kernel's grid for these shapes: 64 rows a block
    (``Tq`` query positions of ``Gb`` heads of one group), and the split of
    the key axis (``n_split`` spans of ``split_len`` keys) that gives the
    grid about ``TARGET_BLOCKS`` blocks when it has fewer."""
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


def variant(dtype: torch.dtype, T: int) -> str:
    """The kernel a CUDA call of this dtype and query length takes."""
    if T == 1:
        return "decode"
    return "tensor_core" if dtype == torch.bfloat16 else "v1"


def tc_plan(B: int, T: int, S: int, H: int, *, causal: bool = True,
            window: int = 0) -> dict:
    """The tensor-core kernel's grid: ``grid_x`` = B * H (batch, head),
    ``grid_y`` Q tiles of TC_ROWS positions, launched from the last tile
    to the first (blockIdx.y = 0 is the last); ``key_tiles[y]`` is the
    number of TC_BLOCK_K-key tiles block row y walks (the keys its rows can
    see, every key when one of its rows sees none), as the kernel computes
    it."""
    grid_y = -(-T // TC_ROWS)
    off = S - T
    key_tiles = []
    for y in range(grid_y):
        t0 = (grid_y - 1 - y) * TC_ROWS
        t1 = min(t0 + TC_ROWS, T) - 1
        lo, hi = 0, S
        if causal and t0 + off >= 0:
            hi = min(S, t1 + off + 1)
            if window:
                lo = max(0, t0 + off - window + 1)
        key_tiles.append(-(-(hi - lo) // TC_BLOCK_K))
    return {"grid_x": B * H, "grid_y": grid_y, "blocks": B * H * grid_y,
            "key_tiles": key_tiles}


def decode_plan(B: int, S: int, H: int, KVH: int, *, causal: bool = True,
                window: int = 0) -> dict:
    """The decode kernel's grid: ``heads`` query heads a block (a power of
    two up to DECODE_HEADS, ``n_gblk`` blocks of them a GQA group), the
    visible keys [lo, S) cut into ``n_span`` spans of ``span_len`` keys (a
    multiple of DECODE_SPAN_ALIGN, none empty), and ``blocks`` in all."""
    G = H // KVH
    heads = min(DECODE_HEADS, 1 << (G - 1).bit_length())
    n_gblk = -(-G // heads)
    visible = min(S, window) if causal and window else S
    groups = B * KVH * n_gblk
    n_span = min(-(-DECODE_TARGET_BLOCKS // groups), DECODE_MAX_SPANS,
                 -(-visible // DECODE_SPAN_ALIGN))
    span_len = -(-visible // (n_span * DECODE_SPAN_ALIGN)) * DECODE_SPAN_ALIGN
    n_span = -(-visible // span_len)
    return {"heads": heads, "n_gblk": n_gblk, "groups": groups,
            "lo": S - visible, "n_span": n_span, "span_len": span_len,
            "blocks": groups * n_span}


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


def refuse_grad(q, k, v) -> None:
    """Raise when a call off the CPU would need a gradient: the CUDA
    kernels fill their output through a raw launch, with no backward, so
    the output would silently carry no grad history.  The model's training
    forward never comes here (it passes ``train=True`` down to the plain
    attention); a caller that does is asking for a gradient the kernels
    cannot give."""
    if (q.device.type != "cpu" and torch.is_grad_enabled()
            and any(t.requires_grad for t in (q, k, v))):
        raise NotImplementedError(
            "flash_attention: the CUDA kernels have no backward (ROADMAP "
            "Queue 1 item 10.2); call them under torch.no_grad() or with "
            "inputs that do not require grad")


def flash_attention(q, k, v, *, causal: bool = True, window: int = 0):
    """Attention of ``q`` (B, T, H, hd) over ``k``, ``v`` (B, S, KVH, hd):
    right-aligned causal mask (optional ``window``), float32 accumulation,
    output (B, T, H, hd) in ``q.dtype``.  Any strides with a contiguous hd
    axis are taken as they are (a KV cache's visible prefix is passed as a
    view); any T and S, with nothing padded.

    A CPU tensor takes the plain version.  A CUDA tensor takes one kernel,
    chosen by dtype and T alone (``variant``): T == 1 the decode kernel
    (float32 or bfloat16), T > 1 the tensor-core kernel in bfloat16 and the
    first (v1) kernel in float32; anything no kernel takes raises, and so
    does a call off the CPU that would need a gradient (``refuse_grad``)."""
    _check(q, k, v, window)
    refuse_grad(q, k, v)
    if isinstance(q, FakeTensor):
        return _fake_call(q, k, causal, window)
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
    vec = 16 // q.element_size()        # the kernels' 16-byte copies
    for name, t in (("q", q), ("k", k), ("v", v)):
        if t.data_ptr() % 16 or any(st % vec for st in t.stride()[:3]):
            raise ValueError(f"flash_attention: {name} must be 16-byte "
                             f"aligned with strides in multiples of {vec} "
                             f"elements, got strides {t.stride()}")
    kind = variant(q.dtype, T)
    out = torch.empty((B, T, H, hd), dtype=q.dtype, device=q.device)
    lib = _build.library()
    with torch.cuda.device(q.device):
        stream = _build.stream_handle(q)
        if kind == "decode":
            err = _launch_decode(lib, q, k, v, out, causal, window, stream)
        elif kind == "tensor_core":
            err = lib.fedsikd_flash_attention_tc(
                q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(),
                *q.stride()[:3], *k.stride()[:3], *v.stride()[:3],
                *out.stride()[:3], B, T, S, H, KVH, hd, int(causal),
                int(window), hd ** -0.5, stream)
        else:
            err = _launch_v1(lib, q, k, v, out, causal, window, stream)
    _build.check(err, f"flash_attention ({kind})")
    flash_attention.launches += 1
    flash_attention.variant_launches[kind] += 1
    return out


def _fake_call(q, k, causal, window):
    """A call on fake tensors (a counted dry run, ``launch/roofline.py``):
    the kernels' output, shape and dtype, and their work, 4 B H hd a
    visible (query, key) pair, into the active count; no launch."""
    from repro_torch.launch import roofline
    B, T, H, hd = q.shape
    roofline.kernel("flash_attention", 4 * B * H * hd * roofline.visible_pairs(
        T, k.shape[1], causal, window))
    return q.new_empty((B, T, H, hd))


def _launch_v1(lib, q, k, v, out, causal, window, stream) -> int:
    B, T, H, hd = q.shape
    S, KVH = k.shape[1], k.shape[2]
    p = plan(B, T, S, H, KVH)
    part_acc = part_ml = None
    if p["n_split"] > 1:
        rows = p["blocks"] * p["n_split"] * ROWS
        part_acc = torch.empty(rows * hd, dtype=torch.float32,
                               device=q.device)
        part_ml = torch.empty(rows * 2, dtype=torch.float32, device=q.device)
    return lib.fedsikd_flash_attention(
        q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(),
        None if part_acc is None else part_acc.data_ptr(),
        None if part_ml is None else part_ml.data_ptr(),
        *q.stride()[:3], *k.stride()[:3], *v.stride()[:3],
        *out.stride()[:3], B, T, S, H, KVH, hd, int(causal), int(window),
        hd ** -0.5, p["n_split"], p["split_len"],
        _build.dtype_code(q, "flash_attention"), stream)


# The decode kernel's merge tickets: zeroed int32 counters, kept per
# (device, stream) and left zero by every launch.
_TICKETS: dict = {}


def _tickets(device, stream: int, n: int) -> torch.Tensor:
    key = (device.index, stream)
    buf = _TICKETS.get(key)
    if buf is None or buf.numel() < n:
        buf = torch.zeros(max(n, 4096), dtype=torch.int32, device=device)
        _TICKETS[key] = buf
    return buf


def _launch_decode(lib, q, k, v, out, causal, window, stream) -> int:
    B, _, H, hd = q.shape
    S, KVH = k.shape[1], k.shape[2]
    p = decode_plan(B, S, H, KVH, causal=causal, window=window)
    part_acc = part_ml = tickets = None
    if p["n_span"] > 1:
        # the spans' states, then those of their sets of DECODE_FAN
        n_set = -(-p["n_span"] // DECODE_FAN)
        n = p["groups"] * (p["n_span"] + n_set) * p["heads"]
        part_acc = torch.empty(n * hd, dtype=torch.float32, device=q.device)
        part_ml = torch.empty(n * 2, dtype=torch.float32, device=q.device)
        tickets = _tickets(q.device, stream, p["groups"] * (1 + n_set))
    return lib.fedsikd_flash_attention_decode(
        q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(),
        *(None if t is None else t.data_ptr()
          for t in (part_acc, part_ml, tickets)),
        q.stride(0), q.stride(2), *k.stride()[:3], *v.stride()[:3],
        out.stride(0), out.stride(2), B, S, H, KVH, hd, p["heads"],
        p["n_gblk"], p["lo"], p["n_span"], p["span_len"],
        _build.dtype_code(q, "flash_attention"), hd ** -0.5, stream)


flash_attention.launches = 0
flash_attention.variant_launches = dict.fromkeys(VARIANTS, 0)
