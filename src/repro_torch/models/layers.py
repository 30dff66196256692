"""Transformer building blocks: the port of ``repro.models.layers``
(norms, RoPE, grouped-query attention for prefill and one-token decode,
multi-head latent attention (MLA), dense MLPs and capacity-based
mixture-of-experts (MoE)), keeping the JAX names and param dicts.

Functional style, as in JAX: ``init_*`` builds a dict of tensors from a
seeded ``torch.Generator``, ``*_fwd`` applies it.  Weights are ``(in,
out)`` and applied as ``x @ w``.  ``lead`` prepends axes to every param,
so the model builds its layers' params stacked on a leading L axis
(``dense_init`` reads its fan-in from ``shape[-2]``, as the JAX one does
under ``vmap``, and fills the stack one matrix at a time).

Serving attention (prefill and decode) goes through
``kernels.ops.flash_attention``: the CUDA kernel for CUDA tensors, its
plain version for CPU ones.  Training attention (``attention_fwd(...,
train=True)``) is the JAX module's own: ``_sdpa`` (scores materialised)
below ``2 * cfg.attn_block`` positions and ``sdpa_blocked`` (an online
softmax over key blocks, each block step recomputed in the backward) at
or above it, in plain torch, as the reference trains through jnp and
never through its Pallas kernel.  MLA is plain torch on every path, as in
JAX (which runs it in jnp, not through its Pallas kernel): its q/k head
dim (nope + rope) differs from its v head dim.  The MoE expert products
are batched matmuls, as JAX's einsums outside any kernel.
"""
from __future__ import annotations

from typing import Optional

import torch
import torch.nn.functional as F
from torch.utils.checkpoint import checkpoint

from repro_torch.configs.base import ModelConfig
from repro_torch.kernels import ops
# the JAX module's mask helper, defined beside the plain flash attention
from repro_torch.kernels.flash_attention import NEG, causal_mask
from repro_torch.launch import roofline

DTYPES = {"float32": torch.float32, "bfloat16": torch.bfloat16}


def _dtype(cfg: ModelConfig) -> torch.dtype:
    return DTYPES[cfg.dtype]


# float32 elements drawn at once by ``dense_init`` (1 GiB)
DRAW_ELEMENTS = 1 << 28


def dense_init(gen: torch.Generator, shape, dtype,
               scale: Optional[float] = None) -> torch.Tensor:
    """Normal(0, scale^2) drawn in float32 and cast to ``dtype``, on the
    generator's device; ``scale`` defaults to fan_in^-1/2 with fan_in =
    ``shape[-2]``.  The result is allocated once in ``dtype`` and filled
    one matrix of the leading axes (a layer, an expert) at a time, in
    pieces of at most DRAW_ELEMENTS, in a fixed order from ``gen``: the
    float32 temporary stays at one piece at any width (a whole-shape draw
    of arctic-480b's two-layer expert stack would be 71 GB), and a seed
    gives the same weights on every run."""
    fan_in = shape[-2] if len(shape) > 1 else shape[0]
    scale = scale if scale is not None else fan_in ** -0.5
    out = torch.empty(shape, dtype=dtype, device=gen.device)
    mats = out.reshape(-1, *out.shape[-2:]) if out.dim() > 1 \
        else out.reshape(1, 1, -1)
    rows = max(1, DRAW_ELEMENTS // max(1, mats.shape[-1]))
    for m in mats:
        for r0 in range(0, m.shape[0], rows):
            piece = m[r0:r0 + rows]
            piece.copy_(torch.randn(piece.shape, generator=gen,
                                    dtype=torch.float32,
                                    device=gen.device).mul_(scale))
    return out


# ------------------------------------------------------------------- norms
def init_rmsnorm(d: int, dtype, *, device="cpu", lead: tuple = ()):
    return {"scale": torch.ones((*lead, d), dtype=dtype, device=device)}


def rmsnorm(p, x, eps: float = 1e-5):
    """Normalise in float32, cast back to ``x.dtype``, then scale (the JAX
    order, which rounds once before the scale in bf16)."""
    xf = x.float()
    var = torch.mean(xf * xf, dim=-1, keepdim=True)
    return (xf * torch.rsqrt(var + eps)).to(x.dtype) * p["scale"]


# -------------------------------------------------------------------- rope
def rope_freqs(hd: int, theta: float, device=None) -> torch.Tensor:
    return 1.0 / (theta ** (torch.arange(0, hd, 2, dtype=torch.float32,
                                         device=device) / hd))


def apply_rope(x: torch.Tensor, positions: torch.Tensor,
               theta: float) -> torch.Tensor:
    """Split-half rotary embedding in float32.  x: (..., T, H, hd);
    positions: broadcastable to (..., T)."""
    hd = x.shape[-1]
    freqs = rope_freqs(hd, theta, x.device)                       # (hd/2,)
    ang = positions[..., None].to(torch.float32) * freqs          # (...,T,hd/2)
    cos, sin = torch.cos(ang)[..., None, :], torch.sin(ang)[..., None, :]
    x1, x2 = torch.chunk(x.float(), 2, dim=-1)
    out = torch.cat([x1 * cos - x2 * sin, x1 * sin + x2 * cos], dim=-1)
    return out.to(x.dtype)


# --------------------------------------------------------------- attention
def init_attention(gen, cfg: ModelConfig, *, lead: tuple = ()):
    d, H, KVH, hd = cfg.d_model, cfg.num_heads, cfg.num_kv_heads, cfg.hd
    dt = _dtype(cfg)
    p = {
        "wq": dense_init(gen, (*lead, d, H * hd), dt),
        "wk": dense_init(gen, (*lead, d, KVH * hd), dt),
        "wv": dense_init(gen, (*lead, d, KVH * hd), dt),
        "wo": dense_init(gen, (*lead, H * hd, d), dt),
    }
    if cfg.qkv_bias:
        for name, width in (("bq", H * hd), ("bk", KVH * hd),
                            ("bv", KVH * hd)):
            p[name] = torch.zeros((*lead, width), dtype=dt, device=gen.device)
    return p


def _qkv(p, cfg: ModelConfig, x, positions):
    B, T, _ = x.shape
    H, KVH, hd = cfg.num_heads, cfg.num_kv_heads, cfg.hd
    q = x @ p["wq"]
    k = x @ p["wk"]
    v = x @ p["wv"]
    if cfg.qkv_bias:
        q, k, v = q + p["bq"], k + p["bk"], v + p["bv"]
    q = apply_rope(q.reshape(B, T, H, hd), positions, cfg.rope_theta)
    k = apply_rope(k.reshape(B, T, KVH, hd), positions, cfg.rope_theta)
    return q, k, v.reshape(B, T, KVH, hd)


def _sdpa(q, k, v, mask, *, scale):
    """Attention with the (T, S) scores materialised.  q: (B, T, H, hd);
    k, v: (B, S, KVH, hd); GQA by head group; ``mask`` broadcasts to the
    (B, KVH, G, T, S) scores.  Scores and softmax in float32, the weights
    cast to v's dtype before the product with V, as in JAX."""
    B, T, H, hd = q.shape
    KVH = k.shape[2]
    qg = q.reshape(B, T, KVH, H // KVH, hd)
    scores = torch.einsum("btkgh,bskh->bkgts", qg, k).float() * scale
    scores = scores.masked_fill(~mask, NEG)
    w = torch.softmax(scores, dim=-1).to(v.dtype)
    out = torch.einsum("bkgts,bskh->btkgh", w, v)
    return out.reshape(B, T, H, hd)


def _block_step(m, l, acc, qblk, kblk, vblk, row0: int, col0: int,
                scale: float, causal: bool, window: int):
    """One key block of ``sdpa_blocked``'s online softmax: the running max
    ``m``, sum ``l`` and float32 accumulator ``acc`` of one query block
    (B, KVH, G, bq[, hd]) after the keys [col0, col0 + bk); the query
    block's first row sits at key position ``row0``."""
    with roofline.attention_step():
        s = torch.einsum("bqkgh,bskh->bkgqs", qblk, kblk.float()) * scale
        if causal:
            rows = row0 + torch.arange(s.shape[3], device=s.device)[:, None]
            cols = col0 + torch.arange(s.shape[4], device=s.device)[None, :]
            mask = cols <= rows
            if window:
                mask &= cols > rows - window
            s = s.masked_fill(~mask, NEG)
        m_new = torch.maximum(m, s.amax(-1))
        r = torch.exp(m - m_new)
        p = torch.exp(s - m_new[..., None])
        l_new = l * r + p.sum(-1)
        acc_new = acc * r[..., None] + torch.einsum("bkgqs,bskh->bkgqh", p,
                                                    vblk.float())
    return m_new, l_new, acc_new


def sdpa_blocked(q, k, v, *, scale, causal: bool = True, window: int = 0,
                 offset: int | None = None, block: int = 1024):
    """Double-blocked flash-style attention in plain torch, the port of
    the JAX function: query blocks of ``block`` rows, and for each an
    online max/sum over key blocks, each block step under
    ``torch.utils.checkpoint`` (the JAX scan's ``jax.checkpoint(inner)``),
    so the backward keeps one (B, KVH, G, bq, bk) score block at a time.
    q: (B, T, H, hd); k, v: (B, S, KVH, hd) -> (B, T, H, hd).

    Ragged last blocks are sliced, not padded.  With a causal mask and
    ``offset`` >= 0 every query sees itself, so a block pair whose every
    score is masked adds exactly nothing and is skipped."""
    B, T, H, hd = q.shape
    S, KVH = k.shape[1], k.shape[2]
    G = H // KVH
    offset = (S - T) if offset is None else offset
    bq, bk = min(block, T), min(block, S)
    outs = []
    for i0 in range(0, T, bq):
        qblk = q[:, i0:i0 + bq].reshape(B, -1, KVH, G, hd).float()
        n = qblk.shape[1]
        row0 = i0 + offset
        m = torch.full((B, KVH, G, n), NEG, dtype=torch.float32,
                       device=q.device)
        l = torch.zeros((B, KVH, G, n), dtype=torch.float32, device=q.device)
        acc = torch.zeros((B, KVH, G, n, hd), dtype=torch.float32,
                          device=q.device)
        for j0 in range(0, S, bk):
            j1 = min(j0 + bk, S)
            if causal and offset >= 0 and (
                    j0 > row0 + n - 1
                    or (window and j1 - 1 <= row0 - window)):
                continue
            m, l, acc = checkpoint(_block_step, m, l, acc, qblk,
                                   k[:, j0:j1], v[:, j0:j1], row0, j0, scale,
                                   causal, window, use_reentrant=False)
        out = acc / torch.clamp(l, min=1e-30)[..., None]   # (B,KVH,G,n,hd)
        outs.append(out.permute(0, 3, 1, 2, 4))            # (B,n,KVH,G,hd)
    return torch.cat(outs, dim=1).reshape(B, T, H, hd).to(q.dtype)


def attention_fwd(p, cfg: ModelConfig, x, positions, *, window: int = 0,
                  train: bool = False):
    """Full prefill attention.  Returns (out, (k, v)), k/v for the cache.

    Serving (``train=False``) calls the flash-attention kernel, which never
    materialises the scores at any T.  Training (``train=True``, set by
    the caller that differentiates: ``lm_loss`` and the distillation
    losses) takes the JAX function's own jnp formulations, chosen by
    ``cfg.attn_block`` as JAX chooses: ``_sdpa`` for T < 2 * attn_block,
    ``sdpa_blocked`` at or above it (each marked for a counted dry run,
    ``launch/roofline.attention``)."""
    B, T, _ = x.shape
    q, k, v = _qkv(p, cfg, x, positions)
    if not train:
        out = ops.flash_attention(q, k, v, causal=True, window=window)
    elif cfg.attn_block and T >= 2 * cfg.attn_block:
        with roofline.attention(B, cfg.num_heads, 2 * cfg.hd, T, T,
                                window=window, inputs=(q, k, v)):
            out = sdpa_blocked(q, k, v, scale=cfg.hd ** -0.5, causal=True,
                               window=window, block=cfg.attn_block)
    else:
        mask = causal_mask(T, T, window=window, device=x.device)
        with roofline.attention(B, cfg.num_heads, 2 * cfg.hd, T, T,
                                window=window, inputs=(q, k, v)):
            out = _sdpa(q, k, v, mask, scale=cfg.hd ** -0.5)
    return out.reshape(B, T, -1) @ p["wo"], (k, v)


def attention_decode(p, cfg: ModelConfig, x, cache_k, cache_v, pos: int, *,
                     window: int = 0):
    """One-token decode.  x: (B, 1, d); cache_k/v: (B, S, KVH, hd); pos:
    the position of the new token (a Python int).

    The new key and value are written into the caches IN PLACE (the JAX
    function returns updated copies; a copy per layer and token would move
    the whole cache).  With ``window`` the cache is a rotating buffer of
    size ``window`` written at ``pos % window``; otherwise S is the whole
    context, written at ``pos`` (a ``pos`` past the cache raises, where JAX
    would clamp the write).  The kernel then attends over the visible
    prefix ``cache[:, :min(pos + 1, S)]``, a strided view, with T = 1: the
    right-aligned mask shows that one query every key of the prefix, which
    is the JAX mask ``arange(S) <= pos`` (or, for a full rotating buffer,
    every slot)."""
    B = x.shape[0]
    S = cache_k.shape[1]
    if not window and pos >= S:
        raise IndexError(f"attention_decode: position {pos} is past the "
                         f"cache's {S} slots; grow the cache first")
    q, k, v = _qkv(p, cfg, x, torch.full((B, 1), pos, device=x.device))
    slot = pos % window if window else pos
    cache_k[:, slot] = k[:, 0]
    cache_v[:, slot] = v[:, 0]
    n = min(pos + 1, S)
    out = ops.flash_attention(q, cache_k[:, :n], cache_v[:, :n], causal=True)
    return out.reshape(B, 1, -1) @ p["wo"], (cache_k, cache_v)


# --------------------------------------------------------------------- MLA
def init_mla(gen, cfg: ModelConfig, *, lead: tuple = ()):
    """DeepSeek-V2 multi-head latent attention.  The KV cache holds only
    the compressed latent c_kv (kv_lora_rank) and the shared rope key
    (qk_rope_dim)."""
    d, H = cfg.d_model, cfg.num_heads
    r, qr = cfg.kv_lora_rank, cfg.q_lora_rank
    nope, rope_d, vd = cfg.qk_nope_dim, cfg.qk_rope_dim, cfg.v_head_dim
    dt = _dtype(cfg)
    dev = gen.device
    return {
        "q_a": dense_init(gen, (*lead, d, qr), dt),
        "q_a_norm": init_rmsnorm(qr, dt, device=dev, lead=lead),
        "q_b": dense_init(gen, (*lead, qr, H * (nope + rope_d)), dt),
        "kv_a": dense_init(gen, (*lead, d, r + rope_d), dt),
        "kv_a_norm": init_rmsnorm(r, dt, device=dev, lead=lead),
        "k_b": dense_init(gen, (*lead, r, H * nope), dt),
        "v_b": dense_init(gen, (*lead, r, H * vd), dt),
        "wo": dense_init(gen, (*lead, H * vd, d), dt),
    }


def _mla_q(p, cfg: ModelConfig, x, positions):
    B, T, _ = x.shape
    H, nope, rope_d = cfg.num_heads, cfg.qk_nope_dim, cfg.qk_rope_dim
    qa = rmsnorm(p["q_a_norm"], x @ p["q_a"], cfg.rms_eps)
    q = (qa @ p["q_b"]).reshape(B, T, H, nope + rope_d)
    q_nope, q_rope = q[..., :nope], q[..., nope:]
    return q_nope, apply_rope(q_rope, positions, cfg.rope_theta)


def _mla_latent(p, cfg: ModelConfig, x, positions):
    """(c_kv (B, T, r), k_rope (B, T, rope_d)) of ``x``."""
    B, T, _ = x.shape
    r, rope_d = cfg.kv_lora_rank, cfg.qk_rope_dim
    kv = x @ p["kv_a"]
    c_kv = rmsnorm(p["kv_a_norm"], kv[..., :r], cfg.rms_eps)
    k_rope = apply_rope(kv[..., r:].reshape(B, T, 1, rope_d), positions,
                        cfg.rope_theta)
    return c_kv, k_rope[:, :, 0]


def _mla_block_step(m, l, acc, qn, qr, c_blk, kr_blk, k_b, v_b, row0: int,
                    col0: int, scale: float, causal: bool):
    """One key block of ``mla_sdpa_blocked``: keys and values expanded from
    the block's latent, then the online-softmax update of (m, l, acc),
    (B, H, bq[, vd]) in float32."""
    with roofline.attention_step():
        k_blk = torch.einsum("bsr,rhc->bshc", c_blk, k_b)
        v_blk = torch.einsum("bsr,rhv->bshv", c_blk, v_b)
        s = (torch.einsum("bqhc,bshc->bhqs", qn, k_blk.float())
             + torch.einsum("bqhr,bsr->bhqs", qr, kr_blk.float())) * scale
        if causal:
            rows = row0 + torch.arange(s.shape[2], device=s.device)[:, None]
            cols = col0 + torch.arange(s.shape[3], device=s.device)[None, :]
            s = s.masked_fill(~(cols <= rows), NEG)
        m_new = torch.maximum(m, s.amax(-1))
        sc = torch.exp(m - m_new)
        pw = torch.exp(s - m_new[..., None])
        l_new = l * sc + pw.sum(-1)
        acc_new = acc * sc[..., None] + torch.einsum("bhqs,bshv->bhqv", pw,
                                                     v_blk.float())
    return m_new, l_new, acc_new


def mla_sdpa_blocked(q_nope, q_rope, c_kv, k_rope, k_b, v_b, *, scale,
                     block: int = 1024, causal: bool = True):
    """Flash-MLA in plain torch, the port of the JAX function: keys and
    values are expanded from the latent per key block inside the loop, so
    neither the (T, S) scores nor the whole (B, S, H, nope) keys exist;
    each block step runs under ``torch.utils.checkpoint`` (JAX's
    ``jax.checkpoint(inner)``).  Ragged last blocks are sliced, not
    padded, and with the causal mask a key block that no query of the
    block sees is skipped (it would add exactly nothing).

    q_nope (B, T, H, nope); q_rope (B, T, H, rd); c_kv (B, S, r); k_rope
    (B, S, rd); k_b (r, H, nope); v_b (r, H, vd) -> (B, T, H, vd)."""
    B, T, H, _ = q_nope.shape
    S = c_kv.shape[1]
    vd = v_b.shape[-1]
    offset = S - T
    bq, bk = min(block, T), min(block, S)
    outs = []
    for i0 in range(0, T, bq):
        qn = q_nope[:, i0:i0 + bq].float()
        qr = q_rope[:, i0:i0 + bq].float()
        n = qn.shape[1]
        row0 = i0 + offset
        m = torch.full((B, H, n), NEG, dtype=torch.float32,
                       device=q_nope.device)
        l = torch.zeros((B, H, n), dtype=torch.float32, device=q_nope.device)
        acc = torch.zeros((B, H, n, vd), dtype=torch.float32,
                          device=q_nope.device)
        for j0 in range(0, S, bk):
            if causal and offset >= 0 and j0 > row0 + n - 1:
                continue
            m, l, acc = checkpoint(_mla_block_step, m, l, acc, qn, qr,
                                   c_kv[:, j0:j0 + bk], k_rope[:, j0:j0 + bk],
                                   k_b, v_b, row0, j0, scale, causal,
                                   use_reentrant=False)
        out = acc / torch.clamp(l, min=1e-30)[..., None]      # (B,H,n,vd)
        outs.append(out.transpose(1, 2))                     # (B,n,H,vd)
    return torch.cat(outs, dim=1).to(q_nope.dtype)


def mla_fwd(p, cfg: ModelConfig, x, positions):
    """Expanded (training and prefill) MLA.  Returns (out, (c_kv, k_rope)).

    From ``T >= 8 * cfg.attn_block`` on, the flash-MLA path
    (``mla_sdpa_blocked``), as in JAX: keys and values expand from the
    latent per key block, never materialising the (T, S) scores or the
    whole (B, S, H, nope) keys.  A counted dry run
    (``launch/roofline.attention``) counts the blocked path's expansion of
    the keys and values once, as the other path computes it."""
    B, T, _ = x.shape
    H, nope, vd = cfg.num_heads, cfg.qk_nope_dim, cfg.v_head_dim
    r = cfg.kv_lora_rank
    q_nope, q_rope = _mla_q(p, cfg, x, positions)
    c_kv, k_rope = _mla_latent(p, cfg, x, positions)
    scale = (nope + cfg.qk_rope_dim) ** -0.5
    width = nope + cfg.qk_rope_dim + vd
    if cfg.attn_block and T >= 8 * cfg.attn_block:
        with roofline.attention(B, H, width, T, T,
                                extra=2 * B * T * r * H * (nope + vd),
                                inputs=(q_nope, q_rope, c_kv, k_rope,
                                        p["k_b"], p["v_b"])):
            out = mla_sdpa_blocked(
                q_nope, q_rope, c_kv, k_rope, p["k_b"].reshape(r, H, nope),
                p["v_b"].reshape(r, H, vd), scale=scale,
                block=cfg.attn_block).reshape(B, T, H * vd)
        return out @ p["wo"], (c_kv, k_rope)
    k_nope = (c_kv @ p["k_b"]).reshape(B, T, H, nope)
    v = (c_kv @ p["v_b"]).reshape(B, T, H, vd)
    with roofline.attention(B, H, width, T, T,
                            inputs=(q_nope, q_rope, k_nope, k_rope, v)):
        scores = (torch.einsum("bthc,bshc->bhts", q_nope, k_nope)
                  + torch.einsum("bthc,bsc->bhts", q_rope, k_rope)).float()
        mask = causal_mask(T, T, device=x.device)
        w = torch.softmax((scores * scale).masked_fill(~mask, NEG),
                          dim=-1).to(x.dtype)
        out = torch.einsum("bhts,bshv->bthv", w, v).reshape(B, T, H * vd)
    return out @ p["wo"], (c_kv, k_rope)


def mla_decode(p, cfg: ModelConfig, x, cache_c, cache_kr, pos: int):
    """Absorbed-matrix MLA decode: the queries are projected into the
    latent space, so the cache is only (r + rope_d) wide.  x: (B, 1, d);
    cache_c: (B, S, r); cache_kr: (B, S, rope_d); pos: the new token's
    position (a Python int).

    The new latent and rope key are written into the caches IN PLACE, as
    ``attention_decode`` does (a ``pos`` past the cache raises, where JAX
    would clamp the write), and the query attends over the visible prefix
    ``[:pos + 1]`` (JAX masks the rest, whose weights are exactly 0)."""
    B = x.shape[0]
    S = cache_c.shape[1]
    if pos >= S:
        raise IndexError(f"mla_decode: position {pos} is past the cache's "
                         f"{S} slots; grow the cache first")
    H, nope, vd, r = (cfg.num_heads, cfg.qk_nope_dim, cfg.v_head_dim,
                      cfg.kv_lora_rank)
    positions = torch.full((B, 1), pos, device=x.device)
    q_nope, q_rope = _mla_q(p, cfg, x, positions)               # (B,1,H,*)
    c_new, kr_new = _mla_latent(p, cfg, x, positions)
    cache_c[:, pos] = c_new[:, 0]
    cache_kr[:, pos] = kr_new[:, 0]
    c_vis, kr_vis = cache_c[:, :pos + 1], cache_kr[:, :pos + 1]
    # absorb W_uk into q: q_lat (B, 1, H, r)
    q_lat = torch.einsum("bthc,rhc->bthr", q_nope,
                         p["k_b"].reshape(r, H, nope))
    scale = (nope + cfg.qk_rope_dim) ** -0.5
    with roofline.attention(B, H, 2 * r + cfg.qk_rope_dim, 1, pos + 1,
                            inputs=(q_lat, q_rope, c_vis, kr_vis)):
        scores = (torch.einsum("bthr,bsr->bhts", q_lat, c_vis)
                  + torch.einsum("bthc,bsc->bhts", q_rope, kr_vis)).float()
        w = torch.softmax(scores * scale, dim=-1).to(x.dtype)
        o_lat = torch.einsum("bhts,bsr->bthr", w, c_vis)           # (B,1,H,r)
    out = torch.einsum("bthr,rhv->bthv", o_lat,
                       p["v_b"].reshape(r, H, vd)).reshape(B, 1, H * vd)
    return out @ p["wo"], (cache_c, cache_kr)


# --------------------------------------------------------------------- MLP
def init_mlp(gen, cfg: ModelConfig, d_ff: Optional[int] = None, *,
             lead: tuple = ()):
    d, f = cfg.d_model, d_ff or cfg.d_ff
    dt = _dtype(cfg)
    p = {}
    if cfg.activation == "silu":
        p["w_gate"] = dense_init(gen, (*lead, d, f), dt)
    p["w_up"] = dense_init(gen, (*lead, d, f), dt)
    p["w_down"] = dense_init(gen, (*lead, f, d), dt)
    return p


def mlp_fwd(p, cfg: ModelConfig, x):
    """SwiGLU (silu), squared ReLU (relu2) or GELU (tanh form, as
    ``jax.nn.gelu``)."""
    if cfg.activation == "silu":
        h = F.silu(x @ p["w_gate"]) * (x @ p["w_up"])
    elif cfg.activation == "relu2":
        h = torch.square(F.relu(x @ p["w_up"]))
    else:
        h = F.gelu(x @ p["w_up"], approximate="tanh")
    return h @ p["w_down"]


# --------------------------------------------------------------------- MoE
def init_moe(gen, cfg: ModelConfig, *, lead: tuple = ()):
    """Router (float32), the experts' stacked ``w_in`` (E, d, 2f gated or
    f) and ``w_out`` (E, f, d), deepseek's always-on ``shared`` MLP and
    arctic's parallel ``dense`` MLP."""
    d, f, E = cfg.d_model, cfg.d_ff, cfg.num_experts
    dt = _dtype(cfg)
    gated = cfg.activation == "silu"
    p = {
        "router": dense_init(gen, (*lead, d, E), torch.float32),
        "w_in": dense_init(gen, (*lead, E, d, (2 if gated else 1) * f), dt),
        "w_out": dense_init(gen, (*lead, E, f, d), dt),
    }
    if cfg.num_shared_experts:
        p["shared"] = init_mlp(gen, cfg, d_ff=cfg.num_shared_experts * f,
                               lead=lead)
    if cfg.moe_dense_residual:
        p["dense"] = init_mlp(gen, cfg, d_ff=cfg.d_ff, lead=lead)
    return p


def _expert_ffn(cfg: ModelConfig, w_in, w_out, xs):
    """xs: (E, C, d) -> (E, C, d), batched expert matmuls."""
    h = torch.bmm(xs, w_in)
    if cfg.activation == "silu":
        g, u = torch.chunk(h, 2, dim=-1)
        h = F.silu(g) * u
    elif cfg.activation == "relu2":
        h = torch.square(F.relu(h))
    else:
        h = F.gelu(h, approximate="tanh")
    return torch.bmm(h, w_out)


def _rank_in_expert_cumsum(e_flat: torch.Tensor, E: int) -> torch.Tensor:
    """GShard-style slot-major ranking by a (kN, E) one-hot cumsum: the
    position of each assignment among the earlier ones to its expert."""
    onehot = F.one_hot(e_flat.long(), E)                        # (kN, E)
    pos = torch.cumsum(onehot, dim=0) - 1
    return torch.sum(pos * onehot, dim=-1)                      # (kN,)


def _rank_in_expert_sort(e_flat: torch.Tensor, E: int) -> torch.Tensor:
    """The same ranking by a stable sort, with no (kN, E) tensor: an
    assignment's index in the expert-sorted order minus the start of its
    expert's run.  The sort must be stable to keep slot-major priority."""
    n = e_flat.shape[0]
    iota = torch.arange(n, device=e_flat.device)
    sorted_e, sort_idx = torch.sort(e_flat, stable=True)
    is_start = torch.ones(n, dtype=torch.bool, device=e_flat.device)
    is_start[1:] = sorted_e[1:] != sorted_e[:-1]
    run_start = torch.cummax(torch.where(is_start, iota, 0), dim=0).values
    pos = torch.empty_like(iota)
    pos[sort_idx] = iota - run_start
    return pos


def _rank(dispatch: str):
    return (_rank_in_expert_sort if dispatch == "sort"
            else _rank_in_expert_cumsum)


def _flat_dispatch(p, cfg: ModelConfig, xt, gate_vals, idx, capacity: int,
                   dispatch: str):
    """One (E * C + 1, d) buffer: assignments in slot-major order (every
    token's first choice before any second choice) take the next free row
    of their expert; those over ``capacity`` go to the last row (the drop
    slot), which no expert reads, and get no weight."""
    N, d = xt.shape
    E, k = cfg.num_experts, cfg.num_experts_per_tok
    e_flat = idx.T.reshape(k * N)
    pos = _rank(dispatch)(e_flat, E)
    keep = pos < capacity
    flat_slot = torch.where(keep, e_flat * capacity + pos, E * capacity)
    buf = torch.zeros((E * capacity + 1, d), dtype=xt.dtype,
                      device=xt.device)
    buf.index_add_(0, flat_slot, xt.repeat(k, 1))
    out_e = _expert_ffn(cfg, p["w_in"], p["w_out"],
                        buf[:-1].reshape(E, capacity, d))
    gathered = out_e.reshape(E * capacity, d)[
        torch.clamp(flat_slot, max=E * capacity - 1)]
    g = (gate_vals.T.reshape(k * N) * keep).to(xt.dtype)[:, None]
    return torch.sum((gathered * g).reshape(k, N, d), dim=0)


def _grouped_dispatch(p, cfg: ModelConfig, xt, gate_vals, idx,
                      capacity: int, dispatch: str, G: int):
    """Group-local dispatch: the tokens cut into G groups, each ranked and
    held to ``capacity // G`` on its own, the groups' buffers laid out
    expert-major for the expert products (the JAX layout's all-to-all)."""
    N, d = xt.shape
    E, k = cfg.num_experts, cfg.num_experts_per_tok
    n, c_l = N // G, capacity // G
    xg = xt.reshape(G, n, d)
    e_flat = idx.reshape(G, n, k).transpose(1, 2).reshape(G, k * n)
    rank = _rank(dispatch)
    pos = torch.stack([rank(e, E) for e in e_flat])             # (G, kn)
    keep = pos < c_l
    slot = torch.where(keep, e_flat * c_l + pos, E * c_l)
    rows = E * c_l + 1
    buf = torch.zeros((G * rows, d), dtype=xt.dtype, device=xt.device)
    offsets = torch.arange(G, device=xt.device)[:, None] * rows
    buf.index_add_(0, (slot + offsets).reshape(-1),
                   xg.repeat(1, k, 1).reshape(G * k * n, d))
    buf = buf.reshape(G, rows, d)[:, :-1]                       # (G, E*c_l, d)
    buf = buf.reshape(G, E, c_l, d).transpose(0, 1).reshape(E, G * c_l, d)
    out_e = _expert_ffn(cfg, p["w_in"], p["w_out"], buf)
    back = out_e.reshape(E, G, c_l, d).transpose(0, 1).reshape(G, E * c_l, d)
    got = torch.gather(back, 1, torch.clamp(slot, max=E * c_l - 1)[..., None]
                       .expand(G, k * n, d))                    # (G, kn, d)
    gate_g = gate_vals.reshape(G, n, k).transpose(1, 2).reshape(G, k * n)
    g = (gate_g * keep).to(xt.dtype)[..., None]
    comb = torch.sum((got * g).reshape(G, k, n, d), dim=1)      # (G, n, d)
    return comb.reshape(N, d)


def moe_fwd(p, cfg: ModelConfig, x, *, capacity: Optional[int] = None,
            dispatch: Optional[str] = None):
    """Capacity-based top-k dispatch into an (E, C, d) expert buffer.

    Returns (out, aux_loss).  Tokens over capacity are dropped from the
    routed experts (the shared and dense paths and the residual still see
    them).  ``capacity=None`` uses ``max(1, int(N * k / E *
    cfg.capacity_factor))``; decode passes ``capacity=B``, so a one-token
    step drops nothing.  The router runs in float32; ``dispatch`` picks
    the ranking ("sort" or "cumsum", the same slot-major priority);
    ``cfg.moe_groups > 1`` takes the group-local layout when it divides
    the tokens and the capacity.  aux is the Switch/GShard load-balance
    loss E * sum_e f_e p_e * ``router_aux_coef``."""
    B, T, d = x.shape
    E, k = cfg.num_experts, cfg.num_experts_per_tok
    N = B * T
    xt = x.reshape(N, d)
    probs = torch.softmax(xt.float() @ p["router"], dim=-1)      # (N, E)
    gate_vals, idx = torch.topk(probs, k, dim=-1)                # (N, k)
    gate_vals = gate_vals / torch.clamp(gate_vals.sum(-1, keepdim=True),
                                        min=1e-9)
    capacity = capacity or max(1, int(N * k / E * cfg.capacity_factor))
    dispatch = dispatch or cfg.moe_dispatch
    groups = cfg.moe_groups
    if groups > 1 and N % groups == 0 and capacity % groups == 0:
        out = _grouped_dispatch(p, cfg, xt, gate_vals, idx, capacity,
                                dispatch, groups)
    else:
        out = _flat_dispatch(p, cfg, xt, gate_vals, idx, capacity, dispatch)
    if "shared" in p:
        out = out + mlp_fwd(p["shared"], cfg, xt)
    if "dense" in p:
        out = out + mlp_fwd(p["dense"], cfg, xt)
    me = probs.mean(dim=0)                                       # (E,)
    ce = F.one_hot(idx[:, 0], E).float().mean(dim=0)
    aux = E * torch.sum(me * ce) * cfg.router_aux_coef
    return out.reshape(B, T, d), aux
