"""Transformer building blocks of the dense decoders: the port of
``repro.models.layers`` (norms, RoPE, grouped-query attention for prefill
and one-token decode, dense MLPs), keeping the JAX names and param dicts.

Functional style, as in JAX: ``init_*`` builds a dict of tensors from a
seeded ``torch.Generator``, ``*_fwd`` applies it.  Weights are ``(in,
out)`` and applied as ``x @ w``.  ``lead`` prepends axes to every param,
so the model can build its layers' params stacked on a leading L axis in
one draw per leaf (``dense_init`` reads its fan-in from ``shape[-2]``, as
the JAX one does under ``vmap``).

Serving attention (prefill and decode) goes through
``kernels.ops.flash_attention``: the CUDA kernel for CUDA tensors, its
plain version for CPU ones.  Training attention (``attention_fwd(...,
train=True)``) is the JAX module's own: ``_sdpa`` (scores materialised)
below ``2 * cfg.attn_block`` positions and ``sdpa_blocked`` (an online
softmax over key blocks, each block step recomputed in the backward) at
or above it, in plain torch, as the reference trains through jnp and
never through its Pallas kernel.  Multi-head latent attention (MLA) and
mixture-of-experts blocks are not ported (ROADMAP Queue 1 item 10.4).
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

DTYPES = {"float32": torch.float32, "bfloat16": torch.bfloat16}


def _dtype(cfg: ModelConfig) -> torch.dtype:
    return DTYPES[cfg.dtype]


def dense_init(gen: torch.Generator, shape, dtype,
               scale: Optional[float] = None) -> torch.Tensor:
    """Normal(0, scale^2) in float32, cast to ``dtype``, on the generator's
    device; ``scale`` defaults to fan_in^-1/2 with fan_in = ``shape[-2]``."""
    fan_in = shape[-2] if len(shape) > 1 else shape[0]
    scale = scale if scale is not None else fan_in ** -0.5
    w = torch.randn(shape, generator=gen, dtype=torch.float32,
                    device=gen.device)
    return (w.mul_(scale)).to(dtype)


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
    if cfg.use_mla:
        raise NotImplementedError("multi-head latent attention (MLA) is not "
                                  "ported yet (ROADMAP Queue 1 item 10.4)")
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
    ``sdpa_blocked`` at or above it."""
    B, T, _ = x.shape
    q, k, v = _qkv(p, cfg, x, positions)
    if not train:
        out = ops.flash_attention(q, k, v, causal=True, window=window)
    elif cfg.attn_block and T >= 2 * cfg.attn_block:
        out = sdpa_blocked(q, k, v, scale=cfg.hd ** -0.5, causal=True,
                           window=window, block=cfg.attn_block)
    else:
        mask = causal_mask(T, T, window=window, device=x.device)
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
