"""Transformer building blocks of the dense decoders: the port of
``repro.models.layers`` (norms, RoPE, grouped-query attention for prefill
and one-token decode, dense MLPs), keeping the JAX names and param dicts.

Functional style, as in JAX: ``init_*`` builds a dict of tensors from a
seeded ``torch.Generator``, ``*_fwd`` applies it.  Weights are ``(in,
out)`` and applied as ``x @ w``.  ``lead`` prepends axes to every param,
so the model can build its layers' params stacked on a leading L axis in
one draw per leaf (``dense_init`` reads its fan-in from ``shape[-2]``, as
the JAX one does under ``vmap``).

Every attention goes through ``kernels.ops.flash_attention``: the CUDA
kernel for CUDA tensors, its plain version for CPU ones.  Multi-head latent
attention (MLA) and mixture-of-experts blocks are not ported (ROADMAP
Queue 1 item 10).
"""
from __future__ import annotations

from typing import Optional

import torch
import torch.nn.functional as F

from repro_torch.configs.base import ModelConfig
from repro_torch.kernels import ops
# the JAX module's mask helper, defined beside its user, the plain attention
from repro_torch.kernels.flash_attention import causal_mask  # noqa: F401

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
                                  "ported yet (ROADMAP Queue 1 item 10)")
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


def attention_fwd(p, cfg: ModelConfig, x, positions, *, window: int = 0):
    """Full prefill attention.  Returns (out, (k, v)), k/v for the cache.

    The JAX function picks between two jnp formulations of one function by
    ``cfg.attn_block``: scores materialised for T < 2 * attn_block, the
    blocked online-softmax scan above it, to keep (T, T) scores out of TPU
    memory.  The flash-attention kernel never materialises the scores at
    any T, so the port calls it for both, and ``attn_block`` stays in the
    config only for the JAX package."""
    B, T, _ = x.shape
    q, k, v = _qkv(p, cfg, x, positions)
    out = ops.flash_attention(q, k, v, causal=True, window=window)
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
