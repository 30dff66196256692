"""Encoder-decoder backbone of seamless-m4t (audio), the port of
``repro.models.encdec``.  The mel/conv audio frontend is a stub, as in the
JAX package: the encoder takes precomputed frame embeddings (B, F,
d_model).

Encoder: bidirectional self-attention blocks.  Decoder: causal
self-attention, cross-attention over the encoder memory, MLP.  Params are
stacked on a leading layer axis (``encoder``, ``decoder``) and a Python
loop walks them.  The encoder's attention and the cross-attention are the
port's ``layers._sdpa``, plain torch, exactly where JAX calls ``ly._sdpa``;
the decoder's causal self-attention goes through ``layers.attention_fwd``
/ ``attention_decode``, so serving reaches the flash kernel, and
``train=True`` takes the training attention (and ``cfg.remat`` a
``torch.utils.checkpoint`` a layer).
"""
from __future__ import annotations

import torch
from torch.utils.checkpoint import checkpoint

from repro_torch.configs.base import ModelConfig
from repro_torch.launch import roofline
from repro_torch.models import layers as ly
from repro_torch.models.transformer import _layer, _logits


def init_encdec(seed: int, cfg: ModelConfig, *, device="cuda") -> dict:
    """Random params from a seeded ``torch.Generator`` on ``device``, the
    JAX init's distributions (as ``transformer.init_lm``)."""
    gen = torch.Generator(device=device).manual_seed(seed)
    dt = ly._dtype(cfg)
    d, Le, Ld = cfg.d_model, cfg.num_encoder_layers, cfg.num_layers

    def norm(L):
        return ly.init_rmsnorm(d, dt, device=device, lead=(L,))

    return {
        "embed": ly.dense_init(gen, (cfg.vocab_size, d), dt, scale=0.02),
        "lm_head": ly.dense_init(gen, (d, cfg.vocab_size), dt),
        "ln_f": ly.init_rmsnorm(d, dt, device=device),
        "encoder": {"ln1": norm(Le),
                    "attn": ly.init_attention(gen, cfg, lead=(Le,)),
                    "ln2": norm(Le),
                    "mlp": ly.init_mlp(gen, cfg, lead=(Le,))},
        "decoder": {"ln1": norm(Ld),
                    "self_attn": ly.init_attention(gen, cfg, lead=(Ld,)),
                    "ln_x": norm(Ld),
                    "cross_attn": ly.init_attention(gen, cfg, lead=(Ld,)),
                    "ln2": norm(Ld),
                    "mlp": ly.init_mlp(gen, cfg, lead=(Ld,))},
    }


def _cross_attention(p, cfg: ModelConfig, x, memory, positions_q):
    """Decoder -> encoder attention: no causal mask and no RoPE (the
    standard encoder-decoder); ``positions_q`` is unused, as in JAX.  K
    and V are projected from ``memory`` on every call."""
    B, T, _ = x.shape
    S = memory.shape[1]
    H, KVH, hd = cfg.num_heads, cfg.num_kv_heads, cfg.hd
    q = (x @ p["wq"]).reshape(B, T, H, hd)
    k = (memory @ p["wk"]).reshape(B, S, KVH, hd)
    v = (memory @ p["wv"]).reshape(B, S, KVH, hd)
    mask = torch.ones((1, 1, 1, T, S), dtype=torch.bool, device=x.device)
    with roofline.attention(B, H, 2 * hd, T, S, causal=False,
                            inputs=(q, k, v)):
        out = ly._sdpa(q, k, v, mask, scale=hd ** -0.5)
    return out.reshape(B, T, -1) @ p["wo"]


def _enc_block(x, lp, cfg: ModelConfig, positions):
    B, F_, _ = x.shape
    h = ly.rmsnorm(lp["ln1"], x, cfg.rms_eps)
    q, k, v = ly._qkv(lp["attn"], cfg, h, positions)
    mask = torch.ones((1, 1, 1, F_, F_), dtype=torch.bool, device=x.device)
    with roofline.attention(B, cfg.num_heads, 2 * cfg.hd, F_, F_,
                            causal=False, inputs=(q, k, v)):
        a = ly._sdpa(q, k, v, mask, scale=cfg.hd ** -0.5)   # bidirectional
    x = x + a.reshape(B, F_, -1) @ lp["attn"]["wo"]
    return x + ly.mlp_fwd(lp["mlp"], cfg, ly.rmsnorm(lp["ln2"], x,
                                                      cfg.rms_eps))


def encode(p, cfg: ModelConfig, frames: torch.Tensor, *,
           train: bool = False) -> torch.Tensor:
    """frames: (B, F, d) stub embeddings -> encoder memory (B, F, d)."""
    B, F_, _ = frames.shape
    positions = torch.arange(F_, device=frames.device).expand(B, F_)
    x = frames.to(ly._dtype(cfg))
    for i in range(cfg.num_encoder_layers):
        lp = _layer(p["encoder"], i)
        if train and cfg.remat:
            x = checkpoint(_enc_block, x, lp, cfg, positions,
                           use_reentrant=False)
        else:
            x = _enc_block(x, lp, cfg, positions)
    return x


def _dec_block(x, lp, cfg: ModelConfig, memory, positions, train: bool):
    h = ly.rmsnorm(lp["ln1"], x, cfg.rms_eps)
    a, _ = ly.attention_fwd(lp["self_attn"], cfg, h, positions, train=train)
    x = x + a
    h = ly.rmsnorm(lp["ln_x"], x, cfg.rms_eps)
    x = x + _cross_attention(lp["cross_attn"], cfg, h, memory, positions)
    return x + ly.mlp_fwd(lp["mlp"], cfg, ly.rmsnorm(lp["ln2"], x,
                                                      cfg.rms_eps))


def _decode_tokens(p, cfg: ModelConfig, memory, tokens, train: bool):
    """The decoder over ``tokens`` (B, T) attending to ``memory``: logits
    (B, T, V)."""
    x = p["embed"][tokens]
    B, T, _ = x.shape
    positions = torch.arange(T, device=x.device).expand(B, T)
    for i in range(cfg.num_layers):
        lp = _layer(p["decoder"], i)
        if train and cfg.remat:
            x = checkpoint(_dec_block, x, lp, cfg, memory, positions, True,
                           use_reentrant=False)
        else:
            x = _dec_block(x, lp, cfg, memory, positions, train)
    return _logits(p, cfg, x)


def forward(p, cfg: ModelConfig, batch: dict, *, train: bool = False):
    """batch: {"frames": (B, F, d), "tokens": (B, T)[, "labels"]}.
    Returns (logits (B, T, V), a float32 zero aux).  ``train=True`` for a
    caller that differentiates."""
    memory = encode(p, cfg, batch["frames"], train=train)
    logits = _decode_tokens(p, cfg, memory, batch["tokens"], train)
    return logits, torch.zeros((), dtype=torch.float32, device=logits.device)


def init_cache(cfg: ModelConfig, batch: int, cache_len: int, frames: int,
               dtype=None, *, device="cuda") -> dict:
    """{"memory": (B, frames, d), "k", "v": (L, B, cache_len, KVH, hd)},
    zeroed; the caller puts the encoder memory in."""
    dt = dtype or ly._dtype(cfg)
    L, kvh, hd = cfg.num_layers, cfg.num_kv_heads, cfg.hd
    return {
        "memory": torch.zeros((batch, frames, cfg.d_model), dtype=dt,
                              device=device),
        "k": torch.zeros((L, batch, cache_len, kvh, hd), dtype=dt,
                         device=device),
        "v": torch.zeros((L, batch, cache_len, kvh, hd), dtype=dt,
                         device=device),
    }


def decode_step(p, cfg: ModelConfig, cache, tokens, pos: int):
    """One decoder token at position ``pos`` (a Python int), the encoder
    memory read from the cache.  Returns (logits (B, 1, V), cache); the
    self-attention caches are written in place, and each layer's
    cross-attention K/V are projected from the memory again, as in JAX."""
    x = p["embed"][tokens]
    B = x.shape[0]
    memory = cache["memory"]
    positions = torch.full((B, 1), pos, device=x.device)
    for i in range(cfg.num_layers):
        lp = _layer(p["decoder"], i)
        h = ly.rmsnorm(lp["ln1"], x, cfg.rms_eps)
        a, _ = ly.attention_decode(lp["self_attn"], cfg, h, cache["k"][i],
                                   cache["v"][i], pos)
        x = x + a
        h = ly.rmsnorm(lp["ln_x"], x, cfg.rms_eps)
        x = x + _cross_attention(lp["cross_attn"], cfg, h, memory, positions)
        x = x + ly.mlp_fwd(lp["mlp"], cfg, ly.rmsnorm(lp["ln2"], x,
                                                       cfg.rms_eps))
    return _logits(p, cfg, x), cache


def lm_loss(p, cfg: ModelConfig, batch: dict):
    """Next-token cross-entropy in float32 over the labels >= 0 (-1 =
    ignore); the forward is the training one.  Returns (loss, {"ce"})."""
    logits, _ = forward(p, cfg, batch, train=True)
    labels = batch["labels"]
    logf = logits.float()
    logz = torch.logsumexp(logf, dim=-1)
    picked = torch.gather(logf, -1,
                          labels.long().clamp(min=0)[..., None])[..., 0]
    mask = (labels >= 0).float()
    ce = torch.sum((logz - picked) * mask) / torch.clamp(mask.sum(), min=1.0)
    return ce, {"ce": ce}
