"""Decoder-only language model, dense and VLM-prefix families: the port of
``repro.models.transformer`` (``init_lm``, ``forward``, ``init_cache``,
``decode_step``, ``prefill``), serving path only.

Layer params are stacked on a leading L axis, as in JAX, and a Python loop
walks them (the port of ``jax.lax.scan``): ``p["layers"]["attn"]["wq"]``
is (L, d, H * hd).  The MoE, MLA, ``ssm`` (rwkv6), ``hybrid`` (zamba2) and
audio branches are not ported and raise (ROADMAP Queue 1 item 10), as do
``lm_loss`` and training.
"""
from __future__ import annotations

from typing import Any

import torch
import torch.nn.functional as F

from repro_torch.configs.base import ModelConfig
from repro_torch.models import layers as ly


def _check_ported(cfg: ModelConfig) -> None:
    if cfg.arch_type not in ("dense", "vlm") or cfg.use_mla or cfg.num_experts:
        raise NotImplementedError(
            f"{cfg.name} ({cfg.arch_type}, mla={cfg.use_mla}, experts="
            f"{cfg.num_experts}) is not ported yet: the port runs dense "
            "decoders (ROADMAP Queue 1 item 10)")


def _layer(tree, i: int):
    """Layer ``i``'s params: a view into every stacked (L, ...) leaf."""
    if isinstance(tree, dict):
        return {k: _layer(v, i) for k, v in tree.items()}
    return tree[i]


# --------------------------------------------------------------------- init
def init_lm(seed: int, cfg: ModelConfig, *, device="cuda") -> dict:
    """Random params from a seeded ``torch.Generator`` on ``device``
    (``dense_init`` for every matrix, ones for the norms, zeros for the
    biases, the JAX init's distributions; not its ``jax.random`` draws)."""
    _check_ported(cfg)
    gen = torch.Generator(device=device).manual_seed(seed)
    dt = ly._dtype(cfg)
    L, d = cfg.num_layers, cfg.d_model
    p: dict[str, Any] = {
        "embed": ly.dense_init(gen, (cfg.vocab_size, d), dt, scale=0.02),
        "ln_f": ly.init_rmsnorm(d, dt, device=device),
    }
    if not cfg.tie_embeddings:
        p["lm_head"] = ly.dense_init(gen, (d, cfg.vocab_size), dt)
    p["layers"] = {
        "ln1": ly.init_rmsnorm(d, dt, device=device, lead=(L,)),
        "ln2": ly.init_rmsnorm(d, dt, device=device, lead=(L,)),
        "attn": ly.init_attention(gen, cfg, lead=(L,)),
        "mlp": ly.init_mlp(gen, cfg, lead=(L,)),
    }
    return p


# ------------------------------------------------------------------ embed/IO
def _embed(p, cfg: ModelConfig, batch: dict) -> torch.Tensor:
    x = p["embed"][batch["tokens"]]
    if cfg.prefix_len:
        prefix = batch["prefix"].to(x.dtype)            # (B,P,d) stub frontend
        x = torch.cat([prefix, x], dim=1)
    return x


def _logits(p, cfg: ModelConfig, x) -> torch.Tensor:
    x = ly.rmsnorm(p["ln_f"], x, cfg.rms_eps)
    w = p["embed"].T if cfg.tie_embeddings else p["lm_head"]
    return x @ w


# ------------------------------------------------------------------ forward
def forward(p, cfg: ModelConfig, batch: dict, *, window: int | None = None,
            return_cache: bool = False, return_hidden: bool = False):
    """Eval/prefill forward.  Returns (logits, aux) or, with
    ``return_cache``, (logits, cache) where cache matches ``init_cache``'s
    layout (sliding-window caches keep the last ``window`` positions, slot
    order aligned with the rotating decode buffer when T % window == 0).
    ``return_hidden`` returns the final-normed hidden states instead of the
    logits."""
    _check_ported(cfg)
    x = _embed(p, cfg, batch)
    B, T, _ = x.shape
    positions = torch.arange(T, device=x.device).expand(B, T)
    win = cfg.sliding_window if window is None else window

    def trim(kv):  # kv: (B, T, KVH, hd), seq axis 1
        """Sliding-window caches are window-sized rotating buffers: keep
        the last ``win`` keys, or pad at the end when T < win."""
        if not win:
            return kv
        if kv.shape[1] >= win:
            return kv[:, -win:]
        return F.pad(kv, (0, 0, 0, 0, 0, win - kv.shape[1]))

    ks, vs = [], []
    for i in range(cfg.num_layers):
        lp = _layer(p["layers"], i)
        h = ly.rmsnorm(lp["ln1"], x, cfg.rms_eps)
        a, (k, v) = ly.attention_fwd(lp["attn"], cfg, h, positions,
                                     window=win)
        x = x + a
        h = ly.rmsnorm(lp["ln2"], x, cfg.rms_eps)
        x = x + ly.mlp_fwd(lp["mlp"], cfg, h)
        if return_cache:
            ks.append(trim(k))
            vs.append(trim(v))

    out = (ly.rmsnorm(p["ln_f"], x, cfg.rms_eps) if return_hidden
           else _logits(p, cfg, x))
    if return_cache:
        return out, {"k": torch.stack(ks), "v": torch.stack(vs)}
    return out, torch.zeros((), dtype=torch.float32, device=x.device)


# -------------------------------------------------------------------- cache
def init_cache(cfg: ModelConfig, batch: int, cache_len: int, dtype=None, *,
               device="cuda") -> dict:
    """Zeroed decode cache {"k", "v"}: (L, B, S, KVH, hd) each, S the
    sliding window when the config has one."""
    _check_ported(cfg)
    dt = dtype or ly._dtype(cfg)
    S = min(cfg.sliding_window or cache_len, cache_len)
    shape = (cfg.num_layers, batch, S, cfg.num_kv_heads, cfg.hd)
    return {"k": torch.zeros(shape, dtype=dt, device=device),
            "v": torch.zeros(shape, dtype=dt, device=device)}


# ------------------------------------------------------------------- decode
def decode_step(p, cfg: ModelConfig, cache, tokens, pos: int):
    """One-token decode.  tokens: (B, 1) int; pos: the current position
    (== tokens already in the cache), a Python int.  Returns (logits,
    cache); the cache is updated in place (``attention_decode``)."""
    _check_ported(cfg)
    x = p["embed"][tokens]
    for i in range(cfg.num_layers):
        lp = _layer(p["layers"], i)
        h = ly.rmsnorm(lp["ln1"], x, cfg.rms_eps)
        a, _ = ly.attention_decode(lp["attn"], cfg, h, cache["k"][i],
                                   cache["v"][i], pos,
                                   window=cfg.sliding_window)
        x = x + a
        h = ly.rmsnorm(lp["ln2"], x, cfg.rms_eps)
        x = x + ly.mlp_fwd(lp["mlp"], cfg, h)
    return _logits(p, cfg, x), cache


def prefill(p, cfg: ModelConfig, batch: dict):
    """Serving prefill: (last-token logits (B, V), decode cache).  The
    cache is T long (or the window); a caller that decodes past it grows
    it first, as no function of the JAX package does either."""
    logits, cache = forward(p, cfg, batch, return_cache=True)
    return logits[:, -1, :].contiguous(), cache
