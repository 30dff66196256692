"""Decoder-only language model, the dense, VLM-prefix and MoE families
(deepseek's with multi-head latent attention): the port of
``repro.models.transformer`` (``init_lm``, ``forward``, ``init_cache``,
``decode_step``, ``prefill``, ``lm_loss``).

Layer params are stacked on a leading L axis, as in JAX, and a Python loop
walks them (the port of ``jax.lax.scan``): ``p["layers"]["attn"]["wq"]``
is (L, d, H * hd).  A block's attention is GQA (``attn``: wq, wk, wv, wo)
or MLA (``attn``: q_a ... wo, ``cfg.use_mla``), its feed-forward a dense
MLP (``mlp``) or a mixture of experts (``moe``, ``cfg.num_experts``),
whose load-balance losses ``forward`` sums over the layers into its aux.
``forward(..., train=True)`` is the training forward: GQA attention
through the JAX module's jnp formulations (``layers._sdpa`` /
``sdpa_blocked``) instead of the flash kernel, and with ``cfg.remat`` each
layer under ``torch.utils.checkpoint`` (the port of ``_maybe_remat``).
The ``ssm`` (rwkv6), ``hybrid`` (zamba2), encoder-decoder and audio
branches are not ported and raise (ROADMAP Queue 1 item 10.4).
"""
from __future__ import annotations

from typing import Any

import torch
import torch.nn.functional as F
from torch.utils.checkpoint import checkpoint

from repro_torch.configs.base import ModelConfig
from repro_torch.models import layers as ly


def _check_ported(cfg: ModelConfig) -> None:
    if cfg.arch_type not in ("dense", "vlm", "moe"):
        raise NotImplementedError(
            f"{cfg.name} ({cfg.arch_type}) is not ported yet: the port runs "
            "the dense, VLM-prefix and MoE decoders, with GQA or MLA "
            "attention (ROADMAP Queue 1 item 10.4)")


def _layer(tree, i: int):
    """Layer ``i``'s params: a view into every stacked (L, ...) leaf."""
    if isinstance(tree, dict):
        return {k: _layer(v, i) for k, v in tree.items()}
    return tree[i]


# --------------------------------------------------------------------- init
def init_lm(seed: int, cfg: ModelConfig, *, device="cuda") -> dict:
    """Random params from a seeded ``torch.Generator`` on ``device``
    (``dense_init`` for every matrix, ones for the norms, zeros for the
    biases, the JAX init's distributions; not its ``jax.random`` draws).
    Every leaf is allocated once in its final dtype and filled a layer and
    an expert at a time, so a full-width model needs no float32 copy."""
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
    init_attn = ly.init_mla if cfg.use_mla else ly.init_attention
    p["layers"] = {
        "ln1": ly.init_rmsnorm(d, dt, device=device, lead=(L,)),
        "ln2": ly.init_rmsnorm(d, dt, device=device, lead=(L,)),
        "attn": init_attn(gen, cfg, lead=(L,)),
    }
    if cfg.num_experts:
        p["layers"]["moe"] = ly.init_moe(gen, cfg, lead=(L,))
    else:
        p["layers"]["mlp"] = ly.init_mlp(gen, cfg, lead=(L,))
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
def _block(lp, cfg: ModelConfig, x, positions, win: int, train: bool):
    """One decoder layer: (x out, its cache entries ((k, v), or (c_kv,
    k_rope) with MLA), its MoE aux loss (a float32 zero without
    experts))."""
    h = ly.rmsnorm(lp["ln1"], x, cfg.rms_eps)
    if cfg.use_mla:
        a, kv = ly.mla_fwd(lp["attn"], cfg, h, positions)
    else:
        a, kv = ly.attention_fwd(lp["attn"], cfg, h, positions, window=win,
                                 train=train)
    x = x + a
    h = ly.rmsnorm(lp["ln2"], x, cfg.rms_eps)
    if cfg.num_experts:
        m, aux = ly.moe_fwd(lp["moe"], cfg, h)
    else:
        m = ly.mlp_fwd(lp["mlp"], cfg, h)
        aux = torch.zeros((), dtype=torch.float32, device=x.device)
    return x + m, kv, aux


def _train_block(x, lp, cfg: ModelConfig, positions, win: int):
    out, _, aux = _block(lp, cfg, x, positions, win, True)
    return out, aux


def forward(p, cfg: ModelConfig, batch: dict, *, window: int | None = None,
            return_cache: bool = False, return_hidden: bool = False,
            train: bool = False):
    """Training/eval/prefill forward.  Returns (logits, aux) or, with
    ``return_cache``, (logits, cache) where cache matches ``init_cache``'s
    layout (sliding-window caches keep the last ``window`` positions, slot
    order aligned with the rotating decode buffer when T % window == 0).
    ``return_hidden`` returns the final-normed hidden states instead of the
    logits.  ``train=True`` is for a caller that differentiates: training
    attention, and each layer checkpointed when ``cfg.remat``."""
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

    ks, vs, auxs = [], [], []
    for i in range(cfg.num_layers):
        lp = _layer(p["layers"], i)
        if train and cfg.remat and not return_cache:
            x, aux = checkpoint(_train_block, x, lp, cfg, positions, win,
                                use_reentrant=False)
            auxs.append(aux)
            continue
        x, (k, v), aux = _block(lp, cfg, x, positions, win, train)
        auxs.append(aux)
        if return_cache:
            ks.append(k if cfg.use_mla else trim(k))
            vs.append(v if cfg.use_mla else trim(v))

    out = (ly.rmsnorm(p["ln_f"], x, cfg.rms_eps) if return_hidden
           else _logits(p, cfg, x))
    if return_cache:
        if cfg.use_mla:
            return out, {"c_kv": torch.stack(ks), "k_rope": torch.stack(vs)}
        return out, {"k": torch.stack(ks), "v": torch.stack(vs)}
    return out, torch.stack(auxs).sum()


# -------------------------------------------------------------------- cache
def init_cache(cfg: ModelConfig, batch: int, cache_len: int, dtype=None, *,
               device="cuda") -> dict:
    """Zeroed decode cache {"k", "v"}: (L, B, S, KVH, hd) each, S the
    sliding window when the config has one; with MLA {"c_kv": (L, B,
    cache_len, kv_lora_rank), "k_rope": (L, B, cache_len, qk_rope_dim)}."""
    _check_ported(cfg)
    dt = dtype or ly._dtype(cfg)
    L = cfg.num_layers
    if cfg.use_mla:
        return {"c_kv": torch.zeros((L, batch, cache_len, cfg.kv_lora_rank),
                                    dtype=dt, device=device),
                "k_rope": torch.zeros((L, batch, cache_len,
                                       cfg.qk_rope_dim), dtype=dt,
                                      device=device)}
    S = min(cfg.sliding_window or cache_len, cache_len)
    shape = (L, batch, S, cfg.num_kv_heads, cfg.hd)
    return {"k": torch.zeros(shape, dtype=dt, device=device),
            "v": torch.zeros(shape, dtype=dt, device=device)}


# ------------------------------------------------------------------- decode
def decode_step(p, cfg: ModelConfig, cache, tokens, pos: int):
    """One-token decode.  tokens: (B, 1) int; pos: the current position
    (== tokens already in the cache), a Python int.  Returns (logits,
    cache); the cache is updated in place (``attention_decode`` /
    ``mla_decode``).  MoE layers take ``capacity = B``, as in JAX, so a
    decode step drops no token."""
    _check_ported(cfg)
    x = p["embed"][tokens]
    for i in range(cfg.num_layers):
        lp = _layer(p["layers"], i)
        h = ly.rmsnorm(lp["ln1"], x, cfg.rms_eps)
        if cfg.use_mla:
            a, _ = ly.mla_decode(lp["attn"], cfg, h, cache["c_kv"][i],
                                 cache["k_rope"][i], pos)
        else:
            a, _ = ly.attention_decode(lp["attn"], cfg, h, cache["k"][i],
                                       cache["v"][i], pos,
                                       window=cfg.sliding_window)
        x = x + a
        h = ly.rmsnorm(lp["ln2"], x, cfg.rms_eps)
        if cfg.num_experts:
            m, _ = ly.moe_fwd(lp["moe"], cfg, h, capacity=h.shape[0])
        else:
            m = ly.mlp_fwd(lp["mlp"], cfg, h)
        x = x + m
    return _logits(p, cfg, x), cache


def prefill(p, cfg: ModelConfig, batch: dict):
    """Serving prefill: (last-token logits (B, V), decode cache).  The
    cache is T long (or the window); a caller that decodes past it grows
    it first, as no function of the JAX package does either."""
    logits, cache = forward(p, cfg, batch, return_cache=True)
    return logits[:, -1, :].contiguous(), cache


# -------------------------------------------------------------------- loss
def lm_loss(p, cfg: ModelConfig, batch: dict):
    """Next-token cross-entropy plus aux (the MoE load-balance losses
    summed over the layers; zero for the families without experts), in
    float32 over the labels >= 0 (-1 = ignore); a VLM's prefix positions
    are sliced off, so the labels cover the token region only.  Returns
    (loss, {"ce", "aux"}); the forward is the training one."""
    logits, aux = forward(p, cfg, batch, train=True)
    if cfg.prefix_len:
        logits = logits[:, cfg.prefix_len:, :]
    labels = batch["labels"]
    logf = logits.float()
    logz = torch.logsumexp(logf, dim=-1)
    picked = torch.gather(logf, -1,
                          labels.long().clamp(min=0)[..., None])[..., 0]
    mask = (labels >= 0).float()
    ce = torch.sum((logz - picked) * mask) / torch.clamp(mask.sum(), min=1.0)
    return ce + aux, {"ce": ce, "aux": aux}
