"""Decoder-only language model, every family of the JAX module: the dense,
VLM-prefix and MoE decoders (deepseek's with multi-head latent attention),
RWKV6 (``ssm``) and the Mamba2 hybrid with one shared attention block
(``hybrid``, zamba2): the port of ``repro.models.transformer``
(``init_lm``, ``forward``, ``init_cache``, ``decode_step``, ``prefill``,
``lm_loss``).  The audio encoder-decoder is ``models/encdec.py``.

Layer params are stacked on a leading L axis, as in JAX, and a Python loop
walks them (the port of ``jax.lax.scan``): ``p["layers"]["attn"]["wq"]``
is (L, d, H * hd).  A block's attention is GQA (``attn``: wq, wk, wv, wo)
or MLA (``attn``: q_a ... wo, ``cfg.use_mla``), its feed-forward a dense
MLP (``mlp``) or a mixture of experts (``moe``, ``cfg.num_experts``),
whose load-balance losses ``forward`` sums over the layers into its aux.
An ``ssm`` model's layers are RWKV6 blocks (``models/rwkv.py``); a
``hybrid`` model's are Mamba2 blocks (``models/ssm.py``), and after every
``cfg.attn_every`` of them the one ``shared_attn`` block (attention over
``cfg.sliding_window``, then an MLP) runs: JAX's group scan is a loop over
the G = L / attn_every groups.  ``forward(..., train=True)`` is the
training forward: GQA attention through the JAX module's jnp formulations
(``layers._sdpa`` / ``sdpa_blocked``) instead of the flash kernel, and
with ``cfg.remat`` each layer (each group of a hybrid) under
``torch.utils.checkpoint`` (the port of ``_maybe_remat``).
"""
from __future__ import annotations

from typing import Any

import torch
import torch.nn.functional as F
from torch.utils.checkpoint import checkpoint

from repro_torch.configs.base import ModelConfig
from repro_torch.models import layers as ly
from repro_torch.models import rwkv as rk
from repro_torch.models import ssm as sm


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
    gen = torch.Generator(device=device).manual_seed(seed)
    dt = ly._dtype(cfg)
    L, d = cfg.num_layers, cfg.d_model
    p: dict[str, Any] = {
        "embed": ly.dense_init(gen, (cfg.vocab_size, d), dt, scale=0.02),
        "ln_f": ly.init_rmsnorm(d, dt, device=device),
    }
    if not cfg.tie_embeddings:
        p["lm_head"] = ly.dense_init(gen, (d, cfg.vocab_size), dt)
    if cfg.arch_type == "ssm":                  # rwkv6
        p["layers"] = rk.init_rwkv6(gen, cfg, lead=(L,))
        return p
    if cfg.arch_type == "hybrid":               # zamba2: mamba2 + shared attn
        if not cfg.attn_every or L % cfg.attn_every:
            raise ValueError(f"{cfg.name}: {L} layers do not split into "
                             f"groups of attn_every={cfg.attn_every}")
        p["layers"] = sm.init_mamba2(gen, cfg, lead=(L,))
        p["shared_attn"] = {
            "ln1": ly.init_rmsnorm(d, dt, device=device),
            "attn": ly.init_attention(gen, cfg),
            "ln2": ly.init_rmsnorm(d, dt, device=device),
            "mlp": ly.init_mlp(gen, cfg),
        }
        return p
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


def _rwkv_train_block(x, lp, cfg: ModelConfig, zero_prev):
    return rk.rwkv6_block_fwd(lp, cfg, x, tm_prev=zero_prev,
                              cm_prev=zero_prev)[0]


def _hybrid_group(x, layers, shared, cfg: ModelConfig, g: int, positions,
                  win: int, train: bool):
    """Group ``g`` of a hybrid: its ``attn_every`` Mamba2 layers, then the
    shared attention block.  Returns (x out, the Mamba2 layers' caches,
    the attention's (k, v))."""
    E = cfg.attn_every
    sts = []
    for i in range(g * E, (g + 1) * E):
        out, st = sm.mamba2_fwd(_layer(layers, i), cfg, x)
        x = x + out
        sts.append(st)
    a, kv = ly.attention_fwd(shared["attn"], cfg,
                             ly.rmsnorm(shared["ln1"], x, cfg.rms_eps),
                             positions, window=win, train=train)
    x = x + a
    x = x + ly.mlp_fwd(shared["mlp"], cfg,
                       ly.rmsnorm(shared["ln2"], x, cfg.rms_eps))
    return x, sts, kv


def _hybrid_train_group(x, layers, shared, cfg: ModelConfig, g: int,
                        positions, win: int):
    return _hybrid_group(x, layers, shared, cfg, g, positions, win, True)[0]


def _stack(dicts):
    """A list of dicts of tensors -> one dict of tensors stacked on a new
    leading axis."""
    return {k: torch.stack([d[k] for d in dicts]) for k in dicts[0]}


def forward(p, cfg: ModelConfig, batch: dict, *, window: int | None = None,
            return_cache: bool = False, return_hidden: bool = False,
            train: bool = False):
    """Training/eval/prefill forward.  Returns (logits, aux) or, with
    ``return_cache``, (logits, cache) where cache matches ``init_cache``'s
    layout (sliding-window caches keep the last ``window`` positions, slot
    order aligned with the rotating decode buffer when T % window == 0);
    a hybrid's cache is JAX's group-scan output, (the Mamba2 caches
    stacked on (G, attn_every), k (G, B, S, KVH, hd), v), which
    ``prefill`` lays out as ``init_cache``'s.  ``return_hidden`` returns
    the final-normed hidden states instead of the logits.  ``train=True``
    is for a caller that differentiates: training attention, and each
    layer (each group of a hybrid) checkpointed when ``cfg.remat``."""
    x = _embed(p, cfg, batch)
    B, T, _ = x.shape
    positions = torch.arange(T, device=x.device).expand(B, T)
    win = cfg.sliding_window if window is None else window
    remat = train and cfg.remat and not return_cache
    zero_aux = torch.zeros((), dtype=torch.float32, device=x.device)

    def _out(x):
        """The final norm (and the LM head unless ``return_hidden``)."""
        if return_hidden:
            return ly.rmsnorm(p["ln_f"], x, cfg.rms_eps)
        return _logits(p, cfg, x)

    def trim(kv):  # kv: (B, T, KVH, hd), seq axis 1
        """Sliding-window caches are window-sized rotating buffers: keep
        the last ``win`` keys, or pad at the end when T < win."""
        if not win:
            return kv
        if kv.shape[1] >= win:
            return kv[:, -win:]
        return F.pad(kv, (0, 0, 0, 0, 0, win - kv.shape[1]))

    if cfg.arch_type == "ssm":
        zero_prev = torch.zeros((B, 1, cfg.d_model), dtype=x.dtype,
                                device=x.device)
        carries = []
        for i in range(cfg.num_layers):
            lp = _layer(p["layers"], i)
            if remat:
                x = checkpoint(_rwkv_train_block, x, lp, cfg, zero_prev,
                               use_reentrant=False)
                continue
            x, c = rk.rwkv6_block_fwd(lp, cfg, x, tm_prev=zero_prev,
                                      cm_prev=zero_prev)
            if return_cache:
                carries.append(c)
        if return_cache:
            return _out(x), _stack(carries)
        return _out(x), zero_aux

    if cfg.arch_type == "hybrid":
        G = cfg.num_layers // cfg.attn_every
        shared = p["shared_attn"]
        groups, ks, vs = [], [], []
        for g in range(G):
            if remat:
                x = checkpoint(_hybrid_train_group, x, p["layers"], shared,
                               cfg, g, positions, win, use_reentrant=False)
                continue
            x, sts, (k, v) = _hybrid_group(x, p["layers"], shared, cfg, g,
                                           positions, win, train)
            if return_cache:
                groups.append(_stack(sts))
                ks.append(trim(k))
                vs.append(trim(v))
        if return_cache:
            return _out(x), (_stack(groups), torch.stack(ks),
                             torch.stack(vs))
        return _out(x), zero_aux

    ks, vs, auxs = [], [], []
    for i in range(cfg.num_layers):
        lp = _layer(p["layers"], i)
        if remat:
            x, aux = checkpoint(_train_block, x, lp, cfg, positions, win,
                                use_reentrant=False)
            auxs.append(aux)
            continue
        x, (k, v), aux = _block(lp, cfg, x, positions, win, train)
        auxs.append(aux)
        if return_cache:
            ks.append(k if cfg.use_mla else trim(k))
            vs.append(v if cfg.use_mla else trim(v))

    out = _out(x)
    if return_cache:
        if cfg.use_mla:
            return out, {"c_kv": torch.stack(ks), "k_rope": torch.stack(vs)}
        return out, {"k": torch.stack(ks), "v": torch.stack(vs)}
    return out, torch.stack(auxs).sum()


# -------------------------------------------------------------------- cache
def init_cache(cfg: ModelConfig, batch: int, cache_len: int, dtype=None, *,
               device="cuda") -> dict:
    """Zeroed decode cache.  {"k", "v"}: (L, B, S, KVH, hd) each, S the
    sliding window when the config has one; with MLA {"c_kv": (L, B,
    cache_len, kv_lora_rank), "k_rope": (L, B, cache_len, qk_rope_dim)};
    an ``ssm`` model's RWKV carries {"tm_prev", "cm_prev": (L, B, 1, d),
    "state": (L, B, H, hd, hd) float32}, whatever ``cache_len``; a
    ``hybrid``'s {"mamba": {"conv": (L, B, K - 1, d_in + 2 state), "ssm":
    (L, B, heads, state, head_p) float32}, "attn_k", "attn_v": (G, B, S,
    KVH, hd)}."""
    dt = dtype or ly._dtype(cfg)
    L = cfg.num_layers
    if cfg.arch_type == "ssm":
        return rk.init_rwkv6_cache(cfg, batch, dt, device=device, lead=(L,))
    kvh, hd = cfg.num_kv_heads, cfg.hd
    if cfg.arch_type == "hybrid":
        G = L // cfg.attn_every
        S = min(cfg.sliding_window or cache_len, cache_len)
        return {"mamba": sm.init_mamba2_cache(cfg, batch, dt, device=device,
                                              lead=(L,)),
                "attn_k": torch.zeros((G, batch, S, kvh, hd), dtype=dt,
                                      device=device),
                "attn_v": torch.zeros((G, batch, S, kvh, hd), dtype=dt,
                                      device=device)}
    if cfg.use_mla:
        return {"c_kv": torch.zeros((L, batch, cache_len, cfg.kv_lora_rank),
                                    dtype=dt, device=device),
                "k_rope": torch.zeros((L, batch, cache_len,
                                       cfg.qk_rope_dim), dtype=dt,
                                      device=device)}
    S = min(cfg.sliding_window or cache_len, cache_len)
    shape = (L, batch, S, kvh, hd)
    return {"k": torch.zeros(shape, dtype=dt, device=device),
            "v": torch.zeros(shape, dtype=dt, device=device)}


# ------------------------------------------------------------------- decode
def _write(cache: dict, new: dict) -> None:
    """Copy a layer's new recurrent state into its views of the cache."""
    for k, v in new.items():
        cache[k].copy_(v)


def decode_step(p, cfg: ModelConfig, cache, tokens, pos: int):
    """One-token decode.  tokens: (B, 1) int; pos: the current position
    (== tokens already in the cache), a Python int.  Returns (logits,
    cache); the cache is updated in place (``attention_decode`` /
    ``mla_decode`` write their slot, and the RWKV and Mamba2 layers'
    recurrent states are copied into their views).  MoE layers take
    ``capacity = B``, as in JAX, so a decode step drops no token."""
    x = p["embed"][tokens]
    if cfg.arch_type == "ssm":
        for i in range(cfg.num_layers):
            c = _layer(cache, i)
            x, new = rk.rwkv6_block_decode(_layer(p["layers"], i), cfg, x, c)
            _write(c, new)
        return _logits(p, cfg, x), cache
    if cfg.arch_type == "hybrid":
        shared = p["shared_attn"]
        E = cfg.attn_every
        for g in range(cfg.num_layers // E):
            for i in range(g * E, (g + 1) * E):
                c = _layer(cache["mamba"], i)
                out, new = sm.mamba2_decode(_layer(p["layers"], i), cfg, x, c)
                _write(c, new)
                x = x + out
            a, _ = ly.attention_decode(
                shared["attn"], cfg,
                ly.rmsnorm(shared["ln1"], x, cfg.rms_eps),
                cache["attn_k"][g], cache["attn_v"][g], pos,
                window=cfg.sliding_window)
            x = x + a
            x = x + ly.mlp_fwd(shared["mlp"], cfg,
                               ly.rmsnorm(shared["ln2"], x, cfg.rms_eps))
        return _logits(p, cfg, x), cache
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
    """Serving prefill: (last-token logits (B, V), decode cache in
    ``init_cache``'s layout).  A full-attention cache is T long; a caller
    that decodes past it grows it first, as no function of the JAX package
    does either.  The RWKV carries never grow, and a hybrid's attention
    caches are window-sized rotating buffers."""
    logits, cache = forward(p, cfg, batch, return_cache=True)
    if cfg.arch_type == "hybrid":
        sts, k, v = cache
        L = cfg.num_layers
        cache = {"mamba": {n: a.reshape(L, *a.shape[2:])
                           for n, a in sts.items()},
                 "attn_k": k, "attn_v": v}
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
