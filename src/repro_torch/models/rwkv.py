"""RWKV6 "Finch" block, the port of ``repro.models.rwkv``: data-dependent
decay linear attention (time mix) and a squared-ReLU channel mix, with the
token-shift data-dependent LoRA interpolation.

Time-mix recurrence per head (dk = dv = head_dim):
    S_t = diag(w_t) S_{t-1} + k_t (x) v_t
    y_t = r_t . (S_{t-1} + diag(u) k_t (x) v_t)        (bonus convention)
with w_t = exp(-exp(w0 + lora_w(x-shift))), through the shared chunked scan
(``bonus_mode=True``).  ``w0`` and the bonus ``u`` are float32, every other
leaf the config's dtype; ``lead`` prepends the stack axes.
"""
from __future__ import annotations

import torch
import torch.nn.functional as F

from repro_torch.configs.base import ModelConfig
from repro_torch.models import chunked_scan as cs
from repro_torch.models.layers import _dtype, dense_init, init_rmsnorm, rmsnorm

_MIX_RANK = 32
_DECAY_RANK = 64
_MIX_KEYS = ("r", "k", "v", "w", "g")


def _heads(cfg: ModelConfig):
    H = cfg.num_heads
    return H, cfg.d_model // H


def init_rwkv6(gen: torch.Generator, cfg: ModelConfig, *, lead: tuple = ()):
    d = cfg.d_model
    H, hd = _heads(cfg)
    dt = _dtype(cfg)
    dev = gen.device

    def zeros(*shape):
        return torch.zeros((*lead, *shape), dtype=dt, device=dev)

    return {
        "ln1": init_rmsnorm(d, dt, device=dev, lead=lead),
        "ln2": init_rmsnorm(d, dt, device=dev, lead=lead),
        # --- time mix ---
        "mu_base": zeros(d),
        "mix_lora_a": dense_init(gen, (*lead, d, _MIX_RANK * 5), dt),
        "mix_lora_b": dense_init(gen, (*lead, 5, _MIX_RANK, d), dt,
                                 scale=0.01),
        "mu": zeros(5, d),
        "w0": torch.full((*lead, d), -2.0, dtype=torch.float32, device=dev),
        "w_lora_a": dense_init(gen, (*lead, d, _DECAY_RANK), dt),
        "w_lora_b": dense_init(gen, (*lead, _DECAY_RANK, d), dt, scale=0.01),
        "wr": dense_init(gen, (*lead, d, d), dt),
        "wk": dense_init(gen, (*lead, d, d), dt),
        "wv": dense_init(gen, (*lead, d, d), dt),
        "wg": dense_init(gen, (*lead, d, d), dt),
        "wo": dense_init(gen, (*lead, d, d), dt),
        "u": torch.full((*lead, H, hd), 0.5, dtype=torch.float32,
                        device=dev),                          # bonus
        "ln_x": init_rmsnorm(d, dt, device=dev, lead=lead),
        # --- channel mix ---
        "cm_mu_k": zeros(d),
        "cm_mu_r": zeros(d),
        "cm_k": dense_init(gen, (*lead, d, cfg.d_ff), dt),
        "cm_v": dense_init(gen, (*lead, cfg.d_ff, d), dt),
        "cm_r": dense_init(gen, (*lead, d, d), dt),
    }


def _token_shift(x, prev):
    """The x_{t-1} stream; ``prev`` (B, 1, d) is the carry before x."""
    return torch.cat([prev, x[:, :-1, :]], dim=1)


def _ddlerp(p, x, xs):
    """Finch's data-dependent interpolation for the 5 streams r, k, v, w,
    g."""
    diff = xs - x
    base = x + diff * p["mu_base"]
    lora = torch.tanh(base @ p["mix_lora_a"])                    # (B,T,5R)
    B_, T = x.shape[:2]
    lora = lora.reshape(B_, T, 5, _MIX_RANK)
    adj = torch.einsum("btfr,frd->btfd", lora, p["mix_lora_b"])  # (B,T,5,d)
    mixed = x[:, :, None, :] + diff[:, :, None, :] * (p["mu"] + adj)
    return {k: mixed[:, :, i, :] for i, k in enumerate(_MIX_KEYS)}


def _time_mix_qkvw(p, cfg: ModelConfig, x, xs):
    H, hd = _heads(cfg)
    B_, T, d = x.shape
    m = _ddlerp(p, x, xs)

    def to_bh(t):                       # (B, T, H * hd) -> (B, H, T, hd)
        return t.reshape(B_, T, H, hd).transpose(1, 2)

    r = m["r"] @ p["wr"]
    k = m["k"] @ p["wk"]
    v = m["v"] @ p["wv"]
    g = F.silu(m["g"] @ p["wg"])
    w_raw = p["w0"] + torch.tanh(m["w"] @ p["w_lora_a"]) @ p["w_lora_b"]
    log_a = -torch.exp(w_raw.float())
    return to_bh(r), to_bh(k), to_bh(v), to_bh(log_a), g


def _out(p, cfg: ModelConfig, y_bhtd, g):
    """(B, H, T, hd) -> norm -> gate -> (B, T, d) projection."""
    H, hd = _heads(cfg)
    B_, _, T, _ = y_bhtd.shape
    y = y_bhtd.transpose(1, 2).reshape(B_, T, H * hd)
    y = rmsnorm(p["ln_x"], y, cfg.rms_eps)
    return (y * g) @ p["wo"]


def time_mix_fwd(p, cfg: ModelConfig, x, prev, *, state=None,
                 chunk: int = cs.DEFAULT_CHUNK):
    r, k, v, log_a, g = _time_mix_qkvw(p, cfg, x, _token_shift(x, prev))
    y, S = cs.chunked_decay_scan(r, k, v, log_a, u=p["u"], init_state=state,
                                 chunk=chunk, bonus_mode=True)
    return _out(p, cfg, y, g), S


def channel_mix_fwd(p, cfg: ModelConfig, x, prev):
    xs = _token_shift(x, prev)
    xk = x + (xs - x) * p["cm_mu_k"]
    xr = x + (xs - x) * p["cm_mu_r"]
    k = torch.square(F.relu(xk @ p["cm_k"]))
    return torch.sigmoid(xr @ p["cm_r"]) * (k @ p["cm_v"])


def rwkv6_block_fwd(p, cfg: ModelConfig, x, *, tm_prev, cm_prev, state=None,
                    chunk: int = cs.DEFAULT_CHUNK):
    """The pre-LN block: x += TM(LN1(x)); x += CM(LN2(x)).  Returns (out,
    carries); the token-shift carries hold the LAST NORMED token, so decode
    continues exactly."""
    xn = rmsnorm(p["ln1"], x, cfg.rms_eps)
    tm, S = time_mix_fwd(p, cfg, xn, tm_prev, state=state, chunk=chunk)
    h = x + tm
    hn = rmsnorm(p["ln2"], h, cfg.rms_eps)
    cm = channel_mix_fwd(p, cfg, hn, cm_prev)
    carries = {"tm_prev": xn[:, -1:, :], "cm_prev": hn[:, -1:, :],
               "state": S}
    return h + cm, carries


def init_rwkv6_cache(cfg: ModelConfig, batch: int, dtype, *, device="cuda",
                     lead: tuple = ()):
    H, hd = _heads(cfg)
    return {
        "tm_prev": torch.zeros((*lead, batch, 1, cfg.d_model), dtype=dtype,
                               device=device),
        "cm_prev": torch.zeros((*lead, batch, 1, cfg.d_model), dtype=dtype,
                               device=device),
        "state": torch.zeros((*lead, batch, H, hd, hd), dtype=torch.float32,
                             device=device),
    }


def rwkv6_block_decode(p, cfg: ModelConfig, x, cache):
    """One-token step, the same arithmetic through ``decay_scan_step``.
    Returns (out, new carries), new tensors."""
    xn = rmsnorm(p["ln1"], x, cfg.rms_eps)
    r, k, v, log_a, g = _time_mix_qkvw(p, cfg, xn, cache["tm_prev"])
    y, S = cs.decay_scan_step(r[:, :, 0], k[:, :, 0], v[:, :, 0],
                              log_a[:, :, 0], cache["state"], u=p["u"],
                              bonus_mode=True)
    tm = _out(p, cfg, y[:, :, None, :], g)
    h = x + tm
    hn = rmsnorm(p["ln2"], h, cfg.rms_eps)
    cm = channel_mix_fwd(p, cfg, hn, cache["cm_prev"])
    return h + cm, {"tm_prev": xn, "cm_prev": hn, "state": S}
