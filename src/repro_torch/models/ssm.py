"""Mamba2 (SSD) block, zamba2's backbone: the port of ``repro.models.ssm``.

State-space recurrence per head: h_t = exp(A dt_t) h_{t-1} + dt_t B_t (x)
x_t, y_t = C_t . h_t + D x_t, computed with the chunk-parallel scan of
``chunked_scan`` (q = C, k = B, v = dt x, a scalar log-decay per head).
Params as in JAX: ``in_proj`` (d, 2 d_in + 2 state + heads), the depthwise
``conv_w`` (K, d_in + 2 state) and ``conv_b``, ``dt_bias``, ``A_log`` and
``D`` in float32, the gated ``norm`` and ``out_proj`` (d_in, d); ``lead``
prepends the stack axes, as in ``layers``.
"""
from __future__ import annotations

import torch
import torch.nn.functional as F

from repro_torch.configs.base import ModelConfig
from repro_torch.models import chunked_scan as cs
from repro_torch.models.layers import _dtype, dense_init, init_rmsnorm, rmsnorm


def _dims(cfg: ModelConfig):
    d_in = cfg.ssm_expand * cfg.d_model
    heads = cfg.ssm_heads or max(1, d_in // 64)
    head_p = d_in // heads
    return d_in, heads, head_p, cfg.ssm_state


def init_mamba2(gen: torch.Generator, cfg: ModelConfig, *, lead: tuple = ()):
    d = cfg.d_model
    d_in, heads, head_p, state = _dims(cfg)
    conv_dim = d_in + 2 * state
    dt = _dtype(cfg)
    dev = gen.device
    return {
        "in_proj": dense_init(gen, (*lead, d, 2 * d_in + 2 * state + heads),
                              dt),
        "conv_w": dense_init(gen, (*lead, cfg.conv_kernel, conv_dim), dt,
                             scale=0.5),
        "conv_b": torch.zeros((*lead, conv_dim), dtype=dt, device=dev),
        "dt_bias": torch.zeros((*lead, heads), dtype=torch.float32,
                               device=dev),
        "A_log": torch.zeros((*lead, heads), dtype=torch.float32,
                             device=dev),                  # A = -exp(A_log)
        "D": torch.ones((*lead, heads), dtype=torch.float32, device=dev),
        "norm": init_rmsnorm(d_in, dt, device=dev, lead=lead),
        "out_proj": dense_init(gen, (*lead, d_in, d), dt),
    }


def _split(p, cfg: ModelConfig, x):
    d_in, heads, head_p, state = _dims(cfg)
    zxd = x @ p["in_proj"]
    return (zxd[..., :d_in], zxd[..., d_in:2 * d_in + 2 * state],
            zxd[..., 2 * d_in + 2 * state:])


def _causal_conv(p, cfg: ModelConfig, xbc):
    """Depthwise causal conv, kernel K: y_t = sum_k w_k x_{t-K+1+k}."""
    K = cfg.conv_kernel
    T = xbc.shape[1]
    pad = F.pad(xbc, (0, 0, K - 1, 0))
    out = sum(pad[:, k:k + T, :] * p["conv_w"][k] for k in range(K))
    return F.silu(out + p["conv_b"])


def _ssd_inputs(p, cfg: ModelConfig, xbc_conv, dt_raw):
    """The scan's (q, k, v, log_a), each (B, H, T, *), and x by head (B, T,
    H, hp).  v = dt x is rounded to the input's dtype, as in JAX."""
    d_in, heads, head_p, state = _dims(cfg)
    B_, T = xbc_conv.shape[0], xbc_conv.shape[1]
    xs = xbc_conv[..., :d_in]
    Bmat = xbc_conv[..., d_in:d_in + state]
    Cmat = xbc_conv[..., d_in + state:]
    dt = F.softplus(dt_raw.float() + p["dt_bias"])                # (B,T,H)
    log_a = (-dt * torch.exp(p["A_log"]))[..., None]              # (B,T,H,1)
    xh = xs.reshape(B_, T, heads, head_p)
    v = (xh.float() * dt[..., None]).to(xs.dtype)
    # B and C shared across heads (ngroups = 1)
    k = Bmat[:, :, None, :].expand(B_, T, heads, state)
    q = Cmat[:, :, None, :].expand(B_, T, heads, state)
    return (q.transpose(1, 2), k.transpose(1, 2), v.transpose(1, 2),
            log_a.transpose(1, 2), xh)


def _gated_out(p, cfg: ModelConfig, y_bhtp, xh, z, x):
    """(B, H, T, hp) scan output + D x, gated norm, out_proj -> (B, T, d)."""
    d_in = _dims(cfg)[0]
    y = y_bhtp.transpose(1, 2)                                    # (B,T,H,hp)
    y = y + p["D"][None, None, :, None] * xh.float()
    y = y.reshape(x.shape[0], x.shape[1], d_in).to(x.dtype)
    y = rmsnorm(p["norm"], y * F.silu(z), cfg.rms_eps)
    return y @ p["out_proj"]


def mamba2_fwd(p, cfg: ModelConfig, x, *, chunk: int = cs.DEFAULT_CHUNK):
    """x: (B, T, d) -> (out (B, T, d), cache), the cache in
    ``init_mamba2_cache``'s layout (the prefill -> decode handoff): the
    last K - 1 raw conv inputs (left-padded with zeros when T < K - 1) and
    the final SSM state."""
    K = cfg.conv_kernel
    z, xbc_raw, dt_raw = _split(p, cfg, x)
    xbc = _causal_conv(p, cfg, xbc_raw)
    q, k, v, log_a, xh = _ssd_inputs(p, cfg, xbc, dt_raw)
    y, S = cs.chunked_decay_scan(q, k, v, log_a, chunk=chunk)
    pad = max(K - 1 - xbc_raw.shape[1], 0)
    tail = F.pad(xbc_raw, (0, 0, pad, 0))[:, -(K - 1):]
    return _gated_out(p, cfg, y, xh, z, x), {"conv": tail, "ssm": S}


def init_mamba2_cache(cfg: ModelConfig, batch: int, dtype, *,
                      device="cuda", lead: tuple = ()):
    d_in, heads, head_p, state = _dims(cfg)
    conv_dim = d_in + 2 * state
    return {
        "conv": torch.zeros((*lead, batch, cfg.conv_kernel - 1, conv_dim),
                            dtype=dtype, device=device),
        "ssm": torch.zeros((*lead, batch, heads, state, head_p),
                           dtype=torch.float32, device=device),
    }


def mamba2_decode(p, cfg: ModelConfig, x, cache):
    """One-token step.  x: (B, 1, d).  Returns (out (B, 1, d), new cache):
    the rolled conv buffer and the stepped state, new tensors (the caller
    writes them into its stacked cache)."""
    z, xbc, dt_raw = _split(p, cfg, x)
    hist = torch.cat([cache["conv"], xbc], dim=1)                 # (B,K,conv)
    conv_out = torch.einsum("bkc,kc->bc", hist, p["conv_w"]) + p["conv_b"]
    xbc1 = F.silu(conv_out)[:, None, :]
    q, k, v, log_a, xh = _ssd_inputs(p, cfg, xbc1, dt_raw)
    y, S = cs.decay_scan_step(q[:, :, 0], k[:, :, 0], v[:, :, 0],
                              log_a[:, :, 0], cache["ssm"])       # (B,H,hp)
    out = _gated_out(p, cfg, y[:, :, None, :], xh, z, x)
    return out, {"conv": hist[:, 1:, :], "ssm": S}
