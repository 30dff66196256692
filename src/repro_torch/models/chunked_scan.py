"""Chunk-parallel decayed linear-attention scan, the shared compute core of
Mamba2 (SSD) and RWKV6 (Finch): the port of ``repro.models.chunked_scan``.

Recurrence (per batch, head):
    S_t = diag(a_t) S_{t-1} + k_t (x) v_t          S in R^{dk x dv}
    y_t = q_t . S_t                                (mamba convention), or
    y_t = q_t . (S_{t-1} + diag(u) k_t (x) v_t)    (rwkv bonus convention)

The chunked form, as in JAX: within a chunk of ``chunk`` steps the terms
are masked (c x c) products, and the state flows from chunk to chunk.  The
decay enters separably: score_ij = (q_i e^{L_i}) . (k_j e^{-L_j}) with L
the inclusive cumulative log-decay (exclusive for the query in the bonus
convention, whose triangle is strict).  The per-step log-decay is clamped
at LOG_DECAY_FLOOR to keep e^{-L_j} inside float32, in the chunked and in
the one-step recurrence alike, so the two agree.  The state is carried in
float32.

JAX's ``lax.scan`` over chunks is a Python loop here.  What does not read
the carried state (the intra-chunk scores and their product with V, the
bonus, each chunk's decayed outer products ``k_rem^T v``) is computed for
all chunks at once before the loop; the loop keeps the two steps that read
the state: the carried state's contribution ``q_dec @ S`` and the state
update ``S e^{L_end} + k_rem^T v``.
"""
from __future__ import annotations

from typing import Optional

import torch
import torch.nn.functional as F

LOG_DECAY_FLOOR = -2.0
DEFAULT_CHUNK = 32


def clamp_log_decay(log_a: torch.Tensor) -> torch.Tensor:
    return torch.clamp(log_a, LOG_DECAY_FLOOR, 0.0)


def chunked_decay_scan(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                       log_a: torch.Tensor, *,
                       u: Optional[torch.Tensor] = None,
                       init_state: Optional[torch.Tensor] = None,
                       chunk: int = DEFAULT_CHUNK, bonus_mode: bool = False):
    """q, k: (B, H, T, dk); v: (B, H, T, dv); log_a: (B, H, T, dk) or (B,
    H, T, 1), the log decay in [-inf, 0]; u: (H, dk), the RWKV bonus
    (required with ``bonus_mode``); init_state: (B, H, dk, dv).  Returns (y
    (B, H, T, dv) in v's dtype, final state (B, H, dk, dv) in float32).

    T need not divide by ``chunk``: q, k, v pad with zeros (a zero k adds
    nothing to the state) and log_a with 0 (decay 1, so the final state is
    untouched), and the padded rows of y are sliced off."""
    B, H, T, dk = q.shape
    dv = v.shape[-1]
    orig_T = T
    if T % chunk:
        pad = chunk - T % chunk
        q, k, v, log_a = (F.pad(t, (0, 0, 0, pad)) for t in (q, k, v, log_a))
        T += pad
    n = T // chunk
    la = clamp_log_decay(log_a.float())
    if la.shape[-1] == 1:
        la = la.expand(B, H, T, dk)

    def chunks(t, width):                       # (n, B, H, c, width)
        return t.float().reshape(B, H, n, chunk, width).permute(2, 0, 1, 3, 4)

    qf, kf, laf = chunks(q, dk), chunks(k, dk), chunks(la, dk)
    vf = chunks(v, dv)
    L = torch.cumsum(laf, dim=-2)               # inclusive cum log-decay
    if bonus_mode:
        if u is None:
            raise ValueError("bonus_mode needs the bonus u")
        q_dec = qf * torch.exp(L - laf)         # q_i e^{L'_i}, exclusive
        tri = torch.tril(torch.ones((chunk, chunk), dtype=torch.bool,
                                    device=q.device), diagonal=-1)
    else:
        q_dec = qf * torch.exp(L)
        tri = torch.tril(torch.ones((chunk, chunk), dtype=torch.bool,
                                    device=q.device))
    k_dec = kf * torch.exp(-L)                  # k_j e^{-L_j}
    k_rem = kf * torch.exp(L[..., -1:, :] - L)  # decay to the chunk's end

    # the state-free terms of every chunk at once
    scores = torch.einsum("nbhik,nbhjk->nbhij", q_dec, k_dec)
    scores = scores.masked_fill(~tri, 0.0)
    intra = torch.einsum("nbhij,nbhjv->nbhiv", scores, vf)
    if bonus_mode:
        bonus = torch.einsum("nbhck,nbhck->nbhc",
                             qf * u.float()[None, None, :, None, :], kf)
    outer = torch.einsum("nbhck,nbhcv->nbhkv", k_rem, vf)
    decay_end = torch.exp(L[..., -1, :])[..., None]          # (n,B,H,dk,1)

    S = (torch.zeros((B, H, dk, dv), dtype=torch.float32, device=q.device)
         if init_state is None else init_state.float())
    inter = []
    for c in range(n):
        inter.append(q_dec[c] @ S)              # the carried state's term
        S = S * decay_end[c] + outer[c]
    y = torch.stack(inter) + intra
    if bonus_mode:
        y = y + bonus[..., None] * vf
    y = y.permute(1, 2, 0, 3, 4).reshape(B, H, T, dv)[:, :, :orig_T]
    return y.to(v.dtype), S


def decay_scan_step(q, k, v, log_a, state, *, u=None,
                    bonus_mode: bool = False):
    """One step of the recurrence, for decode; the same arithmetic as the
    chunked path.  q, k: (B, H, dk); v: (B, H, dv); log_a: (B, H, dk) or
    (B, H, 1); state: (B, H, dk, dv).  Returns (y (B, H, dv) in v's dtype,
    new state in the state's dtype)."""
    a = torch.exp(clamp_log_decay(log_a.float()))
    if a.shape[-1] == 1:
        a = a.expand(q.shape)
    kv = torch.einsum("bhk,bhv->bhkv", k.float(), v.float())
    sf = state.float()
    if bonus_mode:
        eff = sf + u.float()[None, :, :, None] * kv
        y = torch.einsum("bhk,bhkv->bhv", q.float(), eff)
        new = a[..., None] * sf + kv
    else:
        new = a[..., None] * sf + kv
        y = torch.einsum("bhk,bhkv->bhv", q.float(), new)
    return y.to(v.dtype), new.to(state.dtype)


def reference_scan(q, k, v, log_a, *, u=None, init_state=None,
                   bonus_mode: bool = False):
    """The O(T) sequential oracle, for tests: ``decay_scan_step`` over
    every position."""
    B, H, T, dk = q.shape
    dv = v.shape[-1]
    S = (torch.zeros((B, H, dk, dv), dtype=torch.float32, device=q.device)
         if init_state is None else init_state.float())
    la = clamp_log_decay(log_a.float())
    if la.shape[-1] == 1:
        la = la.expand(q.shape)
    ys = []
    for t in range(T):
        y, S = decay_scan_step(q[:, :, t], k[:, :, t], v[:, :, t],
                               la[:, :, t], S, u=u, bonus_mode=bonus_mode)
        ys.append(y)
    return torch.stack(ys, dim=2).to(v.dtype), S
