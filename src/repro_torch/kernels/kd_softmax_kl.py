"""Fused temperature-softmax KL + CE distillation loss: the CUDA kernels'
wrappers and their plain PyTorch versions.

Replaces the Pallas TPU kernels ``src/repro/kernels/kd_softmax_kl.py::
_fwd_kernel`` (via ``kd_loss_fwd``) and ``::_bwd_kernel`` (via
``kd_loss_bwd``); the CUDA sources are ``csrc/kd_softmax_kl.cu``.

Per token the objective is
    ((1-alpha) CE(s, y) + alpha tau^2 KL(softmax(t/tau) || softmax(s/tau))) * [y >= 0]
and the forward also returns the per-row stats (logZ_t, logZ_s, logZ_1)
from which the backward recomputes the three softmaxes.

Bound on the H100: bytes (each logit read once; a handful of exponentials
per element).  At the main path's (64, 10) rows x classes a call moves
about 6 KB, so its cost is the launch.  The first design is one warp per
row with register-resident online softmax state (see the ``.cu`` note);
``chip_smoke.py`` times it beside this bound.

Dispatch: a tensor on the CPU goes to the plain version below; a CUDA
tensor goes to the kernel, or the wrapper raises.  ``launches`` on each
wrapper counts kernel launches (never plain calls).
"""
from __future__ import annotations

import torch

from repro_torch.kernels import _build


# ------------------------------------------------------------ plain versions
def kd_loss_fwd_plain(s, t, y, *, tau: float, alpha: float):
    """(T, V), (T, V), (T,) -> per-token loss (T,) f32, stats (T, 3) f32."""
    sf, tf = s.float(), t.float()
    V = sf.shape[-1]
    logz_t = torch.logsumexp(tf / tau, dim=-1)
    logz_s = torch.logsumexp(sf / tau, dim=-1)
    logz_1 = torch.logsumexp(sf, dim=-1)
    p_t = torch.exp(tf / tau - logz_t[:, None])
    kl = (p_t * ((tf - sf) / tau)).sum(-1) + logz_s - logz_t
    y = y.long()
    hit = (y >= 0) & (y < V)
    picked = torch.where(
        hit, sf.gather(1, y.clamp(0, V - 1)[:, None])[:, 0],
        torch.zeros((), dtype=sf.dtype, device=sf.device))
    ce = logz_1 - picked
    valid = (y >= 0).float()
    loss = ((1.0 - alpha) * ce + alpha * tau * tau * kl) * valid
    return loss, torch.stack([logz_t, logz_s, logz_1], dim=-1)


def kd_loss_bwd_plain(s, t, y, stats, g, *, tau: float, alpha: float):
    """d loss / d s for every row (scaled by the per-row ``g``), in s's dtype."""
    sf, tf = s.float(), t.float()
    V = sf.shape[-1]
    p1 = torch.exp(sf - stats[:, 2:3])
    ps = torch.exp(sf / tau - stats[:, 1:2])
    pt = torch.exp(tf / tau - stats[:, 0:1])
    y = y.long()
    onehot = (torch.arange(V, device=sf.device)[None, :] == y[:, None]).float()
    valid = (y >= 0).float()[:, None]
    ds = (1.0 - alpha) * (p1 - onehot) + (alpha * tau) * (ps - pt)
    return (g.float()[:, None] * ds * valid).to(s.dtype)


# ------------------------------------------------------------------ wrappers
def _check(s, t, y, what):
    if s.dim() != 2 or s.shape != t.shape:
        raise ValueError(f"{what}: student/teacher logits must both be (T, V), "
                         f"got {tuple(s.shape)} and {tuple(t.shape)}")
    if s.dtype != t.dtype:
        raise TypeError(f"{what}: logit dtypes differ ({s.dtype}, {t.dtype})")
    if y.shape != s.shape[:1]:
        raise ValueError(f"{what}: labels {tuple(y.shape)} != ({s.shape[0]},)")
    if y.dtype not in (torch.int32, torch.int64):
        raise TypeError(f"{what}: labels must be int32/int64, got {y.dtype}")
    if not (s.device == t.device == y.device):
        raise ValueError(f"{what}: tensors on different devices")
    if s.device.type not in ("cpu", "cuda"):
        raise ValueError(f"{what}: no kernel or plain path for {s.device}")


def _require_contiguous(what, **tensors):
    for name, x in tensors.items():
        if not x.is_contiguous():
            raise ValueError(f"{what}: {name} must be contiguous")


def kd_loss_fwd(s, t, y, *, tau: float = 2.0, alpha: float = 0.5):
    """Per-token fused distillation loss: ``(T, V), (T, V), (T,) ->
    ((T,) f32 loss, (T, 3) f32 stats)``.  Labels < 0 give zero loss."""
    _check(s, t, y, "kd_loss_fwd")
    if s.device.type == "cpu":
        return kd_loss_fwd_plain(s, t, y, tau=tau, alpha=alpha)
    _require_contiguous("kd_loss_fwd", s=s, t=t)
    code = _build.dtype_code(s, "kd_loss_fwd")
    T, V = s.shape
    if T == 0 or V == 0:
        raise ValueError(f"kd_loss_fwd: empty logits {tuple(s.shape)}")
    y32 = y.to(torch.int32).contiguous()
    loss = torch.empty(T, dtype=torch.float32, device=s.device)
    stats = torch.empty((T, 3), dtype=torch.float32, device=s.device)
    lib = _build.library()
    with torch.cuda.device(s.device):
        err = lib.fedsikd_kd_fwd(
            s.data_ptr(), t.data_ptr(), y32.data_ptr(), loss.data_ptr(),
            stats.data_ptr(), T, V, code, float(tau), float(alpha),
            _build.stream_handle(s))
    _build.check(err, "kd_loss_fwd")
    kd_loss_fwd.launches += 1
    return loss, stats


def kd_loss_bwd(s, t, y, stats, g, *, tau: float = 2.0, alpha: float = 0.5):
    """``ds = g[row] * d loss_row / d s`` for every row, in s's dtype.
    ``stats`` is the forward's (T, 3) output and ``g`` a (T,) f32 vector."""
    _check(s, t, y, "kd_loss_bwd")
    T, V = s.shape
    if stats.shape != (T, 3) or g.shape != (T,):
        raise ValueError(f"kd_loss_bwd: stats {tuple(stats.shape)} / g "
                         f"{tuple(g.shape)} do not match T={T}")
    if s.device.type == "cpu":
        return kd_loss_bwd_plain(s, t, y, stats, g, tau=tau, alpha=alpha)
    if stats.dtype != torch.float32 or g.dtype != torch.float32:
        raise TypeError("kd_loss_bwd: stats and g must be float32")
    _require_contiguous("kd_loss_bwd", s=s, t=t, stats=stats, g=g)
    code = _build.dtype_code(s, "kd_loss_bwd")
    if T == 0 or V == 0:
        raise ValueError(f"kd_loss_bwd: empty logits {tuple(s.shape)}")
    y32 = y.to(torch.int32).contiguous()
    ds = torch.empty_like(s)
    lib = _build.library()
    with torch.cuda.device(s.device):
        err = lib.fedsikd_kd_bwd(
            s.data_ptr(), t.data_ptr(), y32.data_ptr(), stats.data_ptr(),
            g.data_ptr(), ds.data_ptr(), T, V, code, float(tau), float(alpha),
            _build.stream_handle(s))
    _build.check(err, "kd_loss_bwd")
    kd_loss_bwd.launches += 1
    return ds


kd_loss_fwd.launches = 0
kd_loss_bwd.launches = 0
