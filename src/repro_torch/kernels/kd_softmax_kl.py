"""Fused temperature-softmax KL + CE distillation loss: the CUDA kernels'
wrappers, their planner and their plain PyTorch versions.

Replaces the Pallas TPU kernels ``src/repro/kernels/kd_softmax_kl.py::
_fwd_kernel`` (via ``kd_loss_fwd``) and ``::_bwd_kernel`` (via
``kd_loss_bwd``); the CUDA sources are ``csrc/kd_softmax_kl.cu``.

Per token the objective is
    ((1-alpha) CE(s, y) + alpha tau^2 KL(softmax(t/tau) || softmax(s/tau))) * [y >= 0]
and the forward also returns the per-row stats (logZ_t, logZ_s, logZ_1)
from which the backward recomputes the three softmaxes.

Bound on the H100: at LLM vocabularies with many rows, bytes (each logit
read once); with few rows, the exponentials of the SMs that hold one row
each; at the packed path's (2560, 10), where a call moves 0.2 MB, its
latency.  Exponentials are base 2 on logits times log2(e)/tau (passed from
here, computed in double), three an element.  ``plan`` picks one of two
shapes of work from (T, V, SM count), one launch a call in each; the CUDA
side derives the thread counts, shared memory and grids from it:

- ``rows`` (V <= ROWS_MAX_V): a block stages ``tile_rows`` R rows of s and
  t in shared memory with 16-byte copies; ``lanes`` L threads own a row in
  the forward, each at most ROW_LANE_ELEMS elements (up to V = 128), else
  CHUNK.  The backward reads and writes the same tile as one run of
  16-byte vectors, a vector a thread.  R spreads T over the SMs (20 at the
  path's 2,560 rows: 128 blocks), at most ROWS_THREADS / L.
- ``stream`` (V > ROWS_MAX_V, any T): a block a row, 16-byte loads, CHUNK
  elements a thread in flight; the backward a (row, chunk of vectors)
  grid.  With fewer rows than SMs most SMs idle: a regime that splits a
  row over several SMs waits for a caller that gives such shapes.

Dispatch: a tensor on the CPU goes to the plain version below; a CUDA
tensor goes to the kernel, or the wrapper raises.  ``launches`` on each
wrapper counts kernel launches (never plain calls), ``variant_launches``
the same launches by regime.
"""
from __future__ import annotations

import contextlib
import functools
import math

import torch

from repro_torch.kernels import _build

VARIANTS = ("rows", "stream")
# csrc/kd_softmax_kl.cu: elements a chunk update takes; the rows regime's
# elements a lane of the forward (up to V = 4 x 32, then CHUNK), its
# largest V (32 lanes x CHUNK) and its most threads (R x L) a block
CHUNK = 16
ROW_LANE_ELEMS = 4
ROWS_MAX_V = 512
ROWS_THREADS = 256
H100_SMS = 132
LOG2E = math.log2(math.e)


def _pow2_at_least(n: int) -> int:
    return 1 << max(0, (n - 1).bit_length())


def plan(T: int, V: int, sms: int = H100_SMS) -> dict:
    """The kernels' shape of work for (T, V) logits on a card of ``sms``
    SMs (see the module note for the cut-offs): the ``regime``, and for
    ``rows`` the ``tile_rows`` R a block and ``lanes`` L a row (1 and 1
    for ``stream``)."""
    if V > ROWS_MAX_V:
        return {"regime": "stream", "tile_rows": 1, "lanes": 1}
    lanes = _pow2_at_least(-(-V // ROW_LANE_ELEMS))
    if lanes > 32:
        lanes = _pow2_at_least(-(-V // CHUNK))
    R = max(1, min(ROWS_THREADS // lanes, -(-T // sms)))
    return {"regime": "rows", "tile_rows": R, "lanes": lanes}


@functools.lru_cache(maxsize=256)
def _launch_plan(T: int, V: int, device_index: int):
    """``plan`` on this card, kept per shape: (regime, its index, R, L) as
    the C entry points take them."""
    p = plan(T, V, torch.cuda.get_device_properties(
        device_index).multi_processor_count)
    return (p["regime"], VARIANTS.index(p["regime"]), p["tile_rows"],
            p["lanes"])


def _on(device):
    """``torch.cuda.device(device)`` only when it is not already current."""
    if device.index == torch.cuda.current_device():
        return contextlib.nullcontext()
    return torch.cuda.device(device)


def _labels32(y):
    return y if y.dtype == torch.int32 and y.is_contiguous() else \
        y.to(torch.int32).contiguous()


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


def _check_card(what, x, tau, **tensors):
    """What the kernels take beyond ``_check``: contiguous tensors, a
    supported dtype (its code returned), non-empty logits, tau > 0."""
    for name, tensor in tensors.items():
        if not tensor.is_contiguous():
            raise ValueError(f"{what}: {name} must be contiguous")
    code = _build.dtype_code(x, what)
    if x.shape[0] == 0 or x.shape[1] == 0:
        raise ValueError(f"{what}: empty logits {tuple(x.shape)}")
    if not tau > 0:
        raise ValueError(f"{what}: the kernels take tau > 0, got {tau}")
    return code


def kd_loss_fwd(s, t, y, *, tau: float = 2.0, alpha: float = 0.5):
    """Per-token fused distillation loss: ``(T, V), (T, V), (T,) ->
    ((T,) f32 loss, (T, 3) f32 stats)``.  Labels < 0 give zero loss."""
    _check(s, t, y, "kd_loss_fwd")
    if s.device.type == "cpu":
        return kd_loss_fwd_plain(s, t, y, tau=tau, alpha=alpha)
    code = _check_card("kd_loss_fwd", s, tau, s=s, t=t)
    T, V = s.shape
    regime, idx, R, L = _launch_plan(T, V, s.device.index)
    vec = int((s.data_ptr() - t.data_ptr()) % 16 == 0)
    y32 = _labels32(y)
    loss = torch.empty(T, dtype=torch.float32, device=s.device)
    stats = torch.empty((T, 3), dtype=torch.float32, device=s.device)
    lib = _build.library()
    with _on(s.device):
        err = lib.fedsikd_kd_fwd(
            s.data_ptr(), t.data_ptr(), y32.data_ptr(), loss.data_ptr(),
            stats.data_ptr(), T, V, code, float(tau), float(alpha),
            LOG2E / tau, 1.0 / tau, idx, R, L, vec, _build.stream_handle(s))
    _build.check(err, f"kd_loss_fwd ({regime})")
    kd_loss_fwd.launches += 1
    kd_loss_fwd.variant_launches[regime] += 1
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
    code = _check_card("kd_loss_bwd", s, tau, s=s, t=t, stats=stats, g=g)
    regime, idx, R, _ = _launch_plan(T, V, s.device.index)
    y32 = _labels32(y)
    ds = torch.empty_like(s)
    vec = int((s.data_ptr() - t.data_ptr()) % 16 == 0
              and (s.data_ptr() - ds.data_ptr()) % 16 == 0)
    lib = _build.library()
    with _on(s.device):
        err = lib.fedsikd_kd_bwd(
            s.data_ptr(), t.data_ptr(), y32.data_ptr(), stats.data_ptr(),
            g.data_ptr(), ds.data_ptr(), T, V, code, float(tau), float(alpha),
            LOG2E / tau, idx, R, vec, _build.stream_handle(s))
    _build.check(err, f"kd_loss_bwd ({regime})")
    kd_loss_bwd.launches += 1
    kd_loss_bwd.variant_launches[regime] += 1
    return ds


kd_loss_fwd.launches = 0
kd_loss_bwd.launches = 0
kd_loss_fwd.variant_launches = dict.fromkeys(VARIANTS, 0)
kd_loss_bwd.variant_launches = dict.fromkeys(VARIANTS, 0)
