"""Public entry points over the port's kernels: the contracts of
``repro.kernels.ops`` for the KD loss, the fused merge, the k-means
assignment and flash attention.

- ``kd_distillation_loss`` is a ``torch.autograd.Function`` pairing the
  forward kernel with the analytic backward kernel (the port's form of the
  JAX ``custom_vjp``).  Leading axes are flattened into rows; label -1 marks
  an ignored token; the result is the mean over valid tokens; the teacher
  gets no gradient.
- ``kd_distillation_loss_lanes`` is the packed engine's form: (S, B, V)
  logits of S independent client lanes in, the (S,) per-lane means out, in
  one forward and one backward launch for all lanes (the JAX engine calls
  the fused loss per lane inside ``vmap``).
- ``fused_merge`` takes an ``(N, ...)`` stack of one model leaf and returns
  the ``(...)`` float32 decayed weighted mean; ``fused_merge_leaves`` merges
  every leaf of N clients' parameter lists in one launch, unstacked.
- ``kmeans_assign`` is the nearest-centroid step of k-means.
- ``flash_attention`` is grouped-query attention with the right-aligned
  causal mask, in the layer layout.

The kernels mask their own ragged edges, so nothing is padded here.  A
tensor on the CPU runs each kernel's plain version; a CUDA tensor runs the
kernel (``kernels/kd_softmax_kl.py``, ``kernels/fused_merge.py``,
``kernels/kmeans_assign.py``, ``kernels/flash_attention.py``).
"""
from __future__ import annotations

import torch

from repro_torch.kernels import flash_attention as _fa
from repro_torch.kernels import fused_merge as _fm
from repro_torch.kernels import kd_softmax_kl as _kd
from repro_torch.kernels import kmeans_assign as _km


class _KDLoss(torch.autograd.Function):
    @staticmethod
    def forward(ctx, s, t, y, tau, alpha):
        V = s.shape[-1]
        sf = s.reshape(-1, V).contiguous()
        tf = t.reshape(-1, V).contiguous()
        yf = y.reshape(-1)
        per_tok, stats = _kd.kd_loss_fwd(sf, tf, yf, tau=tau, alpha=alpha)
        denom = torch.clamp((yf >= 0).sum().to(torch.float32), min=1.0)
        ctx.save_for_backward(sf, tf, yf, stats, denom)
        ctx.shape, ctx.tau, ctx.alpha = s.shape, tau, alpha
        return per_tok.sum() / denom

    @staticmethod
    def backward(ctx, g):
        sf, tf, yf, stats, denom = ctx.saved_tensors
        gf = (g.to(torch.float32) / denom).expand(sf.shape[0]).contiguous()
        ds = _kd.kd_loss_bwd(sf, tf, yf, stats, gf, tau=ctx.tau,
                             alpha=ctx.alpha)
        return ds.reshape(ctx.shape), None, None, None, None


def kd_distillation_loss(student_logits, teacher_logits, labels,
                         tau: float = 2.0, alpha: float = 0.5):
    """Fused FedSiKD distillation loss (mean over tokens with label >= 0).

        loss = (1-alpha) * CE(student, y)
             + alpha * tau^2 * KL(softmax(teacher/tau) || softmax(student/tau))

    student_logits, teacher_logits: (..., V) float32/bfloat16/float16 of one
    shape; labels: (...) int32/int64, -1 = ignore.  Returns a () float32
    scalar, differentiable in ``student_logits`` only."""
    return _KDLoss.apply(student_logits, teacher_logits, labels, float(tau),
                         float(alpha))


def kd_distillation_loss_batched(student_logits, teacher_logits, labels, *,
                                 tau: float = 2.0, alpha: float = 0.5):
    """Keyword form of ``kd_distillation_loss`` for (B, T, V) logits (or any
    (..., V)) with (B, T) labels; checks the shapes first."""
    if student_logits.shape != teacher_logits.shape:
        raise ValueError(
            "student/teacher logit shapes differ: "
            f"{tuple(student_logits.shape)} vs {tuple(teacher_logits.shape)}")
    if labels.shape != student_logits.shape[:-1]:
        raise ValueError(
            f"labels shape {tuple(labels.shape)} != logit leading axes "
            f"{tuple(student_logits.shape[:-1])}")
    return kd_distillation_loss(student_logits, teacher_logits, labels, tau,
                                alpha)


class _KDLossLanes(torch.autograd.Function):
    @staticmethod
    def forward(ctx, s, t, y, tau, alpha):
        S, B, V = s.shape
        sf = s.reshape(S * B, V).contiguous()
        tf = t.reshape(S * B, V).contiguous()
        yf = y.reshape(-1)
        per_tok, stats = _kd.kd_loss_fwd(sf, tf, yf, tau=tau, alpha=alpha)
        valid = torch.clamp((y >= 0).sum(dim=1).to(torch.float32), min=1.0)
        ctx.save_for_backward(sf, tf, yf, stats, valid)
        ctx.shape, ctx.tau, ctx.alpha = s.shape, tau, alpha
        return per_tok.reshape(S, B).sum(dim=1) / valid

    @staticmethod
    def backward(ctx, g):
        sf, tf, yf, stats, valid = ctx.saved_tensors
        S, B, _ = ctx.shape
        grow = (g.to(torch.float32) / valid)[:, None].expand(S, B)
        ds = _kd.kd_loss_bwd(sf, tf, yf, stats, grow.reshape(-1).contiguous(),
                             tau=ctx.tau, alpha=ctx.alpha)
        return ds.reshape(ctx.shape), None, None, None, None


def kd_distillation_loss_lanes(student_logits, teacher_logits, labels, *,
                               tau: float = 2.0, alpha: float = 0.5):
    """Per-lane fused distillation loss of S independent client lanes.

    student_logits, teacher_logits: (S, B, V); labels: (S, B), -1 = ignore.
    Returns (S,) float32: lane ``i``'s mean over its valid rows, the value
    ``kd_distillation_loss`` gives on lane ``i`` alone.  One forward launch
    covers the S*B rows; the backward is one launch with each row's
    upstream gradient ``g[lane] / valid_rows[lane]``."""
    if (student_logits.dim() != 3
            or student_logits.shape != teacher_logits.shape):
        raise ValueError(
            "student/teacher logits must both be (S, B, V), got "
            f"{tuple(student_logits.shape)} and "
            f"{tuple(teacher_logits.shape)}")
    if labels.shape != student_logits.shape[:2]:
        raise ValueError(f"labels shape {tuple(labels.shape)} != "
                         f"{tuple(student_logits.shape[:2])}")
    return _KDLossLanes.apply(student_logits, teacher_logits, labels,
                              float(tau), float(alpha))


def fused_merge(stacked, weights, staleness=None, *, decay: float = 0.0):
    """Grouped weighted mean with staleness decay, in one kernel pass.

    stacked: (N, ...) — N client copies of one model leaf, any float dtype;
    weights: (N,) non-negative base weights (at least one positive);
    staleness: (N,) rounds, or None (all zeros); decay: a in (1 + s)^-a.
    Returns (...) float32: sum_i w_i(1+s_i)^-a x_i / sum_j w_j(1+s_j)^-a
    (callers cast back to the leaf dtype)."""
    N = stacked.shape[0]
    xf = stacked.reshape(N, -1).contiguous()
    w = torch.as_tensor(weights, dtype=torch.float32, device=xf.device)
    s = (torch.zeros(N, dtype=torch.float32, device=xf.device)
         if staleness is None
         else torch.as_tensor(staleness, dtype=torch.float32, device=xf.device))
    out = _fm.fused_merge(xf, w.contiguous(), s.contiguous(),
                          decay=float(decay))
    return out.reshape(stacked.shape[1:])


def fused_merge_leaves(rows, weights, staleness=None, *, decay: float = 0.0):
    """``fused_merge`` of every leaf of N clients at once.

    rows: N sequences of L tensors (client n's leaves in one order; leaf l
    has one shape and dtype across clients); weights, staleness: (N,) host
    values (staleness None = all zeros).  Returns L float32 tensors in the
    leaves' shapes.  On the card, one kernel launch for each dtype among
    the leaves, reading every client's leaf in place."""
    return _fm.fused_merge_leaves(rows, weights, staleness, decay=float(decay))


def kmeans_assign(x, cents):
    """Nearest-centroid assignment (the k-means E-step).

    Contract (``repro.kernels.ops.kmeans_assign``):
      x       : (N, F) float32 points, contiguous.
      cents   : (K, F) float32 centroids, contiguous, K <= 16.
      returns : (assignments (N,) int32, squared distance to the assigned
                centroid (N,) float32).

    Any N is taken as it is (the kernel masks its own ragged edge); ties go
    to the lowest centroid index, as ``kernels.ref.kmeans_assign_ref``."""
    return _km.kmeans_assign(x, cents)


def flash_attention(q, k, v, *, causal: bool = True, window: int = 0):
    """Streaming (flash-style) attention.

    Contract (``repro.kernels.ops.flash_attention``):
      q       : (B, T, H, hd)   layer layout, heads on axis 2.
      k, v    : (B, S, KVH, hd) KVH divides H (grouped-query attention:
                each KV head serves H/KVH query heads).
      returns : (B, T, H, hd), same dtype as ``q``.

    ``causal=True`` applies the RIGHT-ALIGNED causal mask (query i attends
    to keys up to S - T + i), so cross-length decode shapes (T < S) work;
    ``window > 0`` also limits each query to its last ``window`` keys.
    dtype float32 or bfloat16, accumulation in float32.  Unlike the JAX
    wrapper nothing is padded: the kernel masks ragged T and S itself, so
    every pair of lengths is taken (the JAX wrapper refuses causal calls
    whose T and S pad unequally).  k and v may be strided views (a KV
    cache's visible prefix) as long as the hd axis is contiguous."""
    return _fa.flash_attention(q, k, v, causal=causal, window=window)
