"""Plain-torch oracles for the port's kernels: the counterparts of
``repro.kernels.ref.kd_loss_ref``, ``fused_merge_ref`` and
``kmeans_assign_ref``, written in the same formulation (log-softmax KL, one
weighted contraction, the distance expansion) so the tests hold both
packages to one definition."""
from __future__ import annotations

import torch


def kd_loss_ref(student_logits, teacher_logits, labels, *, tau: float = 2.0,
                alpha: float = 0.5):
    """Per-token (1-a)*CE + a*tau^2*KL(p_T||p_S); labels<0 -> 0."""
    s = student_logits.float()
    t = teacher_logits.float()
    log_ps = torch.log_softmax(s / tau, dim=-1)
    log_pt = torch.log_softmax(t / tau, dim=-1)
    kl = torch.sum(torch.exp(log_pt) * (log_pt - log_ps), dim=-1)
    logz1 = torch.logsumexp(s, dim=-1)
    picked = torch.gather(s, -1, labels.long().clamp(min=0)[:, None])[:, 0]
    ce = logz1 - picked
    valid = (labels >= 0).float()
    return ((1.0 - alpha) * ce + alpha * tau * tau * kl) * valid


def fused_merge_ref(stacked, weights, staleness=None, *, decay: float = 0.0):
    """stacked: (N, D); weights: (N,); staleness: (N,) or None -> (D,) f32
    weighted mean under staleness-decayed, renormalised weights."""
    x = stacked.float()
    w = torch.as_tensor(weights, dtype=torch.float32, device=x.device)
    if staleness is not None:
        s = torch.as_tensor(staleness, dtype=torch.float32, device=x.device)
        w = w * (1.0 + s) ** (-decay)
    w = w / w.sum()
    return torch.einsum("n,nd->d", w, x)


def kmeans_assign_ref(x, cents):
    """x: (N,F); cents: (K,F) -> (assignments (N,) int32, sq dists (N,))."""
    x = x.float()
    c = cents.float()
    d = (torch.sum(x * x, -1, keepdim=True) + torch.sum(c * c, -1)[None]
         - 2.0 * x @ c.T)
    d = torch.clamp(d, min=0.0)
    a = torch.argmin(d, dim=-1).to(torch.int32)
    return a, torch.gather(d, -1, a.long()[:, None])[:, 0]
