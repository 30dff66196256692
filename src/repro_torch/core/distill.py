"""Knowledge-distillation losses (paper §IV-C): the port of
``repro.core.distill``.

Student objective  =  CE(student(x), y)
                    + alpha * tau^2 * KL( softmax(T(x)/tau) || softmax(S(x)/tau) )

Positions with label < 0 are padding and count in neither term — the same
contract as the fused kernel (``kernels.ops.kd_distillation_loss``).
"""
from __future__ import annotations

import torch


def softmax_cross_entropy(logits, labels):
    """Mean CE over valid (label >= 0) positions; labels == -1 are padding."""
    logz = torch.logsumexp(logits, dim=-1)
    picked = torch.gather(logits, -1,
                          labels.long().clamp(min=0)[..., None])[..., 0]
    ce = logz - picked
    mask = (labels >= 0).to(logits.dtype)
    return torch.sum(ce * mask) / torch.clamp(mask.sum(), min=1.0)


def masked_mean(x, mask):
    mask = mask.to(x.dtype)
    return torch.sum(x * mask) / torch.clamp(mask.sum(), min=1.0)


def kl_teacher_student(teacher_logits, student_logits, *,
                       temperature: float = 2.0, mask=None):
    """tau^2 * KL(p_T || p_S) with temperature-softened distributions; mean
    over leading axes, or over the ``mask``-kept positions."""
    t = teacher_logits / temperature
    s = student_logits / temperature
    p_t = torch.softmax(t, dim=-1)
    kl = torch.sum(p_t * (torch.log_softmax(t, -1) - torch.log_softmax(s, -1)),
                   dim=-1)
    if mask is None:
        return (temperature ** 2) * kl.mean()
    return (temperature ** 2) * masked_mean(kl, mask)


def distillation_loss(student_logits, teacher_logits, labels, *,
                      temperature: float = 2.0, alpha: float = 0.5):
    """Combined student loss of §IV-C.4.  Returns (loss, aux dict)."""
    ce = softmax_cross_entropy(student_logits, labels)
    kl = kl_teacher_student(teacher_logits, student_logits,
                            temperature=temperature, mask=labels >= 0)
    loss = (1.0 - alpha) * ce + alpha * kl
    return loss, {"ce": ce, "kl": kl}
