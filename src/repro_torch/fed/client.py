"""Client-side training steps for the federated runtime: the port of
``repro.fed.client``.  Plain CE, FedProx proximal, and the FedSiKD
teacher/student distillation step, over dicts of parameter tensors.

A step takes host (numpy) batches, moves them to the parameters' device,
differentiates the loss with ``torch.autograd.grad`` and returns the new
parameter and optimizer dicts plus the (detached, on-device) loss.  The
``key`` argument is the integer seed of the step's random stream (dropout).
"""
from __future__ import annotations

from typing import Callable

import numpy as np
import torch

from repro_torch.core.distill import distillation_loss, softmax_cross_entropy
from repro_torch.kernels import ops
from repro_torch.optim import Optimizer, apply_updates, fedprox_penalty


def _to_device(a, device):
    if isinstance(a, torch.Tensor):
        return a.to(device)
    return torch.from_numpy(np.ascontiguousarray(a)).to(device)


def _device(params) -> torch.device:
    return next(iter(params.values())).device


def _grad_step(loss_fn, opt, params, opt_state):
    p = {k: v.detach().requires_grad_(True) for k, v in params.items()}
    loss = loss_fn(p)
    grads = dict(zip(p, torch.autograd.grad(loss, list(p.values()))))
    updates, opt_state = opt.update(grads, opt_state, params)
    with torch.no_grad():
        new = apply_updates(params, updates)
    return new, opt_state, loss.detach()


def make_steps(fwd: Callable, opt: Optimizer, *, kd_temperature: float = 2.0,
               kd_alpha: float = 0.5, prox_mu: float = 0.0):
    """Returns dict of steps: ce / prox / make_distill / eval."""

    def ce_loss(params, x, y, key):
        return softmax_cross_entropy(fwd(params, x, train=True, key=key), y)

    def ce_step(params, opt_state, batch, key):
        dev = _device(params)
        x, y = _to_device(batch["x"], dev), _to_device(batch["y"], dev)
        return _grad_step(lambda p: ce_loss(p, x, y, key), opt, params,
                          opt_state)

    def prox_step(params, opt_state, batch, key, global_params):
        dev = _device(params)
        x, y = _to_device(batch["x"], dev), _to_device(batch["y"], dev)
        return _grad_step(
            lambda p: ce_loss(p, x, y, key)
            + fedprox_penalty(p, global_params, prox_mu),
            opt, params, opt_state)

    def make_distill_step(teacher_fwd: Callable, *, fused: bool = False):
        """Student step with a (possibly different-architecture) teacher.

        ``fused=True`` swaps the reference loss for the fused KD kernel
        (``kernels.ops.kd_distillation_loss``: identical objective and
        gradient, one forward and one backward launch per step on CUDA)."""

        def distill_step(params, opt_state, batch, key, teacher_params):
            dev = _device(params)
            x, y = _to_device(batch["x"], dev), _to_device(batch["y"], dev)
            with torch.no_grad():
                t_logits = teacher_fwd(teacher_params, x, train=False,
                                       key=None)

            def loss_fn(p):
                s_logits = fwd(p, x, train=True, key=key)
                if fused:
                    return ops.kd_distillation_loss(
                        s_logits, t_logits, y, kd_temperature, kd_alpha)
                loss, _ = distillation_loss(
                    s_logits, t_logits, y, temperature=kd_temperature,
                    alpha=kd_alpha)
                return loss

            return _grad_step(loss_fn, opt, params, opt_state)

        return distill_step

    @torch.no_grad()
    def eval_batch(params, x, y):
        dev = _device(params)
        x, y = _to_device(x, dev), _to_device(y, dev)
        logits = fwd(params, x, train=False, key=None)
        loss = softmax_cross_entropy(logits, y)
        acc = (torch.argmax(logits, dim=-1) == y).float().mean()
        return acc, loss

    return {"ce": ce_step, "prox": prox_step,
            "make_distill": make_distill_step, "eval": eval_batch}


def evaluate(eval_batch, params, x, y, batch_size: int = 256):
    """Dataset accuracy/loss via batched eval (last partial batch included);
    the per-batch values come back to the host in one transfer."""
    parts, ns = [], []
    for s in range(0, len(y), batch_size):
        a, l = eval_batch(params, x[s:s + batch_size], y[s:s + batch_size])
        parts.append(torch.stack([a, l]))
        ns.append(len(y[s:s + batch_size]))
    vals = torch.stack(parts).tolist()
    n = sum(ns)
    return (sum(a * k for (a, _), k in zip(vals, ns)) / n,
            sum(l * k for (_, l), k in zip(vals, ns)) / n)
