"""Functional optimizers over dicts of tensors: the port of
``repro.optim.optimizers``.

An ``Optimizer`` is (init, update):  state = init(params);
updates, state = update(grads, state, params).  Apply with
``apply_updates``.  ``torch.optim`` is not used: AdamW here adds the weight
decay inside the learning-rate step, after the moment normalisation, exactly
as the JAX package does, and the state is plain data the engine can copy.
Moments are float32 (``state_dtype``) and the step count an int32 scalar
tensor on the parameters' device.
"""
from __future__ import annotations

import dataclasses
from typing import Callable, NamedTuple

import torch


@dataclasses.dataclass(frozen=True)
class Optimizer:
    init: Callable
    update: Callable


def _device(params) -> torch.device:
    return next(iter(params.values())).device


def apply_updates(params, updates):
    return {k: (p + updates[k]).to(p.dtype) for k, p in params.items()}


# ----------------------------------------------------------------------- sgd
class SGDState(NamedTuple):
    momentum: object
    count: torch.Tensor


def sgd(lr, momentum: float = 0.0) -> Optimizer:
    lr_fn = lr if callable(lr) else (lambda _: lr)

    def init(params):
        mom = ({k: torch.zeros_like(p) for k, p in params.items()}
               if momentum else None)
        return SGDState(mom, torch.zeros((), dtype=torch.int32,
                                         device=_device(params)))

    @torch.no_grad()
    def update(grads, state: SGDState, params=None):
        del params
        step_lr = lr_fn(state.count)
        if momentum:
            mom = {k: momentum * state.momentum[k] + g
                   for k, g in grads.items()}
            return ({k: -step_lr * m for k, m in mom.items()},
                    SGDState(mom, state.count + 1))
        return ({k: -step_lr * g for k, g in grads.items()},
                SGDState(None, state.count + 1))

    return Optimizer(init, update)


# --------------------------------------------------------------------- adamw
class AdamState(NamedTuple):
    mu: dict
    nu: dict
    count: torch.Tensor


def adamw(lr, b1: float = 0.9, b2: float = 0.999, eps: float = 1e-8,
          weight_decay: float = 0.0, *,
          state_dtype=torch.float32) -> Optimizer:
    lr_fn = lr if callable(lr) else (lambda _: lr)

    def init(params):
        z = {k: torch.zeros(p.shape, dtype=state_dtype, device=p.device)
             for k, p in params.items()}
        return AdamState(z, {k: v.clone() for k, v in z.items()},
                         torch.zeros((), dtype=torch.int32,
                                     device=_device(params)))

    @torch.no_grad()
    def update(grads, state: AdamState, params):
        count = state.count + 1
        step_lr = lr_fn(count)
        mu = {k: (b1 * state.mu[k].float() + (1 - b1) * g.float()
                  ).to(state_dtype) for k, g in grads.items()}
        nu = {k: (b2 * state.nu[k].float()
                  + (1 - b2) * torch.square(g.float())).to(state_dtype)
              for k, g in grads.items()}
        cf = count.to(torch.float32)
        c1 = 1 - b1 ** cf
        c2 = 1 - b2 ** cf

        def upd(k):
            mhat = mu[k].float() / c1
            vhat = nu[k].float() / c2
            p = params[k]
            u = -step_lr * (mhat / (torch.sqrt(vhat) + eps)
                            + weight_decay * p.float())
            return u.to(p.dtype)

        return {k: upd(k) for k in grads}, AdamState(mu, nu, count)

    return Optimizer(init, update)


# ------------------------------------------------------------------ fedprox
def fedprox_penalty(params, global_params, mu: float) -> torch.Tensor:
    """(mu/2)||w - w_g||^2 proximal term (Li et al. 2020)."""
    sq = [torch.sum((p.float() - global_params[k].float()) ** 2)
          for k, p in params.items()]
    return 0.5 * mu * sum(sq)
