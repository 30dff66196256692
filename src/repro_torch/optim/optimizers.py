"""Functional optimizers over dicts of tensors: the port of
``repro.optim.optimizers``.

An ``Optimizer`` is (init, update):  state = init(params);
updates, state = update(grads, state, params).  Apply with
``apply_updates``.  ``adamw`` also has ``update_(grads, state, params)``,
which does the same arithmetic leaf by leaf and writes the moments, the
parameters and the count in place (the port's form of JAX's buffer
donation, for models too large to hold two copies of their state).  ``torch.optim`` is not used: AdamW here adds the weight
decay inside the learning-rate step, after the moment normalisation, exactly
as the JAX package does, and the state is plain data the engine can copy.
Moments are float32 (``state_dtype``) and the step count an int32 scalar
tensor on the parameters' device.
"""
from __future__ import annotations

import dataclasses
from typing import Callable, NamedTuple

import torch

# elements of a leaf that ``update_`` takes at a time (64 MB in float32)
INPLACE_PIECE = 1 << 24


@dataclasses.dataclass(frozen=True)
class Optimizer:
    init: Callable
    update: Callable
    update_: Callable | None = None


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

    @torch.no_grad()
    def update_(grads, state: AdamState, params):
        """``update`` followed by ``apply_updates``, written into
        ``state.mu``, ``state.nu``, ``params`` and ``state.count`` in
        place; returns ``state``.  Each leaf goes in pieces of
        ``INPLACE_PIECE`` elements through the same elementwise
        expressions as ``update``, so the result is bit for bit theirs and
        the temporaries stay a piece's size.  Views (one replica of a
        stack) are taken as they are."""
        count = state.count + 1
        step_lr = lr_fn(count)
        cf = count.to(torch.float32)
        c1 = 1 - b1 ** cf
        c2 = 1 - b2 ** cf
        for k, g in grads.items():
            m_all = state.mu[k].view(-1)
            v_all = state.nu[k].view(-1)
            p_all = params[k].view(-1)
            g_all = g.reshape(-1)
            for a in range(0, g_all.numel(), INPLACE_PIECE):
                sl = slice(a, a + INPLACE_PIECE)
                gf = g_all[sl].float()
                m = (b1 * m_all[sl].float() + (1 - b1) * gf).to(state_dtype)
                v = (b2 * v_all[sl].float()
                     + (1 - b2) * torch.square(gf)).to(state_dtype)
                m_all[sl] = m
                v_all[sl] = v
                p = p_all[sl]
                u = -step_lr * (m.float() / c1
                                / (torch.sqrt(v.float() / c2) + eps)
                                + weight_decay * p.float())
                p_all[sl] = (p + u.to(p.dtype)).to(p.dtype)
        state.count.copy_(count)
        return state

    return Optimizer(init, update, update_)


# ------------------------------------------------------------------ fedprox
def fedprox_penalty(params, global_params, mu: float) -> torch.Tensor:
    """(mu/2)||w - w_g||^2 proximal term (Li et al. 2020)."""
    sq = [torch.sum((p.float() - global_params[k].float()) ** 2)
          for k, p in params.items()]
    return 0.5 * mu * sum(sq)
