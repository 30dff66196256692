"""The ``Algorithm`` strategy protocol and the loop-engine helpers: the port
of ``repro.fed.algorithms.base`` (loop helpers only).

A federated run is a fixed round skeleton (``fed/driver.py::RoundDriver``)
parameterized by an algorithm strategy:

1. ``setup(ds, shards, cfg, seed, device=...)`` — clustering, models, steps
   and the ``RoundScheduler``; must populate ``scheduler`` and ``labels``.
2. ``warmup()`` — pre-round establishment work (FedSiKD's teacher warm-up).
   Before each round but the last the driver calls ``prefetch`` with the
   next round's plan.
3. ``run_round(plan, rnd)`` — local updates + aggregation for the plan's
   participants; returns per-round metrics.  An all-idle plan is a no-op.
4. ``eval()`` — (accuracy, loss) of the current global model on the test set.

``setup_rounds`` (default 0) is the number of rounds ``setup`` itself
consumes: FL+HC's clustering pre-round trains every client and is the
run's round 1, so the driver records it and starts the round loop after
it.
"""
from __future__ import annotations

from typing import Optional

import numpy as np
import torch

from repro_torch import rng
from repro_torch.data.pipeline import ClientShard
from repro_torch.fed.schedule import RoundPlan, RoundScheduler


class Algorithm:
    """Base strategy: one subclass per (algorithm family, engine)."""

    name: str = "?"
    engine: str = "loop"
    setup_rounds: int = 0
    scheduler: RoundScheduler
    labels: Optional[np.ndarray] = None
    progress: bool = False

    def setup(self, ds, shards, cfg, seed: int, *, device) -> None:
        raise NotImplementedError

    def warmup(self) -> None:
        """Pre-round establishment (skipped on resume in the JAX package)."""

    def initial_active(self, cfg) -> np.ndarray:
        """(total_clients,) bool roster before round 1 (no lifecycle yet)."""
        return np.ones(cfg.total_clients, bool)

    def clamped_clients_per_round(self, cfg, labels) -> Optional[int]:
        """``clients_per_round`` clamped to the current roster size."""
        if cfg.participation == "full" or cfg.clients_per_round is None:
            return None
        return min(cfg.clients_per_round, int((np.asarray(labels) >= 0).sum()))

    def prefetch(self, plan: Optional[RoundPlan]) -> None:
        """Start staging ``plan``'s data ahead of its round (packed engine
        only; the loop engine reads host batches per step)."""

    def run_round(self, plan: RoundPlan, rnd: int) -> dict:
        raise NotImplementedError

    def eval(self) -> tuple[float, float]:
        raise NotImplementedError

    def history_extras(self) -> dict:
        """Algorithm-specific history fields."""
        return {}


# ------------------------------------------------ shared loop-engine helpers
def local_epochs(shard: ClientShard, params, opt_state, key: int, cfg,
                 *, step_fn, extra=()):
    """``cfg.local_epochs`` of sequential local steps on one client's shard;
    step ``j`` draws from the stream ``fold_seed(key, j)``.  Returns the
    params, the optimizer state and the mean step loss (a device scalar)."""
    losses = []
    for epoch in range(cfg.local_epochs):
        for x, y in shard.batches(cfg.batch_size, epoch=epoch, seed=cfg.seed):
            params, opt_state, loss = step_fn(params, opt_state,
                                              {"x": x, "y": y},
                                              rng.fold_seed(key, len(losses)),
                                              *extra)
            losses.append(loss)
    return params, opt_state, _mean(losses, params)


def cluster_epochs(members: list[ClientShard], params, opt_state, key: int,
                   cfg, *, step_fn, epochs: int):
    """Teacher pass over the union of cluster members' shards (Alg.1 l.12):
    pooled and shuffled globally; a single member is used as it is, which
    keeps its batch order identical to the JAX package's.  Returns what
    ``local_epochs`` returns."""
    if len(members) == 1:
        pooled = members[0]
    else:
        pooled = ClientShard(
            client_id=-1,
            x=np.concatenate([sh.x for sh in members]),
            y=np.concatenate([sh.y for sh in members]))
    losses = []
    for epoch in range(epochs):
        for x, y in pooled.batches(cfg.batch_size, epoch=epoch, seed=cfg.seed):
            params, opt_state, loss = step_fn(params, opt_state,
                                              {"x": x, "y": y},
                                              rng.fold_seed(key, len(losses)))
            losses.append(loss)
    return params, opt_state, _mean(losses, params)


def _mean(losses: list, params: dict):
    """Mean of the step losses, on the device (0 for no steps)."""
    if not losses:
        return torch.zeros((), device=next(iter(params.values())).device)
    return torch.stack(losses).mean()


def tree_copy(params: dict) -> dict:
    return {k: v.clone() for k, v in params.items()}
