"""The ``Algorithm`` strategy protocol and the loop-engine helpers: the port
of ``repro.fed.algorithms.base``.

A federated run is a fixed round skeleton (``fed/driver.py::RoundDriver``)
parameterized by an algorithm strategy:

1. ``setup(ds, shards, cfg, seed, device=...)`` — clustering, models, steps
   and the ``RoundScheduler``; must populate ``scheduler`` and ``labels``.
   It runs on resume too, and must be deterministic.
2. ``warmup()`` — pre-round establishment work (FedSiKD's teacher warm-up),
   skipped on resume: a checkpoint already holds it.  Before each round
   but the last the driver calls ``prefetch`` with the next round's plan.
3. ``run_round(plan, rnd)`` — local updates + aggregation for the plan's
   participants; returns per-round metrics.  An all-idle plan is a no-op.
4. ``eval()`` — (accuracy, loss) of the current global model on the test set.
5. ``checkpoint_arrays()`` / ``restore_arrays(arrays)`` — the tree that
   crosses the round boundary, in the JAX package's keys and layouts
   (``repro_torch.convert``, tensors kept where they lie), and its inverse
   from a restored tree of CPU tensors.

``setup_rounds`` (default 0) is the number of rounds ``setup`` itself
consumes: FL+HC's clustering pre-round trains every client and is the
run's round 1, so the driver records it and starts the round loop after
it.

Lifecycle hook: with a ``ClientLifecycle`` the driver sets
``alg.lifecycle`` before ``setup`` (which then clusters the initial roster
only) and calls ``apply_lifecycle(event)`` at the start of every event
round; the strategy re-clusters, migrates its state and rebuilds its
``scheduler``.

Semi-async hook: with ``cfg.async_mode`` the driver sets ``alg.buffer``
(its ``StalenessBuffer``) after setup and ``alg.arrivals`` (this round's
due updates) before each ``run_round``.  A loop strategy pushes its
straggling participants' updates into the buffer with their birth-round
base weight, and merges the on-time updates with the arrivals through
``staleness_merge``.  A packed strategy splits the same merge
(``packed_async_row``): its round program contracts the on-time lanes and
the host folds each arrival in.  With no stragglers and no arrivals either
takes its synchronous merge, so ``straggler_frac=0`` repeats
``async_mode=False``.
"""
from __future__ import annotations

from typing import Optional

import numpy as np
import torch

from repro_torch import rng
from repro_torch.core import aggregation as agg
from repro_torch.data.pipeline import ClientShard
from repro_torch.fed.lifecycle import ClientLifecycle, LifecycleEvent
from repro_torch.fed.schedule import RoundPlan, RoundScheduler
from repro_torch.launch.mesh import fed_mesh_layout


class Algorithm:
    """Base strategy: one subclass per (algorithm family, engine)."""

    name: str = "?"
    engine: str = "loop"
    setup_rounds: int = 0
    scheduler: RoundScheduler
    labels: Optional[np.ndarray] = None
    # set by the driver before setup():
    progress: bool = False
    lifecycle: Optional[ClientLifecycle] = None
    # semi-async (driver-set; None/() when cfg.async_mode is off):
    buffer = None            # the driver's StalenessBuffer
    arrivals: tuple = ()     # AsyncUpdates merging this round

    def setup(self, ds, shards, cfg, seed: int, *, device) -> None:
        raise NotImplementedError

    def warmup(self) -> None:
        """Pre-round establishment (checkpointed state; skipped on resume)."""

    def apply_lifecycle(self, event: LifecycleEvent) -> dict:
        """React to a roster change or a re-clustering cadence hit:
        re-cluster the active clients, migrate cross-round state, rebuild
        ``scheduler``.  Returns per-round metrics."""
        raise NotImplementedError(
            f"algorithm {self.name!r} does not support the client lifecycle")

    def initial_active(self, cfg) -> np.ndarray:
        """(total_clients,) bool roster before round 1."""
        if self.lifecycle is None:
            return np.ones(cfg.total_clients, bool)
        return self.lifecycle.initial_active()

    def clamped_clients_per_round(self, cfg, labels) -> Optional[int]:
        """``clients_per_round`` clamped to the current roster size."""
        if cfg.participation == "full" or cfg.clients_per_round is None:
            return None
        return min(cfg.clients_per_round, int((np.asarray(labels) >= 0).sum()))

    def forced_devices(self, cfg) -> Optional[int]:
        """The slot layout's device count, pinned independently of the
        current roster: ``cfg.n_devices`` when set; else, under a
        lifecycle, the count that hosts the largest roster any join can
        produce, so re-clustering never changes the slot count."""
        if cfg.n_devices is not None:
            return cfg.n_devices
        if self.lifecycle is None:
            return None
        cap = cfg.clients_per_round or cfg.num_clients
        return fed_mesh_layout(cap, pack=cfg.pack)[0]

    def prefetch(self, plan: Optional[RoundPlan]) -> None:
        """Start staging ``plan``'s data ahead of its round (packed engine
        only; the loop engine reads host batches per step)."""

    def run_round(self, plan: RoundPlan, rnd: int) -> dict:
        raise NotImplementedError

    def eval(self) -> tuple[float, float]:
        raise NotImplementedError

    def checkpoint_arrays(self) -> dict:
        raise NotImplementedError

    def restore_arrays(self, arrays: dict) -> None:
        raise NotImplementedError

    def history_extras(self) -> dict:
        """Algorithm-specific history fields."""
        return {}

    def warm_async_merge(self) -> None:
        """Run the arrival fold once, on the live global model with a zero
        scale, its result discarded: the driver calls it during the warm-in
        of a guarded semi-async run, so the fused merge's first build and
        plan fall outside the guarded rounds.  Default: nothing to warm."""


# -------------------------------------------------- shared semi-async helpers
def staleness_merge(on_params, on_weights, arrivals, decay: float):
    """One round's merged global model on a loop engine: the on-time updates
    (staleness 0) and the buffered ``arrivals`` under the decayed,
    renormalised weights, in one fused merge.  The caller guarantees the
    merge set is non-empty."""
    params = list(on_params) + [u.params for u in arrivals]
    base = list(on_weights) + [float(u.weight) for u in arrivals]
    stale = [0] * len(on_params) + [u.staleness for u in arrivals]
    return agg.staleness_weighted_average(params, base, stale, decay=decay)


def packed_async_row(w_slot, on_time, arrivals, decay: float):
    """The packed engines' split of the same merge: ``(row, scales)`` with
    ``row`` the (S,) contraction row (on-time slots' base weights over the
    grand total) and ``scales`` the per-arrival ``aggregation.add_scaled``
    factors (decayed weight over the same total).  The round program's
    contraction is the unnormalised sum ``sum_i row_i x_i``, so the
    program's on-time lanes plus the host's folded arrivals reproduce
    ``staleness_weights`` exactly; straggling lanes weigh 0."""
    w = np.where(np.asarray(on_time), np.asarray(w_slot, np.float64), 0.0)
    f = agg.staleness_factor([u.staleness for u in arrivals], decay)
    total = w.sum() + sum(float(u.weight) * float(fi)
                          for u, fi in zip(arrivals, f))
    scales = [float(u.weight) * float(fi) / total
              for u, fi in zip(arrivals, f)]
    return (w / total).astype(np.float32), scales


def merge_arrivals_only(arrivals, decay: float):
    """A round with arrivals and NO on-time participant (every invitee a
    straggler or a dropout): the merge is the arrivals alone, one fused
    merge."""
    return staleness_merge([], [], arrivals, decay)


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
