"""FedAvg / FedProx baseline strategies on both engines: the port of
``repro.fed.algorithms.baselines``.

The paper's headline claims are comparative (FedSiKD against FedAvg and
FedProx at alpha in {0.1, 0.5}), so the baselines run on the same engines
as FedSiKD.  The federated model is the paper's teacher CNN; every client
starts each round from the global params with a fresh Adam state.

- ``LoopBaseline``: per-client CE (FedAvg) or proximal-CE (FedProx) local
  epochs, then ``aggregation.fedavg`` of the survivors' params under their
  example counts: one fused-merge launch a round on the card.
- ``PackedBaseline``: every participating client is a lane of one stacked
  program a round (``fed/sharded.py::make_packed_baseline_round``), with
  the proximal term against the round-start global params and the merge
  as one product a leaf with the plan's example-weighted row
  (``RoundPlan.example_row``).  That product is what the JAX package does
  there too, so this engine launches no fused merge.

Both engines stage the same per-client batch sequences, freeze each
client's carry after the same step budget and aggregate with the same
example weights, so they agree up to the order of float32 sums.  Random
streams are integer seeds (``repro_torch.rng``), folded where the JAX code
folds its keys; only HAR's dropout reads them.

Both engines also run the client lifecycle (a roster change rebuilds the
scheduler over the active clients; there is no cluster structure to
migrate) and semi-async rounds (stragglers' updates go to the driver's
buffer under their example counts and merge late with staleness-decayed
weights), and checkpoint the JAX package's arrays: the global model as
``student`` and the roster's labels.  The packed engine also streams a
cohort larger than one wave through its program and runs over a virtual
client universe (``cfg.universe``).
"""
from __future__ import annotations

import numpy as np
import torch

from repro_torch import convert, perf, rng
from repro_torch.core import aggregation as agg
from repro_torch.data.pipeline import ClientStore
from repro_torch.fed import schedule
from repro_torch.fed import sharded as sh
from repro_torch.fed.algorithms.base import (Algorithm, local_epochs,
                                             merge_arrivals_only,
                                             packed_async_row,
                                             staleness_merge, tree_copy)
from repro_torch.fed.client import evaluate, make_steps
from repro_torch.fed.driver import AsyncUpdate
from repro_torch.models.cnn import make_lane_dropout, make_model
from repro_torch.optim import adamw


class _BaselineBase(Algorithm):
    """Shared setup: a single pseudo-cluster scheduler (the plan is just
    which clients train this round), the paper's teacher CNN as the
    federated model, example-weighted FedAvg aggregation."""

    def setup(self, ds, shards, cfg, seed: int, *, device):
        if not isinstance(shards, ClientStore):
            shards = ClientStore(shards, universe=cfg.universe)
        self.ds, self.shards, self.cfg, self.seed = ds, shards, cfg, seed
        self.device = torch.device(device)
        self.name = cfg.algorithm
        self.is_prox = cfg.algorithm == "fedprox"
        self.roster_labels = self._roster_labels(self.initial_active(cfg))
        self.scheduler = self._make_scheduler(cfg, self.roster_labels)
        self.opt = adamw(cfg.lr)
        self.t_init, self.t_fwd = make_model(ds.name, student=False)
        self.steps = make_steps(self.t_fwd, self.opt, prox_mu=cfg.prox_mu)
        self.global_params = self._init_params()
        self.sizes = np.asarray(shards.sizes)
        self._x_test = torch.from_numpy(ds.x_test).to(self.device)
        self._y_test = torch.from_numpy(ds.y_test).to(self.device)
        self._setup_engine()

    def _init_params(self) -> dict:
        return self.t_init(rng.fold_seed(self.seed), self.device)

    @staticmethod
    def _roster_labels(active) -> np.ndarray:
        """One pseudo-cluster over the CURRENT roster (-1 off the roster)."""
        return np.where(np.asarray(active), 0, -1).astype(np.int32)

    def apply_lifecycle(self, event):
        """No cluster structure to migrate: a roster change rebuilds the
        scheduler over the active clients (a cadence hit changes
        nothing else)."""
        self.roster_labels = self._roster_labels(event.active)
        self.scheduler = self._make_scheduler(self.cfg, self.roster_labels)
        return {"active_clients": float(event.active.sum())}

    def _make_scheduler(self, cfg, labels):
        return schedule.RoundScheduler(
            labels, participation=cfg.participation,
            clients_per_round=self.clamped_clients_per_round(cfg, labels),
            dropout_rate=cfg.dropout_rate, seed=cfg.seed,
            async_mode=cfg.async_mode, round_deadline=cfg.round_deadline,
            straggler_frac=cfg.straggler_frac,
            latency_dist=cfg.latency_dist)

    def _setup_engine(self):
        pass

    def eval(self):
        return evaluate(self.steps["eval"], self.global_params,
                        self._x_test, self._y_test)

    def checkpoint_arrays(self):
        # the roster rides the checkpoint: a resume past a lifecycle event
        # rebuilds the scheduler for the roster as of the checkpoint round
        return {"student": convert.params_to_jax(self.global_params),
                "labels": torch.as_tensor(self.roster_labels)}

    def restore_arrays(self, arrays):
        self.global_params = convert.params_from_jax(arrays["student"],
                                                     device=self.device)
        self.roster_labels = arrays["labels"].numpy()
        self.scheduler = self._make_scheduler(self.cfg, self.roster_labels)


# ---------------------------------------------------------------- loop engine
class LoopBaseline(_BaselineBase):
    """Sequential reference: per-client CE (FedAvg) or proximal-CE (FedProx)
    local epochs, example-weighted global mean."""

    engine = "loop"

    def run_round(self, plan, rnd):
        cfg = self.cfg
        delay_of = plan.delay_of()
        locals_, sizes = [], []
        for i in (int(i) for i in plan.participants):
            sh_i = self.shards[i]
            p = tree_copy(self.global_params)
            o = self.opt.init(p)
            key = rng.fold_seed(self.seed, rnd * 31 + i)
            if self.is_prox:
                p, _, _ = local_epochs(sh_i, p, o, key, cfg,
                                       step_fn=self.steps["prox"],
                                       extra=(self.global_params,))
            else:
                p, _, _ = local_epochs(sh_i, p, o, key, cfg,
                                       step_fn=self.steps["ce"])
            d = delay_of[i]
            if d > 0:              # straggler: update lands d rounds late
                self.buffer.push(AsyncUpdate(
                    client=i, birth=rnd, arrival=rnd + d,
                    weight=float(sh_i.num_examples), params=p))
            else:
                locals_.append(p)
                sizes.append(sh_i.num_examples)
        if self.arrivals or plan.stragglers.any():
            # semi-async merge under staleness-decayed example weights
            if locals_ or self.arrivals:
                self.global_params = staleness_merge(
                    locals_, [float(n) for n in sizes], self.arrivals,
                    cfg.staleness_decay)
        elif locals_:
            self.global_params = agg.fedavg(locals_, sizes)
        # else: an all-dropout round is a no-op (params unchanged)
        return {}


# ------------------------------------------------------------- packed engine
class PackedBaseline(_BaselineBase):
    """FedAvg/FedProx on the packed engine: every participating client runs
    its masked local steps as a lane of one stacked program, then one
    example-weighted product a leaf gives every slot the aggregate.

    Waves: a cohort larger than ``S`` streams through the same program wave
    by wave; every wave starts from the round-start global params, its
    contraction row is a slice of the example row over the WHOLE plan, and
    ``aggregation.fold_partials`` sums the per-wave partials into the
    cohort mean.  Semi-async rounds split the staleness merge over raw
    example counts (``packed_async_row``): straggling lanes weigh 0 and go
    to the driver's buffer as copies, arrivals fold in on the host.

    Under a ``torch.distributed`` process group the slots spread over a
    client mesh of ranks (``sharded.make_client_mesh``): each rank trains
    its block of every wave's slots, the global params stay replicated on
    every rank, and a straggler's params come from the rank that holds its
    lane."""

    engine = "sharded"

    def _make_scheduler(self, cfg, labels):
        return schedule.RoundScheduler(
            labels, participation=cfg.participation,
            clients_per_round=self.clamped_clients_per_round(cfg, labels),
            pack=cfg.pack, n_devices=self.forced_devices(cfg),
            waves=cfg.waves, dropout_rate=cfg.dropout_rate, seed=cfg.seed,
            async_mode=cfg.async_mode, round_deadline=cfg.round_deadline,
            straggler_frac=cfg.straggler_frac,
            latency_dist=cfg.latency_dist)

    def _setup_engine(self):
        cfg, store = self.cfg, self.shards
        self.S = self.scheduler.wave_slots
        self.mesh = sh.make_client_mesh(self.scheduler.n_devices,
                                        pack=self.scheduler.pack,
                                        device=self.device)
        self.n_local = (self.S if self.mesh is None
                        else self.S // self.mesh.size())
        # static per-client step budgets and the one-off (R, steps, B, ...)
        # host staging of the BASE pool (virtual clients alias base rows
        # through ``row_of``): the loop engine's batch sequences
        self._base_counts = sh.client_step_counts(store.base, cfg.batch_size,
                                                  cfg.local_epochs)
        self.steps_all = self._base_counts[store.row_of]
        self.x_all, self.y_all = sh.stack_client_data(
            store.base, int(self._base_counts.max()), cfg.batch_size,
            seed=cfg.seed)
        self.round_fn = sh.make_packed_baseline_round(
            self.t_fwd, self.opt,
            prox_mu=cfg.prox_mu if self.is_prox else 0.0,
            lane_dropout=make_lane_dropout(self.ds.name, student=False),
            mesh=self.mesh)
        self.stager = sh.WaveStager(self.x_all, self.y_all,
                                    device=self.device,
                                    row_maps=(store.row_of, store.row_of),
                                    capacity=self.scheduler.n_waves + 1,
                                    mesh=self.mesh)

    def _prep(self, global_p):
        """The round-start global params on every slot (of this rank's
        block on a mesh), and a fresh stacked Adam state (the loop engine's
        per-client ``opt.init``)."""
        p_s = {k: v.expand((self.n_local,) + v.shape)
               for k, v in global_p.items()}
        return p_s, sh.stacked_opt_init(self.opt, p_s)

    @staticmethod
    def _take0(tree):
        """Slot 0 of a stack whose slots all hold the aggregate."""
        return {k: v[0] for k, v in tree.items()}

    def _slot_keys(self, rnd, plan):
        """Per-slot training seeds, folded by client id; the salt 40_000
        keeps the stream apart from the clustered-KD engines'."""
        return sh.slot_client_keys(rng.fold_seed(self.seed, 40_000 + rnd),
                                   plan)

    def prefetch(self, plan):
        """Stage the NEXT round's first wave while this round computes;
        later waves are prefetched inside ``run_round``."""
        if plan is not None and plan.active.any():
            self.stager.prefetch(plan.wave(0))

    def warm_async_merge(self):
        g = self.global_params
        agg.add_scaled(g, g, 0.0)
        agg.staleness_weighted_average([g], [1.0], [1],
                                       decay=self.cfg.staleness_decay)

    def run_round(self, plan, rnd):
        cfg = self.cfg
        arrivals = self.arrivals
        if not plan.active.any():
            # every invited client dropped out: a no-op round, unless
            # buffered updates arrive, which merge alone
            if arrivals:
                self.global_params = merge_arrivals_only(
                    arrivals, cfg.staleness_decay)
            return {"train_loss": 0.0}
        has_async = bool(arrivals) or bool(plan.stragglers.any())
        # the row is built over the WHOLE plan and sliced per wave
        if not has_async:
            row, scales = plan.example_row(self.sizes), []
        elif plan.on_time.any() or arrivals:
            # split merge over raw example counts (the buffered entries'
            # ``weight`` is their example count too)
            safe = np.where(plan.active, plan.slot_client, 0)
            n_slot = np.where(plan.active, self.sizes[safe], 0)
            row, scales = packed_async_row(n_slot, plan.on_time, arrivals,
                                           cfg.staleness_decay)
        else:
            row, scales = np.zeros(plan.n_slots, np.float32), []
        ws, n_waves = plan.wave_slots or plan.n_slots, plan.n_waves
        partials, losses = [], []
        for w in range(n_waves):
            wp = plan.wave(w)
            if not wp.active.any():
                continue
            with perf.span("stage"):
                xs, ys = self.stager.stage(wp)
                p_s, s_s = self._prep(self.global_params)
            with perf.span("compute"):
                if w + 1 < n_waves:
                    self.stager.prefetch(plan.wave(w + 1))
                n_w = wp.steps_for(self.steps_all)
                p_s, p_local, _s_s, loss = self.round_fn(
                    p_s, s_s, xs, ys, n_w, self._slot_keys(rnd, wp),
                    np.ascontiguousarray(row[w * ws:(w + 1) * ws]),
                    self.global_params)
                # the wave's one host sync, inside the span it waits for
                losses.append((float(loss), int((n_w > 0).sum())))
            with perf.span("aggregate"):
                partials.append(self._take0(p_s))
            if has_async:
                for t in np.flatnonzero(wp.stragglers):
                    c = int(wp.slot_client[t])
                    self.buffer.push(AsyncUpdate(
                        client=c, birth=rnd, arrival=rnd + int(wp.delays[t]),
                        weight=float(self.sizes[c]),
                        params=sh.take_rows(p_local, int(t),
                                            mesh=self.mesh)))
        if len(losses) == 1:
            loss = losses[0][0]
        else:
            tot = sum(c for _, c in losses)
            loss = float(sum(lo * c for lo, c in losses) / tot) if tot else 0.0
        p0 = partials[0] if len(partials) == 1 else agg.fold_partials(partials)
        if not has_async:
            self.global_params = p0
        elif plan.on_time.any():
            acc = p0
            for u, sc in zip(arrivals, scales):
                acc = agg.add_scaled(acc, u.params, sc)
            self.global_params = acc
        elif arrivals:
            self.global_params = merge_arrivals_only(arrivals,
                                                     cfg.staleness_decay)
        # else: an all-straggler round with an empty buffer — unchanged
        return {"train_loss": loss}

    def history_extras(self):
        return {"pack": self.scheduler.pack, "train_loss": []}
