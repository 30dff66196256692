"""FedAvg / FedProx baseline strategies on both engines: the port of
``repro.fed.algorithms.baselines`` for synchronous rounds.

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

The loop engine also runs the client lifecycle (a roster change rebuilds
the scheduler over the active clients; there is no cluster structure to
migrate) and semi-async rounds (stragglers' updates go to the driver's
buffer under their example counts and merge late with staleness-decayed
weights).  Both engines checkpoint the JAX package's arrays: the global
model as ``student`` and the roster's labels.  The packed engine's
lifecycle and async rounds are not ported (``rounds.unported_knobs``).
"""
from __future__ import annotations

import numpy as np
import torch

from repro_torch import convert, rng
from repro_torch.core import aggregation as agg
from repro_torch.data.pipeline import ClientStore
from repro_torch.fed import schedule
from repro_torch.fed import sharded as sh
from repro_torch.fed.algorithms.base import (Algorithm, local_epochs,
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
    example-weighted product a leaf gives every slot the new global model.
    One wave a round (more raise in ``rounds.unported_knobs``)."""

    engine = "sharded"

    def _make_scheduler(self, cfg, labels):
        return schedule.RoundScheduler(
            labels, participation=cfg.participation,
            clients_per_round=self.clamped_clients_per_round(cfg, labels),
            pack=cfg.pack, n_devices=cfg.n_devices, waves=cfg.waves,
            dropout_rate=cfg.dropout_rate, seed=cfg.seed,
            async_mode=cfg.async_mode, round_deadline=cfg.round_deadline,
            straggler_frac=cfg.straggler_frac,
            latency_dist=cfg.latency_dist)

    def _setup_engine(self):
        cfg, store = self.cfg, self.shards
        if self.scheduler.n_waves != 1:
            raise NotImplementedError(
                "wave-scheduled rounds (more than one wave) are not ported "
                "to repro_torch yet (ROADMAP Queue 1 item 9)")
        self.S = self.scheduler.wave_slots
        # static per-client step budgets and the one-off (C, steps, B, ...)
        # host staging: the loop engine's batch sequences
        self._base_counts = sh.client_step_counts(store.base, cfg.batch_size,
                                                  cfg.local_epochs)
        self.steps_all = self._base_counts[store.row_of]
        self.x_all, self.y_all = sh.stack_client_data(
            store.base, int(self._base_counts.max()), cfg.batch_size,
            seed=cfg.seed)
        self.round_fn = sh.make_packed_baseline_round(
            self.t_fwd, self.opt,
            prox_mu=cfg.prox_mu if self.is_prox else 0.0,
            lane_dropout=make_lane_dropout(self.ds.name, student=False))
        self.stager = sh.WaveStager(self.x_all, self.y_all,
                                    device=self.device,
                                    row_maps=(store.row_of, store.row_of))

    def _prep(self, global_p):
        """The round-start global params on every slot, and a fresh stacked
        Adam state (the loop engine's per-client ``opt.init``)."""
        p_s = {k: v.expand((self.S,) + v.shape) for k, v in global_p.items()}
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
        """Stage the NEXT round's slot data while this round computes."""
        if plan is not None and plan.active.any():
            self.stager.prefetch(plan.wave(0))

    def run_round(self, plan, rnd):
        if not plan.active.any():
            # every invited client dropped out: a no-op round
            return {"train_loss": 0.0}
        wp = plan.wave(0)
        xs, ys = self.stager.stage(wp)
        p_s, s_s = self._prep(self.global_params)
        p_s, _p_local, _s_s, loss = self.round_fn(
            p_s, s_s, xs, ys, wp.steps_for(self.steps_all),
            self._slot_keys(rnd, wp), plan.example_row(self.sizes),
            self.global_params)
        self.global_params = self._take0(p_s)
        return {"train_loss": float(loss)}      # the round's one host sync

    def history_extras(self):
        return {"pack": self.scheduler.pack, "train_loss": []}
