"""FL+HC (Briggs 2020): one pre-round of local training, agglomerative
clustering of the updates, then per-cluster FedAvg for the rest of the
run.  The port of ``repro.fed.algorithms.flhc`` on the loop engine.

The clustering pre-round is ``setup`` and is the run's round 1
(``setup_rounds = 1``): every client trains one round from the same
initial params, the flattened updates are clustered (``num_clusters`` or
4 clusters, average linkage), and each cluster's model starts as the
example-weighted mean of its members' params.  Every later round trains
the sampled members of each cluster from the cluster's model and merges
them with ``aggregation.fedavg``: one fused-merge launch a cluster with a
surviving member, K launches a full round on the card.  Eval is the
client-example-weighted mean of the cluster models' accuracy and loss.

``FedConfig`` refuses the client lifecycle and ``async_mode`` for FL+HC.
Checkpoints hold the cluster models (``cluster_models``, the JAX layout);
a resumed run re-runs the deterministic pre-round in ``setup`` (its labels
are checked against the fingerprint's) and then takes the restored models.
"""
from __future__ import annotations

import numpy as np
import torch

from repro_torch import convert, rng
from repro_torch.core import aggregation as agg
from repro_torch.core import hierarchical
from repro_torch.fed import schedule
from repro_torch.fed.algorithms.base import Algorithm, local_epochs, tree_copy
from repro_torch.fed.client import evaluate, make_steps
from repro_torch.models.cnn import make_model
from repro_torch.optim import adamw


class FLHC(Algorithm):
    name = "flhc"
    engine = "loop"
    setup_rounds = 1       # the clustering pre-round is the run's round 1

    def setup(self, ds, shards, cfg, seed: int, *, device):
        self.ds, self.shards, self.cfg, self.seed = ds, shards, cfg, seed
        self.device = torch.device(device)
        self.opt = adamw(cfg.lr)
        self.t_init, t_fwd = make_model(ds.name, student=False)
        self.steps = make_steps(t_fwd, self.opt, prox_mu=cfg.prox_mu)
        global_params = self._init_params()
        locals_, updates = [], []
        for i, sh in enumerate(shards):
            p = tree_copy(global_params)
            o = self.opt.init(p)
            p, _, _ = local_epochs(sh, p, o, rng.fold_seed(seed, i), cfg,
                                   step_fn=self.steps["ce"])
            locals_.append(p)
            updates.append(hierarchical.flatten_update(
                agg.tree_sub(p, global_params)))
        k = cfg.num_clusters or 4
        self.labels = hierarchical.agglomerative(np.stack(updates),
                                                 n_clusters=k)
        self.clusters = [np.flatnonzero(self.labels == c)
                         for c in np.unique(self.labels)]
        self.cluster_models = [
            agg.fedavg([locals_[i] for i in c],
                       [shards[i].num_examples for i in c])
            for c in self.clusters]
        self.scheduler = schedule.RoundScheduler(
            self.labels, participation=cfg.participation,
            clients_per_round=cfg.clients_per_round,
            dropout_rate=cfg.dropout_rate, seed=cfg.seed)
        self._x_test = torch.from_numpy(ds.x_test).to(self.device)
        self._y_test = torch.from_numpy(ds.y_test).to(self.device)

    def _init_params(self) -> dict:
        return self.t_init(rng.fold_seed(self.seed), self.device)

    def run_round(self, plan, rnd):
        cfg = self.cfg
        part = set(int(i) for i in plan.participants)
        for ci, members in enumerate(self.clusters):
            sel = [int(i) for i in members if int(i) in part]
            if not sel:
                continue     # no sampled/surviving member: model untouched
            locs = []
            for i in sel:
                p = tree_copy(self.cluster_models[ci])
                o = self.opt.init(p)
                p, _, _ = local_epochs(
                    self.shards[i], p, o, rng.fold_seed(self.seed,
                                                        rnd * 777 + i),
                    cfg, step_fn=self.steps["ce"])
                locs.append(p)
            self.cluster_models[ci] = agg.fedavg(
                locs, [self.shards[i].num_examples for i in sel])
        return {}

    def eval(self):
        # client-weighted mean over cluster models on the global test set
        # (full-population cluster sizes, independent of this round's sample)
        accs, losses, ws = [], [], []
        for cm, c in zip(self.cluster_models, self.clusters):
            a, l = evaluate(self.steps["eval"], cm, self._x_test,
                            self._y_test)
            w = sum(self.shards[int(i)].num_examples for i in c)
            accs.append(a * w)
            losses.append(l * w)
            ws.append(w)
        return sum(accs) / sum(ws), sum(losses) / sum(ws)

    def checkpoint_arrays(self):
        return {"cluster_models": [convert.params_to_jax(m)
                                   for m in self.cluster_models]}

    def restore_arrays(self, arrays):
        self.cluster_models = [convert.params_from_jax(m, device=self.device)
                               for m in arrays["cluster_models"]]

    def history_extras(self):
        return {"num_clusters": len(self.clusters)}
