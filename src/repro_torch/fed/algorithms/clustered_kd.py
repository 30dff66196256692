"""Clustered-KD strategy on the loop engine: FedSiKD (Alg. 1) and the
RandomCluster ablation — the port of ``stat_features``,
``_ClusteredKDBase.setup``/``_rebuild_structures`` and ``LoopClusteredKD``
of ``repro.fed.algorithms.clustered_kd``.

``LoopClusteredKD`` is the sequential per-client reference: per round, each
cluster's teacher trains on its leader's shard (or the sampled cluster
members', ``teacher_data="cluster"``), then every sampled member distils a
copy of the global student from its cluster's teacher, and the plan-weighted
merge of the members' students (one fused-merge kernel launch per parameter
leaf on CUDA) becomes the new global student.  Random streams are integer
seeds folded exactly where the JAX code folds its keys
(``repro_torch.rng``).
"""
from __future__ import annotations

import numpy as np
import torch

from repro_torch import rng
from repro_torch.core import aggregation as agg
from repro_torch.core import kmeans, stats
from repro_torch.data.pipeline import ClientStore
from repro_torch.fed import schedule
from repro_torch.fed.algorithms.base import (Algorithm, cluster_epochs,
                                             local_epochs, tree_copy)
from repro_torch.fed.client import evaluate, make_steps
from repro_torch.models.cnn import make_model
from repro_torch.optim import adamw


def stat_features(shards, cfg, roster=None, *, device="cpu"):
    """Alg. 1 phase 1, batched: the (R, 3F) raw statistics matrix for the
    ``roster`` clients (None = everyone) in one segment-sum pass."""
    if roster is None:
        roster = np.arange(len(shards))
    roster = np.asarray(roster)
    xs = [shards[int(i)].x.reshape(shards[int(i)].num_examples, -1)
          for i in roster]
    sizes = [len(x) for x in xs]
    x_cat = torch.from_numpy(
        np.concatenate(xs, axis=0).astype(np.float32)).to(device)
    cid = torch.from_numpy(np.repeat(np.arange(len(roster)), sizes)).to(device)
    mean, std, skew = stats.batched_moments(x_cat, cid,
                                            num_segments=len(roster))
    return torch.cat([mean, std, skew], dim=1)


class _ClusteredKDBase(Algorithm):
    """Shared setup: clustering, leaders, scheduler, models/optimizers."""

    def setup(self, ds, shards, cfg, seed: int, *, device):
        if not isinstance(shards, ClientStore):
            shards = ClientStore(shards, universe=cfg.universe)
        self.ds, self.shards, self.cfg, self.seed = ds, shards, cfg, seed
        self.device = torch.device(device)
        self.name = cfg.algorithm
        self._stats_seed = cfg.seed + 17
        roster = np.flatnonzero(self.initial_active(cfg))
        if cfg.algorithm == "fedsikd":
            raw = stat_features(shards, cfg, roster, device=self.device)
            self._feat_mu, self._feat_sd = stats.standardize_params(raw)
            feats = stats.apply_standardize(raw, self._feat_mu, self._feat_sd)
            if cfg.num_clusters is None:
                k, _ = kmeans.select_k(self._stats_seed, feats, *cfg.k_range)
            else:
                k = cfg.num_clusters
            res = kmeans.kmeans(self._stats_seed, feats, k)
            lab = res.assignments.cpu().numpy().astype(np.int64)
            occ = np.unique(lab)
            # compact to the OCCUPIED clusters: one teacher per occupied
            # cluster, K fixed for the rest of the run
            self.K0 = len(occ)
            self.centroids = res.centroids.cpu().numpy()[occ]
            lab = np.searchsorted(occ, lab)
        else:                          # random-cluster ablation baseline
            r = np.random.default_rng(cfg.seed + 3)
            k = cfg.num_clusters or 4
            base = r.integers(0, k, cfg.total_clients)
            occ = np.unique(base)
            base = np.searchsorted(occ, base)
            self.K0 = len(occ)
            self.centroids = None
            lab = base[roster]
        labels_full = np.full(cfg.total_clients, -1, np.int64)
        labels_full[roster] = lab
        self._rebuild_structures(labels_full)
        self.opt = adamw(cfg.lr)
        self.s_opt = adamw(cfg.student_lr)
        self.t_model = make_model(ds.name, student=False)
        self.s_model = make_model(ds.name, student=True)
        self._setup_engine()

    def _rebuild_structures(self, labels_full) -> None:
        """Cluster membership, leaders, compact->teacher-row map and a fresh
        ``RoundScheduler`` from the (C,) label array."""
        cfg = self.cfg
        self.labels = np.asarray(labels_full)
        occ = np.unique(self.labels[self.labels >= 0])
        self.cluster_ids = occ.astype(np.int64)
        self.clusters = [np.flatnonzero(self.labels == c) for c in occ]
        # leader (teacher host) = most-data client in the cluster
        sizes = self.shards.sizes
        self.leaders = [int(c[np.argmax(sizes[c])]) for c in self.clusters]
        self.scheduler = schedule.RoundScheduler(
            self.labels, participation=cfg.participation,
            clients_per_round=self.clamped_clients_per_round(cfg, self.labels),
            pack=cfg.pack, n_devices=None, waves=None,
            weighting=cfg.cluster_weighting, dropout_rate=cfg.dropout_rate,
            seed=cfg.seed)

    def _setup_engine(self):
        raise NotImplementedError

    def history_extras(self):
        return {"num_clusters": len(self.clusters)}


class LoopClusteredKD(_ClusteredKDBase):
    """Sequential reference: Alg. 1 phases 3-4 as a per-client Python loop."""

    engine = "loop"

    def _init_student(self) -> dict:
        return self.s_model[0](rng.fold_seed(self.seed), self.device)

    def _init_teacher(self, k: int) -> dict:
        return self.t_model[0](rng.fold_seed(self.seed, 100 + k), self.device)

    def _setup_engine(self):
        cfg = self.cfg
        t_fwd, s_fwd = self.t_model[1], self.s_model[1]
        self.teacher_steps = make_steps(t_fwd, self.opt, prox_mu=cfg.prox_mu)
        self.student_steps = make_steps(
            s_fwd, self.s_opt, kd_temperature=cfg.kd_temperature,
            kd_alpha=cfg.kd_alpha)
        # the reference loss, as in the JAX loop engine (fused=False)
        self.distill_step = self.student_steps["make_distill"](t_fwd)
        self.global_student = self._init_student()
        self.teachers = [self._init_teacher(k) for k in range(self.K0)]
        self.t_opts = [self.opt.init(t) for t in self.teachers]
        self._x_test = torch.from_numpy(self.ds.x_test).to(self.device)
        self._y_test = torch.from_numpy(self.ds.y_test).to(self.device)

    def _teacher_shards(self, ci, members=None):
        # "cluster" mode pools the round's SAMPLED members only (None = all,
        # for warm-up); "leader" trains on the leader's own shard
        if self.cfg.teacher_data == "cluster":
            sel = self.clusters[ci] if members is None else members
            return [self.shards[i] for i in sel]
        return [self.shards[self.leaders[ci]]]

    def warmup(self):
        cfg = self.cfg
        if not cfg.teacher_warmup_epochs:
            return
        # KD establishment phase (pre-round teacher warm-up, Alg. 1)
        for ci in range(len(self.clusters)):
            t = int(self.cluster_ids[ci])
            self.teachers[t], self.t_opts[t] = cluster_epochs(
                self._teacher_shards(ci), self.teachers[t], self.t_opts[t],
                rng.fold_seed(self.seed, 9000 + ci), cfg,
                step_fn=self.teacher_steps["ce"],
                epochs=cfg.teacher_warmup_epochs)

    def run_round(self, plan, rnd):
        cfg = self.cfg
        part = set(int(i) for i in plan.participants)
        weight_of = plan.weight_of()
        new_params, weights = [], []
        for ci, members in enumerate(self.clusters):
            sel = [i for i in members if int(i) in part]
            if not sel:
                continue           # no sampled member: teacher untouched
            t = int(self.cluster_ids[ci])
            # Alg.1 line 12: the teacher trains on (sampled) cluster data
            self.teachers[t], self.t_opts[t] = cluster_epochs(
                self._teacher_shards(ci, sel), self.teachers[t],
                self.t_opts[t], rng.fold_seed(self.seed, rnd * 1000 + ci),
                cfg, step_fn=self.teacher_steps["ce"], epochs=cfg.local_epochs)
            for i in sel:
                sp = tree_copy(self.global_student)
                so = self.s_opt.init(sp)
                sp, _ = local_epochs(
                    self.shards[i], sp, so,
                    rng.fold_seed(self.seed, rnd * 1000 + 500 + int(i)), cfg,
                    step_fn=self.distill_step, extra=(self.teachers[t],))
                new_params.append(sp)
                weights.append(weight_of[int(i)])
        if new_params:
            # the plan's weights ARE the two-level FedSiKD mean, extended
            # unbiasedly to the sampled subset (schedule.RoundPlan docstring)
            self.global_student = agg.weighted_average(new_params, weights)
        # else: every invited client dropped out — a no-op round
        return {}

    def eval(self):
        return evaluate(self.student_steps["eval"], self.global_student,
                        self._x_test, self._y_test)
