"""Clustered-KD strategies: FedSiKD (Alg. 1) and the RandomCluster
ablation on both engines — the port of ``stat_features``,
``_ClusteredKDBase``, ``LoopClusteredKD`` and ``ShardedClusteredKD`` (one
wave, synchronous rounds) of ``repro.fed.algorithms.clustered_kd``.

``LoopClusteredKD`` is the sequential per-client reference: per round, each
cluster's teacher trains on its leader's shard (or the sampled cluster
members', ``teacher_data="cluster"``), then every sampled member distils a
copy of the global student from its cluster's teacher, and the plan-weighted
merge of the members' students (one fused-merge kernel launch a round on
CUDA) becomes the new global student.  Random streams are integer seeds
folded exactly where the JAX code folds its keys (``repro_torch.rng``).

Runtime features of the loop engine:

- client lifecycle: ``apply_lifecycle`` re-clusters the active roster with
  ``kmeans_warm`` from the previous centroids, in the feature space
  standardised once over the initial roster; K stays fixed, and each new
  cluster takes the teacher (and its Adam state) of the nearest previously
  occupied centroid.  Two clusters may then share one teacher's tensors,
  which is safe because every update is functional (``optim``'s
  ``apply_updates`` makes new tensors; nothing is changed in place);
- semi-async rounds: a straggler's distilled student goes to the driver's
  buffer at its birth round, and each round merges the on-time students
  with the arrivals under staleness-decayed weights in one fused merge;
  teachers stay synchronous (edge-hosted);
- DP noise on the shared statistics (``cfg.dp_noise``): each client's
  draws come from its own generator, (seed + 17, client id).

``ShardedClusteredKD`` runs the same phases as lanes of one stacked program
per round (``fed/sharded.py``): per-cluster teacher replicas on every
participating slot, their sync, the students' distillation steps with the
fused KD kernels for all lanes at once, and the plan-weighted merge.

Both engines checkpoint the JAX package's arrays: the global student, the
teachers and their Adam states (a list on the loop engine, ``(K, ...)``
stacks on the packed one), the current labels and, for FedSiKD, the
centroids.
"""
from __future__ import annotations

import numpy as np
import torch

from repro_torch import convert, rng
from repro_torch.core import aggregation as agg
from repro_torch.core import kmeans, stats
from repro_torch.data.pipeline import ClientStore
from repro_torch.fed import schedule
from repro_torch.fed import sharded as sh
from repro_torch.fed.algorithms.base import (Algorithm, cluster_epochs,
                                             local_epochs, staleness_merge,
                                             tree_copy)
from repro_torch.fed.client import evaluate, make_steps
from repro_torch.fed.driver import AsyncUpdate
from repro_torch.models.cnn import make_lane_dropout, make_model
from repro_torch.optim import adamw
from repro_torch.tree import tree_map


def stat_features(shards, cfg, roster=None, *, device="cpu"):
    """Alg. 1 phase 1, batched: the (R, 3F) raw statistics matrix for the
    ``roster`` clients (global ids; None = everyone) in one segment-sum
    pass, DP-noised when ``cfg.dp_noise > 0``.  A client's noise is drawn
    from (seed + 17, its global id), so it is the same whenever it joins
    and however often the server re-clusters."""
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
    if cfg.dp_noise > 0:
        noise = stats.dp_noise_draws(cfg.seed + 17, roster, mean.shape[1],
                                     device=device)
        mean, std, skew = stats.privatize_batched(
            mean, std, skew, noise_multiplier=cfg.dp_noise, noise=noise)
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
            self._base_labels = base
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
            pack=cfg.pack, n_devices=cfg.n_devices, waves=cfg.waves,
            weighting=cfg.cluster_weighting, dropout_rate=cfg.dropout_rate,
            seed=cfg.seed, async_mode=cfg.async_mode,
            round_deadline=cfg.round_deadline,
            straggler_frac=cfg.straggler_frac,
            latency_dist=cfg.latency_dist)

    def apply_lifecycle(self, event):
        cfg = self.cfg
        old_labels = self.labels
        roster = np.flatnonzero(event.active)
        migrate = np.arange(self.K0)
        if cfg.algorithm == "fedsikd":
            raw = stat_features(self.shards, cfg, roster, device=self.device)
            feats = stats.apply_standardize(raw, self._feat_mu, self._feat_sd)
            res = kmeans.kmeans_warm(
                feats, torch.as_tensor(self.centroids, device=self.device))
            new_cent = res.centroids.cpu().numpy()
            lab = res.assignments.cpu().numpy().astype(np.int64)
            # teacher migration: cluster j starts from the teacher of the
            # nearest previously OCCUPIED centroid (itself, for clusters
            # that merely drifted)
            occupied_old = np.unique(old_labels[old_labels >= 0])
            d = ((new_cent[:, None, :] - self.centroids[None, :, :]) ** 2
                 ).sum(-1)
            penalty = np.full(self.K0, np.inf)
            penalty[occupied_old] = 0.0
            migrate = np.argmin(d + penalty[None, :], axis=1)
            self._migrate_teachers(migrate)
            self.centroids = new_cent
        else:                          # random baseline: labels are sticky
            lab = self._base_labels[roster]
        labels_full = np.full(cfg.num_clients, -1, np.int64)
        labels_full[roster] = lab
        both = (old_labels >= 0) & (labels_full >= 0)
        shift = (float(np.mean(old_labels[both] != labels_full[both]))
                 if both.any() else 0.0)
        self._rebuild_structures(labels_full)
        return {"recluster": 1.0, "cluster_shift": shift,
                "active_clients": float(event.active.sum()),
                "migrated_teachers": float(
                    int((migrate != np.arange(self.K0)).sum()))}

    def _setup_engine(self):
        raise NotImplementedError

    def _migrate_teachers(self, migrate: np.ndarray) -> None:
        raise NotImplementedError

    def _labels_and_centroids(self) -> dict:
        """The checkpoint's labels (int32) and, for FedSiKD, centroids."""
        arrs = {"labels": torch.as_tensor(self.labels.astype(np.int32))}
        if self.centroids is not None:
            arrs["centroids"] = torch.as_tensor(
                np.asarray(self.centroids, np.float32))
        return arrs

    def _restore_labels(self, arrays) -> None:
        if "centroids" in arrays:
            self.centroids = arrays["centroids"].numpy()
        self._rebuild_structures(arrays["labels"].numpy())

    def _init_student(self) -> dict:
        return self.s_model[0](rng.fold_seed(self.seed), self.device)

    def _init_teacher(self, k: int) -> dict:
        return self.t_model[0](rng.fold_seed(self.seed, 100 + k), self.device)

    def history_extras(self):
        return {"num_clusters": len(self.clusters)}


class LoopClusteredKD(_ClusteredKDBase):
    """Sequential reference: Alg. 1 phases 3-4 as a per-client Python loop."""

    engine = "loop"

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

    def _migrate_teachers(self, migrate):
        if np.array_equal(migrate, np.arange(self.K0)):
            return
        # rows may share one teacher's tensors: safe, as no update is in
        # place
        self.teachers = [self.teachers[int(m)] for m in migrate]
        self.t_opts = [self.t_opts[int(m)] for m in migrate]

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
            self.teachers[t], self.t_opts[t], _ = cluster_epochs(
                self._teacher_shards(ci), self.teachers[t], self.t_opts[t],
                rng.fold_seed(self.seed, 9000 + ci), cfg,
                step_fn=self.teacher_steps["ce"],
                epochs=cfg.teacher_warmup_epochs)

    def run_round(self, plan, rnd):
        cfg = self.cfg
        part = set(int(i) for i in plan.participants)
        weight_of = plan.weight_of()
        delay_of = plan.delay_of()
        new_params, weights, t_losses, s_losses = [], [], [], []
        for ci, members in enumerate(self.clusters):
            sel = [i for i in members if int(i) in part]
            if not sel:
                continue           # no sampled member: teacher untouched
            t = int(self.cluster_ids[ci])
            # Alg.1 line 12: the teacher trains on (sampled) cluster data;
            # teachers are edge-hosted, so they stay synchronous even when a
            # member's student update straggles
            self.teachers[t], self.t_opts[t], t_loss = cluster_epochs(
                self._teacher_shards(ci, sel), self.teachers[t],
                self.t_opts[t], rng.fold_seed(self.seed, rnd * 1000 + ci),
                cfg, step_fn=self.teacher_steps["ce"], epochs=cfg.local_epochs)
            t_losses += [t_loss] * len(sel)
            for i in sel:
                sp = tree_copy(self.global_student)
                so = self.s_opt.init(sp)
                sp, _, s_loss = local_epochs(
                    self.shards[i], sp, so,
                    rng.fold_seed(self.seed, rnd * 1000 + 500 + int(i)), cfg,
                    step_fn=self.distill_step, extra=(self.teachers[t],))
                s_losses.append(s_loss)
                d = delay_of[int(i)]
                if d > 0:          # straggler: update lands d rounds late
                    self.buffer.push(AsyncUpdate(
                        client=int(i), birth=rnd, arrival=rnd + d,
                        weight=weight_of[int(i)], params=sp))
                else:
                    new_params.append(sp)
                    weights.append(weight_of[int(i)])
        if self.arrivals or plan.stragglers.any():
            # semi-async merge: on-time students and buffered arrivals under
            # the staleness-decayed, renormalised weights
            if new_params or self.arrivals:
                self.global_student = staleness_merge(
                    new_params, weights, self.arrivals, cfg.staleness_decay)
        elif new_params:
            # the plan's weights ARE the two-level FedSiKD mean, extended
            # unbiasedly to the sampled subset (schedule.RoundPlan docstring)
            self.global_student = agg.weighted_average(new_params, weights)
        if not s_losses:
            # every invited client dropped out — a no-op round
            return {"teacher_loss": 0.0, "student_loss": 0.0}
        # means over the trained clients, each client counting its cluster
        # teacher's loss, as the packed engine's means over its active
        # slots; the round's one host sync of the losses
        t_loss, s_loss = torch.stack([torch.stack(t_losses).mean(),
                                      torch.stack(s_losses).mean()]).tolist()
        return {"teacher_loss": t_loss, "student_loss": s_loss}

    def eval(self):
        return evaluate(self.student_steps["eval"], self.global_student,
                        self._x_test, self._y_test)

    def checkpoint_arrays(self):
        return {"student": convert.params_to_jax(self.global_student),
                "teachers": [convert.params_to_jax(t) for t in self.teachers],
                "t_opts": [convert.adam_to_jax(o) for o in self.t_opts],
                **self._labels_and_centroids()}

    def restore_arrays(self, arrays):
        dev = self.device
        self.global_student = convert.params_from_jax(arrays["student"],
                                                      device=dev)
        self.teachers = [convert.params_from_jax(t, device=dev)
                         for t in arrays["teachers"]]
        self.t_opts = [convert.adam_from_jax(o, device=dev)
                       for o in arrays["t_opts"]]
        self._restore_labels(arrays)

    def history_extras(self):
        return {**super().history_extras(), "teacher_loss": [],
                "student_loss": []}


# ------------------------------------------------------------- packed engine
class ShardedClusteredKD(_ClusteredKDBase):
    """Alg. 1 on the packed engine: the round's ``S`` slots are lanes of one
    stacked program on the card (``fed/sharded.py``).

    Canonical state lives per CLUSTER between rounds (teachers and their
    Adam states: ``(K, ...)`` stacks; the student: one global dict).  Each
    round gathers it onto the plan's slots, runs the round program, and
    scatters the refreshed teachers back from each cluster's first active
    slot; a cluster with no sampled member keeps its teacher untouched,
    exactly like the loop engine skipping it.

    On one card every slot lives on the one device: ``pack`` (with
    ``n_devices``) sets only the slot count and numbering and changes no
    result.  ``donate`` has no effect: the slot tensors are rebuilt from the
    canonical state every round, as in JAX, and nothing is updated in
    place.  One wave per round and synchronous merges only; the rest raises
    in ``rounds.unported_knobs``."""

    engine = "sharded"

    def _init_teacher_stack(self) -> dict:
        teachers = [self._init_teacher(k) for k in range(self.K)]
        return {name: torch.stack([t[name] for t in teachers])
                for name in teachers[0]}

    def _setup_engine(self):
        cfg, store = self.cfg, self.shards
        if self.scheduler.n_waves != 1:
            raise NotImplementedError(
                "wave-scheduled rounds (more than one wave) are not ported "
                "to repro_torch yet (ROADMAP Queue 1 item 9)")
        self.S = self.scheduler.wave_slots
        self.K = self.K0
        t_fwd, s_fwd = self.t_model[1], self.s_model[1]
        self.tp_k = self._init_teacher_stack()
        self.ts_k = sh.stacked_opt_init(self.opt, self.tp_k)
        self.sp_global = self._init_student()
        self.student_steps = make_steps(
            s_fwd, self.s_opt, kd_temperature=cfg.kd_temperature,
            kd_alpha=cfg.kd_alpha)
        # static per-client step budgets (the loop engine's batch counts)
        # and the one-off (C, steps, B, ...) host staging of every shard
        self._base_counts = sh.client_step_counts(
            store.base, cfg.batch_size, cfg.local_epochs)
        self.s_steps_all = self._base_counts[store.row_of]
        self.sx_all, self.sy_all = sh.stack_client_data(
            store.base, int(self._base_counts.max()), cfg.batch_size,
            seed=cfg.seed)
        self._feed_of = None
        self._restage_teacher_feed()
        self.t_dropout = make_lane_dropout(self.ds.name, student=False)
        self.round_fn = sh.make_packed_kd_round(
            t_fwd, s_fwd, self.opt, self.s_opt,
            kd_temperature=cfg.kd_temperature, kd_alpha=cfg.kd_alpha,
            kd_impl=cfg.kd_impl, t_dropout=self.t_dropout,
            s_dropout=make_lane_dropout(self.ds.name, student=True))
        self._x_test = torch.from_numpy(self.ds.x_test).to(self.device)
        self._y_test = torch.from_numpy(self.ds.y_test).to(self.device)

    def _restage_teacher_feed(self):
        """Build the per-client teacher feed, its step budgets and the slot
        stager.  "leader" streams the cluster leader's shard to every slot
        of the cluster (identical batches keep the replicas in sync);
        "cluster" streams each client's own shard, which the teacher sync
        turns into data-parallel training over the union."""
        cfg, store = self.cfg, self.shards
        total = len(store)
        if cfg.teacher_data == "leader":
            cidx = self.scheduler.cluster_idx
            leaders = np.asarray(self.leaders, np.int64)
            feed_of = np.where(cidx >= 0, leaders[np.maximum(cidx, 0)],
                               np.arange(total))
        else:
            feed_of = np.arange(total)
        if self._feed_of is not None and np.array_equal(feed_of,
                                                        self._feed_of):
            return
        self._feed_of = feed_of
        self._t_map = store.row_of[feed_of]
        self.t_steps_all = self._base_counts[self._t_map]
        self.tx_all, self.ty_all = sh.stack_client_data(
            store.base, int(self.t_steps_all.max()), cfg.batch_size,
            seed=cfg.seed)
        self.stager = sh.WaveStager(
            self.tx_all, self.ty_all, self.sx_all, self.sy_all,
            device=self.device,
            row_maps=(self._t_map, self._t_map, store.row_of, store.row_of))

    # ------------------------------------------------- slot gather/scatter
    def _teacher_row(self, plan) -> np.ndarray:
        """(S,) teacher row hosted by each slot: the scheduler's compact
        cluster index mapped through ``cluster_ids`` (idle slots row 0)."""
        comp = np.where(plan.active, plan.slot_cluster, 0)
        return np.where(plan.active, self.cluster_ids[comp], 0)

    def _gather_teachers(self, kidx):
        """The (S, ...) teacher params and Adam states of the slots."""
        idx = torch.as_tensor(kidx, device=self.device)
        return (tree_map(lambda a: a[idx], self.tp_k),
                tree_map(lambda a: a[idx], self.ts_k))

    def _scatter_src(self, plan):
        """Scatter operands for ``_scatter``: which teacher rows the round
        refreshed (``refreshed``, (K,) bool) and the first active slot
        sourcing each (``safe``, (K,) int; untouched rows read slot 0 but
        are masked out)."""
        row = self._teacher_row(plan)
        src = np.full(self.K, -1, np.int64)
        for s in range(self.S - 1, -1, -1):
            if plan.slot_client[s] >= 0:
                src[row[s]] = s
        refreshed = src >= 0
        safe = np.where(refreshed, src, 0)
        return (torch.as_tensor(refreshed, device=self.device),
                torch.as_tensor(safe, device=self.device))

    def _scatter(self, tp_s, ts_s, plan):
        """Write the refreshed teacher rows back into the (K, ...) stacks."""
        refreshed, safe = self._scatter_src(plan)

        def upd(new, old):
            mask = refreshed.reshape((self.K,) + (1,) * (old.dim() - 1))
            return torch.where(mask, new[safe], old)

        self.tp_k = tree_map(upd, tp_s, self.tp_k)
        self.ts_k = tree_map(upd, ts_s, self.ts_k)

    def _student_keys(self, salt: int, plan) -> np.ndarray:
        """Per-slot student seeds, folded by client id (stable under slot
        re-assignment across rounds)."""
        return sh.slot_client_keys(rng.fold_seed(self.seed, salt), plan)

    def _teacher_keys(self, salt: int, plan) -> np.ndarray:
        """Teacher seeds.  Leader mode: the slots of a cluster share one
        stream, so replicas stepping on identical leader batches draw
        identical dropout masks.  Cluster mode: per-client streams, offset
        10_000 to stay apart from the student streams."""
        base = rng.fold_seed(self.seed, salt)
        if self.cfg.teacher_data == "leader":
            return sh.slot_cluster_keys(base, plan)
        return sh.slot_client_keys(base, plan, offset=10_000)

    # ---------------------------------------------------------------- rounds
    def warmup(self):
        """Alg. 1 KD establishment: teacher warm-up before round 1 as its own
        lane-stacked phase."""
        cfg = self.cfg
        if cfg.teacher_warmup_epochs <= 0:
            return
        w_steps_all = ((self.t_steps_all // max(cfg.local_epochs, 1))
                       * cfg.teacher_warmup_epochs).astype(np.int32)
        wx_all, wy_all = sh.stack_client_data(
            self.shards.base, int(w_steps_all.max()), cfg.batch_size,
            seed=cfg.seed)
        wp = self.scheduler.warmup_plan().wave(0)
        if not wp.active.any():
            return
        warm = sh.make_packed_teacher_phase(self.t_model[1], self.opt,
                                            lane_dropout=self.t_dropout)
        tp_s, ts_s = self._gather_teachers(self._teacher_row(wp))
        wx, wy = sh.stage_on_slots(wp, wx_all, wy_all, device=self.device,
                                   row_maps=(self._t_map, self._t_map))
        tp_s, ts_s, wl = warm(tp_s, ts_s, wx, wy, wp.steps_for(w_steps_all),
                              self._teacher_keys(9001, wp),
                              wp.sync_matrix())
        self._scatter(tp_s, ts_s, wp)
        if self.progress:
            print(f"  warmup  teacher_loss={float(wl):.4f}")

    def prefetch(self, plan):
        """Start staging the NEXT round's slot data while this round
        computes (plans are pure functions of (seed, round))."""
        if plan is not None and plan.active.any():
            self.stager.prefetch(plan.wave(0))

    def run_round(self, plan, rnd):
        if not plan.active.any():
            # every invited client dropped out: canonical state untouched
            return {"teacher_loss": 0.0, "student_loss": 0.0}
        wp = plan.wave(0)
        tx, ty, sx, sy = self.stager.stage(wp)
        tp_s, ts_s = self._gather_teachers(self._teacher_row(wp))
        sp_s = tree_map(lambda a: a.expand((self.S,) + a.shape),
                        self.sp_global)
        ss_s = sh.stacked_opt_init(self.s_opt, sp_s)   # fresh, as the loop
        # disjoint even/odd salts keep the teacher and student streams apart
        tp_s, ts_s, sp_s, _sp_local, _ss, t_loss, s_loss = self.round_fn(
            tp_s, ts_s, sp_s, ss_s, tx, ty, wp.steps_for(self.t_steps_all),
            sx, sy, wp.steps_for(self.s_steps_all),
            self._teacher_keys(2 * rnd, wp), self._student_keys(2 * rnd + 1,
                                                                wp),
            wp.sync_matrix(), plan.agg_row())
        self._scatter(tp_s, ts_s, wp)
        self.sp_global = {k: v[0] for k, v in sp_s.items()}
        # the round's one host sync
        t_loss, s_loss = torch.stack([t_loss, s_loss]).tolist()
        return {"teacher_loss": t_loss, "student_loss": s_loss}

    def eval(self):
        return evaluate(self.student_steps["eval"], self.sp_global,
                        self._x_test, self._y_test)

    def checkpoint_arrays(self):
        return {"student": convert.params_to_jax(self.sp_global),
                "teachers": convert.params_to_jax(self.tp_k, stacked=True),
                "t_opts": convert.adam_to_jax(self.ts_k, stacked=True),
                **self._labels_and_centroids()}

    def restore_arrays(self, arrays):
        dev = self.device
        self.sp_global = convert.params_from_jax(arrays["student"], device=dev)
        self.tp_k = convert.params_from_jax(arrays["teachers"], device=dev,
                                            stacked=True)
        self.ts_k = convert.adam_from_jax(arrays["t_opts"], device=dev,
                                          stacked=True)
        self._restore_labels(arrays)
        self._restage_teacher_feed()

    def history_extras(self):
        return {"num_clusters": self.K, "pack": self.scheduler.pack,
                "teacher_loss": [], "student_loss": []}
