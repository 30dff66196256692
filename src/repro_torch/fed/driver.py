"""RoundDriver: the federated round skeleton of the port (the port of
``repro.fed.driver`` for the loop engine, and for checkpoints on both
engines).

It owns, for every algorithm:

- the per-round ``RoundPlan`` (participation sampling + dropout);
- the client lifecycle (``fed/lifecycle.py``): on an event round the
  strategy gets the new roster (``Algorithm.apply_lifecycle``) before the
  round is planned, and the history's ``labels_history`` records each
  re-clustering as ``[round, labels]``;
- eval/record after every round and the running history, in the JAX
  package's schema: ``acc``, ``loss``, ``round``, ``participants``,
  ``algorithm``, ``engine``, ``participation``, ``dropout_rate``, the
  strategy's ``history_extras`` and its round-aligned per-round metrics.
  The port adds one per-round list, ``round_seconds``: the host wall time
  of the round's lifecycle event, training, merge and eval (not its
  checkpoint, which holds the history up to that round), which ends in a
  device-to-host copy and so includes the device's work.
  A round that ``setup`` consumes (``Algorithm.setup_rounds``: FL+HC's
  clustering pre-round) counts the whole of ``setup`` and its eval;
- checkpoint/save/resume (``fed/fedstate.py``): the save cadence, the
  restore, the fingerprint check and the skipped warm-up of a resumed run.
  A resumed run repeats the uninterrupted one, across a re-clustering
  boundary too (lifecycle events replay from (seed, round); the evolved
  labels and centroids ride the checkpoint);
- the bounded-staleness buffer of semi-async rounds (``cfg.async_mode``):
  the stragglers' updates wait in the one ``StalenessBuffer``; before each
  round the driver pops those arriving, and the strategy merges them under
  the decayed weights of ``core.aggregation.staleness_weights`` if their
  staleness is at most ``cfg.max_staleness`` (the rest are dropped and
  counted).  Buffer contents ride the checkpoint: the params as the
  ``_async_buffer`` list beside the strategy's arrays, the records in the
  meta JSON.

The checkpoint holds what the JAX package's holds, under the same keys and
in its layouts (``repro_torch.convert``), and the fingerprint has the same
keys and values, so a run of either package resumes the other's
checkpoint.  ``round_seconds``, which a JAX history lacks, is padded with
``None`` for the rounds a resumed run did not time.
"""
from __future__ import annotations

import dataclasses
import time
from typing import Any

from repro_torch import convert
from repro_torch.data.pipeline import ClientStore, make_client_shards
from repro_torch.fed import fedstate
from repro_torch.fed.lifecycle import ClientLifecycle

# History keys the driver appends itself (or that are not one entry a
# round); every other list-valued key is a per-round metric kept
# round-aligned by _append_metrics.
_NON_METRIC_KEYS = frozenset({"acc", "loss", "round", "participants",
                              "labels_history", "round_seconds"})

# The JAX package's fingerprint schema version: a checkpoint of another
# schema refuses to resume.
FINGERPRINT_VERSION = 4

# FedConfig fields that are not part of the resume identity: execution
# knobs that change no computed value.  Every FedConfig field is either
# fingerprinted or listed here (tests/test_torch_ckpt.py).
EXECUTION_ONLY = frozenset({
    "rounds", "ckpt_dir", "ckpt_every", "ckpt_keep", "resume",
    "donate", "prefetch", "async_ckpt", "guards",
})


@dataclasses.dataclass
class AsyncUpdate:
    """One client update in flight between rounds: computed against round
    ``birth``'s global model, merged at ``arrival``.  ``weight`` is its
    birth-round base weight (the plan weight for the clustered-KD
    strategies, the example count for the baselines).  ``params is None``
    marks a tombstone: an update known at push time to exceed
    ``max_staleness``, whose params are never kept but whose arrival round
    still counts the drop."""

    client: int
    birth: int
    arrival: int
    weight: float
    params: Any = None

    @property
    def staleness(self) -> int:
        return self.arrival - self.birth


class StalenessBuffer:
    """The driver's bounded-staleness buffer: strategies ``push`` straggler
    updates at their birth round; ``pop_due`` hands back those whose
    arrival round has come, as mergeable arrivals and a count of dropped
    ones.  An entry with ``staleness > max_staleness`` is tombstoned at push
    time (its params discarded)."""

    def __init__(self, max_staleness: int):
        if max_staleness < 0:
            raise ValueError(
                f"max_staleness must be >= 0, got {max_staleness}")
        self.max_staleness = max_staleness
        self.entries: list[AsyncUpdate] = []

    def __len__(self) -> int:
        return len(self.entries)

    def push(self, update: AsyncUpdate) -> None:
        if update.staleness > self.max_staleness:
            update = dataclasses.replace(update, params=None)
        self.entries.append(update)

    def pop_due(self, round_index: int) -> tuple[list[AsyncUpdate], int]:
        """(arrivals to merge this round, number dropped as too stale)."""
        due = [u for u in self.entries if u.arrival <= round_index]
        self.entries = [u for u in self.entries if u.arrival > round_index]
        arrivals = [u for u in due if u.params is not None]
        return arrivals, len(due) - len(arrivals)

    # ------------------------------------------------- checkpoint plumbing
    def meta(self) -> list[dict]:
        """JSON-safe entry records, in buffer order (the meta JSON)."""
        return [{"client": int(u.client), "birth": int(u.birth),
                 "arrival": int(u.arrival), "weight": float(u.weight),
                 "has_params": u.params is not None}
                for u in self.entries]

    def params_list(self) -> list:
        """Params of the entries that are not tombstones, in buffer order
        (the checkpoint's ``_async_buffer``)."""
        return [u.params for u in self.entries if u.params is not None]

    def load(self, meta: list[dict], params: list) -> None:
        """Rebuild the buffer from a checkpoint's (records, params)."""
        it = iter(params)
        self.entries = [
            AsyncUpdate(client=int(e["client"]), birth=int(e["birth"]),
                        arrival=int(e["arrival"]), weight=float(e["weight"]),
                        params=next(it) if e["has_params"] else None)
            for e in meta]


def fingerprint(cfg, labels=None) -> dict:
    """Run identity stored with every checkpoint and checked on resume:
    every config field whose change would make the resumed tail a different
    run, with the JAX package's keys and values.  ``labels`` (the INITIAL
    cluster assignment) is recomputed at start-up, so comparing it also
    catches silent data or config drift; labels evolved by re-clustering
    ride the checkpoint's arrays."""
    fp = {"fingerprint_version": FINGERPRINT_VERSION,
          "algorithm": cfg.algorithm, "engine": cfg.engine,
          "seed": cfg.seed, "num_clients": cfg.num_clients,
          "alpha": cfg.alpha, "num_clusters": cfg.num_clusters,
          "participation": cfg.participation,
          "clients_per_round": cfg.clients_per_round,
          "dropout_rate": cfg.dropout_rate,
          "pack": cfg.pack, "universe": cfg.universe,
          "n_devices": cfg.n_devices, "waves": cfg.waves,
          "join_schedule": cfg.join_schedule, "leave_rate": cfg.leave_rate,
          "recluster_every": cfg.recluster_every,
          "local_epochs": cfg.local_epochs, "batch_size": cfg.batch_size,
          "lr": cfg.lr, "student_lr": cfg.student_lr,
          "kd_temperature": cfg.kd_temperature, "kd_alpha": cfg.kd_alpha,
          "kd_impl": cfg.kd_impl, "prox_mu": cfg.prox_mu,
          "teacher_warmup_epochs": cfg.teacher_warmup_epochs,
          "teacher_data": cfg.teacher_data,
          "cluster_weighting": cfg.cluster_weighting,
          "dp_noise": cfg.dp_noise,
          "async_mode": cfg.async_mode, "max_staleness": cfg.max_staleness,
          "staleness_decay": cfg.staleness_decay,
          "round_deadline": cfg.round_deadline,
          "straggler_frac": cfg.straggler_frac,
          "latency_dist": cfg.latency_dist}
    if cfg.num_clusters is None:
        # with metric-voted K the sweep bounds decide the cluster count
        fp["k_range"] = cfg.k_range
    if labels is not None:
        fp["labels"] = [int(l) for l in labels]
    return fp


class RoundDriver:
    """Runs ``cfg.rounds`` federated rounds of one Algorithm strategy."""

    def __init__(self, ds, cfg, algorithm, *, device, progress: bool = False):
        self.ds, self.cfg, self.alg = ds, cfg, algorithm
        self.device = device
        self.progress = progress
        self.buffer: StalenessBuffer | None = None
        self.writer: fedstate.AsyncCheckpointWriter | None = None

    def run(self) -> dict:
        ds, cfg, alg = self.ds, self.cfg, self.alg
        alg.progress = self.progress
        shards = ClientStore(
            make_client_shards(ds, cfg.num_clients, cfg.alpha, seed=cfg.seed),
            universe=cfg.universe)
        lc = ClientLifecycle.from_config(cfg)
        alg.lifecycle = lc
        t_setup = time.perf_counter()
        alg.setup(ds, shards, cfg, cfg.seed, device=self.device)
        if cfg.async_mode:
            self.buffer = StalenessBuffer(cfg.max_staleness)
        alg.buffer = self.buffer
        fp = fingerprint(cfg, labels=alg.labels)

        history = {"acc": [], "loss": [], "round": [], "participants": [],
                   "algorithm": cfg.algorithm, "engine": cfg.engine,
                   "participation": cfg.participation,
                   "dropout_rate": cfg.dropout_rate, "round_seconds": []}
        if lc is not None and alg.labels is not None:
            history["labels_history"] = [[0, [int(l) for l in alg.labels]]]
        history.update(alg.history_extras())

        # resume-or-warmup: a checkpoint's state already holds the
        # establishment work (warm-up, pre-round), so a resumed run skips it
        if (cfg.resume and cfg.ckpt_dir
                and fedstate.latest_round(cfg.ckpt_dir) is not None):
            start_round = self._resume(history, fp)
        else:
            alg.warmup()
            # rounds consumed by setup itself (FL+HC's clustering pre-round
            # trains every client and IS the run's round 1)
            start_round = min(alg.setup_rounds, cfg.rounds)
            for rnd in range(1, start_round + 1):
                history["participants"].append(cfg.num_clients)
                self._record(history, rnd)
                history["round_seconds"].append(time.perf_counter() - t_setup)
                self._save(history, fp, rnd)

        if cfg.ckpt_dir and cfg.async_ckpt:
            self.writer = fedstate.AsyncCheckpointWriter(
                cfg.ckpt_dir, keep_last=cfg.ckpt_keep)
        try:
            for rnd in range(start_round + 1, cfg.rounds + 1):
                t0 = time.perf_counter()
                metrics = {}
                if lc is not None:
                    ev = lc.event(rnd)
                    if ev.recluster:
                        metrics.update(alg.apply_lifecycle(ev) or {})
                        if alg.labels is not None:
                            history["labels_history"].append(
                                [rnd, [int(l) for l in alg.labels]])
                        if self.progress and ev.changed:
                            print(f"  round {rnd:3d}  lifecycle: "
                                  f"+{len(ev.joins)} joined, "
                                  f"-{len(ev.leaves)} left, "
                                  f"{int(ev.active.sum())} active")
                plan = alg.scheduler.plan(rnd)
                if cfg.prefetch and rnd < cfg.rounds and (
                        lc is None or not lc.event(rnd + 1).recluster):
                    # stage round N+1's slot data while round N computes
                    # (plans are pure functions of (seed, round); an event
                    # round's plan exists only after apply_lifecycle)
                    alg.prefetch(alg.scheduler.plan(rnd + 1))
                if self.buffer is not None:
                    arrivals, dropped = self.buffer.pop_due(rnd)
                    alg.arrivals = tuple(arrivals)
                    metrics.update(alg.run_round(plan, rnd))
                    alg.arrivals = ()
                    metrics["stragglers"] = int(plan.stragglers.sum())
                    metrics["stale_merged"] = len(arrivals)
                    metrics["stale_dropped"] = dropped
                    metrics["buffered"] = len(self.buffer)
                else:
                    metrics.update(alg.run_round(plan, rnd))
                self._append_metrics(history, metrics)
                history["participants"].append(int(plan.active.sum()))
                self._record(history, rnd)
                history["round_seconds"].append(time.perf_counter() - t0)
                self._save(history, fp, rnd)
        finally:
            if self.writer is not None:
                # drain pending writes and raise a writer error, on an
                # exception too: a killed run leaves only complete
                # checkpoints behind
                writer, self.writer = self.writer, None
                writer.close()
        return history

    # ------------------------------------------------------------ internals
    def _resume(self, history, fp) -> int:
        """Restore the latest checkpoint into the strategy, the buffer and
        the history; returns the round it was taken after."""
        cfg, alg = self.cfg, self.alg
        like = alg.checkpoint_arrays()
        if self.buffer is not None:
            # the template's buffer length comes from the checkpoint's own
            # records (each live entry is a copy of the global model)
            n_live = sum(1 for e in fedstate.latest_meta(cfg.ckpt_dir).get(
                "buffer", []) if e.get("has_params"))
            like["_async_buffer"] = [like["student"]] * n_live
        st = fedstate.restore_run(cfg.ckpt_dir, like, expect_meta=fp)
        buf_params = st.arrays.pop("_async_buffer", [])
        alg.restore_arrays(st.arrays)
        if self.buffer is not None:
            self.buffer.load(st.buffer_meta, [
                convert.params_from_jax(p, device=self.device)
                for p in buf_params])
        history.update(st.history)
        # a JAX history has no round_seconds: None for the untimed rounds
        secs = history.setdefault("round_seconds", [])
        secs.extend([None] * (len(history["round"]) - len(secs)))
        if self.progress:
            print(f"  resumed from round {st.round_index} ({cfg.ckpt_dir})")
        return st.round_index

    def _append_metrics(self, history, metrics):
        """Append this round's metrics, keeping every per-round metric list
        the same length: a metric a strategy emits only in SOME rounds gets
        explicit ``None`` entries for the others."""
        # run_round records so far = recorded rounds minus setup's own
        # evals (FL+HC's clustering pre-round never calls run_round)
        n_prev = max(0, len(history["round"])
                     - min(self.alg.setup_rounds, self.cfg.rounds))
        keys = set(metrics) | {k for k, v in history.items()
                               if k not in _NON_METRIC_KEYS
                               and isinstance(v, list)}
        for k in sorted(keys):
            lst = history.setdefault(k, [])
            if len(lst) < n_prev:
                lst.extend([None] * (n_prev - len(lst)))
            lst.append(metrics.get(k))

    def _record(self, history, rnd):
        acc, loss = self.alg.eval()
        history["acc"].append(acc)
        history["loss"].append(loss)
        history["round"].append(rnd)
        if self.progress:
            print(f"  round {rnd:3d}  acc={acc:.4f}  loss={loss:.4f}  "
                  f"clients={history['participants'][-1]}")

    def _save(self, history, fp, rnd):
        cfg = self.cfg
        if cfg.ckpt_dir and (rnd % cfg.ckpt_every == 0 or rnd == cfg.rounds):
            arrays = self.alg.checkpoint_arrays()
            buffer_meta = []
            if self.buffer is not None:
                # in-flight updates cross the round boundary too: params in
                # the arrays (the JAX layout), records in the meta JSON
                arrays["_async_buffer"] = [
                    convert.params_to_jax(p) for p in self.buffer.params_list()]
                buffer_meta = self.buffer.meta()
            state = fedstate.FedState(
                round_index=rnd, arrays=arrays, history=history, meta=fp,
                buffer_meta=buffer_meta)
            if self.writer is not None:
                # the device-to-host copy and the npz write run on the
                # writer's thread; submit copies the JSON members
                self.writer.submit(state)
            else:
                fedstate.save_round(cfg.ckpt_dir, state,
                                    keep_last=cfg.ckpt_keep)
