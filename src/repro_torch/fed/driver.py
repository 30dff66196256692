"""RoundDriver: the federated round skeleton of the port (the loop-engine
part of ``repro.fed.driver.RoundDriver``).

It owns the per-round ``RoundPlan`` (participation sampling + dropout),
the eval/record after every round, and the running history, in the JAX
package's schema: ``acc``, ``loss``, ``round``, ``participants``,
``algorithm``, ``engine``, ``participation``, ``dropout_rate``, the
strategy's ``history_extras`` and its round-aligned per-round metrics.
The port adds one per-round list, ``round_seconds``: the host wall time of
the round's training, merge and eval, which ends in a device-to-host copy
and so includes the device's work.  A round that ``setup`` consumes
(``Algorithm.setup_rounds``: FL+HC's clustering pre-round) counts the
whole of ``setup`` and its eval.

Checkpoint/resume, the semi-async buffer, runtime guards and the client
lifecycle are not ported yet (``rounds.unported_knobs`` refuses them).
"""
from __future__ import annotations

import time

from repro_torch.data.pipeline import ClientStore, make_client_shards

# History keys the driver appends itself; every other list-valued key is a
# per-round metric kept round-aligned by _append_metrics.
_NON_METRIC_KEYS = frozenset({"acc", "loss", "round", "participants",
                              "round_seconds"})


class RoundDriver:
    """Runs ``cfg.rounds`` federated rounds of one Algorithm strategy."""

    def __init__(self, ds, cfg, algorithm, *, device, progress: bool = False):
        self.ds, self.cfg, self.alg = ds, cfg, algorithm
        self.device = device
        self.progress = progress

    def run(self) -> dict:
        ds, cfg, alg = self.ds, self.cfg, self.alg
        alg.progress = self.progress
        shards = ClientStore(
            make_client_shards(ds, cfg.num_clients, cfg.alpha, seed=cfg.seed),
            universe=cfg.universe)
        t_setup = time.perf_counter()
        alg.setup(ds, shards, cfg, cfg.seed, device=self.device)
        history = {"acc": [], "loss": [], "round": [], "participants": [],
                   "algorithm": cfg.algorithm, "engine": cfg.engine,
                   "participation": cfg.participation,
                   "dropout_rate": cfg.dropout_rate, "round_seconds": []}
        history.update(alg.history_extras())
        alg.warmup()
        # rounds consumed by setup itself (FL+HC's clustering pre-round
        # trains every client and IS the run's round 1)
        start_round = min(alg.setup_rounds, cfg.rounds)
        for rnd in range(1, start_round + 1):
            history["participants"].append(cfg.num_clients)
            self._record(history, rnd)
            history["round_seconds"].append(time.perf_counter() - t_setup)
        for rnd in range(start_round + 1, cfg.rounds + 1):
            t0 = time.perf_counter()
            plan = alg.scheduler.plan(rnd)
            if cfg.prefetch and rnd < cfg.rounds:
                # stage round N+1's slot data while round N computes (plans
                # are pure functions of (seed, round))
                alg.prefetch(alg.scheduler.plan(rnd + 1))
            metrics = alg.run_round(plan, rnd)
            self._append_metrics(history, metrics)
            history["participants"].append(int(plan.active.sum()))
            self._record(history, rnd)
            history["round_seconds"].append(time.perf_counter() - t0)
        return history

    def _append_metrics(self, history, metrics):
        """Append this round's metrics, keeping every per-round metric list
        the same length (``None`` where a strategy skipped a metric)."""
        n_prev = len(history["round"])
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
