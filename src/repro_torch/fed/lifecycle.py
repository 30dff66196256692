"""Client lifecycle: dynamic join/leave schedule + re-clustering cadence
(DESIGN.md §11).

The paper's clustering premise is incremental — "as clients join the system,
they securely share relevant statistics about their data distribution"
(§IV-A) — but a fixed-roster reproduction only ever clusters once.  This
module makes the roster a first-class, deterministic quantity:

- ``ClientLifecycle`` owns the arrival/departure schedule over a FIXED
  client universe of ``num_clients`` ids (their Dirichlet shards exist from
  the start; *joining* means the client comes online and its statistics
  become visible to the server).
- ``join_schedule`` is a tuple of ``(round, count)`` pairs: ``count``
  clients join at the START of that round.  Joiner ids are the TOP ids of
  the universe, dealt to events in round order, so the initial roster is
  ``[0, num_clients - total_joins)`` — deterministic with no RNG at all.
- ``leave_rate`` makes every active client independently leave for good at
  the start of each round with this probability, deterministically per
  ``(seed, round)`` on a PRNG stream disjoint from the sampling and dropout
  streams (salt 0x1F).  Leaving is permanent (dropout — ``dropout_rate`` —
  stays the transient, per-round failure).  A draw that would empty the
  roster is suppressed for that round.
- ``recluster_every`` adds a periodic re-clustering cadence on top of the
  event-driven one: ``event(r).recluster`` is True whenever membership
  changed at round ``r`` OR ``r`` is a multiple of ``recluster_every``.

``event(r)`` is a pure function of ``(schedule, seed, r)`` — the roster at
round r is replayed from round 1 (and cached), never carried as mutable
state — so a killed run resumed at any round sees the identical lifecycle,
which is what makes mid-lifecycle resume bit-identical
(tests/test_lifecycle.py, tests/test_fault_tolerance.py).

A verbatim copy of ``repro.fed.lifecycle``.  The port's round driver does
not run the lifecycle yet (the knobs raise ``NotImplementedError``); the
copy keeps ``FedConfig``'s validation of ``join_schedule`` whole.
"""
from __future__ import annotations

import dataclasses
from typing import Optional

import numpy as np


@dataclasses.dataclass(frozen=True)
class LifecycleEvent:
    """The roster change at the START of one round."""

    round_index: int
    joins: np.ndarray      # client ids joining this round (may be empty)
    leaves: np.ndarray     # client ids leaving for good this round
    active: np.ndarray     # (num_clients,) bool AFTER the event
    recluster: bool        # membership changed, or periodic cadence hit

    @property
    def changed(self) -> bool:
        return bool(len(self.joins) or len(self.leaves))


def normalize_join_schedule(join_schedule) -> Optional[tuple]:
    """Canonical ``((round, count), ...)`` sorted by round; accepts any
    iterable of pairs or a {round: count} mapping; None/empty -> None."""
    if not join_schedule:
        return None
    if isinstance(join_schedule, dict):
        pairs = list(join_schedule.items())
    else:
        pairs = [tuple(p) for p in join_schedule]
    out = []
    seen = set()
    for p in sorted(pairs):
        if len(p) != 2:
            raise ValueError(
                "join_schedule entries must be (round, count) pairs, "
                f"got {p!r}")
        r, c = int(p[0]), int(p[1])
        if r < 1:
            raise ValueError(
                "join_schedule rounds are 1-based (joins happen at the "
                f"start of the round), got round {r}")
        if c < 1:
            raise ValueError(f"join_schedule count must be >= 1, got {c}")
        if r in seen:
            raise ValueError(f"join_schedule has two entries for round {r}")
        seen.add(r)
        out.append((r, c))
    return tuple(out)


class ClientLifecycle:
    """Deterministic per-(seed, round) join/leave events over a fixed
    universe of ``num_clients`` client ids."""

    def __init__(self, num_clients: int, *, join_schedule=None,
                 leave_rate: float = 0.0, recluster_every: int = 0,
                 seed: int = 0):
        if num_clients < 1:
            raise ValueError(f"num_clients must be >= 1, got {num_clients}")
        if not 0.0 <= leave_rate < 1.0:
            raise ValueError(f"leave_rate must be in [0, 1), got {leave_rate}")
        if recluster_every < 0:
            raise ValueError(
                f"recluster_every must be >= 0, got {recluster_every}")
        self.num_clients = num_clients
        self.join_schedule = normalize_join_schedule(join_schedule)
        self.leave_rate = leave_rate
        self.recluster_every = recluster_every
        self.seed = seed
        total_joins = sum(c for _, c in self.join_schedule or ())
        if total_joins >= num_clients:
            raise ValueError(
                f"join_schedule brings in {total_joins} clients but the "
                f"universe has only {num_clients}; at least one client must "
                "be present from round 1")
        # joiner ids: the top ids of the universe, dealt in round order
        self._joins_at: dict[int, np.ndarray] = {}
        nxt = num_clients - total_joins
        for r, c in self.join_schedule or ():
            self._joins_at[r] = np.arange(nxt, nxt + c)
            nxt += c
        initial = np.zeros(num_clients, bool)
        initial[: num_clients - total_joins] = True
        self._active: list[np.ndarray] = [initial]   # index = rounds applied

    @classmethod
    def from_config(cls, cfg) -> Optional["ClientLifecycle"]:
        """A lifecycle for ``cfg``, or None when every lifecycle knob is off
        (the static-roster fast path: the driver skips the subsystem)."""
        if not cfg.lifecycle_enabled:
            return None
        return cls(cfg.num_clients, join_schedule=cfg.join_schedule,
                   leave_rate=cfg.leave_rate,
                   recluster_every=cfg.recluster_every, seed=cfg.seed)

    # ------------------------------------------------------------- queries
    def initial_active(self) -> np.ndarray:
        """(num_clients,) bool roster before round 1."""
        return self._active[0].copy()

    def active_at(self, round_index: int) -> np.ndarray:
        """Roster AFTER the events of ``round_index`` (0 = before round 1)."""
        self._replay_to(round_index)
        return self._active[round_index].copy()

    def event(self, round_index: int) -> LifecycleEvent:
        """The (deterministic) roster change at the start of this round."""
        if round_index < 1:
            raise ValueError(f"rounds are 1-based, got {round_index}")
        self._replay_to(round_index)
        prev = self._active[round_index - 1]
        cur = self._active[round_index]
        joins = np.flatnonzero(~prev & cur)
        leaves = np.flatnonzero(prev & ~cur)
        changed = bool(len(joins) or len(leaves))
        periodic = (self.recluster_every > 0
                    and round_index % self.recluster_every == 0)
        return LifecycleEvent(round_index=round_index, joins=joins,
                              leaves=leaves, active=cur.copy(),
                              recluster=changed or periodic)

    # ------------------------------------------------------------ internals
    def _replay_to(self, round_index: int) -> None:
        while len(self._active) <= round_index:
            r = len(self._active)
            cur = self._active[r - 1].copy()
            if self.leave_rate > 0.0:
                # disjoint stream: the 0x1F salt keeps permanent leaves away
                # from the sampling (plain), dropout (0xD0) and speed (0x5E)
                # streams of fed/schedule.py, so turning churn on never
                # reshuffles them (stream registry in schedule's docstring)
                from repro_torch.fed.schedule import SALT_LEAVE
                rng = np.random.default_rng(np.random.SeedSequence(
                    [self.seed & 0x7FFFFFFF, r, SALT_LEAVE]))
                ids = np.flatnonzero(cur)
                gone = ids[rng.random(len(ids)) < self.leave_rate]
                if len(gone) < len(ids):       # never empty the roster
                    cur[gone] = False
            joins = self._joins_at.get(r)
            if joins is not None:
                cur[joins] = True
            self._active.append(cur)
