"""Round scheduler: WHO trains each round, and WHERE on the mesh.

Real FL deployments sample a fraction of a huge client population per round
(partial participation is the default regime in the non-i.i.d. FL
literature), and the paper's clustered-KD structure adds a constraint of its
own: every cluster must keep teacher coverage, or its teacher goes stale.
This module turns participation into a first-class, engine-agnostic
quantity:

- ``RoundScheduler`` owns the participation policy (``full`` | ``uniform``
  | ``stratified``) and the packed mesh layout (``n_devices`` devices x
  ``pack`` client lanes per device = ``n_slots`` slots).
- ``RoundScheduler.plan(r)`` returns a ``RoundPlan``: the participating
  client subset for round ``r``, their slot assignment, their aggregation
  weights, and the slot-indexed collective operators (intra-cluster sync
  matrix, global aggregation row) the mesh engine contracts with.

Both round engines consume the same plan (``fed/rounds.py`` loop,
``fed/sharded.py`` packed mesh), so loop/sharded parity extends to sampled
rounds: the engines train the SAME clients with the SAME step budgets and
aggregate with the SAME weights.

Unbiased aggregation under sampling (DESIGN.md §8): the plan weights
combine the FULL-population cluster weight W_k (``uniform`` -> 1/K,
``size`` -> |C_k|/N, per Alg. 1 / §IV-C.5) with the per-round sampled
member count m_k: a slot hosting a member of cluster k aggregates with
weight W_k / m_k.  Since the within-cluster sample mean is an unbiased
estimator of the cluster mean, the expected aggregate equals the
full-participation aggregate whenever every cluster is represented —
which ``stratified`` sampling guarantees (>= 1 member per cluster, so no
cluster is ever teacher-less).  Under ``uniform`` sampling a cluster can
drop out of a round entirely; its weight is then renormalised over the
clusters present (documented bias, bounded by the dropout probability).

With ``participation="full"`` the plan collapses to today's semantics
exactly: slot i hosts client i, weights reproduce
``aggregation.hierarchical_average`` (``size`` -> flat 1/N, ``uniform`` ->
1/(K*|C_k|)).

Client dropout (``dropout_rate``): real deployments lose clients MID-ROUND
(stragglers, battery, network — a standing challenge in federated
distillation, arXiv:2404.08564 / arXiv:2211.04742).  After the
participation policy invites its subset, each invited client independently
fails with probability ``dropout_rate``, deterministically per
``(seed, round)`` on a PRNG stream disjoint from the sampling stream.  The
survivors flow through the SAME ``_build_plan`` weighting as sampling, so
the unbiasedness story extends to failures: surviving members of cluster k
aggregate with ``W_k / m_k`` (m_k = survivor count) and a cluster whose
invitees all failed is renormalised away exactly like an unsampled cluster
under ``uniform``.  Dropout can empty a round entirely; engines treat an
all-idle plan as a no-op round (state unchanged, metrics still recorded).
The warm-up plan never drops clients — the KD-establishment phase happens
before deployment failures are in scope.

Per-client speed model (``async_mode``, DESIGN.md §12): beside statistical
skew, production FL faces SYSTEM heterogeneity — slow devices whose updates
arrive rounds late (arXiv:2106.06843).  The scheduler models it
deterministically: each client has a persistent speed profile drawn
per-(seed, client) — with probability ``straggler_frac`` the client is a
straggler — and each round draws a latency per-(seed, round, client) on
the 0x5E speed stream (disjoint from sampling/dropout/lifecycle, so
turning the speed model on never reshuffles WHO trains).  Latency is in
units of the nominal round length: on-pace clients draw in (0, 1),
stragglers draw ``1 + excess`` with the excess from ``latency_dist``
(lognormal | exp | uniform).  The server's ``round_deadline`` then
partitions participants: ``delay = ceil(latency / deadline) - 1`` rounds —
``RoundPlan.slot_delay`` — with delay 0 arriving on time and delay ``d >=
1`` landing ``d`` rounds late (the driver's bounded-staleness buffer,
fed/driver.py).  A straggler still trains this round (the server cannot
stop it); only its update's ARRIVAL is late.  The warm-up plan carries no
delays — establishment happens before deployment timing is in scope.

PRNG stream registry (fold-constant collision guard,
tests/test_schedule.py): every scheduler stream is a ``SeedSequence`` over
``[seed, ...]`` with a distinct tail —

    sampling   [seed, round + 1]                  (legacy, unsalted)
    dropout    [seed, round + 1, 0xD0]
    leave      [seed, round, 0x1F]                (fed/lifecycle.py)
    latency    [seed, round + 1, 0x5E, client]
    profile    [seed, 0, 0x5E, client]            (round-free: slot 0)
    warm-up    [seed, 0, 0xA0, 0]

The warm-up stream HAD a collision: it reused ``_rng(0)`` — the sampling
stream of round 0 — so a warm-up stratified slice and a hypothetical
round-0 plan drew identical choices.  It now lives on its own salted
stream; the regression test asserts pairwise disjointness of all six
streams across an adversarial (seed, round, client) grid, including
values that equal the salts themselves.

A copy of ``repro.fed.schedule`` with ``fed_wave_layout`` inlined: plans
must match the JAX package's bit for bit, so both engines train the same
clients with the same weights.
"""
from __future__ import annotations

import dataclasses
import math
from typing import Optional, Sequence

import numpy as np

PARTICIPATION_MODES = ("full", "uniform", "stratified")
WEIGHTINGS = ("uniform", "size")
LATENCY_DISTS = ("lognormal", "exp", "uniform")

# PRNG stream salts (module docstring: the stream registry).  New streams
# MUST pick a fresh salt and keep the [seed, round-slot, salt, ...] shape —
# the disjointness regression test in tests/test_schedule.py guards it.
SALT_DROPOUT = 0xD0
SALT_LEAVE = 0x1F          # owned by fed/lifecycle.py
SALT_SPEED = 0x5E
SALT_WARMUP = 0xA0
SALT_BATCH = 0xB0          # owned by data/pipeline.py (per-epoch batch order)


def fed_wave_layout(n_participants: int, *, pack: int = 1,
                    n_devices: int | None = None,
                    waves: int | None = None) -> tuple[int, int, int]:
    """Wave-scheduled layout: ``(n_devices, wave_slots, n_waves)`` hosting
    ``n_participants`` clients by streaming them through a FIXED mesh of
    ``wave_slots = n_devices * pack`` slots in ``n_waves`` passes.

    A copy of ``repro.launch.mesh.fed_wave_layout`` (pure arithmetic; the
    JAX module also builds device meshes, so the port keeps its own copy).
    Defaults reproduce the single-wave layout: with ``n_devices=None`` and
    ``waves=None`` the mesh is sized for the whole cohort, ``n_waves == 1``.
    """
    if pack < 1:
        raise ValueError(f"pack must be >= 1, got {pack}")
    if waves is not None and waves < 1:
        raise ValueError(f"waves must be >= 1, got {waves}")
    if n_devices is not None and n_devices < 1:
        raise ValueError(f"n_devices must be >= 1, got {n_devices}")
    if n_devices is None:
        per_wave = (n_participants if waves is None
                    else math.ceil(n_participants / waves))
        n_devices = max(1, math.ceil(per_wave / pack))
    wave_slots = n_devices * pack
    if waves is None:
        waves = max(1, math.ceil(n_participants / wave_slots))
    if wave_slots * waves < n_participants:
        raise ValueError(
            f"{waves} waves x {n_devices} devices x pack={pack} = "
            f"{wave_slots * waves} lanes cannot host {n_participants} "
            "participants")
    return n_devices, wave_slots, waves


# --------------------------------------------------------------- round plan
@dataclasses.dataclass(frozen=True)
class RoundPlan:
    """One round's participation + mesh-slot assignment.

    Slot arrays all have length ``n_slots = n_devices * pack``; slot ``s``
    lives on device ``s // pack``, lane ``s % pack``.  Idle slots (padding
    when fewer participants than slots) carry ``client == -1``, train for 0
    steps, and aggregate with weight 0.
    """

    round_index: int
    pack: int
    slot_client: np.ndarray    # (S,) int32 client id per slot; -1 = idle
    slot_cluster: np.ndarray   # (S,) int32 cluster INDEX per slot; -1 = idle
    slot_weight: np.ndarray    # (S,) float32 aggregation weight; sums to 1
    # (S,) int32 arrival delay in rounds (speed model, module docstring):
    # 0 = the update arrives before this round's deadline, d >= 1 = it lands
    # d rounds late (a straggler).  None = synchronous plan (all on time).
    slot_delay: Optional[np.ndarray] = None
    # Wave-scheduled execution (DESIGN.md §15): the slot arrays span
    # ``n_waves * wave_slots`` LANES, streamed through a fixed mesh of
    # ``wave_slots`` physical slots in ``n_waves`` passes.  ``None`` means
    # single-wave (the lanes ARE the mesh — today's packed semantics).
    wave_slots: Optional[int] = None

    @property
    def n_slots(self) -> int:
        return len(self.slot_client)

    @property
    def n_waves(self) -> int:
        """Number of fixed-shape passes the plan's lanes are streamed in."""
        if self.wave_slots is None:
            return 1
        return self.n_slots // self.wave_slots

    def wave(self, w: int) -> "RoundPlan":
        """The ``wave_slots``-sized single-wave sub-plan for pass ``w``.

        Slot arrays are sliced views over lanes ``[w*ws, (w+1)*ws)``;
        weights are NOT renormalised — each wave's ``agg_row`` is a slice
        of the globally-normalised row, so per-wave unnormalised partial
        sums fold exactly into the full-cohort mean (DESIGN.md §15).
        ``sync_matrix``/``steps_for`` computed on the slice are correct
        because clusters are slot-contiguous and engines constrain
        cluster-spanning sync to wave-invariant teacher feeds.
        """
        ws = self.wave_slots if self.wave_slots is not None else self.n_slots
        if not 0 <= w < max(1, self.n_slots // ws):
            raise IndexError(f"wave {w} out of range for {self.n_waves} waves")
        lo, hi = w * ws, (w + 1) * ws
        return RoundPlan(
            round_index=self.round_index, pack=self.pack,
            slot_client=self.slot_client[lo:hi],
            slot_cluster=self.slot_cluster[lo:hi],
            slot_weight=self.slot_weight[lo:hi],
            slot_delay=(None if self.slot_delay is None
                        else self.slot_delay[lo:hi]),
            wave_slots=None)

    @property
    def active(self) -> np.ndarray:
        """(S,) bool — slots that host a participating client."""
        return self.slot_client >= 0

    @property
    def delays(self) -> np.ndarray:
        """(S,) int32 arrival delays (zeros for a synchronous plan)."""
        if self.slot_delay is None:
            return np.zeros(self.n_slots, np.int32)
        return self.slot_delay

    @property
    def on_time(self) -> np.ndarray:
        """(S,) bool — active slots whose update beats the round deadline."""
        return self.active & (self.delays == 0)

    @property
    def stragglers(self) -> np.ndarray:
        """(S,) bool — active slots whose update arrives >= 1 round late."""
        return self.active & (self.delays > 0)

    def delay_of(self) -> dict[int, int]:
        """client id -> arrival delay in rounds (participants only)."""
        return {int(c): int(d) for c, d in
                zip(self.slot_client, self.delays) if c >= 0}

    @property
    def participants(self) -> np.ndarray:
        """Participating client ids, in slot order (cluster-contiguous)."""
        return self.slot_client[self.active]

    def weight_of(self) -> dict[int, float]:
        """client id -> aggregation weight (participants only)."""
        return {int(c): float(w) for c, w in
                zip(self.slot_client, self.slot_weight) if c >= 0}

    def sync_matrix(self) -> np.ndarray:
        """(S, S) row-stochastic intra-cluster mean operator over slots.

        Row s of the matrix is slot s's post-sync mixture: active slots
        average over their cluster's ACTIVE slots (the mesh form of Alg. 1's
        teacher sync, now spanning (device, lane) pairs); idle slots get an
        identity row so whatever they carry passes through untouched.
        """
        S = self.n_slots
        w = np.eye(S, dtype=np.float32)
        for k in np.unique(self.slot_cluster[self.active]):
            members = np.flatnonzero(self.active & (self.slot_cluster == k))
            w[np.ix_(members, members)] = 1.0 / len(members)
        return w

    def agg_row(self) -> np.ndarray:
        """(S,) global aggregation weights (the two-level FedSiKD mean
        collapsed into one contraction row; idle slots weigh 0)."""
        return self.slot_weight.astype(np.float32)

    def steps_for(self, per_client_steps: np.ndarray) -> np.ndarray:
        """(S,) int32 per-slot step budgets: the hosted client's budget for
        active slots, 0 for idle slots (their scan carry stays frozen)."""
        per_client_steps = np.asarray(per_client_steps)
        safe = np.where(self.active, self.slot_client, 0)
        return np.where(self.active, per_client_steps[safe], 0).astype(np.int32)

    def example_row(self, num_examples: np.ndarray) -> np.ndarray:
        """(S,) FedAvg example-weighted aggregation row: active slot ``s``
        weighs ``n_{client(s)} / sum_active n``, idle slots 0.  This is the
        single all-clients group operator the packed baseline engine
        contracts with ``cluster_collectives.packed_weighted_mean`` — the
        runtime-array mirror of the loop engine's
        ``aggregation.fedavg(locals, sizes)`` (no cluster structure, so
        ``slot_weight``'s two-level mean does not apply)."""
        n = np.asarray(num_examples, np.float64)
        safe = np.where(self.active, self.slot_client, 0)
        row = np.where(self.active, n[safe], 0.0)
        total = row.sum()
        return (row / (total if total > 0 else 1.0)).astype(np.float32)


# ---------------------------------------------------------------- scheduler
class RoundScheduler:
    """Deterministic per-round participation + slot-assignment policy.

    Parameters
    ----------
    cluster_of : (C,) integer cluster label per client (values need not be
        contiguous).  A NEGATIVE label marks a client that is not currently
        part of the roster (not yet joined, or permanently left —
        ``fed/lifecycle.py``); such clients belong to no group and are
        never sampled.
    participation : ``full`` (everyone, every round), ``uniform``
        (``clients_per_round`` sampled uniformly without replacement), or
        ``stratified`` (per-cluster proportional allocation with a floor of
        one member per cluster, so no cluster is ever teacher-less).
    clients_per_round : sample size; required for non-``full`` modes.
    pack : client lanes per device in the mesh engine (>= 1).
    n_devices : mesh size; defaults to ``ceil(max_participants / pack)``
        when ``waves`` is unset (single-wave legacy layout), else to the
        smallest mesh that hosts the cohort in ``waves`` passes.
    waves : stream each round's cohort through the fixed mesh in this many
        fixed-shape passes (DESIGN.md §15); ``None`` = auto (1 when the
        cohort fits ``n_devices * pack`` slots, else the minimum count).
    weighting : full-population cluster weight, ``size`` (|C_k|/N,
        §IV-C.5) or ``uniform`` (1/K, Alg. 1 literal).
    dropout_rate : probability that an invited client fails mid-round
        (module docstring); 0 disables the failure scenario.
    async_mode : turn the per-client speed model on — plans carry per-slot
        arrival delays (``RoundPlan.slot_delay``, module docstring).
    round_deadline : server cutoff per round in units of the nominal round
        length; ``delay = ceil(latency / deadline) - 1``.  1.0 means every
        on-pace client arrives on time; < 1 squeezes even on-pace clients.
    straggler_frac : per-(seed, client) probability the client is a
        persistent straggler (its per-round latency exceeds one round).
    latency_dist : distribution of a straggler's excess latency —
        ``lognormal`` | ``exp`` | ``uniform``.
    seed : plans are a pure function of (seed, round_index).
    """

    def __init__(self, cluster_of: Sequence[int], *,
                 participation: str = "full",
                 clients_per_round: Optional[int] = None,
                 pack: int = 1, n_devices: Optional[int] = None,
                 waves: Optional[int] = None,
                 weighting: str = "size", dropout_rate: float = 0.0,
                 async_mode: bool = False, round_deadline: float = 1.0,
                 straggler_frac: float = 0.0,
                 latency_dist: str = "lognormal",
                 seed: int = 0):
        labels = np.asarray(cluster_of)
        member = labels >= 0
        self.client_ids = np.flatnonzero(member)   # the active roster
        self.n_clients = len(self.client_ids)
        if self.n_clients == 0:
            raise ValueError("scheduler needs at least one active client "
                             "(every label is negative)")
        uniq = np.unique(labels[member])
        # cluster INDEX (0..K-1) per client — the one id space plans use;
        # off-roster clients keep -1 and belong to no group
        cluster_idx = np.full(len(labels), -1, np.int32)
        cluster_idx[member] = np.searchsorted(
            uniq, labels[member]).astype(np.int32)
        self.cluster_idx = cluster_idx
        self.groups = [np.flatnonzero(self.cluster_idx == k)
                       for k in range(len(uniq))]
        self.n_clusters = len(self.groups)
        if participation not in PARTICIPATION_MODES:
            raise ValueError("participation must be one of "
                             f"{PARTICIPATION_MODES}, got {participation!r}")
        if weighting not in WEIGHTINGS:
            raise ValueError(f"weighting must be one of {WEIGHTINGS}, "
                             f"got {weighting!r}")
        if participation == "full":
            if clients_per_round not in (None, self.n_clients):
                raise ValueError(
                    f"participation='full' runs all {self.n_clients} clients "
                    f"every round; clients_per_round={clients_per_round} "
                    "conflicts (use participation='uniform'/'stratified')")
            clients_per_round = self.n_clients
        else:
            if clients_per_round is None:
                raise ValueError(
                    f"participation={participation!r} needs clients_per_round")
            if not 1 <= clients_per_round <= self.n_clients:
                raise ValueError(
                    f"clients_per_round must be in [1, {self.n_clients}], "
                    f"got {clients_per_round}")
            if (participation == "stratified"
                    and clients_per_round < self.n_clusters):
                raise ValueError(
                    "stratified sampling needs clients_per_round >= "
                    f"n_clusters ({self.n_clusters}) to keep every cluster's "
                    f"teacher covered, got {clients_per_round}")
        if not 0.0 <= dropout_rate < 1.0:
            raise ValueError(
                f"dropout_rate must be in [0, 1), got {dropout_rate}")
        if not 0.0 <= straggler_frac < 1.0:
            raise ValueError(
                f"straggler_frac must be in [0, 1), got {straggler_frac}")
        if round_deadline <= 0.0:
            raise ValueError(
                f"round_deadline must be > 0, got {round_deadline}")
        if latency_dist not in LATENCY_DISTS:
            raise ValueError(f"latency_dist must be one of {LATENCY_DISTS}, "
                             f"got {latency_dist!r}")
        self.async_mode = bool(async_mode)
        self.round_deadline = float(round_deadline)
        self.straggler_frac = float(straggler_frac)
        self.latency_dist = latency_dist
        self.participation = participation
        self.clients_per_round = clients_per_round
        self.weighting = weighting
        self.dropout_rate = dropout_rate
        self.pack = pack
        self.max_participants = clients_per_round
        # the ONE slot-layout rule, shared with the mesh builder: the mesh
        # holds ``wave_slots`` physical slots; plans span
        # ``n_slots = n_waves * wave_slots`` lanes streamed through it
        self.n_devices, self.wave_slots, self.n_waves = fed_wave_layout(
            self.max_participants, pack=pack, n_devices=n_devices,
            waves=waves)
        self.n_slots = self.wave_slots * self.n_waves
        self.seed = seed
        self._group_sizes = np.asarray([len(g) for g in self.groups],
                                       np.int64)
        self._speed_profile: dict[int, bool] = {}

    # ------------------------------------------------------------- sampling
    def _rng(self, round_index: int) -> np.random.Generator:
        # Legacy pre-registry participation stream: retro-salting it would
        # reshuffle every sampled roster and invalidate all committed
        # numerics.  Its [seed, round+1] shape cannot meet any salted
        # stream — those all have entropy length >= 3.
        return np.random.default_rng(
            np.random.SeedSequence(
                [self.seed & 0x7FFFFFFF, round_index + 1]
            ))  # fedlint: allow=FL001 -- legacy pre-registry stream; its 2-elt shape collides with no salted stream and retro-salting would invalidate committed numerics

    # ---------------------------------------------------------- speed model
    def _is_straggler(self, client: int) -> bool:
        """Persistent per-(seed, client) speed profile on the round-free
        0x5E stream (round slot pinned to 0: per-round latency always uses
        ``round + 1 >= 1``, so the streams never meet).  Profiles are
        immutable per client, so they are memoised — at 100k-client
        universes the SeedSequence spin-up would otherwise dominate
        ``plan()`` (satellite: plan cost ∝ cohort, not universe)."""
        client = int(client)
        hit = self._speed_profile.get(client)
        if hit is None:
            rng = np.random.default_rng(np.random.SeedSequence(
                [self.seed & 0x7FFFFFFF, 0, SALT_SPEED, client]))
            hit = bool(rng.random() < self.straggler_frac)
            self._speed_profile[client] = hit
        return hit

    def latency(self, round_index: int, client: int) -> float:
        """This round's completion latency for ``client``, in units of the
        nominal round length — deterministic per (seed, round, client) and
        independent of the cohort (who else was invited never shifts a
        client's draw).  On-pace clients complete within the nominal round
        (latency in (0.05, 0.95)); stragglers draw ``1 + excess`` from
        ``latency_dist``."""
        rng = np.random.default_rng(np.random.SeedSequence(
            [self.seed & 0x7FFFFFFF, round_index + 1, SALT_SPEED,
             int(client)]))
        if not self._is_straggler(client):
            return float(rng.uniform(0.05, 0.95))
        if self.latency_dist == "lognormal":
            excess = rng.lognormal(mean=0.0, sigma=0.75)
        elif self.latency_dist == "exp":
            excess = rng.exponential(1.0)
        else:                                          # uniform
            excess = rng.uniform(0.0, 2.0)
        return float(1.0 + excess)

    def delay(self, round_index: int, client: int) -> int:
        """Arrival delay in rounds under the server deadline: 0 = on time,
        d >= 1 = the update lands d rounds late."""
        lat = self.latency(round_index, client)
        return max(0, int(np.ceil(lat / self.round_deadline)) - 1)

    def _stratified_counts(self, total: int, caps: np.ndarray) -> np.ndarray:
        """Largest-remainder apportionment of ``total`` over clusters,
        proportional to cluster size, floored at 1 and capped at |C_k|."""
        sizes = caps.astype(np.float64)
        quota = total * sizes / sizes.sum()
        m = np.clip(np.floor(quota).astype(np.int64), 1, caps)
        # distribute the remainder to the largest fractional parts (ties ->
        # lower cluster index), respecting the caps
        order = np.argsort(-(quota - np.floor(quota)), kind="stable")
        for k in np.concatenate([order, np.arange(len(caps))]):
            if m.sum() >= total:
                break
            if m[k] < caps[k]:
                m[k] += 1
        while m.sum() > total:         # floors can overshoot a tiny total
            k = int(np.argmax(m - 1))  # shrink the largest above its floor
            if m[k] <= 1:
                break
            m[k] -= 1
        return m.astype(np.int64)

    def _sample(self, round_index: int) -> list[np.ndarray]:
        """Participating client ids per cluster (ascending within cluster)."""
        if self.participation == "full":
            return [g.copy() for g in self.groups]
        rng = self._rng(round_index)
        if self.participation == "uniform":
            chosen = rng.choice(self.client_ids, self.clients_per_round,
                                replace=False)
            # group by cached cluster index — O(cohort * K), universe-free
            # (np.isin against each full group array was O(C) per cluster)
            cid = self.cluster_idx[chosen]
            return [np.sort(chosen[cid == k])
                    for k in range(self.n_clusters)]
        caps = np.asarray([len(g) for g in self.groups])
        counts = self._stratified_counts(self.clients_per_round, caps)
        return [np.sort(rng.choice(g, int(m), replace=False))
                for g, m in zip(self.groups, counts)]

    def _apply_dropout(self, round_index: int,
                       per_cluster: list[np.ndarray]) -> list[np.ndarray]:
        """Fail each invited client independently with ``dropout_rate``,
        deterministically per (seed, round); the 0xD0 salt keeps the failure
        stream disjoint from the sampling stream (``_rng``), so turning
        dropout on never reshuffles WHO was invited."""
        rng = np.random.default_rng(np.random.SeedSequence(
            [self.seed & 0x7FFFFFFF, round_index + 1, SALT_DROPOUT]))
        return [sel[rng.random(len(sel)) >= self.dropout_rate]
                for sel in per_cluster]

    # ----------------------------------------------------------------- plan
    def _build_plan(self, round_index: int,
                    per_cluster: list[np.ndarray]) -> RoundPlan:
        S = self.n_slots
        slot_client = np.full(S, -1, np.int32)
        slot_cluster = np.full(S, -1, np.int32)
        slot_weight = np.zeros(S, np.float32)

        # Everything below is O(cohort + K): per-universe scans would make
        # plan() scale with C (satellite: negligible planning at C = 100k).
        m_k = np.asarray([len(sel) for sel in per_cluster], np.int64)
        present = np.flatnonzero(m_k)
        s = 0
        if len(present):
            if self.weighting == "size":
                Wp = self._group_sizes[present] / self.n_clients
            else:
                Wp = np.full(len(present), 1.0 / self.n_clusters)
            # sequential Python sum, bit-matching the historical per-dict
            # accumulation (np.sum's pairwise order can differ in the ulp)
            norm = float(sum(Wp.tolist()))  # renormalise over present
            w_per = Wp / (norm * m_k[present])
            cohort = np.concatenate([per_cluster[k] for k in present])
            s = len(cohort)             # clusters are slot-contiguous
            slot_client[:s] = cohort
            slot_cluster[:s] = np.repeat(present, m_k[present])
            slot_weight[:s] = np.repeat(w_per, m_k[present])
        # speed model: per-slot arrival delays (warm-up — round 0 — stays
        # synchronous: establishment precedes deployment timing)
        slot_delay = None
        if self.async_mode and round_index >= 1:
            slot_delay = np.zeros(S, np.int32)
            for t in range(s):
                slot_delay[t] = self.delay(round_index, int(slot_client[t]))
        return RoundPlan(round_index=round_index, pack=self.pack,
                         slot_client=slot_client, slot_cluster=slot_cluster,
                         slot_weight=slot_weight, slot_delay=slot_delay,
                         wave_slots=self.wave_slots)

    def plan(self, round_index: int) -> RoundPlan:
        """The participation plan for round ``round_index`` (1-based by
        convention; any int is valid and deterministic).  Survivors of the
        dropout filter are reweighted by ``_build_plan``'s present-cluster
        renormalisation, exactly like an under-sampled round."""
        sel = self._sample(round_index)
        if self.dropout_rate > 0.0:
            sel = self._apply_dropout(round_index, sel)
        return self._build_plan(round_index, sel)

    def warmup_plan(self) -> RoundPlan:
        """Teacher-coverage plan for the pre-round KD-establishment phase:
        all clients when they fit the mesh, otherwise a stratified slice of
        ``n_slots`` clients (still >= 1 per cluster) so every cluster's
        teacher warms up even when C >> slots.  With ``teacher_data="leader"``
        the member choice is immaterial (every slot of a cluster streams the
        same leader feed); with ``"cluster"`` this caps the warm-up's
        data-parallel width at the mesh size."""
        if self.n_clients <= self.n_slots:
            return self._build_plan(0, [g.copy() for g in self.groups])
        if self.n_clusters > self.n_slots:
            raise ValueError(
                "teacher warm-up needs at least one mesh slot per cluster: "
                f"{self.n_clusters} clusters > {self.n_slots} slots "
                "(raise pack or n_devices)")
        caps = np.asarray([len(g) for g in self.groups])
        counts = self._stratified_counts(self.n_slots, caps)
        # own salted stream: ``_rng(0)`` — the old choice — IS the sampling
        # stream of ``plan(0)``, a fold-constant collision (module
        # docstring); the warm-up slice must not mirror any round's sample
        rng = np.random.default_rng(np.random.SeedSequence(
            [self.seed & 0x7FFFFFFF, 0, SALT_WARMUP, 0]))
        sel = [np.sort(rng.choice(g, int(m), replace=False))
               for g, m in zip(self.groups, counts)]
        return self._build_plan(0, sel)
