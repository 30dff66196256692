"""Federated entry point of the port: ``FedConfig`` (a copy of
``repro.fed.rounds.FedConfig`` with every field and every validation) and
``run_federated`` (one call = one ``RoundDriver`` run on a torch device).

The port runs every algorithm on the loop engine and, one wave of
synchronous rounds, every algorithm but FL+HC on the packed engine
(``engine="sharded"``): the clustered-KD algorithms (``fedsikd`` and the
``random`` ablation) and the baselines (``fedavg``, ``fedprox``; FL+HC is
loop-only, as in JAX).  On the loop engine it runs the runtime knobs too:
DP-noised statistics (``dp_noise``), the client lifecycle
(``join_schedule``, ``leave_rate``, ``recluster_every``), semi-async
rounds (``async_mode``) and checkpoints (``ckpt_dir``, ``resume``,
``async_ckpt``); on the packed engine ``dp_noise`` and checkpoints.  Every
knob it does not port raises ``NotImplementedError`` naming its ROADMAP.md
item, before any work starts (``unported_knobs``).
"""
from __future__ import annotations

import dataclasses
from typing import Optional

import torch

from repro_torch.data.synthetic import Dataset
from repro_torch.fed import schedule

ALGORITHMS = ("fedsikd", "random", "fedavg", "fedprox", "flhc")
ENGINES = ("loop", "sharded")
KD_IMPLS = ("fused", "reference")
TEACHER_DATA_MODES = ("leader", "cluster")
# engine x algorithm compatibility matrix: every algorithm runs on the
# sequential loop engine; the packed mesh engine runs everything except
# FL+HC, whose agglomerative-clustering pre-round is host-sequential by
# construction (its post-clustering rounds still get the shared driver).
SHARDED_ALGORITHMS = ("fedsikd", "random", "fedavg", "fedprox")


@dataclasses.dataclass
class FedConfig:
    algorithm: str = "fedsikd"        # fedsikd | fedavg | flhc | random | fedprox
    # Round engine (every algorithm has a strategy per engine, DESIGN.md §10):
    #   loop    — sequential per-client Python loop (reference implementation)
    #   sharded — packed client mesh: C = devices x pack clients in one
    #             jitted collective program per round (fed/sharded.py,
    #             DESIGN.md §3/§8).  Supports fedsikd | random | fedavg |
    #             fedprox (FL+HC's clustering pre-round is loop-only).
    engine: str = "loop"
    # KD loss used by the sharded engine's student steps:
    #   fused     — Pallas kd_distillation_loss kernel (one pass over logits)
    #   reference — pure-jnp core.distill.distillation_loss
    kd_impl: str = "fused"
    # Per-round participation policy (fed/schedule.py, DESIGN.md §8):
    #   full       — every client, every round (the original behaviour)
    #   uniform    — clients_per_round sampled uniformly w/o replacement
    #   stratified — per-cluster proportional sampling, >= 1 per cluster
    #                (every cluster keeps teacher coverage)
    # All engines consume the same deterministic RoundPlan, so loop/sharded
    # parity extends to sampled rounds.
    participation: str = "full"
    clients_per_round: Optional[int] = None
    # Per-round client failure probability (fed/schedule.py module docstring,
    # DESIGN.md §9): each invited client independently drops out of the round
    # with this probability, deterministic per (seed, round); survivors are
    # reweighted by the same present-cluster renormalisation as sampling.
    dropout_rate: float = 0.0
    # Client lanes per device in the sharded engine: C = devices x pack
    # clients run in one jitted program (ignored by the loop engine).
    pack: int = 1
    # Wave-scheduled universe scaling (DESIGN.md §15, sharded engine only).
    #   universe  — total VIRTUAL client population; ``num_clients`` stays
    #               the materialised base data pool and virtual client v
    #               aliases base shard v % num_clients
    #               (data.pipeline.ClientStore).  None = no virtualisation
    #               (universe == num_clients, byte-identical legacy runs).
    #   n_devices — pin the mesh size; the cohort streams through
    #               n_devices * pack slots in fixed-shape waves instead of
    #               sizing the mesh for the whole cohort.
    #   waves     — pin the wave count (None = auto: 1 when the cohort
    #               fits the mesh, else the minimum that hosts it).
    universe: Optional[int] = None
    n_devices: Optional[int] = None
    waves: Optional[int] = None
    # Client lifecycle (fed/lifecycle.py, DESIGN.md §11).  ``num_clients``
    # stays the FULL client universe; lifecycle knobs control who is online:
    #   join_schedule   — ((round, count), ...): count clients come online at
    #                     the start of that round (ids dealt from the top of
    #                     the universe, so the initial roster is the low ids)
    #   leave_rate      — per-round probability an active client leaves FOR
    #                     GOOD (vs dropout_rate's transient one-round failure)
    #   recluster_every — also re-cluster every N rounds (0: only on
    #                     membership events)
    # Any knob on => the driver re-clusters on every membership change,
    # warm-starting k-means from the previous centroids and migrating each
    # cluster's teacher from the nearest surviving centroid's teacher.
    join_schedule: Optional[tuple] = None
    leave_rate: float = 0.0
    recluster_every: int = 0
    # Semi-async rounds (fed/schedule.py speed model + fed/driver.py
    # StalenessBuffer, DESIGN.md §12).  With async_mode on, each
    # participant's update either beats the round deadline (delay 0, merged
    # as today) or lands d >= 1 rounds late — buffered, then merged with
    # weight decayed by (1 + staleness)^-staleness_decay if staleness <=
    # max_staleness, dropped (and counted) otherwise.  Teachers stay
    # synchronous (edge-hosted: device stragglers delay only the student
    # update's arrival).  With straggler_frac=0 every plan is all-on-time
    # and both engines are bit-identical to async_mode=False.
    async_mode: bool = False
    max_staleness: int = 2            # arrivals older than this are dropped
    staleness_decay: float = 0.5      # a in (1 + s)^-a; 0 = no decay
    round_deadline: float = 1.0       # latency units per round
    straggler_frac: float = 0.0       # fraction of clients that straggle
    latency_dist: str = "lognormal"   # lognormal | exp | uniform
    num_clients: int = 40
    alpha: float = 0.5                # Dirichlet skew
    rounds: int = 5
    local_epochs: int = 1
    batch_size: int = 64
    lr: float = 1e-3
    student_lr: float = 3e-3          # smaller net needs a hotter lr (see
                                      # EXPERIMENTS.md calibration)
    kd_temperature: float = 2.0
    kd_alpha: float = 0.5
    prox_mu: float = 0.01
    num_clusters: Optional[int] = None   # None -> metric-voted K (paper)
    k_range: tuple[int, int] = (2, 5)
    # Alg.1: "FL rounds start after ... the establishment of knowledge
    # distillation within each cluster" -> teachers warm up before round 1.
    teacher_warmup_epochs: int = 3
    # Alg.1 line 12 trains the teacher on CLUSTER data (union of members,
    # hosted at the leader/edge node).  "leader" restricts to the leader's
    # own shard — strictly more private, weaker teacher.  See DESIGN.md §7.
    teacher_data: str = "leader"         # leader (privacy-faithful: the
                                         # teacher sees only the leader's own
                                         # shard) | cluster (Alg.1 literal)
    cluster_weighting: str = "size"      # size (§IV-C.5 text) | uniform (Alg.1)
    dp_noise: float = 0.0                # DP noise multiplier on shared stats
    # Fault tolerance (fed/fedstate.py, DESIGN.md §9): with ckpt_dir set the
    # run writes round_NNNNN.npz snapshots every ckpt_every rounds (and at
    # the final round); resume=True restarts from the latest one if present
    # — bit-identical to the uninterrupted run — else starts fresh.
    ckpt_dir: Optional[str] = None
    ckpt_every: int = 1
    # Retention: keep only the newest N round snapshots (a full snapshot
    # per round is O(rounds) model copies and only the latest is restored);
    # None keeps everything.
    ckpt_keep: Optional[int] = 3
    resume: bool = False
    # Hot-path performance knobs (DESIGN.md §13).  All three are pure
    # execution-strategy switches: they change WHERE buffers live and WHEN
    # host work happens, never a single computed bit — so they are excluded
    # from the resume fingerprint, and each has an off switch for bisecting.
    #   donate     — donate per-round slot temporaries to the jitted round
    #                programs (in-place update instead of allocate+copy)
    #   prefetch   — stage round N+1's slot arrays on a background thread
    #                while round N computes (packed engines only)
    #   async_ckpt — move checkpoint device-to-host copy + npz write to a
    #                background writer (bounded queue, atomic publish,
    #                flushed at run end — kill-and-resume stays bit-identical)
    donate: bool = True
    prefetch: bool = True
    async_ckpt: bool = False
    # Runtime sanitizers (src/repro/guards.py, DESIGN.md §14): steady-state
    # rounds run under jax's transfer guard (implicit host<->device syncs in
    # the hot path raise) and a compile-count sentinel (any recompile after
    # the warm-in rounds raises).  Execution-only: guards never change a
    # computed bit, they only turn silent performance regressions into
    # errors.  Sharded engines only — the loop engine feeds numpy batches
    # straight into jit by design.  The string value "jitter" additionally
    # arms the schedule-jitter race harness (guards.enable_jitter):
    # deterministic seeded sleeps at every thread-handoff point stretch the
    # prefetch/async-ckpt interleavings adversarially — histories must stay
    # bitwise identical (DESIGN.md §16).
    guards: bool | str = False
    seed: int = 0

    def __post_init__(self):
        # Construction-time validation of EVERY knob (and the engine x
        # algorithm compatibility matrix): an invalid config fails here,
        # not minutes into a run.  The RoundScheduler re-validates against
        # the actual cluster structure (e.g. stratified needs >= K
        # participants), which is only known at setup time.
        if self.algorithm not in ALGORITHMS:
            raise ValueError(
                f"algorithm must be one of {ALGORITHMS}, "
                f"got {self.algorithm!r}")
        if self.engine not in ENGINES:
            raise ValueError(
                f"engine must be one of {ENGINES}, got {self.engine!r}")
        if self.engine == "sharded" and self.algorithm not in SHARDED_ALGORITHMS:
            raise ValueError(
                f"engine='sharded' supports algorithms {SHARDED_ALGORITHMS}; "
                f"{self.algorithm!r} clusters on a host-sequential pre-round "
                "of local updates — use engine='loop'")
        if self.kd_impl not in KD_IMPLS:
            raise ValueError(
                f"kd_impl must be one of {KD_IMPLS}, got {self.kd_impl!r}")
        if self.teacher_data not in TEACHER_DATA_MODES:
            raise ValueError(
                f"teacher_data must be one of {TEACHER_DATA_MODES}, "
                f"got {self.teacher_data!r}")
        if self.cluster_weighting not in schedule.WEIGHTINGS:
            raise ValueError(
                f"cluster_weighting must be one of {schedule.WEIGHTINGS}, "
                f"got {self.cluster_weighting!r}")
        if self.participation not in schedule.PARTICIPATION_MODES:
            raise ValueError(
                f"participation must be one of {schedule.PARTICIPATION_MODES},"
                f" got {self.participation!r}")
        if self.universe is not None:
            if self.engine != "sharded":
                raise ValueError(
                    "universe virtualisation needs engine='sharded' (the "
                    "loop engine iterates every client per round, so round "
                    "time would scale with the universe)")
            if self.universe < self.num_clients:
                raise ValueError(
                    f"universe={self.universe} must be >= num_clients="
                    f"{self.num_clients} (the materialised base pool)")
        for knob, val in (("n_devices", self.n_devices),
                          ("waves", self.waves)):
            if val is not None:
                if self.engine != "sharded":
                    raise ValueError(
                        f"{knob} is a packed-mesh layout knob; it needs "
                        "engine='sharded'")
                if val < 1:
                    raise ValueError(f"{knob} must be >= 1, got {val}")
        if self.participation == "full":
            if self.clients_per_round not in (None, self.total_clients):
                raise ValueError(
                    "clients_per_round only applies with participation="
                    "'uniform' or 'stratified'")
        elif self.clients_per_round is None:
            raise ValueError(
                f"participation={self.participation!r} needs clients_per_round")
        elif not 1 <= self.clients_per_round <= self.total_clients:
            raise ValueError(
                f"clients_per_round must be in [1, {self.total_clients}], got "
                f"{self.clients_per_round}")
        if self.pack < 1:
            raise ValueError(f"pack must be >= 1, got {self.pack}")
        if (self.engine == "sharded"
                and self.algorithm in ("fedsikd", "random")
                and self.teacher_data == "cluster"):
            # prospective wave layout: the pooled-cluster teacher feed syncs
            # across the WHOLE cluster each round, which a per-wave sync
            # matrix cannot express — leader mode's wave-invariant feeds can
            cohort = self.clients_per_round or self.total_clients
            _, _, n_waves = schedule.fed_wave_layout(cohort, pack=self.pack,
                                            n_devices=self.n_devices,
                                            waves=self.waves)
            if n_waves > 1:
                raise ValueError(
                    "teacher_data='cluster' pools member data into one "
                    "teacher feed and needs the whole cluster on the mesh "
                    "at once; wave-scheduled rounds (waves > 1) require "
                    "teacher_data='leader'")
        if not 0.0 <= self.dropout_rate < 1.0:
            raise ValueError(
                f"dropout_rate must be in [0, 1), got {self.dropout_rate}")
        if self.ckpt_every < 1:
            raise ValueError(f"ckpt_every must be >= 1, got {self.ckpt_every}")
        if self.ckpt_keep is not None and self.ckpt_keep < 1:
            raise ValueError(
                f"ckpt_keep must be >= 1 or None, got {self.ckpt_keep}")
        if self.resume and not self.ckpt_dir:
            raise ValueError("resume=True needs ckpt_dir")
        if self.guards not in (False, True, "jitter"):
            raise ValueError(
                f"guards must be False, True, or 'jitter', got "
                f"{self.guards!r}")
        if self.guards and self.engine != "sharded":
            raise ValueError(
                "guards=True requires engine='sharded': the loop engine "
                "feeds host batches into jit on purpose, so the transfer "
                "guard would reject its steady state")
        # lifecycle knobs (fed/lifecycle.py validates the schedule's shape;
        # normalising here keeps the fingerprint canonical)
        from repro_torch.fed.lifecycle import normalize_join_schedule
        self.join_schedule = normalize_join_schedule(self.join_schedule)
        if not 0.0 <= self.leave_rate < 1.0:
            raise ValueError(
                f"leave_rate must be in [0, 1), got {self.leave_rate}")
        if self.recluster_every < 0:
            raise ValueError(
                f"recluster_every must be >= 0, got {self.recluster_every}")
        # semi-async knobs (the scheduler re-validates what it consumes)
        if self.max_staleness < 0:
            raise ValueError(
                f"max_staleness must be >= 0, got {self.max_staleness}")
        if self.staleness_decay < 0:
            raise ValueError(
                f"staleness_decay must be >= 0, got {self.staleness_decay}")
        if self.round_deadline <= 0:
            raise ValueError(
                f"round_deadline must be > 0, got {self.round_deadline}")
        if not 0.0 <= self.straggler_frac < 1.0:
            raise ValueError(
                "straggler_frac must be in [0, 1), got "
                f"{self.straggler_frac}")
        if self.latency_dist not in schedule.LATENCY_DISTS:
            raise ValueError(
                f"latency_dist must be one of {schedule.LATENCY_DISTS}, "
                f"got {self.latency_dist!r}")
        if self.async_mode:
            if self.algorithm == "flhc":
                raise ValueError(
                    "async_mode needs a strategy with a staleness merge "
                    "path; algorithm='flhc' keeps per-cluster models with "
                    "no global merge — use fedsikd | random | fedavg | "
                    "fedprox")
        elif self.straggler_frac > 0:
            raise ValueError(
                "straggler_frac > 0 needs async_mode=True (a synchronous "
                "run has no deadline for a straggler to miss)")
        if self.lifecycle_enabled:
            if self.universe is not None:
                raise ValueError(
                    "universe virtualisation and lifecycle knobs "
                    "(join_schedule/leave_rate/recluster_every) are "
                    "mutually exclusive: lifecycle rosters are sized by "
                    "the materialised pool")
            if self.algorithm == "flhc":
                raise ValueError(
                    "algorithm='flhc' clusters once on a pre-round of local "
                    "updates and has no re-clustering path; lifecycle knobs "
                    "(join_schedule/leave_rate/recluster_every) need "
                    "fedsikd | random | fedavg | fedprox")
            total = sum(c for _, c in self.join_schedule or ())
            if total >= self.num_clients:
                raise ValueError(
                    f"join_schedule brings in {total} clients but "
                    f"num_clients={self.num_clients}; at least one client "
                    "must be present from round 1")

    @property
    def total_clients(self) -> int:
        """The client ID space every roster/plan spans: the virtual
        universe when set, else the materialised pool."""
        return self.num_clients if self.universe is None else self.universe

    @property
    def lifecycle_enabled(self) -> bool:
        return bool(self.join_schedule) or self.leave_rate > 0 \
            or self.recluster_every > 0


def unported_knobs(cfg: FedConfig) -> list[str]:
    """The knobs of ``cfg`` this slice of the port does not run yet, each
    with the ROADMAP.md Queue 1 item that ports it: the packed engine's
    waves, universe, guards, async rounds and client lifecycle."""
    out = []
    if cfg.engine == "sharded":
        if cfg.universe is not None:
            out.append("universe (virtual client universe on the packed "
                       "engine: ROADMAP Queue 1 item 9)")
        cohort = cfg.clients_per_round or cfg.total_clients
        _, _, n_waves = schedule.fed_wave_layout(
            cohort, pack=cfg.pack, n_devices=cfg.n_devices, waves=cfg.waves)
        if n_waves > 1:
            out.append(f"waves/n_devices giving {n_waves} waves "
                       "(wave-scheduled rounds: ROADMAP Queue 1 item 9)")
        if cfg.guards:
            out.append("guards (runtime guards on the packed engine: "
                       "ROADMAP Queue 1 item 9)")
        if cfg.async_mode:
            out.append("async_mode on the packed engine (semi-async packed "
                       "rounds: ROADMAP Queue 1 item 9)")
        if cfg.lifecycle_enabled:
            out.append("join_schedule/leave_rate/recluster_every on the "
                       "packed engine (packed client lifecycle: ROADMAP "
                       "Queue 1 item 9)")
    return out


def resolve_device(device) -> torch.device:
    """The torch device a run uses.  A CUDA device that is not there raises:
    an entry point never carries on on the CPU unless asked to."""
    dev = torch.device(device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            f"device={str(device)!r} requested but torch.cuda.is_available() "
            "is False; pass device='cpu' to run the port on the CPU")
    return dev


def run_federated(ds: Dataset, cfg: FedConfig, *, device="cuda",
                  progress: bool = False) -> dict:
    """Runs ``cfg.rounds`` federated rounds on ``device``; returns per-round
    test metrics in the history schema of ``repro.fed.rounds.run_federated``.
    """
    missing = unported_knobs(cfg)
    if missing:
        raise NotImplementedError(
            "not ported to repro_torch yet: " + "; ".join(missing))
    dev = resolve_device(device)
    from repro_torch.fed.algorithms import make_algorithm
    from repro_torch.fed.driver import RoundDriver
    return RoundDriver(ds, cfg, make_algorithm(cfg), device=dev,
                       progress=progress).run()
