"""The port's runtime guards (``repro_torch.guards``) and phase timer
(``repro_torch.perf``) on the CPU.

- Compile sentinel: a kernel plan cache's miss counts, a hit does not, and
  a new shape inside ``no_new_compiles`` raises; inside a guarded run a
  new kernel shape in round 3 or later raises ``GuardError`` naming the
  round, one in the warm-in rounds does not; ``warm_async_merge`` runs
  once, in the warm-in of a guarded semi-async run.
- ``leak_check`` passes a balanced block and catches a pinned tensor;
  ``no_implicit_transfers`` does nothing.
- Race harness: disarmed, ``jitter_point`` neither counts nor sleeps;
  armed, its sleeps are ``jitter_delay(seed, tag, n)`` for the n-th firing
  of each tag.  A packed multi-wave semi-async run with the async
  checkpoint writer gives a history bitwise equal with jitter on and off;
  the test holds the harness's schedule (which tags fired, in what order,
  for how long), never measured sleep times.
- ``perf``: spans land in the open round, token spans patch closed rounds
  (from another thread too), the async writer's checkpoint span lands in
  its submission round (``tests/test_perf.py`` on the port), and a packed
  run fills every round's bucket with the driver's and the strategy's
  spans.
"""
import threading
import time

import numpy as np
import pytest
import torch

from repro_torch import guards, perf
from repro_torch.fed import fedstate
from repro_torch.fed.algorithms import baselines
from repro_torch.fed.algorithms import clustered_kd
from repro_torch.fed.rounds import FedConfig
from repro_torch.kernels import fused_merge
from test_torch_runtime import port_run

torch.set_num_threads(1)

PACKED = dict(algorithm="fedavg", engine="sharded", num_clients=6,
              alpha=1.0, rounds=4, local_epochs=1, batch_size=32, seed=0,
              pack=2, n_devices=1)
ASYNC = dict(async_mode=True, straggler_frac=0.5, max_staleness=2)


def teardown_function(_fn):
    perf.disable()
    guards.disable_jitter()


def _new_plan(tag: int):
    """Show the fused merge's planner a leaf layout no run has used."""
    fused_merge._merge_plan((1000 + tag, 7), 4, (True, False))


# ------------------------------------------------------------ compile sentinel
def test_sentinel_counts_plan_misses_and_ignores_hits():
    guards.install()
    guards.install()                       # idempotent
    before = guards.compile_count()
    _new_plan(1)
    assert guards.compile_count() == before + 1
    with guards.no_new_compiles("cached plan"):
        _new_plan(1)                       # a hit: the count holds


def test_sentinel_raises_on_a_new_shape():
    _new_plan(2)
    with pytest.raises(guards.GuardError, match="recompilation"):
        with guards.no_new_compiles("shape change"):
            _new_plan(3)


def test_assert_no_new_compiles_reports_context():
    base = guards.compile_count()
    guards.assert_no_new_compiles(base, "round 7")    # no-op when clean
    with pytest.raises(guards.GuardError, match="round 7"):
        guards.assert_no_new_compiles(base - 1, "round 7")


@pytest.mark.parametrize("at,raises", [(2, False), (3, True), (4, True)])
def test_guarded_run_fires_on_a_new_kernel_shape_after_warm_in(
        at, raises, monkeypatch):
    """Rounds 1-2 are warm-in (a first plan is legal there); from round 3
    on a kernel shown a new shape fails the run, naming the round."""
    run_round = baselines.PackedBaseline.run_round

    def with_new_shape(self, plan, rnd):
        if rnd == at:
            _new_plan(100 * at + (1 if raises else 0))
        return run_round(self, plan, rnd)

    monkeypatch.setattr(baselines.PackedBaseline, "run_round",
                        with_new_shape)
    if raises:
        with pytest.raises(guards.GuardError, match=f"round {at}"):
            port_run({**PACKED, "guards": True})
    else:
        h = port_run({**PACKED, "guards": True})
        assert len(h["acc"]) == PACKED["rounds"]


@pytest.mark.parametrize("algorithm", ["fedsikd", "fedavg"])
def test_warm_async_merge_runs_once_in_the_warm_in(algorithm, monkeypatch):
    cls = (clustered_kd.ShardedClusteredKD if algorithm == "fedsikd"
           else baselines.PackedBaseline)
    calls = []
    warm = cls.warm_async_merge
    monkeypatch.setattr(cls, "warm_async_merge",
                        lambda self: calls.append(1) or warm(self))
    kw = {**PACKED, **ASYNC, "algorithm": algorithm, "rounds": 3,
          "num_clusters": 2, "teacher_warmup_epochs": 1}
    port_run(kw)
    assert calls == []
    h = port_run({**kw, "guards": True})
    assert calls == [1] and sum(h["stale_merged"]) > 0


def test_guards_need_the_packed_engine():
    with pytest.raises(ValueError, match="sharded"):
        FedConfig(algorithm="fedavg", engine="loop", guards=True)
    with pytest.raises(ValueError, match="guards"):
        FedConfig(engine="sharded", guards="sometimes")


# ------------------------------------------------------- leaks and transfers
def test_leak_check_passes_when_balanced_and_catches_growth():
    with guards.leak_check(context="balanced", device_type="cpu"):
        tmp = torch.arange(64, dtype=torch.float32)
        del tmp
    pinned = []
    with pytest.raises(guards.GuardError, match="leaked during pinned"):
        with guards.leak_check(context="pinned", device_type="cpu"):
            pinned.append(torch.arange(65, dtype=torch.float32))
    pinned.clear()
    with guards.leak_check():              # no CUDA tensors here at all
        torch.ones(3)


def test_no_implicit_transfers_does_nothing():
    with guards.no_implicit_transfers():
        out = torch.from_numpy(np.arange(4, dtype=np.float32)) + 1
    assert out.tolist() == [1.0, 2.0, 3.0, 4.0]


# --------------------------------------------------------- the race harness
def test_jitter_schedule_is_deterministic_and_free_when_disarmed(
        monkeypatch):
    slept = []
    monkeypatch.setattr(guards.time, "sleep", slept.append)
    assert not guards.jitter_enabled()
    guards.jitter_point("wave-stage")
    assert slept == [] and guards.jitter_counts() == {}
    guards.enable_jitter(7)
    for tag in ("wave-stage", "ckpt-worker", "wave-stage"):
        guards.jitter_point(tag)
    assert guards.jitter_counts() == {"wave-stage": 2, "ckpt-worker": 1}
    assert slept == [guards.jitter_delay(7, "wave-stage", 0),
                     guards.jitter_delay(7, "ckpt-worker", 0),
                     guards.jitter_delay(7, "wave-stage", 1)]
    assert all(0.0 <= d <= 0.02 for d in slept)
    assert len(set(slept)) == 3
    assert guards.jitter_delay(7, "wave-stage", 1) == \
        guards.jitter_delay(7, "wave-stage", 1)
    assert guards.jitter_delay(8, "wave-stage", 1) != \
        guards.jitter_delay(7, "wave-stage", 1)
    guards.disable_jitter()
    guards.jitter_point("wave-stage")
    assert len(slept) == 3 and not guards.jitter_enabled()


def test_histories_bitwise_equal_under_jitter(monkeypatch, tmp_path):
    """Packed FedSiKD, 3 waves of 2 slots, stragglers, the async checkpoint
    writer: the history is bit for bit the same with the harness armed."""
    kw = dict(PACKED, algorithm="fedsikd", num_clusters=2,
              teacher_warmup_epochs=1, rounds=3, ckpt_every=1,
              async_ckpt=True, **ASYNC)
    off = port_run(kw, ckpt_dir=str(tmp_path / "off"))
    fired = []
    delay = guards.jitter_delay

    def recorded(seed, tag, n):
        fired.append((seed, tag, n))
        return delay(seed, tag, n)

    monkeypatch.setattr(guards, "jitter_delay", recorded)
    on = port_run({**kw, "guards": "jitter"}, ckpt_dir=str(tmp_path / "on"))
    assert not guards.jitter_enabled()     # the driver disarmed it
    for key in sorted(set(on) | set(off)):
        if key != "round_seconds":
            assert on[key] == off[key], key
    tags = {t for _, t, _ in fired}
    assert tags >= {"wave-prefetch", "wave-stage", "wave-evict",
                    "ckpt-submit", "ckpt-worker"}, tags
    assert {s for s, _, _ in fired} == {kw["seed"]}
    for tag in tags:                       # each tag's firings 0, 1, 2, ...
        ns = sorted(n for _, t, n in fired if t == tag)
        assert ns == list(range(len(ns))), (tag, ns)
    # one submit a round on the driver's thread; the writer's thread fires
    # once an item until the driver disarms the harness, before its close
    assert sum(t == "ckpt-submit" for _, t, _ in fired) == kw["rounds"]
    assert 1 <= sum(t == "ckpt-worker" for _, t, _ in fired) \
        <= kw["rounds"] + 1


# ------------------------------------------------------------------- perf
def test_span_without_token_lands_in_open_round():
    perf.enable()
    with perf.span("work"):
        pass
    perf.end_round()
    snap = perf.snapshot()
    assert len(snap) == 1 and "work" in snap[0]


def test_disabled_perf_records_nothing():
    perf.disable()
    with perf.span("work"):
        pass
    perf.add("stage_wait", 1.0)
    perf.end_round()
    perf.enable()
    assert perf.snapshot() == []


def test_token_span_patches_a_closed_round():
    perf.enable()
    tok = perf.round_token()
    perf.end_round()                 # round 0 closes before the span runs
    perf.end_round()                 # round 1 is also closed
    with perf.span("checkpoint", round_id=tok):
        time.sleep(0.01)
    perf.add("stage_hidden", 0.5, round_id=tok)
    snap = perf.snapshot()
    assert snap[0].get("checkpoint", 0.0) >= 0.01
    assert snap[0]["stage_hidden"] == 0.5
    assert "checkpoint" not in snap[1]


def test_token_span_from_background_thread():
    perf.enable()
    tok = perf.round_token()

    def worker():
        with perf.span("checkpoint", round_id=tok):
            time.sleep(0.01)

    th = threading.Thread(target=worker)
    perf.end_round()                 # the round closes while work is queued
    th.start()
    th.join()
    perf.end_round()
    snap = perf.snapshot()
    assert snap[0].get("checkpoint", 0.0) >= 0.01
    assert "checkpoint" not in snap[1]


def test_async_writer_attributes_by_submission_round(monkeypatch, tmp_path):
    """The writer's save runs rounds after the submit; its checkpoint span
    still lands in the SUBMISSION round's bucket."""
    release = threading.Event()
    saved = []

    def slow_save(ckpt_dir, state, keep_last=None):
        release.wait(timeout=30)
        saved.append(state.round_index)

    monkeypatch.setattr(fedstate, "save_round", slow_save)
    perf.enable()
    writer = fedstate.AsyncCheckpointWriter(str(tmp_path))
    state = fedstate.FedState(round_index=1,
                              arrays={"w": torch.zeros(2)},
                              history={}, meta={})
    writer.submit(state)             # submitted during round 0
    perf.end_round()                 # rounds advance past the pending write
    perf.end_round()
    release.set()
    writer.close()
    perf.end_round()
    assert saved == [1]
    snap = perf.snapshot()
    assert snap[0].get("checkpoint", 0.0) > 0.0, snap
    assert all("checkpoint" not in b for b in snap[1:]), snap


@pytest.mark.parametrize("algorithm", ["fedsikd", "fedavg"])
def test_packed_run_fills_every_round_bucket(algorithm, tmp_path):
    perf.enable()
    port_run({**PACKED, "algorithm": algorithm, "num_clusters": 2,
              "teacher_warmup_epochs": 1, "rounds": 2},
             ckpt_dir=str(tmp_path))
    snap = perf.snapshot()
    assert len(snap) == 2
    for bucket in snap:
        assert {"round_total", "eval", "checkpoint", "stage", "compute",
                "aggregate"} <= set(bucket), bucket
        assert bucket["round_total"] >= bucket["compute"] > 0.0
    # round 1 gathers its 3 waves; round 2 finds them all in the LRU
    assert snap[0]["stage_wait"] > 0.0 and "stage_wait" not in snap[1]
