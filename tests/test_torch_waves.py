"""The port's packed engine at cross-device scale against the JAX package's,
on the CPU: wave-scheduled rounds, a virtual client universe, packed
semi-async rounds and the packed client lifecycle.

- The wave folds (``fold_partials``, ``add_scaled``), the packed async
  split (``packed_async_row``), ``merge_arrivals_only``, ``forced_devices``
  and ``fed_mesh_layout`` against JAX's, within 1e-6 (the layouts equal).
- ``WaveStager``: cold stage, adopted prefetch, a mispredicted prefetch
  that stays adoptable, LRU hits returning the same tensors, the capacity
  bound, the pending dict's eviction, ``row_maps``, and the overlap
  accounting (``tests/test_waves.py``'s stager script, in-process here).
  ``take_rows`` returns a copy of the lane, not a view of the stack.
- Whole runs through both packages with ``test_torch_runtime.run_both``
  (the JAX run's clusters and initial params injected; JAX's packed engine
  in-process on one device with ``n_devices=1``): multi-wave FedSiKD and
  multi-wave FedAvg under stratified sampling, dropout and async rounds
  within 1e-4 relative loss; packed lifecycle + async FedSiKD and FedAvg
  with equal ``labels_history``, participants and buffer counts (1 point,
  1e-3, the bounds of the other runtime files).
- Explicit wave knobs that give one wave are bit-identical to the
  knobless run; a universe run's labels equal JAX's and its k-means runs
  over the base pool; a kill-and-resume with a universe store is
  bit-identical on the CPU.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core import aggregation as jagg
from repro.fed.algorithms import base as jbase
from repro.fed.driver import AsyncUpdate as JaxAsyncUpdate
from repro.launch import mesh as jmesh
from repro_torch import guards, perf
from repro_torch.core import aggregation as agg
from repro_torch.fed import schedule
from repro_torch.fed import sharded as sh
from repro_torch.fed.algorithms import base
from repro_torch.fed.algorithms import clustered_kd as port_ckd
from repro_torch.fed.driver import AsyncUpdate
from repro_torch.fed.lifecycle import ClientLifecycle
from repro_torch.fed.rounds import FedConfig
from repro_torch.fed.schedule import RoundScheduler
from test_torch_runtime import port_run, run_both

torch.set_num_threads(1)

WAVES = dict(algorithm="fedsikd", engine="sharded", num_clients=6,
             alpha=1.0, rounds=2, local_epochs=1, teacher_warmup_epochs=1,
             batch_size=32, num_clusters=2, seed=0)
FLOATS = ("loss", "teacher_loss", "student_loss", "train_loss")


def _tree(seed, shapes=((3, 4), (5,), (2, 2, 3))):
    r = np.random.default_rng(seed)
    return {f"l{i}": r.standard_normal(s).astype(np.float32)
            for i, s in enumerate(shapes)}


def _torch(tree):
    return {k: torch.from_numpy(v.copy()) for k, v in tree.items()}


def _close(port, jax_tree, tol=1e-6):
    for k, v in port.items():
        np.testing.assert_allclose(v.numpy(), np.asarray(jax_tree[k]),
                                   rtol=tol, atol=tol, err_msg=k)


def _losses_within(h, h_jax, rtol):
    for key in FLOATS:
        if key in h_jax:
            np.testing.assert_allclose(h[key], h_jax[key], rtol=rtol,
                                       err_msg=key)


# ------------------------------------------------------------ wave folds
@pytest.mark.parametrize("n_parts", [1, 2, 3])
def test_fold_partials_matches_jax(n_parts):
    parts = [_tree(i) for i in range(n_parts)]
    got = agg.fold_partials([_torch(p) for p in parts])
    want = jagg.fold_partials([jax.tree_util.tree_map(jnp.asarray, p)
                               for p in parts])
    _close(got, want)
    one = _torch(parts[0])
    assert agg.fold_partials([one]) is one      # one wave: untouched
    with pytest.raises(ValueError):
        agg.fold_partials([])


@pytest.mark.parametrize("scale", [0.0, 0.37, 1.5])
def test_add_scaled_and_tree_ops_match_jax(scale):
    a, p = _tree(1), _tree(2)
    jt = [jax.tree_util.tree_map(jnp.asarray, t) for t in (a, p)]
    _close(agg.add_scaled(_torch(a), _torch(p), scale),
           jagg.add_scaled(*jt, scale))
    _close(agg.tree_add(_torch(a), _torch(p)), jagg.tree_add(*jt))
    _close(agg.tree_scale(_torch(a), scale), jagg.tree_scale(jt[0], scale))


def _arrivals(pairs, cls):
    return [cls(client=i, birth=b, arrival=b + s, weight=w, params=None)
            for i, (w, b, s) in enumerate(pairs)]


@pytest.mark.parametrize("on_time,pairs", [
    ([True, True, False, True], []),
    ([True, False, False, True], [(0.2, 1, 1), (0.4, 2, 2)]),
    ([False, False, False, False], [(3.0, 1, 1)]),
    ([True, True, True, False], [(12.0, 1, 2), (7.0, 3, 1), (1.0, 2, 2)]),
])
def test_packed_async_row_matches_jax(on_time, pairs):
    w = np.asarray([0.1, 0.3, 0.25, 0.35])
    row, scales = base.packed_async_row(w, on_time,
                                        _arrivals(pairs, AsyncUpdate), 0.5)
    jrow, jscales = jbase.packed_async_row(
        w, on_time, _arrivals(pairs, JaxAsyncUpdate), 0.5)
    assert row.dtype == np.float32
    np.testing.assert_allclose(row, jrow, rtol=1e-6, atol=1e-7)
    np.testing.assert_allclose(scales, jscales, rtol=1e-6)
    # the split reproduces the staleness-normalised weights
    assert abs(row.sum() + sum(scales) - 1.0) < 1e-6


@pytest.mark.parametrize("n", [1, 3])
def test_merge_arrivals_only_matches_jax(n):
    trees = [_tree(10 + i) for i in range(n)]
    meta = [(1.0 + i, 1, 1 + i % 2) for i in range(n)]
    ups = [AsyncUpdate(client=i, birth=b, arrival=b + s, weight=w,
                       params=_torch(t))
           for i, ((w, b, s), t) in enumerate(zip(meta, trees))]
    jups = [JaxAsyncUpdate(client=i, birth=b, arrival=b + s, weight=w,
                           params=jax.tree_util.tree_map(jnp.asarray, t))
            for i, ((w, b, s), t) in enumerate(zip(meta, trees))]
    _close(base.merge_arrivals_only(ups, 0.5),
           jbase.merge_arrivals_only(jups, 0.5))


@pytest.mark.parametrize("kw", [
    dict(num_clients=40, pack=40),
    dict(num_clients=12, pack=2, join_schedule=((2, 3),)),
    dict(num_clients=12, pack=5, clients_per_round=7, participation="uniform",
         leave_rate=0.1),
    dict(num_clients=12, pack=2, n_devices=3),
    dict(num_clients=12, pack=2),
], ids=["static", "joins", "sampled-lifecycle", "pinned", "no-lifecycle"])
def test_forced_devices_matches_jax(kw):
    cfg = FedConfig(engine="sharded", **kw)
    port, jax_alg = base.Algorithm(), jbase.Algorithm()
    port.lifecycle = jax_alg.lifecycle = ClientLifecycle.from_config(cfg)
    assert port.forced_devices(cfg) == jax_alg.forced_devices(cfg)


def test_fed_mesh_layout_matches_jax():
    for n, pack, nd in [(1, 1, None), (8, 2, None), (7, 2, None),
                        (12, 4, 3), (40, 40, None), (5, 3, 2)]:
        assert schedule.fed_mesh_layout(n, pack=pack, n_devices=nd) == \
            jmesh.fed_mesh_layout(n, pack=pack, n_devices=nd)
    for bad in (dict(pack=0), dict(pack=1, n_devices=2)):
        with pytest.raises(ValueError):
            schedule.fed_mesh_layout(8, **bad)


# ------------------------------------------------------------ the stager
def _stager_setup():
    s = RoundScheduler(np.arange(12) % 3, participation="stratified",
                       clients_per_round=8, pack=1, n_devices=2, seed=0)
    x_all = np.arange(12 * 5, dtype=np.float32).reshape(12, 5)
    row_of = np.arange(12) % 4      # an alias map, as a universe's store
    st = sh.WaveStager(x_all, -x_all, device="cpu",
                       row_maps=(row_of, row_of), capacity=3)

    def expect(wp):
        cid = np.where(wp.active, wp.slot_client, 0)
        return x_all[row_of[cid]]

    return s.plan(1), st, expect


def _join(st):
    for th, _ in list(st._pending.values()):
        th.join(timeout=30)


def test_wave_stager_prefetch_rowmaps_and_lru(monkeypatch):
    p, st, expect = _stager_setup()
    assert p.n_waves == 4
    gathers = []
    real = sh.stage_on_slots
    monkeypatch.setattr(sh, "stage_on_slots", lambda plan, *a, **kw: (
        gathers.append(plan.slot_client.tolist()) or real(plan, *a, **kw)))
    xs, ys = st.stage(p.wave(0))                   # cold
    np.testing.assert_array_equal(xs.numpy(), expect(p.wave(0)))
    np.testing.assert_array_equal(ys.numpy(), -expect(p.wave(0)))
    st.prefetch(p.wave(1))                         # prefetch + adopt
    _join(st)
    xs, _ = st.stage(p.wave(1))
    np.testing.assert_array_equal(xs.numpy(), expect(p.wave(1)))
    assert len(gathers) == 2 and not st._pending
    st.prefetch(p.wave(2))                         # mispredicted: wave 3
    xs, _ = st.stage(p.wave(3))                    # is gathered instead
    np.testing.assert_array_equal(xs.numpy(), expect(p.wave(3)))
    assert p.wave(2).slot_client.tobytes() in st._pending
    xs, _ = st.stage(p.wave(2))                    # still adoptable
    np.testing.assert_array_equal(xs.numpy(), expect(p.wave(2)))
    n = len(gathers)
    a, b = st.stage(p.wave(2)), st.stage(p.wave(2))
    assert a[0] is b[0] and len(gathers) == n      # an LRU hit
    st.prefetch(p.wave(2))                         # staged: a no-op
    assert not st._pending and len(gathers) == n
    for w in range(4):
        st.stage(p.wave(w))
    assert len(st._staged) <= 3


def test_wave_stager_evicts_the_oldest_pending_prefetch():
    s = RoundScheduler(np.arange(12) % 3, participation="uniform",
                       clients_per_round=2, seed=3)
    plans = []
    for r in range(1, 40):
        if all(p.slot_client.tolist() != s.plan(r).slot_client.tolist()
               for p in plans):
            plans.append(s.plan(r))
        if len(plans) == 4:
            break
    x_all = np.arange(12 * 3, dtype=np.float32).reshape(12, 3)
    st = sh.WaveStager(x_all, device="cpu", capacity=2)
    for p in plans[:3]:
        st.prefetch(p)
    _join(st)
    keys = [p.slot_client.tobytes() for p in plans]
    assert list(st._pending) == keys[1:3]          # the oldest went
    xs, = st.stage(plans[0])                       # gathered synchronously
    np.testing.assert_array_equal(
        xs.numpy(), x_all[np.where(plans[0].active, plans[0].slot_client,
                                   0)])


def test_wave_stager_overlap_accounting():
    p, st, _ = _stager_setup()
    perf.enable()
    try:
        st.stage(p.wave(0))                        # cold: a wait only
        st.prefetch(p.wave(1))
        _join(st)
        st.stage(p.wave(1))                        # adopted: hidden time
        perf.end_round()
        snap = perf.snapshot()
    finally:
        perf.disable()
    assert snap[0]["stage_wait"] > 0.0 and snap[0]["stage_hidden"] > 0.0


def test_take_rows_copies_the_lane():
    """A lane kept past its round holds only its own storage; a view would
    keep its base, the whole 40-lane stack, alive (``leak_check`` counts
    the bases too)."""
    def stack():
        return {"w": torch.arange(40 * 1000, dtype=torch.float32).reshape(
            40, 1000), "b": torch.ones(40, 3)}

    with guards.leak_check(allow=2, device_type="cpu", context="take_rows"):
        lane = sh.take_rows(stack(), 7)
    assert torch.equal(lane["w"], torch.arange(7000, 8000,
                                               dtype=torch.float32))
    assert lane["w"].untyped_storage().nbytes() == 4 * 1000
    assert lane["w"]._base is None
    with pytest.raises(guards.GuardError, match="4 cpu tensor"):
        with guards.leak_check(allow=2, device_type="cpu"):
            view = {k: v[7] for k, v in stack().items()}
    assert torch.equal(view["w"], lane["w"])


# ------------------------------------------------- whole runs against JAX
def test_multi_wave_fedsikd_matches_jax(monkeypatch, tmp_path):
    """6 clients through 3 waves of 2 slots.  (At 8 clients round 2's
    student loss is 2-5e-4 relative from JAX's with one wave and with
    four alike — as far as JAX's own one-wave and four-wave runs are from
    each other: float32 noise that Adam's first step amplifies there.)"""
    h, h_jax = run_both({**WAVES, "pack": 2, "n_devices": 1}, monkeypatch,
                        tmp_path)
    _losses_within(h, h_jax, 1e-4)


def test_multi_wave_fedavg_sampling_dropout_async_matches_jax(
        monkeypatch, tmp_path):
    """3 waves of 2 slots; stragglers, dropout and staleness-decayed merges
    cross wave boundaries (``tests/test_waves.py``'s loop-parity config)."""
    kw = dict(WAVES, algorithm="fedavg", num_clients=8, rounds=3, pack=2,
              n_devices=1,
              participation="stratified", clients_per_round=6,
              dropout_rate=0.2, async_mode=True, straggler_frac=0.4,
              max_staleness=2)
    h, h_jax = run_both(kw, monkeypatch, tmp_path)
    assert sum(h["stragglers"]) > 0 and sum(h["stale_merged"]) > 0
    _losses_within(h, h_jax, 1e-4)


@pytest.mark.parametrize("kw", [
    dict(algorithm="fedsikd", num_clients=6, join_schedule=((2, 2),),
         recluster_every=2, async_mode=True, straggler_frac=0.5, rounds=3),
    dict(algorithm="fedavg", num_clients=6, leave_rate=0.2,
         join_schedule=((2, 1),), async_mode=True, straggler_frac=0.5,
         rounds=3),
], ids=["fedsikd", "fedavg"])
def test_packed_lifecycle_async_matches_jax(kw, monkeypatch, tmp_path):
    """Joins, leaves and warm re-clustering with stragglers, 2 waves of 2
    slots: the plan keys (``labels_history``, participants, the buffer's
    counts) equal JAX's."""
    h, h_jax = run_both({**WAVES, "pack": 2, "n_devices": 1, **kw},
                        monkeypatch, tmp_path)
    assert sum(h["stale_merged"]) > 0
    if kw["algorithm"] == "fedsikd":
        assert len(h["labels_history"]) >= 2


@pytest.mark.parametrize("algorithm", ["fedsikd", "fedavg"])
def test_one_wave_with_explicit_knobs_is_bit_identical(algorithm):
    kw = dict(WAVES, algorithm=algorithm, pack=2)
    plain = port_run(kw)
    knobs = port_run({**kw, "universe": 6, "n_devices": 3, "waves": 1})
    for key in ("acc", "loss", *FLOATS):
        assert plain.get(key) == knobs.get(key), key


def test_universe_labels_match_jax_over_the_base_pool(monkeypatch, tmp_path):
    """An 18-client universe over 6 base shards: the port's statistics
    and k-means see the 6 base rows, and its labels (18) equal JAX's."""
    seen_rows = []
    real = port_ckd.stat_features

    def rows(shards, cfg, roster=None, **kw):
        seen_rows.append(len(roster))
        return real(shards, cfg, roster, **kw)

    monkeypatch.setattr(port_ckd, "stat_features", rows)
    kw = dict(WAVES, universe=18, pack=3, n_devices=1,
              participation="stratified", clients_per_round=6)
    h, h_jax = run_both(kw, monkeypatch, tmp_path)
    assert seen_rows == [6]
    assert h["participants"] == [6, 6]
    _losses_within(h, h_jax, 1e-4)


def test_universe_resume_is_bit_identical(tmp_path):
    kw = dict(WAVES, num_clients=6, universe=12, rounds=4, pack=1,
              n_devices=2, participation="stratified", clients_per_round=4,
              ckpt_every=1)
    full = port_run(kw, ckpt_dir=str(tmp_path / "a"))
    port_run({**kw, "rounds": 2}, ckpt_dir=str(tmp_path / "b"))
    res = port_run({**kw, "resume": True}, ckpt_dir=str(tmp_path / "b"))
    for key in ("round", "acc", "loss", "teacher_loss", "student_loss",
                "participants"):
        assert res[key] == full[key], key
