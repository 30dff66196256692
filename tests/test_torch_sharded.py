"""The port's packed engine and k-means assignment against the JAX
package's, on the CPU (the kernels' plain versions; the JAX kernels in
Pallas interpret mode).

- ``ops.kmeans_assign`` against the Pallas kernel's wrapper: assignments
  exactly equal, distances within 1e-4 (``tests/test_kernels.py``'s
  tolerance), including the clustering step's (40, 2352) shape, an N that
  is not a multiple of 128 and a constructed tie.  The port's Lloyd loop
  against JAX ``_lloyd`` from the same start: equal assignments, centroids
  within 1e-5.
- The packed operators and the packed round programs against JAX's on a
  one-device mesh with ``pack = S`` (every slot on the one device, the
  layout the port has): float32 arithmetic in another order, so 1e-6 on
  one contraction and 1e-5 after three optimizer steps.  Small dense models
  stand in for the CNNs there, so the JAX programs compile in seconds; the
  whole-run test below drives the CNNs.
- A whole packed run against the JAX packed run, given the JAX run's
  clusters and initial params (torch cannot draw ``jax.random``'s bits):
  accuracy within 1 point each round, losses within 1e-4 relative.
- ``pack`` changes no result; a HAR run learns; the stager adopts a
  matching prefetch and never a mispredicted one; the knobs the packed
  engine does not port raise naming their ROADMAP item, and its
  checkpoints match the JAX package's.
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core import cluster_collectives as jcc
from repro.core import kmeans as jkmeans
from repro.data.synthetic import load_dataset as jax_load_dataset
from repro.fed import sharded as jsh
from repro.fed.algorithms import clustered_kd as jckd
from repro.fed.rounds import FedConfig as JaxFedConfig
from repro.fed.rounds import run_federated as jax_run_federated
from repro.kernels import ops as jops
from repro.launch.mesh import make_fed_client_mesh
from repro.optim import adamw as jax_adamw
from repro_torch import convert
from repro_torch.core import cluster_collectives as cc
from repro_torch.core import kmeans as port_kmeans
from repro_torch.data.synthetic import load_dataset
from repro_torch.fed import sharded as sh
from repro_torch.fed.algorithms import clustered_kd as port_ckd
from repro_torch.fed.rounds import FedConfig, run_federated
from repro_torch.fed.schedule import RoundScheduler
from repro_torch.kernels import ops
from repro_torch.optim import AdamState, adamw
from test_torch_runtime import run_both

torch.set_num_threads(1)


def _np_tree(tree):
    return jax.tree_util.tree_map(np.asarray, tree)


# ------------------------------------------------------------ kmeans_assign
@pytest.mark.parametrize("N,F,K", [(40, 2352, 2), (40, 2352, 5),
                                   (97, 12, 5), (300, 24, 8)])
def test_kmeans_assign_matches_jax(N, F, K):
    r = np.random.default_rng(N * K + F)
    x = r.standard_normal((N, F)).astype(np.float32)
    c = r.standard_normal((K, F)).astype(np.float32)
    want_a, want_d = jops.kmeans_assign(jnp.asarray(x), jnp.asarray(c),
                                        interpret=True)
    a, d = ops.kmeans_assign(torch.from_numpy(x), torch.from_numpy(c))
    assert a.dtype == torch.int32 and d.dtype == torch.float32
    np.testing.assert_array_equal(a.numpy(), np.asarray(want_a))
    np.testing.assert_allclose(d.numpy(), np.asarray(want_d), rtol=1e-4,
                               atol=1e-4)


def test_kmeans_assign_tie_goes_to_the_lowest_index():
    # point 0 is equidistant from every centroid; points 1-2 sit on the
    # duplicated centroid (rows 1 and 3); exact in float32
    c = np.zeros((4, 6), np.float32)
    c[0, 0], c[1, 1], c[2, 0], c[3, 1] = 1.0, 2.0, -1.0, 2.0
    x = np.zeros((3, 6), np.float32)
    x[1, 1], x[2, 1] = 2.0, 2.5
    want_a, want_d = jops.kmeans_assign(jnp.asarray(x), jnp.asarray(c),
                                        interpret=True)
    a, d = ops.kmeans_assign(torch.from_numpy(x), torch.from_numpy(c))
    np.testing.assert_array_equal(a.numpy(), np.asarray(want_a))
    np.testing.assert_array_equal(a.numpy(), [0, 1, 1])
    np.testing.assert_allclose(d.numpy(), np.asarray(want_d), atol=1e-6)


@pytest.mark.parametrize("F,k,k_cap", [(48, 3, 5), (2352, 4, 4)])
def test_lloyd_matches_jax(F, k, k_cap):
    r = np.random.default_rng(F + k)
    centres = r.standard_normal((k, F)).astype(np.float32) * 3
    x = (centres[r.integers(0, k, 40)]
         + r.standard_normal((40, F)).astype(np.float32))
    cents0 = np.zeros((k_cap, F), np.float32)
    cents0[:k] = x[r.choice(40, k, replace=False)]
    want = jkmeans._lloyd(jnp.asarray(x), jnp.asarray(cents0), k, k_cap, 10)
    got = port_kmeans._lloyd(torch.from_numpy(x), torch.from_numpy(cents0),
                             k, k_cap, 10)
    np.testing.assert_array_equal(got.assignments.numpy(),
                                  np.asarray(want.assignments))
    np.testing.assert_allclose(got.centroids.numpy(),
                               np.asarray(want.centroids), rtol=1e-5,
                               atol=1e-5)
    np.testing.assert_allclose(float(got.inertia), float(want.inertia),
                               rtol=1e-4)


# ------------------------------------------------------- packed operators
S = 4
LABELS = np.asarray([0, 0, 1, 1])


def _plan():
    """Slots 0-1 host cluster 0, slot 3 cluster 1, slot 2 is idle."""
    sch = RoundScheduler(LABELS, participation="uniform", clients_per_round=3,
                         pack=S, seed=5)
    for rnd in range(1, 50):
        plan = sch.plan(rnd)
        if plan.active.sum() == 3 and len(set(plan.slot_cluster) - {-1}) == 2:
            return plan
    raise AssertionError("no plan with an idle slot and both clusters")


def _jax_on_one_device(fn):
    from jax.sharding import PartitionSpec as P
    mesh = make_fed_client_mesh(S, pack=S)
    return jax.jit(jsh.shard_map(fn, mesh, in_specs=(P(jsh.AXIS), P()),
                                 out_specs=P(jsh.AXIS)))


def test_packed_operators_match_jax():
    plan = _plan()
    r = np.random.default_rng(0)
    tree = {"a": r.standard_normal((S, 3, 5)).astype(np.float32),
            "b": r.standard_normal((S, 7)).astype(np.float32),
            "n": np.asarray([3, 1, 0, 2], np.int32)}
    sync, row = plan.sync_matrix(), plan.agg_row()
    j_sync = _jax_on_one_device(
        lambda t, m: jcc.packed_teacher_sync(t, jsh.AXIS, m, pack=S))
    j_mean = _jax_on_one_device(
        lambda t, w: jcc.packed_weighted_mean(t, jsh.AXIS, w, pack=S))
    port_tree = {k: torch.from_numpy(v) for k, v in tree.items()}
    for got, want in (
            (cc.packed_teacher_sync(port_tree, torch.from_numpy(sync)),
             j_sync(tree, sync)),
            (cc.packed_weighted_mean(
                {k: v for k, v in port_tree.items() if k != "n"},
                torch.from_numpy(row)),
             j_mean({k: v for k, v in tree.items() if k != "n"}, row))):
        for k, v in got.items():
            np.testing.assert_allclose(v.numpy(), np.asarray(want[k]),
                                       rtol=1e-6, atol=1e-6, err_msg=k)
    synced = cc.packed_teacher_sync(port_tree, torch.from_numpy(sync))
    np.testing.assert_array_equal(synced["n"].numpy(), tree["n"])
    assert synced["n"].dtype == torch.int32


# ---------------------------------------------------- packed round programs
FEAT, V, B, T = 12, 10, 8, 3
BUDGETS = np.asarray([3, 1, 0, 2], np.int32)


def _jax_dense(p, x, train=False, key=None):
    del train, key
    h = jnp.tanh(x.reshape(x.shape[0], -1) @ p["h"]["w"] + p["h"]["b"])
    return h @ p["o"]["w"] + p["o"]["b"]


def _port_dense(p, x, train=False, keep=None):
    del train, keep
    h = torch.tanh(x.reshape(x.shape[0], -1) @ p["h.w"] + p["h.b"])
    return h @ p["o.w"] + p["o.b"]


def _dense_stack(r, hidden):
    return {"h": {"w": r.standard_normal((S, FEAT, hidden)).astype(np.float32)
                  * 0.5, "b": np.zeros((S, hidden), np.float32)},
            "o": {"w": r.standard_normal((S, hidden, V)).astype(np.float32)
                  * 0.5, "b": r.standard_normal((S, V)).astype(np.float32)}}


def _batches(r):
    x = r.standard_normal((S, T, B, FEAT)).astype(np.float32)
    y = r.integers(0, V, (S, T, B)).astype(np.int32)
    y[:, :, -2:] = -1                     # padded tails
    return x, y


def _zeros_adam(tree):
    z = jax.tree_util.tree_map(np.zeros_like, tree)
    return z, z, np.zeros(S, np.int32)


def _port_adam(state):
    return convert.adam_from_jax(state, stacked=True)


def _assert_stack_close(got, want, tol, what):
    want = dict(convert._flatten(want))
    for k, v in convert._flatten(convert.params_to_jax(got, stacked=True)):
        np.testing.assert_allclose(v, want[k], rtol=tol, atol=tol,
                                   err_msg=f"{what} {k}")


def _assert_adam_close(got: AdamState, want, tol, what):
    _assert_stack_close(got.mu, want.mu, tol, what + " mu")
    _assert_stack_close(got.nu, want.nu, tol, what + " nu")
    np.testing.assert_array_equal(got.count.numpy(), np.asarray(want.count))


def test_packed_teacher_phase_matches_jax():
    r = np.random.default_rng(1)
    tp = _dense_stack(r, 16)
    ts = _zeros_adam(tp)
    x, y = _batches(r)
    plan = _plan()
    sync = plan.sync_matrix()
    mesh = make_fed_client_mesh(S, pack=S)
    jopt = jax_adamw(1e-2)
    phase = jsh.make_packed_teacher_phase(mesh, S, _jax_dense, jopt,
                                          donate=False)
    keys = jax.random.split(jax.random.PRNGKey(0), S)
    from repro.optim.optimizers import AdamState as JaxAdamState
    jtp, jts, jloss = phase(tp, JaxAdamState(*ts), x, y, BUDGETS, keys, sync)
    port = sh.make_packed_teacher_phase(_port_dense, adamw(1e-2))
    ptp, pts, ploss = port(convert.params_from_jax(tp, stacked=True),
                           _port_adam(ts), torch.from_numpy(x),
                           torch.from_numpy(y), BUDGETS,
                           np.arange(S), torch.from_numpy(sync))
    _assert_stack_close(ptp, _np_tree(jtp), 1e-5, "tp")
    _assert_adam_close(pts, _np_tree(jts), 1e-5, "ts")
    np.testing.assert_allclose(float(ploss), float(jloss), rtol=1e-5)
    np.testing.assert_array_equal(pts.count.numpy(), BUDGETS)


@pytest.mark.parametrize("kd_impl", ["fused", "reference"])
def test_packed_kd_round_matches_jax(kd_impl):
    r = np.random.default_rng(2)
    tp, sp = _dense_stack(r, 16), _dense_stack(r, 8)
    # every slot starts from one global student, as the engine stages it
    sp = jax.tree_util.tree_map(lambda a: np.repeat(a[:1], S, 0), sp)
    ts, ss = _zeros_adam(tp), _zeros_adam(sp)
    tx, ty = _batches(r)
    sx, sy = _batches(r)
    t_n, s_n = BUDGETS, np.asarray([2, 3, 0, 1], np.int32)
    plan = _plan()
    sync, row = plan.sync_matrix(), plan.agg_row()
    mesh = make_fed_client_mesh(S, pack=S)
    jt_opt, js_opt = jax_adamw(1e-2), jax_adamw(3e-2)
    round_fn = jsh.make_packed_kd_round(
        mesh, S, _jax_dense, _jax_dense, jt_opt, js_opt, kd_temperature=2.0,
        kd_alpha=0.5, kd_impl=kd_impl, donate=False)
    keys = jax.random.split(jax.random.PRNGKey(0), S)
    from repro.optim.optimizers import AdamState as JaxAdamState
    want = _np_tree(round_fn(tp, JaxAdamState(*ts), sp, JaxAdamState(*ss),
                             tx, ty, t_n, sx, sy, s_n, keys, keys, sync,
                             row))
    port_fn = sh.make_packed_kd_round(
        _port_dense, _port_dense, adamw(1e-2), adamw(3e-2),
        kd_temperature=2.0, kd_alpha=0.5, kd_impl=kd_impl)
    got = port_fn(convert.params_from_jax(tp, stacked=True), _port_adam(ts),
                  convert.params_from_jax(sp, stacked=True), _port_adam(ss),
                  torch.from_numpy(tx), torch.from_numpy(ty), t_n,
                  torch.from_numpy(sx), torch.from_numpy(sy), s_n,
                  np.arange(S), np.arange(S), sync, row)
    assert len(got) == len(want) == 7
    _assert_stack_close(got[0], want[0], 1e-5, "tp")
    _assert_adam_close(got[1], want[1], 1e-5, "ts")
    _assert_stack_close(got[2], want[2], 1e-5, "sp")
    _assert_stack_close(got[3], want[3], 1e-5, "sp_local")
    _assert_adam_close(got[4], want[4], 1e-5, "ss")
    for g, w in zip(got[5:], want[5:]):
        np.testing.assert_allclose(float(g), float(w), rtol=1e-5)
    np.testing.assert_array_equal(got[4].count.numpy(), s_n)


def test_kd_loss_lanes_is_the_per_lane_loss():
    """One call on (S, B, V) equals the fused loss of each lane alone, in
    value and gradient, and JAX's vmapped fused loss in value."""
    r = np.random.default_rng(3)
    s = r.standard_normal((S, B, V)).astype(np.float32) * 2
    t = r.standard_normal((S, B, V)).astype(np.float32) * 2
    y = r.integers(-1, V, (S, B)).astype(np.int32)
    y[2] = -1                                  # a lane with no valid row
    sg = torch.from_numpy(s).requires_grad_(True)
    lanes = ops.kd_distillation_loss_lanes(sg, torch.from_numpy(t),
                                           torch.from_numpy(y), tau=3.0,
                                           alpha=0.25)
    w = torch.arange(1.0, S + 1)
    (lanes * w).sum().backward()
    for i in range(S):
        si = torch.from_numpy(s[i]).requires_grad_(True)
        one = ops.kd_distillation_loss(si, torch.from_numpy(t[i]),
                                       torch.from_numpy(y[i]), 3.0, 0.25)
        (one * w[i]).backward()
        torch.testing.assert_close(lanes[i], one, rtol=1e-6, atol=1e-7)
        torch.testing.assert_close(sg.grad[i], si.grad, rtol=1e-6, atol=1e-7)
    want = jax.vmap(lambda a, b, c: jops.kd_distillation_loss_batched(
        a, b, c, tau=3.0, alpha=0.25, interpret=True))(s, t, y)
    np.testing.assert_allclose(lanes.detach().numpy(), np.asarray(want),
                               rtol=1e-5, atol=1e-6)


# ------------------------------------------------------------- whole runs
PARITY = dict(algorithm="fedsikd", engine="sharded", num_clients=6,
              alpha=1.0, rounds=2, local_epochs=1, teacher_warmup_epochs=1,
              batch_size=32, num_clusters=2, seed=0, pack=6)


def test_packed_run_matches_jax(monkeypatch):
    # 1. the JAX packed run, keeping its clusters and initial params
    seen = {}
    jax_warmup = jckd.ShardedClusteredKD.warmup

    def capture(self):
        seen.update(labels=np.asarray(self.labels),
                    centroids=np.asarray(self.centroids),
                    student=_np_tree(self.sp_global),
                    teachers=_np_tree(self.tp_k))
        jax_warmup(self)

    monkeypatch.setattr(jckd.ShardedClusteredKD, "warmup", capture)
    h_jax = jax_run_federated(jax_load_dataset("mnist", small=True),
                              JaxFedConfig(**PARITY, donate=False))

    # 2. the port, seeded with them
    labels = seen["labels"]

    def injected_kmeans(seed, feats, k, iters=50):
        assert k == PARITY["num_clusters"] and feats.shape[0] == len(labels)
        return port_kmeans.KMeansResult(
            torch.from_numpy(seen["centroids"]),
            torch.from_numpy(labels.astype(np.int32)), torch.zeros(()))

    monkeypatch.setattr(port_kmeans, "kmeans", injected_kmeans)
    monkeypatch.setattr(port_ckd.ShardedClusteredKD, "_init_student",
                        lambda self: convert.params_from_jax(seen["student"]))
    monkeypatch.setattr(port_ckd.ShardedClusteredKD, "_init_teacher_stack",
                        lambda self: convert.params_from_jax(
                            seen["teachers"], stacked=True))
    h = run_federated(load_dataset("mnist", small=True), FedConfig(**PARITY),
                      device="cpu")

    for key in ("round", "participants", "num_clusters", "algorithm",
                "engine", "participation", "dropout_rate", "pack"):
        assert h[key] == h_jax[key], key
    for rnd, (a, b) in enumerate(zip(h["acc"], h_jax["acc"]), 1):
        assert abs(a - b) <= 0.01, (rnd, h["acc"], h_jax["acc"])
    for key in ("loss", "teacher_loss", "student_loss"):
        np.testing.assert_allclose(h[key], h_jax[key], rtol=1e-4,
                                   err_msg=key)


def _port_run(**kw):
    return run_federated(load_dataset("mnist", small=True),
                         FedConfig(**{**PARITY, **kw}), device="cpu")


def test_pack_changes_no_result():
    a, b = _port_run(pack=6), _port_run(pack=2)
    assert (a["pack"], b["pack"]) == (6, 2)
    for key in ("acc", "loss", "teacher_loss", "student_loss"):
        np.testing.assert_allclose(a[key], b[key], rtol=1e-6, atol=1e-6,
                                   err_msg=key)


def test_packed_run_matches_the_loop_engine():
    """The engines run the same clusters, init and batches; only the order
    of the sums differs (grouped convolutions under vmap, the teacher sync),
    and some 30 Adam steps carry it forward.  Measured gaps: 0.75 points of
    accuracy, 1.7e-3 relative eval loss, 4e-4 relative teacher and student
    loss.  Held to the JAX packed-vs-loop bound of 3 points
    (tests/test_sharded_kd.py) and to 1e-2 relative on every loss, the bound
    chip_smoke.py holds on the card at full size."""
    packed, loop = _port_run(), _port_run(engine="loop", pack=1)
    np.testing.assert_allclose(packed["acc"], loop["acc"], atol=0.03)
    for key in ("loss", "teacher_loss", "student_loss"):
        np.testing.assert_allclose(packed[key], loop[key], rtol=1e-2,
                                   err_msg=key)


def test_har_packed_run_learns():
    """HAR's dropout masks come from per-lane generators: finite metrics, and
    the student's train and test losses fall (a 240-example cut of the small
    twin keeps the 4.6M-weight HAR models quick on one CPU core)."""
    ds = load_dataset("har", small=True)
    ds = dataclasses.replace(ds, x_train=ds.x_train[:240],
                             y_train=ds.y_train[:240],
                             x_test=ds.x_test[:200], y_test=ds.y_test[:200])
    h = run_federated(ds, FedConfig(**{**PARITY, "num_clients": 3,
                                       "pack": 3}), device="cpu")
    vals = h["acc"] + h["loss"] + h["teacher_loss"] + h["student_loss"]
    assert all(np.isfinite(vals)), vals
    assert h["loss"][-1] < h["loss"][0], h["loss"]
    assert h["student_loss"][-1] < h["student_loss"][0], h["student_loss"]


# ------------------------------------------------------------- the stager
def test_wave_stager_adopts_a_matching_prefetch_only(monkeypatch):
    sch = RoundScheduler(np.asarray([0, 0, 1, 1, 1]),
                         participation="uniform", clients_per_round=3,
                         seed=1)
    plans = [sch.plan(r) for r in range(1, 8)]
    a = next(p for p in plans if p.slot_client.tolist()
             != plans[0].slot_client.tolist())
    b = plans[0]
    xs = np.arange(5 * 2, dtype=np.float32).reshape(5, 2)
    stager = sh.WaveStager(xs, device="cpu")
    gathers = []
    real = sh.stage_on_slots
    monkeypatch.setattr(sh, "stage_on_slots",
                        lambda plan, *arr, **kw: gathers.append(
                            plan.slot_client.tolist()) or real(plan, *arr,
                                                               **kw))
    stager.prefetch(a)
    stager._pending[1].join(timeout=30)
    staged_a = stager.stage(a)                     # adopted: no new gather
    assert gathers == [a.slot_client.tolist()]
    cid = np.where(a.active, a.slot_client, 0)
    np.testing.assert_array_equal(staged_a[0].numpy(), xs[cid])
    stager.prefetch(a)                             # already staged: no-op
    assert gathers == [a.slot_client.tolist()]
    stager.prefetch(b)                             # mispredicted below
    stager._pending[1].join(timeout=30)
    c = next(p for p in plans if p.slot_client.tolist()
             not in (a.slot_client.tolist(), b.slot_client.tolist()))
    staged_c = stager.stage(c)                     # gathered synchronously
    assert gathers[-1] == c.slot_client.tolist() and len(gathers) == 3
    assert stager._pending[0] == b.slot_client.tobytes()  # not adopted
    np.testing.assert_array_equal(
        staged_c[0].numpy(), xs[np.where(c.active, c.slot_client, 0)])


# ------------------------------------------------------ knobs not ported
@pytest.mark.parametrize("knob", [
    {"universe": 12},
    {"waves": 2},
    {"n_devices": 2, "pack": 1},
    {"guards": True},
    {"async_mode": True},
    {"join_schedule": ((2, 1),)},
], ids=lambda k: ",".join(k))
def test_packed_unported_knobs_raise(knob):
    cfg = FedConfig(**{**PARITY, "pack": 1, **knob})
    with pytest.raises(NotImplementedError, match="ROADMAP Queue 1 item 9"):
        run_federated(load_dataset("mnist", small=True), cfg, device="cpu")


@pytest.mark.parametrize("knob", [
    {"ckpt_dir": "ckpt"},
    {"dp_noise": 0.05},
], ids=lambda k: ",".join(k))
def test_packed_runtime_knob_matches_jax(knob, monkeypatch, tmp_path):
    """The runtime knobs the packed engine runs, against JAX's run
    (``test_torch_runtime.run_both``): checkpoints write the JAX package's
    keys, shapes and dtypes (the (K, ...) teacher stacks and their Adam
    states); ``dp_noise`` clusters on DP-noised statistics, given JAX's
    draws."""
    run_both({**PARITY, **knob}, monkeypatch, tmp_path)


def test_convert_stacked_round_trip():
    r = np.random.default_rng(4)
    tree = {"conv": [{"w": r.standard_normal((3, 3, 3, 1, 4)).astype(
        np.float32), "b": r.standard_normal((3, 4)).astype(np.float32)}],
        "head": {"w": r.standard_normal((3, 6, 2)).astype(np.float32)}}
    port = convert.params_from_jax(tree, stacked=True)
    assert port["conv.0.w"].shape == (3, 4, 1, 3, 3)
    for k in range(3):
        one = convert.params_from_jax(
            jax.tree_util.tree_map(lambda a: a[k], tree))
        for name, v in one.items():
            assert torch.equal(port[name][k], v), name
    back = dict(convert._flatten(convert.params_to_jax(port, stacked=True)))
    for name, v in convert._flatten(tree):
        np.testing.assert_array_equal(back[name], v)
    state = (tree, tree, np.asarray([1, 2, 3], np.int32))
    st = convert.adam_from_jax(state, stacked=True)
    assert st.count.tolist() == [1, 2, 3]
    assert convert.adam_to_jax(st, stacked=True)[2].tolist() == [1, 2, 3]
