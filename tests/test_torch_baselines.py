"""The port's baselines (FedAvg, FedProx, FL+HC) against the JAX package's,
on the CPU (the fused merge's plain version; JAX's jnp merge).

- Whole loop-engine FedAvg and FedProx runs against the JAX loop engine.
  Torch cannot draw ``jax.random``'s bits, so the port is handed the JAX
  run's initial params (``_init_params`` patched here, in the test).  The
  batch order is shared, so only float32 rounding differs: per-round
  accuracy within 1 point, loss within 1e-3 relative.
- One packed baseline round (S = 4, two idle slots, FedProx on and off)
  against JAX's ``make_packed_baseline_round`` on a one-device mesh with
  ``pack = S``: params, ``p_local``, Adam state and loss within 1e-5 (small
  dense models stand in for the CNN, as in ``tests/test_torch_sharded.py``).
- The packed engine against the loop engine in the port, through
  stratified sampling and dropout (the JAX ``tests/test_baseline_parity.py``
  scenario): equal participants, accuracy within 1 point.
- ``hierarchical.agglomerative`` against the JAX copy: equal labels.  A
  whole FL+HC run against JAX from the same initial params: equal cluster
  labels, accuracy within 1 point, loss within 1e-3 relative.
- The runtime knobs the baselines run on the loop engine (resume from a
  JAX checkpoint, the client lifecycle, DP noise) and on the packed engine
  (a virtual universe, waves, the guards, async rounds, the lifecycle)
  against JAX's runs.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core import aggregation as jagg
from repro.core import hierarchical as jhier
from repro.data.synthetic import load_dataset as jax_load_dataset
from repro.fed import sharded as jsh
from repro.fed.rounds import FedConfig as JaxFedConfig
from repro.fed.rounds import run_federated as jax_run_federated
from repro.launch.mesh import make_fed_client_mesh
from repro.models import cnn as jcnn
from repro.optim import adamw as jax_adamw
from repro.optim.optimizers import AdamState as JaxAdamState
from repro_torch import convert
from repro_torch.core import aggregation as agg
from repro_torch.core import hierarchical
from repro_torch.data.pipeline import make_client_shards
from repro_torch.data.synthetic import load_dataset
from repro_torch.fed import sharded as sh
from repro_torch.fed.algorithms import baselines
from repro_torch.fed.algorithms import flhc as port_flhc
from repro_torch.fed.rounds import FedConfig, run_federated
from repro_torch.optim import adamw
from test_torch_runtime import run_both

torch.set_num_threads(1)

RUN = dict(engine="loop", num_clients=6, alpha=1.0, rounds=2,
           local_epochs=1, batch_size=32, seed=0)


def _np_tree(tree):
    return jax.tree_util.tree_map(np.asarray, tree)


def _jax_teacher_init(seed=0):
    """The initial params both JAX strategies draw: the teacher CNN from
    ``PRNGKey(cfg.seed)``."""
    init, _ = jcnn.make_model("mnist", student=False)
    return _np_tree(init(jax.random.PRNGKey(seed)))


def _assert_same_history(h, h_jax, keys):
    for key in keys:
        assert h[key] == h_jax[key], key
    for rnd, (a, b) in enumerate(zip(h["acc"], h_jax["acc"]), 1):
        assert abs(a - b) <= 0.01, (rnd, h["acc"], h_jax["acc"])
    np.testing.assert_allclose(h["loss"], h_jax["loss"], rtol=1e-3)


# --------------------------------------------------------------- loop runs
@pytest.mark.parametrize("algorithm", ["fedavg", "fedprox"])
def test_loop_run_matches_jax(algorithm, monkeypatch):
    """A whole loop-engine run from the JAX run's initial params: accuracy
    within 1 point and loss within 1e-3 relative each round."""
    kw = {**RUN, "algorithm": algorithm}
    h_jax = jax_run_federated(jax_load_dataset("mnist", small=True),
                              JaxFedConfig(**kw))
    init = _jax_teacher_init(kw["seed"])
    monkeypatch.setattr(baselines._BaselineBase, "_init_params",
                        lambda self: convert.params_from_jax(init))
    h = run_federated(load_dataset("mnist", small=True), FedConfig(**kw),
                      device="cpu")
    _assert_same_history(h, h_jax, ("round", "participants", "algorithm",
                                    "engine", "participation",
                                    "dropout_rate"))
    assert len(h["round_seconds"]) == kw["rounds"]


def test_fedavg_is_the_example_weighted_merge():
    """``aggregation.fedavg`` and ``tree_sub`` against the JAX operators on
    three clients' params (1e-6: one weighted sum in float32)."""
    r = np.random.default_rng(0)
    trees = [{"a": r.standard_normal((3, 4)).astype(np.float32),
              "b": r.standard_normal(5).astype(np.float32)}
             for _ in range(3)]
    sizes = [7, 0, 13]                        # a client with no weight
    want = _np_tree(jagg.fedavg(trees, sizes))
    got = agg.fedavg([convert.params_from_jax(t) for t in trees], sizes)
    for k in want:
        np.testing.assert_allclose(got[k].numpy(), want[k], rtol=1e-6,
                                   atol=1e-6)
    diff = agg.tree_sub(convert.params_from_jax(trees[0]),
                        convert.params_from_jax(trees[2]))
    want = _np_tree(jagg.tree_sub(trees[0], trees[2]))
    for k in want:
        np.testing.assert_array_equal(diff[k].numpy(), want[k])
    one = agg.fedavg([convert.params_from_jax(trees[1])], [4])
    for k in one:                             # N = 1 is the input itself
        np.testing.assert_array_equal(one[k].numpy(), trees[1][k])


# --------------------------------------------------- packed baseline round
S, FEAT, V, B, T = 4, 12, 10, 8, 3
BUDGETS = np.asarray([3, 0, 2, 0], np.int32)       # slots 1 and 3 idle
ROW = np.asarray([0.625, 0.0, 0.375, 0.0], np.float32)


def _jax_dense(p, x, train=False, key=None):
    del train, key
    h = jnp.tanh(x.reshape(x.shape[0], -1) @ p["h"]["w"] + p["h"]["b"])
    return h @ p["o"]["w"] + p["o"]["b"]


def _port_dense(p, x, train=False, keep=None):
    del train, keep
    h = torch.tanh(x.reshape(x.shape[0], -1) @ p["h.w"] + p["h.b"])
    return h @ p["o.w"] + p["o.b"]


def _assert_stack_close(got, want, tol, what):
    want = dict(convert._flatten(want))
    for k, v in convert._flatten(convert.params_to_jax(got, stacked=True)):
        np.testing.assert_allclose(v, want[k], rtol=tol, atol=tol,
                                   err_msg=f"{what} {k}")


@pytest.mark.parametrize("prox_mu", [0.5, 0.0], ids=["fedprox", "fedavg"])
def test_packed_baseline_round_matches_jax(prox_mu):
    """One round program, port against JAX, within 1e-5 (float32 sums in
    another order through three Adam steps)."""
    r = np.random.default_rng(5)
    g = {"h": {"w": r.standard_normal((FEAT, 16)).astype(np.float32) * 0.5,
               "b": np.zeros(16, np.float32)},
         "o": {"w": r.standard_normal((16, V)).astype(np.float32) * 0.5,
               "b": r.standard_normal(V).astype(np.float32)}}
    p = jax.tree_util.tree_map(lambda a: np.repeat(a[None], S, 0), g)
    zeros = jax.tree_util.tree_map(np.zeros_like, p)
    x = r.standard_normal((S, T, B, FEAT)).astype(np.float32)
    y = r.integers(0, V, (S, T, B)).astype(np.int32)
    y[:, :, -2:] = -1                                   # padded tails
    mesh = make_fed_client_mesh(S, pack=S)
    round_fn = jsh.make_packed_baseline_round(mesh, S, _jax_dense,
                                              jax_adamw(1e-2),
                                              prox_mu=prox_mu, donate=False)
    keys = jax.random.split(jax.random.PRNGKey(0), S)
    want = _np_tree(round_fn(p, JaxAdamState(zeros, zeros,
                                             np.zeros(S, np.int32)),
                             x, y, BUDGETS, keys, ROW, g))
    port_fn = sh.make_packed_baseline_round(_port_dense, adamw(1e-2),
                                            prox_mu=prox_mu)
    gp = convert.params_from_jax(g)
    p_s = {k: v.expand((S,) + v.shape) for k, v in gp.items()}
    got = port_fn(p_s, sh.stacked_opt_init(adamw(1e-2), p_s),
                  torch.from_numpy(x), torch.from_numpy(y), BUDGETS,
                  np.arange(S), ROW, gp)
    assert len(got) == len(want) == 4
    _assert_stack_close(got[0], want[0], 1e-5, "p")
    _assert_stack_close(got[1], want[1], 1e-5, "p_local")
    _assert_stack_close(got[2].mu, want[2].mu, 1e-5, "mu")
    _assert_stack_close(got[2].nu, want[2].nu, 1e-5, "nu")
    np.testing.assert_array_equal(got[2].count.numpy(), BUDGETS)
    np.testing.assert_allclose(float(got[3]), float(want[3]), rtol=1e-5)
    for k, v in gp.items():                  # idle slots never moved
        for idle in (1, 3):
            np.testing.assert_array_equal(got[1][k][idle].numpy(),
                                          v.numpy())


# ------------------------------------------------- packed vs loop, in port
@pytest.mark.parametrize("algorithm", ["fedavg", "fedprox"])
def test_packed_run_matches_the_loop_engine(algorithm):
    """Stratified sampling of 4 of 6 clients with dropout 0.25: the engines
    deal the same participants and agree within 1 point of accuracy (the
    bound of the JAX ``tests/test_baseline_parity.py``)."""
    kw = {**RUN, "algorithm": algorithm, "participation": "stratified",
          "clients_per_round": 4, "dropout_rate": 0.25}
    ds = load_dataset("mnist", small=True)
    loop = run_federated(ds, FedConfig(**kw), device="cpu")
    packed = run_federated(ds, FedConfig(**{**kw, "engine": "sharded",
                                            "pack": 4}), device="cpu")
    assert packed["engine"] == "sharded" and packed["pack"] == 4
    assert packed["participants"] == loop["participants"]
    assert len(packed["train_loss"]) == kw["rounds"]
    assert all(np.isfinite(packed["train_loss"]))
    for rnd, (a, b) in enumerate(zip(packed["acc"], loop["acc"]), 1):
        assert abs(a - b) <= 0.01, (rnd, packed["acc"], loop["acc"])


def test_all_dropout_round_is_a_noop():
    """A round whose every invitee dropped out leaves the global params as
    they were, on both engines (the JAX strategies' rule)."""
    ds = load_dataset("mnist", small=True)
    for engine in ("loop", "sharded"):
        cfg = FedConfig(**{**RUN, "algorithm": "fedavg", "engine": engine,
                           "rounds": 1})
        alg = (baselines.LoopBaseline() if engine == "loop"
               else baselines.PackedBaseline())
        alg.setup(ds, make_client_shards(ds, 6, 1.0, seed=0), cfg, 0,
                  device="cpu")
        before = {k: v.clone() for k, v in alg.global_params.items()}
        plan = alg.scheduler.plan(1)
        idle = type(plan)(round_index=1, pack=plan.pack,
                          slot_client=np.full_like(plan.slot_client, -1),
                          slot_cluster=np.full_like(plan.slot_cluster, -1),
                          slot_weight=np.zeros_like(plan.slot_weight))
        alg.run_round(idle, 1)
        for k, v in before.items():
            assert torch.equal(alg.global_params[k], v), (engine, k)


# ------------------------------------------------------------------ FL+HC
@pytest.mark.parametrize("form", [dict(n_clusters=3),
                                  dict(distance_threshold=9.0)],
                         ids=["n_clusters", "threshold"])
def test_agglomerative_matches_jax(form):
    """Seeded updates drawn around four centres: the copy deals the JAX
    module's labels exactly, in both stopping forms."""
    r = np.random.default_rng(11)
    centres = r.standard_normal((4, 30)) * 3
    x = (centres[r.integers(0, 4, 20)]
         + r.standard_normal((20, 30))).astype(np.float32)
    got = hierarchical.agglomerative(x, **form)
    want = jhier.agglomerative(x, **form)
    assert got.dtype == np.int32
    np.testing.assert_array_equal(got, want)
    assert len(np.unique(got)) > 1


def test_flatten_update_gives_jax_distances():
    """The port's flat update (sorted keys, torch layout) is a permutation
    of the JAX one: the same values, and the distance between two updates
    within 1e-6 relative (the diagonal is cancellation noise, which
    ``agglomerative`` masks)."""
    init, _ = jcnn.make_model("mnist", student=False)
    a = _np_tree(init(jax.random.PRNGKey(1)))
    b = _np_tree(init(jax.random.PRNGKey(2)))
    want = np.stack([jhier.flatten_update(t) for t in (a, b)])
    got = np.stack([hierarchical.flatten_update(convert.params_from_jax(t))
                    for t in (a, b)])
    assert got.shape == want.shape and got.dtype == np.float32
    np.testing.assert_allclose(
        hierarchical._pairwise(got.astype(np.float64))[0, 1],
        jhier._pairwise(want.astype(np.float64))[0, 1], rtol=1e-6)
    np.testing.assert_array_equal(np.sort(got, axis=1),
                                  np.sort(want, axis=1))


def test_flhc_run_matches_jax(monkeypatch):
    """A whole FL+HC run (its pre-round is round 1) from the JAX run's
    initial params: the same cluster labels, accuracy within 1 point and
    loss within 1e-3 relative each round."""
    kw = {**RUN, "algorithm": "flhc", "num_clusters": 3, "rounds": 3}
    seen = {}
    jax_agglomerative = jhier.agglomerative

    def capture(updates, **form):
        seen["labels"] = jax_agglomerative(updates, **form)
        return seen["labels"]

    monkeypatch.setattr(jhier, "agglomerative", capture)
    h_jax = jax_run_federated(jax_load_dataset("mnist", small=True),
                              JaxFedConfig(**kw))
    init = _jax_teacher_init(kw["seed"])
    monkeypatch.setattr(port_flhc.FLHC, "_init_params",
                        lambda self: convert.params_from_jax(init))
    port_labels = {}
    port_agglomerative = hierarchical.agglomerative

    def capture_port(updates, **form):
        port_labels["labels"] = port_agglomerative(updates, **form)
        return port_labels["labels"]

    monkeypatch.setattr(hierarchical, "agglomerative", capture_port)
    h = run_federated(load_dataset("mnist", small=True), FedConfig(**kw),
                      device="cpu")
    np.testing.assert_array_equal(port_labels["labels"], seen["labels"])
    _assert_same_history(h, h_jax, ("round", "participants", "algorithm",
                                    "engine", "num_clusters"))
    assert h["num_clusters"] == 3
    assert len(h["round_seconds"]) == kw["rounds"]


@pytest.mark.parametrize("knob", [
    {"algorithm": "fedavg", "universe": 12, "pack": 12},
    {"algorithm": "fedprox", "waves": 3, "pack": 2},
    {"algorithm": "fedavg", "guards": True, "pack": 2, "n_devices": 1,
     "rounds": 3},
    {"algorithm": "fedprox", "async_mode": True, "straggler_frac": 0.5,
     "pack": 2, "n_devices": 1, "rounds": 3},
    {"algorithm": "fedavg", "leave_rate": 0.1, "pack": 6},
], ids=lambda k: ",".join(f"{a}={b}" for a, b in k.items()))
def test_packed_baseline_knob_matches_jax(knob, monkeypatch, tmp_path):
    """The packed baselines' runtime knobs (a virtual universe, waves, the
    guards, async rounds, the lifecycle) against JAX's packed runs on one
    device (``test_torch_runtime.run_both``).  The teacher CNN's runs sit
    near chance accuracy on the small twin, where Adam's first step turns
    float32 noise into a few flipped test examples: one-wave FedProx (pack
    6) is already exactly 1 point (4 of 400) from JAX at round 2, and
    FedAvg 1.25 points at round 3; the cases here measure 0.75 points at
    most (3 waves give the same run within 1e-7)."""
    run_both({**RUN, "engine": "sharded", **knob}, monkeypatch, tmp_path)


@pytest.mark.parametrize("knob", [
    {"algorithm": "fedprox", "resume": True, "ckpt_dir": "ckpt"},
    {"algorithm": "fedavg", "join_schedule": ((2, 1),)},
    {"algorithm": "fedprox", "dp_noise": 0.5},
    {"algorithm": "flhc", "dp_noise": 0.5},
], ids=lambda k: ",".join(f"{a}={b}" for a, b in k.items()))
def test_baseline_runtime_knob_matches_jax(knob, monkeypatch, tmp_path):
    """The baselines' runtime knobs on the loop engine run and match the
    JAX package's runs (``test_torch_runtime.run_both``; ``resume`` takes
    the JAX run's checkpoint).  FL+HC shares no statistics, so its
    ``dp_noise`` changes nothing, in both packages."""
    run_both({**RUN, "num_clusters": 3, **knob}, monkeypatch, tmp_path)


def test_flhc_refuses_async_mode_at_construction():
    """FL+HC keeps per-cluster models with no global merge: ``FedConfig``
    rejects ``async_mode`` for it, as the JAX ``FedConfig`` does."""
    with pytest.raises(ValueError, match="flhc"):
        FedConfig(**{**RUN, "algorithm": "flhc", "async_mode": True})
    with pytest.raises(ValueError, match="flhc"):
        JaxFedConfig(**{**RUN, "algorithm": "flhc", "async_mode": True})
