"""The port's federated layer (``repro_torch.fed``) against the JAX
package's, on the CPU.

- One teacher CE step and one student distill step (reference loss and
  fused KD loss) from the same converted params on the same batch: losses
  and updated params agree to 1e-5 (float32 arithmetic in another order;
  Adam's first step is about lr * sign(grad), so a gradient sign that
  rounding could flip would show as a 2 * lr gap, and none does here).
- A whole loop-engine FedSiKD run against the JAX loop engine.  Torch
  cannot draw ``jax.random``'s bits, so the test hands the port the JAX
  run's k-means labels and initial params by patching the port's seeding
  here, in the test.  The batch order is shared (``ClientShard.batches`` is
  a copy), so the runs differ only by float32 rounding: per-round accuracy
  agrees to 1 point and loss to 1e-3 relative.
- ``run_federated`` refuses a missing CUDA device.  Each runtime knob of
  the loop engine (async rounds, the client lifecycle, DP noise,
  checkpoints and resume) runs and matches the JAX package's run
  (``tests/test_torch_runtime.py``); the knobs the packed engine still
  refuses are in ``tests/test_torch_sharded.py`` and
  ``tests/test_torch_baselines.py``.
"""
import jax
import numpy as np
import pytest
import torch

from repro.data.synthetic import load_dataset as jax_load_dataset
from repro.fed.algorithms import clustered_kd as jckd
from repro.fed.client import make_steps as jax_make_steps
from repro.fed.rounds import FedConfig as JaxFedConfig
from repro.fed.rounds import run_federated as jax_run_federated
from repro.models import cnn as jcnn
from repro.optim import adamw as jax_adamw
from repro_torch import convert
from repro_torch.core import kmeans as port_kmeans
from repro_torch.data.synthetic import load_dataset
from repro_torch.fed.algorithms import clustered_kd as port_ckd
from repro_torch.fed.client import make_steps
from repro_torch.fed.rounds import FedConfig, run_federated
from repro_torch.models.cnn import make_model
from repro_torch.optim import adamw
from test_torch_runtime import run_both

torch.set_num_threads(1)


def _np_tree(tree):
    return jax.tree_util.tree_map(np.asarray, tree)


def _batch(seed=0, n=32):
    r = np.random.default_rng(seed)
    x = r.random((n, 28, 28, 1)).astype(np.float32)
    y = r.integers(0, 10, n).astype(np.int32)
    y[-3:] = -1                        # the padded tail of a last batch
    return {"x": x, "y": y}


def _assert_params_close(port_params, jax_params, tol=1e-5):
    got = dict(convert._flatten(convert.params_to_jax(port_params)))
    for k, want in convert._flatten(jax_params):
        np.testing.assert_allclose(got[k], want, rtol=tol, atol=tol,
                                   err_msg=k)


def _jax_init(student, seed):
    init, fwd = jcnn.make_model("mnist", student=student)
    return _np_tree(init(jax.random.PRNGKey(seed))), fwd


def test_teacher_ce_step_matches_jax():
    jp, jfwd = _jax_init(False, 1)
    _, tfwd = make_model("mnist", student=False)
    batch = _batch(1)
    jopt, topt = jax_adamw(1e-3), adamw(1e-3)
    jp1, _, jloss = jax_make_steps(jfwd, jopt)["ce"](
        jp, jopt.init(jp), batch, jax.random.PRNGKey(0))
    tp = convert.params_from_jax(jp)
    tp1, tstate, tloss = make_steps(tfwd, topt)["ce"](
        tp, topt.init(tp), batch, 0)
    np.testing.assert_allclose(float(tloss), float(jloss), rtol=1e-5)
    _assert_params_close(tp1, _np_tree(jp1))
    assert int(tstate.count) == 1


@pytest.mark.parametrize("fused", [False, True])
def test_distill_step_matches_jax(fused):
    js, jsfwd = _jax_init(True, 2)
    jt, jtfwd = _jax_init(False, 3)
    _, sfwd = make_model("mnist", student=True)
    _, tfwd = make_model("mnist", student=False)
    batch = _batch(2)
    jopt, topt = jax_adamw(3e-3), adamw(3e-3)
    jstep = jax_make_steps(jsfwd, jopt, kd_temperature=2.0, kd_alpha=0.5)[
        "make_distill"](jtfwd, fused=fused)
    js1, _, jloss = jstep(js, jopt.init(js), batch, jax.random.PRNGKey(0), jt)
    ts = convert.params_from_jax(js)
    tstep = make_steps(sfwd, topt, kd_temperature=2.0, kd_alpha=0.5)[
        "make_distill"](tfwd, fused=fused)
    ts1, _, tloss = tstep(ts, topt.init(ts), batch, 0,
                          convert.params_from_jax(jt))
    np.testing.assert_allclose(float(tloss), float(jloss), rtol=1e-5)
    _assert_params_close(ts1, _np_tree(js1))


PARITY = dict(algorithm="fedsikd", engine="loop", num_clients=6, alpha=1.0,
              rounds=2, local_epochs=1, teacher_warmup_epochs=1,
              batch_size=32, num_clusters=2, seed=0)


def test_loop_engine_run_matches_jax(monkeypatch):
    # 1. the JAX run, keeping its clusters and initial params
    seen = {}
    jax_warmup = jckd.LoopClusteredKD.warmup

    def capture(self):
        seen.update(labels=np.asarray(self.labels),
                    centroids=np.asarray(self.centroids),
                    student=_np_tree(self.global_student),
                    teachers=[_np_tree(t) for t in self.teachers])
        jax_warmup(self)

    monkeypatch.setattr(jckd.LoopClusteredKD, "warmup", capture)
    h_jax = jax_run_federated(jax_load_dataset("mnist", small=True),
                              JaxFedConfig(**PARITY))

    # 2. the port, seeded with them
    labels = seen["labels"]
    assert (labels >= 0).all()

    def injected_kmeans(seed, feats, k, iters=50):
        assert k == PARITY["num_clusters"] and feats.shape[0] == len(labels)
        return port_kmeans.KMeansResult(
            torch.from_numpy(seen["centroids"]),
            torch.from_numpy(labels.astype(np.int32)), torch.zeros(()))

    monkeypatch.setattr(port_kmeans, "kmeans", injected_kmeans)
    monkeypatch.setattr(port_ckd.LoopClusteredKD, "_init_student",
                        lambda self: convert.params_from_jax(seen["student"]))
    monkeypatch.setattr(port_ckd.LoopClusteredKD, "_init_teacher",
                        lambda self, k: convert.params_from_jax(
                            seen["teachers"][k]))
    h = run_federated(load_dataset("mnist", small=True), FedConfig(**PARITY),
                      device="cpu")

    for key in ("round", "participants", "num_clusters", "algorithm",
                "engine", "participation", "dropout_rate"):
        assert h[key] == h_jax[key], key
    assert len(h["round_seconds"]) == PARITY["rounds"]
    for rnd, (a, b) in enumerate(zip(h["acc"], h_jax["acc"]), 1):
        assert abs(a - b) <= 0.01, (rnd, h["acc"], h_jax["acc"])
    np.testing.assert_allclose(h["loss"], h_jax["loss"], rtol=1e-3)


def test_stat_features_match_jax():
    """The clustering input: the port's batched (mean, std, skew) features
    of every client shard equal the JAX package's to 1e-5."""
    from repro.data.pipeline import make_client_shards as jax_shards
    from repro_torch.data.pipeline import make_client_shards
    cfg = FedConfig(**PARITY)
    want = np.asarray(jckd.stat_features(
        jax_shards(jax_load_dataset("mnist", small=True), 6, 1.0, seed=0),
        JaxFedConfig(**PARITY)))
    got = port_ckd.stat_features(
        make_client_shards(load_dataset("mnist", small=True), 6, 1.0, seed=0),
        cfg).numpy()
    np.testing.assert_allclose(got, want, rtol=1e-5, atol=1e-5)


@pytest.mark.parametrize("participation,per_round,dropout", [
    ("full", None, 0.0), ("uniform", 5, 0.2), ("stratified", 4, 0.3)])
def test_round_plans_match_jax(participation, per_round, dropout):
    """The copied scheduler deals the same participants and merge weights
    as the JAX package's for every round: both engines train the same
    clients under the same weights."""
    from repro.fed.schedule import RoundScheduler as JaxScheduler
    from repro_torch.fed.schedule import RoundScheduler
    labels = np.asarray([0, 1, 1, 2, 0, 2, 1, 0, 2, 1])
    kw = dict(participation=participation, clients_per_round=per_round,
              dropout_rate=dropout, seed=3)
    jsch, tsch = JaxScheduler(labels, **kw), RoundScheduler(labels, **kw)
    for rnd in range(1, 6):
        a, b = tsch.plan(rnd), jsch.plan(rnd)
        assert np.array_equal(a.participants, b.participants), rnd
        assert a.weight_of() == b.weight_of(), rnd


def test_run_federated_needs_a_cuda_device():
    assert not torch.cuda.is_available()
    ds = load_dataset("mnist", small=True)
    with pytest.raises(RuntimeError, match="cuda"):
        run_federated(ds, FedConfig(**PARITY))


@pytest.mark.parametrize("knob", [
    {"algorithm": "fedavg", "async_mode": True, "straggler_frac": 0.5},
    {"algorithm": "fedprox", "ckpt_dir": "ckpt"},
    {"algorithm": "flhc", "num_clusters": None, "ckpt_dir": "ckpt"},
    {"ckpt_dir": "ckpt"},
    {"ckpt_dir": "ckpt", "resume": True},
    {"async_mode": True, "straggler_frac": 0.5},
    {"join_schedule": ((2, 1),)},
    {"leave_rate": 0.1},
    {"recluster_every": 1},
    {"dp_noise": 0.5},
], ids=lambda k: ",".join(k))
def test_runtime_knob_matches_jax(knob, monkeypatch, tmp_path):
    """Each runtime knob of the loop engine runs, and its run matches the
    JAX package's (``test_torch_runtime.run_both``: equal plans, labels
    and buffer counts, accuracy within 1 point, loss within 1e-3; with
    ``ckpt_dir`` the same checkpoint keys, and with ``resume`` the JAX
    run's checkpoint resumed in the port)."""
    run_both({**PARITY, **knob}, monkeypatch, tmp_path)
