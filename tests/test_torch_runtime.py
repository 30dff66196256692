"""The port's runtime features against the JAX package's, on the CPU: the
shared machinery of ``tests/test_torch_ckpt.py``, ``test_torch_lifecycle.py``,
``test_torch_async.py`` and the knob cases of ``test_torch_fed.py``,
``test_torch_baselines.py`` and ``test_torch_sharded.py``, and the tests of
the run's identity.

``run_both`` runs one small configuration (the small MNIST twin, 6
clients) through both packages.  Torch cannot draw ``jax.random``'s bits,
so the port is handed what the JAX run drew, by patching the port's
seeding here, in the test: the initial clusters and centroids, the initial
params and, with ``dp_noise > 0``, the DP noise of every client
(``jax_dp_draws``).  Everything after that is computed by each package on
its own: plans, lifecycle events, warm re-clustering, teacher migration,
the staleness buffer and its merges.  The batch order is shared, so the
runs differ only by float32 rounding: per-round accuracy within 1 point,
loss within 1e-3 relative (the bounds of
``test_loop_engine_run_matches_jax``), and every key the plan decides
(participants, ``labels_history``, the buffer's four counts, the lifecycle
metrics) equal.

Here too: the fingerprint has the JAX package's keys and values, every
``FedConfig`` field is fingerprinted or execution-only (the JAX
``tests/test_config_surface.py`` on the port), and the staleness buffer's
pops, tombstones and checkpoint records.
"""
import dataclasses
import json
import shutil

import jax
import numpy as np
import pytest
import torch

from repro.data.synthetic import load_dataset as jax_load_dataset
from repro.fed import driver as jdriver
from repro.fed.algorithms import clustered_kd as jckd
from repro.fed.rounds import FedConfig as JaxFedConfig
from repro.fed.rounds import run_federated as jax_run_federated
from repro.models import cnn as jcnn
from repro_torch import convert
from repro_torch.core import kmeans as port_kmeans
from repro_torch.core import stats as port_stats
from repro_torch.data.synthetic import load_dataset
from repro_torch.fed import driver
from repro_torch.fed.algorithms import baselines as port_baselines
from repro_torch.fed.algorithms import clustered_kd as port_ckd
from repro_torch.fed.algorithms import flhc as port_flhc
from repro_torch.fed.rounds import FedConfig, run_federated

torch.set_num_threads(1)

SMALL = dict(num_clients=6, alpha=1.0, rounds=2, local_epochs=1,
             teacher_warmup_epochs=1, batch_size=32, num_clusters=2, seed=0)
# per-round floats the two packages compute each in its own rounding
FLOAT_KEYS = {"acc", "loss", "teacher_loss", "student_loss", "train_loss",
              "round_seconds"}


def _np_tree(tree):
    return jax.tree_util.tree_map(np.asarray, tree)


def jax_dp_draws(seed, clients, num_features):
    """The JAX package's DP noise draws for ``clients`` as the port's
    (R, 3, F) tensor: ``privatize_batched``'s per-client key
    ``fold_in(PRNGKey(seed), client)`` split in three."""
    key = jax.random.PRNGKey(seed)
    out = []
    for c in np.asarray(clients).tolist():
        ks = jax.random.split(jax.random.fold_in(key, int(c)), 3)
        out.append([np.asarray(jax.random.normal(k, (num_features,)))
                    for k in ks])
    return torch.from_numpy(np.asarray(out, np.float32))


def _capture_jax_init(monkeypatch, kw, seen):
    """Record what the JAX run draws at setup (clusters, centroids, the
    initial params) into ``seen``."""
    alg, engine = kw["algorithm"], kw.get("engine", "loop")
    if alg in ("fedsikd", "random"):
        cls = (jckd.ShardedClusteredKD if engine == "sharded"
               else jckd.LoopClusteredKD)
        jax_warmup = cls.warmup

        def capture(self):
            seen.update(
                labels=np.asarray(self.labels),
                centroids=(None if self.centroids is None
                           else np.asarray(self.centroids)),
                student=_np_tree(self.sp_global if engine == "sharded"
                                 else self.global_student),
                teachers=(_np_tree(self.tp_k) if engine == "sharded" else
                          [_np_tree(t) for t in self.teachers]))
            jax_warmup(self)

        monkeypatch.setattr(cls, "warmup", capture)
    else:
        init, _ = jcnn.make_model("mnist", student=False)
        seen["params"] = _np_tree(init(jax.random.PRNGKey(kw["seed"])))


def _inject_into_port(monkeypatch, kw, seen):
    """Hand the port what the JAX run drew (see the module docstring)."""
    alg, engine = kw["algorithm"], kw.get("engine", "loop")
    if kw.get("dp_noise", 0) > 0:
        monkeypatch.setattr(port_stats, "dp_noise_draws",
                            lambda seed, clients, F, device="cpu":
                            jax_dp_draws(seed, clients, F).to(device))
    if alg in ("fedsikd", "random"):
        labels = seen["labels"]
        roster = labels[labels >= 0]
        if kw.get("universe") is not None:
            # a universe clusters its base pool, whose labels are the
            # first ``num_clients`` virtual clients' (``row_of = v % n``)
            roster = roster[:kw["num_clients"]]

        def injected_kmeans(seed, feats, k, iters=50):
            assert feats.shape[0] == len(roster)
            return port_kmeans.KMeansResult(
                torch.from_numpy(seen["centroids"]),
                torch.from_numpy(roster.astype(np.int32)), torch.zeros(()))

        monkeypatch.setattr(port_kmeans, "kmeans", injected_kmeans)
        if engine == "sharded":
            cls = port_ckd.ShardedClusteredKD
            monkeypatch.setattr(cls, "_init_teacher_stack",
                                lambda self: convert.params_from_jax(
                                    seen["teachers"], stacked=True))
        else:
            cls = port_ckd.LoopClusteredKD
            monkeypatch.setattr(cls, "_init_teacher",
                                lambda self, k: convert.params_from_jax(
                                    seen["teachers"][k]))
        monkeypatch.setattr(cls, "_init_student",
                            lambda self: convert.params_from_jax(
                                seen["student"]))
    else:
        cls = (port_flhc.FLHC if alg == "flhc"
               else port_baselines._BaselineBase)
        monkeypatch.setattr(cls, "_init_params",
                            lambda self: convert.params_from_jax(
                                seen["params"]))


def jax_run(kw, **extra):
    return jax_run_federated(jax_load_dataset("mnist", small=True),
                             JaxFedConfig(**kw, **extra))


def port_run(kw, **extra):
    return run_federated(load_dataset("mnist", small=True),
                         FedConfig(**kw, **extra), device="cpu")


def assert_histories_match(h, h_jax):
    """Every key both histories hold: the plan's equal, the floats within
    1 point of accuracy and 1e-3 relative loss."""
    shared = (set(h) & set(h_jax)) - FLOAT_KEYS
    assert shared >= {"round", "participants", "algorithm", "engine"}
    for key in sorted(shared):
        assert h[key] == h_jax[key], (key, h[key], h_jax[key])
    assert len(h["acc"]) == len(h_jax["acc"])
    for rnd, (a, b) in enumerate(zip(h["acc"], h_jax["acc"]), 1):
        assert abs(a - b) <= 0.01, (rnd, h["acc"], h_jax["acc"])
    np.testing.assert_allclose(h["loss"], h_jax["loss"], rtol=1e-3)


def npz_layout(ckpt_dir, rnd):
    """{key: (shape, dtype)} of one round's npz."""
    with np.load(f"{ckpt_dir}/round_{rnd:05d}.npz") as z:
        return {k: (z[k].shape, z[k].dtype.name) for k in z.files}


def run_both(kw, monkeypatch, tmp_path):
    """One configuration through both packages (see the module docstring).

    ``ckpt_dir`` set: each package checkpoints into its own directory, and
    both write the same keys, shapes and dtypes.  ``resume`` set too: the
    JAX package checkpoints ``rounds - 1`` rounds and the port resumes that
    checkpoint to ``rounds``, against JAX's uninterrupted run.  Returns the
    port's and JAX's histories."""
    kw = {**SMALL, **kw}
    seen = {}
    _capture_jax_init(monkeypatch, kw, seen)
    jdir, pdir = tmp_path / "jax", tmp_path / "port"
    if kw.get("resume"):
        base = {k: v for k, v in kw.items()
                if k not in ("resume", "ckpt_dir")}
        jax_run({**base, "rounds": kw["rounds"] - 1}, ckpt_dir=str(jdir))
        h_jax = jax_run(base)
        shutil.copytree(jdir, pdir)
        _inject_into_port(monkeypatch, kw, seen)
        h = port_run({**kw, "ckpt_dir": str(pdir)})
        assert h["round_seconds"][:kw["rounds"] - 1] == [None] * (
            kw["rounds"] - 1)
    else:
        ck = {"ckpt_dir": str(jdir)} if kw.get("ckpt_dir") else {}
        h_jax = jax_run({**kw, **ck})
        _inject_into_port(monkeypatch, kw, seen)
        ck = {"ckpt_dir": str(pdir)} if kw.get("ckpt_dir") else {}
        h = port_run({**kw, **ck})
        if ck:
            assert npz_layout(pdir, kw["rounds"]) == npz_layout(
                jdir, kw["rounds"])
    assert all(s is None or s > 0 for s in h["round_seconds"])
    assert_histories_match(h, h_jax)
    return h, h_jax


# ------------------------------------------------------------ run identity
def test_fingerprint_has_the_jax_keys_and_values():
    """The same config fingerprints to the same JSON in both packages, so
    either package's checkpoint validates in the other."""
    for kw in ({**SMALL, "algorithm": "fedsikd", "num_clusters": None,
                "join_schedule": ((2, 1),), "async_mode": True,
                "straggler_frac": 0.3, "dp_noise": 0.1},
               {**SMALL, "algorithm": "fedprox", "engine": "sharded",
                "pack": 6}):
        labels = np.asarray([0, 1, 1, 0, -1, 2])
        got = json.dumps(driver.fingerprint(FedConfig(**kw), labels))
        want = json.dumps(jdriver.fingerprint(JaxFedConfig(**kw), labels))
        assert got == want
    assert driver.FINGERPRINT_VERSION == jdriver.FINGERPRINT_VERSION
    assert driver.EXECUTION_ONLY == jdriver.EXECUTION_ONLY


def test_every_field_is_fingerprinted_or_execution_only():
    fields = {f.name for f in dataclasses.fields(FedConfig)}
    fp_keys = set(driver.fingerprint(FedConfig(num_clusters=2)))
    fp_keys |= set(driver.fingerprint(FedConfig(num_clusters=None)))
    assert not fields - fp_keys - driver.EXECUTION_ONLY
    assert not set(driver.fingerprint(FedConfig())) & driver.EXECUTION_ONLY
    assert not driver.EXECUTION_ONLY - fields
    assert fields == {f.name for f in dataclasses.fields(JaxFedConfig)}


# ------------------------------------------------------- staleness buffer
def _update(client, birth, arrival, params="p"):
    return driver.AsyncUpdate(client=client, birth=birth, arrival=arrival,
                              weight=float(client) + 0.5, params=params)


def test_buffer_pops_due_updates_and_tombstones_too_stale_ones():
    """The port's buffer against the JAX one on the same pushes: the same
    arrivals, drop counts, occupancy and records round by round."""
    pushes = [(1, 1, 2), (2, 1, 4), (3, 2, 3), (4, 2, 6), (5, 3, 4)]
    bufs = (driver.StalenessBuffer(2), jdriver.StalenessBuffer(2))
    for c, b, a in pushes:
        bufs[0].push(_update(c, b, a))
        bufs[1].push(jdriver.AsyncUpdate(client=c, birth=b, arrival=a,
                                         weight=float(c) + 0.5, params="p"))
    assert bufs[0].meta() == bufs[1].meta()
    assert [e["has_params"] for e in bufs[0].meta()] == [True, False, True,
                                                        False, True]
    for rnd in range(1, 7):
        (got, gd), (want, wd) = (b.pop_due(rnd) for b in bufs)
        assert [(u.client, u.staleness) for u in got] == [
            (u.client, u.staleness) for u in want], rnd
        assert gd == wd and len(bufs[0]) == len(bufs[1]), rnd
    assert len(bufs[0]) == 0
    with pytest.raises(ValueError, match="max_staleness"):
        driver.StalenessBuffer(-1)


def test_buffer_records_round_trip():
    buf = driver.StalenessBuffer(1)
    for u in (_update(0, 1, 2, "a"), _update(1, 1, 3), _update(2, 2, 3, "c")):
        buf.push(u)
    meta, params = json.loads(json.dumps(buf.meta())), buf.params_list()
    assert params == ["a", "c"]
    back = driver.StalenessBuffer(1)
    back.load(meta, params)
    assert back.entries == buf.entries
