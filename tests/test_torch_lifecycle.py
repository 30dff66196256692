"""The port's client lifecycle and DP-noised statistics against the JAX
package's, on the CPU.

- ``privatize_batched``: the port's arithmetic (clip, scale by
  noise_multiplier * clip, add, clamp std at >= 0) fed JAX's own normal
  draws, against JAX's ``privatize_batched``: 1e-6.  The draws themselves
  differ by design (a torch stream per (seed + 17, client), not
  ``jax.random``); their promise is held separately: a client's noise is
  the same whatever roster it is drawn with, at setup or at a later join.
- ``stat_features`` with ``dp_noise`` fed JAX's draws against JAX's: 1e-5.
- Whole loop-engine runs with joins, leaves and periodic re-clustering
  (FedSiKD with and without DP noise, the random ablation, FedAvg) against
  JAX's, from the JAX run's clusters, params and draws
  (``test_torch_runtime.run_both``): ``labels_history`` (warm re-clustering
  in the initial roster's feature space), participants and the lifecycle
  metrics (``cluster_shift``, ``migrated_teachers``, ``active_clients``)
  equal; accuracy within 1 point, loss within 1e-3 relative.  Two rounds,
  as in ``test_loop_engine_run_matches_jax``, with a leave in round 1, a
  join in round 2 and a re-clustering in each: the float32 gap between
  the packages grows each round, through the lr * sign(grad) first step
  of every client's fresh Adam state (measured on the synchronous FedAvg
  run of this twin, which PR 18 ported: 0.75 points apart by round 4).
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core import stats as jstats
from repro.data.pipeline import make_client_shards as jax_shards
from repro.data.synthetic import load_dataset as jax_load_dataset
from repro.fed.algorithms import clustered_kd as jckd
from repro.fed.rounds import FedConfig as JaxFedConfig
from repro_torch.core import stats
from repro_torch.data.pipeline import make_client_shards
from repro_torch.data.synthetic import load_dataset
from repro_torch.fed.algorithms import clustered_kd as port_ckd
from repro_torch.fed.lifecycle import ClientLifecycle
from repro_torch.fed.rounds import FedConfig
from test_torch_runtime import SMALL, jax_dp_draws, run_both

torch.set_num_threads(1)

LIFECYCLE = dict(join_schedule=((2, 2),), leave_rate=0.15,
                 recluster_every=1, rounds=2)


@pytest.mark.parametrize("mult", [0.05, 0.5, 2.0])
def test_privatize_batched_matches_jax_on_its_draws(mult):
    r = np.random.default_rng(1)
    R, F = 5, 7
    mean = (r.standard_normal((R, F)) * 8).astype(np.float32)
    std = np.abs(r.standard_normal((R, F))).astype(np.float32) * 0.1
    skew = (r.standard_normal((R, F)) * 20).astype(np.float32)
    clients = [4, 0, 9, 2, 7]
    key = jax.random.PRNGKey(17)
    keys = jnp.stack([jax.random.fold_in(key, c) for c in clients])
    want = jstats.privatize_batched(jnp.asarray(mean), jnp.asarray(std),
                                    jnp.asarray(skew), noise_multiplier=mult,
                                    keys=keys)
    got = stats.privatize_batched(
        torch.from_numpy(mean), torch.from_numpy(std), torch.from_numpy(skew),
        noise_multiplier=mult, noise=jax_dp_draws(17, clients, F))
    for g, w in zip(got, want):
        np.testing.assert_allclose(g.numpy(), np.asarray(w), rtol=1e-6,
                                   atol=1e-6)
    assert (got[1] >= 0).all()
    assert (got[1] == 0).any()        # the clamp is exercised


def test_privatize_with_no_noise_is_the_identity():
    x = torch.randn(3, 4)
    out = stats.privatize_batched(x, x.abs(), x, noise_multiplier=0.0,
                                  noise=None)
    assert out[0] is x and out[2] is x


def test_a_clients_noise_does_not_depend_on_its_roster():
    full = stats.dp_noise_draws(17, [0, 1, 2, 3, 4, 5], 11)
    late = stats.dp_noise_draws(17, [5, 2], 11)
    assert torch.equal(late[0], full[5]) and torch.equal(late[1], full[2])
    assert not torch.equal(full[0], full[1])
    assert not torch.equal(stats.dp_noise_draws(18, [2], 11)[0], full[2])


def test_dp_stat_features_match_jax_on_its_draws(monkeypatch):
    kw = {**SMALL, "dp_noise": 0.3, "seed": 2}
    roster = np.asarray([0, 2, 3, 5])
    want = np.asarray(jckd.stat_features(
        jax_shards(jax_load_dataset("mnist", small=True), 6, 1.0, seed=2),
        JaxFedConfig(**kw), roster))
    shards = make_client_shards(load_dataset("mnist", small=True), 6, 1.0,
                                seed=2)
    own = port_ckd.stat_features(shards, FedConfig(**kw), roster)
    one = port_ckd.stat_features(shards, FedConfig(**kw), [3])
    monkeypatch.setattr(stats, "dp_noise_draws",
                        lambda seed, clients, F, device="cpu":
                        jax_dp_draws(seed, clients, F))
    got = port_ckd.stat_features(shards, FedConfig(**kw), roster).numpy()
    np.testing.assert_allclose(got, want, rtol=1e-5, atol=1e-5)
    # the port's own stream gives other values, a client's the same on any
    # roster
    assert not np.allclose(own.numpy(), want)
    assert torch.equal(one[0], own[2])


@pytest.mark.parametrize("kw", [
    {"algorithm": "fedsikd"},
    {"algorithm": "fedsikd", "dp_noise": 0.05},
    {"algorithm": "random"},
    {"algorithm": "fedavg"},
], ids=lambda k: "-".join(f"{a}={b}" for a, b in k.items()))
def test_lifecycle_loop_run_matches_jax(kw, monkeypatch, tmp_path):
    lc = ClientLifecycle.from_config(FedConfig(**{**SMALL, **LIFECYCLE}))
    assert len(lc.event(1).leaves) and len(lc.event(2).joins)
    h, _ = run_both({**kw, **LIFECYCLE}, monkeypatch, tmp_path)
    assert h["participants"] != [h["participants"][0]] * LIFECYCLE["rounds"]
    if kw["algorithm"] != "fedavg":
        assert len(h["labels_history"]) == 1 + len(
            [r for r in h["recluster"] if r])
