"""The port's semi-async rounds against the JAX package's, on the CPU.

- ``staleness_merge`` (on-time updates plus buffered arrivals under
  (1+s)^-decay weights, one fused merge) against the JAX function on the
  same params, and with no on-time update against JAX's
  ``merge_arrivals_only``: 1e-6.
- Whole loop-engine runs with stragglers (FedSiKD, the random ablation,
  FedAvg, FedProx) against JAX's, from the JAX run's clusters and initial
  params (``test_torch_runtime.run_both``): the buffer's four counts
  (``stragglers``, ``stale_merged``, ``stale_dropped``, ``buffered``) and
  the participants equal, accuracy within 1 point, loss within 1e-3
  relative.  Each run merges at least one late update.  Three rounds:
  a client's first Adam step from a fresh state moves each weight by about
  lr * sign(grad), so float32 rounding that flips a near-zero gradient's
  sign grows round by round, fastest where few on-time clients are
  averaged.  The random ablation's run drifts to 1.2e-2 relative loss in a
  fourth round while its merged students still agree to 1.8e-6 after
  round 1 (measured on this configuration).
- With no stragglers an async run is the synchronous run, bit for bit.
"""
import jax
import numpy as np
import pytest
import torch

from repro.fed.algorithms import base as jbase
from repro.fed.driver import AsyncUpdate as JaxAsyncUpdate
from repro.models import cnn as jcnn
from repro_torch import convert
from repro_torch.fed.algorithms import base
from repro_torch.fed.driver import AsyncUpdate
from test_torch_runtime import port_run, run_both

torch.set_num_threads(1)

ASYNC = dict(async_mode=True, straggler_frac=0.5, max_staleness=1,
             staleness_decay=0.5, rounds=3)


def _student(seed):
    init, _ = jcnn.make_model("mnist", student=True)
    return jax.tree_util.tree_map(np.asarray, init(jax.random.PRNGKey(seed)))


@pytest.mark.parametrize("n_on", [0, 1, 3])
@pytest.mark.parametrize("decay", [0.0, 0.5])
def test_staleness_merge_matches_jax(n_on, decay):
    trees = [_student(s) for s in range(n_on + 3)]
    weights = [1.5, 0.25, 2.0][:n_on]
    late = [(7, 1, 2, 3.0), (2, 1, 4, 0.5), (9, 2, 3, 1.0)]   # s = 1, 3, 1
    j_arr = [JaxAsyncUpdate(client=c, birth=b, arrival=a, weight=w,
                            params=trees[n_on + i])
             for i, (c, b, a, w) in enumerate(late)]
    p_arr = [AsyncUpdate(client=c, birth=b, arrival=a, weight=w,
                         params=convert.params_from_jax(trees[n_on + i]))
             for i, (c, b, a, w) in enumerate(late)]
    want = (jbase.staleness_merge(trees[:n_on], weights, j_arr, decay)
            if n_on else jbase.merge_arrivals_only(j_arr, decay))
    got = base.staleness_merge(
        [convert.params_from_jax(t) for t in trees[:n_on]], weights, p_arr,
        decay)
    back = dict(convert._flatten(convert.params_to_jax(got)))
    for k, w in convert._flatten(jax.tree_util.tree_map(np.asarray, want)):
        np.testing.assert_allclose(back[k], w, rtol=1e-6, atol=1e-6,
                                   err_msg=k)


@pytest.mark.parametrize("algorithm", ["fedsikd", "random", "fedavg",
                                       "fedprox"])
def test_async_loop_run_matches_jax(algorithm, monkeypatch, tmp_path):
    h, _ = run_both({"algorithm": algorithm, **ASYNC}, monkeypatch, tmp_path)
    assert sum(h["stragglers"]) > 0 and sum(h["stale_merged"]) >= 1
    assert len(h["buffered"]) == ASYNC["rounds"]


def test_async_without_stragglers_is_the_sync_run():
    kw = dict(algorithm="fedsikd", num_clients=6, alpha=1.0, rounds=2,
              local_epochs=1, teacher_warmup_epochs=1, batch_size=32,
              num_clusters=2, seed=0)
    h_sync = port_run(kw)
    h_async = port_run(kw, async_mode=True)
    assert h_async["stragglers"] == [0, 0] and h_async["buffered"] == [0, 0]
    for key in ("acc", "loss", "teacher_loss", "student_loss",
                "participants"):
        assert h_async[key] == h_sync[key], key
