"""The port's core modules (distill, stats, kmeans, aggregation) against
the JAX package's on the same numpy inputs.  float32 reductions run in a
different order in the two frameworks, so values agree to 1e-5 (losses,
moments, centroids, merges) and the cluster metrics, which divide sums of
distances, to 1e-4; k-means assignments and the K vote agree exactly."""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core import aggregation as jagg
from repro.core import distill as jdistill
from repro.core import kmeans as jkm
from repro.core import stats as jstats
from repro_torch.core import aggregation as agg
from repro_torch.core import distill, kmeans, stats

torch.set_num_threads(1)


def test_distillation_loss_with_padding_labels():
    r = np.random.default_rng(0)
    s = (r.standard_normal((32, 10)) * 2).astype(np.float32)
    t = (r.standard_normal((32, 10)) * 2).astype(np.float32)
    y = r.integers(0, 10, 32).astype(np.int32)
    y[-5:] = -1
    want, aux_j = jdistill.distillation_loss(jnp.asarray(s), jnp.asarray(t),
                                             jnp.asarray(y), temperature=3.0,
                                             alpha=0.3)
    got, aux_t = distill.distillation_loss(torch.from_numpy(s),
                                           torch.from_numpy(t),
                                           torch.from_numpy(y),
                                           temperature=3.0, alpha=0.3)
    np.testing.assert_allclose(float(got), float(want), rtol=1e-5)
    for k in ("ce", "kl"):
        np.testing.assert_allclose(float(aux_t[k]), float(aux_j[k]),
                                   rtol=1e-5)
    # padding rows carry neither loss nor gradient
    st = torch.from_numpy(s).requires_grad_(True)
    distill.distillation_loss(st, torch.from_numpy(t),
                              torch.from_numpy(y))[0].backward()
    assert float(st.grad[-5:].abs().sum()) == 0.0


def test_batched_moments_on_ragged_segments():
    r = np.random.default_rng(1)
    sizes = [5, 1, 12, 7]
    x = (r.standard_normal((sum(sizes), 9)) * 3 + 1).astype(np.float32)
    ids = np.repeat(np.arange(len(sizes)), sizes)
    want = jstats.batched_moments(jnp.asarray(x), jnp.asarray(ids),
                                  num_segments=len(sizes))
    got = stats.batched_moments(torch.from_numpy(x), torch.from_numpy(ids),
                                num_segments=len(sizes))
    for g, w in zip(got, want):
        np.testing.assert_allclose(g.numpy(), np.asarray(w), rtol=1e-5,
                                   atol=1e-5)
    feats = np.concatenate([np.asarray(w) for w in want], axis=1)
    np.testing.assert_allclose(
        stats.standardize(torch.from_numpy(feats)).numpy(),
        np.asarray(jstats.standardize(jnp.asarray(feats))),
        rtol=1e-5, atol=1e-5)


def _blobs(seed=2, n=40, f=12, k=3):
    r = np.random.default_rng(seed)
    centers = r.standard_normal((k, f)) * 4
    x = centers[r.integers(0, k, n)] + r.standard_normal((n, f))
    return x.astype(np.float32)


def test_kmeans_warm_matches_exactly():
    x = _blobs()
    c0 = x[[0, 7, 19]]
    want = jkm.kmeans_warm(jnp.asarray(x), jnp.asarray(c0))
    got = kmeans.kmeans_warm(torch.from_numpy(x), torch.from_numpy(c0))
    assert np.array_equal(got.assignments.numpy(),
                          np.asarray(want.assignments))
    np.testing.assert_allclose(got.centroids.numpy(),
                               np.asarray(want.centroids), rtol=1e-5,
                               atol=1e-5)
    np.testing.assert_allclose(float(got.inertia), float(want.inertia),
                               rtol=1e-5)


@pytest.mark.parametrize("k_cap", [3, 5])   # 5: two empty cluster slots
def test_cluster_metrics_on_fixed_assignments(k_cap):
    x = _blobs(seed=3)
    a = np.random.default_rng(4).integers(0, 3, len(x)).astype(np.int32)
    xj, xt = jnp.asarray(x), torch.from_numpy(x)
    aj, at = jnp.asarray(a), torch.from_numpy(a)
    pairs = [
        (kmeans._silhouette_impl(xt, at, k_cap),
         jkm._silhouette_impl(xj, aj, k_cap)),
        (kmeans._calinski_impl(xt, at, 3, k_cap),
         jkm._calinski_impl(xj, aj, 3, k_cap)),
        (kmeans._davies_impl(xt, at, k_cap), jkm._davies_impl(xj, aj, k_cap)),
    ]
    for got, want in pairs:
        np.testing.assert_allclose(float(got), float(want), rtol=1e-4,
                                   atol=1e-4)
    np.testing.assert_allclose(float(kmeans.silhouette_score(xt, at, 3)),
                               float(jkm.silhouette_score(xj, aj, 3)),
                               rtol=1e-4, atol=1e-4)


@pytest.mark.parametrize("table", [
    # each metric votes for a different K -> tie at one vote, smaller K wins
    ([0.1, 0.5, 0.2], [10.0, 5.0, 30.0], [0.9, 0.8, 0.2]),
    # silhouette and DB agree on K=4, CH picks K=2
    ([0.1, 0.2, 0.6], [50.0, 5.0, 30.0], [0.9, 0.8, 0.2]),
    # exact metric ties inside one metric go to the smaller K
    ([0.3, 0.3, 0.3], [7.0, 7.0, 7.0], [0.5, 0.5, 0.5]),
])
def test_select_k_vote_on_a_fixed_table(monkeypatch, table):
    sil, ch, db = table
    inertia = [3.0, 2.0, 1.0]
    monkeypatch.setattr(jkm, "_select_k_sweep", lambda *a, **k: (
        jnp.asarray(sil), jnp.asarray(ch), jnp.asarray(db),
        jnp.asarray(inertia)))
    monkeypatch.setattr(kmeans, "_select_k_sweep", lambda *a, **k: (
        sil, ch, db, inertia))
    x = _blobs(n=10)
    import jax
    k_j, tab_j = jkm.select_k(jax.random.PRNGKey(0), jnp.asarray(x), 2, 4)
    k_t, tab_t = kmeans.select_k(0, torch.from_numpy(x), 2, 4)
    assert k_t == k_j
    for k in tab_j:
        for m in tab_j[k]:
            np.testing.assert_allclose(tab_t[k][m], tab_j[k][m], rtol=1e-6)


def _param_sets(n, seed=5):
    r = np.random.default_rng(seed)
    return [{"w": r.standard_normal((3, 4)).astype(np.float32),
             "b": r.standard_normal(5).astype(np.float32)} for _ in range(n)]


def _check_tree(got, want):
    assert set(got) == set(want)
    for k in want:
        assert got[k].dtype == torch.float32
        np.testing.assert_allclose(got[k].numpy(), np.asarray(want[k]),
                                   rtol=1e-5, atol=1e-6)


def test_aggregation_operators_match():
    ps = _param_sets(5)
    pj = [{k: jnp.asarray(v) for k, v in p.items()} for p in ps]
    pt = [{k: torch.from_numpy(v) for k, v in p.items()} for p in ps]
    w = [0.1, 0.4, 0.2, 0.2, 0.1]
    _check_tree(agg.weighted_average(pt, w), jagg.weighted_average(pj, w))
    labels = [0, 1, 1, 2, 1]
    for weighting in ("size", "uniform"):
        _check_tree(agg.hierarchical_average(pt, labels, weighting=weighting),
                    jagg.hierarchical_average(pj, labels,
                                              weighting=weighting))
    stale = [0, 2, 1, 0, 3]
    _check_tree(agg.staleness_weighted_average(pt, w, stale, decay=0.5),
                jagg.staleness_weighted_average(pj, w, stale, decay=0.5))
    np.testing.assert_allclose(agg.staleness_weights(w, stale, 0.5),
                               jagg.staleness_weights(w, stale, 0.5))
    with pytest.raises(ValueError):
        agg.staleness_weighted_average(pt, w, [0, -1, 0, 0, 0], decay=0.5)
