"""The k-means assignment kernel's planner (``repro_torch.kernels.
kmeans_assign.plan``), and the split regime's arithmetic written out in
torch (each cluster block's partial sums over its F-slice, added in rank
order) against the JAX package's Pallas kernel in interpret mode, on the
same numpy inputs.  Tolerance: the port's k-means bound, 1e-4 relative on
distances with no assignment differing (``tests/test_torch_sharded.py``):
the slices sum the same float32 products in another order."""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels import ops as jops
from repro_torch.kernels import kmeans_assign as km

KM_N, KM_F = 40, 3 * 784          # the clustering step's statistics matrix


@pytest.mark.parametrize("F", [2352, 2350, 12, 3, 1, 100003])
def test_split_slices_cover_f_exactly_once(F):
    p = km.plan(KM_N, F, 5)
    assert p["regime"] == "split" and len(p["slices"]) == km.CLUSTER
    assert p["slice_len"] % 4 == 0 and p["slice_len"] * km.CLUSTER >= F
    covered = np.concatenate([np.arange(f0, f0 + n) for f0, n in p["slices"]])
    np.testing.assert_array_equal(covered, np.arange(F))
    for r, (f0, n) in enumerate(p["slices"]):
        assert n == max(0, min(p["slice_len"], F - r * p["slice_len"]))
        assert f0 % 4 == 0 or n == 0


@pytest.mark.parametrize("K", [2, 3, 4, 5])
def test_plan_at_the_clustering_step(K):
    """N = 40: 10 clusters of 8 blocks, 4 points (a warp each) a block, F
    in slices of 296 columns: 80 blocks where the first design had 5."""
    p = km.plan(KM_N, KM_F, K)
    assert p == {"regime": "split", "cluster": 8, "groups": 10,
                 "blocks": 80, "threads": 128, "slice_len": 296,
                 "slices": [(296 * r, 296) for r in range(7)] + [(2072, 280)],
                 "smem": 0}


def test_plan_switches_to_stream_at_large_n():
    """Stream once every SM gets a block of 8 warps x 2 points and the
    centroids fit in a block's shared memory; blocks a SM by shared memory
    (3 at K = 8, 1 at K = 16), at most 4."""
    edge = 132 * 16
    assert km.plan(edge - 16, KM_F, 8)["regime"] == "split"
    assert km.plan(edge - 15, KM_F, 8)["regime"] == "stream"
    p = km.plan(16384, KM_F, 8)
    assert p == {"regime": "stream", "blocks": 396, "per_sm": 3,
                 "threads": 256, "smem": 4 * 8 * (KM_F + 1)}
    p16 = km.plan(16384, KM_F, 16)
    assert (p16["regime"], p16["per_sm"], p16["blocks"]) == ("stream", 1, 132)
    assert p16["smem"] <= km.SMEM_BLOCK_MAX
    assert km.plan(16384, KM_F, 2)["per_sm"] == 4
    assert km.plan(2200, KM_F, 8)["blocks"] == -(-2200 // 16)
    # centroids too large for shared memory: split at any N
    assert km.plan(16384, 8000, 16)["regime"] == "split"
    # a smaller card switches earlier
    assert km.plan(114 * 16, KM_F, 8, sms=114)["regime"] == "stream"


def _split_mirror(x, c, p):
    """The split kernel's arithmetic: per F-slice partial x.c_k, ||x||^2
    and ||c_k||^2 in float32, added over the slices in rank order, then the
    clamped expansion and the strict argmin."""
    N, K = x.shape[0], c.shape[0]
    xx, dot, cc = torch.zeros(N), torch.zeros(N, K), torch.zeros(K)
    for f0, n in p["slices"]:
        xs, cs = x[:, f0:f0 + n], c[:, f0:f0 + n]
        xx = xx + (xs * xs).sum(1)
        dot = dot + xs @ cs.T
        cc = cc + (cs * cs).sum(1)
    d = torch.clamp((xx[:, None] + cc[None]) - 2.0 * dot, min=0.0)
    a = torch.argmin(d, dim=1)              # the first minimum: lowest k
    return a.to(torch.int32), torch.gather(d, 1, a[:, None])[:, 0]


@pytest.mark.parametrize("K", [2, 3, 4, 5])
def test_split_arithmetic_matches_jax(K):
    r = np.random.default_rng(KM_N * K + KM_F)
    x = r.standard_normal((KM_N, KM_F)).astype(np.float32)
    c = r.standard_normal((K, KM_F)).astype(np.float32)
    want_a, want_d = jops.kmeans_assign(jnp.asarray(x), jnp.asarray(c),
                                        interpret=True)
    p = km.plan(KM_N, KM_F, K)
    a, d = _split_mirror(torch.from_numpy(x), torch.from_numpy(c), p)
    assert int((a.numpy() != np.asarray(want_a)).sum()) == 0
    np.testing.assert_allclose(d.numpy(), np.asarray(want_d), rtol=1e-4,
                               atol=1e-4)
    a_p, d_p = km.kmeans_assign_plain(torch.from_numpy(x), torch.from_numpy(c))
    assert torch.equal(a, a_p)
    torch.testing.assert_close(d, d_p, rtol=1e-4, atol=1e-4)


def test_split_arithmetic_keeps_ties_at_the_lowest_index():
    """The tie cases of the JAX test, with F spread over several slices."""
    c = np.zeros((4, 40), np.float32)
    c[0, 0], c[1, 33], c[2, 0], c[3, 33] = 1.0, 2.0, -1.0, 2.0
    x = np.zeros((3, 40), np.float32)
    x[1, 33], x[2, 33] = 2.0, 2.5
    want_a, _ = jops.kmeans_assign(jnp.asarray(x), jnp.asarray(c),
                                   interpret=True)
    a, _ = _split_mirror(torch.from_numpy(x), torch.from_numpy(c),
                         km.plan(3, 40, 4))
    np.testing.assert_array_equal(a.numpy(), np.asarray(want_a))
    np.testing.assert_array_equal(a.numpy(), [0, 1, 1])
