"""The port's kernel entry points (``repro_torch.kernels.ops``, CPU plain
path) against the JAX package's Pallas kernels run in interpret mode, on the
same numpy inputs.  Tolerances are those of tests/test_kernels.py: 2e-5 for
the f32 KD loss and 5e-2 for bf16 (bf16 inputs hold ~3 significant digits),
1e-4 for the tau/alpha sweep, rtol 1e-5 / atol 1e-6 for the gradient, 1e-5
for the f32 merge and 2e-2 for a bf16 leaf (the multi-leaf merge too)."""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels import ops as jops
from repro.kernels.kd_softmax_kl import kd_loss_fwd as jax_kd_loss_fwd
from repro_torch.kernels import _build, launch_counts, ops, reset_launches
from repro_torch.kernels.kd_softmax_kl import kd_loss_fwd

torch.set_num_threads(1)


def _logits(seed, T, V, scale=3.0):
    r = np.random.default_rng(seed)
    s = (r.standard_normal((T, V)) * scale).astype(np.float32)
    t = (r.standard_normal((T, V)) * scale).astype(np.float32)
    y = r.integers(0, V, T).astype(np.int32)
    y[r.random(T) < 0.1] = -1          # padding tokens
    return s, t, y


def _jax_per_token(s, t, y, tau, alpha):
    """The Pallas forward kernel (interpret mode) on padded inputs, cropped
    back: ((T,) loss, (T, 3) stats)."""
    T, V = s.shape
    bt, bv = jops._blocks(V)
    sp = jops._pad_to(jops._pad_to(jnp.asarray(s), 0, bt, 0.0), 1, bv, jops.NEG)
    tp = jops._pad_to(jops._pad_to(jnp.asarray(t), 0, bt, 0.0), 1, bv, jops.NEG)
    yp = jops._pad_to(jnp.asarray(y), 0, bt, -1)
    loss, stats = jax_kd_loss_fwd(sp, tp, yp, tau=tau, alpha=alpha, block_t=bt,
                                  block_v=bv, interpret=True)
    return np.asarray(loss)[:T], np.asarray(stats)[:T]


@pytest.mark.parametrize("T,V", [(64, 10), (100, 700), (128, 512)])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_kd_forward_matches_pallas(T, V, dtype):
    s, t, y = _logits(0, T, V)
    jd, td = (jnp.bfloat16, torch.bfloat16) if dtype == "bfloat16" else (
        jnp.float32, torch.float32)
    s_j, t_j = jnp.asarray(s).astype(jd), jnp.asarray(t).astype(jd)
    s_t = torch.from_numpy(s).to(td)
    t_t = torch.from_numpy(t).to(td)
    tol = 2e-5 if dtype == "float32" else 5e-2
    loss_j = float(jops.kd_distillation_loss(s_j, t_j, jnp.asarray(y), 2.0,
                                             0.5, True))
    loss_t = float(ops.kd_distillation_loss(s_t, t_t, torch.from_numpy(y)))
    np.testing.assert_allclose(loss_t, loss_j, rtol=tol, atol=tol)
    # per-token loss and the saved stats the backward relies on
    per_j, stats_j = _jax_per_token(np.asarray(s_j.astype(jnp.float32)),
                                    np.asarray(t_j.astype(jnp.float32)), y,
                                    2.0, 0.5)
    per_t, stats_t = kd_loss_fwd(s_t, t_t, torch.from_numpy(y), tau=2.0,
                                 alpha=0.5)
    np.testing.assert_allclose(per_t.numpy(), per_j, rtol=tol, atol=tol * 10)
    np.testing.assert_allclose(stats_t.numpy(), stats_j, rtol=tol, atol=tol)


@pytest.mark.parametrize("tau,alpha", [(1.0, 0.0), (2.0, 0.5), (4.0, 1.0)])
def test_kd_tau_alpha_sweep(tau, alpha):
    s, t, y = _logits(1, 128, 512, scale=2.0)
    per_j, _ = _jax_per_token(s, t, y, tau, alpha)
    per_t, _ = kd_loss_fwd(torch.from_numpy(s), torch.from_numpy(t),
                           torch.from_numpy(y), tau=tau, alpha=alpha)
    np.testing.assert_allclose(per_t.numpy(), per_j, rtol=1e-4, atol=1e-4)


def test_kd_all_padding_is_exactly_zero():
    s, t, _ = _logits(2, 64, 10)
    y = torch.full((64,), -1, dtype=torch.int32)
    st = torch.from_numpy(s).requires_grad_(True)
    loss = ops.kd_distillation_loss(st, torch.from_numpy(t), y)
    loss.backward()
    assert float(loss.detach()) == 0.0
    assert float(st.grad.abs().sum()) == 0.0


def test_kd_gradient_matches_jax_custom_vjp():
    s, t, y = _logits(3, 100, 700, scale=2.0)
    g_j = jax.grad(lambda s_: jops.kd_distillation_loss(
        s_, jnp.asarray(t), jnp.asarray(y), 2.0, 0.5, True))(jnp.asarray(s))
    st = torch.from_numpy(s).requires_grad_(True)
    tt = torch.from_numpy(t).requires_grad_(True)
    ops.kd_distillation_loss(st, tt, torch.from_numpy(y), 2.0, 0.5).backward()
    np.testing.assert_allclose(st.grad.numpy(), np.asarray(g_j), rtol=1e-5,
                               atol=1e-6)
    assert tt.grad is None             # the teacher gets no gradient


def test_kd_batched_leading_axes():
    r = np.random.default_rng(4)
    s = r.standard_normal((2, 16, 24)).astype(np.float32) * 2
    t = r.standard_normal((2, 16, 24)).astype(np.float32) * 2
    y = r.integers(-1, 24, (2, 16)).astype(np.int64)
    want = float(jops.kd_distillation_loss_batched(
        jnp.asarray(s), jnp.asarray(t), jnp.asarray(y), tau=3.0, alpha=0.25,
        interpret=True))
    got = float(ops.kd_distillation_loss_batched(
        torch.from_numpy(s), torch.from_numpy(t), torch.from_numpy(y),
        tau=3.0, alpha=0.25))
    np.testing.assert_allclose(got, want, rtol=2e-5, atol=2e-5)
    with pytest.raises(ValueError, match="labels shape"):
        ops.kd_distillation_loss_batched(torch.from_numpy(s),
                                         torch.from_numpy(t),
                                         torch.from_numpy(y[:, :8]))
    with pytest.raises(ValueError, match="shapes differ"):
        ops.kd_distillation_loss_batched(torch.from_numpy(s),
                                         torch.from_numpy(t[:1]),
                                         torch.from_numpy(y))


@pytest.mark.parametrize("N,D", [(3, 512), (8, 1024), (5, 100), (1, 7),
                                 (13, 513)])
@pytest.mark.parametrize("decay", [0.0, 0.5, 1.5])
def test_fused_merge_matches_pallas(N, D, decay):
    r = np.random.default_rng(N * 1000 + D)
    x = (r.standard_normal((N, D)) * 2).astype(np.float32)
    w = (np.abs(r.standard_normal(N)) + 0.1).astype(np.float32)
    s = (np.abs(r.standard_normal(N)).astype(np.int32) * 2).astype(np.float32)
    want = np.asarray(jops.fused_merge(jnp.asarray(x), jnp.asarray(w),
                                       jnp.asarray(s), decay=decay,
                                       interpret=True))
    got = ops.fused_merge(torch.from_numpy(x), w, s, decay=decay).numpy()
    np.testing.assert_allclose(got, want, rtol=1e-5, atol=1e-5)


def test_fused_merge_bf16_leaf():
    r = np.random.default_rng(5)
    x = (r.standard_normal((5, 3, 4, 7)) * 3).astype(np.float32)
    xj = jnp.asarray(x).astype(jnp.bfloat16)
    want = np.asarray(jops.fused_merge(xj, jnp.ones(5), interpret=True))
    got = ops.fused_merge(torch.from_numpy(x).to(torch.bfloat16),
                          np.ones(5, np.float32))
    assert got.shape == (3, 4, 7) and got.dtype == torch.float32
    np.testing.assert_allclose(got.numpy(), want, rtol=2e-2, atol=2e-2)


def test_fused_merge_monotone_in_decay():
    x = torch.stack([torch.zeros(64), torch.ones(64)])
    w = np.ones(2, np.float32)
    s = np.asarray([0.0, 5.0], np.float32)
    prev = 1.0
    for decay in (0.0, 0.5, 1.0, 2.0):
        got = float(ops.fused_merge(x, w, s, decay=decay).mean())
        assert got <= prev + 1e-7
        prev = got
    assert prev < 0.1


# the MNIST student's ten leaves (repro_torch.models.cnn.MnistCNN(student=True))
MNIST_STUDENT_SHAPES = [(32, 1, 3, 3), (32,), (16, 32, 3, 3), (16,),
                        (16, 16, 3, 3), (16,), (64, 16, 3, 3), (64,),
                        (256, 10), (10,)]


@pytest.mark.parametrize("N", [3, 40])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("decay", [0.0, 0.5])
def test_fused_merge_leaves_matches_pallas(N, dtype, decay):
    """The multi-leaf entry (its plain version on the CPU) against the
    Pallas kernel in interpret mode, leaf by leaf, over the MNIST student's
    ten leaves: 1e-5 in f32, 2e-2 in bf16 (the single-leaf bounds)."""
    r = np.random.default_rng(N * 10 + int(decay * 2) + (dtype == "bfloat16"))
    leaves = [(r.standard_normal((N, *shape)) * 2).astype(np.float32)
              for shape in MNIST_STUDENT_SHAPES]
    w = (np.abs(r.standard_normal(N)) + 0.1).astype(np.float32)
    s = r.integers(0, 4, N).astype(np.float32)
    jd, td = (jnp.bfloat16, torch.bfloat16) if dtype == "bfloat16" else (
        jnp.float32, torch.float32)
    rows = [[torch.from_numpy(x[n]).to(td) for x in leaves] for n in range(N)]
    reset_launches()
    got = ops.fused_merge_leaves(rows, w, s, decay=decay)
    assert launch_counts()["fused_merge"] == 0          # CPU: plain
    tol = 1e-5 if dtype == "float32" else 2e-2
    for x, g in zip(leaves, got):
        assert g.shape == x.shape[1:] and g.dtype == torch.float32
        want = jops.fused_merge(jnp.asarray(x).astype(jd), jnp.asarray(w),
                                jnp.asarray(s), decay=decay, interpret=True)
        np.testing.assert_allclose(g.numpy(), np.asarray(want), rtol=tol,
                                   atol=tol)


@pytest.mark.parametrize("elt,n_tiles", [(4, 154), (2, 80)])
def test_merge_plan_tiles_cover_every_leaf_once(elt, n_tiles):
    """The kernel's tile table over the MNIST student: every column of every
    leaf in exactly one tile, no tile across a leaf boundary, each leaf's
    output on a 16-byte boundary, the layout of ``csrc/fused_merge.cu``'s
    Tile (leaf in the low and width in the high half of the third word)."""
    from repro_torch.kernels.fused_merge import TILE_BYTES, merge_plan
    sizes = [int(np.prod(shape)) for shape in MNIST_STUDENT_SHAPES]
    aligned = [i % 3 != 1 for i in range(len(sizes))]
    tiles, offsets, total = merge_plan(sizes, elt, aligned)
    assert tiles.shape == (n_tiles, 4) and tiles.dtype == np.int64
    leaf, width = tiles[:, 2] & 0xffffffff, tiles[:, 2] >> 32
    assert np.all((width >= 1) & (width <= TILE_BYTES // elt))
    for l, D in enumerate(sizes):
        mine = tiles[leaf == l]
        covered = np.concatenate([np.arange(c0, c0 + n) for c0, n in
                                  zip(mine[:, 1], width[leaf == l])])
        np.testing.assert_array_equal(np.sort(covered), np.arange(D))
        np.testing.assert_array_equal(mine[:, 0], offsets[l] + mine[:, 1])
        assert set(mine[:, 3].tolist()) == {int(aligned[l])}
        assert offsets[l] % 4 == 0
        end = offsets[l + 1] if l + 1 < len(sizes) else total
        assert end - offsets[l] in (D, D + (-D) % 4)
    assert total == sum(D + (-D) % 4 for D in sizes)


def test_fused_merge_leaves_checks_its_inputs(monkeypatch):
    monkeypatch.setattr(_build, "library", lambda: pytest.fail(
        "a CPU tensor reached the CUDA library"))
    a = [torch.ones(2, 3), torch.ones(4)]
    with pytest.raises(ValueError, match="client 1 leaf 0"):
        ops.fused_merge_leaves([a, [torch.ones(3, 2), torch.ones(4)]], [1, 1])
    with pytest.raises(ValueError, match="client 1 has 1 leaves"):
        ops.fused_merge_leaves([a, a[:1]], [1, 1])
    with pytest.raises(ValueError, match="must be"):
        ops.fused_merge_leaves([a, a], [1, 1, 1])
    meta = [torch.empty(4, device="meta")]
    with pytest.raises(ValueError, match="no kernel or plain path"):
        ops.fused_merge_leaves([meta, meta], [1, 1])
    reset_launches()
    got = ops.fused_merge_leaves([a, [2 * t for t in a]], [1, 3],
                                 [0, 0])
    np.testing.assert_allclose(got[0].numpy(), np.full((2, 3), 1.75))
    assert launch_counts()["fused_merge"] == 0


def test_reset_launches_zeroes_the_merge_and_kmeans_variants():
    from repro_torch.kernels import fused_merge as fm
    from repro_torch.kernels import kmeans_assign as km
    fm.fused_merge.variant_launches.update(leaf=2, leaves=3)
    km.kmeans_assign.variant_launches.update(split=4, stream=5)
    reset_launches()
    assert fm.fused_merge.variant_launches == {"leaf": 0, "leaves": 0}
    assert km.kmeans_assign.variant_launches == {"split": 0, "stream": 0}


@pytest.mark.parametrize("tau,alpha", [(1.0, 0.0), (2.0, 0.5), (4.0, 1.0)])
def test_refs_match_jax_refs(tau, alpha):
    """The port's oracles (``kernels/ref.py``) against ``repro.kernels.ref``,
    and each kernel's plain version against the port's oracle: one
    definition of the objective in both packages (f32, 1e-5)."""
    from repro.kernels import ref as jref
    from repro_torch.kernels import ref
    from repro_torch.kernels.fused_merge import fused_merge_plain
    from repro_torch.kernels.kd_softmax_kl import kd_loss_fwd_plain
    s, t, y = _logits(7, 50, 33)
    st, tt, yt = map(torch.from_numpy, (s, t, y))
    want = np.asarray(jref.kd_loss_ref(jnp.asarray(s), jnp.asarray(t),
                                       jnp.asarray(y), tau=tau, alpha=alpha))
    got = ref.kd_loss_ref(st, tt, yt, tau=tau, alpha=alpha)
    np.testing.assert_allclose(got.numpy(), want, rtol=1e-5, atol=1e-5)
    plain, _ = kd_loss_fwd_plain(st, tt, yt, tau=tau, alpha=alpha)
    np.testing.assert_allclose(plain.numpy(), got.numpy(), rtol=1e-5,
                               atol=1e-5)

    r = np.random.default_rng(8)
    x = r.standard_normal((6, 40)).astype(np.float32)
    w = (np.abs(r.standard_normal(6)) + 0.1).astype(np.float32)
    stale = r.integers(0, 4, 6).astype(np.float32)
    want = np.asarray(jref.fused_merge_ref(jnp.asarray(x), jnp.asarray(w),
                                           jnp.asarray(stale), decay=tau))
    got = ref.fused_merge_ref(torch.from_numpy(x), w, stale, decay=tau)
    np.testing.assert_allclose(got.numpy(), want, rtol=1e-5, atol=1e-6)
    plain = fused_merge_plain(torch.from_numpy(x), torch.from_numpy(w),
                              torch.from_numpy(stale), decay=tau)
    np.testing.assert_allclose(plain.numpy(), got.numpy(), rtol=1e-5,
                               atol=1e-6)


def test_plain_backward_matches_autodiff_of_the_ref():
    """The plain backward (what the CUDA backward kernel is held to on the
    card) against autograd of the oracle's valid-token mean, as
    tests/test_kernels.py holds the Pallas backward (rtol 1e-5, atol 1e-6)."""
    from repro_torch.kernels import ref
    s, t, y = _logits(9, 100, 700, scale=2.0)
    st = torch.from_numpy(s).requires_grad_(True)
    tt, yt = torch.from_numpy(t), torch.from_numpy(y)
    want = ref.kd_loss_ref(st, tt, yt, tau=2.0, alpha=0.5).sum() / (
        yt >= 0).sum()
    want.backward()
    s2 = torch.from_numpy(s).requires_grad_(True)
    got = ops.kd_distillation_loss(s2, tt, yt)
    got.backward()
    np.testing.assert_allclose(got.item(), want.item(), rtol=1e-5)
    np.testing.assert_allclose(s2.grad.numpy(), st.grad.numpy(), rtol=1e-5,
                               atol=1e-6)


def test_cpu_tensors_take_the_plain_path(monkeypatch):
    """On the CPU no wrapper builds or launches a kernel, and no count
    moves; an unsupported device raises instead of falling back."""
    def no_library():
        raise AssertionError("a CPU tensor reached the CUDA library")

    monkeypatch.setattr(_build, "library", no_library)
    reset_launches()
    s, t, y = _logits(6, 8, 10)
    st = torch.from_numpy(s).requires_grad_(True)
    ops.kd_distillation_loss(st, torch.from_numpy(t),
                             torch.from_numpy(y)).backward()
    ops.fused_merge(torch.ones(3, 5), np.ones(3, np.float32))
    ops.kmeans_assign(torch.ones(3, 5), torch.zeros(2, 5))
    ops.flash_attention(torch.ones(1, 4, 2, 32), torch.ones(1, 6, 1, 32),
                        torch.ones(1, 6, 1, 32))
    assert launch_counts() == {"kd_softmax_kl_fwd": 0,
                               "kd_softmax_kl_bwd": 0, "fused_merge": 0,
                               "kmeans_assign": 0, "flash_attention": 0}
    meta = torch.empty((4, 10), device="meta")
    with pytest.raises(ValueError, match="no kernel or plain path"):
        kd_loss_fwd(meta, meta, torch.empty(4, dtype=torch.int32,
                                            device="meta"))
    meta_qkv = torch.empty((1, 4, 2, 32), device="meta")
    with pytest.raises(ValueError, match="no kernel or plain path"):
        ops.flash_attention(meta_qkv, meta_qkv, meta_qkv)
