"""The KD loss kernels' planner (``repro_torch.kernels.kd_softmax_kl.plan``)
and their arithmetic written out in torch, against the JAX package's Pallas
kernels in interpret mode on the same numpy inputs.

- The planner: its regime cut-offs, the rows regime's tile inside the
  kernels' limits, and the kernels' index arithmetic (written out here,
  with the thread counts the CUDA side derives from the plan) reaching
  every (row, column) of the logits exactly once in every regime, forward
  and backward.
- The forward's arithmetic as ``csrc/kd_softmax_kl.cu`` does it: base-2
  exponentials of logits times log2(e)/tau, the online softmax moved once
  per chunk of 16 elements, the fixed-order butterfly merges of lanes and
  of 1-8 warps' states, held to the Pallas forward at 2e-5
  (tests/test_kernels.py's float32 bound).
- The backward's folded coefficients (A, B, three exp2 offsets) held to
  ``jax.grad`` of the JAX loss at rtol 1e-5, atol 1e-6
  (tests/test_torch_kernels.py's gradient bound), and ``chip_smoke.py``'s
  bf16 gradient check (``KD_BF16_DS``) passing one rounding of the float32
  gradient and failing a gradient of zeros or with each bf16 pair swapped.
"""
import sys
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

sys.path.insert(0, str(Path(__file__).resolve().parents[1]))
import chip_smoke  # noqa: E402  (the repository root's smoke script)
from repro.kernels import ops as jops  # noqa: E402
from repro.kernels.kd_softmax_kl import kd_loss_fwd as jax_kd_loss_fwd  # noqa: E402
from repro_torch.kernels import kd_softmax_kl as kd  # noqa: E402
from repro_torch.kernels import reset_launches  # noqa: E402

torch.set_num_threads(1)

NEG = -1e30
LOG2E = np.float32(kd.LOG2E)
LN2 = np.float32(np.log(2.0))


def _logits(seed, T, V, scale=3.0):
    r = np.random.default_rng(seed)
    s = (r.standard_normal((T, V)) * scale).astype(np.float32)
    t = (r.standard_normal((T, V)) * scale).astype(np.float32)
    y = r.integers(0, V, T).astype(np.int32)
    y[r.random(T) < 0.1] = -1
    return s, t, y


def _jax_per_token(s, t, y, tau, alpha):
    """The Pallas forward (interpret mode) on padded inputs, cropped back."""
    T, V = s.shape
    bt, bv = jops._blocks(V)
    sp = jops._pad_to(jops._pad_to(jnp.asarray(s), 0, bt, 0.0), 1, bv, jops.NEG)
    tp = jops._pad_to(jops._pad_to(jnp.asarray(t), 0, bt, 0.0), 1, bv, jops.NEG)
    yp = jops._pad_to(jnp.asarray(y), 0, bt, -1)
    loss, stats = jax_kd_loss_fwd(sp, tp, yp, tau=tau, alpha=alpha, block_t=bt,
                                  block_v=bv, interpret=True)
    return np.array(loss)[:T], np.array(stats)[:T]


# The numbers csrc/kd_softmax_kl.cu derives from a plan, written out:
# launch_fwd's stream threads (a thread per 64 elements, 32 to 256) and
# kd_bwd_chunk_kernel's vectors a block (256 threads x 2).
STREAM_THREADS = 256
BWD_VECS_A_BLOCK = 256 * 2


def _stream_threads(V):
    n = 32
    while n < STREAM_THREADS and n * 4 * kd.CHUNK < V:
        n *= 2
    return n


# ------------------------------------------------------------------ planner
def test_plan_at_the_packed_path():
    """(2560, 10): 20 rows a block (128 blocks on 132 SMs), 4 lanes a row
    (3 or 2 elements each); (64, 10), the loop engine's step, a row a
    block."""
    assert kd.plan(2560, 10) == {"regime": "rows", "tile_rows": 20,
                                 "lanes": 4}
    assert kd.plan(64, 10) == {"regime": "rows", "tile_rows": 1,
                               "lanes": 4}


@pytest.mark.parametrize("sms", [kd.H100_SMS, 114])
def test_plan_regime_cut_offs(sms):
    """rows up to V = 512, stream above it at any T; the rows a tile
    spread T over the SMs."""
    assert kd.plan(1000, kd.ROWS_MAX_V, sms)["regime"] == "rows"
    for T in (1, 16, 2 * sms - 1, 2048):
        assert kd.plan(T, kd.ROWS_MAX_V + 1, sms) == {
            "regime": "stream", "tile_rows": 1, "lanes": 1}
    assert kd.plan(2560, 10, sms)["tile_rows"] == -(-2560 // sms)
    assert kd.plan(10 ** 6, 10, sms)["tile_rows"] == 256 // 4
    # lanes a row: 4 elements a lane up to V = 128, 16 above
    assert [kd.plan(64, V, sms)["lanes"] for V in (1, 4, 5, 10, 31, 128,
                                                   129, 512)] == \
        [1, 1, 2, 4, 8, 32, 16, 32]
    assert [_stream_threads(V) for V in (513, 2048, 2049, 32000)] == \
        [32, 32, 64, 256]


@pytest.mark.parametrize("elt", [4, 2])
def test_plan_rows_fit_the_kernels_limits(elt):
    """What fedsikd_kd_fwd checks of a rows plan (L a power of two up to
    32, 16 L >= V, R L <= 256), for every V the regime takes and T up to
    a million, and the two shared-memory tiles that follow inside 48 KB."""
    E = 16 // elt
    for V in range(1, kd.ROWS_MAX_V + 1):
        for T in (1, 200, 10 ** 6):
            p = kd.plan(T, V)
            R, L = p["tile_rows"], p["lanes"]
            assert L & (L - 1) == 0 and L <= 32 and L * kd.CHUNK >= V
            assert 1 <= R and R * L <= kd.ROWS_THREADS
            assert 2 * ((R * V + 2 * E - 1) // E * E) * elt <= 48 * 1024


# ----------------------------------------------- the kernels' index arithmetic
def _head(first_elem: int, n: int, elt: int) -> int:
    """head_len: elements from element ``first_elem`` of a 16-byte aligned
    buffer up to the next 16-byte boundary, at most n."""
    E = 16 // elt
    return min(n, (E - first_elem % E) % E)


def _cover_vectors(counts, row, v0, v1, head, E, nthr, U):
    """The vectors [v0, v1) of a row as slice_state walks them: thread tid,
    chunk base i = v0 + tid + it U nthr, vector i + u nthr."""
    its = -(-(v1 - v0) // (U * nthr)) if v1 > v0 else 0
    k = (v0 + np.arange(nthr)[:, None, None]
         + (np.arange(its) * U * nthr)[None, :, None]
         + (np.arange(U) * nthr)[None, None, :]).ravel()
    k = k[k < v1]
    cols = (head + k[:, None] * E + np.arange(E)[None, :]).ravel()
    np.add.at(counts[row], cols, 1)


def _cover_fwd(p, T, V, elt, off, vec):
    """How often the forward folds in each (row, column), for logits whose
    element 0 lies ``off`` elements past a 16-byte boundary."""
    E = 16 // elt
    counts = np.zeros((T, V), np.int32)
    if p["regime"] == "rows":
        R, L = p["tile_rows"], p["lanes"]
        maxe = 4 if -(-V // L) <= 4 else kd.CHUNK
        assert L * maxe >= V
        for b in range(-(-T // R)):
            for r in range(b * R, min(T, b * R + R)):
                for q in range(L):
                    cols = q + L * np.arange(maxe)
                    np.add.at(counts[r], cols[cols < V], 1)
        return counts
    U = kd.CHUNK // E
    for row in range(T):
        head = _head(off + row * V, V, elt) if vec else V
        nvec = (V - head) // E
        _cover_vectors(counts, row, 0, nvec, head, E, _stream_threads(V), U)
        counts[row, :head] += 1                 # the scalars
        counts[row, head + nvec * E:] += 1
    return counts


def _cover_bwd(p, T, V, elt, off, vec):
    """How often the backward writes each (row, column)."""
    E = 16 // elt
    counts = np.zeros((T, V), np.int32)
    flat = counts.reshape(-1)
    if p["regime"] == "rows":
        R = p["tile_rows"]
        for b in range(-(-T // R)):
            a, n = b * R * V, min(R, T - b * R) * V
            head = _head(off + a, n, elt) if vec else n
            nvec = (n - head) // E
            idx = a + head + (np.arange(nvec)[:, None] * E
                              + np.arange(E)[None, :]).ravel()
            np.add.at(flat, idx, 1)
            flat[a:a + head] += 1
            flat[a + head + nvec * E:a + n] += 1
        return counts
    P = BWD_VECS_A_BLOCK
    chunks = max(1, -(-(-(-V // E)) // P))
    for row in range(T):
        head = _head(off + row * V, V, elt) if vec else V
        nvec = (V - head) // E
        assert chunks * P >= nvec
        for ch in range(chunks):
            k = np.arange(ch * P, min(nvec, ch * P + P))
            np.add.at(counts[row], (head + k[:, None] * E
                                    + np.arange(E)[None, :]).ravel(), 1)
        counts[row, :head] += 1
        counts[row, head + nvec * E:] += 1
    return counts


@pytest.mark.parametrize("V", [1, 10, 31, 32003, 151936])
@pytest.mark.parametrize("elt", [4, 2])
def test_every_row_and_column_is_covered_once(V, elt):
    """Every regime the planner gives (rows with 1 to 4 rows a tile on a
    card of 4 SMs; stream), base offsets 0 and 1 element, and rows whose
    starts are not 16-byte aligned (odd V); with s, t and ds not aligned
    alike (vec = 0) every element is scalar."""
    seen = set()
    for T in (1, 3, 8, 13):
        p = kd.plan(T, V, sms=4)
        seen.add(p["regime"])
        for off, vec in ((0, 1), (1, 1), (0, 0)):
            np.testing.assert_array_equal(_cover_fwd(p, T, V, elt, off, vec),
                                          1)
            np.testing.assert_array_equal(_cover_bwd(p, T, V, elt, off, vec),
                                          1)
    assert seen == ({"rows"} if V <= kd.ROWS_MAX_V else {"stream"})


def test_the_path_and_the_served_shapes_are_covered_once():
    """The packed path's (2560, 10) f32 on the H100's plan, and (16,
    151936) bf16 on stream, 256 threads a row."""
    p = kd.plan(2560, 10)
    np.testing.assert_array_equal(_cover_fwd(p, 2560, 10, 4, 0, 1), 1)
    np.testing.assert_array_equal(_cover_bwd(p, 2560, 10, 4, 0, 1), 1)
    p = kd.plan(16, 151936)
    assert p["regime"] == "stream" and _stream_threads(151936) == 256
    np.testing.assert_array_equal(_cover_fwd(p, 16, 151936, 2, 0, 1), 1)
    np.testing.assert_array_equal(_cover_bwd(p, 16, 151936, 2, 0, 1), 1)


# ------------------------------------------------ the arithmetic, in torch
def _empty(shape):
    neg, zero = torch.full(shape, NEG), torch.zeros(shape)
    return [neg, zero, zero.clone(), neg.clone(), zero.clone(), neg.clone(),
            zero.clone()]


def _update(st, s, t, c):
    """update<N>: (..., N) chunks (NEG padding) into (...) states
    (mt, lt, ut, ms, ls, m1, l1), maxima in base-2 units."""
    smax, tmax = s.amax(-1), t.amax(-1)
    mt = torch.maximum(st[0], tmax * c)
    ms = torch.maximum(st[3], smax * c)
    m1 = torch.maximum(st[5], smax * LOG2E)
    et = torch.exp2(t * c - mt[..., None])
    es = torch.exp2(s * c - ms[..., None])
    l1 = torch.exp2(s * LOG2E - m1[..., None]).sum(-1)
    at = torch.exp2(st[0] - mt)
    return [mt, st[1] * at + et.sum(-1), st[2] * at + (et * (t - s)).sum(-1),
            ms, st[4] * torch.exp2(st[3] - ms) + es.sum(-1), m1,
            st[6] * torch.exp2(st[5] - m1) + l1]


def _merge(a, b):
    out = []
    for i in (0, 3, 5):
        m = torch.maximum(a[i], b[i])
        xa, xb = torch.exp2(a[i] - m), torch.exp2(b[i] - m)
        out.append((i, m))
        out.append((i + 1, a[i + 1] * xa + b[i + 1] * xb))
        if i == 0:
            out.append((2, a[2] * xa + b[2] * xb))
    return [v for _, v in sorted(out, key=lambda kv: kv[0])]


def _butterfly(st, width):
    """merge_lanes over the last axis (a multiple of ``width``): lane x
    merges with lane x ^ off for off = width / 2 .. 1."""
    n = st[0].shape[-1]
    for off in (width // 2 ** k for k in range(1, width.bit_length())):
        idx = torch.arange(n) ^ off
        st = _merge(st, [x[..., idx] for x in st])
    return st


def _pad_lanes(st, n):
    k = st[0].shape[-1]
    if k == n:
        return st
    e = _empty(st[0].shape[:-1] + (n - k,))
    return [torch.cat([x, y], -1) for x, y in zip(st, e)]


def _finish(st, picked, y, tau, alpha):
    logz = [st[m] * LN2 + torch.log(st[l]) for m, l in ((0, 1), (3, 4), (5, 6))]
    kl = st[2] / st[1] * np.float32(1.0 / tau) + logz[1] - logz[0]
    valid = (y >= 0).float()
    loss = (np.float32(1 - alpha) * (logz[2] - picked)
            + np.float32(alpha) * np.float32(tau) * np.float32(tau) * kl) * valid
    return loss, torch.stack(logz, -1)


def _picked(s, y):
    V = s.shape[1]
    hit = (y >= 0) & (y < V)
    return torch.where(hit, s.gather(1, y.long().clamp(0, V - 1)[:, None])
                       [:, 0], torch.zeros(()))


def _mirror_rows(s, t, y, p, tau, alpha):
    """kd_fwd_rows_kernel: lane q of a row folds elements q, q + L, .. in
    one chunk update, then a butterfly over the row's L lanes."""
    T, V = s.shape
    c = np.float32(kd.LOG2E / tau)
    L = p["lanes"]
    maxe = 4 if -(-V // L) <= 4 else kd.CHUNK
    cols = torch.arange(L)[:, None] + L * torch.arange(maxe)[None, :]
    real = cols < V
    sv = torch.where(real, s[:, cols.clamp(max=V - 1)], torch.tensor(NEG))
    tv = torch.where(real, t[:, cols.clamp(max=V - 1)], torch.tensor(NEG))
    st = _update(_empty((T, L)), sv, tv, c)
    st = [x[..., 0] for x in _butterfly(st, L)]
    return _finish(st, _picked(s, y), y, tau, alpha)


def _mirror_stream(s, t, y, elt, nthr, tau, alpha):
    """kd_fwd_stream_kernel: per row, per thread, chunks of 16 elements in
    row_state's order, then the row's head and tail scalars, then the
    butterflies over each warp's lanes and over the warps' states."""
    T, V = s.shape
    E, U = 16 // elt, kd.CHUNK // (16 // elt)
    c = np.float32(kd.LOG2E / tau)
    neg = torch.tensor(NEG)
    rows = []
    for row in range(T):
        head = _head(row * V, V, elt)
        nvec = (V - head) // E
        st = _empty((nthr,))
        tid = torch.arange(nthr)
        for i0 in range(0, nvec, U * nthr):
            k = i0 + tid[:, None] + torch.arange(U)[None, :] * nthr
            real = (k < nvec)[..., None].expand(nthr, U, E)
            cols = (head + k[..., None] * E + torch.arange(E)).clamp(max=V - 1)
            sv = torch.where(real, s[row][cols], neg).reshape(nthr, -1)
            tv = torch.where(real, t[row][cols], neg).reshape(nthr, -1)
            new = _update(st, sv, tv, c)
            has = i0 + tid < nvec
            st = [torch.where(has, a, b) for a, b in zip(new, st)]
        tail0 = head + nvec * E
        for j in [*range(head), *range(tail0, V)]:
            lane = j % nthr if j < head else (j - tail0) % nthr
            one = [x[lane:lane + 1] for x in st]
            one = _update(one, s[row, j].reshape(1, 1),
                          t[row, j].reshape(1, 1), c)
            for x, v in zip(st, one):
                x[lane] = v[0]
        st = _butterfly([x.reshape(-1, 32) for x in st], 32)
        st = _pad_lanes([x[:, 0] for x in st], 32)
        rows.append([x[0] for x in _butterfly(st, 32)])
    st = [torch.stack(v) for v in zip(*rows)]
    return _finish(st, _picked(s, y), y, tau, alpha)


def _inputs(seed, T, V, elt):
    """f32 logits, or bf16-rounded ones (as float32) for elt = 2."""
    s, t, y = _logits(seed, T, V)
    if elt == 2:
        s = torch.from_numpy(s).bfloat16().float().numpy()
        t = torch.from_numpy(t).bfloat16().float().numpy()
    return s, t, y


def _check_fwd(got, s, t, y, tau, alpha):
    loss_j, stats_j = _jax_per_token(s, t, y, tau, alpha)
    np.testing.assert_allclose(got[0].numpy(), loss_j, rtol=2e-5, atol=2e-5)
    np.testing.assert_allclose(got[1].numpy(), stats_j, rtol=2e-5, atol=2e-5)


@pytest.mark.parametrize("tau", [0.7, 2.0, 3.0])
@pytest.mark.parametrize("T,V,elt", [(37, 10, 4), (20, 31, 2), (9, 300, 4)])
def test_rows_arithmetic_matches_jax(T, V, elt, tau):
    s, t, y = _inputs(T + V, T, V, elt)
    p = kd.plan(T, V)
    assert p["regime"] == "rows"
    got = _mirror_rows(*map(torch.from_numpy, (s, t, y)), p, tau, 0.5)
    _check_fwd(got, s, t, y, tau, 0.5)


@pytest.mark.parametrize("tau", [0.7, 2.0, 3.0])
@pytest.mark.parametrize("V,elt", [(1100, 4), (1031, 4), (2061, 2)])
def test_stream_arithmetic_matches_jax(V, elt, tau):
    """One block a row, a chunk of 16 elements a thread at a time; odd V
    gives rows with a scalar head and tail."""
    s, t, y = _inputs(V, 8, V, elt)
    assert kd.plan(8, V)["regime"] == "stream"
    got = _mirror_stream(*map(torch.from_numpy, (s, t, y)), elt,
                         _stream_threads(V), tau, 0.25)
    _check_fwd(got, s, t, y, tau, 0.25)


@pytest.mark.parametrize("warps", range(1, 9))
@pytest.mark.parametrize("tau", [0.7, 2.0, 3.0])
def test_warp_merge_matches_jax(warps, tau):
    """A row's vectors over a block of 1-8 warps (some threads idle at 8),
    the warps' states merged in a fixed order by the butterfly over warp
    0's lanes, one state a lane (the rest empty)."""
    elt = 2 if warps % 2 else 4
    s, t, y = _inputs(warps, 3, 2053, elt)
    got = _mirror_stream(*map(torch.from_numpy, (s, t, y)), elt, 32 * warps,
                         tau, 0.5)
    _check_fwd(got, s, t, y, tau, 0.5)


def _mirror_bwd(s, t, y, stats, g, tau, alpha):
    """The backward kernels' arithmetic from the folded coefficients:
    ds = A p1 + B (ps - pt) - A [j == y]."""
    T, V = s.shape
    c = np.float32(kd.LOG2E / tau)
    gv = torch.where(y >= 0, g, torch.zeros(()))[:, None]
    A = gv * np.float32(1 - alpha)
    B = gv * (np.float32(alpha) * np.float32(tau))
    Lt, Ls, L1 = (stats[:, i:i + 1] * LOG2E for i in range(3))
    ps = torch.exp2(s * c - Ls)
    pt = torch.exp2(t * c - Lt)
    d = A * torch.exp2(s * LOG2E - L1) + B * (ps - pt)
    hit = (y >= 0) & (y < V)
    onehot = torch.zeros(T, V)
    onehot[torch.arange(T)[hit], y[hit].long()] = 1.0
    return d - A * onehot


@pytest.mark.parametrize("tau,alpha", [(0.7, 0.5), (2.0, 0.5), (3.0, 0.25)])
@pytest.mark.parametrize("T,V", [(64, 10), (40, 700)])
def test_backward_coefficients_match_jax_grad(T, V, tau, alpha):
    s, t, y = _logits(T + V + 1, T, V, scale=2.0)
    g_j = jax.grad(lambda s_: jops.kd_distillation_loss(
        s_, jnp.asarray(t), jnp.asarray(y), tau, alpha, True))(jnp.asarray(s))
    _, stats = _jax_per_token(s, t, y, tau, alpha)
    n = max(1, int((y >= 0).sum()))
    got = _mirror_bwd(*map(torch.from_numpy, (s, t, y, stats)),
                      torch.full((T,), np.float32(1.0 / n)), tau, alpha)
    np.testing.assert_allclose(got.numpy(), np.asarray(g_j), rtol=1e-5,
                               atol=1e-6)


@pytest.mark.parametrize("T,V", [(64, 10), (2560, 10), (300, 32003),
                                 (16, 151936)], ids=str)
def test_bf16_ds_check_fails_zeros_and_swapped_pairs(monkeypatch, T, V):
    """On chip_smoke's inputs the plain bf16 ds (one rounding of the
    float32 one) passes ``check_bf16_ds``; zeros, and for even V each pair
    of bf16 elements swapped, fail it (KD_TOL's 5e-2 alone passes zeros
    wherever every |ds| is below 5e-2)."""
    monkeypatch.setattr(chip_smoke, "DEV", "cpu")
    monkeypatch.setattr(chip_smoke, "emit", lambda obj: None)
    s, t, y = chip_smoke._kd_inputs(T, V, torch.bfloat16, T + V)
    g = chip_smoke._lane_grads(y, T)
    _, stats = kd.kd_loss_fwd_plain(s, t, y, tau=2.0, alpha=0.5)
    ds = kd.kd_loss_bwd_plain(s, t, y, stats, g, tau=2.0, alpha=0.5)
    want = kd.kd_loss_bwd_plain(s.float(), t.float(), y, stats, g, tau=2.0,
                                alpha=0.5)
    chip_smoke.check_bf16_ds("plain", ds, want)
    bad = [torch.zeros_like(ds)]
    if V % 2 == 0:
        bad.append(ds.view(T, V // 2, 2).flip(-1).reshape(T, V))
    for wrong in bad:
        with pytest.raises(RuntimeError):
            chip_smoke.check_bf16_ds("wrong", wrong, want)


def test_reset_launches_zeroes_the_kd_variants():
    kd.kd_loss_fwd.variant_launches.update(rows=2, stream=3)
    kd.kd_loss_bwd.variant_launches.update(rows=5, stream=6)
    reset_launches()
    assert kd.kd_loss_fwd.variant_launches == {"rows": 0, "stream": 0}
    assert kd.kd_loss_bwd.variant_launches == {"rows": 0, "stream": 0}
