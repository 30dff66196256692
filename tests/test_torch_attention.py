"""The port's flash attention (``repro_torch.kernels.ops.flash_attention``,
on the CPU its plain version) against the JAX package's: the Pallas kernel
in interpret mode at the JAX kernel test's shapes, and the plain oracle
``flash_attention_ref`` where the JAX wrapper refuses (unequal padding) and
at decode shapes.  Inputs come from numpy.  Both sides keep the scores,
the softmax weights and the product with V in float32 and round once, at
the output, so the tolerance is 2e-5 in float32 (the JAX kernel test's)
and, in bfloat16, one rounding of the output (at most 2**-7 = 7.8e-3 of a
value, rtol 8e-3) over a float32 floor near zero (atol 1e-4): tighter than
the JAX kernel test's 3e-2, which is as large as a typical output.
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels import ops as jops
from repro.kernels import ref as jref
from repro_torch.kernels import flash_attention as fa
from repro_torch.kernels import ops

TOL = {"float32": (2e-5, 2e-5), "bfloat16": (8e-3, 1e-4)}     # rtol, atol


def _inputs(seed, B, H, KVH, T, S, hd):
    """q (B, T, H, hd), k, v (B, S, KVH, hd) float32 numpy."""
    r = np.random.default_rng(seed)
    return (r.standard_normal((B, T, H, hd), np.float32),
            r.standard_normal((B, S, KVH, hd), np.float32),
            r.standard_normal((B, S, KVH, hd), np.float32))


def _both(arrays, dtype):
    """The same values as JAX and as torch arrays of ``dtype`` (float32 ->
    bfloat16 rounds to nearest even in both)."""
    jx = [jnp.asarray(a).astype(dtype) for a in arrays]
    tx = [torch.from_numpy(a).to(getattr(torch, dtype)) for a in arrays]
    return jx, tx


def _close(got, want, dtype):
    rtol, atol = TOL[dtype]
    np.testing.assert_allclose(got.float().numpy(),
                               np.asarray(want, np.float32), rtol=rtol,
                               atol=atol)


@pytest.mark.parametrize("B,H,KVH,T,S,hd", [
    (1, 4, 4, 64, 64, 32),
    (2, 8, 2, 128, 128, 64),
    (1, 4, 2, 100, 100, 32),        # the JAX wrapper's padding path
    (2, 4, 4, 64, 256, 64),         # cross-length, right-aligned
    # head dims 96 and 192 (nemotron-4-340b's smoke and full head dim)
    (1, 4, 2, 100, 100, 96),
    (1, 12, 1, 64, 64, 96),         # a GQA group of 12
    (1, 4, 2, 64, 256, 192),
    (2, 7, 1, 64, 64, 192),         # a GQA group of 7 (arctic-480b's)
])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_flash_attention_matches_the_jax_kernel(B, H, KVH, T, S, hd, dtype):
    (jq, jk, jv), (tq, tk, tv) = _both(_inputs(B + T + S, B, H, KVH, T, S,
                                               hd), dtype)
    want = jops.flash_attention(jq, jk, jv, causal=True, interpret=True)
    got = ops.flash_attention(tq, tk, tv, causal=True)
    assert got.dtype == getattr(torch, dtype) and got.shape == (B, T, H, hd)
    _close(got, want, dtype)


def test_flash_attention_windowed_matches_the_jax_kernel():
    (jq, jk, jv), (tq, tk, tv) = _both(_inputs(7, 1, 2, 2, 128, 128, 32),
                                       "float32")
    want = jops.flash_attention(jq, jk, jv, causal=True, window=32,
                                interpret=True)
    _close(ops.flash_attention(tq, tk, tv, causal=True, window=32), want,
           "float32")


def _ref(jq, jk, jv, **kw):
    """``flash_attention_ref`` in the layer layout."""
    out = jref.flash_attention_ref(jnp.moveaxis(jq, 2, 1),
                                   jnp.moveaxis(jk, 2, 1),
                                   jnp.moveaxis(jv, 2, 1), **kw)
    return jnp.moveaxis(out, 1, 2)


@pytest.mark.parametrize("B,H,KVH,T,S,hd,window", [
    (1, 4, 2, 64, 200, 64, 0),      # unequal pads: the JAX wrapper refuses
    (2, 4, 2, 64, 200, 64, 48),
    (2, 16, 2, 1, 97, 128, 0),      # decode: one query over a cache prefix
    (2, 8, 8, 1, 1, 64, 0),
    (1, 4, 2, 96, 40, 64, 0),       # T > S: the first 56 queries see no key
    (1, 12, 1, 1, 200, 96, 0),      # decode at head dims 96 and 192
    (2, 16, 2, 1, 97, 192, 0),
    (1, 4, 2, 64, 200, 192, 48),    # unequal pads with a window, hd 192
])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_flash_attention_matches_the_reference_where_jax_pads(
        B, H, KVH, T, S, hd, window, dtype):
    (jq, jk, jv), (tq, tk, tv) = _both(_inputs(T * S, B, H, KVH, T, S, hd),
                                       dtype)
    want = _ref(jq, jk, jv, causal=True, window=window)
    _close(ops.flash_attention(tq, tk, tv, causal=True, window=window), want,
           dtype)


def test_the_jax_wrapper_refuses_unequal_pads_the_port_takes():
    (jq, jk, jv), (tq, tk, tv) = _both(_inputs(1, 1, 4, 2, 64, 200, 64),
                                       "float32")
    with pytest.raises(ValueError, match="pads queries"):
        jops.flash_attention(jq, jk, jv, causal=True, interpret=True)
    assert ops.flash_attention(tq, tk, tv).shape == (1, 64, 4, 64)


def test_non_causal_and_strided_prefix():
    """``causal=False`` attends every key; a cache prefix passed as a view
    gives what its contiguous copy gives."""
    (jq, jk, jv), (tq, tk, tv) = _both(_inputs(2, 2, 4, 2, 8, 50, 32),
                                       "float32")
    _close(ops.flash_attention(tq, tk, tv, causal=False),
           _ref(jq, jk, jv, causal=False), "float32")
    view = ops.flash_attention(tq[:, :1], tk[:, :30], tv[:, :30])
    copy = ops.flash_attention(tq[:, :1], tk[:, :30].contiguous(),
                               tv[:, :30].contiguous())
    torch.testing.assert_close(view, copy, rtol=0, atol=0)


@pytest.mark.parametrize("B,T,S,H,KVH,want", [
    (2, 4096, 4096, 16, 2, (512, 2, 1)),    # the path's prefill: no split
    (2, 1, 4097, 16, 2, (1, 2, 65)),        # its decode: a split per
    (2, 1, 4128, 16, 2, (1, 2, 65)),        # 64-key block
    (1, 64, 64, 4, 4, (1, 4, 1)),           # G = 1: 64 positions a block
    (1, 1, 100, 128, 1, (1, 2, 2)),         # G = 128: two head blocks
])
def test_kernel_grid_plan(B, T, S, H, KVH, want):
    p = fa.plan(B, T, S, H, KVH)
    assert (p["grid_x"], p["grid_y"], p["n_split"]) == want
    assert p["split_len"] % fa.BLOCK_K == 0
    assert p["n_split"] * p["split_len"] >= S
    assert (p["n_split"] - 1) * p["split_len"] < S   # no empty span


def test_head_dims_the_kernels_take():
    """Every kernel is built for head dims 32, 64, 96, 128 and 192 (an
    explicit tuple: 48, for one, raises on the card)."""
    assert fa.HEAD_DIMS == (32, 64, 96, 128, 192)
    assert 48 not in fa.HEAD_DIMS


def test_wrapper_checks_shapes():
    q = torch.zeros(1, 4, 4, 32)
    with pytest.raises(ValueError, match="must divide"):
        ops.flash_attention(q, torch.zeros(1, 4, 3, 32),
                            torch.zeros(1, 4, 3, 32))
    with pytest.raises(ValueError, match="must be"):
        ops.flash_attention(q, torch.zeros(1, 4, 2, 32),
                            torch.zeros(1, 5, 2, 32))
    with pytest.raises(ValueError, match="window"):
        ops.flash_attention(q, q, q, window=-1)


# ---------------------------------------------------------------------------
# The Hopper kernels' planners, dispatch and counters, and the tensor-core
# kernel's arithmetic written out in torch.

SERVING_DECODE = [(2, 4097, 16, 2), (2, 4128, 16, 2)]     # B, S, H, KVH


@pytest.mark.parametrize("B,S,H,KVH,causal,window", [
    *[(*shape, True, 0) for shape in SERVING_DECODE],
    (1, 1, 4, 4, True, 0),          # one key, G = 1
    (2, 97, 16, 2, True, 0),
    (1, 100, 128, 1, True, 0),      # G = 128: 16 blocks of 8 heads
    (1, 200_000, 48, 8, True, 0),   # G = 6 (a padded head), spans capped
    (1, 300, 4, 2, True, 50),       # the window: keys [250, 300)
    (1, 300, 4, 2, False, 50),      # no causal mask: the window is unused
])
def test_decode_plan_covers_the_visible_keys(B, S, H, KVH, causal, window):
    p = fa.decode_plan(B, S, H, KVH, causal=causal, window=window)
    G = H // KVH
    visible = min(S, window) if causal and window else S
    assert p["lo"] == S - visible
    assert p["span_len"] % fa.DECODE_SPAN_ALIGN == 0
    assert 1 <= p["n_span"] <= fa.DECODE_MAX_SPANS
    assert p["n_span"] * p["span_len"] >= visible     # the spans cover S
    assert (p["n_span"] - 1) * p["span_len"] < visible   # none is empty
    heads = p["heads"]
    assert heads in (1, 2, 4, 8) and heads <= max(1, 2 * G - 1)
    assert p["n_gblk"] * heads >= G > (p["n_gblk"] - 1) * heads
    assert p["blocks"] == B * KVH * p["n_gblk"] * p["n_span"]
    if (B, S, H, KVH) in SERVING_DECODE:
        assert p["blocks"] >= 132                     # every SM of an H100


@pytest.mark.parametrize("T,S,causal,window", [
    (4096, 4096, True, 0),          # the serving prefill
    (96, 40, True, 0),              # T > S: rows that see no key
    (512, 512, True, 128),
    (100, 300, False, 0),
])
def test_tensor_core_plan_walks_the_visible_tiles_heaviest_first(
        T, S, causal, window):
    B, H = 2, 16
    p = fa.tc_plan(B, T, S, H, causal=causal, window=window)
    assert (p["grid_x"], p["grid_y"]) == (B * H, -(-T // fa.TC_ROWS))
    tiles = p["key_tiles"]
    assert min(tiles) >= 1 and max(tiles) <= -(-S // fa.TC_BLOCK_K)
    mask = (fa.causal_mask(T, S, offset=S - T, window=window) if causal
            else torch.ones(T, S, dtype=torch.bool))
    for y, n in enumerate(tiles):       # every key a row sees is walked
        t0 = (p["grid_y"] - 1 - y) * fa.TC_ROWS
        rows = mask[t0:t0 + fa.TC_ROWS]
        seen = rows.any(dim=0).nonzero()
        if bool(rows.any(dim=1).all()) and len(seen):
            assert int(seen.max()) - int(seen.min()) < n * fa.TC_BLOCK_K
        else:                           # a row sees none: every key
            assert n == -(-S // fa.TC_BLOCK_K)
    if causal and T == S and not window:
        assert tiles == sorted(tiles, reverse=True)   # heaviest first
        assert tiles[0] == p["grid_y"]


def test_dispatch_is_by_dtype_and_query_length():
    assert fa.variant(torch.float32, 1) == "decode"
    assert fa.variant(torch.bfloat16, 1) == "decode"
    assert fa.variant(torch.bfloat16, 2) == "tensor_core"
    assert fa.variant(torch.bfloat16, 4096) == "tensor_core"
    assert fa.variant(torch.float32, 4096) == "v1"
    assert fa.VARIANTS == ("v1", "tensor_core", "decode")


def test_reset_launches_zeroes_the_variant_counts():
    from repro_torch.kernels import launch_counts, reset_launches
    fa.flash_attention.launches = 3
    fa.flash_attention.variant_launches.update(v1=1, tensor_core=1, decode=1)
    reset_launches()
    assert fa.flash_attention.variant_launches == dict.fromkeys(
        fa.VARIANTS, 0)
    assert launch_counts()["flash_attention"] == 0
    ops.flash_attention(torch.ones(1, 4, 2, 32), torch.ones(1, 6, 1, 32),
                        torch.ones(1, 6, 1, 32))          # CPU: plain
    assert fa.flash_attention.variant_launches == dict.fromkeys(
        fa.VARIANTS, 0)


def _tensor_core_arithmetic(q, k, v, *, split: bool = True):
    """The tensor-core kernel's arithmetic in torch (causal, no window):
    64-key tiles; S = Q K^T from bf16 operands with float32 sums (each
    product exact), ``scale`` on the float32 scores; masked scores -1e30;
    the online softmax from m = -1e30; P = exp(S - m) in float32, split into
    P_hi = bf16(P) and P_lo = bf16(P - P_hi) for the two products with V
    (``split=False``: P rounded once to bf16); l the sum of the unrounded
    P; the output rounded once to bf16."""
    B, T, H, hd = q.shape
    S, G = k.shape[1], H // k.shape[2]
    qf = q.float().transpose(1, 2)                          # (B, H, T, hd)
    kf = k.float().repeat_interleave(G, dim=2).transpose(1, 2)
    vf = v.float().repeat_interleave(G, dim=2).transpose(1, 2)
    seen = fa.causal_mask(T, S, offset=S - T)
    m = torch.full((B, H, T, 1), fa.NEG)
    l = torch.zeros(B, H, T, 1)
    o = torch.zeros(B, H, T, hd)
    for kb in range(0, S, fa.TC_BLOCK_K):
        ke = min(S, kb + fa.TC_BLOCK_K)
        s = (qf @ kf[:, :, kb:ke].transpose(-1, -2)) * hd ** -0.5
        s = s.masked_fill(~seen[:, kb:ke], fa.NEG)
        m_new = torch.maximum(m, s.amax(dim=-1, keepdim=True))
        alpha, p = torch.exp(m - m_new), torch.exp(s - m_new)
        l = l * alpha + p.sum(dim=-1, keepdim=True)
        hi = p.bfloat16().float()
        pv = hi @ vf[:, :, kb:ke]
        if split:
            pv = pv + (p - hi).bfloat16().float() @ vf[:, :, kb:ke]
        o, m = o * alpha + pv, m_new
    return (o / l).transpose(1, 2).bfloat16()


def _outside_fa_tol(got, want):
    """How many outputs break ``chip_smoke.FA_TOL`` in bf16."""
    rtol, atol = TOL["bfloat16"]
    g, w = got.float(), want.float()
    return int(((g - w).abs() > atol + rtol * w.abs()).sum())


@pytest.mark.parametrize("B,H,KVH,T,S,hd", [
    (1, 4, 2, 512, 512, 128),       # causal prefill
    (1, 16, 2, 1, 4128, 128),       # a serving decode shape
])
def test_tensor_core_arithmetic_matches_plain_in_bf16(B, H, KVH, T, S, hd):
    """Split P keeps the weights to float32 accuracy: every output within
    the card's bf16 tolerance (one rounding of the output) of the plain
    version."""
    import sys
    from pathlib import Path
    sys.path.insert(0, str(Path(__file__).resolve().parents[1]))
    import chip_smoke
    assert chip_smoke.FA_TOL["bfloat16"] == TOL["bfloat16"]
    _, (q, k, v) = _both(_inputs(S + T, B, H, KVH, T, S, hd), "bfloat16")
    want = fa.flash_attention_plain(q, k, v, causal=True)
    assert _outside_fa_tol(_tensor_core_arithmetic(q, k, v), want) == 0


def test_rounding_p_once_to_bf16_breaks_the_tolerance():
    """The design's numerical argument: with P rounded once to bf16 for
    the product with V, thousands of the prefill shape's outputs fall
    outside the one-rounding tolerance that split P meets."""
    _, (q, k, v) = _both(_inputs(1024, 1, 4, 2, 512, 512, 128), "bfloat16")
    want = fa.flash_attention_plain(q, k, v, causal=True)
    assert _outside_fa_tol(_tensor_core_arithmetic(q, k, v, split=False),
                           want) > 1000


def test_a_call_off_the_cpu_that_needs_a_gradient_raises():
    """The CUDA kernels have no backward, so a call that would need one
    raises before the device dispatch (``meta`` tensors reach the same
    branch a CUDA tensor does); without grad mode or grad inputs the call
    goes on to the dispatch, which has no path for ``meta``."""
    shape = (1, 4, 2, 32)
    grad = torch.empty(shape, device="meta", requires_grad=True)
    plain = torch.empty(shape, device="meta")
    for q, k in ((grad, plain), (plain, grad)):
        with pytest.raises(NotImplementedError, match="Queue 1 item 10.2"):
            ops.flash_attention(q, k, plain)
    with torch.no_grad(), pytest.raises(ValueError,
                                        match="no kernel or plain path"):
        ops.flash_attention(grad, grad, grad)
    with pytest.raises(ValueError, match="no kernel or plain path"):
        ops.flash_attention(plain, plain, plain)
    fa.refuse_grad(*(torch.ones(shape, requires_grad=True),) * 3)   # CPU


@pytest.mark.parametrize("T,S,window", [(24, 24, 0), (16, 40, 8)])
def test_the_cpu_path_stays_differentiable(T, S, window):
    """On the CPU the plain version carries the gradient: q, k and v's
    gradients of a weighted sum of the output against ``jax.grad`` of the
    JAX oracle, whose attention is what the reference trains through.
    Float32 on both sides, summed in other orders: 1e-5."""
    import jax
    arrays = _inputs(T + S, 2, 4, 2, T, S, 32)
    g = np.random.default_rng(1).standard_normal((2, T, 4, 32), np.float32)

    def loss(q, k, v):
        return jnp.sum(_ref(q, k, v, causal=True, window=window) * g)
    want = jax.grad(loss, argnums=(0, 1, 2))(*map(jnp.asarray, arrays))
    tx = [torch.from_numpy(a).requires_grad_(True) for a in arrays]
    out = ops.flash_attention(*tx, causal=True, window=window)
    assert out.grad_fn is not None
    (out * torch.from_numpy(g)).sum().backward()
    for t, w in zip(tx, want):
        np.testing.assert_allclose(t.grad.numpy(), np.asarray(w), rtol=1e-5,
                                   atol=1e-5)
