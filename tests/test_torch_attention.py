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
