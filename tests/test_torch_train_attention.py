"""The port's training attention against the JAX package on the CPU:
``_sdpa`` and ``sdpa_blocked`` (values and q/k/v gradients, below and at
or above ``2 * attn_block``, with a sliding window, ragged blocks and
T < S), ``attention_fwd(train=True)``'s choice between them, and the
explicit ``train`` switch that keeps training off the flash kernel.
Inputs from numpy seeds, float32, held at 1e-5.
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_config as jax_config
from repro.models import layers as jly
from repro_torch.configs import get_config
from repro_torch.convert import lm_params_from_jax
from repro_torch.models import layers as ly
from repro_torch.models import transformer as tf

KEY = jax.random.PRNGKey(0)
TOL = 1e-5


def _cfgs(arch, **over):
    over = {"dtype": "float32", "remat": False, **over}
    return (dataclasses.replace(jax_config(arch, smoke=True), **over),
            dataclasses.replace(get_config(arch, smoke=True), **over))


def _close(got, want, tol=TOL):
    np.testing.assert_allclose(got.detach().float().numpy(),
                               np.asarray(want, np.float32), rtol=tol,
                               atol=tol)


def test_forward_train_takes_no_flash_kernel_and_serving_does(monkeypatch):
    """``train=True`` is an explicit switch: a serving forward (even with
    grad-requiring params) calls flash attention, a training one never."""
    from repro_torch.kernels import ops
    calls = []
    real = ops.flash_attention
    monkeypatch.setattr(ops, "flash_attention",
                        lambda *a, **k: calls.append(1) or real(*a, **k))
    _, tc = _cfgs("qwen2.5-3b")
    p = tf.init_lm(0, tc, device="cpu")
    b = {"tokens": torch.zeros((1, 8), dtype=torch.long)}
    tf.forward(p, tc, b)
    assert len(calls) == tc.num_layers
    tf.forward(p, tc, b, train=True)
    tf.lm_loss(p, tc, {**b, "labels": b["tokens"]})
    assert len(calls) == tc.num_layers


# ------------------------------------------------------------ attention
def _qkv(B, T, H, KVH, hd, seed):
    r = np.random.default_rng(seed)
    return [r.standard_normal((B, T, h, hd), np.float32)
            for h in (H, KVH, KVH)]


def _attn_grads(jfn, tfn, q, k, v, seed):
    """Values and q/k/v gradients of a random projection of the output."""
    ct = np.random.default_rng(seed).standard_normal(q.shape, np.float32)

    @jax.jit
    def jvjp(q, k, v, ct):
        out, back = jax.vjp(jfn, q, k, v)
        return out, back(ct)
    want, jgrads = jvjp(*(jnp.asarray(a) for a in (q, k, v, ct)))
    tq, tk, tv = (torch.from_numpy(a).requires_grad_() for a in (q, k, v))
    got = tfn(tq, tk, tv)
    got.backward(torch.from_numpy(ct))
    return (got, want), [(t.grad, g) for t, g in zip((tq, tk, tv), jgrads)]


@pytest.mark.parametrize("T,window", [(20, 0), (20, 6)])
def test_sdpa_and_grads_match_jax(T, window):
    q, k, v = _qkv(2, T, 4, 2, 16, seed=T + window)
    mask_j = jly.causal_mask(T, T, window=window)[None, None, None]
    mask_t = ly.causal_mask(T, T, window=window)
    (got, want), grads = _attn_grads(
        lambda a, b, c: jly._sdpa(a, b, c, mask_j, scale=0.25),
        lambda a, b, c: ly._sdpa(a, b, c, mask_t, scale=0.25), q, k, v, 3)
    _close(got, want)
    for g, w in grads:
        _close(g, w)


@pytest.mark.parametrize("T,S,block,window", [
    (64, 64, 16, 0),      # T = 4 blocks: JAX's blocked branch
    (64, 64, 16, 20),     # with a sliding window (skipped block pairs)
    (50, 50, 16, 0),      # ragged last blocks
    (24, 40, 16, 0),      # T < S: right-aligned, offset 16
])
def test_sdpa_blocked_and_grads_match_jax(T, S, block, window):
    r = np.random.default_rng(T + S)
    q = r.standard_normal((2, T, 4, 16), np.float32)
    k, v = (r.standard_normal((2, S, 2, 16), np.float32) for _ in range(2))
    (got, want), grads = _attn_grads(
        lambda a, b, c: jly.sdpa_blocked(a, b, c, scale=0.25, window=window,
                                         block=block),
        lambda a, b, c: ly.sdpa_blocked(a, b, c, scale=0.25, window=window,
                                        block=block), q, k, v, 4)
    _close(got, want)
    for g, w in grads:
        _close(g, w)


@pytest.mark.parametrize("T,attn_block,window", [
    (16, 1024, 0),       # T < 2 * attn_block: _sdpa
    (31, 16, 0),         # just below: still _sdpa
    (32, 16, 0),         # T == 2 * attn_block: sdpa_blocked
    (64, 16, 24),        # blocked with a window
])
def test_attention_fwd_train_picks_as_jax(T, attn_block, window,
                                          monkeypatch):
    jc, tc = _cfgs("qwen2.5-3b", attn_block=attn_block)
    jp = jax.tree_util.tree_map(lambda a: a + 0.01,
                                jly.init_attention(KEY, jc))
    x = np.random.default_rng(5).standard_normal((2, T, jc.d_model),
                                                 np.float32)
    pos = np.broadcast_to(np.arange(T), (2, T)).copy()
    taken = []
    for name in ("_sdpa", "sdpa_blocked"):
        real = getattr(ly, name)
        monkeypatch.setattr(ly, name, lambda *a, _r=real, _n=name, **k:
                            taken.append(_n) or _r(*a, **k))
    want, _ = jly.attention_fwd(jp, jc, jnp.asarray(x), jnp.asarray(pos),
                                window=window)
    got, _ = ly.attention_fwd(lm_params_from_jax(jp), tc, torch.from_numpy(x),
                              torch.from_numpy(pos), window=window,
                              train=True)
    _close(got, want)
    assert taken == ["sdpa_blocked" if T >= 2 * attn_block else "_sdpa"]
