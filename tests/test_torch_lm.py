"""The port's serving path of the dense decoders and the VLM (every
registered architecture: qwen2.5-3b, glm4-9b, minitron-8b, nemotron-4-340b,
internvl2-2b with its stub prefix) against the JAX package on the
CPU: configs, layers (``rmsnorm``, ``apply_rope``, ``mlp_fwd``,
``attention_fwd`` in both of JAX's branches, ``attention_decode``), the
model (``forward``, ``prefill`` and a grown-cache ``decode_step``
continuation, the sliding-window cache), the serving steps, and the LM
param converter.

Both packages get the same inputs: the JAX model's params (``init_lm``),
carried over by ``lm_params_from_jax``, and tokens from numpy.  Float32
runs are held at 2e-4, the tolerance of ``tests/test_models.py``; the
bf16 run at 3e-2 (JAX rounds the softmax weights to bf16 before the value
product, the port's kernel keeps them in float32).
"""
import dataclasses
import functools
import sys
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_config as jax_config
from repro.launch import steps as jst
from repro.models import layers as jly
from repro.models import transformer as jtf
from repro_torch.configs import get_config
from repro_torch.convert import lm_params_from_jax, lm_params_to_jax
from repro_torch.launch import steps as st
from repro_torch.models import layers as ly
from repro_torch.models import transformer as tf

sys.path.insert(0, str(Path(__file__).resolve().parents[1]))
from chip_smoke import _grow  # noqa: E402  (grows a prefill's cache)

# every registered architecture: the dense decoders (nemotron-4-340b's
# smoke head_dim 96 runs on the CPU's plain attention) and the VLM
DENSE = ["qwen2.5-3b", "glm4-9b", "minitron-8b", "nemotron-4-340b",
         "internvl2-2b"]
KEY = jax.random.PRNGKey(0)
TOL = 2e-4


def _cfgs(arch, **over):
    """The JAX and the port's smoke config of ``arch``, float32 unless
    ``over`` says otherwise."""
    over = {"dtype": "float32", "remat": False, **over}
    return (dataclasses.replace(jax_config(arch, smoke=True), **over),
            dataclasses.replace(get_config(arch, smoke=True), **over))


def _close(got, want, tol=TOL):
    np.testing.assert_allclose(got.detach().float().numpy(),
                               np.asarray(want, np.float32), rtol=tol,
                               atol=tol)


def _prefixed(cfg, toks, seed=2):
    """The model batch of ``toks``: a VLM also gets its (B, P, d) stub
    prefix from numpy; returns (JAX batch, port batch)."""
    b = {"tokens": toks}
    if cfg.prefix_len:
        b["prefix"] = np.random.default_rng(seed).standard_normal(
            (toks.shape[0], cfg.prefix_len, cfg.d_model), np.float32)
    return ({k: jnp.asarray(v) for k, v in b.items()},
            {k: torch.from_numpy(np.ascontiguousarray(v))
             for k, v in b.items()})


def _tokens(cfg, B, T, seed=1):
    return np.random.default_rng(seed).integers(0, cfg.vocab_size, (B, T),
                                                dtype=np.int32)


# ----------------------------------------------------------------- configs
@pytest.mark.parametrize("arch", DENSE)
@pytest.mark.parametrize("smoke", [False, True])
def test_configs_are_the_jax_configs(arch, smoke):
    jc, tc = jax_config(arch, smoke=smoke), get_config(arch, smoke=smoke)
    assert dataclasses.asdict(jc) == dataclasses.asdict(tc)
    assert (tc.hd, tc.param_count()) == (jc.hd, jc.param_count())
    assert tc.as_student() == get_config(arch, smoke=smoke).as_student()
    assert dataclasses.asdict(tc.as_student()) == dataclasses.asdict(
        jc.as_student())


def test_unported_families_raise():
    """The families still to port (rwkv, ssm, hybrid, audio) raise naming
    their ROADMAP item; MoE and MLA run (``tests/test_torch_moe_mla.py``)."""
    with pytest.raises(NotImplementedError, match="Queue 1 item 10"):
        get_config("rwkv6-3b")
    _, cfg = _cfgs("qwen2.5-3b")
    for over in ({"arch_type": "ssm"}, {"arch_type": "hybrid"}):
        with pytest.raises(NotImplementedError, match="Queue 1 item 10"):
            tf.init_lm(0, dataclasses.replace(cfg, **over), device="cpu")
    with pytest.raises(NotImplementedError, match="Queue 1 item 10"):
        st.make_prefill_step(dataclasses.replace(cfg, arch_type="audio"))


@pytest.mark.parametrize("arch", DENSE)
def test_init_lm_has_the_jax_tree(arch):
    """Same keys, shapes and dtypes as the JAX init (layers stacked on L),
    and the JAX init's distributions: norm scales 1, biases 0, embed
    std 0.02, every matrix std fan_in^-1/2."""
    jc, tc = _cfgs(arch, dtype="bfloat16")
    want = jax.eval_shape(lambda: jtf.init_lm(KEY, jc))
    p = tf.init_lm(5, tc, device="cpu")
    got = jax.tree_util.tree_map(lambda t: (tuple(t.shape), str(t.dtype)[6:]),
                                 p)
    assert got == jax.tree_util.tree_map(
        lambda a: (tuple(a.shape), str(a.dtype)), want)
    lp = p["layers"]
    assert bool((lp["ln1"]["scale"] == 1).all())
    assert abs(float(p["embed"].float().std()) - 0.02) < 1e-3
    wq = lp["attn"]["wq"].float()
    assert abs(float(wq.std()) * tc.d_model ** 0.5 - 1.0) < 0.02


# ------------------------------------------------------------------ layers
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_rmsnorm(dtype):
    r = np.random.default_rng(0)
    x = r.standard_normal((2, 5, 64), np.float32) * 3
    scale = r.standard_normal(64, np.float32)
    jx, js = (jnp.asarray(a).astype(dtype) for a in (x, scale))
    tx, ts = (torch.from_numpy(a).to(getattr(torch, dtype)) for a in (x, scale))
    got = ly.rmsnorm({"scale": ts}, tx, 1e-6)
    assert got.dtype == tx.dtype
    _close(got, jly.rmsnorm({"scale": js}, jx, 1e-6),
           TOL if dtype == "float32" else 3e-2)


def test_apply_rope():
    r = np.random.default_rng(1)
    x = r.standard_normal((2, 12, 4, 64), np.float32)
    pos = np.broadcast_to(np.arange(12) * 7, (2, 12))
    want = jly.apply_rope(jnp.asarray(x), jnp.asarray(pos), 1e6)
    _close(ly.apply_rope(torch.from_numpy(x), torch.from_numpy(pos.copy()),
                         1e6), want, 1e-5)


@pytest.mark.parametrize("T,S,offset,window", [(5, 5, 0, 0), (3, 9, 6, 0),
                                                (8, 8, 0, 3), (4, 10, 2, 4)])
def test_causal_mask(T, S, offset, window):
    want = jly.causal_mask(T, S, offset=offset, window=window)
    got = ly.causal_mask(T, S, offset=offset, window=window)
    assert np.array_equal(got.numpy(), np.asarray(want))


@pytest.mark.parametrize("activation", ["silu", "relu2", "gelu"])
def test_mlp_fwd(activation):
    jc, tc = _cfgs("qwen2.5-3b", activation=activation)
    jp = jly.init_mlp(KEY, jc)
    x = np.random.default_rng(2).standard_normal((2, 6, jc.d_model),
                                                 np.float32)
    _close(ly.mlp_fwd(lm_params_from_jax(jp), tc, torch.from_numpy(x)),
           jly.mlp_fwd(jp, jc, jnp.asarray(x)))


@pytest.mark.parametrize("T,attn_block,window", [
    (16, 1024, 0),       # JAX's short branch: scores materialised
    (64, 16, 0),         # T >= 2 * attn_block: JAX's blocked scan
    (64, 16, 24),        # the blocked scan with a sliding window
    (20, 1024, 8),       # the short branch with a window
])
def test_attention_fwd_both_jax_branches(T, attn_block, window):
    jc, tc = _cfgs("qwen2.5-3b", attn_block=attn_block)
    jp = jly.init_attention(KEY, jc)
    jp = jax.tree_util.tree_map(lambda a: a + 0.01, jp)   # non-zero biases
    x = np.random.default_rng(3).standard_normal((2, T, jc.d_model),
                                                 np.float32)
    pos = np.broadcast_to(np.arange(T), (2, T)).copy()
    want, (wk, wv) = jly.attention_fwd(jp, jc, jnp.asarray(x),
                                       jnp.asarray(pos), window=window)
    got, (gk, gv) = ly.attention_fwd(lm_params_from_jax(jp), tc,
                                     torch.from_numpy(x),
                                     torch.from_numpy(pos), window=window)
    _close(got, want)
    _close(gk, wk)
    _close(gv, wv)


@pytest.mark.parametrize("window", [0, 8])
def test_attention_decode(window):
    """One decode step at position 11 over a 16-slot cache (or an 8-slot
    rotating buffer): the output and the written cache."""
    jc, tc = _cfgs("glm4-9b")
    jp = jly.init_attention(KEY, jc)
    S = window or 16
    r = np.random.default_rng(4)
    x = r.standard_normal((2, 1, jc.d_model), np.float32)
    ck = r.standard_normal((2, S, jc.num_kv_heads, jc.hd), np.float32)
    cv = r.standard_normal((2, S, jc.num_kv_heads, jc.hd), np.float32)
    want, (wk, wv) = jly.attention_decode(jp, jc, jnp.asarray(x),
                                          jnp.asarray(ck), jnp.asarray(cv),
                                          11, window=window)
    tk, tv = torch.from_numpy(ck.copy()), torch.from_numpy(cv.copy())
    got, (gk, gv) = ly.attention_decode(lm_params_from_jax(jp), tc,
                                        torch.from_numpy(x), tk, tv, 11,
                                        window=window)
    _close(got, want)
    _close(gk, wk)
    _close(gv, wv)
    assert gk is tk                       # written in place
    with pytest.raises(IndexError, match="grow the cache"):
        ly.attention_decode(lm_params_from_jax(jp), tc, torch.from_numpy(x),
                            torch.zeros(2, 4, 2, 64), torch.zeros(2, 4, 2, 64),
                            4)


# ------------------------------------------------------------------- model
def _models(arch, **over):
    jc, tc = _cfgs(arch, **over)
    jp = jtf.init_lm(KEY, jc)
    return jc, tc, jp, lm_params_from_jax(jp)


@pytest.mark.parametrize("arch", DENSE)
def test_forward_matches_jax(arch):
    jc, tc, jp, tp = _models(arch)
    toks = _tokens(jc, 2, 24)
    jb, tb = _prefixed(jc, toks)
    want, _ = jtf.forward(jp, jc, jb)
    got, aux = tf.forward(tp, tc, tb)
    assert got.shape == (2, 24 + jc.prefix_len, jc.vocab_size)
    assert float(aux) == 0.0
    _close(got, want)
    hid, _ = tf.forward(tp, tc, tb, return_hidden=True)
    want_h, _ = jtf.forward(jp, jc, jb, return_hidden=True)
    _close(hid, want_h)


def test_forward_bf16_matches_jax():
    jc, tc, jp, tp = _models("qwen2.5-3b", dtype="bfloat16")
    assert tp["layers"]["attn"]["wq"].dtype == torch.bfloat16
    toks = _tokens(jc, 2, 24, seed=3)
    want, _ = jtf.forward(jp, jc, {"tokens": jnp.asarray(toks)})
    got, _ = tf.forward(tp, tc, {"tokens": torch.from_numpy(toks)})
    assert got.dtype == torch.bfloat16
    _close(got, want, 3e-2)


@pytest.mark.parametrize("arch", DENSE)
@pytest.mark.parametrize("entry", ["model", "steps"])
def test_prefill_then_decode_continuation(arch, entry):
    """Prefill 12 tokens, grow the cache, decode 4: each step's logits
    against the JAX package's same calls (``transformer.prefill`` /
    ``decode_step``, or ``make_prefill_step`` / ``make_decode_step``)."""
    jc, tc, jp, tp = _models(arch)
    T, extra = 12, 4
    P = jc.prefix_len                  # a VLM's cache starts with its prefix
    toks = _tokens(jc, 2, T + extra)
    if entry == "model":
        jpre, jdec = (functools.partial(jtf.prefill, jp, jc),
                      functools.partial(jtf.decode_step, jp, jc))
        tpre, tdec = (functools.partial(tf.prefill, tp, tc),
                      functools.partial(tf.decode_step, tp, tc))
    else:
        jpre, jdec = (functools.partial(jst.make_prefill_step(jc), jp),
                      functools.partial(jst.make_decode_step(jc), jp))
        tpre, tdec = (functools.partial(st.make_prefill_step(tc), tp),
                      functools.partial(st.make_decode_step(tc), tp))
    jb, tb = _prefixed(jc, toks[:, :T])
    want, jcache = jpre(jb)
    got, tcache = tpre(tb)
    _close(got, want)
    _close(tcache["k"], jcache["k"])
    assert tcache["k"].shape[2] == P + T
    jcache = jax.tree_util.tree_map(
        lambda a: jnp.pad(a, ((0, 0), (0, 0), (0, extra), (0, 0), (0, 0))),
        jcache)
    tcache = _grow(tcache, extra)
    jdec = jax.jit(jdec)
    for t in range(T, T + extra):
        want, jcache = jdec(jcache, jnp.asarray(toks[:, t:t + 1]), P + t)
        got, tcache = tdec(tcache, torch.from_numpy(toks[:, t:t + 1]), P + t)
        _close(got, want)
    _close(tcache["v"], jcache["v"])


def test_sliding_window_cache_and_rotating_decode():
    """A sliding window of 8: prefill of 16 keeps the last 8 keys
    (slot-aligned), and 5 decode steps wrap the rotating buffer."""
    jc, tc, jp, tp = _models("qwen2.5-3b", sliding_window=8)
    toks = _tokens(jc, 2, 21, seed=4)
    want, jcache = jtf.prefill(jp, jc, {"tokens": jnp.asarray(toks[:, :16])})
    got, tcache = tf.prefill(tp, tc, {"tokens": torch.from_numpy(toks[:, :16])})
    assert tuple(tcache["k"].shape[2:3]) == (8,)
    _close(got, want)
    _close(tcache["k"], jcache["k"])
    jdec = jax.jit(functools.partial(jtf.decode_step, jp, jc))
    for t in range(16, 21):
        want, jcache = jdec(jcache, jnp.asarray(toks[:, t:t + 1]), t)
        got, tcache = tf.decode_step(tp, tc, tcache,
                                     torch.from_numpy(toks[:, t:t + 1]), t)
        _close(got, want)
    short, _ = tf.prefill(tp, tc, {"tokens": torch.from_numpy(toks[:, :5])})
    want, _ = jtf.prefill(jp, jc, {"tokens": jnp.asarray(toks[:, :5])})
    _close(short, want)


def test_init_cache_layout():
    jc, tc = _cfgs("minitron-8b")
    want = jax.eval_shape(lambda: jtf.init_cache(jc, 3, 40))
    got = tf.init_cache(tc, 3, 40, device="cpu")
    assert {k: tuple(v.shape) for k, v in got.items()} == {
        k: tuple(v.shape) for k, v in want.items()}
    assert not bool(got["k"].any())


# --------------------------------------------------------------- converter
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_lm_param_round_trip_is_exact(dtype):
    jc, _ = _cfgs("qwen2.5-3b", dtype=dtype)
    jp = jax.tree_util.tree_map(np.asarray, jtf.init_lm(KEY, jc))
    tp = lm_params_from_jax(jp)
    wq = tp["layers"]["attn"]["wq"]
    assert tuple(wq.shape) == jp["layers"]["attn"]["wq"].shape   # (L, d, H*hd)
    assert wq.dtype == getattr(torch, dtype)
    back = lm_params_to_jax(tp)
    flat_j, tree_j = jax.tree_util.tree_flatten(jp)
    flat_b, tree_b = jax.tree_util.tree_flatten(back)
    assert tree_j == tree_b
    for a, b in zip(flat_j, flat_b):
        assert a.dtype == b.dtype and a.shape == b.shape
        assert np.array_equal(a.view(np.uint8), b.view(np.uint8))
    again = lm_params_from_jax(back)
    for a, b in zip(jax.tree_util.tree_leaves(tp),
                    jax.tree_util.tree_leaves(again)):
        assert torch.equal(a, b)
