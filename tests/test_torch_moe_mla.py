"""The port's mixture-of-experts and multi-head latent attention against
the JAX package on the CPU: the two slot-major rankings (exactly),
``moe_fwd`` on the flat and the group-local dispatch, with tokens dropped
over capacity and at decode capacity, ``mla_fwd`` in both of JAX's
branches (expanded, and flash-MLA blocked from ``8 * attn_block``
positions), the absorbed ``mla_decode``, and the two registered models
that use them (deepseek-v2-236b: MLA and MoE with shared experts;
arctic-480b: GQA and MoE beside a dense residual MLP) at their smoke
sizes: the init tree, the param converter, forward, prefill and decode
against a full forward, and the loss with its aux.

Both packages get the same inputs: JAX's params carried over by
``lm_params_from_jax`` (the router stays float32), activations and tokens
from numpy seeds.  Layers are held at 1e-5 in float32, models at 2e-4
(``tests/test_models.py``'s tolerance) and at 3e-2 in bf16.
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
from repro.models import layers as jly
from repro.models import transformer as jtf
from repro_torch.configs import get_config
from repro_torch.convert import lm_params_from_jax, lm_params_to_jax
from repro_torch.launch import steps as st
from repro_torch.models import layers as ly
from repro_torch.models import transformer as tf

sys.path.insert(0, str(Path(__file__).resolve().parents[1]))
from chip_smoke import _grow  # noqa: E402  (grows a prefill's cache)

torch.set_num_threads(1)
KEY = jax.random.PRNGKey(0)
LAYER_TOL = 1e-5
TOL = 2e-4
MOE = ["deepseek-v2-236b", "arctic-480b"]


def _cfgs(arch, **over):
    over = {"dtype": "float32", "remat": False, **over}
    return (dataclasses.replace(jax_config(arch, smoke=True), **over),
            dataclasses.replace(get_config(arch, smoke=True), **over))


def _close(got, want, tol):
    np.testing.assert_allclose(got.detach().float().numpy(),
                               np.asarray(want, np.float32), rtol=tol,
                               atol=tol)


def _x(shape, seed):
    return np.random.default_rng(seed).standard_normal(shape, np.float32)


@functools.cache
def _jax_params(arch, dtype):
    """Params in the tree of JAX's ``init_lm`` of the smoke config in
    ``dtype`` (its keys, shapes and dtypes, the router float32) with the
    init's distributions, drawn by numpy (JAX's own init compiles for
    seconds): norm scales 1, the embedding 0.02 x normal, every matrix
    fan_in^-1/2 x normal, each value rounded to bf16 (so the float32 and
    the bf16 model hold the same weights).  Once a session: the capacity
    factor and ``attn_block`` change no param."""
    r = np.random.default_rng(11)

    def leaf(path, a):
        name = path[-1].key
        if name == "scale":
            v = np.ones(a.shape, np.float32)
        else:
            std = 0.02 if name == "embed" else a.shape[-2] ** -0.5
            v = r.standard_normal(a.shape, np.float32) * std
        return jnp.asarray(v).astype(jnp.bfloat16).astype(a.dtype)
    jc = _cfgs(arch, dtype=dtype)[0]
    return jax.tree_util.tree_map_with_path(
        leaf, jax.eval_shape(lambda: jtf.init_lm(KEY, jc)))


# ----------------------------------------------------------------- configs
@pytest.mark.parametrize("arch", MOE)
@pytest.mark.parametrize("smoke", [False, True])
def test_configs_are_the_jax_configs(arch, smoke):
    jc, tc = jax_config(arch, smoke=smoke), get_config(arch, smoke=smoke)
    assert dataclasses.asdict(jc) == dataclasses.asdict(tc)
    assert (tc.param_count(), tc.active_param_count()) == (
        jc.param_count(), jc.active_param_count())
    assert dataclasses.asdict(tc.as_student()) == dataclasses.asdict(
        jc.as_student())


# ---------------------------------------------------------------- rankings
@pytest.mark.parametrize("n,E,seed", [(12, 4, 0), (250, 160, 2), (7, 1, 3)])
def test_rankings_match_jax_exactly(n, E, seed):
    e = np.random.default_rng(seed).integers(0, E, n).astype(np.int32)
    want = np.asarray(jly._rank_in_expert_cumsum(jnp.asarray(e), E))
    assert np.array_equal(np.asarray(jly._rank_in_expert_sort(jnp.asarray(e),
                                                              E)), want)
    for fn in (ly._rank_in_expert_cumsum, ly._rank_in_expert_sort):
        got = fn(torch.from_numpy(e), E)
        assert np.array_equal(got.numpy(), want), fn.__name__


# --------------------------------------------------------------------- MoE
def _drops(probs_in, cfg, capacity):
    """Whether the top-k assignments of these router inputs overflow
    ``capacity`` in some expert (per group with ``moe_groups``)."""
    G = cfg.moe_groups
    idx = torch.topk(probs_in, cfg.num_experts_per_tok, dim=-1).indices
    per = idx.reshape(G, -1)
    c = capacity // G
    return any(int(torch.bincount(g, minlength=cfg.num_experts).max()) > c
               for g in per)


@pytest.mark.parametrize("arch,dispatch,groups,activation,decode", [
    ("deepseek-v2-236b", "sort", 1, "silu", False),     # shared experts
    ("deepseek-v2-236b", "sort", 1, "silu", True),
    ("arctic-480b", "cumsum", 1, "silu", False),        # the dense residual
    ("deepseek-v2-236b", "cumsum", 2, "silu", False),   # group-local
    ("deepseek-v2-236b", "cumsum", 2, "silu", True),
    ("arctic-480b", "sort", 2, "relu2", False),         # ungated experts
    ("arctic-480b", "sort", 1, "gelu", True),
])
def test_moe_fwd_matches_jax(arch, dispatch, groups, activation, decode):
    """Output and aux at 1e-5.  Prefill shapes (2 x 16 tokens) at capacity
    factor 1.0 (16 slots an expert, 8 a group) drop tokens (asserted);
    decode shapes (4 x 1) at capacity B drop none."""
    jc, tc = _cfgs(arch, moe_dispatch=dispatch, moe_groups=groups,
                   activation=activation, capacity_factor=1.0)
    jp = jly.init_moe(KEY, jc)
    tp = lm_params_from_jax(jp)
    assert tp["router"].dtype == torch.float32
    shape = (4, 1, jc.d_model) if decode else (2, 16, jc.d_model)
    x = _x(shape, 5)
    cap = shape[0] if decode else None
    want, jaux = jly.moe_fwd(jp, jc, jnp.asarray(x), capacity=cap)
    got, aux = ly.moe_fwd(tp, tc, torch.from_numpy(x), capacity=cap)
    _close(got, want, LAYER_TOL)
    _close(aux, jaux, LAYER_TOL)
    N = shape[0] * shape[1]
    used = cap or max(1, int(N * tc.num_experts_per_tok / tc.num_experts
                             * tc.capacity_factor))
    probs = torch.from_numpy(x.reshape(N, -1)) @ tp["router"]
    assert _drops(probs, tc, used) == (not decode)


def test_moe_dispatches_agree_without_drops():
    """At a capacity that drops nothing, flat and grouped dispatch and both
    rankings give one output."""
    _, tc = _cfgs("deepseek-v2-236b", capacity_factor=8.0)
    tp = lm_params_from_jax(jly.init_moe(KEY, _cfgs("deepseek-v2-236b")[0]))
    x = torch.from_numpy(_x((2, 8, tc.d_model), 6))
    outs = [ly.moe_fwd(tp, dataclasses.replace(tc, moe_groups=g), x,
                       dispatch=d)[0]
            for g in (1, 2) for d in ("sort", "cumsum")]
    for o in outs[1:]:
        torch.testing.assert_close(o, outs[0], rtol=1e-6, atol=1e-6)


# --------------------------------------------------------------------- MLA
@pytest.mark.parametrize("T,attn_block", [(12, 1024), (37, 4)])
def test_mla_fwd_matches_jax(T, attn_block):
    """The expanded form, and from T >= 8 * attn_block the blocked
    flash-MLA (with a ragged last block); the cache entries too."""
    jc, tc = _cfgs("deepseek-v2-236b", attn_block=attn_block)
    jp = jly.init_mla(KEY, jc)
    x = _x((2, T, jc.d_model), 7)
    pos = np.broadcast_to(np.arange(T), (2, T)).copy()
    want, (wc, wr) = jly.mla_fwd(jp, jc, jnp.asarray(x), jnp.asarray(pos))
    got, (gc, gr) = ly.mla_fwd(lm_params_from_jax(jp), tc,
                               torch.from_numpy(x), torch.from_numpy(pos))
    _close(got, want, LAYER_TOL)
    _close(gc, wc, LAYER_TOL)
    _close(gr, wr, LAYER_TOL)


def test_mla_sdpa_blocked_matches_jax_off_the_diagonal():
    """``mla_sdpa_blocked`` alone with fewer queries than keys (a
    right-aligned causal mask): every key block, none skipped early."""
    r = np.random.default_rng(8)
    B, T, S, H, nope, rd, rank, vd = 2, 6, 21, 3, 8, 4, 10, 5
    arrs = [r.standard_normal(s, np.float32) for s in
            ((B, T, H, nope), (B, T, H, rd), (B, S, rank), (B, S, rd),
             (rank, H, nope), (rank, H, vd))]
    want = jly.mla_sdpa_blocked(*map(jnp.asarray, arrs), scale=0.3, block=4)
    got = ly.mla_sdpa_blocked(*map(torch.from_numpy, arrs), scale=0.3,
                              block=4)
    _close(got, want, LAYER_TOL)


def test_mla_decode_matches_jax():
    """The absorbed decode at position 11 of a 16-slot latent cache: the
    output and the caches, written in place; a position past the cache
    raises."""
    jc, tc = _cfgs("deepseek-v2-236b")
    jp = jly.init_mla(KEY, jc)
    r = np.random.default_rng(9)
    x = r.standard_normal((2, 1, jc.d_model), np.float32)
    cc = r.standard_normal((2, 16, jc.kv_lora_rank), np.float32)
    ckr = r.standard_normal((2, 16, jc.qk_rope_dim), np.float32)
    want, (wc, wr) = jly.mla_decode(jp, jc, jnp.asarray(x), jnp.asarray(cc),
                                    jnp.asarray(ckr), 11)
    tc_c, tc_r = torch.from_numpy(cc.copy()), torch.from_numpy(ckr.copy())
    tp = lm_params_from_jax(jp)
    got, (gc, gr) = ly.mla_decode(tp, tc, torch.from_numpy(x), tc_c, tc_r, 11)
    _close(got, want, LAYER_TOL)
    _close(gc, wc, LAYER_TOL)
    _close(gr, wr, LAYER_TOL)
    assert gc is tc_c and gr is tc_r
    with pytest.raises(IndexError, match="grow the cache"):
        ly.mla_decode(tp, tc, torch.from_numpy(x), tc_c, tc_r, 16)


# ------------------------------------------------------------------ models
@pytest.mark.parametrize("arch", MOE)
def test_init_lm_has_the_jax_tree(arch):
    """Keys, shapes and dtypes of the JAX init (the router float32 in a
    bf16 model), its distributions, and the same weights from one seed
    twice."""
    jc, tc = _cfgs(arch, dtype="bfloat16")
    want = jax.eval_shape(lambda: jtf.init_lm(KEY, jc))
    p = tf.init_lm(5, tc, device="cpu")
    got = jax.tree_util.tree_map(lambda t: (tuple(t.shape), str(t.dtype)[6:]),
                                 p)
    assert got == jax.tree_util.tree_map(
        lambda a: (tuple(a.shape), str(a.dtype)), want)
    moe = p["layers"]["moe"]
    assert moe["router"].dtype == torch.float32
    w_in = moe["w_in"].float()
    assert abs(float(w_in.std()) * tc.d_model ** 0.5 - 1.0) < 0.02
    assert abs(float(p["embed"].float().std()) - 0.02) < 1e-3
    again = tf.init_lm(5, tc, device="cpu")
    for a, b in zip(jax.tree_util.tree_leaves(p),
                    jax.tree_util.tree_leaves(again)):
        assert torch.equal(a, b)


def test_dense_init_fills_piece_by_piece(monkeypatch):
    """With pieces cut to 7 elements the fill still gives fan_in^-1/2
    normals of the whole shape, and the same tensor from the same seed."""
    monkeypatch.setattr(ly, "DRAW_ELEMENTS", 7)
    a = ly.dense_init(torch.Generator().manual_seed(3), (3, 5, 40, 6),
                      torch.bfloat16)
    b = ly.dense_init(torch.Generator().manual_seed(3), (3, 5, 40, 6),
                      torch.bfloat16)
    assert a.dtype == torch.bfloat16 and a.shape == (3, 5, 40, 6)
    assert torch.equal(a, b)
    assert abs(float(a.float().std()) * 40 ** 0.5 - 1.0) < 0.05


@pytest.mark.parametrize("arch", MOE)
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_lm_param_round_trip_is_exact(arch, dtype):
    """The MoE and MLA trees both ways, bit for bit, on random values in
    the JAX init's tree (keys, shapes, dtypes: the router float32)."""
    import ml_dtypes
    jc, _ = _cfgs(arch, dtype=dtype)
    r = np.random.default_rng(4)
    jp = jax.tree_util.tree_map(
        lambda a: r.standard_normal(a.shape, np.float32).astype(
            ml_dtypes.bfloat16 if a.dtype == jnp.bfloat16 else a.dtype),
        jax.eval_shape(lambda: jtf.init_lm(KEY, jc)))
    tp = lm_params_from_jax(jp)
    assert tp["layers"]["moe"]["router"].dtype == torch.float32
    assert tp["layers"]["moe"]["w_in"].dtype == getattr(torch, dtype)
    back = lm_params_to_jax(tp)
    flat_j, tree_j = jax.tree_util.tree_flatten(jp)
    flat_b, tree_b = jax.tree_util.tree_flatten(back)
    assert tree_j == tree_b
    for a, b in zip(flat_j, flat_b):
        assert a.dtype == b.dtype and a.shape == b.shape
        assert np.array_equal(a.view(np.uint8), b.view(np.uint8))


def _models(arch, **over):
    jc, tc = _cfgs(arch, **over)
    jp = _jax_params(arch, jc.dtype)
    return jc, tc, jp, lm_params_from_jax(jp)


TOKS = np.random.default_rng(1).integers(0, 512, (2, 24), dtype=np.int32)


@functools.cache
def _jax_forward(arch, dtype):
    """JAX's forward (logits, aux) of TOKS at the smoke config in
    ``dtype``."""
    jc = _cfgs(arch, dtype=dtype)[0]
    return jtf.forward(_jax_params(arch, dtype), jc,
                       {"tokens": jnp.asarray(TOKS)})


@pytest.mark.parametrize("arch", MOE)
def test_forward_matches_jax(arch):
    """Float32: logits at 2e-4, the layers' summed aux at 1e-5."""
    jc, tc, jp, tp = _models(arch)
    want, jaux = _jax_forward(arch, "float32")
    got, aux = tf.forward(tp, tc, {"tokens": torch.from_numpy(TOKS)})
    assert got.shape == (2, 24, jc.vocab_size)
    assert float(jaux) > 0.0
    _close(got, want, TOL)
    _close(aux, jaux, LAYER_TOL)


@pytest.mark.parametrize("arch", MOE)
def test_forward_bf16_is_as_close_to_float32_as_jax_bf16(arch):
    """bf16: the port's logits and JAX's, each against JAX's float32
    forward of the same (bf16-valued) weights.  Both packages round at
    every bf16 op, but not at the same places (JAX's bf16 silu rounds
    exp, 1 + exp and the reciprocal each; torch rounds once), so the two
    bf16 runs differ by about their own rounding error: at these untied
    heads (logits about 0.8) that is up to 0.06, as it is for the dense
    glm4-9b, and an absolute 3e-2 would fail JAX's own bf16 run against
    its float32 one.  Held: the port's largest and mean gaps to float32
    within 1.25 times JAX's, and the aux within 3e-2 of JAX's bf16 aux."""
    _, tc, _, tp = _models(arch, dtype="bfloat16")
    want, jaux = _jax_forward(arch, "bfloat16")
    ref, _ = _jax_forward(arch, "float32")      # the same weights
    got, aux = tf.forward(tp, tc, {"tokens": torch.from_numpy(TOKS)})
    assert got.dtype == torch.bfloat16
    ref = np.asarray(ref, np.float32)
    port_gap = np.abs(got.float().numpy() - ref)
    jax_gap = np.abs(np.asarray(want, np.float32) - ref)
    assert port_gap.max() <= 1.25 * jax_gap.max(), (port_gap.max(),
                                                    jax_gap.max())
    assert port_gap.mean() <= 1.25 * jax_gap.mean(), (port_gap.mean(),
                                                      jax_gap.mean())
    _close(aux, jaux, 3e-2)


@pytest.mark.parametrize("arch", MOE)
def test_prefill_then_decode_matches_the_full_forward(arch):
    """Through the serving steps: prefill 12 tokens, grow the cache,
    decode 4, each step's logits against JAX's full forward of the 16
    tokens at capacity factor 8.0 (so the prefill drops nothing, as
    decode never does); the cache against JAX's prefill."""
    jc, tc, jp, tp = _models(arch, capacity_factor=8.0)
    T, extra = 12, 4
    toks = np.random.default_rng(2).integers(0, jc.vocab_size,
                                             (2, T + extra), dtype=np.int32)
    full, _ = jtf.forward(jp, jc, {"tokens": jnp.asarray(toks)})
    _, jcache = jtf.prefill(jp, jc, {"tokens": jnp.asarray(toks[:, :T])})
    last, cache = st.make_prefill_step(tc)(
        tp, {"tokens": torch.from_numpy(toks[:, :T])})
    assert set(cache) == set(jcache)
    for k in cache:
        _close(cache[k], jcache[k], TOL)
    _close(last, full[:, T - 1], TOL)
    cache = _grow(cache, extra)
    decode = st.make_decode_step(tc)
    for t in range(T, T + extra):
        got, cache = decode(tp, cache, torch.from_numpy(toks[:, t:t + 1]), t)
        _close(got, full[:, t], TOL)


def test_mla_init_cache_layout():
    jc, tc = _cfgs("deepseek-v2-236b")
    want = jax.eval_shape(lambda: jtf.init_cache(jc, 3, 40))
    got = tf.init_cache(tc, 3, 40, device="cpu")
    assert {k: tuple(v.shape) for k, v in got.items()} == {
        k: tuple(v.shape) for k, v in want.items()}
    assert not bool(got["c_kv"].any())


def test_lm_loss_with_aux_and_remat_matches_jax():
    """deepseek-v2-236b's ``lm_loss`` (ce + the layers' summed aux) with
    each layer under ``torch.utils.checkpoint``, and its gradient in the
    router, the experts and the MLA output projection at 1e-5 of the
    largest (``tests/test_torch_lm_train.py`` holds both models' loss)."""
    jc, tc = _cfgs("deepseek-v2-236b", remat=True)
    jp = _jax_params("deepseek-v2-236b", "float32")
    r = np.random.default_rng(3)
    toks = r.integers(0, jc.vocab_size, (2, 17), dtype=np.int32)
    b = {"tokens": toks[:, :-1].copy(), "labels": toks[:, 1:].copy()}
    b["labels"][0, 2] = -1
    (want, jmet), jg = jax.jit(jax.value_and_grad(
        lambda p, x: jtf.lm_loss(p, jc, x), has_aux=True))(
            jp, {k: jnp.asarray(v) for k, v in b.items()})
    tp = lm_params_from_jax(jp)
    leaves = {"router": tp["layers"]["moe"]["router"],
              "w_in": tp["layers"]["moe"]["w_in"],
              "wo": tp["layers"]["attn"]["wo"]}
    for t in leaves.values():
        t.requires_grad_(True)
    got, met = tf.lm_loss(tp, tc, {k: torch.from_numpy(v)
                                   for k, v in b.items()})
    _close(got, want, TOL)
    _close(met["aux"], jmet["aux"], 1e-5)
    assert float(met["aux"].detach()) > 0.0
    got.backward()
    jl = {"router": jg["layers"]["moe"]["router"],
          "w_in": jg["layers"]["moe"]["w_in"],
          "wo": jg["layers"]["attn"]["wo"]}
    for k, t in leaves.items():
        w = np.asarray(jl[k])
        np.testing.assert_allclose(t.grad.numpy(), w, rtol=0,
                                   atol=1e-5 * float(np.abs(w).max()),
                                   err_msg=k)


def test_train_step_runs_a_moe_model():
    """``make_train_step`` on arctic-480b's smoke config: the step's loss
    is ``lm_loss`` (ce + aux) at the params it started from, and the
    router and the experts move."""
    _, tc = _cfgs("arctic-480b")
    p = tf.init_lm(3, tc, device="cpu")
    toks = torch.from_numpy(TOKS[:, :17].astype(np.int64))
    b = {"tokens": toks[:, :-1], "labels": toks[:, 1:]}
    with torch.no_grad():
        want, _ = tf.lm_loss(p, tc, b)
    before = {k: p["layers"]["moe"][k].clone() for k in ("router", "w_in")}
    step, opt = st.make_train_step(tc, lr=1e-3)
    _, _, loss = step(p, opt.init(p), b)
    assert float(loss) == pytest.approx(float(want), rel=1e-6)
    for k, w in before.items():
        assert not torch.equal(p["layers"]["moe"][k], w), k
