"""The port's LM training path against the JAX package on the CPU:
``lm_loss`` for every registered architecture and its gradients,
``make_train_step`` with and without gradient accumulation and remat,
``make_optimizer``'s moment dtypes and the in-place AdamW step (the
training attention is in ``tests/test_torch_train_attention.py``).

Both packages get the same inputs: the JAX params carried over by
``lm_params_from_jax``, tokens and activations from numpy seeds.  Smoke
configs in float32.  Losses and attention are held at 1e-5; after two
train steps the first moments (which carry the gradients) of every leaf,
and the params of every leaf that starts non-zero, at 1e-4 relative in
the Frobenius norm of the leaf (``held_after_steps``), at the default
learning rate.  The max norm would not do: Adam's first steps move every
weight by about the learning rate whatever the gradient's size, so an
element whose gradient is within rounding of zero takes a step of either
sign in either package (a handful of elements, 2 lr apart; at lr 1e-3 two
such elements of a student's 524,288-element embedding already come to
1.4e-4 of its norm).  The moments carry no such step: a gradient within
rounding of zero stays within rounding of zero.  The biases start at zero, so
their params are Adam's updates alone, -lr g / (|g| + eps) in the first
step: where |g| nears eps (qwen's key bias ``bk``, whose gradient nearly
cancels in the softmax, sits at 1e-9) the value follows the rounding of
g, and the moments, not the values, hold them.
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_config as jax_config
from repro.launch import steps as jst
from repro.models import encdec as jed
from repro.models import transformer as jtf
from repro.optim import adamw as jax_adamw
from repro.optim import apply_updates as jax_apply_updates
from repro_torch.configs import get_config
from repro_torch.configs.base import PORTED
from repro_torch.convert import lm_adam_from_jax, lm_params_from_jax
from repro_torch.launch import steps as st
from repro_torch.models import transformer as tf
from repro_torch.optim import adamw, apply_updates
from repro_torch.optim import optimizers as optim_mod
from repro_torch.tree import flatten, unflatten

KEY = jax.random.PRNGKey(0)
TOL = 1e-5
PARAM_RTOL = 1e-4
LR = 1e-4                  # the step builders' default, in both packages


def _cfgs(arch, **over):
    over = {"dtype": "float32", "remat": False, **over}
    return (dataclasses.replace(jax_config(arch, smoke=True), **over),
            dataclasses.replace(get_config(arch, smoke=True), **over))


def jax_init(key, cfg):
    """``init_lm`` (``init_encdec`` for audio) jitted: the same params,
    compiled once for each model shape (the width, depth and dtype fields;
    eager it takes seconds a call)."""
    shape = dataclasses.replace(cfg, remat=False, attn_block=1024)
    if cfg.arch_type == "audio":
        return _jit_init_encdec(key, shape)
    return _jit_init(key, shape)


_jit_init = jax.jit(jtf.init_lm, static_argnums=1)
_jit_init_encdec = jax.jit(jed.init_encdec, static_argnums=1)


def _batch(cfg, B, T, seed):
    """Tokens, next-token labels with two ignored (-1), a VLM's prefix and
    an audio model's frames (B, max(T // 4, 4), d), as numpy."""
    r = np.random.default_rng(seed)
    toks = r.integers(0, cfg.vocab_size, (B, T + 1), dtype=np.int32)
    b = {"tokens": toks[:, :-1].copy(), "labels": toks[:, 1:].copy()}
    b["labels"][0, 3] = -1
    b["labels"][-1, -1] = -1
    if cfg.prefix_len:
        b["prefix"] = r.standard_normal((B, cfg.prefix_len, cfg.d_model),
                                        np.float32)
    if cfg.arch_type == "audio":
        b["frames"] = r.standard_normal((B, max(T // 4, 4), cfg.d_model),
                                        np.float32)
    return b


def _jax(b):
    return {k: jnp.asarray(v) for k, v in b.items()}


def _torch(b):
    return {k: torch.from_numpy(v) for k, v in b.items()}


def held_after_steps(got_p, want_p, got_mu, want_mu, zero_init):
    """Every leaf's first moment, and the params of every leaf not in
    ``zero_init``, within PARAM_RTOL relative in the Frobenius norm (flat
    dicts of tensors)."""
    assert got_p.keys() == want_p.keys() == got_mu.keys() == want_mu.keys()
    for what, got, want, keys in (
            ("mu", got_mu, want_mu, list(want_mu)),
            ("param", got_p, want_p, [k for k in want_p
                                      if k not in zero_init])):
        for k in keys:
            g, w = got[k].float(), want[k].float()
            rel = float((g - w).norm() / w.norm())
            assert rel <= PARAM_RTOL, (what, k, rel)


def _close(got, want, tol=TOL):
    np.testing.assert_allclose(got.detach().float().numpy(),
                               np.asarray(want, np.float32), rtol=tol,
                               atol=tol)


# -------------------------------------------------------------- lm_loss
@pytest.mark.parametrize("arch", PORTED)
def test_lm_loss_matches_jax(arch):
    """The loss, its ce and its aux: the MoE models' load-balance losses
    summed over the layers, exactly 0.0 for the other decoders; the audio
    encoder-decoder's loss (``encdec.lm_loss``, picked as JAX's steps pick
    it) has its ce alone."""
    jc, tc = _cfgs(arch)
    jp = jax_init(KEY, jc)
    b = _batch(jc, 2, 16, seed=1)
    jmod, mod = jst._loss_mod(jc), st._loss_mod(tc)
    want, jaux = jax.jit(lambda p, x: jmod.lm_loss(p, jc, x))(jp, _jax(b))
    got, aux = mod.lm_loss(lm_params_from_jax(jp), tc, _torch(b))
    assert aux.keys() == jaux.keys()
    _close(got, want)
    _close(aux["ce"], jaux["ce"])
    if tc.arch_type != "audio":
        _close(aux["aux"], jaux["aux"])
    if not tc.num_experts and tc.arch_type != "audio":
        assert float(aux["aux"]) == float(jaux["aux"]) == 0.0


@pytest.mark.parametrize("arch", ["qwen2.5-3b", "internvl2-2b"])
def test_lm_loss_grads_match_jax(arch):
    """Every leaf's gradient, the near-zero ``bk`` among them."""
    jc, tc = _cfgs(arch)
    jp = jax_init(KEY, jc)
    b = _batch(jc, 2, 16, seed=2)
    jg = jax.jit(jax.grad(lambda p, x: jtf.lm_loss(p, jc, x)[0]))(
        jp, _jax(b))
    flat = {k: v.requires_grad_() for k, v in
            flatten(lm_params_from_jax(jp)).items()}
    loss, _ = tf.lm_loss(unflatten(flat), tc, _torch(b))
    loss.backward()
    want = flatten(lm_params_from_jax(jg))
    for k, p in flat.items():
        scale = float(np.abs(want[k].numpy()).max())
        np.testing.assert_allclose(p.grad.numpy(), want[k].numpy(), rtol=0,
                                   atol=TOL * scale, err_msg=k)


# ----------------------------------------------------------- train step
def _train_both(arch, accum, remat, T, attn_block, steps=2):
    """Two train steps in both packages; holds them (``held_after_steps``)
    and returns the port's Adam state."""
    jc, tc = _cfgs(arch, remat=remat, attn_block=attn_block)
    jp = jax_init(KEY, jc)
    tp = lm_params_from_jax(jp)
    zero_init = {k for k, v in flatten(tp).items() if not v.any()}
    jstep, jopt = jst.make_train_step(jc, lr=LR, accum=accum)
    tstep, topt = st.make_train_step(tc, lr=LR, accum=accum)
    jstate, tstate = jopt.init(jp), topt.init(tp)
    jstep = jax.jit(jstep)
    for i in range(steps):
        b = _batch(jc, 4, T, seed=10 + i)
        jp, jstate, jl = jstep(jp, jstate, _jax(b))
        out, tstate, tl = tstep(tp, tstate, _torch(b))
        assert out is tp
        _close(tl, jl)
    held_after_steps(flatten(tp), flatten(lm_params_from_jax(jp)),
                     tstate.mu, lm_adam_from_jax(jstate).mu, zero_init)
    return tstate


@pytest.mark.parametrize("arch,accum,remat,T,attn_block", [
    ("qwen2.5-3b", 1, False, 24, 1024),    # _sdpa
    ("qwen2.5-3b", 2, True, 32, 8),        # remat, the blocked attention
    ("internvl2-2b", 2, False, 12, 1024),  # the prefix in every micro-batch
])
def test_train_step_matches_jax(arch, accum, remat, T, attn_block):
    tstate = _train_both(arch, accum, remat, T, attn_block)
    assert int(tstate.count) == 2


def test_accum_loss_is_the_mean_of_micro_losses():
    """With every label valid, the accum-2 loss of a batch is its accum-1
    loss (the same params, the same tokens)."""
    _, tc = _cfgs("glm4-9b")
    b = _torch(_batch(tc, 4, 12, seed=3))
    b["labels"] = b["tokens"].roll(-1, dims=1)
    losses = []
    for accum in (1, 2):
        p = tf.init_lm(7, tc, device="cpu")
        step, opt = st.make_train_step(tc, accum=accum)
        _, _, loss = step(p, opt.init(p), b)
        losses.append(float(loss))
    assert losses[1] == pytest.approx(losses[0], rel=1e-6)


def test_audio_chunked_distill_is_refused():
    """The distillation step's vocab-chunked path needs final hidden
    states, which the audio encoder-decoder's forward does not return: the
    port refuses the combination when the step is built; JAX builds the
    step and fails when it runs (``encdec.forward`` takes no
    ``return_hidden``).  The other audio paths build."""
    jc, tc = _cfgs("seamless-m4t-large-v2")
    with pytest.raises(ValueError, match="vocab_chunk needs the final "
                                         "hidden states"):
        st.make_fedsikd_distill_step(tc, [0, 0], vocab_chunk=128)
    jstep, _, jinit, jopt, _ = jst.make_fedsikd_distill_step(
        jc, np.array([0, 0]), vocab_chunk=128)
    students = jax.eval_shape(lambda: jinit(KEY))
    batch = {k: jax.ShapeDtypeStruct((2, *v.shape), v.dtype)
             for k, v in _batch(jc, 1, 8, seed=0).items()}
    with pytest.raises(TypeError, match="return_hidden"):
        jax.eval_shape(jstep, students, jax.eval_shape(
            jax.vmap(jopt.init), students),
            jax.eval_shape(lambda: jax_init(KEY, jc)), batch)
    for kw in ({}, {"teacher_in_grad": True}):
        st.make_fedsikd_distill_step(tc, [0, 0], **kw)


# ------------------------------------------------------------ optimizer
@pytest.mark.parametrize("arch,dtype", [("glm4-9b", torch.bfloat16),
                                        ("nemotron-4-340b", torch.bfloat16),
                                        ("qwen2.5-3b", torch.float32),
                                        ("minitron-8b", torch.float32)])
def test_make_optimizer_moment_dtypes(arch, dtype):
    """bf16 moments above 8e9 parameters, read from ``param_count()`` of
    the full config; nothing of the model is built."""
    cfg = get_config(arch)
    assert (cfg.param_count() > 8_000_000_000) == (dtype == torch.bfloat16)
    jdt = jst.make_optimizer(jax_config(arch)).init(
        {"w": jnp.zeros(3)}).mu["w"].dtype
    state = st.make_optimizer(cfg).init({"a": {"w": torch.zeros(3)}})
    assert list(state.mu) == ["a.w"]
    assert state.mu["a.w"].dtype == state.nu["a.w"].dtype == dtype
    assert str(jdt) == str(dtype)[6:]


@pytest.mark.parametrize("state_dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("param_dtype", [torch.float32, torch.bfloat16])
def test_inplace_adamw_is_update_then_apply_bit_for_bit(
        state_dtype, param_dtype, monkeypatch):
    """``update_`` against ``update`` + ``apply_updates`` over 3 steps,
    weight decay on, a leaf of several pieces (the piece size cut to 7),
    and one replica of a stack (views) updated in place."""
    monkeypatch.setattr(optim_mod, "INPLACE_PIECE", 7)
    opt = adamw(3e-3, weight_decay=0.1, state_dtype=state_dtype)
    r = np.random.default_rng(0)
    shapes = {"a": (5, 6), "b.c": (11,), "d": (2, 3, 4)}
    params = {k: torch.from_numpy(r.standard_normal(s, np.float32))
              .to(param_dtype) for k, s in shapes.items()}
    ref_p, ref_s = dict(params), opt.init(params)
    p_, s_ = {k: v.clone() for k, v in params.items()}, opt.init(params)
    for _ in range(3):
        g = {k: torch.from_numpy(r.standard_normal(s, np.float32))
             .to(param_dtype) for k, s in shapes.items()}
        upd, ref_s = opt.update(g, ref_s, ref_p)
        ref_p = apply_updates(ref_p, upd)
        out = opt.update_(g, s_, p_)
        assert out is s_
    for k in shapes:
        assert torch.equal(p_[k], ref_p[k]), k
        assert torch.equal(s_.mu[k], ref_s.mu[k])
        assert torch.equal(s_.nu[k], ref_s.nu[k])
    assert int(s_.count) == int(ref_s.count) == 3
    # one replica of a (2, ...) stack: the other replica stays untouched
    stack = {k: torch.stack([v, v + 1]) for k, v in params.items()}
    st_state = opt.init(stack)
    st_state = st_state._replace(count=torch.zeros(2, dtype=torch.int32))
    before = {k: v[0].clone() for k, v in stack.items()}
    from repro_torch.optim import AdamState
    g = {k: torch.ones_like(v[1]) for k, v in stack.items()}
    opt.update_(g, AdamState({k: m[1] for k, m in st_state.mu.items()},
                             {k: n[1] for k, n in st_state.nu.items()},
                             st_state.count[1]),
                {k: v[1] for k, v in stack.items()})
    one_p = {k: v + 1 for k, v in params.items()}
    want = apply_updates(one_p, opt.update(g, opt.init(one_p), one_p)[0])
    for k in shapes:
        assert torch.equal(stack[k][0], before[k])
        assert torch.equal(stack[k][1], want[k])
    assert st_state.count.tolist() == [0, 1]


def test_inplace_adamw_matches_jax():
    """The in-place step against the JAX AdamW on the same grads."""
    r = np.random.default_rng(1)
    p = {"w": r.standard_normal((4, 5), np.float32)}
    jopt, opt = jax_adamw(1e-2, weight_decay=0.01), adamw(1e-2,
                                                          weight_decay=0.01)
    jp = {"w": jnp.asarray(p["w"])}
    tp = {"w": torch.from_numpy(p["w"].copy())}
    js, ts = jopt.init(jp), opt.init(tp)
    for _ in range(3):
        g = r.standard_normal((4, 5), np.float32)
        u, js = jopt.update({"w": jnp.asarray(g)}, js, jp)
        jp = jax_apply_updates(jp, u)
        opt.update_({"w": torch.from_numpy(g)}, ts, tp)
    _close(tp["w"], jp["w"], 1e-6)
