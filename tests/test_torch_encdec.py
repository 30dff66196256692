"""The port's audio encoder-decoder (``models/encdec.py``, seamless-m4t-
large-v2 at smoke size) against the JAX package on the CPU: the config,
the init tree and the param converter, ``encode``, ``forward``, the
serving steps (``make_prefill_step``'s logits and encoder memory, then
``make_decode_step`` over a decode cache from ``encdec.init_cache``,
against the full forward), ``lm_loss``, one ``make_train_step``, one
default-path ``make_fedsikd_distill_step``, and the launcher's ``lm`` mode
writing an ``lm.npz`` that the JAX package restores.

Both packages get the same inputs: JAX's params carried over by
``lm_params_from_jax`` (drawn by the port's init and rounded to bf16
values, so the float32 and bf16 runs share them; JAX's own init compiles
for seconds), frames and tokens from numpy seeds.  Float32 is held at
1e-5 relative and of the largest value, bf16 as close to JAX's float32
forward as JAX's own bf16 run is (the untied head's rule), decode against
the forward at 2e-4 (``tests/test_models.py``), the steps' losses at 1e-5
and their params and first moments at 1e-4 in each leaf's Frobenius norm
(``test_torch_lm_train.held_after_steps``, which says why).
"""
import dataclasses
import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro import checkpoint as jax_ckpt
from repro.configs import get_config as jax_config
from repro.launch import steps as jst
from repro.models import encdec as jed
from repro_torch.configs import get_config
from repro_torch.convert import (lm_adam_from_jax, lm_params_from_jax,
                                 lm_params_to_jax)
from repro_torch.launch import steps as st
from repro_torch.launch import train
from repro_torch.models import encdec as ed
from repro_torch.tree import flatten
from test_torch_lm_train import held_after_steps

torch.set_num_threads(1)
ARCH = "seamless-m4t-large-v2"
KEY = jax.random.PRNGKey(0)
TOL = 1e-5
DECODE_TOL = 2e-4
LR = 1e-4                  # the step builders' default, in both packages
F_ = 10                    # encoder frames
T = 12                     # decoder tokens


def _cfgs(**over):
    over = {"dtype": "float32", "remat": False, **over}
    return (dataclasses.replace(jax_config(ARCH, smoke=True), **over),
            dataclasses.replace(get_config(ARCH, smoke=True), **over))


def _close(got, want, tol=TOL):
    np.testing.assert_allclose(got.detach().float().numpy(),
                               np.asarray(want, np.float32), rtol=tol,
                               atol=tol)


def _close_scaled(got, want, tol=TOL):
    """Within ``tol`` relative and ``tol`` of the largest |want|."""
    want = np.asarray(want, np.float32)
    np.testing.assert_allclose(got.detach().float().numpy(), want, rtol=tol,
                               atol=tol * float(np.abs(want).max()))


def _shapes(tree):
    return jax.tree_util.tree_map(
        lambda a: (tuple(a.shape), str(a.dtype).replace("torch.", "")), tree)


@functools.lru_cache(maxsize=None)
def _jax_params(dtype, seed=0):
    """The port's init at ``seed`` rounded to bf16 values, in ``dtype``, as
    the JAX side's tree."""
    _, tc = _cfgs(dtype="bfloat16")
    tree = lm_params_to_jax(ed.init_encdec(seed, tc, device="cpu"))
    if dtype == "float32":
        tree = jax.tree_util.tree_map(lambda a: a.astype(np.float32), tree)
    return jax.tree_util.tree_map(jnp.asarray, tree)


def _models(**over):
    jc, tc = _cfgs(**over)
    jp = _jax_params(jc.dtype)
    return jc, tc, jp, lm_params_from_jax(jp)


def _batch(lead, seed):
    """Frames, tokens and next-token labels (two ignored), as numpy;
    ``lead`` the leading axes, e.g. (B,) or (D, B)."""
    r = np.random.default_rng(seed)
    seq = r.integers(0, 512, (*lead, T + 1), dtype=np.int32)
    b = {"frames": r.standard_normal((*lead, F_, 256), np.float32),
         "tokens": seq[..., :-1].copy(), "labels": seq[..., 1:].copy()}
    b["labels"].reshape(-1, T)[0, 3] = -1
    b["labels"].reshape(-1, T)[-1, -1] = -1
    return b


BATCH = _batch((2,), 1)


def _jax(b):
    return {k: jnp.asarray(v) for k, v in b.items()}


def _torch(b):
    return {k: torch.from_numpy(v) for k, v in b.items()}


@functools.lru_cache(maxsize=None)
def _jax_logits(dtype):
    jc, _, jp, _ = _models(dtype=dtype)
    return np.asarray(jax.jit(lambda p, b: jed.forward(p, jc, b)[0])(
        jp, _jax(BATCH)), np.float32)


# ------------------------------------------------------------ the model
@pytest.mark.parametrize("smoke", [False, True])
def test_config_is_the_jax_config(smoke):
    jc, tc = jax_config(ARCH, smoke=smoke), get_config(ARCH, smoke=smoke)
    assert dataclasses.asdict(jc) == dataclasses.asdict(tc)
    assert (tc.hd, tc.param_count()) == (jc.hd, jc.param_count())
    assert dataclasses.asdict(tc.as_student()) == dataclasses.asdict(
        jc.as_student())


def test_init_tree_and_converter_match_jax():
    """bf16: the keys, shapes and dtypes of JAX's ``eval_shape`` of
    ``init_encdec`` (encoder and decoder stacked on their layers); the
    converter carries the tree both ways bit for bit."""
    jc, tc = _cfgs(dtype="bfloat16")
    got = ed.init_encdec(3, tc, device="cpu")
    assert _shapes(got) == _shapes(jax.eval_shape(
        lambda: jed.init_encdec(KEY, jc)))
    assert abs(float(got["embed"].float().std()) - 0.02) < 1e-3
    jp = jax.tree_util.tree_map(np.asarray, _jax_params("bfloat16"))
    back = lm_params_to_jax(lm_params_from_jax(jp))
    flat_j, tree_j = jax.tree_util.tree_flatten(jp)
    flat_b, tree_b = jax.tree_util.tree_flatten(back)
    assert tree_j == tree_b
    for a, b in zip(flat_j, flat_b):
        assert a.dtype == b.dtype and a.shape == b.shape
        assert np.array_equal(a.view(np.uint8), b.view(np.uint8))


def test_encode_matches_jax():
    jc, tc, jp, tp = _models()
    want = jax.jit(lambda p, f: jed.encode(p, jc, f))(
        jp, jnp.asarray(BATCH["frames"]))
    got = ed.encode(tp, tc, torch.from_numpy(BATCH["frames"]))
    assert got.shape == (2, F_, 256)
    _close_scaled(got, want)


def test_forward_matches_jax():
    """float32 at 1e-5; bf16 as close to JAX's float32 forward of the same
    weights as JAX's bf16 run is (1.25 times its largest and mean gap)."""
    _, tc, _, tp = _models()
    ref = _jax_logits("float32")
    got, aux = ed.forward(tp, tc, _torch(BATCH))
    assert got.shape == (2, T, 512) and float(aux) == 0.0
    _close_scaled(got, ref)
    _, tc, _, tp = _models(dtype="bfloat16")
    got, _ = ed.forward(tp, tc, _torch(BATCH))
    assert got.dtype == torch.bfloat16
    port_gap = np.abs(got.float().numpy() - ref)
    jax_gap = np.abs(_jax_logits("bfloat16") - ref)
    assert port_gap.max() <= 1.25 * jax_gap.max(), (port_gap.max(),
                                                    jax_gap.max())
    assert port_gap.mean() <= 1.25 * jax_gap.mean(), (port_gap.mean(),
                                                      jax_gap.mean())


def test_prefill_step_matches_jax():
    """``make_prefill_step``: the last token's logits and the encoder
    memory, against JAX's step."""
    jc, tc, jp, tp = _models()
    want_l, want_m = jax.jit(jst.make_prefill_step(jc))(jp, _jax(BATCH))
    got_l, got_m = st.make_prefill_step(tc)(tp, _torch(BATCH))
    assert got_l.shape == (2, 512) and got_m.shape == (2, F_, 256)
    _close_scaled(got_l, want_l)
    _close_scaled(got_m, want_m)


def test_decode_matches_the_full_forward():
    """The prefill step's memory in a cache from ``init_cache`` (JAX's
    layout), then every token through ``make_decode_step`` at positions
    0..T-1, as ``tests/test_models.py`` does: each step's logits against
    JAX's full forward, at 2e-4; the self-attention caches written in
    place."""
    jc, tc, _, tp = _models()
    _, memory = st.make_prefill_step(tc)(tp, _torch(BATCH))
    cache = ed.init_cache(tc, 2, T, F_, device="cpu")
    assert _shapes(cache) == _shapes(jax.eval_shape(
        lambda: jed.init_cache(jc, 2, T, F_)))
    cache["memory"] = memory
    decode = st.make_decode_step(tc)
    full = _jax_logits("float32")
    for t in range(T):
        logits, same = decode(tp, cache,
                              torch.from_numpy(BATCH["tokens"][:, t:t + 1]),
                              t)
        assert same is cache and logits.shape == (2, 512)
        _close(logits, full[:, t], DECODE_TOL)
    assert bool(cache["k"][:, :, T - 1].any())


def test_lm_loss_matches_jax():
    """The loss and its ce, through the training forward with ``remat``."""
    jc, tc, jp, tp = _models(remat=True)
    want, jaux = jax.jit(lambda p, b: jed.lm_loss(p, jc, b))(jp, _jax(BATCH))
    got, aux = ed.lm_loss(tp, tc, _torch(BATCH))
    assert aux.keys() == jaux.keys() == {"ce"}
    _close(got, want)
    _close(aux["ce"], jaux["ce"])


# ------------------------------------------------------------ the steps
def test_train_step_matches_jax():
    """One ``make_train_step`` (remat, accum 2) in both packages: the loss,
    then every leaf's first moment (0.1 of its gradient) and param."""
    jc, tc, jp, tp = _models(remat=True)
    zero_init = {k for k, v in flatten(tp).items() if not v.any()}
    jstep, jopt = jst.make_train_step(jc, lr=LR, accum=2)
    tstep, topt = st.make_train_step(tc, lr=LR, accum=2)
    b = _batch((4,), 2)
    jp, jstate, jl = jax.jit(jstep)(jp, jopt.init(jp), _jax(b))
    out, tstate, tl = tstep(tp, topt.init(tp), _torch(b))
    assert out is tp and int(tstate.count) == 1
    _close(tl, jl)
    held_after_steps(flatten(tp), flatten(lm_params_from_jax(jp)),
                     tstate.mu, lm_adam_from_jax(jstate).mu, zero_init)


CLUSTERS = np.array([0, 1])


def test_distill_step_matches_jax():
    """One default-path ``make_fedsikd_distill_step``: the teacher's logits
    once, the D = 2 students' losses in one ``kd_distillation_loss_lanes``
    call, each replica's Adam step; the mean loss, then the students'
    moments and params, against JAX's step; the teacher is only read."""
    jc, tc, teacher, tt = _models(remat=True)
    jstep, _, jinit, jopt, _ = jst.make_fedsikd_distill_step(jc, CLUSTERS,
                                                            lr=LR)
    tstep, _, tinit, topt, s_cfg = st.make_fedsikd_distill_step(
        tc, CLUSTERS, lr=LR)
    assert s_cfg == tc.as_student()
    assert _shapes(tinit(0, device="cpu")) == _shapes(
        jax.eval_shape(lambda: jinit(KEY)))
    students = jax.tree_util.tree_map(
        lambda a, b: jnp.stack([a, b]), *(
            jax.tree_util.tree_map(jnp.asarray, lm_params_to_jax(
                ed.init_encdec(s, s_cfg, device="cpu"))) for s in (5, 6)))
    ts = lm_params_from_jax(students)
    zero_init = {k for k, v in flatten(ts).items() if not v.any()}
    before = {k: v.clone() for k, v in flatten(tt).items()}
    b = _batch((2, 2), 3)
    students, jstate, jl = jax.jit(jstep)(
        students, jax.vmap(jopt.init)(students), teacher, _jax(b))
    out, tstate, tl = tstep(ts, topt.init(ts), tt, _torch(b))
    assert out is ts and tstate.count.tolist() == [1, 1]
    _close(tl, jl)
    held_after_steps(flatten(ts), flatten(lm_params_from_jax(students)),
                     tstate.mu, lm_adam_from_jax(jstate).mu, zero_init)
    for k, v in flatten(tt).items():
        assert torch.equal(v, before[k]), k


def test_launcher_lm_mode_writes_what_the_jax_package_restores(tmp_path):
    """``lm --arch seamless-m4t-large-v2 --smoke --device cpu``: zero
    frames (B, max(seq // 4, 4), d), two finite steps, and an ``lm.npz``
    that JAX's ``ckpt.restore`` reads into ``init_encdec``'s tree."""
    ck = tmp_path / "lm"
    params, losses = train.main(
        ["lm", "--device", "cpu", "--arch", ARCH, "--smoke", "--steps", "2",
         "--batch", "2", "--seq", "16", "--log-every", "1", "--ckpt",
         str(ck)])
    assert len(losses) == 2 and all(np.isfinite(losses))
    assert jax_ckpt.load_meta(ck / "lm.npz")["step"] == 2
    jc = jax_config(ARCH, smoke=True)
    like = jax.eval_shape(lambda: jed.init_encdec(KEY, jc))
    back = jax_ckpt.restore(ck / "lm.npz", like)
    assert str(back["decoder"]["cross_attn"]["wq"].dtype) == "bfloat16"
    want = flatten(lm_params_from_jax(jax.tree_util.tree_map(np.asarray,
                                                             back)))
    for k, v in flatten(params).items():
        assert torch.equal(v, want[k]), k
