"""The port's LM train and distillation steps for the mixture-of-experts
and recurrent families against the JAX package on the CPU, at their smoke
sizes in float32.  This file holds the checks and runs them for
deepseek-v2-236b (MLA and MoE with shared experts) and arctic-480b (GQA and
MoE beside a dense MLP); ``test_torch_lm_steps_rwkv.py`` runs them for
rwkv6-3b and ``test_torch_lm_steps_hybrid.py`` for zamba2-1.2b (Mamba2 and
a shared attention block), each file under a minute on one core.

- ``make_train_step``: two steps at accum 1, and two at accum 2 with remat;
  the loss (the MoE models' with its load-balance aux), the params and the
  first moments held as ``tests/test_torch_lm_train.py`` holds the dense
  decoders (``held_after_steps``, which says why the Frobenius norm);
- ``make_fedsikd_distill_step`` on each loss path (default, teacher inside
  the student's closure, vocab-chunked), two steps then ``sync``, as
  ``tests/test_torch_lm_distill.py`` holds qwen2.5-3b; the teacher's bytes
  unchanged.  A MoE teacher runs one forward a replica, as JAX's ``vmap``
  over the replicas does: one forward of the merged batch would rank and
  cap the tokens of all replicas together (the loss then differs by about
  7e-5);
- the final hidden states (``forward(..., return_hidden=True)``), which the
  vocab-chunked path reads.

The JAX side's params are the port's init carried over by
``lm_params_to_jax`` (JAX's rwkv6 init alone compiles for about 11 s; its
MoE init for about 10 s), the students' too, stacked on the replica axis;
batches come from numpy seeds.  Losses at 1e-5, params and moments at 1e-4
relative per leaf, ``sync`` of the same students at 1e-6, hidden states at
1e-5 relative and of their largest value.  A MoE case that failed would
first be checked for equal top-k and capacity positions: a near-tie in the
router picks another expert, which is not a numerical drift.
"""
import dataclasses
import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_config as jax_config
from repro.launch import steps as jst
from repro.models import transformer as jtf
from repro_torch.configs import get_config
from repro_torch.convert import (lm_adam_from_jax, lm_params_from_jax,
                                 lm_params_to_jax)
from repro_torch.launch import steps as st
from repro_torch.models import transformer as tf
from repro_torch.tree import flatten
from test_torch_lm_train import held_after_steps

torch.set_num_threads(1)
TOL = 1e-5
SYNC_TOL = 1e-6
LR = 1e-4                  # the step builders' default, in both packages
CLUSTERS = np.array([0, 0, 1, 1])
D = len(CLUSTERS)
PATHS = {"default": {}, "teacher_in_grad": {"teacher_in_grad": True},
         "vocab_chunk": {"vocab_chunk": 200}}      # 512 % 200 != 0


def _cfgs(arch, **over):
    over = {"dtype": "float32", "remat": False, **over}
    return (dataclasses.replace(jax_config(arch, smoke=True), **over),
            dataclasses.replace(get_config(arch, smoke=True), **over))


def _close(got, want, tol=TOL):
    np.testing.assert_allclose(got.detach().float().numpy(),
                               np.asarray(want, np.float32), rtol=tol,
                               atol=tol)


def _to_jax(tree):
    return jax.tree_util.tree_map(jnp.asarray, lm_params_to_jax(tree))


@functools.cache
def _init(arch, seed):
    """The port's float32 init of the smoke config as JAX arrays (remat and
    the capacity factor change no param); each test takes its own copy."""
    return _to_jax(tf.init_lm(seed, _cfgs(arch)[1], device="cpu"))


def _batch(cfg, shape, seed):
    """Tokens and next-token labels of ``shape`` (..., T) with two labels
    ignored (-1), as numpy."""
    r = np.random.default_rng(seed)
    toks = r.integers(0, cfg.vocab_size, (*shape[:-1], shape[-1] + 1),
                      dtype=np.int32)
    b = {"tokens": toks[..., :-1].copy(), "labels": toks[..., 1:].copy()}
    b["labels"].reshape(-1, shape[-1])[0, 3] = -1
    b["labels"].reshape(-1, shape[-1])[-1, -1] = -1
    return b


def _zero_init(tree) -> set:
    return {k for k, v in flatten(tree).items() if not v.any()}


# ------------------------------------------------------------ the checks
def check_train_step(arch, accum, remat):
    """Two train steps in both packages from one init."""
    jc, tc = _cfgs(arch, remat=remat)
    jp = _init(arch, 0)
    tp = lm_params_from_jax(jp)
    zero_init = _zero_init(tp)
    jstep, jopt = jst.make_train_step(jc, lr=LR, accum=accum)
    tstep, topt = st.make_train_step(tc, lr=LR, accum=accum)
    jstate, tstate = jopt.init(jp), topt.init(tp)
    jstep = jax.jit(jstep)
    for i in range(2):
        b = _batch(jc, (4, 16), seed=10 + i)
        jp, jstate, jl = jstep(jp, jstate,
                               {k: jnp.asarray(v) for k, v in b.items()})
        out, tstate, tl = tstep(tp, tstate,
                                {k: torch.from_numpy(v) for k, v in b.items()})
        assert out is tp
        _close(tl, jl)
    assert int(tstate.count) == 2
    held_after_steps(flatten(tp), flatten(lm_params_from_jax(jp)),
                     tstate.mu, lm_adam_from_jax(jstate).mu, zero_init)


def check_distill_step(arch, path):
    """Two distillation steps on loss path ``path`` in both packages from
    one teacher and one set of students, then ``sync`` and the teacher."""
    jc, tc = _cfgs(arch, remat=True)
    jstep, jsync, _, jopt, _ = jst.make_fedsikd_distill_step(
        jc, CLUSTERS, lr=LR, **PATHS[path])
    tstep, tsync, init_students, topt, s_cfg = st.make_fedsikd_distill_step(
        tc, CLUSTERS, lr=LR, **PATHS[path])
    assert s_cfg == tc.as_student()
    teacher = _init(arch, 0)
    tt = lm_params_from_jax(teacher)
    ts = init_students(1, device="cpu")
    students = _to_jax(ts)
    zero_init = _zero_init(ts)
    jstate = jax.vmap(jopt.init)(students)
    tstate = topt.init(ts)
    teacher_before = {k: v.clone() for k, v in flatten(tt).items()}
    jstep = jax.jit(jstep)
    for i in range(2):
        bt = _batch(jc, (D, 2, 12), 20 + i)
        students, jstate, jl = jstep(students, jstate, teacher,
                                     {k: jnp.asarray(v) for k, v in
                                      bt.items()})
        out, tstate, tl = tstep(ts, tstate, tt,
                                {k: torch.from_numpy(v)
                                 for k, v in bt.items()})
        assert out is ts
        _close(tl, jl)
    assert tstate.count.tolist() == [2] * D
    held_after_steps(flatten(ts), flatten(lm_params_from_jax(students)),
                     tstate.mu, lm_adam_from_jax(jstate).mu, zero_init)
    # sync on the same students: the port's after the two steps
    want = flatten(lm_params_from_jax(jax.jit(jsync)(_to_jax(ts))))
    assert tsync(ts) is ts
    for k, g in flatten(ts).items():
        _close(g, want[k], SYNC_TOL)
        for d in range(1, D):
            assert torch.equal(g[d], g[0]), k      # equal rows of A_global
    for k, v in flatten(tt).items():
        assert torch.equal(v, teacher_before[k]), k


def check_hidden_states(arch):
    """``forward(..., return_hidden=True)``: the final normed hidden states
    the vocab-chunked distillation path reads, in both packages."""
    jc, tc = _cfgs(arch)
    jp = _init(arch, 0)
    toks = _batch(jc, (2, 24), 7)["tokens"]
    want, _ = jax.jit(lambda p, t: jtf.forward(
        p, jc, {"tokens": t}, return_hidden=True))(jp, jnp.asarray(toks))
    got, _ = tf.forward(lm_params_from_jax(jp), tc,
                        {"tokens": torch.from_numpy(toks)},
                        return_hidden=True)
    want = np.asarray(want, np.float32)
    assert got.shape == want.shape == (2, 24, tc.d_model)
    np.testing.assert_allclose(got.detach().numpy(), want, rtol=TOL,
                               atol=TOL * float(np.abs(want).max()))


# ------------------------------------------------------------- the tests
TRAIN_CASES = [(1, False), (2, True)]      # (accum, remat)
MOE = ["deepseek-v2-236b", "arctic-480b"]


@pytest.mark.parametrize("accum,remat", TRAIN_CASES)
@pytest.mark.parametrize("arch", MOE)
def test_train_step_matches_jax(arch, accum, remat):
    check_train_step(arch, accum, remat)


@pytest.mark.parametrize("path", list(PATHS))
@pytest.mark.parametrize("arch", MOE)
def test_distill_step_matches_jax(arch, path):
    check_distill_step(arch, path)


@pytest.mark.parametrize("arch", MOE)
def test_hidden_states_match_jax(arch):
    check_hidden_states(arch)
