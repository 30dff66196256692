"""The port's FedSiKD distillation step at LLM scale against the JAX
package on the CPU: ``averaging_matrices``, ``chunked_kd_loss`` (value and
gradients), ``make_fedsikd_distill_step`` on each of its three loss paths
(the default one through ``ops.kd_distillation_loss_lanes``, the teacher
inside the student's checkpointed closure, the vocab-chunked loss),
``sync``, ``init_students`` and the stacked Adam state's converter.

Both packages get the same teacher, students and Adam state (the JAX ones,
carried over by ``convert``) and the same numpy batches; smoke configs in
float32, D = 4 replicas in clusters (0, 0, 1, 1).  Losses are held at
1e-5; after two steps the students' first moments of every leaf and
their params of every leaf that starts non-zero at 1e-4 relative in the
Frobenius norm (``test_torch_lm_train.held_after_steps``, which says
why); ``sync`` at 1e-6.
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_config as jax_config
from repro.launch import steps as jst
from repro_torch.configs import get_config
from repro_torch.convert import (lm_adam_from_jax, lm_adam_to_jax,
                                 lm_params_from_jax)
from repro_torch.launch import steps as st
from repro_torch.tree import flatten
from test_torch_lm_train import held_after_steps, jax_init

KEY = jax.random.PRNGKey(0)
TOL = 1e-5
LR = 1e-4                  # the step builders' default, in both packages
CLUSTERS = np.array([0, 0, 1, 1])
D = len(CLUSTERS)
PATHS = {"default": {}, "teacher_in_grad": {"teacher_in_grad": True},
         "vocab_chunk": {"vocab_chunk": 200}}      # 512 % 200 != 0


def _cfgs(arch, **over):
    over = {"dtype": "float32", "remat": True, **over}
    return (dataclasses.replace(jax_config(arch, smoke=True), **over),
            dataclasses.replace(get_config(arch, smoke=True), **over))


def _close(got, want, tol=TOL):
    np.testing.assert_allclose(got.detach().float().numpy(),
                               np.asarray(want, np.float32), rtol=tol,
                               atol=tol)


@pytest.mark.parametrize("cluster_of", [[0, 0, 1, 1], [2, 0, 2, 2, 1],
                                        [0], [3, 3]])
def test_averaging_matrices_equal_jax(cluster_of):
    for got, want in zip(st.averaging_matrices(cluster_of),
                         jst.averaging_matrices(np.array(cluster_of))):
        assert got.dtype == torch.float32
        assert np.array_equal(got.numpy(), np.asarray(want))


@pytest.mark.parametrize("V,chunk", [(300, 64), (257, 256), (128, 128)])
def test_chunked_kd_loss_and_grads_match_jax(V, chunk):
    r = np.random.default_rng(V)
    T, d = 10, 16
    h_s, h_t = (r.standard_normal((T, d), np.float32) for _ in range(2))
    w_s, w_t = (r.standard_normal((d, V), np.float32) for _ in range(2))
    labels = r.integers(0, V, T).astype(np.int32)
    labels[[2, 7]] = -1
    kw = dict(tau=2.0, alpha=0.3, chunk=chunk)
    jl, (jg_h, jg_w) = jax.value_and_grad(
        lambda h, w: jst.chunked_kd_loss(h, w, jnp.asarray(h_t),
                                         jnp.asarray(w_t),
                                         jnp.asarray(labels), **kw),
        argnums=(0, 1))(jnp.asarray(h_s), jnp.asarray(w_s))
    th = torch.from_numpy(h_s).requires_grad_()
    tw = torch.from_numpy(w_s).requires_grad_()
    loss = st.chunked_kd_loss(th, tw, torch.from_numpy(h_t),
                              torch.from_numpy(w_t),
                              torch.from_numpy(labels), **kw)
    loss.backward()
    _close(loss, jl)
    _close(th.grad, jg_h)
    _close(tw.grad, jg_w)


def test_chunked_kd_loss_equals_the_materialised_kd_loss():
    """The chunked loss is the KD kernel's function: the same value as
    ``ops.kd_distillation_loss`` on the full logits."""
    from repro_torch.kernels import ops
    r = np.random.default_rng(3)
    h_s, h_t = (torch.from_numpy(r.standard_normal((12, 8), np.float32))
                for _ in range(2))
    w_s, w_t = (torch.from_numpy(r.standard_normal((8, 70), np.float32))
                for _ in range(2))
    y = torch.from_numpy(r.integers(-1, 70, 12))
    got = st.chunked_kd_loss(h_s, w_s, h_t, w_t, y, tau=1.5, alpha=0.4,
                             chunk=32)
    want = ops.kd_distillation_loss(h_s @ w_s, h_t @ w_t, y, 1.5, 0.4)
    _close(got, want)


def _batch(cfg, seed, b=2, T=12, drop_replica=None):
    r = np.random.default_rng(seed)
    toks = r.integers(0, cfg.vocab_size, (D, b, T + 1), dtype=np.int32)
    bt = {"tokens": toks[..., :-1].copy(), "labels": toks[..., 1:].copy()}
    bt["labels"][0, 0, 3] = -1
    if drop_replica is not None:         # a replica with no valid label
        bt["labels"][drop_replica] = -1
    if cfg.prefix_len:
        bt["prefix"] = r.standard_normal((D, b, cfg.prefix_len, cfg.d_model),
                                         np.float32)
    return bt


def _setup(arch, path):
    jc, tc = _cfgs(arch)
    jstep, jsync, jinit, jopt, _ = jst.make_fedsikd_distill_step(
        jc, CLUSTERS, lr=LR, **PATHS[path])
    tstep, tsync, _, topt, s_cfg = st.make_fedsikd_distill_step(
        tc, CLUSTERS, lr=LR, **PATHS[path])
    assert s_cfg == tc.as_student()
    teacher = jax_init(KEY, jc)
    students = jax.jit(jinit)(jax.random.fold_in(KEY, 1))
    jstate = jax.vmap(jopt.init)(students)
    return (jc, jax.jit(jstep), jsync, teacher, students, jstate,
            tstep, tsync, topt)


@pytest.mark.parametrize("arch,path", [
    *(("qwen2.5-3b", path) for path in PATHS),
    ("internvl2-2b", "default"),          # the prefix sliced off
])
def test_distill_step_matches_jax(arch, path):
    (jc, jstep, _, teacher, students, jstate, tstep, _,
     topt) = _setup(arch, path)
    tt = lm_params_from_jax(teacher)
    ts = lm_params_from_jax(students)
    zero_init = {k for k, v in flatten(ts).items() if not v.any()}
    tstate = topt.init(ts)
    assert tstate.count.tolist() == [0] * D
    teacher_before = {k: v.clone() for k, v in flatten(tt).items()}
    for i in range(2):
        bt = _batch(jc, 20 + i, drop_replica=1 if i else None)
        students, jstate, jl = jstep(students, jstate, teacher,
                                     {k: jnp.asarray(v) for k, v in
                                      bt.items()})
        out, tstate, tl = tstep(ts, tstate, tt,
                                {k: torch.from_numpy(v)
                                 for k, v in bt.items()})
        assert out is ts
        _close(tl, jl)
    assert tstate.count.tolist() == [2] * D
    # the moments through the stacked converter
    held_after_steps(flatten(ts), flatten(lm_params_from_jax(students)),
                     tstate.mu, lm_adam_from_jax(jstate).mu, zero_init)
    for k, v in flatten(tt).items():
        assert torch.equal(v, teacher_before[k]), k


def test_distill_loss_paths_agree():
    """The three paths give one loss on one state (the chunked loss is the
    materialised one in vocab chunks; the naive path recomputes the
    teacher)."""
    _, tc = _cfgs("qwen2.5-3b")
    bt = {k: torch.from_numpy(v) for k, v in _batch(tc, 5).items()}
    teacher = st.tf.init_lm(1, tc, device="cpu")
    losses = []
    for path in PATHS:
        step, _, init, opt, _ = st.make_fedsikd_distill_step(
            tc, CLUSTERS, **PATHS[path])
        students = init(2, device="cpu")
        _, _, loss = step(students, opt.init(students), teacher, bt)
        losses.append(float(loss))
    assert losses[1] == pytest.approx(losses[0], rel=TOL)
    assert losses[2] == pytest.approx(losses[0], rel=TOL)


def test_sync_matches_jax_and_equalises_replicas():
    (_, _, jsync, _, students, _, _, tsync, _) = _setup("qwen2.5-3b",
                                                        "default")
    ts = lm_params_from_jax(students)
    out = tsync(ts)
    assert out is ts
    want = flatten(lm_params_from_jax(jax.jit(jsync)(students)))
    for k, g in flatten(ts).items():
        _close(g, want[k], 1e-6)
        for d in range(1, D):
            assert torch.equal(g[d], g[0]), k      # equal rows of A_global


def test_init_students_has_the_jax_tree():
    jc, tc = _cfgs("qwen2.5-3b", dtype="bfloat16")
    _, _, jinit, jopt, _ = jst.make_fedsikd_distill_step(jc, CLUSTERS)
    _, _, init, opt, s_cfg = st.make_fedsikd_distill_step(tc, CLUSTERS)
    want = jax.eval_shape(lambda: jinit(KEY))
    got = init(0, device="cpu")
    shapes = jax.tree_util.tree_map(
        lambda t: (tuple(t.shape), str(t.dtype)[6:]), got)
    assert shapes == jax.tree_util.tree_map(
        lambda a: (tuple(a.shape), str(a.dtype)), want)
    assert got["layers"]["attn"]["wq"].shape[:2] == (D, s_cfg.num_layers)
    # replicas differ (one seed each), as JAX's split keys do
    assert not torch.equal(got["embed"][0], got["embed"][1])
    state = opt.init(got)
    jstate = jax.eval_shape(lambda: jax.vmap(jopt.init)(jinit(KEY)))
    assert tuple(state.count.shape) == jstate.count.shape == (D,)
    assert state.mu["embed"].shape == jstate.mu["embed"].shape


def test_lm_adam_converter_round_trip_is_exact():
    jc, _ = _cfgs("qwen2.5-3b", dtype="bfloat16")
    _, _, jinit, jopt, _ = jst.make_fedsikd_distill_step(jc, CLUSTERS)
    students = jax.jit(jinit)(KEY)
    jstate = jax.vmap(jopt.init)(students)
    jstate = jstate._replace(
        mu=jax.tree_util.tree_map(lambda a: a + 0.5, jstate.mu),
        count=jnp.arange(D, dtype=jnp.int32))
    jstate = jax.tree_util.tree_map(np.asarray, jstate)
    port = lm_adam_from_jax(jstate)
    assert "layers.attn.wq" in port.mu
    assert port.count.tolist() == list(range(D))
    back = lm_adam_to_jax(port)
    flat_j, tree_j = jax.tree_util.tree_flatten(tuple(jstate))
    flat_b, tree_b = jax.tree_util.tree_flatten(tuple(back))
    assert tree_j == tree_b
    for a, b in zip(flat_j, flat_b):
        assert a.dtype == b.dtype and np.array_equal(a, b)
