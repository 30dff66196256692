"""The port's functional optimizers (``repro_torch.optim``) against the JAX
package's, fed the same parameters and the same five gradients made with
numpy.  Both keep float32 moments and do the same float32 arithmetic in the
same order, so the parameters agree to 1e-6 after five steps."""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro import optim as jopt
from repro_torch import optim

torch.set_num_threads(1)

SHAPES = {"conv.0.w": (4, 3, 3, 3), "conv.0.b": (4,), "head.w": (12, 5),
          "head.b": (5,)}


def _tree(seed, scale=1.0):
    r = np.random.default_rng(seed)
    return {k: (r.standard_normal(s) * scale).astype(np.float32)
            for k, s in SHAPES.items()}


def _run_both(make_jax, make_port, steps=5):
    p0 = _tree(0)
    grads = [_tree(10 + i, scale=0.1) for i in range(steps)]
    jo, to = make_jax(), make_port()
    jp = {k: jnp.asarray(v) for k, v in p0.items()}
    tp = {k: torch.from_numpy(v.copy()) for k, v in p0.items()}
    js, ts = jo.init(jp), to.init(tp)
    jupdate = jax.jit(jo.update)
    for g in grads:
        ju, js = jupdate({k: jnp.asarray(v) for k, v in g.items()}, js, jp)
        jp = jopt.apply_updates(jp, ju)
        tu, ts = to.update({k: torch.from_numpy(v) for k, v in g.items()},
                           ts, tp)
        tp = optim.apply_updates(tp, tu)
    return jp, tp, js, ts


def _assert_tree_close(tp, jp, tol=1e-6):
    assert set(tp) == set(jp)
    for k in jp:
        assert tp[k].dtype == torch.float32
        np.testing.assert_allclose(tp[k].numpy(), np.asarray(jp[k]),
                                   rtol=tol, atol=tol, err_msg=k)


@pytest.mark.parametrize("weight_decay", [0.0, 0.05])
def test_adamw_five_steps_match_jax(weight_decay):
    jp, tp, js, ts = _run_both(
        lambda: jopt.adamw(1e-2, weight_decay=weight_decay),
        lambda: optim.adamw(1e-2, weight_decay=weight_decay))
    _assert_tree_close(tp, jp)
    _assert_tree_close(ts.mu, js.mu)
    _assert_tree_close(ts.nu, js.nu)
    assert ts.count.dtype == torch.int32 and int(ts.count) == 5
    assert all(v.dtype == torch.float32 for v in ts.mu.values())


@pytest.mark.parametrize("momentum", [0.0, 0.9])
def test_sgd_five_steps_match_jax(momentum):
    jp, tp, js, ts = _run_both(lambda: jopt.sgd(0.1, momentum=momentum),
                               lambda: optim.sgd(0.1, momentum=momentum))
    _assert_tree_close(tp, jp)
    assert int(ts.count) == 5
    if momentum:
        _assert_tree_close(ts.momentum, js.momentum)
    else:
        assert ts.momentum is None


def test_fedprox_penalty_matches_jax():
    a, b = _tree(1), _tree(2)
    want = float(jopt.fedprox_penalty(
        {k: jnp.asarray(v) for k, v in a.items()},
        {k: jnp.asarray(v) for k, v in b.items()}, 0.01))
    got = float(optim.fedprox_penalty(
        {k: torch.from_numpy(v) for k, v in a.items()},
        {k: torch.from_numpy(v) for k, v in b.items()}, 0.01))
    np.testing.assert_allclose(got, want, rtol=1e-6)
