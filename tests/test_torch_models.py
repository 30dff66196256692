"""The port's CNNs (``repro_torch.models.cnn``) against the JAX package's,
from the same JAX init params converted with ``repro_torch.convert``.
Logits agree to 1e-5 (float32 convolutions summed in another order) and
CE gradients to 1e-4 relative to the largest gradient of the leaf; the
convert round trip is bit-identical (transposes only)."""
import functools

import jax
import numpy as np
import pytest
import torch

from repro.core.distill import softmax_cross_entropy as jax_ce
from repro.models import cnn as jcnn
from repro.optim import adamw as jax_adamw
from repro.optim.optimizers import AdamState as JaxAdamState
from repro_torch import convert
from repro_torch.core.distill import softmax_cross_entropy
from repro_torch.models.cnn import HarCNN, MnistCNN, make_model

torch.set_num_threads(1)

CASES = [("mnist", False), ("mnist", True), ("har", False), ("har", True)]


def _inputs(dataset, n=6, seed=0):
    r = np.random.default_rng(seed)
    if dataset == "mnist":
        x = r.random((n, 28, 28, 1)).astype(np.float32)
        ncls = 10
    else:
        x = r.standard_normal((n, 561, 1)).astype(np.float32)
        ncls = 6
    y = r.integers(0, ncls, n).astype(np.int32)
    y[0] = -1                                    # a padding example
    return x, y


@functools.cache
def _jax_params(dataset, student, seed=7):
    init, _ = jcnn.make_model(dataset, student=student)
    return jax.tree_util.tree_map(np.asarray, init(jax.random.PRNGKey(seed)))


@pytest.mark.parametrize("dataset,student", CASES)
def test_logits_and_ce_grads_match_jax(dataset, student):
    jp = _jax_params(dataset, student)
    _, jfwd = jcnn.make_model(dataset, student=student)
    _, tfwd = make_model(dataset, student=student)
    x, y = _inputs(dataset)
    p = convert.params_from_jax(jp)
    want = np.asarray(jax.jit(lambda q: jfwd(q, x, train=False))(jp))
    got = tfwd(p, torch.from_numpy(x), train=False).detach().numpy()
    np.testing.assert_allclose(got, want, rtol=1e-5, atol=1e-5)

    jg = jax.jit(jax.grad(lambda q: jax_ce(jfwd(q, x, train=False), y)))(jp)
    pg = {k: v.clone().requires_grad_(True) for k, v in p.items()}
    loss = softmax_cross_entropy(tfwd(pg, torch.from_numpy(x)),
                                 torch.from_numpy(y))
    grads = dict(zip(pg, torch.autograd.grad(loss, list(pg.values()))))
    got_g = dict(convert._flatten(convert.params_to_jax(grads)))
    for k, g in convert._flatten(jg):
        scale = max(float(np.abs(g).max()), 1e-12)
        np.testing.assert_allclose(got_g[k], g, rtol=1e-4, atol=1e-4 * scale,
                                   err_msg=k)


@pytest.mark.parametrize("dataset,student", CASES)
def test_state_dict_keys_mirror_jax_paths(dataset, student):
    module = (MnistCNN if dataset == "mnist" else HarCNN)(student=student)
    p = convert.params_from_jax(_jax_params(dataset, student))
    assert sorted(module.state_dict()) == sorted(p)
    assert all(module.state_dict()[k].shape == v.shape for k, v in p.items())


@pytest.mark.parametrize("dataset,student", CASES)
def test_convert_round_trip_is_bit_identical(dataset, student):
    jp = _jax_params(dataset, student)
    back = convert.params_to_jax(convert.params_from_jax(jp))
    assert jax.tree_util.tree_structure(back) == \
        jax.tree_util.tree_structure(jp)
    for (ka, a), (kb, b) in zip(convert._flatten(jp), convert._flatten(back)):
        assert ka == kb and a.dtype == b.dtype and np.array_equal(a, b), ka

    # Adam state after one step: moments convert like params, count int32
    opt = jax_adamw(1e-3)
    g = jax.tree_util.tree_map(lambda a: np.ones_like(a) * 0.5, jp)
    _, st = jax.jit(opt.update)(g, opt.init(jp), jp)
    port = convert.adam_from_jax(st)
    assert port.count.dtype == torch.int32 and int(port.count) == 1
    back = JaxAdamState(*convert.adam_to_jax(port))
    for a, b in zip(jax.tree_util.tree_leaves(st),
                    jax.tree_util.tree_leaves(back)):
        assert np.array_equal(np.asarray(a), np.asarray(b))


def test_init_is_seeded_and_device_independent():
    init, _ = make_model("mnist", student=True)
    a, b = init(3), init(3)
    assert all(torch.equal(a[k], b[k]) for k in a)
    assert not torch.equal(a["conv.0.w"], init(4)["conv.0.w"])
    assert float(a["head.b"].abs().sum()) == 0.0
