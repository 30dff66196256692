"""The port's CUDA kernels on the card, each against its plain PyTorch
version on the same inputs.  These need an NVIDIA GPU and ``nvcc`` (the
first test builds the kernels); without a card they skip.  On a machine with
one, run them with

    PYTHONPATH=src python -m pytest -m cuda tests/test_torch_cuda.py

Tolerances are those of ``chip_smoke.py``: 2e-5 on the f32 KD loss and
stats, 1e-5 on its gradient, 5e-2 in bf16, 1e-5 on the f32 merge and 2e-2
on a bf16 leaf.  This file imports no JAX, so it runs where JAX is absent.
"""
import numpy as np
import pytest
import torch

from repro_torch.kernels import fused_merge as fm
from repro_torch.kernels import kd_softmax_kl as kd
from repro_torch.kernels import launch_counts, ops, reset_launches

pytestmark = pytest.mark.cuda


@pytest.fixture
def dev():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (the kernels run only on the card)")
    torch.backends.cuda.matmul.allow_tf32 = False
    return torch.device("cuda")


def _kd(seed, T, V, dtype, dev):
    r = np.random.default_rng(seed)
    s = torch.from_numpy((r.standard_normal((T, V)) * 3).astype(np.float32))
    t = torch.from_numpy((r.standard_normal((T, V)) * 3).astype(np.float32))
    y = r.integers(0, V, T).astype(np.int32)
    y[r.random(T) < 0.1] = -1
    return s.to(dev, dtype), t.to(dev, dtype), torch.from_numpy(y).to(dev)


@pytest.mark.parametrize("T,V,dtype", [(64, 10, torch.float32),
                                       (100, 700, torch.float32),
                                       (37, 1031, torch.bfloat16)])
def test_kd_kernels_match_plain(dev, T, V, dtype):
    s, t, y = _kd(T + V, T, V, dtype, dev)
    tol = 2e-5 if dtype == torch.float32 else 5e-2
    reset_launches()
    loss, stats = kd.kd_loss_fwd(s, t, y, tau=2.0, alpha=0.5)
    loss_p, stats_p = kd.kd_loss_fwd_plain(s, t, y, tau=2.0, alpha=0.5)
    torch.testing.assert_close(loss, loss_p, rtol=tol, atol=tol * 10)
    torch.testing.assert_close(stats, stats_p, rtol=tol, atol=tol * 10)
    g = torch.from_numpy(np.random.default_rng(T).random(T, np.float32)).to(dev)
    ds = kd.kd_loss_bwd(s, t, y, stats, g, tau=2.0, alpha=0.5)
    ds_p = kd.kd_loss_bwd_plain(s, t, y, stats_p, g, tau=2.0, alpha=0.5)
    assert ds.dtype == dtype
    btol = 1e-5 if dtype == torch.float32 else 5e-2
    torch.testing.assert_close(ds.float(), ds_p.float(), rtol=btol,
                               atol=btol)
    assert launch_counts()["kd_softmax_kl_fwd"] == 1
    assert launch_counts()["kd_softmax_kl_bwd"] == 1


def test_kd_autograd_function_matches_cpu(dev):
    s, t, y = _kd(5, 3 * 20, 10, torch.float32, dev)
    s, t, y = s.reshape(3, 20, 10), t.reshape(3, 20, 10), y.reshape(3, 20)
    sg = s.clone().requires_grad_(True)
    loss = ops.kd_distillation_loss(sg, t, y, 3.0, 0.25)
    loss.backward()
    sc = s.cpu().requires_grad_(True)
    want = ops.kd_distillation_loss(sc, t.cpu(), y.cpu(), 3.0, 0.25)
    want.backward()
    torch.testing.assert_close(loss.cpu(), want, rtol=2e-5, atol=2e-5)
    torch.testing.assert_close(sg.grad.cpu(), sc.grad, rtol=1e-5, atol=1e-6)


@pytest.mark.parametrize("N,D,dtype,decay", [
    (40, 9216, torch.float32, 0.0), (13, 513, torch.float32, 0.5),
    (300, 70, torch.float32, 1.5), (40, 2560, torch.bfloat16, 0.0)])
def test_fused_merge_matches_plain(dev, N, D, dtype, decay):
    r = np.random.default_rng(N + D)
    x = torch.from_numpy((r.standard_normal((N, D)) * 2).astype(np.float32))
    w = torch.from_numpy((np.abs(r.standard_normal(N)) + 0.1)
                         .astype(np.float32)).to(dev)
    s = torch.from_numpy(r.integers(0, 4, N).astype(np.float32)).to(dev)
    x = x.to(dev, dtype)
    reset_launches()
    out = fm.fused_merge(x, w, s, decay=decay)
    tol = 1e-5 if dtype == torch.float32 else 2e-2
    torch.testing.assert_close(out, fm.fused_merge_plain(x, w, s, decay=decay),
                               rtol=tol, atol=tol)
    assert out.dtype == torch.float32
    assert launch_counts()["fused_merge"] == 1


def test_wrappers_refuse_what_the_kernels_do_not_take(dev):
    x = torch.ones((4, 6), device=dev)
    w = torch.ones(4, device=dev)
    with pytest.raises(ValueError, match="contiguous"):
        fm.fused_merge(torch.ones((6, 4), device=dev).T, w, w)
    with pytest.raises(TypeError, match="float32"):
        fm.fused_merge(x, w.double(), w)
    s = torch.zeros((4, 8), device=dev, dtype=torch.float64)
    with pytest.raises(TypeError, match="unsupported dtype"):
        kd.kd_loss_fwd(s, s, torch.zeros(4, dtype=torch.int32, device=dev))
