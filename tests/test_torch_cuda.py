"""The port's CUDA kernels on the card, each against its plain PyTorch
version on the same inputs.  These need an NVIDIA GPU and ``nvcc`` (the
first test builds the kernels); without a card they skip.  On a machine with
one, run them with

    PYTHONPATH=src python -m pytest -m cuda tests/test_torch_cuda.py

Tolerances are those of ``chip_smoke.py``: 2e-5 on the f32 KD loss and
stats, 1e-5 on its gradient, 5e-2 in bf16, 1e-5 on the f32 merge and 2e-2
on a bf16 leaf, 1e-4 relative on k-means distances with no assignment
differing.  This file imports no JAX, so it runs where JAX is absent.
"""
import numpy as np
import pytest
import torch

from repro_torch.kernels import fused_merge as fm
from repro_torch.kernels import kd_softmax_kl as kd
from repro_torch.kernels import kmeans_assign as km
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


@pytest.mark.parametrize("N,F,K", [(40, 2352, 2), (40, 2352, 5),
                                   (16384, 2352, 8), (97, 300, 16)])
def test_kmeans_assign_matches_plain(dev, N, F, K):
    r = np.random.default_rng(N + K)
    x = torch.from_numpy(r.standard_normal((N, F)).astype(np.float32)).to(dev)
    c = torch.from_numpy(r.standard_normal((K, F)).astype(np.float32)).to(dev)
    reset_launches()
    a, d = km.kmeans_assign(x, c)
    a_p, d_p = km.kmeans_assign_plain(x, c)
    assert a.dtype == torch.int32
    assert int((a != a_p).sum()) == 0
    torch.testing.assert_close(d, d_p, rtol=1e-4, atol=1e-4)
    assert launch_counts()["kmeans_assign"] == 1


def test_kmeans_assign_ties_and_refusals(dev):
    c = torch.zeros((4, 6), device=dev)
    c[0, 0], c[1, 1], c[2, 0], c[3, 1] = 1.0, 2.0, -1.0, 2.0
    x = torch.zeros((3, 6), device=dev)
    x[1, 1], x[2, 1] = 2.0, 2.5
    a, _ = km.kmeans_assign(x, c)
    assert a.tolist() == [0, 1, 1]
    with pytest.raises(ValueError, match="K="):
        km.kmeans_assign(x, torch.zeros((17, 6), device=dev))
    with pytest.raises(ValueError, match="contiguous"):
        km.kmeans_assign(torch.zeros((6, 3), device=dev).T, c)
    with pytest.raises(TypeError, match="float32"):
        km.kmeans_assign(x.double(), c)


def test_kd_loss_lanes_matches_cpu(dev):
    s, t, y = _kd(11, 4 * 16, 10, torch.float32, dev)
    s, t, y = s.reshape(4, 16, 10), t.reshape(4, 16, 10), y.reshape(4, 16)
    reset_launches()
    sg = s.clone().requires_grad_(True)
    lanes = ops.kd_distillation_loss_lanes(sg, t, y, tau=2.0, alpha=0.5)
    (lanes * torch.arange(1.0, 5.0, device=dev)).sum().backward()
    assert launch_counts()["kd_softmax_kl_fwd"] == 1
    assert launch_counts()["kd_softmax_kl_bwd"] == 1
    sc = s.cpu().requires_grad_(True)
    want = ops.kd_distillation_loss_lanes(sc, t.cpu(), y.cpu(), tau=2.0,
                                          alpha=0.5)
    (want * torch.arange(1.0, 5.0)).sum().backward()
    torch.testing.assert_close(lanes.detach().cpu(), want.detach(),
                               rtol=2e-5, atol=2e-5)
    torch.testing.assert_close(sg.grad.cpu(), sc.grad, rtol=1e-5, atol=1e-6)


SMALL_RUN = dict(algorithm="fedsikd", num_clients=6, alpha=1.0, rounds=2,
                 teacher_warmup_epochs=1, batch_size=32, num_clusters=2)


def _card_and_cpu_runs(dev, monkeypatch, cfg):
    """The run of ``cfg`` on the card and on the CPU, the card's launch
    counts, and each metric's largest gap (absolute for accuracy, relative
    for the losses), printed for the record."""
    from repro_torch.data.synthetic import load_dataset
    from repro_torch.fed.rounds import run_federated
    monkeypatch.setattr(torch.backends.cudnn, "allow_tf32", False)
    ds = load_dataset("mnist", small=True)
    reset_launches()
    h = run_federated(ds, cfg, device=dev)
    counts = launch_counts()
    want = run_federated(ds, cfg, device="cpu")
    gaps = {"acc": float(np.max(np.abs(np.subtract(h["acc"], want["acc"]))))}
    for key in ("loss", "teacher_loss", "student_loss"):
        gaps[key] = float(np.max(np.abs(np.subtract(h[key], want[key]))
                                 / np.abs(want[key])))
    print(f"card-vs-cpu {cfg.engine}: {gaps}")
    return h, want, counts, gaps


def test_loop_run_on_the_card_matches_cpu(dev, monkeypatch):
    """The loop engine's small run on the card against the same run on the
    CPU: the witness for the packed test's bounds below, since the loop
    engine has no grouped convolutions and no lanes, only cuDNN's and the
    CPU's different orders of summation."""
    from repro_torch.fed.rounds import FedConfig
    h, want, counts, gaps = _card_and_cpu_runs(
        dev, monkeypatch, FedConfig(engine="loop", **SMALL_RUN))
    assert counts["kmeans_assign"] == 51
    assert gaps["acc"] <= 0.02
    for key in ("loss", "teacher_loss", "student_loss"):
        assert gaps[key] <= 1e-2, (key, h[key], want[key])


def test_packed_run_on_the_card_matches_cpu(dev, monkeypatch):
    """A small packed run on the card against the same run on the CPU (the
    kernels against their plain versions, end to end), with every student
    step one KD forward and one backward launch for all lanes.  cuDNN's
    grouped convolutions and the CPU's sum in other orders, and some 30
    Adam steps carry those ulps forward, so the metrics agree to 2 points of
    accuracy and 1e-2 relative loss, not to the last digit; the loop
    engine's test above shows gaps of the same order with no lanes."""
    from repro_torch.data.pipeline import make_client_shards
    from repro_torch.data.synthetic import load_dataset
    from repro_torch.fed.rounds import FedConfig
    from repro_torch.fed.sharded import client_step_counts
    cfg = FedConfig(engine="sharded", pack=6, **SMALL_RUN)
    h, want, counts, gaps = _card_and_cpu_runs(dev, monkeypatch, cfg)
    shards = make_client_shards(load_dataset("mnist", small=True), 6, 1.0)
    budget = client_step_counts(shards, 32, 1).max()
    assert counts["kd_softmax_kl_fwd"] == counts["kd_softmax_kl_bwd"] \
        == cfg.rounds * budget
    assert counts["kmeans_assign"] == 51
    assert gaps["acc"] <= 0.02
    for key in ("loss", "teacher_loss", "student_loss"):
        assert gaps[key] <= 1e-2, (key, h[key], want[key])
