"""The port's CUDA kernels on the card, each against its plain PyTorch
version on the same inputs.  These need an NVIDIA GPU and ``nvcc`` (the
first test builds the kernels); without a card they skip.  On a machine with
one, run them with

    PYTHONPATH=src python -m pytest -m cuda tests/test_torch_cuda.py

Tolerances are those of ``chip_smoke.py``: 2e-5 on the f32 KD loss and
stats, 1e-5 on its gradient, 5e-2 in bf16 (``KD_TOL``; its ``KD_CASES``
give the shapes of each KD regime) and, for a bf16 gradient, one rounding
of the float32 one (``KD_BF16_DS``), 1e-5 on the f32 merge and 2e-2
on a bf16 leaf (single- and multi-leaf entries), 1e-4 relative on k-means
distances with no assignment differing (both regimes), and ``chip_smoke.FA_TOL`` on flash attention (2e-5 in f32; in
bf16 one rounding of the output, rtol 8e-3 over an atol of 1e-4), whose
shapes and inputs also come from ``chip_smoke.py``.  This file imports no
JAX, so it runs where JAX is absent.
"""
import sys
from pathlib import Path

import numpy as np
import pytest
import torch

sys.path.insert(0, str(Path(__file__).resolve().parents[1]))
import chip_smoke  # noqa: E402  (the repository root's smoke script)

from repro_torch.kernels import flash_attention as fa
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


def _kd_call_checked(s, t, y, g, tau, alpha, regime):
    """One forward and one backward call against the plain versions at
    ``chip_smoke.KD_TOL`` (and a bf16 ds at ``KD_BF16_DS`` against the
    plain ds in float32); each call exactly one launch, of ``regime``."""
    name = str(s.dtype)[6:]
    tol, btol = chip_smoke.KD_TOL[name]
    reset_launches()
    loss, stats = kd.kd_loss_fwd(s, t, y, tau=tau, alpha=alpha)
    ds = kd.kd_loss_bwd(s, t, y, stats, g, tau=tau, alpha=alpha)
    one = {k: int(k == regime) for k in kd.VARIANTS}
    assert launch_counts()["kd_softmax_kl_fwd"] == 1
    assert launch_counts()["kd_softmax_kl_bwd"] == 1
    assert kd.kd_loss_fwd.variant_launches == one
    assert kd.kd_loss_bwd.variant_launches == one
    loss_p, stats_p = kd.kd_loss_fwd_plain(s, t, y, tau=tau, alpha=alpha)
    ds_p = kd.kd_loss_bwd_plain(s, t, y, stats_p, g, tau=tau, alpha=alpha)
    torch.testing.assert_close(loss, loss_p, rtol=tol, atol=tol * 10)
    torch.testing.assert_close(stats, stats_p, rtol=tol, atol=tol * 10)
    assert ds.dtype == s.dtype
    torch.testing.assert_close(ds.float(), ds_p.float(), rtol=btol,
                               atol=btol)
    if s.dtype == torch.bfloat16:
        want = kd.kd_loss_bwd_plain(s.float(), t.float(), y, stats_p, g,
                                    tau=tau, alpha=alpha)
        rtol, floor = chip_smoke.KD_BF16_DS
        torch.testing.assert_close(ds.float(), want, rtol=rtol,
                                   atol=floor * float(want.abs().max()))


@pytest.mark.parametrize("T,V", chip_smoke.KD_CASES, ids=str)
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_kd_regimes_match_plain(dev, T, V, dtype):
    """``chip_smoke.py``'s phase-2 KD cases, with its inputs
    (``_kd_inputs``) and tolerances: rows (V = 10), stream (an LLM
    vocabulary, an odd V whose rows are not 16-byte aligned, and fewer rows
    than SMs)."""
    s, t, y = chip_smoke._kd_inputs(T, V, dtype, T + V)
    regime = kd.plan(T, V, torch.cuda.get_device_properties(
        dev).multi_processor_count)["regime"]
    _kd_call_checked(s, t, y, chip_smoke._lane_grads(y, T), 2.0, 0.5, regime)


@pytest.mark.parametrize("T,V", chip_smoke.KD_BF16_CASES, ids=str)
def test_kd_distill_vocabularies_match_plain(dev, T, V):
    """``chip_smoke.py``'s bf16 KD cases at the distill steps' vocabularies
    (65,536, 102,400 and 256,206: rows 6 mod 8 elements long, so
    consecutive rows start at other 16-byte alignments), with its inputs
    drawn on the card (``_kd_inputs_on_card``) and its tolerances."""
    s, t, y = chip_smoke._kd_inputs_on_card(T, V, torch.bfloat16, V)
    regime = kd.plan(T, V, torch.cuda.get_device_properties(
        dev).multi_processor_count)["regime"]
    _kd_call_checked(s, t, y, chip_smoke._lane_grads(y, T), 2.0, 0.5, regime)


@pytest.mark.parametrize("T,V", [(64, 10), (300, 32003), (5, 50257)],
                         ids=str)
@pytest.mark.parametrize("tau,alpha", [(0.7, 0.25), (3.0, 1.0)])
def test_kd_regimes_hold_at_other_temperatures(dev, T, V, tau, alpha):
    """The base-2 arithmetic (logits times log2(e)/tau, no division) at a
    tau that is not a power of two, in each regime, f32 and its bound."""
    s, t, y = chip_smoke._kd_inputs(T, V, torch.float32, T + V + 1)
    regime = kd.plan(T, V, torch.cuda.get_device_properties(dev)
                     .multi_processor_count)["regime"]
    _kd_call_checked(s, t, y, chip_smoke._lane_grads(y, T), tau, alpha,
                     regime)


@pytest.mark.parametrize("T,V", [(64, 10), (300, 32003), (5, 50257)],
                         ids=str)
def test_kd_misaligned_view_matches_plain(dev, T, V):
    """s one element into its buffer: s, t and ds do not lie alike modulo
    16 bytes, so every element takes the scalar path (the rows regime
    stages each tensor with its own offset)."""
    s, t, y = chip_smoke._kd_inputs(T, V, torch.float32, T + V + 2)
    buf = torch.empty(T * V + 1, device=dev)
    buf[1:].copy_(s.reshape(-1))
    s1 = buf[1:].view(T, V)
    assert s1.data_ptr() % 16 and s1.is_contiguous()
    regime = kd.plan(T, V, torch.cuda.get_device_properties(dev)
                     .multi_processor_count)["regime"]
    _kd_call_checked(s1, t, y, chip_smoke._lane_grads(y, T), 2.0, 0.5,
                     regime)


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
    assert fm.fused_merge.variant_launches == {"leaf": 1, "leaves": 0}


@pytest.mark.parametrize("N,dtypes,decay,offset", [
    (40, (torch.float32,), 0.5, 0),          # the loop engine's round
    (300, (torch.float32,), 1.5, 0),         # N past one chunk of weights
    (40, (torch.bfloat16,), 0.0, 0),
    (40, (torch.float32,), 0.5, 1),          # misaligned rows: scalar loads
    (40, (torch.bfloat16,), 0.5, 3),
    (7, (torch.float32, torch.bfloat16), 0.5, 0),   # two dtypes: 2 launches
], ids=str)
def test_fused_merge_leaves_matches_plain(dev, N, dtypes, decay, offset):
    """The ten student leaves from ``chip_smoke._client_rows``; with
    ``offset`` the odd clients' rows are not 16-byte aligned."""
    rows, w, s = chip_smoke._client_rows(N, dtypes, N + offset,
                                         offset=offset, device=dev)
    if offset:
        assert any(t.data_ptr() % 16 for t in rows[1])
    reset_launches()
    got = fm.fused_merge_leaves(rows, w, s, decay=decay)
    assert launch_counts()["fused_merge"] == len(dtypes)
    assert fm.fused_merge.variant_launches == {"leaf": 0,
                                               "leaves": len(dtypes)}
    want = fm.fused_merge_leaves_plain(rows, w, s, decay=decay)
    for l, (g, ref) in enumerate(zip(got, want)):
        tol = 1e-5 if rows[0][l].dtype == torch.float32 else 2e-2
        assert g.dtype == torch.float32 and g.shape == rows[0][l].shape
        assert g.data_ptr() % 16 == 0
        torch.testing.assert_close(g, ref, rtol=tol, atol=tol)


def test_weighted_average_is_one_launch_on_the_card(dev):
    """The loop engine's merge (``core.aggregation``) of 40 client dicts of
    the student: one kernel launch, each leaf's dtype kept, equal to the
    same merge on the CPU."""
    from repro_torch.core import aggregation as agg
    rows, w, _ = chip_smoke._client_rows(40, (torch.float32,), 1,
                                         device=dev)
    keys = [f"leaf{l}" for l in range(len(rows[0]))]
    params = [dict(zip(keys, r)) for r in rows]
    reset_launches()
    got = agg.weighted_average(params, w.tolist())
    assert fm.fused_merge.variant_launches == {"leaf": 0, "leaves": 1}
    want = agg.weighted_average([{k: v.cpu() for k, v in p.items()}
                                 for p in params], w.tolist())
    for k in keys:
        assert got[k].dtype == params[0][k].dtype
        torch.testing.assert_close(got[k].cpu(), want[k], rtol=1e-5,
                                   atol=1e-5)


def test_a_merge_of_one_client_is_its_input(dev):
    """FL+HC merges a cluster of one member: the N = 1 merge of the
    teacher's leaves (the baselines' model) on the card gives the client's
    params back bit for bit (its normalised weight is exactly 1), and a
    zero weight beside it leaves them so too."""
    from repro_torch.core import aggregation as agg
    rows, _, _ = chip_smoke._client_rows(2, (torch.float32,), 2,
                                         student=False, device=dev)
    keys = [f"leaf{l}" for l in range(len(rows[0]))]
    one, other = (dict(zip(keys, r)) for r in rows)
    reset_launches()
    for got in (agg.fedavg([one], [37]), agg.fedavg([one, other], [37, 0])):
        for k in keys:
            assert torch.equal(got[k], one[k]), k
    assert fm.fused_merge.variant_launches == {"leaf": 0, "leaves": 2}


def test_fedavg_on_the_card_merges_once_a_round(dev, monkeypatch):
    """A small loop FedAvg run on the card: one ``leaves`` merge launch a
    round, and metrics within the loop engine's card-vs-CPU bounds (2
    points of accuracy, 1e-2 relative loss)."""
    from repro_torch.data.synthetic import load_dataset
    from repro_torch.fed.rounds import FedConfig, run_federated
    monkeypatch.setattr(torch.backends.cudnn, "allow_tf32", False)
    ds = load_dataset("mnist", small=True)
    cfg = FedConfig(algorithm="fedavg", num_clients=6, alpha=1.0, rounds=2,
                    batch_size=32)
    reset_launches()
    h = run_federated(ds, cfg, device=dev)
    assert launch_counts()["fused_merge"] == cfg.rounds
    assert fm.fused_merge.variant_launches == {"leaf": 0,
                                               "leaves": cfg.rounds}
    want = run_federated(ds, cfg, device="cpu")
    assert np.max(np.abs(np.subtract(h["acc"], want["acc"]))) <= 0.02
    np.testing.assert_allclose(h["loss"], want["loss"], rtol=1e-2)


@pytest.mark.parametrize("algorithm,engine", [("fedprox", "loop"),
                                              ("fedprox", "sharded"),
                                              ("flhc", "loop")], ids=str)
def test_baseline_on_the_card_matches_cpu(dev, monkeypatch, algorithm,
                                          engine):
    """A small FedProx (both engines) and FL+HC run on the card against the
    same run on the CPU: FedProx's proximal term and FL+HC's clustering of
    updates read back to the host, with the fused merge once a round on the
    loop engine, once a cluster a round for FL+HC and never on the packed
    engine; metrics within the card-vs-CPU bounds of the FedAvg test above
    (2 points of accuracy, 1e-2 relative loss)."""
    from repro_torch.data.synthetic import load_dataset
    from repro_torch.fed.rounds import FedConfig, run_federated
    monkeypatch.setattr(torch.backends.cudnn, "allow_tf32", False)
    ds = load_dataset("mnist", small=True)
    cfg = FedConfig(algorithm=algorithm, engine=engine, num_clients=6,
                    alpha=1.0, rounds=2, batch_size=32, num_clusters=2,
                    **({"pack": 6} if engine == "sharded" else {}))
    reset_launches()
    h = run_federated(ds, cfg, device=dev)
    want = run_federated(ds, cfg, device="cpu")
    merges = {"loop": cfg.rounds, "sharded": 0}[engine]
    if algorithm == "flhc":
        assert h["num_clusters"] == want["num_clusters"] == 2
        merges = cfg.rounds * h["num_clusters"]
    assert launch_counts()["fused_merge"] == merges
    assert fm.fused_merge.variant_launches == {"leaf": 0, "leaves": merges}
    assert np.max(np.abs(np.subtract(h["acc"], want["acc"]))) <= 0.02
    np.testing.assert_allclose(h["loss"], want["loss"], rtol=1e-2)


@pytest.mark.parametrize("algorithm,knobs", [
    ("fedavg", dict(async_mode=True, straggler_frac=0.5, max_staleness=1,
                    rounds=3)),
    ("fedsikd", dict(join_schedule=((2, 2),), leave_rate=0.15,
                     recluster_every=1, rounds=2)),
], ids=["fedavg-async", "fedsikd-lifecycle"])
def test_runtime_run_on_the_card_matches_cpu(dev, monkeypatch, algorithm,
                                             knobs):
    """Loop FedAvg with stragglers and loop FedSiKD with joins, leaves and
    re-clustering on the card against the same runs on the CPU: the plan's
    keys (participants, labels, the buffer's counts) equal, metrics within
    the card-vs-CPU bounds of the baseline tests above (2 points of
    accuracy, 1e-2 relative loss).  Every merge is one ``leaves`` launch a
    round, and each re-clustering 51 ``kmeans_assign`` launches beside the
    setup's 51; the async run merges at least one late update (s >= 1)."""
    from repro_torch.data.synthetic import load_dataset
    from repro_torch.fed.rounds import FedConfig, run_federated
    monkeypatch.setattr(torch.backends.cudnn, "allow_tf32", False)
    ds = load_dataset("mnist", small=True)
    cfg = FedConfig(algorithm=algorithm, num_clients=6, alpha=1.0,
                    batch_size=32, num_clusters=2, teacher_warmup_epochs=1,
                    **knobs)
    reset_launches()
    h = run_federated(ds, cfg, device=dev)
    counts, stale = launch_counts(), fm.fused_merge.stale_launches
    want = run_federated(ds, cfg, device="cpu")
    for key in ("participants", "labels_history", "recluster",
                "stragglers", "stale_merged", "stale_dropped", "buffered"):
        assert h.get(key) == want.get(key), key
    assert counts["fused_merge"] == fm.fused_merge.variant_launches[
        "leaves"] == cfg.rounds
    if algorithm == "fedsikd":
        assert counts["kmeans_assign"] == 51 * (1 + sum(h["recluster"]))
    else:
        assert sum(h["stale_merged"]) >= 1 and stale >= 1
    assert np.max(np.abs(np.subtract(h["acc"], want["acc"]))) <= 0.02
    np.testing.assert_allclose(h["loss"], want["loss"], rtol=1e-2)


def test_checkpoint_of_card_tensors_is_bit_exact(dev, tmp_path):
    """A checkpoint of CUDA tensors (float32, bfloat16, int32, an Adam
    state) restores bit for bit, and back onto the card."""
    from repro_torch import checkpoint as ckpt
    from repro_torch.optim import adamw
    g = torch.Generator(device=dev).manual_seed(0)
    p = {"w": torch.randn(33, 7, device=dev, generator=g),
         "b": torch.randn(7, device=dev, generator=g)}
    tree = {"p": p, "bf": torch.randn(5, 9, device=dev,
                                      generator=g).to(torch.bfloat16),
            "opt": adamw(1e-3).init(p),
            "labels": torch.arange(6, dtype=torch.int32, device=dev)}
    ckpt.save(tmp_path / "c", tree)
    back = ckpt.restore(tmp_path / "c", tree)
    pairs = [(back["p"]["w"], p["w"]), (back["p"]["b"], p["b"]),
             (back["bf"], tree["bf"]), (back["labels"], tree["labels"]),
             (back["opt"].count, tree["opt"].count),
             (back["opt"].mu["w"], tree["opt"].mu["w"])]
    for got, want in pairs:
        assert got.device.type == "cpu" and got.dtype == want.dtype
        assert torch.equal(got.to(dev), want)
    assert torch.equal(back["bf"].to(dev).view(torch.int16),
                       tree["bf"].view(torch.int16))


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


@pytest.mark.parametrize("N,F,K", [
    (40, 2352, 3), (40, 2352, 4),            # split: the clustering step
    (16384, 2352, 16),                       # stream, K = MAX_K (150 KB)
    (40, 2350, 5), (16384, 2350, 8),         # F not a multiple of 4
    (3000, 2352, 5), (5, 7, 16)])
def test_kmeans_assign_regimes_match_plain(dev, N, F, K):
    r = np.random.default_rng(N + F + K)
    x = torch.from_numpy(r.standard_normal((N, F)).astype(np.float32)).to(dev)
    c = torch.from_numpy(r.standard_normal((K, F)).astype(np.float32)).to(dev)
    regime = km.plan(N, F, K, torch.cuda.get_device_properties(dev)
                     .multi_processor_count)["regime"]
    reset_launches()
    a, d = km.kmeans_assign(x, c)
    assert km.kmeans_assign.variant_launches == {
        name: int(name == regime) for name in km.VARIANTS}
    a_p, d_p = km.kmeans_assign_plain(x, c)
    assert int((a != a_p).sum()) == 0
    torch.testing.assert_close(d, d_p, rtol=1e-4, atol=1e-4)


@pytest.mark.parametrize("F", [6, 8])
def test_kmeans_assign_ties_in_the_stream_regime(dev, F):
    """The tie points repeated past the stream regime's threshold, with
    scalar (F = 6) and 16-byte (F = 8) loads: ties go to the lowest k."""
    c = torch.zeros((4, F), device=dev)
    c[0, 0], c[1, 1], c[2, 0], c[3, 1] = 1.0, 2.0, -1.0, 2.0
    pts = torch.zeros((3, F), device=dev)
    pts[1, 1], pts[2, 1] = 2.0, 2.5
    x = pts.repeat(1000, 1).contiguous()
    reset_launches()
    a, d = km.kmeans_assign(x, c)
    assert km.kmeans_assign.variant_launches["stream"] == 1
    assert a.tolist() == [0, 1, 1] * 1000
    torch.testing.assert_close(d, km.kmeans_assign_plain(x, c)[1])


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


def test_two_wave_packed_run_on_the_card_matches_cpu(dev, monkeypatch):
    """The small packed run streamed through 3 slots in 2 waves, on the card
    against the CPU: every KD launch on the rows kernels, as many as the
    waves' longest student budgets (read from the run's plans by
    ``chip_smoke._scale_run``), and the bounds of the one-wave test
    above."""
    from repro_torch.data.synthetic import load_dataset
    from repro_torch.fed.rounds import FedConfig, run_federated
    monkeypatch.setattr(torch.backends.cudnn, "allow_tf32", False)
    ds = load_dataset("mnist", small=True)
    cfg = FedConfig(engine="sharded", pack=3, n_devices=1, **SMALL_RUN)
    h, _, counts, want, breakdown = chip_smoke._scale_run(ds, cfg)
    assert want["waves"] == 2 * cfg.rounds
    rows = {"rows": want["kd"], "stream": 0}
    assert counts["kd_variants"] == {"fwd": rows, "bwd": rows}
    assert counts["kmeans_assign"] == 51 and counts["fused_merge"] == 0
    assert len(breakdown["compute"]) == cfg.rounds
    cpu = run_federated(ds, cfg, device="cpu")
    assert np.max(np.abs(np.subtract(h["acc"], cpu["acc"]))) <= 0.02
    for key in ("loss", "teacher_loss", "student_loss"):
        np.testing.assert_allclose(h[key], cpu[key], rtol=1e-2, err_msg=key)


@pytest.mark.parametrize("algorithm", ["fedavg", "fedsikd"])
def test_packed_round_of_arrivals_only_is_one_merge(dev, monkeypatch,
                                                    algorithm):
    """Packed async rounds on the card (2 waves of one slot, two sampled
    clients a round, 90 % stragglers): round 3's two participants both
    straggle while two late updates arrive, so it merges the arrivals alone
    — exactly one ``leaves`` launch in the run, at s >= 1; rounds with an
    on-time lane contract it in the program and launch no merge.  The plan
    keys equal the CPU run's, the metrics within 2 points and 1e-2."""
    from repro_torch.data.synthetic import load_dataset
    from repro_torch.fed.rounds import FedConfig, run_federated
    monkeypatch.setattr(torch.backends.cudnn, "allow_tf32", False)
    ds = load_dataset("mnist", small=True)
    cfg = FedConfig(algorithm=algorithm, engine="sharded", num_clients=6,
                    alpha=1.0, rounds=3, batch_size=32, num_clusters=2,
                    teacher_warmup_epochs=1, pack=1, n_devices=1,
                    participation="uniform", clients_per_round=2,
                    async_mode=True, straggler_frac=0.9, max_staleness=2)
    reset_launches()
    h = run_federated(ds, cfg, device=dev)
    counts, stale = launch_counts(), fm.fused_merge.stale_launches
    cpu = run_federated(ds, cfg, device="cpu")
    for key in ("participants", "stragglers", "stale_merged",
                "stale_dropped", "buffered"):
        assert h[key] == cpu[key], key
    assert chip_smoke._arrivals_only_rounds(h) == 1
    assert counts["fused_merge"] == 1 and stale == 1
    assert fm.fused_merge.variant_launches == {"leaf": 0, "leaves": 1}
    assert np.max(np.abs(np.subtract(h["acc"], cpu["acc"]))) <= 0.02
    np.testing.assert_allclose(h["loss"], cpu["loss"], rtol=1e-2)


@pytest.mark.parametrize("shape", chip_smoke.FA_SHAPES, ids=str)
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_flash_attention_matches_plain(dev, shape, dtype):
    """At the shapes of ``chip_smoke.py``'s phase 2, from its input builder
    and with its tolerances: the JAX kernel test's shapes and windowed case,
    an unequal-pad causal shape the JAX wrapper refuses, the serving path's
    prefill, and its decode steps over a cache prefix (strided views)."""
    B, H, KVH, T, S, hd, window = shape
    q, k, v = chip_smoke._fa_inputs(shape, dtype, sum(shape), dev)
    reset_launches()
    out = ops.flash_attention(q, k, v, causal=True, window=window)
    want = fa.flash_attention_plain(q, k, v, causal=True, window=window)
    assert out.dtype == dtype and out.shape == (B, T, H, hd)
    rtol, atol = chip_smoke.FA_TOL[str(dtype)[6:]]
    torch.testing.assert_close(out.float(), want.float(), rtol=rtol,
                               atol=atol)
    assert launch_counts()["flash_attention"] == 1
    kind = fa.variant(dtype, T)
    assert fa.flash_attention.variant_launches == {
        name: int(name == kind) for name in fa.VARIANTS}


@pytest.mark.parametrize("hd", [96, 192])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("B,H,KVH,T,S,window", [
    (1, 4, 2, 100, 100, 0),         # ragged T (v1 / tensor_core)
    (1, 12, 1, 64, 256, 0),         # cross-length, GQA group of 12
    (1, 2, 2, 128, 128, 32),        # a window
    (1, 7, 1, 1, 97, 0),            # decode, group of 7 (a padded head)
    (2, 16, 2, 1, 4097, 0),         # decode over many spans (the merge)
])
def test_flash_attention_new_head_dims_match_plain(dev, hd, dtype, B, H,
                                                   KVH, T, S, window):
    """Head dims 96 and 192 in each kernel (``v1`` for float32 T > 1,
    ``tensor_core`` for bf16 T > 1, ``decode`` for T = 1) against the
    plain version, at ``chip_smoke.FA_TOL``."""
    shape = (B, H, KVH, T, S, hd, window)
    q, k, v = chip_smoke._fa_inputs(shape, dtype, sum(shape), dev)
    reset_launches()
    out = ops.flash_attention(q, k, v, causal=True, window=window)
    want = fa.flash_attention_plain(q, k, v, causal=True, window=window)
    rtol, atol = chip_smoke.FA_TOL[str(dtype)[6:]]
    torch.testing.assert_close(out.float(), want.float(), rtol=rtol,
                               atol=atol)
    kind = fa.variant(dtype, T)
    assert fa.flash_attention.variant_launches == {
        name: int(name == kind) for name in fa.VARIANTS}


def test_flash_attention_fully_masked_rows_average_v(dev):
    """T > S, right-aligned: the first T - S queries see no key and, with
    the -1e30 mask, average V over all S keys, as the reference does."""
    q, k, v = chip_smoke._fa_inputs((1, 4, 2, 96, 40, 64, 0), torch.float32,
                                    3, dev)
    out = ops.flash_attention(q, k, v, causal=True)
    want = fa.flash_attention_plain(q, k, v, causal=True)
    torch.testing.assert_close(out, want, rtol=2e-5, atol=2e-5)
    mean_v = v.mean(dim=1).repeat_interleave(2, dim=1)       # (B, H, hd)
    torch.testing.assert_close(out[:, 0], mean_v, rtol=2e-5, atol=2e-5)


def test_flash_attention_fully_masked_rows_average_v_bf16(dev):
    """The same in bf16, on the tensor-core kernel: the first 56 queries see
    no key and average V over all 40 keys (the -1e30 mask), the rest see a
    causal prefix; both to ``chip_smoke.FA_TOL`` (one rounding of the
    output)."""
    q, k, v = chip_smoke._fa_inputs((1, 4, 2, 96, 40, 64, 0), torch.bfloat16,
                                    3, dev)
    reset_launches()
    out = ops.flash_attention(q, k, v, causal=True)
    assert fa.flash_attention.variant_launches["tensor_core"] == 1
    rtol, atol = chip_smoke.FA_TOL["bfloat16"]
    want = fa.flash_attention_plain(q, k, v, causal=True)
    torch.testing.assert_close(out.float(), want.float(), rtol=rtol,
                               atol=atol)
    mean_v = v.float().mean(dim=1).repeat_interleave(2, dim=1)  # (B, H, hd)
    torch.testing.assert_close(out[:, :56].float(),
                               mean_v[:, None].expand(-1, 56, -1, -1)
                               .bfloat16().float(), rtol=rtol, atol=atol)


def test_flash_attention_refuses_a_gradient_on_the_card(dev):
    """The CUDA kernels have no backward: with grad mode on and an input
    that requires grad the call raises and launches nothing; under
    ``torch.no_grad()`` it runs and gives the same output."""
    q, k, v = chip_smoke._fa_inputs((1, 4, 2, 8, 8, 64, 0), torch.float32, 5,
                                    dev)
    reset_launches()
    for i in range(3):
        args = [q, k, v]
        args[i] = args[i].clone().requires_grad_(True)
        with pytest.raises(NotImplementedError, match="Queue 1 item 10.2"):
            ops.flash_attention(*args)
    assert launch_counts()["flash_attention"] == 0
    with torch.no_grad():
        out = ops.flash_attention(q.clone().requires_grad_(True), k, v)
    assert not out.requires_grad
    torch.testing.assert_close(out, ops.flash_attention(q, k, v), rtol=0,
                               atol=0)


def test_flash_attention_refuses_what_the_kernel_does_not_take(dev):
    q, k, v = chip_smoke._fa_inputs((1, 4, 2, 8, 8, 64, 0), torch.float32, 4,
                                    dev)
    with pytest.raises(TypeError, match="dtype"):
        ops.flash_attention(q.double(), k.double(), v.double())
    with pytest.raises(TypeError, match="dtype"):
        ops.flash_attention(q, k.bfloat16(), v)
    q48, k48, v48 = (t[..., :48] for t in (q, k, v))
    with pytest.raises(ValueError, match="head_dim"):
        ops.flash_attention(q48.contiguous(), k48.contiguous(),
                            v48.contiguous())
    with pytest.raises(ValueError, match="different devices"):
        ops.flash_attention(q, k.cpu(), v)
    with pytest.raises(ValueError, match="contiguous"):
        ops.flash_attention(q, k.transpose(1, 3).contiguous().transpose(1, 3),
                            v)
    shifted = torch.empty(k.numel() + 1, device=dev)[1:].view(k.shape)
    shifted.copy_(k)                      # 4 bytes past a 16-byte boundary
    with pytest.raises(ValueError, match="16-byte"):
        ops.flash_attention(q, shifted, v)


def _to(tree, device):
    if isinstance(tree, dict):
        return {k: _to(v, device) for k, v in tree.items()}
    return tree.to(device)


def _serve(cfg, params, toks, T, device):
    """Prefill ``toks[:, :T]``, grow the cache, decode the rest of ``toks``
    one token at a time; the (1 + extra, B, V) logits on the CPU."""
    from repro_torch.launch.steps import make_decode_step, make_prefill_step
    p = _to(params, device)
    last, cache = make_prefill_step(cfg)(p, {"tokens": toks[:, :T].to(device)})
    extra = toks.shape[1] - T
    cache = chip_smoke._grow(cache, extra)
    decode = make_decode_step(cfg)
    outs = [last]
    for t in range(T, T + extra):
        logits, cache = decode(p, cache, toks[:, t:t + 1].to(device), t)
        outs.append(logits)
    return torch.stack(outs).cpu()


def test_lm_prefill_and_decode_on_the_card_match_cpu(dev):
    """A 2-layer smoke-width qwen2.5-3b in float32: a 24-token prefill and
    8 decode steps on the card against the same calls on the CPU (the
    kernel against its plain version inside the whole model)."""
    import dataclasses

    from repro_torch.configs import get_config
    from repro_torch.models import transformer as tf
    cfg = dataclasses.replace(get_config("qwen2.5-3b", smoke=True),
                              dtype="float32")
    T, extra = 24, 8
    toks = torch.from_numpy(np.random.default_rng(9).integers(
        0, cfg.vocab_size, (2, T + extra)))
    params = tf.init_lm(3, cfg, device="cpu")
    want = _serve(cfg, params, toks, T, "cpu")
    reset_launches()
    got = _serve(cfg, params, toks, T, dev)
    assert launch_counts()["flash_attention"] == cfg.num_layers * (1 + extra)
    # float32: the prefill on the v1 kernel, every decode step on the
    # decode kernel
    assert fa.flash_attention.variant_launches == {
        "v1": cfg.num_layers, "tensor_core": 0,
        "decode": cfg.num_layers * extra}
    print(f"lm card-vs-cpu max abs gap {float((got - want).abs().max())}")
    torch.testing.assert_close(got, want, rtol=2e-4, atol=2e-4)


@pytest.mark.parametrize("arch,flash_layers", [("deepseek-v2-236b", 0),
                                                ("arctic-480b", 2)])
def test_moe_prefill_and_decode_on_the_card_match_cpu(dev, arch,
                                                      flash_layers):
    """The smoke-size MoE models in float32 (deepseek's MLA is plain
    torch and launches no flash kernel; arctic's GQA does): a 24-token
    prefill and 8 decode steps on the card against the same calls on the
    CPU."""
    import dataclasses

    from repro_torch.configs import get_config
    from repro_torch.models import transformer as tf
    cfg = dataclasses.replace(get_config(arch, smoke=True), dtype="float32")
    T, extra = 24, 8
    toks = torch.from_numpy(np.random.default_rng(10).integers(
        0, cfg.vocab_size, (2, T + extra)))
    params = tf.init_lm(4, cfg, device="cpu")
    want = _serve(cfg, params, toks, T, "cpu")
    reset_launches()
    got = _serve(cfg, params, toks, T, dev)
    assert fa.flash_attention.variant_launches == {
        "v1": flash_layers, "tensor_core": 0,
        "decode": flash_layers * extra}
    print(f"{arch} card-vs-cpu max abs gap "
          f"{float((got - want).abs().max())}")
    torch.testing.assert_close(got, want, rtol=2e-4, atol=2e-4)


def _flat_to(tree, device):
    from repro_torch.tree import flatten
    return {k: v.detach().to(device, copy=True)
            for k, v in flatten(tree).items()}


def test_lm_train_step_on_the_card_launches_nothing_and_matches_cpu(dev):
    """A 2-layer smoke-width qwen2.5-3b in float32 with attn_block 16: one
    train step at accum 2 on 2 x 64 tokens (the blocked training
    attention) launches no flash and no KD kernel, and its params match
    the same step on the CPU per leaf at 1e-4 in the Frobenius norm (the
    near-zero-gradient key bias by Adam's step bound, as in
    ``chip_smoke.phase_lm_train``)."""
    import dataclasses

    from repro_torch.configs import get_config
    from repro_torch.launch.steps import make_train_step
    from repro_torch.models import transformer as tf
    from repro_torch.tree import unflatten
    cfg = dataclasses.replace(get_config("qwen2.5-3b", smoke=True),
                              dtype="float32", attn_block=16)
    toks = torch.from_numpy(np.random.default_rng(4).integers(
        0, cfg.vocab_size, (2, 65)))
    batch = {"tokens": toks[:, :-1], "labels": toks[:, 1:]}
    params = tf.init_lm(2, cfg, device="cpu")
    out = {}
    for device in ("cpu", dev):
        p = unflatten(_flat_to(params, device))
        step, opt = make_train_step(cfg, lr=1e-3, accum=2)
        reset_launches()
        _, _, loss = step(p, opt.init(p), {k: v.to(device)
                                           for k, v in batch.items()})
        out[str(device)] = (float(loss), _flat_to(p, "cpu"),
                            dict(launch_counts()))
    (l_cpu, p_cpu, _), (l_card, p_card, counts) = out.values()
    assert counts["flash_attention"] == counts["kd_softmax_kl_fwd"] == 0
    assert counts["kd_softmax_kl_bwd"] == 0
    assert l_card == pytest.approx(l_cpu, rel=1e-5)
    for k, w in p_cpu.items():
        if k == "layers.attn.bk":
            assert float(p_card[k].abs().max()) <= 1e-3
            continue
        assert float((p_card[k] - w).norm() / w.norm()) <= 1e-4, k


@pytest.mark.parametrize("path,kw,kd_n,fa_per_layer", [
    ("default", {}, 1, 1),
    ("vocab_chunk", {"vocab_chunk": 200}, 0, 1),
    ("teacher_in_grad", {"teacher_in_grad": True}, 1, 4),   # 2 x D
])
def test_lm_distill_step_launches_on_the_card(dev, path, kw, kd_n,
                                              fa_per_layer):
    """A smoke-width qwen2.5-3b teacher in bf16, D 2 students: each loss
    path's exact KD launches (the lanes form: one forward and one
    backward, none when vocab-chunked) and teacher flash launches (one
    forward of the whole batch, or each replica's forward twice inside
    its checkpointed closure); the loss within bf16 tolerance of the same
    step on the CPU; the teacher unchanged."""
    from repro_torch.configs import get_config
    from repro_torch.launch.steps import make_fedsikd_distill_step
    from repro_torch.models import transformer as tf
    from repro_torch.tree import flatten, unflatten
    cfg = get_config("qwen2.5-3b", smoke=True)
    D = 2
    toks = torch.from_numpy(np.random.default_rng(6).integers(
        0, cfg.vocab_size, (D, 1, 33)))
    batch = {"tokens": toks[..., :-1], "labels": toks[..., 1:]}
    teacher = tf.init_lm(1, cfg, device="cpu")
    step, _, init, opt, _ = make_fedsikd_distill_step(cfg, (0, 0), **kw)
    students = init(2, device="cpu")
    losses = {}
    for device in ("cpu", dev):
        t = unflatten(_flat_to(teacher, device))
        before = _flat_to(t, "cpu")
        s = unflatten(_flat_to(students, device))
        reset_launches()
        _, _, loss = step(s, opt.init(s), t,
                          {k: v.to(device) for k, v in batch.items()})
        losses[str(device)] = float(loss)
        for k, v in flatten(t).items():
            assert torch.equal(v.cpu(), before[k]), k
    counts = launch_counts()
    assert kd.kd_loss_fwd.variant_launches == {"rows": kd_n, "stream": 0}
    assert kd.kd_loss_bwd.variant_launches == {"rows": kd_n, "stream": 0}
    assert fa.flash_attention.variant_launches == {
        "v1": 0, "tensor_core": fa_per_layer * cfg.num_layers, "decode": 0}
    assert counts["fused_merge"] == 0
    assert losses[str(dev)] == pytest.approx(losses["cpu"], rel=5e-2)
