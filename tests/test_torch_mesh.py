"""The port's client mesh (``repro_torch.launch.mesh``, ``launch.shardings``
and the mesh forms of ``core.cluster_collectives``) on gloo worlds of CPU
ranks, spawned by ``torch.multiprocessing`` with a ``FileStore`` under
``tmp_path`` (``tests/_torch_mesh_worker.py`` holds the rank workers).

- The mesh operators at a world of 4 against the JAX package's on 4
  placeholder devices under ``shard_map`` (a subprocess, as the JAX mesh
  tests run theirs), within 1e-6: the unpacked operators with one client a
  rank, the packed ones with 2 slots a rank; ``gather_slots`` returns the
  rows that the ranks hold, bit for bit.
- Packed FedSiKD and FedAvg runs at worlds 2 and 4, in 1 wave of 8 slots
  and in 2 waves, against the same runs with no process group: equal
  accuracy and losses within 1e-6 relative (``test_pack_changes_no_result``'s
  bound), every rank with the same history and the same global model
  after every round, and each rank holding its block of the slots.  At a
  world of 2 also FedProx over a virtual universe, and FedSiKD with DP
  noise, stragglers, joins, re-clustering and checkpoints.
- A world that does not divide the slots raises ``ValueError`` naming
  them; ``client_stack_specs`` and ``check_divisible`` as JAX's.

The mesh gives bit-equal params because a rank's lanes compute as they
would among all of them; at least 2 slots a rank keep every product's
kernel path (one lane a rank changes a convolution's gradient in the last
bit on the CPU, and Adam's first step carries that far).
"""
import numpy as np
import pytest
import torch
import torch.multiprocessing as mp

import _torch_mesh_worker as worker
from _subproc import run_script
from repro_torch.data.synthetic import load_dataset
from repro_torch.fed.rounds import FedConfig, run_federated
from repro_torch.launch import shardings

torch.set_num_threads(1)

BASE = dict(engine="sharded", alpha=1.0, rounds=2, local_epochs=1,
            batch_size=32, seed=0)
KD = dict(BASE, algorithm="fedsikd", teacher_warmup_epochs=1, num_clusters=2)
JOBS = {
    "fedsikd 1 wave": dict(KD, num_clients=8, pack=4),
    "fedsikd 2 waves": dict(KD, num_clients=16, pack=2, n_devices=4,
                            waves=2),
    "fedavg 1 wave": dict(BASE, algorithm="fedavg", num_clients=8, pack=4),
    "fedavg 2 waves": dict(BASE, algorithm="fedavg", num_clients=16, pack=2,
                           n_devices=4, waves=2),
}
KNOBS = {
    "fedprox universe": dict(BASE, algorithm="fedprox", num_clients=8,
                             universe=40, participation="uniform",
                             clients_per_round=8, pack=4),
    "fedsikd runtime knobs": dict(KD, num_clients=8, pack=4, n_devices=2,
                                  dp_noise=0.05, async_mode=True,
                                  straggler_frac=0.3,
                                  join_schedule=((2, 2),),
                                  recluster_every=2),
}
RUNS = {2: {**JOBS, **KNOBS}, 4: JOBS}
REFUSED = dict(BASE, algorithm="fedavg", num_clients=6, pack=3)
CASES = [(w, job) for w, jobs in RUNS.items() for job in jobs]


def _start(fn, world, tmp_path, *args):
    out = tmp_path / f"{fn.__name__}_{world}"
    out.mkdir()
    ctx = mp.start_processes(fn, args=(world, str(out / "store"), *args,
                                       str(out)),
                             nprocs=world, join=False, start_method="spawn")
    return ctx, out


def _results(started, world):
    ctx, out = started
    while not ctx.join():
        pass
    return [torch.load(out / f"rank{r}.pt", weights_only=False)
            for r in range(world)]


@pytest.fixture(scope="module")
def worlds(tmp_path_factory):
    """Every job of ``RUNS`` in its world (the world of 4 also the refused
    layout: 6 slots in 4 blocks), and the same jobs with no process group,
    computed here while the worlds run; each run that checkpoints writes
    to a folder of its own."""
    tmp = tmp_path_factory.mktemp("mesh_runs")
    ckpt = {"fedsikd runtime knobs": dict(ckpt_dir=str(tmp / "ckpt"))}
    started = {w: _start(worker.runs, w, tmp, [
        (name, {**kw, **ckpt.get(name, {})}) for name, kw in jobs.items()]
        + ([("refused", REFUSED)] if w == 4 else []))
        for w, jobs in RUNS.items()}
    ds = load_dataset("mnist", small=True)
    ref = {name: run_federated(ds, FedConfig(**kw), device="cpu")
           for name, kw in RUNS[2].items()}
    return ref, {w: _results(s, w) for w, s in started.items()}, tmp


@pytest.mark.parametrize("world, job", CASES)
def test_mesh_run_matches_one_process(worlds, world, job):
    ref, got, _ = worlds
    h = got[world][0][job]["history"]
    want = ref[job]
    assert h["acc"] == want["acc"], (h["acc"], want["acc"])
    keys = ["loss"] + [k for k in ("teacher_loss", "student_loss",
                                   "train_loss") if k in want]
    for key in keys:
        np.testing.assert_allclose(h[key], want[key], rtol=1e-6, atol=0,
                                   err_msg=key)
    for key in ("participants", "round", "pack", "stragglers",
                "stale_merged", "labels_history"):
        assert h.get(key) == want.get(key), key


@pytest.mark.parametrize("world, job", CASES)
def test_every_rank_holds_the_same_run(worlds, world, job):
    _, got, _ = worlds
    first = got[world][0][job]
    assert len(first["params"]) == RUNS[world][job]["rounds"]
    for rank in range(world):
        held = got[world][rank][job]["slots_held"]
        assert set(held) == {8 // world}, (rank, held)
    for rank in range(1, world):
        other = got[world][rank][job]
        assert other["history"] == first["history"], rank
        for rnd, (a, b) in enumerate(zip(first["params"], other["params"])):
            for k in a:
                np.testing.assert_array_equal(a[k], b[k],
                                              err_msg=f"{rank} {rnd} {k}")


def test_only_rank0_writes_checkpoints(worlds):
    _, got, tmp = worlds
    saved = sorted(p.name for p in (tmp / "ckpt").iterdir())
    assert saved and all("round_" in name for name in saved), saved


def test_a_world_that_does_not_divide_the_slots_is_refused(worlds):
    _, got, _ = worlds
    for rank in range(4):
        err = got[4][rank]["refused"]["error"]
        assert "a world of 4 ranks cannot host 2 devices x pack=3 = 6 " \
               "slots" in err, err


def test_client_stack_specs_and_divisibility():
    class Mesh:                   # the two DeviceMesh calls the helpers make
        mesh_dim_names = ("clients",)

        def size(self, dim=None):
            return 4

        def get_local_rank(self, dim=None):
            return 1

    tree = {"w": torch.zeros(8, 3), "opt": (torch.zeros(6), np.zeros(4))}
    specs = shardings.client_stack_specs(tree, Mesh())
    assert [str(p) for p in specs["w"]] == ["S(0)"]
    assert shardings.check_divisible(tree, specs, Mesh()) == ["opt/0"]
    block = shardings.local_block({"w": torch.arange(8)}, Mesh())
    assert block["w"].tolist() == [2, 3]
    Mesh.mesh_dim_names = ("data",)
    with pytest.raises(ValueError, match="no 'clients'"):
        shardings.client_stack_specs(tree, Mesh())


def test_a_launch_of_several_ranks_without_a_group_raises(monkeypatch):
    """``WORLD_SIZE`` above 1 with no process group would run the whole
    run on every rank: the engine refuses; with no ``WORLD_SIZE`` (or 1)
    there is no mesh and the run stays in one process."""
    from repro_torch.fed import sharded
    from repro_torch.launch import mesh
    assert sharded.make_client_mesh(2, pack=4, device="cpu") is None
    monkeypatch.setenv("WORLD_SIZE", "1")
    assert mesh.is_rank0() and not mesh.distributed()
    monkeypatch.setenv("WORLD_SIZE", "2")
    with pytest.raises(RuntimeError, match="WORLD_SIZE=2"):
        sharded.make_client_mesh(2, pack=4, device="cpu")
    with pytest.raises(RuntimeError, match="init_process_group"):
        run_federated(load_dataset("mnist", small=True),
                      FedConfig(**JOBS["fedavg 1 wave"]), device="cpu")


# ------------------------------------------------------- mesh operators
S, PACK, W = 8, 2, 4
LABELS = np.asarray([0, 0, 1, 0])


def _operator_inputs():
    r = np.random.default_rng(7)
    x = {"a": r.standard_normal((W, 3, 5)).astype(np.float32),
         "b": r.standard_normal((W, 7)).astype(np.float32),
         "n": np.asarray([3, 1, 4, 2], np.int32)}
    stack = {"a": r.standard_normal((S, 3, 5)).astype(np.float32),
             "b": r.standard_normal((S, 7)).astype(np.float32),
             "n": np.arange(S, dtype=np.int32)}
    sync = np.eye(S, dtype=np.float32)
    for block in ([0, 1, 4], [2, 5, 6]):        # slots 3 and 7 alone
        sync[np.ix_(block, block)] = 1.0 / len(block)
    row = r.random(S).astype(np.float32)
    row[3] = 0.0
    row /= row.sum()
    return {"labels": LABELS, "x": x, "sizes": np.asarray([5, 9, 2, 7]),
            "stack": stack, "sync": sync, "row": row,
            "slots": np.asarray([6, 1, 3])}


JAX_OPERATORS = """
import os
os.environ["XLA_FLAGS"] = "--xla_force_host_platform_device_count=4"
import numpy as np
import jax
from jax.sharding import PartitionSpec as P
from repro.core import cluster_collectives as cc
from repro.fed import sharded as sh

d = dict(np.load({path!r}))
x = {{k: d["x_" + k] for k in ("a", "b", "n")}}
stack = {{k: d["stack_" + k] for k in ("a", "b", "n")}}
floats = {{k: v for k, v in stack.items() if k != "n"}}
groups = cc.cluster_groups(d["labels"])
mesh = sh.make_client_mesh(4)
A = sh.AXIS


def run(fn, *args, specs=None):
    specs = specs or tuple(P(A) for _ in args)
    return jax.jit(sh.shard_map(fn, mesh, in_specs=specs,
                                out_specs=P(A)))(*args)


out = {{
    "intra": run(lambda t: cc.intra_cluster_mean(t, A, groups), x),
    "global": run(lambda t: cc.fedsikd_global_mean(t, A, groups), x),
    "global_size": run(lambda t: cc.fedsikd_global_mean(
        t, A, groups, weighting="size"), x),
    "teacher_sync": run(lambda t: cc.teacher_sync(t, A, groups), x),
    "fedavg": run(lambda t, n: cc.fedavg_mean(t, A, n),
                  {{k: v for k, v in x.items() if k != "n"}},
                  d["sizes"].astype(np.float32)),
    "broadcast": run(lambda t: cc.broadcast_from(t, A, 2), x),
    "broadcast_groups": run(lambda t: cc.broadcast_from(t, A, 1, groups), x),
    "packed_sync": run(lambda t, m: cc.packed_teacher_sync(t, A, m, pack=2),
                       stack, d["sync"], specs=(P(A), P())),
    "packed_gather": run(lambda t, m: cc.packed_weighted_gather(
        t, A, m, pack=2), floats, d["sync"], specs=(P(A), P())),
    "packed_mean": run(lambda t, w: cc.packed_weighted_mean(
        t, A, w, pack=2), floats, d["row"], specs=(P(A), P())),
}}
np.savez({out!r}, **{{f"{{op}}_{{k}}": np.asarray(v)
                      for op, t in out.items() for k, v in t.items()}})
print("OK")
"""


def test_mesh_operators_match_jax_shard_map(tmp_path):
    inputs = _operator_inputs()
    flat = {"labels": inputs["labels"], "sizes": inputs["sizes"],
            "sync": inputs["sync"], "row": inputs["row"],
            **{f"x_{k}": v for k, v in inputs["x"].items()},
            **{f"stack_{k}": v for k, v in inputs["stack"].items()}}
    np.savez(tmp_path / "in.npz", **flat)
    started = _start(worker.operators, W, tmp_path, inputs)
    res = run_script(JAX_OPERATORS.format(path=str(tmp_path / "in.npz"),
                                          out=str(tmp_path / "jax.npz")))
    got = _results(started, W)
    assert res.returncode == 0 and "OK" in res.stdout, res.stderr[-3000:]
    want = dict(np.load(tmp_path / "jax.npz"))
    per = S // W
    for op in ("intra", "global", "global_size", "teacher_sync", "fedavg",
               "broadcast", "broadcast_groups"):
        for rank in range(W):
            for k, v in got[rank][op].items():
                np.testing.assert_allclose(v, want[f"{op}_{k}"][rank],
                                           rtol=1e-6, atol=1e-6,
                                           err_msg=f"{op} {k} rank {rank}")
                assert v.dtype == want[f"{op}_{k}"].dtype, (op, k)
    for op in ("packed_sync", "packed_gather", "packed_mean"):
        for rank in range(W):
            for k, v in got[rank][op].items():
                np.testing.assert_allclose(
                    v, want[f"{op}_{k}"][rank * per:(rank + 1) * per],
                    rtol=1e-6, atol=1e-6, err_msg=f"{op} {k} rank {rank}")
    for rank in range(W):
        for k, v in got[rank]["slots"].items():
            np.testing.assert_array_equal(
                v, inputs["stack"][k][inputs["slots"]], err_msg=k)
