"""Rank workers of ``tests/test_torch_mesh.py``.

``torch.multiprocessing`` spawns each worker once a rank.  It joins a gloo
world over a ``FileStore`` under the test's ``tmp_path`` (no port, so
parallel test workers cannot clash), with one thread, runs its jobs on the
CPU and saves what it saw to ``out/rank{r}.pt`` for the test to compare.
"""
import datetime

import numpy as np
import torch
import torch.distributed as dist


def _join(rank, world, store):
    torch.set_num_threads(1)
    dist.init_process_group("gloo", store=dist.FileStore(store, world),
                            rank=rank, world_size=world,
                            timeout=datetime.timedelta(seconds=120))


def _student(alg) -> dict:
    """The strategy's global model as numpy copies."""
    params = getattr(alg, "sp_global", None) or alg.global_params
    return {k: v.detach().cpu().numpy().copy() for k, v in params.items()}


def runs(rank, world, store, jobs, out):
    """``jobs``: ``(name, FedConfig kwargs)``.  Each runs through
    ``run_federated`` on the small MNIST twin; the worker keeps its history
    and the global model after each round and the number of a wave's slots
    this rank held, or the text of the ``ValueError`` it raised."""
    _join(rank, world, store)
    try:
        from repro_torch.data.synthetic import load_dataset
        from repro_torch.fed import driver
        from repro_torch.fed.rounds import FedConfig, run_federated

        ds = load_dataset("mnist", small=True)
        record = driver.RoundDriver._record
        results = {}
        for name, kw in jobs:
            seen, held = [], []

            def snapshot(self, history, rnd, seen=seen, held=held):
                seen.append(_student(self.alg))
                held.append(self.alg.n_local)
                return record(self, history, rnd)

            driver.RoundDriver._record = snapshot
            try:
                h = run_federated(ds, FedConfig(**kw), device="cpu")
                results[name] = {"history": h, "params": seen,
                                 "slots_held": held}
            except ValueError as e:
                results[name] = {"error": str(e)}
            finally:
                driver.RoundDriver._record = record
        torch.save(results, f"{out}/rank{rank}.pt")
    finally:
        dist.destroy_process_group()


def operators(rank, world, store, inputs, out):
    """The mesh operators of ``core.cluster_collectives`` on this rank's
    share of ``inputs`` (numpy; full stacks, one row a rank for the
    unpacked operators, ``pack`` rows for the packed ones)."""
    _join(rank, world, store)
    try:
        from repro_torch.core import cluster_collectives as cc
        from repro_torch.launch.mesh import make_fed_client_mesh
        from repro_torch.launch.shardings import local_block

        mesh = make_fed_client_mesh(world, pack=1, device_type="cpu")
        groups = cc.cluster_groups(inputs["labels"])
        one = {k: torch.from_numpy(np.asarray(v[rank]))
               for k, v in inputs["x"].items()}
        got = {
            "intra": cc.intra_cluster_mean(one, mesh, groups),
            "global": cc.fedsikd_global_mean(one, mesh, groups),
            "global_size": cc.fedsikd_global_mean(one, mesh, groups,
                                                  weighting="size"),
            "teacher_sync": cc.teacher_sync(one, mesh, groups),
            "fedavg": cc.fedavg_mean(
                {k: v for k, v in one.items() if k != "n"}, mesh,
                torch.tensor(float(inputs["sizes"][rank]))),
            "broadcast": cc.broadcast_from(one, mesh, 2),
            "broadcast_groups": cc.broadcast_from(one, mesh, 1, groups),
        }
        stack = {k: torch.from_numpy(v) for k, v in inputs["stack"].items()}
        block = local_block(stack, mesh)
        floats = {k: v for k, v in block.items() if k != "n"}
        got["packed_sync"] = cc.packed_teacher_sync(
            block, torch.from_numpy(inputs["sync"]), mesh=mesh)
        got["packed_gather"] = cc.packed_weighted_gather(
            floats, torch.from_numpy(inputs["sync"]), mesh=mesh)
        got["packed_mean"] = cc.packed_weighted_mean(
            floats, torch.from_numpy(inputs["row"]), mesh=mesh)
        got["slots"] = cc.gather_slots(block, inputs["slots"], mesh=mesh)
        torch.save({k: {n: np.asarray(t) for n, t in v.items()}
                    for k, v in got.items()}, f"{out}/rank{rank}.pt")
    finally:
        dist.destroy_process_group()
