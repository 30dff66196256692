"""Federated algorithms on a mesh of ranks: the twin of
``examples/sharded_collectives.py`` on the PyTorch port, one process a
rank over ``torch.distributed`` (NCCL on cards, gloo on the CPU).

Part 1 shows the raw collective pattern with one client a rank: the
intra-cluster grouped mean and the two-level global mean
(``core.cluster_collectives``).  Part 2 runs the FULL FedSiKD algorithm
(Alg. 1) on the mesh: per-cluster teacher replicas, the KD-establishment
warm-up, the fused KD steps, the grouped student aggregation, with the
8 clients' slots spread over the ranks.  Part 3 breaks the clients ==
ranks coupling: 24 clients, 3 lanes a device of 8, with stratified
partial participation (12 sampled clients a round) through the same
round program.  Part 4 runs a baseline (FedAvg) through the same packed
runtime.  The world must divide each part's slots (8 and 24).

  # the CPU: spawns --world gloo ranks (default 8)
  PYTHONPATH=src python examples/sharded_collectives_torch.py --device cpu --world 4
  # cards: one NCCL rank a card
  PYTHONPATH=src torchrun --nproc-per-node N examples/sharded_collectives_torch.py

Without ``torchrun`` and with ``--device cuda`` (the default) it spawns
``--world`` NCCL ranks (default: every card), one card each; without a
card it raises unless given ``--device cpu``.
"""
import argparse
import os
import tempfile

import torch
import torch.distributed as dist
import torch.multiprocessing as mp

from repro_torch.core import cluster_collectives as cc
from repro_torch.core import kmeans, stats
from repro_torch.data.pipeline import make_client_shards
from repro_torch.data.synthetic import load_dataset
from repro_torch.fed.algorithms.clustered_kd import stat_features
from repro_torch.fed.rounds import FedConfig, resolve_device, run_federated
from repro_torch.launch.mesh import from_rank0, make_fed_client_mesh


def parts(device) -> dict:
    """The four parts on this rank of the caller's process group; rank 0
    prints.  Returns what this rank saw."""
    rank, world = dist.get_rank(), dist.get_world_size()
    say = print if rank == 0 else (lambda *a, **k: None)
    ds = load_dataset("mnist", small=True)

    # ---- part 1: the raw grouped-collective operators (Alg. 1 lines
    # 16-18), one client a rank; rank 0 clusters the clients' statistics
    shards = make_client_shards(ds, world, 0.3, seed=0)

    def cluster():
        feats = stats.standardize(stat_features(
            shards, FedConfig(num_clients=world), device=device))
        return kmeans.kmeans(0, feats, min(3, world)).assignments.cpu() \
            .numpy()

    cluster_of = from_rank0(cluster)
    say("cluster assignment:", cluster_of.tolist())
    mesh = make_fed_client_mesh(world, device_type=torch.device(device).type)
    groups = cc.cluster_groups(cluster_of)
    x = {"w": torch.tensor([float(rank)], device=device)}
    got = {}
    for name, tree in (("per-cluster means",
                        cc.intra_cluster_mean(x, mesh, groups)),
                       ("two-level global mean",
                        cc.fedsikd_global_mean(x, mesh, groups))):
        every = [None] * world
        dist.all_gather_object(every, float(tree["w"]))
        say(f"{name}:", every)
        got[name] = every

    # ---- part 2: the full Alg. 1 on the mesh (teachers + fused KD)
    say(f"FedSiKD on a mesh of {world} ranks (teacher replicas + fused KD "
        "steps):")
    got["fedsikd"] = run_federated(ds, FedConfig(
        algorithm="fedsikd", engine="sharded", num_clients=8, alpha=0.3,
        rounds=3, local_epochs=1, teacher_warmup_epochs=2, batch_size=32,
        num_clusters=3, kd_temperature=3.0, kd_impl="fused", seed=0),
        device=device, progress=True)
    say("accuracy curve:", ["%.3f" % a for a in got["fedsikd"]["acc"]])

    # ---- part 3: C >> ranks — client packing + partial participation
    say(f"packed FedSiKD: 24 clients, 8 devices x pack=3 on {world} ranks, "
        "12 sampled per round:")
    got["packed"] = run_federated(ds, FedConfig(
        algorithm="fedsikd", engine="sharded", num_clients=24, pack=3,
        n_devices=8, participation="stratified", clients_per_round=12,
        alpha=0.5, rounds=3, local_epochs=1, teacher_warmup_epochs=2,
        batch_size=32, num_clusters=3, seed=0), device=device, progress=True)
    say("accuracy curve:", ["%.3f" % a for a in got["packed"]["acc"]],
        "participants/round:", got["packed"]["participants"])

    # ---- part 4: a baseline on the SAME packed runtime: 24 FedAvg
    # clients, one all-clients example-weighted mean a round
    say(f"packed FedAvg: 24 clients, 8 devices x pack=3 on {world} ranks:")
    got["fedavg"] = run_federated(ds, FedConfig(
        algorithm="fedavg", engine="sharded", num_clients=24, pack=3,
        alpha=0.5, rounds=3, local_epochs=1, batch_size=32, seed=0),
        device=device, progress=True)
    say("accuracy curve:", ["%.3f" % a for a in got["fedavg"]["acc"]])
    return got


def _spawned(rank, world, device_type, store, out):
    """One rank of a spawned world: joins it over a ``FileStore``, runs the
    parts, and rank 0 saves what it saw for the parent."""
    device = (torch.device("cuda", rank) if device_type == "cuda"
              else torch.device("cpu"))
    if device_type == "cuda":
        torch.cuda.set_device(device)
    else:
        torch.set_num_threads(1)
    dist.init_process_group("nccl" if device_type == "cuda" else "gloo",
                            store=dist.FileStore(store, world), rank=rank,
                            world_size=world)
    try:
        got = parts(device)
        if rank == 0:
            torch.save(got, out)
    finally:
        dist.destroy_process_group()


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--device", default="cuda", choices=("cuda", "cpu"),
                    help="torch device type (raises without a card unless "
                         "cpu)")
    ap.add_argument("--world", type=int, default=None,
                    help="ranks to spawn without torchrun (default: 8 on "
                         "the CPU, every card on cuda)")
    args = ap.parse_args(argv)
    resolve_device(args.device)
    if "LOCAL_RANK" in os.environ:          # under torchrun: this process
        local = int(os.environ["LOCAL_RANK"])
        if args.device == "cuda":
            torch.cuda.set_device(local)
            device = torch.device("cuda", local)
        else:
            device = torch.device("cpu")
        dist.init_process_group("nccl" if args.device == "cuda" else "gloo")
        try:
            return parts(device)
        finally:
            dist.destroy_process_group()
    world = args.world or (torch.cuda.device_count() if args.device == "cuda"
                           else 8)
    if args.device == "cuda" and world > torch.cuda.device_count():
        raise ValueError(f"--world {world} needs {world} cards, have "
                         f"{torch.cuda.device_count()}")
    with tempfile.TemporaryDirectory() as tmp:
        out = os.path.join(tmp, "rank0.pt")
        mp.start_processes(_spawned, args=(world, args.device,
                                           os.path.join(tmp, "store"), out),
                           nprocs=world, start_method="spawn")
        return torch.load(out, weights_only=False)


if __name__ == "__main__":
    main()
