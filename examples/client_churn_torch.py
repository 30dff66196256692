"""Client churn on the PyTorch port: dynamic joins/leaves + periodic
re-clustering on the packed engine (DESIGN.md §11).  The twin of
``examples/client_churn.py``; it imports only ``repro_torch``.

The paper's clustering story is incremental ("as clients join the system,
they securely share relevant statistics about their data distribution",
§IV-A) and real federated populations churn.  This example runs FedSiKD
on the packed engine (16 client slots on one device, pack=2) through a
churn scenario:

- 12 clients are online from round 1; 4 more JOIN at rounds 2 and 4
  (``join_schedule``);
- every active client has a 5% chance per round of LEAVING for good
  (``leave_rate``: permanent, unlike ``dropout_rate``'s one-round failure);
- the server re-clusters on every membership change AND every 2 rounds
  (``recluster_every``): the batched statistics recompute the roster's
  (mu, sigma, gamma), k-means warm-starts from the previous centroids,
  each cluster's teacher migrates from the nearest surviving centroid's
  teacher, and the scheduler and slot staging are rebuilt; the slots are
  sized for the full client universe up front.

  PYTHONPATH=src python examples/client_churn_torch.py [--device cuda|cpu]

The default device is ``cuda``; without a card the example raises unless
given ``--device cpu``.
"""
import argparse

from repro_torch.data.synthetic import load_dataset
from repro_torch.fed.rounds import FedConfig, run_federated


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--device", default="cuda",
                    help="torch device (raises without a card unless cpu)")
    args = ap.parse_args(argv)
    ds = load_dataset("mnist", small=True)
    cfg = FedConfig(algorithm="fedsikd", engine="sharded",
                    num_clients=16, pack=2, alpha=1.0, rounds=5,
                    local_epochs=1, teacher_warmup_epochs=1, batch_size=32,
                    num_clusters=2, seed=0,
                    join_schedule=((2, 2), (4, 2)),
                    leave_rate=0.05, recluster_every=2)
    print("FedSiKD with client churn on the packed engine "
          f"(C={cfg.num_clients}, pack={cfg.pack}, device={args.device}):")
    h = run_federated(ds, cfg, device=args.device, progress=True)

    print("\nroster + re-clustering timeline:")
    for rnd, labels in h["labels_history"]:
        online = sum(1 for l in labels if l >= 0)
        tag = "initial clustering" if rnd == 0 else f"re-cluster @ round {rnd}"
        print(f"  {tag:24s} {online:2d} clients online   labels={labels}")
    recl = [r for r, v in zip(h["round"], h["recluster"]) if v]
    print(f"re-cluster rounds: {recl}")
    print(f"participants/round: {h['participants']}")
    print(f"final: acc={h['acc'][-1]:.4f} loss={h['loss'][-1]:.4f}")
    assert len(h["labels_history"]) >= 3    # initial + both join events
    assert h["participants"][-1] >= 12
    return h


if __name__ == "__main__":
    main()
