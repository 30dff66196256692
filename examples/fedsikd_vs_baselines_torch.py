"""FedSiKD against the paper's baselines (FedAvg, FL+HC, RandomCluster,
FedProx) at a chosen skew level on the PyTorch port: the paper's Fig. 3
comparison in miniature.  The twin of ``examples/fedsikd_vs_baselines.py``;
it imports only ``repro_torch``.

With ``--engine sharded`` every algorithm except FL+HC runs on the packed
engine (all participating clients as lanes of one stacked program on the
device, C = pack x the lanes' groups); FL+HC runs on the loop engine (its
clustering pre-round is host-sequential).

  PYTHONPATH=src python examples/fedsikd_vs_baselines_torch.py [alpha] \\
      [--engine loop|sharded] [--pack 2] [--device cuda|cpu]

The default device is ``cuda``; without a card the example raises unless
given ``--device cpu``.
"""
import argparse
import time

from repro_torch.data.synthetic import load_dataset
from repro_torch.fed.rounds import SHARDED_ALGORITHMS, FedConfig, run_federated


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("alpha", nargs="?", type=float, default=0.5)
    ap.add_argument("--engine", default="loop", choices=["loop", "sharded"])
    ap.add_argument("--pack", type=int, default=2,
                    help="client lanes per device group (sharded engine)")
    ap.add_argument("--device", default="cuda",
                    help="torch device (raises without a card unless cpu)")
    args = ap.parse_args(argv)

    ds = load_dataset("mnist", small=True)
    print(f"dataset={ds.name} twin, alpha={args.alpha}, 8 clients, 3 rounds, "
          f"engine={args.engine}, device={args.device}")
    out = {}
    for alg in ("fedsikd", "random", "flhc", "fedavg", "fedprox"):
        engine = (args.engine if alg in SHARDED_ALGORITHMS else "loop")
        t0 = time.time()
        cfg = FedConfig(algorithm=alg, engine=engine,
                        pack=args.pack if engine == "sharded" else 1,
                        num_clients=8, alpha=args.alpha, rounds=3,
                        local_epochs=2,
                        num_clusters=None if alg == "fedsikd" else 3)
        h = run_federated(ds, cfg, device=args.device)
        out[alg] = h
        print(f"  {alg:9s} [{engine:7s}] "
              f"acc={['%.3f' % a for a in h['acc']]} "
              f"loss={h['loss'][-1]:.3f} "
              f"K={h.get('num_clusters', '-')} ({time.time()-t0:.0f}s)")
    return out


if __name__ == "__main__":
    main()
