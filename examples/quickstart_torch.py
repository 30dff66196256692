"""Quickstart on the PyTorch port: FedSiKD end to end on the MNIST twin.
The twin of ``examples/quickstart.py``; it imports only ``repro_torch``.

Phases (paper Alg. 1): clients share (mu, sigma, gamma) -> server k-means
with metric-voted K -> per-cluster teacher/student KD -> two-level averaging.

  PYTHONPATH=src python examples/quickstart_torch.py [--device cuda|cpu]

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
    cfg = FedConfig(
        algorithm="fedsikd",
        num_clients=8,
        alpha=0.5,              # Dirichlet skew (lower = more non-iid)
        rounds=3,
        local_epochs=2,
        kd_temperature=3.0,
        kd_alpha=0.5,
    )
    print(f"FedSiKD on {ds.name} twin: {cfg.num_clients} clients, "
          f"alpha={cfg.alpha}, {cfg.rounds} rounds, device={args.device}")
    h = run_federated(ds, cfg, device=args.device, progress=True)
    print(f"clusters selected: K={h['num_clusters']}")
    print(f"accuracy curve: {['%.3f' % a for a in h['acc']]}")
    return h


if __name__ == "__main__":
    main()
