"""Semi-async rounds on the PyTorch port: stragglers, bounded staleness,
decayed merges (DESIGN.md §12).  The twin of ``examples/async_stragglers.py``;
it imports only ``repro_torch``.

The paper's motivation is the CONSTRAINED client: beside statistical skew,
real deployments face system heterogeneity, slow devices whose updates
arrive rounds late.  This example runs FedSiKD at the paper's hardest skew
(alpha = 0.1) with the speed model on: 40% of clients are persistent
stragglers whose updates land >= 1 round late, buffered by the driver and
merged under the polynomial staleness decay ``(1 + s)^-a``.

The sweep varies the staleness bound ``max_staleness`` in {0, 2, 4}:

- ``0``: every late update is dropped at arrival (deadline-only FL:
  stragglers train but never contribute);
- ``2``: the default bound: updates up to 2 rounds stale still merge,
  decayed;
- ``4``: a lax bound that admits almost every arrival.

Teachers stay synchronous throughout: FedSiKD hosts them at the cluster
edge, so a slow DEVICE delays only the student update's arrival.

  PYTHONPATH=src python examples/async_stragglers_torch.py [--device cuda|cpu]

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
    common = dict(algorithm="fedsikd", engine="sharded", num_clients=16,
                  pack=2, alpha=0.1, rounds=6, local_epochs=1,
                  teacher_warmup_epochs=1, batch_size=32, num_clusters=2,
                  seed=0)

    print(f"synchronous reference (no speed model), device={args.device}:")
    h_sync = run_federated(ds, FedConfig(**common), device=args.device,
                           progress=True)

    results = {}
    for ms in (0, 2, 4):
        print(f"\nasync, straggler_frac=0.4, max_staleness={ms}:")
        h = run_federated(ds, FedConfig(async_mode=True, straggler_frac=0.4,
                                        max_staleness=ms, **common),
                          device=args.device, progress=True)
        results[ms] = h

    print("\nmax_staleness sweep at alpha=0.1, 40% stragglers:")
    print(f"  {'bound':>10s} {'final acc':>10s} {'stragglers':>11s} "
          f"{'merged':>7s} {'dropped':>8s} {'in flight':>10s}")
    print(f"  {'sync ref':>10s} {h_sync['acc'][-1]:10.4f} "
          f"{'-':>11s} {'-':>7s} {'-':>8s} {'-':>10s}")
    for ms, h in results.items():
        print(f"  {ms:10d} {h['acc'][-1]:10.4f} "
              f"{sum(h['stragglers']):11d} {sum(h['stale_merged']):7d} "
              f"{sum(h['stale_dropped']):8d} {h['buffered'][-1]:10d}")

    # the accounting always balances: pushed = merged + dropped + in flight
    for ms, h in results.items():
        assert sum(h["stragglers"]) == (sum(h["stale_merged"])
                                        + sum(h["stale_dropped"])
                                        + h["buffered"][-1]), ms
    # max_staleness only relaxes the drop rule: a laxer bound merges at
    # least as many updates
    assert sum(results[4]["stale_merged"]) >= sum(results[2]["stale_merged"])
    assert sum(results[0]["stale_merged"]) == 0
    return h_sync, results


if __name__ == "__main__":
    main()
