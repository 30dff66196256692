"""Fault-tolerant federated runs on the PyTorch port: kill-and-resume +
client dropout.  The twin of ``examples/fault_tolerance.py``; it imports
only ``repro_torch``.

Demonstrates DESIGN.md §9 end to end on the MNIST twin:

1. a FedSiKD run with per-round checkpoints and a 25% per-round client
   dropout rate is "killed" after 3 of 6 rounds;
2. the same config restarts with ``resume=True`` and finishes rounds 4-6
   from the round-3 snapshot;
3. the resumed history is verified BIT-IDENTICAL to an uninterrupted
   6-round run: same plans, same batches, same random streams, same floats.

  PYTHONPATH=src python examples/fault_tolerance_torch.py [--device cuda|cpu]

The default device is ``cuda``; without a card the example raises unless
given ``--device cpu``.
"""
import argparse
import tempfile

from repro_torch.data.synthetic import load_dataset
from repro_torch.fed import fedstate
from repro_torch.fed.rounds import FedConfig, run_federated


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--device", default="cuda",
                    help="torch device (raises without a card unless cpu)")
    args = ap.parse_args(argv)
    ds = load_dataset("mnist", small=True)
    common = dict(algorithm="fedsikd", num_clients=6, alpha=1.0, rounds=6,
                  local_epochs=1, teacher_warmup_epochs=1, batch_size=64,
                  num_clusters=2, participation="stratified",
                  clients_per_round=4, dropout_rate=0.25, seed=0)

    print("reference: 6 uninterrupted rounds (stratified, 25% dropout), "
          f"device={args.device}")
    h_full = run_federated(ds, FedConfig(**common), device=args.device,
                           progress=True)

    with tempfile.TemporaryDirectory(prefix="fedsikd_ckpt_") as ckpt_dir:
        print(f"\nrun 1: 3 rounds, checkpointing every round -> {ckpt_dir}")
        run_federated(ds, FedConfig(**{**common, "rounds": 3},
                                    ckpt_dir=ckpt_dir, ckpt_every=1),
                      device=args.device, progress=True)
        print("   ...killed. latest checkpoint: "
              f"round {fedstate.latest_round(ckpt_dir)}")

        print("\nrun 2: same config, resume=True -> finishes rounds 4-6")
        h_res = run_federated(ds, FedConfig(**common, ckpt_dir=ckpt_dir,
                                            resume=True),
                              device=args.device, progress=True)

    assert h_res["acc"] == h_full["acc"], "resume broke bit-parity!"
    assert h_res["participants"] == h_full["participants"]
    print("\nresumed history is bit-identical to the uninterrupted run")
    print(f"per-round survivors (of {common['clients_per_round']} invited): "
          f"{h_res['participants']}")
    return h_full, h_res


if __name__ == "__main__":
    main()
