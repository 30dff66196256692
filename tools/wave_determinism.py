#!/usr/bin/env python3
"""Hold the packed engine's 3-wave rounds to one wave of the same cohort
on one NVIDIA GPU, with and without the two measures that make them agree:

    python3 tools/wave_determinism.py

The configuration is ``chip_smoke.py``'s ``scale_path`` (full MNIST twin,
40 base clients, a universe of 100,000, stratified cohorts of 120 in 3
waves of 40 slots under the guards, against one wave of 120; 4 rounds).
Two modes, run in the order before, after, after, before:

- ``before``: cuDNN's default (non-deterministic) algorithms and the
  teacher sync as the plain product ``table @ x``
  (``cluster_collectives.packed_weighted_gather``);
- ``after``: the package as it is (``run_federated`` holds
  ``torch.backends.cudnn.deterministic`` for a packed run;
  ``packed_teacher_sync`` averages about each slot's first cluster
  member).

Prints one JSON line per run (eval accuracy and loss per round, steady
seconds a round over rounds 2-4), then one summary line with the card's
name and power limit, each mode's accuracy gap and relative loss gap of 3
waves against one wave per round, and whether a mode's two passes agree
bit for bit.  It changes no file of the repository.
"""
from __future__ import annotations

import contextlib
import json
import statistics
import subprocess
import sys
from pathlib import Path

sys.path.insert(0, str(Path(__file__).resolve().parents[1] / "src"))

UNIVERSE, COHORT, PACK, ROUNDS = 100_000, 120, 40, 4
BASE = dict(algorithm="fedsikd", engine="sharded", rounds=ROUNDS,
            participation="stratified", clients_per_round=COHORT,
            universe=UNIVERSE, teacher_data="leader")
RUNS = {"3 waves": dict(pack=PACK, n_devices=1, guards=True),
        "one wave": dict(pack=COHORT, n_devices=None)}


@contextlib.contextmanager
def mode(name: str):
    """``after``: nothing changed; ``before``: the earlier behaviour."""
    from repro_torch.core import cluster_collectives as cc
    from repro_torch.fed import rounds
    from repro_torch.tree import tree_map
    if name == "after":
        yield
        return
    sync, det = cc.packed_teacher_sync, rounds.deterministic_cudnn

    def product_sync(tree, table):
        return tree_map(lambda x, y: y if x.is_floating_point() else x,
                        tree, cc.packed_weighted_gather(tree, table))

    cc.packed_teacher_sync = product_sync
    rounds.deterministic_cudnn = contextlib.nullcontext
    try:
        yield
    finally:
        cc.packed_teacher_sync, rounds.deterministic_cudnn = sync, det


def main() -> int:
    import torch
    if not torch.cuda.is_available():
        print("wave_determinism: needs a CUDA device", file=sys.stderr)
        return 2
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    from repro_torch.data.synthetic import load_dataset
    from repro_torch.fed.rounds import FedConfig, run_federated
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        timeout=60, check=True).stdout.strip().splitlines()[0]
    ds = load_dataset("mnist")
    seen: dict = {}
    for p, name in enumerate(("before", "after", "after", "before")):
        for run, kw in RUNS.items():
            with mode(name):
                h = run_federated(ds, FedConfig(**{**BASE, **kw}))
            row = {"mode": name, "pass": p, "run": run, "acc": h["acc"],
                   "loss": h["loss"],
                   "steady_s_per_round":
                   statistics.fmean(h["round_seconds"][1:])}
            print(json.dumps(row), flush=True)
            seen.setdefault(name, []).append(row)
    summary = {"card": smi}
    for name, rows in seen.items():
        by = {}
        for r in rows:
            by.setdefault(r["run"], []).append(r)
        w3, w1 = by["3 waves"], by["one wave"]
        summary[name] = {
            "acc_gap": [[abs(a - b) for a, b in zip(x["acc"], y["acc"])]
                        for x, y in zip(w3, w1)],
            "loss_rel_gap": [[abs(a - b) / abs(b)
                              for a, b in zip(x["loss"], y["loss"])]
                             for x, y in zip(w3, w1)],
            "repeats_bit_for_bit": {
                run: rs[0]["acc"] == rs[1]["acc"]
                and rs[0]["loss"] == rs[1]["loss"]
                for run, rs in by.items()},
            "steady_s_per_round": {run: [r["steady_s_per_round"] for r in rs]
                                   for run, rs in by.items()}}
    print(json.dumps(summary), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
