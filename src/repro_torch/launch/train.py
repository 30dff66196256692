"""Training launcher of the port: the twin of ``repro.launch.train``, with
the same modes and flags plus ``--device`` (default ``cuda``; a run
without a card raises unless given ``--device cpu``).

Two modes:
  fl   — the paper's federated pipeline on the CNN models (default):
         PYTHONPATH=src python -m repro_torch.launch.train fl \\
             --dataset mnist --algorithm fedsikd --alpha 0.5 --rounds 5 \\
             --ckpt out/run
  lm   — LM training loop on a registered architecture (smoke or full
         config), one device, with checkpoint/resume of the params in the
         JAX package's ``lm.npz`` format:
         PYTHONPATH=src python -m repro_torch.launch.train lm \\
             --arch qwen2.5-3b --smoke --steps 50
"""
from __future__ import annotations

import argparse
import dataclasses
import json
import time
from pathlib import Path

import torch

from repro_torch import checkpoint as ckpt
from repro_torch.configs import get_config
from repro_torch.data.pipeline import token_stream
from repro_torch.data.synthetic import load_dataset
from repro_torch.fed.fedstate import json_safe
from repro_torch.fed.rounds import FedConfig, resolve_device, run_federated
from repro_torch.launch import steps as st
from repro_torch.models import encdec as ed
from repro_torch.models import transformer as tf
from repro_torch.models.layers import DTYPES


def parse_join_schedule(spec):
    """``"3:2,6:2"`` -> ((3, 2), (6, 2)): count clients join at that round."""
    if not spec:
        return None
    try:
        return tuple((int(r), int(c)) for r, c in
                     (tok.split(":") for tok in spec.split(",")))
    except ValueError as e:
        raise SystemExit(
            "--join-schedule wants 'round:count[,round:count...]', "
            f"got {spec!r} ({e})")


def run_fl(args):
    device = resolve_device(args.device)
    ds = load_dataset(args.dataset, small=args.small)
    cfg = FedConfig(algorithm=args.algorithm, engine=args.engine,
                    num_clients=args.clients, pack=args.pack,
                    universe=args.universe, n_devices=args.n_devices,
                    waves=args.waves,
                    alpha=args.alpha, rounds=args.rounds,
                    local_epochs=args.local_epochs, seed=args.seed,
                    num_clusters=args.clusters,
                    participation=args.participation,
                    clients_per_round=args.clients_per_round,
                    dropout_rate=args.dropout_rate,
                    join_schedule=parse_join_schedule(args.join_schedule),
                    leave_rate=args.leave_rate,
                    recluster_every=args.recluster_every,
                    async_mode=args.async_mode,
                    max_staleness=args.max_staleness,
                    staleness_decay=args.staleness_decay,
                    round_deadline=args.round_deadline,
                    straggler_frac=args.straggler_frac,
                    latency_dist=args.latency_dist,
                    # --ckpt doubles as the round-checkpoint dir: a killed
                    # run restarts with --resume (fed/fedstate.py)
                    ckpt_dir=args.ckpt, ckpt_every=args.ckpt_every,
                    ckpt_keep=args.ckpt_keep or None,
                    resume=args.resume,
                    donate=args.donate, prefetch=args.prefetch,
                    async_ckpt=args.async_ckpt, guards=args.guards)
    h = run_federated(ds, cfg, device=device, progress=True)
    print(f"final: acc={h['acc'][-1]:.4f} loss={h['loss'][-1]:.4f}")
    if args.ckpt:
        Path(args.ckpt).mkdir(parents=True, exist_ok=True)
        (Path(args.ckpt) / "history.json").write_text(json.dumps(json_safe(h)))
    return h


def run_lm(args):
    device = resolve_device(args.device)
    cfg = get_config(args.arch, smoke=args.smoke)
    if args.layers:
        cfg = dataclasses.replace(cfg, num_layers=args.layers)
    step, opt = st.make_train_step(cfg, lr=args.lr)
    init = ed.init_encdec if cfg.arch_type == "audio" else tf.init_lm
    params = init(args.seed, cfg, device=device)
    opt_state = opt.init(params)
    start = 0
    ck = Path(args.ckpt) / "lm.npz" if args.ckpt else None
    if ck and ck.exists():
        params = _to(ckpt.restore(ck, params), device)
        start = ckpt.load_meta(ck)["step"]
        print(f"resumed from step {start}")
    dt = DTYPES[cfg.dtype]
    losses = []
    t0 = time.time()
    for i, b in enumerate(token_stream(cfg.vocab_size, args.batch, args.seq,
                                       seed=args.seed + start,
                                       num_batches=args.steps)):
        batch = {k: torch.from_numpy(v).to(device) for k, v in b.items()}
        if cfg.arch_type == "audio":
            batch["frames"] = torch.zeros(
                (args.batch, max(args.seq // 4, 4), cfg.d_model), dtype=dt,
                device=device)
        if cfg.prefix_len:
            batch["prefix"] = torch.zeros(
                (args.batch, cfg.prefix_len, cfg.d_model), dtype=dt,
                device=device)
            batch["tokens"] = batch["tokens"][:, :-cfg.prefix_len]
            batch["labels"] = batch["labels"][:, :-cfg.prefix_len]
        params, opt_state, loss = step(params, opt_state, batch)
        losses.append(float(loss))
        if (i + 1) % args.log_every == 0:
            print(f"step {start+i+1}: loss={losses[-1]:.4f} "
                  f"({(time.time()-t0)/(i+1):.2f}s/step)", flush=True)
    if ck:
        ck.parent.mkdir(parents=True, exist_ok=True)
        ckpt.save(ck, params, step=start + args.steps)
        print(f"checkpointed at step {start + args.steps}")
    return params, losses


def _to(tree, device):
    if isinstance(tree, dict):
        return {k: _to(v, device) for k, v in tree.items()}
    return tree.to(device)


def build_parser() -> argparse.ArgumentParser:
    ap = argparse.ArgumentParser()
    sub = ap.add_subparsers(dest="mode", required=True)

    fl = sub.add_parser("fl")
    fl.add_argument("--device", default="cuda",
                    help="torch device (a run without a card raises unless "
                         "given --device cpu)")
    fl.add_argument("--dataset", default="mnist")
    fl.add_argument("--algorithm", default="fedsikd",
                    help="fedsikd | random | fedavg | fedprox | flhc (all "
                         "run on --engine loop; all but flhc also on "
                         "--engine sharded)")
    fl.add_argument("--engine", default="loop", choices=["loop", "sharded"])
    fl.add_argument("--pack", type=int, default=1,
                    help="client lanes per device in the packed engine "
                         "(C = devices x pack clients in one stacked "
                         "program)")
    fl.add_argument("--universe", type=int, default=None,
                    help="virtual client universe size (packed engine): "
                         "--clients base shards are aliased host-side up to "
                         "this population; sampling/clustering span the "
                         "full universe")
    fl.add_argument("--n-devices", type=int, default=None, dest="n_devices",
                    help="pin the slot layout to this many devices "
                         "regardless of cohort size: a cohort larger than "
                         "devices x pack streams through in waves")
    fl.add_argument("--waves", type=int, default=None,
                    help="explicit wave count per round (default: derived "
                         "from the cohort and the layout; waves x devices x "
                         "pack slots must cover the cohort)")
    fl.add_argument("--alpha", type=float, default=0.5)
    fl.add_argument("--rounds", type=int, default=5)
    fl.add_argument("--clients", type=int, default=16)
    fl.add_argument("--local-epochs", type=int, default=2)
    fl.add_argument("--clusters", type=int, default=None)
    fl.add_argument("--participation", default="full",
                    choices=["full", "uniform", "stratified"])
    fl.add_argument("--clients-per-round", type=int, default=None)
    fl.add_argument("--dropout-rate", type=float, default=0.0,
                    help="per-round client failure probability")
    fl.add_argument("--join-schedule", default=None,
                    help="client lifecycle: 'round:count,...' clients come "
                         "online at that round (fed/lifecycle.py)")
    fl.add_argument("--leave-rate", type=float, default=0.0,
                    help="per-round probability an active client leaves "
                         "FOR GOOD (vs --dropout-rate's one-round failure)")
    fl.add_argument("--async-mode", action="store_true", dest="async_mode",
                    help="semi-async rounds: stragglers' updates land late "
                         "and merge staleness-weighted (fed/driver.py)")
    fl.add_argument("--max-staleness", type=int, default=2,
                    help="drop buffered updates older than this many rounds")
    fl.add_argument("--staleness-decay", type=float, default=0.5,
                    help="a in the (1+s)^-a staleness weight decay")
    fl.add_argument("--round-deadline", type=float, default=1.0,
                    help="latency units per round (smaller => later arrivals)")
    fl.add_argument("--straggler-frac", type=float, default=0.0,
                    help="fraction of clients with straggler latency")
    fl.add_argument("--latency-dist", default="lognormal",
                    choices=["lognormal", "exp", "uniform"],
                    help="straggler excess-latency distribution")
    fl.add_argument("--recluster-every", type=int, default=0,
                    help="also re-cluster every N rounds (0: only on "
                         "join/leave events)")
    fl.add_argument("--small", action="store_true")
    fl.add_argument("--seed", type=int, default=0)
    fl.add_argument("--ckpt", default=None,
                    help="checkpoint dir: round_NNNNN.npz every --ckpt-every "
                         "rounds + history.json at the end")
    fl.add_argument("--ckpt-every", type=int, default=1)
    fl.add_argument("--ckpt-keep", type=int, default=3,
                    help="retain the newest N round snapshots (0 = all)")
    fl.add_argument("--resume", action="store_true",
                    help="resume from the latest round checkpoint in --ckpt")
    fl.add_argument("--donate", default=True,
                    action=argparse.BooleanOptionalAction,
                    help="kept for the JAX launcher's flags: the port's "
                         "FedConfig takes it, torch has no buffer donation")
    fl.add_argument("--prefetch", default=True,
                    action=argparse.BooleanOptionalAction,
                    help="stage round N+1's client shards on a background "
                         "thread while round N computes")
    fl.add_argument("--async-ckpt", action="store_true", dest="async_ckpt",
                    help="write round checkpoints on a background thread "
                         "(atomic publish; identical bytes to sync writes)")
    fl.add_argument("--guards", nargs="?", const=True, default=False,
                    choices=[True, False, "jitter"], metavar="[jitter]",
                    help="run steady-state rounds under the runtime guards "
                         "(src/repro_torch/guards.py: kernel rebuilds and "
                         "plan-cache misses after warm-in raise; packed "
                         "engine only); '--guards jitter' also injects "
                         "deterministic seeded sleeps at every thread "
                         "handoff, and histories must stay bit-identical")

    lm = sub.add_parser("lm")
    lm.add_argument("--device", default="cuda",
                    help="torch device (a run without a card raises unless "
                         "given --device cpu)")
    lm.add_argument("--arch", required=True)
    lm.add_argument("--smoke", action="store_true")
    lm.add_argument("--layers", type=int, default=None)
    lm.add_argument("--steps", type=int, default=20)
    lm.add_argument("--batch", type=int, default=4)
    lm.add_argument("--seq", type=int, default=128)
    lm.add_argument("--lr", type=float, default=1e-3)
    lm.add_argument("--seed", type=int, default=0)
    lm.add_argument("--log-every", type=int, default=5)
    lm.add_argument("--ckpt", default=None)
    return ap


def main(argv=None):
    args = build_parser().parse_args(argv)
    if args.mode == "fl":
        return run_fl(args)
    return run_lm(args)


if __name__ == "__main__":
    main()
