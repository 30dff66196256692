"""FedSiKD at LLM scale on the PyTorch port: cluster-grouped teacher ->
student distillation through ``launch/steps.py::make_fedsikd_distill_step``
with a reduced config.  The twin of ``examples/llm_distill.py``; it imports
only ``repro_torch``.

4 client replicas in 2 clusters distill a frozen full-depth teacher into
depth-pruned students.  The replicas are stacked on a leading axis of every
student leaf on one device (no mesh); the intra-cluster gradient mean and
the end-of-round two-level mean are contractions on that axis.  On the card
the teacher's forward runs on the flash-attention kernel and the students'
loss on the KD kernels, one launch for the four replicas.

  PYTHONPATH=src python examples/llm_distill_torch.py [--device cuda|cpu]

The default device is ``cuda``; without a card the example raises unless
given ``--device cpu``.
"""
import argparse
import dataclasses

import numpy as np
import torch

from repro_torch.configs import get_config
from repro_torch.data.pipeline import token_stream
from repro_torch.fed.rounds import resolve_device
from repro_torch.launch import steps as st
from repro_torch.models import transformer as tf
from repro_torch.tree import flatten


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--device", default="cuda",
                    help="torch device (raises without a card unless cpu)")
    args = ap.parse_args(argv)
    device = resolve_device(args.device)
    cfg = dataclasses.replace(get_config("qwen2.5-3b", smoke=True),
                              num_layers=2, remat=False)
    D = 4                                    # client replicas
    cluster_of = np.array([0, 0, 1, 1])

    dstep, sync, init_students, opt, s_cfg = st.make_fedsikd_distill_step(
        cfg, cluster_of, lr=3e-3, kd_alpha=0.5)
    print(f"teacher: {cfg.num_layers}L/{cfg.d_model}d "
          f"({cfg.param_count()/1e6:.1f}M params) -> student: "
          f"{s_cfg.num_layers}L ({s_cfg.param_count()/1e6:.1f}M params), "
          f"{D} replicas on {device}")

    teacher = tf.init_lm(0, cfg, device=device)
    students = init_students(1, device=device)
    opt_state = opt.init(students)

    B, S = 4, 64
    losses, rounds = [], []
    for rnd in range(3):                               # 3 FL rounds
        for b in token_stream(cfg.vocab_size, D * B, S, seed=rnd,
                              num_batches=10):
            batch = {k: torch.from_numpy(v).to(device).reshape(
                (D, B) + v.shape[1:]) for k, v in b.items()}
            students, opt_state, loss = dstep(students, opt_state, teacher,
                                              batch)
            losses.append(float(loss))
        students = sync(students)                      # two-level global mean
        equal = all(torch.equal(w[d], w[0]) for w in flatten(students).values()
                    for d in range(1, D))
        rounds.append({"round": rnd, "losses": losses[-10:],
                       "replicas_equal": equal})
        print(f"round {rnd}: loss {losses[-10]:.3f} -> {losses[-1]:.3f} "
              f"(post-sync replicas equal: {equal})")
    return rounds


if __name__ == "__main__":
    main()
