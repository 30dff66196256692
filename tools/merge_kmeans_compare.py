#!/usr/bin/env python3
"""Time one source tree's fused merge and k-means assignment on one NVIDIA
GPU, so that two trees can be compared in turns within one call:

    python3 tools/merge_kmeans_compare.py --src SRC --tag NAME

``SRC`` is a tree's ``src`` directory; its ``repro_torch`` is imported and
its kernels are built into that tree's own ``build/`` directory.  Prints
one JSON line with the card's name and power limit and, by CUDA events
(median of 5 x 50 back-to-back calls after a warm-up) and by
``torch.profiler`` (device time a call, over 20 calls):

- ``merge``: the loop engine's merge of a round as the tree does it,
  ``core.aggregation.weighted_average`` of 40 client dicts of the MNIST
  student's ten leaves (``ms``), the device time of its merge kernels
  (``kernel_us``) and of every device event of a call, copies and stacks
  included (``device_all_us``), and the kernel launches a call;
- ``kmeans``: ``kernels.kmeans_assign.kmeans_assign`` at (40, 2352, 5), the
  clustering step's shape, and at (16384, 2352, 8): ``ms`` and the
  kernel's device time ``kernel_us``.

Every input is made from a seed with numpy.  It changes no file of the
repository.
"""
from __future__ import annotations

import argparse
import json
import statistics
import subprocess
import sys
from pathlib import Path


def time_ms(fn, iters=50, reps=5):
    import torch
    for _ in range(3):
        fn()
    torch.cuda.synchronize()
    times = []
    for _ in range(reps):
        a = torch.cuda.Event(enable_timing=True)
        b = torch.cuda.Event(enable_timing=True)
        a.record()
        for _ in range(iters):
            fn()
        b.record()
        torch.cuda.synchronize()
        times.append(a.elapsed_time(b) / iters)
    return statistics.median(times)


def device_us(fn, key, calls=20):
    """Device time a call in events whose name contains ``key`` ("" for
    every device event), and the number of such events a call."""
    import torch
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile
    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        for _ in range(calls):
            fn()
        torch.cuda.synchronize()
    ev = [e for e in prof.key_averages()
          if e.device_type == DeviceType.CUDA and key in e.key]
    return (sum(e.self_device_time_total for e in ev) / calls,
            sum(e.count for e in ev) / calls)


def main() -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--src", required=True)
    ap.add_argument("--tag", required=True)
    args = ap.parse_args()
    sys.path.insert(0, str(Path(args.src).resolve()))
    import numpy as np
    import torch
    if not torch.cuda.is_available():
        print("merge_kmeans_compare: needs a CUDA device", file=sys.stderr)
        return 2
    from repro_torch.core import aggregation as agg
    from repro_torch.kernels import kmeans_assign as km
    from repro_torch.models.cnn import MnistCNN

    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, check=True).stdout.strip()
    r = np.random.default_rng(0)
    shapes = {k: p.shape for k, p in
              MnistCNN(student=True).named_parameters()}
    params = [{k: torch.from_numpy(r.standard_normal(sh).astype(np.float32))
               .cuda() for k, sh in shapes.items()} for _ in range(40)]
    weights = (np.abs(r.standard_normal(40)) + 0.1).tolist()

    def merge():
        return agg.weighted_average(params, weights)
    kernel_us, launches = device_us(merge, "fused_merge")
    out = {"tag": args.tag, "card": smi, "merge": {
        "ms": time_ms(merge), "kernel_us": kernel_us,
        "kernel_launches": launches,
        "device_all_us": device_us(merge, "")[0]}, "kmeans": {}}
    for N, K in ((40, 5), (16384, 8)):
        x = torch.from_numpy(r.standard_normal((N, 2352)).astype(np.float32)
                             ).cuda()
        c = torch.from_numpy(r.standard_normal((K, 2352)).astype(np.float32)
                             ).cuda()
        out["kmeans"][f"{N}x2352 K={K}"] = {
            "ms": time_ms(lambda: km.kmeans_assign(x, c)),
            "kernel_us": device_us(lambda: km.kmeans_assign(x, c),
                                   "kmeans_assign")[0]}
    print(json.dumps(out), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
