#!/usr/bin/env python3
"""Time the KD forward and backward kernels of ``csrc/kd_softmax_kl.cu`` at
shapes of work other than the planner's, on one NVIDIA GPU, by calling the
library's C entry points with each plan (the numbers behind the cut-offs
and sizes of ``kernels/kd_softmax_kl.py::plan``):

    PYTHONPATH=src python3 tools/kd_plan_sweep.py

Prints one JSON line a case with the card's name and power limit: the
shape, the plan (regime, rows a block R, lanes a row L), the kernel's
device time a call (``torch.profiler``, 20 calls after a warm-up) and its
largest error against the plain version.  Inputs come from a seed with
numpy.
"""
from __future__ import annotations

import json
import math
import subprocess
import sys

sys.path.insert(0, __file__.rsplit("/", 1)[0])
from merge_kmeans_compare import device_us  # noqa: E402


def main() -> int:
    import numpy as np
    import torch
    if not torch.cuda.is_available():
        print("kd_plan_sweep: needs a CUDA device", file=sys.stderr)
        return 2
    from repro_torch.kernels import _build
    from repro_torch.kernels import kd_softmax_kl as kd
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, check=True).stdout.strip()
    lib = _build.library()
    c = math.log2(math.e) / 2.0

    def inputs(T, V, dtype):
        r = np.random.default_rng(T + V)
        s = torch.from_numpy((r.standard_normal((T, V)) * 3)
                             .astype(np.float32)).cuda().to(dtype)
        t = torch.from_numpy((r.standard_normal((T, V)) * 3)
                             .astype(np.float32)).cuda().to(dtype)
        y = torch.from_numpy(r.integers(0, V, T).astype(np.int32)).cuda()
        return s, t, y

    def fwd(s, t, y, regime, R, L):
        T, V = s.shape
        loss = torch.empty(T, device="cuda")
        stats = torch.empty((T, 3), device="cuda")
        err = lib.fedsikd_kd_fwd(
            s.data_ptr(), t.data_ptr(), y.data_ptr(), loss.data_ptr(),
            stats.data_ptr(), T, V, _build.dtype_code(s, "sweep"), 2.0, 0.5,
            c, 0.5, kd.VARIANTS.index(regime), R, L, 1,
            torch.cuda.current_stream().cuda_stream)
        _build.check(err, "sweep fwd")
        return loss, stats

    def bwd(s, t, y, stats, g, regime, R):
        T, V = s.shape
        ds = torch.empty_like(s)
        err = lib.fedsikd_kd_bwd(
            s.data_ptr(), t.data_ptr(), y.data_ptr(), stats.data_ptr(),
            g.data_ptr(), ds.data_ptr(), T, V, _build.dtype_code(s, "sweep"),
            2.0, 0.5, c, kd.VARIANTS.index(regime), R, 1,
            torch.cuda.current_stream().cuda_stream)
        _build.check(err, "sweep bwd")
        return ds

    cases = []
    for R in (10, 20, 40):
        cases += [("fwd", 2560, 10, torch.float32, "rows", R, L)
                  for L in (1, 2, 4, 8) if R * L <= kd.ROWS_THREADS]
        cases += [("bwd", 2560, 10, torch.float32, "rows", R, 4)]
    cases += [(way, T, 151936, torch.bfloat16, "stream", 1, 1)
              for way in ("fwd", "bwd") for T in (16, 132, 264)]
    for case in cases:
        way, T, V, dtype, regime, R, L = case
        s, t, y = inputs(T, V, dtype)
        g = torch.ones(T, device="cuda")
        loss_p, stats_p = kd.kd_loss_fwd_plain(s, t, y, tau=2.0, alpha=0.5)
        if way == "fwd":
            def fn():
                return fwd(s, t, y, regime, R, L)
            err = float((fn()[0] - loss_p).abs().max())
        else:
            def fn():
                return bwd(s, t, y, stats_p, g, regime, R)
            want = kd.kd_loss_bwd_plain(s, t, y, stats_p, g, tau=2.0,
                                        alpha=0.5)
            err = float((fn().float() - want.float()).abs().max())
        print(json.dumps({"card": smi, "way": way, "shape": [T, V],
                          "dtype": str(dtype)[6:], "regime": regime,
                          "R": R, "L": L,
                          "device_us": device_us(fn, "kd_")[0],
                          "max_abs_err": err}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
