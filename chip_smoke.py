#!/usr/bin/env python3
"""Smoke test of the PyTorch/CUDA port (``src/repro_torch``) on one NVIDIA
GPU.  Run from the repository root with no arguments:

    python3 chip_smoke.py

It builds the port's CUDA kernels from ``src/repro_torch/kernels/csrc``,
holds each kernel against its plain PyTorch version on the card, drives the
fused distill step and the FedSiKD main path (``run_federated`` on the full
MNIST twin, 40 clients, 3 rounds) on the card, checks that each path went
through its kernels, times every kernel beside its bound, and prints one
JSON object per line.  The last line is
``{"ok": true, "device": {"platform": "gpu", "kind": ..., "count": ...}}``;
any failed phase raises, so the script exits non-zero and never prints it.
It imports nothing of JAX and nothing of the JAX package.

    python3 chip_smoke.py --profile

profiles one steady round of the same main path instead (host wall time,
device busy time and idle share, launches, the kernels that take the
device's time) and prints it as one JSON line; it checks nothing.
"""
from __future__ import annotations

import json
import math
import statistics
import subprocess
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parent
sys.path.insert(0, str(ROOT / "src"))

# Published peaks of one H100 SXM (NVIDIA data sheet): HBM bandwidth and the
# float32 rate outside the tensor cores.  Every bound below uses these.
HBM_BYTES_PER_S = 3.35e12
F32_FLOPS_PER_S = 67e12
# Operations per logit element, counted from the kernels' arithmetic
# (exponentials counted as one operation each).
KD_FWD_OPS_PER_ELEM = 16
KD_BWD_OPS_PER_ELEM = 14
ROUNDS = 3
DEV = "cuda"


def emit(obj) -> None:
    print(json.dumps(obj), flush=True)


def bound_ms(nbytes: float, nops: float) -> tuple[float, str]:
    tb = nbytes / HBM_BYTES_PER_S * 1e3
    to = nops / F32_FLOPS_PER_S * 1e3
    return (tb, "bytes") if tb >= to else (to, "operations")


def time_ms(fn, *, iters: int = 50, reps: int = 5) -> float:
    """Median over ``reps`` of the mean time per call of ``iters`` calls,
    by CUDA events on the current stream, after a warm-up."""
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


def max_err(got, want) -> float:
    return float((got.float() - want.float()).abs().max())


def check_close(name, got, want, rtol, atol) -> float:
    """Raise unless |got - want| <= atol + rtol |want| everywhere."""
    import torch
    g, w = got.float(), want.float()
    ok = bool(torch.all((g - w).abs() <= atol + rtol * w.abs()))
    err = max_err(g, w)
    emit({"check": name, "max_abs_err": err, "rtol": rtol, "atol": atol,
          "ok": ok})
    if not ok:
        raise RuntimeError(f"{name}: kernel disagrees with its plain version "
                           f"(max abs err {err})")
    return err


# ------------------------------------------------------------------ phase 0
def phase_setup():
    import torch
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        timeout=60, check=True).stdout.strip().splitlines()[0]
    print(smi, flush=True)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    emit({"phase": "setup", "nvidia_smi": smi, "torch": torch.__version__,
          "cuda": torch.version.cuda,
          "device": torch.cuda.get_device_name(0),
          "matmul_allow_tf32": torch.backends.cuda.matmul.allow_tf32,
          "cudnn_allow_tf32": torch.backends.cudnn.allow_tf32})
    return smi


# ------------------------------------------------------------------ phase 1
def phase_build():
    from repro_torch.kernels import _build
    info = _build.build()
    _build.library()
    ptxas = [ln.strip() for ln in info["log"].splitlines()
             if "registers" in ln or "spill" in ln]
    emit({"phase": "build", "built": info["built"],
          "seconds": info["seconds"], "library": info["path"],
          "ptxas": ptxas})


# ------------------------------------------------------------------ phase 2
def _kd_inputs(T, V, dtype, seed):
    import numpy as np
    import torch
    r = np.random.default_rng(seed)
    s = torch.from_numpy((r.standard_normal((T, V)) * 3).astype(np.float32))
    t = torch.from_numpy((r.standard_normal((T, V)) * 3).astype(np.float32))
    y = r.integers(0, V, T).astype(np.int32)
    y[r.random(T) < 0.1] = -1
    return (s.to(DEV, dtype), t.to(DEV, dtype), torch.from_numpy(y).to(DEV))


def _merge_inputs(N, D, dtype, seed, stale: bool):
    import numpy as np
    import torch
    r = np.random.default_rng(seed)
    x = torch.from_numpy((r.standard_normal((N, D)) * 2).astype(np.float32))
    w = torch.from_numpy((np.abs(r.standard_normal(N)) + 0.1).astype(np.float32))
    s = (r.integers(0, 4, N) if stale else np.zeros(N)).astype(np.float32)
    return (x.to(DEV, dtype), w.to(DEV), torch.from_numpy(s).to(DEV))


def phase_kernel_checks():
    import torch
    from repro_torch.kernels import fused_merge as fm
    from repro_torch.kernels import kd_softmax_kl as kd
    errs = {"kd_softmax_kl_fwd": 0.0, "kd_softmax_kl_bwd": 0.0,
            "fused_merge": 0.0}
    for T, V, dtype, tol, seed in ((64, 10, torch.float32, 2e-5, 0),
                                   (2048, 32000, torch.float32, 2e-5, 1),
                                   (2048, 32000, torch.bfloat16, 5e-2, 2)):
        s, t, y = _kd_inputs(T, V, dtype, seed)
        loss, stats = kd.kd_loss_fwd(s, t, y, tau=2.0, alpha=0.5)
        loss_p, stats_p = kd.kd_loss_fwd_plain(s, t, y, tau=2.0, alpha=0.5)
        torch.cuda.synchronize()
        tag = f"kd_fwd T={T} V={V} {str(dtype)[6:]}"
        e = max(check_close(tag + " loss", loss, loss_p, tol, tol * 10),
                check_close(tag + " stats", stats, stats_p, tol, tol * 10))
        errs["kd_softmax_kl_fwd"] = max(errs["kd_softmax_kl_fwd"], e)
        g = torch.ones(s.shape[0], dtype=torch.float32, device=DEV)
        ds = kd.kd_loss_bwd(s, t, y, stats, g, tau=2.0, alpha=0.5)
        ds_p = kd.kd_loss_bwd_plain(s, t, y, stats_p, g, tau=2.0, alpha=0.5)
        torch.cuda.synchronize()
        if dtype == torch.float32:
            e = check_close(f"kd_bwd T={T} V={V} float32 ds", ds, ds_p,
                            1e-5, 1e-5)
        else:
            e = check_close(f"kd_bwd T={T} V={V} bfloat16 ds", ds, ds_p,
                            5e-2, 5e-2)
        errs["kd_softmax_kl_bwd"] = max(errs["kd_softmax_kl_bwd"], e)
    for N, D, dtype, decay, stale, tol, seed in (
            (40, 9216, torch.float32, 0.0, False, 1e-5, 3),
            (40, 9216, torch.float32, 0.5, True, 1e-5, 4),
            (13, 513, torch.float32, 0.5, True, 1e-5, 5),
            (40, 2560, torch.bfloat16, 0.0, False, 2e-2, 6)):
        x, w, s = _merge_inputs(N, D, dtype, seed, stale)
        out = fm.fused_merge(x, w, s, decay=decay)
        out_p = fm.fused_merge_plain(x, w, s, decay=decay)
        torch.cuda.synchronize()
        e = check_close(f"fused_merge N={N} D={D} {str(dtype)[6:]} "
                        f"decay={decay}", out, out_p, tol, tol)
        errs["fused_merge"] = max(errs["fused_merge"], e)
    return errs


# ------------------------------------------------------------------ phase 3
def phase_fused_distill(ds):
    import torch
    from repro_torch import rng
    from repro_torch.data.pipeline import make_client_shards
    from repro_torch.fed.client import make_steps
    from repro_torch.kernels import launch_counts, reset_launches
    from repro_torch.models.cnn import make_model
    from repro_torch.optim import adamw

    shard = make_client_shards(ds, 40, 0.5, seed=0)[0]
    t_init, t_fwd = make_model("mnist", student=False)
    s_init, s_fwd = make_model("mnist", student=True)
    teacher = t_init(rng.fold_seed(0, 100), DEV)
    start = s_init(rng.fold_seed(0), DEV)
    opt = adamw(3e-3)
    steps = make_steps(s_fwd, opt, kd_temperature=2.0, kd_alpha=0.5)

    def epoch(step_fn):
        p, o, losses = dict(start), opt.init(start), []
        for j, (x, y) in enumerate(shard.batches(64, epoch=0, seed=0)):
            p, o, loss = step_fn(p, o, {"x": x, "y": y}, rng.fold_seed(0, j),
                                 teacher)
            losses.append(loss)
        torch.cuda.synchronize()
        return p, [float(v) for v in losses]

    reset_launches()
    p_fused, l_fused = epoch(steps["make_distill"](t_fwd, fused=True))
    counts = launch_counts()
    p_ref, l_ref = epoch(steps["make_distill"](t_fwd, fused=False))
    n = len(l_fused)
    loss_rel = max(abs(a - b) / abs(b) for a, b in zip(l_fused, l_ref))
    param_abs = max(max_err(p_fused[k], p_ref[k]) for k in p_ref)
    emit({"phase": "fused_distill_step", "steps": n, "examples":
          shard.num_examples, "losses_fused": l_fused, "losses_ref": l_ref,
          "max_loss_rel_err": loss_rel, "max_param_abs_err": param_abs,
          "launches": counts})
    if loss_rel > 1e-5:
        raise RuntimeError(f"fused and reference distill losses differ by "
                           f"{loss_rel} relative (limit 1e-5)")
    if param_abs > 1e-3:
        raise RuntimeError(f"fused and reference distill params differ by "
                           f"{param_abs} (limit 1e-3)")
    if counts["kd_softmax_kl_fwd"] != n or counts["kd_softmax_kl_bwd"] != n:
        raise RuntimeError(f"expected {n} KD forward and backward launches "
                           f"in {n} steps, counted {counts}")
    return counts


# ------------------------------------------------------------------ phase 4
def phase_main_path(ds):
    from repro_torch.fed.rounds import FedConfig, run_federated
    from repro_torch.kernels import launch_counts, reset_launches
    from repro_torch.models.cnn import MnistCNN

    cfg = FedConfig(algorithm="fedsikd", engine="loop", rounds=ROUNDS)
    leaves = len(list(MnistCNN(student=True).parameters()))
    reset_launches()
    t0 = time.perf_counter()
    h = run_federated(ds, cfg, device=DEV)
    total = time.perf_counter() - t0
    counts = launch_counts()
    emit({"phase": "main_path", "config": "fedsikd loop mnist 40 clients "
          f"alpha=0.5 batch=64 warmup=3 rounds={ROUNDS}",
          "acc": h["acc"], "loss": h["loss"],
          "round_seconds": h["round_seconds"],
          "num_clusters": h["num_clusters"], "participants":
          h["participants"], "seconds_total": total, "launches": counts})
    if counts["fused_merge"] != ROUNDS * leaves:
        raise RuntimeError(f"expected {ROUNDS} x {leaves} fused-merge "
                           f"launches, counted {counts['fused_merge']}")
    if not all(math.isfinite(v) for v in h["acc"] + h["loss"]):
        raise RuntimeError(f"non-finite eval metrics: {h['acc']} {h['loss']}")
    return counts


# ------------------------------------------------------------------ phase 5
def _kd_timing(T, V, dtype, seed):
    import torch
    from repro_torch.kernels import kd_softmax_kl as kd
    s, t, y = _kd_inputs(T, V, dtype, seed)
    T, V = s.shape
    g = torch.ones(T, dtype=torch.float32, device=DEV)
    _, stats = kd.kd_loss_fwd(s, t, y)
    elt = s.element_size()
    fwd_bytes = 2 * T * V * elt + T * 4 + T * 4 + T * 12
    bwd_bytes = 3 * T * V * elt + T * 4 + T * 12 + T * 4
    fwd = {"ms": time_ms(lambda: kd.kd_loss_fwd(s, t, y)),
           "plain_ms": time_ms(lambda: kd.kd_loss_fwd_plain(s, t, y, tau=2.0,
                                                            alpha=0.5))}
    fwd["bound_ms"], fwd["bound_by"] = bound_ms(fwd_bytes,
                                                KD_FWD_OPS_PER_ELEM * T * V)
    bwd = {"ms": time_ms(lambda: kd.kd_loss_bwd(s, t, y, stats, g)),
           "plain_ms": time_ms(lambda: kd.kd_loss_bwd_plain(
               s, t, y, stats, g, tau=2.0, alpha=0.5))}
    bwd["bound_ms"], bwd["bound_by"] = bound_ms(bwd_bytes,
                                                KD_BWD_OPS_PER_ELEM * T * V)
    return fwd, bwd


def _merge_round_timing():
    """One round's ten per-leaf merges of the MNIST student (N = 40)."""
    import torch
    from repro_torch.kernels import fused_merge as fm
    from repro_torch.models.cnn import MnistCNN
    sizes = [p.numel() for p in MnistCNN(student=True).parameters()]
    stacks = [_merge_inputs(40, d, torch.float32, 10 + i, False)
              for i, d in enumerate(sizes)]
    wn = [(w / w.sum()) for _, w, _ in stacks]
    nbytes = sum(x.numel() * 4 + 2 * 40 * 4 + x.shape[1] * 4
                 for x, _, _ in stacks)
    nops = sum(2 * x.numel() for x, _, _ in stacks)
    out = {
        "ms": time_ms(lambda: [fm.fused_merge(x, w, s) for x, w, s in stacks]),
        "plain_ms": time_ms(lambda: [fm.fused_merge_plain(x, w, s)
                                     for x, w, s in stacks]),
        "library_ms": time_ms(lambda: [v @ x for v, (x, _, _)
                                       in zip(wn, stacks)]),
        "leaf_sizes": sizes, "bytes": nbytes}
    out["bound_ms"], out["bound_by"] = bound_ms(nbytes, nops)
    return out


def phase_timing(errs, path_counts, smi):
    import torch
    kd_fwd, kd_bwd = _kd_timing(64, 10, torch.float32, 20)
    merge = _merge_round_timing()
    for dtype in (torch.float32, torch.bfloat16):
        f, b = _kd_timing(2048, 32000, dtype, 21)
        emit({"timing": f"kd T=2048 V=32000 {str(dtype)[6:]}",
              "fwd": f, "bwd": b, "card": smi})
    emit({"timing": "fused_merge, one round (10 leaves, N=40)", **merge,
          "card": smi})
    src = "src/repro_torch/kernels/csrc/"
    rows = [
        {"name": "kd_softmax_kl_fwd", "route": "cuda",
         "source": src + "kd_softmax_kl.cu",
         "replaces": "src/repro/kernels/kd_softmax_kl.py:33",
         "shape": "T=64 V=10 float32, one call", **kd_fwd,
         "library_ms": None, "path": "fused distill step"},
        {"name": "kd_softmax_kl_bwd", "route": "cuda",
         "source": src + "kd_softmax_kl.cu",
         "replaces": "src/repro/kernels/kd_softmax_kl.py:118",
         "shape": "T=64 V=10 float32, one call", **kd_bwd,
         "library_ms": None, "path": "fused distill step"},
        {"name": "fused_merge", "route": "cuda",
         "source": src + "fused_merge.cu",
         "replaces": "src/repro/kernels/fused_merge.py:30",
         "shape": "N=40, the 10 student leaves of one round",
         **{k: merge[k] for k in ("ms", "plain_ms", "library_ms",
                                  "bound_ms", "bound_by")},
         "path": "run_federated"},
    ]
    for r in rows:
        r["launches"] = path_counts[r["name"]]
        r["max_abs_err"] = errs[r["name"]]
    emit({"kernels": rows})


# ---------------------------------------------------------- --profile mode
PORT_KERNELS = ("kd_fwd_kernel", "kd_bwd_kernel", "fused_merge_kernel")
# substrings that sort device kernels into groups, tried in order
KERNEL_GROUPS = (("port", PORT_KERNELS),
                 ("memcpy/memset", ("Memcpy", "Memset")),
                 ("conv (cuDNN)", ("cudnn", "xmma", "conv", "wgrad", "dgrad",
                                   "implicit_gemm", "nhwcToNchw",
                                   "nchwToNhwc")),
                 ("matmul", ("gemm", "Kernel2", "splitK")),
                 ("reduce", ("reduce_kernel",)),
                 ("elementwise", ("elementwise", "Functor")))


def _device_summary(prof, wall_s):
    """Device busy time, idle share, launches, time by kernel group, the
    top kernels and the port's own kernels from one profiler window."""
    from torch.autograd import DeviceType
    events = prof.key_averages()
    dev = [e for e in events if e.device_type == DeviceType.CUDA]
    busy_us = sum(e.self_device_time_total for e in dev)
    groups = {}
    for e in dev:
        name = next((g for g, keys in KERNEL_GROUPS
                     if any(k in e.key for k in keys)), "other")
        groups[name] = groups.get(name, 0.0) + e.self_device_time_total / 1e3
    top = sorted(dev, key=lambda e: -e.self_device_time_total)[:10]
    return {
        "wall_ms": wall_s * 1e3, "device_busy_ms": busy_us / 1e3,
        "device_idle_share": 1.0 - busy_us / (wall_s * 1e6),
        "host_kernel_launches": sum(
            e.count for e in events
            if e.key in ("cudaLaunchKernel", "cudaLaunchKernelExC",
                         "cuLaunchKernel", "cuLaunchKernelEx")),
        "device_events": sum(e.count for e in dev),
        "device_ms_by_group": groups,
        "top_device": [{"name": e.key[:90], "count": e.count,
                        "ms": e.self_device_time_total / 1e3} for e in top],
        "port_kernels": [{"name": e.key[:60], "count": e.count,
                          "device_us_per_launch":
                          e.self_device_time_total / e.count}
                         for e in dev
                         if any(k in e.key for k in PORT_KERNELS)]}


def phase_profile(ds, smi):
    """Under ``torch.profiler``: one steady round of the main path (round 2,
    after the warm-up and a first round) with its training steps counted,
    then one epoch of the fused distill step on client 0's shard.  Each
    window reports host wall time, the device's busy time and idle share,
    the launches, device time by kernel group and the port's kernels'
    device time per launch."""
    import torch
    from torch.profiler import ProfilerActivity, profile
    from repro_torch.data.pipeline import ClientStore, make_client_shards
    from repro_torch.fed.algorithms import make_algorithm
    from repro_torch.fed.rounds import FedConfig

    acts = [ProfilerActivity.CPU, ProfilerActivity.CUDA]
    cfg = FedConfig(algorithm="fedsikd", engine="loop", rounds=2)
    shards = ClientStore(make_client_shards(ds, cfg.num_clients, cfg.alpha,
                                            seed=cfg.seed))
    alg = make_algorithm(cfg)
    alg.setup(ds, shards, cfg, cfg.seed, device=torch.device(DEV))
    alg.warmup()
    alg.run_round(alg.scheduler.plan(1), 1)
    alg.eval()
    torch.cuda.synchronize()
    steps = {"student": 0, "teacher": 0}

    def counted(kind, fn):
        def step(*a):
            steps[kind] += 1
            return fn(*a)
        return step

    alg.distill_step = counted("student", alg.distill_step)
    alg.teacher_steps["ce"] = counted("teacher", alg.teacher_steps["ce"])
    with profile(activities=acts) as prof:
        t0 = time.perf_counter()
        alg.run_round(alg.scheduler.plan(2), 2)
        t1 = time.perf_counter()
        alg.eval()
        torch.cuda.synchronize()
        t2 = time.perf_counter()
    emit({"phase": "profile", "window": "main path, round 2", "card": smi,
          "train_merge_ms": (t1 - t0) * 1e3, "eval_ms": (t2 - t1) * 1e3,
          "steps": steps,
          "host_ms_per_step": (t1 - t0) * 1e3 / sum(steps.values()),
          **_device_summary(prof, t2 - t0)})

    fused = alg.student_steps["make_distill"](alg.t_model[1], fused=True)
    teacher, shard = alg.teachers[0], shards[0]
    p, o = alg.global_student, alg.s_opt.init(alg.global_student)
    with profile(activities=acts) as prof:
        t0 = time.perf_counter()
        for j, (x, y) in enumerate(shard.batches(cfg.batch_size, epoch=0,
                                                 seed=cfg.seed)):
            p, o, _ = fused(p, o, {"x": x, "y": y}, j, teacher)
        torch.cuda.synchronize()
        t1 = time.perf_counter()
    emit({"phase": "profile", "window": "fused distill epoch, client 0",
          "card": smi, "steps": j + 1, **_device_summary(prof, t1 - t0)})


def main() -> int:
    import torch
    if not torch.cuda.is_available():
        print("chip_smoke: torch.cuda.is_available() is False; this script "
              "needs a CUDA device", file=sys.stderr)
        return 2
    from repro_torch.data.synthetic import load_dataset

    smi = phase_setup()
    phase_build()
    if sys.argv[1:] == ["--profile"]:
        phase_profile(load_dataset("mnist"), smi)
        return 0
    if sys.argv[1:]:
        print(f"chip_smoke: unknown arguments {sys.argv[1:]} (only "
              "--profile)", file=sys.stderr)
        return 2
    errs = phase_kernel_checks()
    ds = load_dataset("mnist")
    kd_counts = phase_fused_distill(ds)
    merge_counts = phase_main_path(ds)
    for name, c in (("kd_softmax_kl_fwd", kd_counts),
                    ("kd_softmax_kl_bwd", kd_counts),
                    ("fused_merge", merge_counts)):
        if c[name] < 1:
            raise RuntimeError(f"{name} was not launched on its path")
    path_counts = {"kd_softmax_kl_fwd": kd_counts["kd_softmax_kl_fwd"],
                   "kd_softmax_kl_bwd": kd_counts["kd_softmax_kl_bwd"],
                   "fused_merge": merge_counts["fused_merge"]}
    phase_timing(errs, path_counts, smi)
    print(smi, flush=True)
    emit({"ok": True, "device": {"platform": "gpu",
                                 "kind": torch.cuda.get_device_name(0),
                                 "count": torch.cuda.device_count()}})
    return 0


if __name__ == "__main__":
    sys.exit(main())
