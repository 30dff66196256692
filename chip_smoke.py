#!/usr/bin/env python3
"""Smoke test of the PyTorch/CUDA port (``src/repro_torch``) on one NVIDIA
GPU.  Run from the repository root with no arguments:

    python3 chip_smoke.py

It builds the port's CUDA kernels from ``src/repro_torch/kernels/csrc``,
holds each kernel against its plain PyTorch version on the card (the KD
kernels in each of their two regimes, rows and stream, at ``KD_CASES``,
and in bf16 at the distill steps' vocabularies, ``KD_BF16_CASES``),
drives the fused distill step and the FedSiKD main path (``run_federated``
on the full MNIST twin, 40 clients, 3 rounds) on the card on both engines
(the loop engine, then the packed engine with all 40 clients as lanes of
one stacked program), then the paper's baselines on the same twin (loop
FedAvg, FedProx and FL+HC, each merge one fused-merge launch, and packed
FedAvg with all 40 clients as lanes, whose merge is a product), then the
packed engine on a mesh of ranks (phase ``mesh_path``: packed FedSiKD and
FedAvg through the client mesh of ``torch.distributed``, one NCCL rank a
card, and on a one-card machine 2 gloo ranks sharing it, 20 slots each;
each held to the one-process packed run: equal accuracy, losses within
1e-6 relative, the same history and global model on every rank, exact KD
and k-means launches a rank), then the
paper's join-and-share path (phase ``runtime_path``: loop FedSiKD with
DP-noised statistics, clients joining and leaving, warm re-clustering,
stragglers merged late and a checkpoint every round, interrupted and
resumed with a bit-exact restore; loop FedAvg with the same knobs; packed
FedSiKD with DP noise and checkpoints, interrupted and resumed), then the
packed engine at cross-device scale (phase ``scale_path``: packed FedSiKD
over a virtual universe of 100,000 clients, cohorts of 120 streamed through
40 slots in 3 waves under the runtime guards, against a universe of 1,000
and against the cohort in one wave; packed FedSiKD on the join-and-share
knobs against its loop run, interrupted and resumed; packed FedAvg in 2
waves with stragglers against loop FedAvg), then serves
the full-width, full-depth qwen2.5-3b in bf16 (random weights from a seed):
a prefill of 2 x 4096 tokens and 32 greedy decode steps through
``make_prefill_step`` / ``make_decode_step``, with every attention in a
flash-attention kernel (the bf16 prefill on the tensor-core kernel, every
decode step on the decode kernel), and glm4-9b, minitron-8b and
internvl2-2b the same way at 1 x 1024 tokens and 8 steps, and, at full
width with the depth cut to fit 80 GB, deepseek-v2-236b (multi-head
latent attention and 160 experts, no flash kernel), arctic-480b (128
experts beside a dense MLP) and nemotron-4-340b (head dim 192), each
then a float32 1-layer copy's decode held to its forward, and at full
width and full depth rwkv6-3b (RWKV6, no flash kernel), zamba2-1.2b
(Mamba2 layers and a shared attention block over a 4096-token window)
and seamless-m4t-large-v2 (the audio encoder-decoder: 256 frames, a
16-token prompt replayed through decode), each then a float32
full-depth copy's decode held to its forward; then trains the
full qwen2.5-3b (phase ``lm_train``: ``make_train_step`` on 2 x 2048
tokens at accum 1 and 2, the plain training attention, no port kernel,
and a float32 2-layer twin's step held to the same step on the CPU) and
then rwkv6-3b, zamba2-1.2b, seamless-m4t-large-v2, deepseek-v2-236b and
arctic-480b at full width (the MoE models with their layers and experts
cut to fit 80 GB, ``TRAIN_MORE``), each with its float32 twin held to its
CPU step, and runs the paper's FedSiKD step at LLM scale (phase
``lm_distill``: ``make_fedsikd_distill_step`` with the full qwen2.5-3b as
teacher and 2 students of 18 layers, on each loss path: the teacher's
forward on the flash kernel, the students' loss in one call of the KD
kernels, or none when vocab-chunked; then each of the five other families
as teacher, ``DISTILL_MORE``), then sizes and bounds every (architecture x
input shape) step and each LM step it timed on fake tensors in 8 host
processes (phase ``dryrun``: ``repro_torch.launch.dryrun`` and
``analysis``; each timed step's roofline share and MFU beside its
measured ms, its run's predicted peak beside the measured one, raising
over a share of 1.05 or under 0.8 of the peak), then runs
``examples/quickstart_torch.py``
and ``examples/llm_distill_torch.py`` on the card as a user runs them
(phase ``examples``). It checks that each path went through
its kernels (the loop engine's merge one multi-leaf launch a round, the
clustering step's 255 k-means calls on the split kernel, every KD launch of
the fused distill step and the packed engine on the rows kernels, FedAvg's
and FedProx's merge one launch a round and FL+HC's one a cluster, the
join-and-share runs' merge one launch a round that merges, late updates at
s >= 1 among them, and 51 k-means launches a re-clustering; the scale
runs' KD launches one a step of each wave's longest budget and their merges
one a round that merges arrivals alone; every served model's flash
launches, attention layers on ``tensor_core`` and attention layers x
steps on ``decode`` (RWKV none, zamba2 2 + 16, seamless 24 + 576); no
flash or KD launch in a train step; one ``stream`` KD forward and backward
a distill step with materialised logits, none when vocab-chunked, and the
teacher's attention layers of ``tensor_core`` launches a teacher forward,
once a replica for a MoE teacher), holds
each packed engine's per-round accuracy and eval loss to its loop engine's
and a float32 2-layer serve's decode logits to a full forward of the same
tokens, times every kernel beside its bound, and prints one JSON object per
line. The last line is
``{"ok": true, "device": {"platform": "gpu", "kind": ..., "count": ...}}``;
any failed phase raises, so the script exits non-zero and never prints it.
It imports nothing of JAX and nothing of the JAX package.

    python3 chip_smoke.py --profile

profiles one steady round of the same main path on each engine, the
clustering step, one steady FedAvg round on each engine, and one prefill
and one decode step of the served model and of rwkv6-3b, zamba2-1.2b and
seamless-m4t-large-v2 instead (host wall time, device
busy time and idle share, launches, the kernels that take the device's
time) and prints each as one JSON line; it checks nothing.
"""
from __future__ import annotations

import contextlib
import json
import math
import statistics
import subprocess
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parent
sys.path.insert(0, str(ROOT / "src"))

# Published peaks of one H100 SXM (NVIDIA data sheet): HBM bandwidth, the
# float32 rate outside the tensor cores and the dense bf16 tensor-core rate,
# kept in the dry run's roofline module.  Every bound below uses these.
from repro_torch.launch.roofline import (  # noqa: E402
    BF16_FLOPS_PER_S, F32_FLOPS_PER_S, HBM_BYTES_PER_S, PEAK_FLOPS)
# Operations per logit element, counted from the kernels' arithmetic
# (exponentials counted as one operation each).
KD_FWD_OPS_PER_ELEM = 16
KD_BWD_OPS_PER_ELEM = 14
ROUNDS = 3
PACKED_LANES = 40                      # pack=40: one card hosts the cohort
BATCH = 64
PATH_ROWS = PACKED_LANES * BATCH       # the KD kernels' rows on the packed path
# packed-vs-loop bound on every per-round loss (eval, teacher, student): the
# engines run the same clusters, init and batches, so only rounding differs
# (measured gaps up to 1.7e-3 relative on the CPU, tests/test_torch_sharded.py)
LOSS_RTOL_TO_LOOP = 1e-2
# (T, V) of the KD checks, every regime of kernels/kd_softmax_kl.py::plan:
# rows at the loop engine's and the packed path's shapes, stream at an LLM
# vocabulary, at an odd V (rows not 16-byte aligned, a scalar tail), and
# for fewer rows than SMs at the served model's vocabulary and GPT-2's,
# and the LLM distillation step's D x T = 2 x 1024 rows at that
# vocabulary; each in float32 and bf16
KD_CASES = [(64, 10), (PATH_ROWS, 10), (2048, 32000), (300, 32003),
            (16, 151936), (5, 50257), (2048, 151936)]
# bf16 only, at the 2 x 1024 rows of the distill step: the vocabularies the
# other families give the KD kernels there (rwkv6-3b's 65,536,
# deepseek-v2-236b's 102,400 and seamless-m4t-large-v2's 256,206, which is
# 6 mod 8, so consecutive rows start at other 16-byte alignments and every
# row takes the head and tail path; arctic's and zamba2's 32,000 is in
# KD_CASES), drawn on the card (``_kd_inputs_on_card``: the host draws about
# 3e7 normals a second)
KD_BF16_CASES = [(2048, 65536), (2048, 102400), (2048, 256206)]
# (loss and stats rtol, ds rtol and atol) of the KD kernels against their
# plain versions; the loss and stats take an atol of 10 x their rtol
KD_TOL = {"float32": (2e-5, 1e-5), "bfloat16": (5e-2, 5e-2)}
# bf16 ds also against the plain ds in float32 on the same (exactly
# widened) inputs: one rounding to bf16, at most 2**-7 of a value, over a
# floor of 1e-5 of the largest |ds| for the float32 arithmetic before it.
# Most |ds| lie far below KD_TOL's 5e-2 (g is 0.01-0.03 a row), where
# that bound alone would pass a kernel that wrote zeros.
KD_BF16_DS = (2 ** -7, 1e-5)
# the clustering step's statistics matrix: 40 clients x 3 * 784 features
KM_N, KM_F = 40, 3 * 784
# the served model and its traffic: B sequences, a prompt of LM_PROMPT
# tokens, LM_DECODE greedy steps (the cache grows to LM_PROMPT + LM_DECODE)
LM_ARCH = "qwen2.5-3b"
LM_B, LM_PROMPT, LM_DECODE = 2, 4096, 32
LM_SEED = 0
# decode-vs-forward bound of the float32 2-layer consistency run (abs and
# relative): the same function summed in other orders (split keys, T = 1)
LM_CONSISTENCY_TOL = 1e-3
# the other served models, each at full width with random weights: GQA
# groups of 16 (glm4-9b, 18.8 GB in bf16), vocab 256000 and squared ReLU
# (minitron-8b), a 256-position VLM prefix (internvl2-2b) at full depth;
# MLA and 160 experts top-6 with 2 shared (deepseek-v2-236b), 128 experts
# top-2 beside a dense MLP and GQA groups of 7 (arctic-480b), and head_dim
# 192 with GQA groups of 12 (nemotron-4-340b), whose bf16 weights do not
# fit 80 GB, at the depth SERVE_DEPTH gives (by param_count: 6 of 60
# layers, 49.8 GB; 2 of 35, 55.4 GB; 6 of 96, 60.3 GB); then the
# recurrent and encoder-decoder families at full width and full depth:
# RWKV6 (rwkv6-3b, no attention), the Mamba2 hybrid with its shared
# attention block (zamba2-1.2b, window 4096, applied twice) and the audio
# encoder-decoder (seamless-m4t-large-v2, vocab 256206); a shorter request
# than qwen2.5-3b's to stay inside the run's time
SERVE_MORE = ("glm4-9b", "minitron-8b", "internvl2-2b", "deepseek-v2-236b",
              "arctic-480b", "nemotron-4-340b", "rwkv6-3b", "zamba2-1.2b",
              "seamless-m4t-large-v2")
SERVE_DEPTH = {"deepseek-v2-236b": 6, "arctic-480b": 2, "nemotron-4-340b": 6}
SERVE_B, SERVE_PROMPT, SERVE_DECODE = 1, 1024, 8
# seamless's request: SERVE_AUDIO audio positions as frame embeddings (the
# stub frontend's output, standard normal from a seed), SERVE_AUDIO //
# frame_ratio of them, as run_lm makes them, and a decoder prompt of
# SERVE_AUDIO_PROMPT tokens; its prefill fills no self-attention cache (as
# in JAX), so the prompt is replayed through decode before the greedy steps
SERVE_AUDIO, SERVE_AUDIO_PROMPT = 1024, 16
# the decode-vs-forward check of a depth-cut model and of the families
# above: a float32 copy at full width (one layer for a depth-cut model,
# full depth for CHECK_FULL_DEPTH) serves SERVE_CHECK_PROMPT tokens and
# SERVE_DECODE steps, held to a full forward of the same tokens at
# LM_CONSISTENCY_TOL; its MoE capacity factor is raised to E / k + 1, so
# that the forward, like decode (capacity B), drops no token (the served
# runs keep 1.25)
SERVE_CHECK_PROMPT = 64
CHECK_FULL_DEPTH = ("rwkv6-3b", "zamba2-1.2b", "seamless-m4t-large-v2")
# ``--profile`` also takes a prefill and a decode step of these
PROFILE_FAMILIES = CHECK_FULL_DEPTH
# lm_train: full qwen2.5-3b, TRAIN_STEPS steps at accum 1 then at accum 2,
# on B x T tokens (T >= 2 * attn_block: the blocked training attention);
# the float32 2-layer twin's card step is held to its CPU step per leaf at
# TRAIN_PARAM_RTOL in the Frobenius norm: the first moments (0.1 x the
# gradient) of every leaf and the params of every leaf that is not zero at
# init (Adam turns rounding into steps of +-lr where a gradient is within
# rounding of zero, so the max norm would hold rounding noise; a bias
# that starts at zero is its update alone, -lr g / (|g| + eps), which
# follows the rounding of g where |g| nears eps: its moment holds it), and
# its accum-2 loss to its accum-1 loss at TRAIN_ACCUM_RTOL
TRAIN_B, TRAIN_T, TRAIN_STEPS, TRAIN_LR = 2, 2048, 3, 1e-4
TRAIN_PARAM_RTOL, TRAIN_ACCUM_RTOL = 1e-4, 1e-5
# lm_distill: teacher full qwen2.5-3b, students its as_student() (18
# layers), D replicas in clusters DISTILL_CLUSTERS, DISTILL_T tokens a
# replica (the KD kernels see D x DISTILL_T rows); the chunked path's
# vocab chunk; the chunked and naive losses against the default one at
# KD_TOL's bf16 rtol
DISTILL_CLUSTERS = (0, 0)
DISTILL_T = 1024
DISTILL_ROWS = len(DISTILL_CLUSTERS) * DISTILL_T
DISTILL_CHUNK = 8192
DISTILL_LR = 1e-4
# lm_train and lm_distill then take every other family, each after qwen2.5-3b's
# runs, at full width with random weights (seed LM_SEED): at full depth, or for
# the MoE models with num_layers and num_experts cut to fit 80 GB at 12 B a
# trained parameter (bf16 weights and grads, float32 Adam moments: each cut
# config stays under make_optimizer's 8e9 switch) and 2 B a teacher parameter;
# d_model, heads, d_ff, top-k, shared experts and MLA stay the full config's.
# Train (by param_count): rwkv6-3b 3.06 B, zamba2-1.2b 1.17,
# seamless-m4t-large-v2 1.53, deepseek-v2-236b 1 of 60 layers with all 160
# experts 5.02 (60.3 GB), arctic-480b 2 of 35 layers with 8 of 128 experts
# 2.58.  Distill: the teacher so cut and its as_student() (half the layers):
# deepseek 2 layers with 32 experts (2.95 B) and students of 1 layer (2.00 B
# each), arctic 2 layers with 8 experts (2.58 B) and students of 1 (1.52 B)
TRAIN_MORE = {"rwkv6-3b": {}, "zamba2-1.2b": {}, "seamless-m4t-large-v2": {},
              "deepseek-v2-236b": {"num_layers": 1},
              "arctic-480b": {"num_layers": 2, "num_experts": 8}}
DISTILL_MORE = {"rwkv6-3b": {}, "zamba2-1.2b": {},
                "seamless-m4t-large-v2": {},
                "deepseek-v2-236b": {"num_layers": 2, "num_experts": 32},
                "arctic-480b": {"num_layers": 2, "num_experts": 8}}
# the MoE models train on MOE_TRAIN_BT = (B, T): 1,024 tokens, B even so that
# accum 2 splits it; the others on TRAIN_B x TRAIN_T (the encoder-decoder with
# T // frame_ratio frames a sequence)
MOE_TRAIN_BT = (2, 512)
# deepseek-v2-236b's train run takes no accum-2 step: its float32 gradient
# sums (4 B a parameter, 20.1 GB) do not fit beside the 60.3 GB of one
# layer with all 160 experts and its activations (the step ran out of
# memory at 73.9 GiB allocated, asking 4.7 GiB more); arctic-480b's run
# takes the MoE through accum 2
NO_ACCUM2 = ("deepseek-v2-236b",)
# each one's float32 twin: 2 layers at full width (the MoE's with TWIN_EXPERTS
# experts, the hybrid's as one group, attn_every 2, the encoder-decoder's 2 +
# 2), one step at B 1 x TWIN_T on the card and the same step on the CPU, held
# per leaf at TRAIN_PARAM_RTOL as qwen2.5-3b's twin is
TWIN_EXPERTS, TWIN_T = 8, 256
# head dims 96 and 192 (ROADMAP Queue 2 item 5): shapes of the checks, and
# the timed shapes of phase 5: nemotron-4-340b's prefill and last decode
# step (96 query heads, 8 kv heads, hd 192) and the same at hd 96
FA_HD192_PREFILL = (SERVE_B, 96, 8, SERVE_PROMPT, SERVE_PROMPT, 192, 0)
FA_HD192_DECODE = (SERVE_B, 96, 8, 1, SERVE_PROMPT + SERVE_DECODE, 192, 0)
FA_HD96_PREFILL = (SERVE_B, 96, 8, SERVE_PROMPT, SERVE_PROMPT, 96, 0)
FA_HD96_DECODE = (SERVE_B, 96, 8, 1, SERVE_PROMPT + SERVE_DECODE, 96, 0)
FA_NEW_HD = [shape for hd in (96, 192) for shape in (
    (1, 4, 2, 100, 100, hd, 0), (2, 4, 4, 64, 256, hd, 0),
    (1, 2, 2, 128, 128, hd, 32), (1, 4, 2, 96, 40, hd, 0),
    (2, 16, 2, 1, 97, hd, 0), (1, 24, 2, 1, LM_PROMPT + 1, hd, 0))]
# (B, H, KVH, T, S, hd, window) of the flash-attention checks: the JAX
# kernel test's shapes and windowed case, an unequal-pad causal shape, the
# served model's prefill and its first and last decode step (T = 1 over the
# prefix of a LM_PROMPT + LM_DECODE slot cache, a strided view)
FA_PREFILL = (LM_B, 16, 2, LM_PROMPT, LM_PROMPT, 128, 0)
FA_DECODE = [(LM_B, 16, 2, 1, LM_PROMPT + 1 + i, 128, 0)
             for i in (0, LM_DECODE - 1)]
FA_SHAPES = [(1, 4, 4, 64, 64, 32, 0), (2, 8, 2, 128, 128, 64, 0),
             (1, 4, 2, 100, 100, 32, 0), (2, 4, 4, 64, 256, 64, 0),
             (1, 2, 2, 128, 128, 32, 32), (1, 4, 2, 64, 200, 64, 0),
             FA_PREFILL, *FA_DECODE,
             # the other served models' prefills and glm4-9b's last decode
             # step, and the distillation teacher's forward
             (SERVE_B, 32, 2, SERVE_PROMPT, SERVE_PROMPT, 128, 0),
             (SERVE_B, 32, 2, 1, SERVE_PROMPT + SERVE_DECODE, 128, 0),
             (SERVE_B, 32, 8, SERVE_PROMPT, SERVE_PROMPT, 128, 0),
             (SERVE_B, 16, 8, 256 + SERVE_PROMPT, 256 + SERVE_PROMPT, 128, 0),
             (len(DISTILL_CLUSTERS), 16, 2, DISTILL_T, DISTILL_T, 128, 0),
             # arctic-480b's prefill and last decode step (GQA groups of 7)
             (SERVE_B, 56, 8, SERVE_PROMPT, SERVE_PROMPT, 128, 0),
             (SERVE_B, 56, 8, 1, SERVE_PROMPT + SERVE_DECODE, 128, 0),
             # head dims 96 and 192: ragged T, cross-length, a window, T > S
             # (rows that see no key), decode over one span and over many,
             # and nemotron-4-340b's prefill and last decode step (groups
             # of 12)
             *FA_NEW_HD,
             FA_HD192_PREFILL, FA_HD192_DECODE]
# (rtol, atol) of the kernel against its plain version.  Both keep scores,
# softmax weights and the product with V in float32 and round once, at the
# output: float32 to 2e-5 (measured <= 1.7e-6); bf16 to one rounding of the
# output, at most 2**-7 = 7.8e-3 of a value, over a float32 floor of 1e-4
# near zero.  (An atol of 3e-2 would be as large as a typical output:
# |out| has an RMS of about sqrt(e / S), 0.026 at the decode shapes.)
FA_TOL = {"float32": (2e-5, 2e-5), "bfloat16": (8e-3, 1e-4)}
# T > S: the first T - S queries see no key and average V (the -1e30 mask)
FA_MASKED = (1, 4, 2, 96, 40, 64, 0)
DEV = "cuda"


def emit(obj) -> None:
    print(json.dumps(obj), flush=True)


def bound_ms(nbytes: float, nops: float,
             flops_per_s: float = F32_FLOPS_PER_S) -> tuple[float, str]:
    tb = nbytes / HBM_BYTES_PER_S * 1e3
    to = nops / flops_per_s * 1e3
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


def check_bf16_ds(name, ds, want) -> float:
    """A bf16 KD gradient against the plain one in float32, at KD_BF16_DS."""
    rtol, floor = KD_BF16_DS
    return check_close(name, ds, want, rtol,
                       floor * float(want.abs().max()))


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
def _kernel_name(mangled: str) -> str:
    """``fa_decode_kernel<bf16,96,8>`` from an Itanium-mangled kernel name
    (the last name of its nest, and its template arguments: types and
    integers)."""
    import re
    rest, name = mangled[3:] if mangled.startswith("_ZN") else mangled, ""
    while rest[:1].isdigit():                  # <length><identifier> ...
        n = re.match(r"\d+", rest).group()
        name, rest = rest[len(n):len(n) + int(n)], rest[len(n) + int(n):]
    args, rest = [], rest[1:] if rest[:1] == "I" else ""
    while rest and rest[0] != "E":
        m = re.match(r"L([ib])(-?\d+)E", rest)
        if m:                                  # an int or bool argument
            args.append(m.group(2) if m.group(1) == "i"
                        else ("false", "true")[int(m.group(2))])
            rest = rest[m.end():]
        elif rest[0].isdigit():                # a named type
            n = re.match(r"\d+", rest).group()
            ident = rest[len(n):len(n) + int(n)]
            args.append({"__nv_bfloat16": "bf16", "__half": "f16"}.get(
                ident, ident))
            rest = rest[len(n) + int(n):]
        else:                                  # a builtin type
            args.append({"f": "f32", "i": "int"}.get(rest[0], rest[0]))
            rest = rest[1:]
    return name + (f"<{','.join(args)}>" if args else "")


def ptxas_usage(log: str) -> list[dict]:
    """Each kernel's registers and spills (bytes) from ``nvcc -Xptxas
    -v``'s log, by its name and template arguments."""
    import re
    out, cur = [], None
    for ln in log.splitlines():
        m = re.search(r"Compiling entry function '(\S+)'", ln)
        if m:
            cur = {"kernel": _kernel_name(m.group(1))}
            out.append(cur)
            continue
        m = re.search(r"(\d+) bytes spill stores, (\d+) bytes spill loads", ln)
        if m and cur is not None:
            cur["spill_stores"], cur["spill_loads"] = map(int, m.groups())
        m = re.search(r"Used (\d+) registers", ln)
        if m and cur is not None:
            cur["registers"] = int(m.group(1))
    return out


def phase_build():
    """The port's library: one nvcc per source, all started together;
    prints each kernel's registers and spills."""
    from repro_torch.kernels import _build
    info = _build.build()
    _build.library()
    emit({"phase": "build", "built": info["built"],
          "seconds": info["seconds"], "library": info["path"],
          "ptxas": ptxas_usage(info["log"])})


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


def _kd_inputs_on_card(T, V, dtype, seed):
    """``_kd_inputs``' distributions drawn by the card's generator: logits
    3 x standard normal, labels uniform with about a tenth of them -1."""
    import torch
    g = torch.Generator(device=DEV).manual_seed(seed)
    s = (torch.randn((T, V), generator=g, device=DEV) * 3).to(dtype)
    t = (torch.randn((T, V), generator=g, device=DEV) * 3).to(dtype)
    y = torch.randint(0, V, (T,), generator=g, device=DEV,
                      dtype=torch.int32)
    y[torch.rand((T,), generator=g, device=DEV) < 0.1] = -1
    return s, t, y


def _lane_grads(y, seed):
    """Per-row upstream gradients of the packed path's form: rows in lanes
    of ``BATCH``, each row ``w[lane] / valid_rows[lane]`` with a random
    positive ``w`` (the path's ``w`` is all ones)."""
    import numpy as np
    import torch
    T = y.shape[0]
    lanes = -(-T // BATCH)
    w = np.random.default_rng(seed).random(lanes).astype(np.float32) + 0.5
    lane = torch.arange(T, device=DEV) // BATCH
    valid = torch.zeros(lanes, device=DEV).index_add_(
        0, lane, (y >= 0).float()).clamp(min=1.0)
    return (torch.from_numpy(w).to(DEV) / valid)[lane].contiguous()


def _merge_inputs(N, D, dtype, seed, stale: bool):
    import numpy as np
    import torch
    r = np.random.default_rng(seed)
    x = torch.from_numpy((r.standard_normal((N, D)) * 2).astype(np.float32))
    w = torch.from_numpy((np.abs(r.standard_normal(N)) + 0.1).astype(np.float32))
    s = (r.integers(0, 4, N) if stale else np.zeros(N)).astype(np.float32)
    return (x.to(DEV, dtype), w.to(DEV), torch.from_numpy(s).to(DEV))


def _client_rows(N, dtypes, seed, *, student: bool = True, offset: int = 0,
                 device=None):
    """N clients' copies of the ten leaves of the MNIST student (FedSiKD's
    merge) or, with ``student=False``, of the teacher (the baselines'
    model) as separate tensors on ``device`` (default ``DEV``; leaf l in
    ``dtypes[l % len(dtypes)]``): the loop engine's merge input, with
    host-side weights and staleness.  With ``offset`` > 0 every odd
    client's leaves are views into a buffer that starts ``offset`` elements
    in (rows not 16-byte aligned, contiguous all the same).
    ``tests/test_torch_cuda.py`` builds its merge inputs here too."""
    import numpy as np
    import torch
    from repro_torch.models.cnn import MnistCNN
    shapes = [p.shape for p in MnistCNN(student=student).parameters()]
    r = np.random.default_rng(seed)
    rows = []
    for n in range(N):
        row = []
        for l, sh in enumerate(shapes):
            v = torch.from_numpy((r.standard_normal(sh) * 2).astype(np.float32))
            dtype = dtypes[l % len(dtypes)]
            if offset and n % 2:
                t = torch.empty(v.numel() + offset, dtype=dtype,
                                device=device or DEV)[offset:].view(sh)
                t.copy_(v)
            else:
                t = v.to(device or DEV, dtype)
            row.append(t)
        rows.append(row)
    w = (np.abs(r.standard_normal(N)) + 0.1).astype(np.float32)
    return rows, w, r.integers(0, 4, N).astype(np.float32)


def _kmeans_inputs(N, K, seed, F=KM_F):
    """Standard-normal points and centroids: at F = 2352 the gaps between a
    point's K distances are ~100 while the rounding is ~1e-3, so no
    assignment sits on a near-tie."""
    import numpy as np
    import torch
    r = np.random.default_rng(seed)
    x = torch.from_numpy(r.standard_normal((N, F)).astype(np.float32))
    c = torch.from_numpy(r.standard_normal((K, F)).astype(np.float32))
    return x.to(DEV), c.to(DEV)


def _fa_inputs(shape, dtype, seed, device=None):
    """Standard-normal q (B, T, H, hd) and k, v (B, S, KVH, hd) on
    ``device`` (default ``DEV``); at T = 1 k and v are the first S slots of
    a LM_PROMPT + LM_DECODE slot cache, as the decode path passes them.
    ``tests/test_torch_cuda.py`` builds its inputs here too."""
    import numpy as np
    import torch
    B, H, KVH, T, S, hd, _ = shape
    r = np.random.default_rng(seed)
    S_buf = LM_PROMPT + LM_DECODE if T == 1 else S

    def normal(*dims):
        return torch.from_numpy(r.standard_normal(dims, np.float32)).to(
            device or DEV, dtype)
    q = normal(B, T, H, hd)
    return q, normal(B, S_buf, KVH, hd)[:, :S], normal(B, S_buf, KVH, hd)[:, :S]


def _kd_check(T, V, dtype, seed, sms, draw=_kd_inputs):
    """One KD forward and backward call against the plain versions at the
    KD_TOL of ``dtype``, per-lane g, on inputs from ``draw``; raises unless
    each call was one launch of the regime ``plan`` gives.  Returns the
    forward's and backward's largest errors."""
    import torch
    from repro_torch.kernels import kd_softmax_kl as kd
    name = str(dtype)[6:]
    tol, btol = KD_TOL[name]
    s, t, y = draw(T, V, dtype, seed)
    regime = kd.plan(T, V, sms)["regime"]
    tag = f"T={T} V={V} {name} [{regime}]"
    before = (dict(kd.kd_loss_fwd.variant_launches),
              dict(kd.kd_loss_bwd.variant_launches))
    loss, stats = kd.kd_loss_fwd(s, t, y, tau=2.0, alpha=0.5)
    loss_p, stats_p = kd.kd_loss_fwd_plain(s, t, y, tau=2.0, alpha=0.5)
    g = _lane_grads(y, seed)
    ds = kd.kd_loss_bwd(s, t, y, stats, g, tau=2.0, alpha=0.5)
    ds_p = kd.kd_loss_bwd_plain(s, t, y, stats_p, g, tau=2.0, alpha=0.5)
    torch.cuda.synchronize()
    for fn, was in zip((kd.kd_loss_fwd, kd.kd_loss_bwd), before):
        took = {k: v - was[k] for k, v in fn.variant_launches.items()}
        if took != {k: int(k == regime) for k in kd.VARIANTS}:
            raise RuntimeError(f"{fn.__name__} {tag}: expected one "
                               f"'{regime}' launch, counted {took}")
    e_fwd = max(check_close(f"kd_fwd {tag} loss", loss, loss_p, tol,
                            tol * 10),
                check_close(f"kd_fwd {tag} stats", stats, stats_p, tol,
                            tol * 10))
    e_bwd = check_close(f"kd_bwd {tag} ds, per-lane g", ds, ds_p, btol,
                        btol)
    if dtype == torch.bfloat16:
        check_bf16_ds(f"kd_bwd {tag} ds, one rounding of the float32 ds",
                      ds, kd.kd_loss_bwd_plain(s.float(), t.float(), y,
                                               stats_p, g, tau=2.0,
                                               alpha=0.5))
    return e_fwd, e_bwd


def phase_kernel_checks():
    """Every kernel against its plain version on the card, the KD kernels at
    KD_CASES in every regime and at KD_BF16_CASES.  The KD rows of the
    kernels line carry the error at the packed path's shape: (2560, 10)
    rows and the per-lane wrapper ``ops.kd_distillation_loss_lanes`` on
    (40, 64, 10), held against the plain per-lane loss and its gradient;
    the flash-attention row the largest error at the served model's prefill
    and decode shapes, in float32 and bf16."""
    import numpy as np
    import torch
    from repro_torch.core.distill import distillation_loss
    from repro_torch.kernels import flash_attention as fa
    from repro_torch.kernels import fused_merge as fm
    from repro_torch.kernels import kd_softmax_kl as kd
    from repro_torch.kernels import kmeans_assign as km
    from repro_torch.kernels import ops
    errs = {"kd_softmax_kl_fwd": 0.0, "kd_softmax_kl_bwd": 0.0,
            "fused_merge": 0.0}
    sms = torch.cuda.get_device_properties(0).multi_processor_count
    for i, (T, V) in enumerate(KD_CASES):
        for dtype in (torch.float32, torch.bfloat16):
            e_fwd, e_bwd = _kd_check(T, V, dtype, 2 * i + (dtype != torch
                                                           .float32), sms)
            if (T, V, dtype) == (PATH_ROWS, 10, torch.float32):
                errs["kd_softmax_kl_fwd"] = e_fwd
                errs["kd_softmax_kl_bwd"] = e_bwd
    for i, (T, V) in enumerate(KD_BF16_CASES):
        _kd_check(T, V, torch.bfloat16, 100 + i, sms, draw=_kd_inputs_on_card)
        torch.cuda.empty_cache()
    s, t, y = _kd_inputs(PATH_ROWS, 10, torch.float32, 26)
    shape = (PACKED_LANES, BATCH, 10)
    s, t, y = s.reshape(shape), t.reshape(shape), y.reshape(shape[:2])
    w = torch.from_numpy(np.random.default_rng(27).random(PACKED_LANES)
                         .astype(np.float32) + 0.5).to(DEV)
    sg = s.clone().requires_grad_(True)
    lanes = ops.kd_distillation_loss_lanes(sg, t, y, tau=2.0, alpha=0.5)
    (ds,) = torch.autograd.grad((lanes * w).sum(), sg)
    sp = s.clone().requires_grad_(True)
    lanes_p = torch.stack([distillation_loss(sp[i], t[i], y[i],
                                             temperature=2.0, alpha=0.5)[0]
                           for i in range(PACKED_LANES)])
    (ds_p,) = torch.autograd.grad((lanes_p * w).sum(), sp)
    torch.cuda.synchronize()
    tag = f"kd_distillation_loss_lanes S={PACKED_LANES} B={BATCH} V=10"
    errs["kd_softmax_kl_fwd"] = max(
        errs["kd_softmax_kl_fwd"],
        check_close(tag + " per-lane loss", lanes.detach(), lanes_p.detach(),
                    2e-5, 2e-5))
    errs["kd_softmax_kl_bwd"] = max(
        errs["kd_softmax_kl_bwd"],
        check_close(tag + " grad", ds, ds_p, 1e-5, 1e-5))
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
    # the multi-leaf entry: one launch for a model's ten leaves
    def leaves_check(tag, rows, w, s, decay, tol):
        before = dict(fm.fused_merge.variant_launches)
        out = fm.fused_merge_leaves(rows, w, s, decay=decay)
        want = fm.fused_merge_leaves_plain(rows, w, s, decay=decay)
        torch.cuda.synchronize()
        took = {k: v - before[k] for k, v in
                fm.fused_merge.variant_launches.items()}
        if took != {"leaf": 0, "leaves": 1}:
            raise RuntimeError(f"{tag}: expected one 'leaves' launch, "
                               f"counted {took}")
        e = max(check_close(f"{tag} leaf {l}", o, ref, tol, tol)
                for l, (o, ref) in enumerate(zip(out, want)))
        errs["fused_merge"] = max(errs["fused_merge"], e)

    for N, dtype, decay, offset, tol, seed in (
            (40, torch.float32, 0.5, 0, 1e-5, 13),
            (300, torch.float32, 1.5, 0, 1e-5, 14),
            (40, torch.bfloat16, 0.0, 0, 2e-2, 15),
            (40, torch.float32, 0.5, 1, 1e-5, 16)):
        rows, w, s = _client_rows(N, (dtype,), seed, offset=offset)
        leaves_check(f"fused_merge_leaves N={N} 10 student leaves "
                     f"{str(dtype)[6:]} decay={decay}"
                     + (" misaligned rows" if offset else ""),
                     rows, w, s, decay, tol)
    # the baselines' merges: the teacher's ten leaves under example-count
    # weights; N = 40 is loop FedAvg's and FedProx's round, N = 7 (one
    # client with no examples) and N = 1 are FL+HC clusters, and the last
    # N = 40 is async FedAvg's (arrivals at staleness 1 or 2, decay 0.5)
    for N, seed, decay in ((40, 40, 0.0), (7, 41, 0.0), (1, 42, 0.0),
                           (40, 43, 0.5)):
        rows, _, _ = _client_rows(N, (torch.float32,), seed, student=False)
        r = np.random.default_rng(seed)
        w = r.integers(1, 3000, N).astype(np.float32)
        if N == 7:
            w[3] = 0.0
        s = (r.integers(0, 3, N) if decay else np.zeros(N)).astype(np.float32)
        leaves_check(f"fused_merge_leaves N={N} 10 teacher leaves float32, "
                     f"example counts {w.astype(int).tolist()[:8]}, "
                     f"staleness {s.astype(int).tolist()[:8]} decay={decay}",
                     rows, w, s, decay, 1e-5)
    errs["kmeans_assign"] = 0.0
    for N, K, F, seed in [(KM_N, k, KM_F, 7 + k) for k in (2, 3, 4, 5)] + [
            (16384, 8, KM_F, 12), (16384, 16, KM_F, 17),
            (KM_N, 5, KM_F - 2, 18), (16384, 8, KM_F - 2, 19)]:
        x, c = _kmeans_inputs(N, K, seed, F)
        regime = km.plan(N, F, K, sms)["regime"]
        before = dict(km.kmeans_assign.variant_launches)
        a, d = km.kmeans_assign(x, c)
        a_p, d_p = km.kmeans_assign_plain(x, c)
        torch.cuda.synchronize()
        took = [k for k, v in km.kmeans_assign.variant_launches.items()
                if v != before[k]]
        tag = f"kmeans_assign N={N} F={F} K={K} [{regime}]"
        if took != [regime]:
            raise RuntimeError(f"{tag}: the plan says {regime}, the call "
                               f"launched {took}")
        differ = int((a != a_p).sum())
        emit({"check": f"{tag} assignments", "differing": differ,
              "ok": differ == 0})
        if differ:
            raise RuntimeError(f"{tag}: {differ} assignments differ from the "
                               "plain version")
        e = check_close(f"{tag} dist", d, d_p, 1e-4, 1e-4)
        errs["kmeans_assign"] = max(errs["kmeans_assign"], e)
    errs["flash_attention"] = 0.0
    errs["flash_attention_decode"] = 0.0
    errs["flash_attention_hd96"] = 0.0
    errs["flash_attention_hd192"] = 0.0
    for shape in [*FA_SHAPES, FA_MASKED]:
        for dtype in (torch.float32, torch.bfloat16):
            q, k, v = _fa_inputs(shape, dtype, seed=sum(shape))
            window = shape[-1]
            before = dict(fa.flash_attention.variant_launches)
            out = fa.flash_attention(q, k, v, causal=True, window=window)
            want = fa.flash_attention_plain(q, k, v, causal=True,
                                            window=window)
            torch.cuda.synchronize()
            kind = fa.variant(dtype, shape[3])
            took = [name for name, n in fa.flash_attention.variant_launches
                    .items() if n != before[name]]
            tag = (f"flash_attention (B,H,KVH,T,S,hd,window)={shape} "
                   f"{str(dtype)[6:]} [{kind}]")
            if took != [kind]:
                raise RuntimeError(f"{tag}: the dispatch says {kind}, the "
                                   f"call launched {took}")
            e = check_close(tag, out, want, *FA_TOL[str(dtype)[6:]])
            if shape == FA_PREFILL or shape in FA_DECODE:
                key = "flash_attention" + ("_decode" if shape[3] == 1
                                           else "")
                errs[key] = max(errs[key], e)
            if shape[5] in (96, 192):
                key = f"flash_attention_hd{shape[5]}"
                errs[key] = max(errs[key], e)
            if shape == FA_MASKED:
                B, H, KVH, T, S = shape[:5]
                mean_v = v.float().mean(dim=1).repeat_interleave(H // KVH,
                                                                 dim=1)
                check_close(f"{tag}: the {T - S} rows that see no key "
                            "average V", out[:, :T - S],
                            mean_v[:, None].expand(-1, T - S, -1, -1)
                            .to(dtype), *FA_TOL[str(dtype)[6:]])
            del q, k, v, out, want
    return errs


# ------------------------------------------------------------------ phase 3
def phase_fused_distill(ds):
    import torch
    from repro_torch import rng
    from repro_torch.data.pipeline import make_client_shards
    from repro_torch.fed.client import make_steps
    from repro_torch.kernels import kd_softmax_kl as kd
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
    variants = {"fwd": dict(kd.kd_loss_fwd.variant_launches),
                "bwd": dict(kd.kd_loss_bwd.variant_launches)}
    p_ref, l_ref = epoch(steps["make_distill"](t_fwd, fused=False))
    n = len(l_fused)
    loss_rel = max(abs(a - b) / abs(b) for a, b in zip(l_fused, l_ref))
    param_abs = max(max_err(p_fused[k], p_ref[k]) for k in p_ref)
    emit({"phase": "fused_distill_step", "steps": n, "examples":
          shard.num_examples, "losses_fused": l_fused, "losses_ref": l_ref,
          "max_loss_rel_err": loss_rel, "max_param_abs_err": param_abs,
          "launches": counts, "kd_variants": variants})
    if loss_rel > 1e-5:
        raise RuntimeError(f"fused and reference distill losses differ by "
                           f"{loss_rel} relative (limit 1e-5)")
    if param_abs > 1e-3:
        raise RuntimeError(f"fused and reference distill params differ by "
                           f"{param_abs} (limit 1e-3)")
    if counts["kd_softmax_kl_fwd"] != n or counts["kd_softmax_kl_bwd"] != n:
        raise RuntimeError(f"expected {n} KD forward and backward launches "
                           f"in {n} steps, counted {counts}")
    all_rows = {"rows": n, "stream": 0}
    if variants != {"fwd": all_rows, "bwd": all_rows}:
        raise RuntimeError(f"expected every KD launch of the {n} steps on "
                           f"the rows kernels, counted {variants}")
    return counts


# ------------------------------------------------------------------ phase 4
def phase_main_path(ds):
    from repro_torch.fed.rounds import FedConfig, run_federated
    from repro_torch.kernels import fused_merge as fm
    from repro_torch.kernels import kmeans_assign as km
    from repro_torch.kernels import launch_counts, reset_launches

    cfg = FedConfig(algorithm="fedsikd", engine="loop", rounds=ROUNDS)
    reset_launches()
    t0 = time.perf_counter()
    h = run_federated(ds, cfg, device=DEV)
    total = time.perf_counter() - t0
    counts = launch_counts()
    merge_variants = dict(fm.fused_merge.variant_launches)
    km_variants = dict(km.kmeans_assign.variant_launches)
    emit({"phase": "main_path", "config": "fedsikd loop mnist 40 clients "
          f"alpha=0.5 batch=64 warmup=3 rounds={ROUNDS}",
          "acc": h["acc"], "loss": h["loss"],
          "teacher_loss": h["teacher_loss"],
          "student_loss": h["student_loss"],
          "round_seconds": h["round_seconds"],
          "num_clusters": h["num_clusters"], "participants":
          h["participants"], "seconds_total": total, "launches": counts,
          "fused_merge_variants": merge_variants,
          "kmeans_assign_variants": km_variants})
    # one merge a round, every leaf of the student in one launch
    if (counts["fused_merge"] != ROUNDS
            or merge_variants != {"leaf": 0, "leaves": ROUNDS}):
        raise RuntimeError(f"expected {ROUNDS} fused-merge launches, all "
                           f"'leaves', counted {counts['fused_merge']} "
                           f"({merge_variants})")
    want_km = expected_kmeans_launches(cfg, cfg.num_clients)
    if km_variants != {"split": want_km, "stream": 0}:
        raise RuntimeError(f"expected the clustering step's {want_km} "
                           f"kmeans_assign launches on the split kernel, "
                           f"counted {km_variants}")
    if counts["kmeans_assign"] != want_km:
        raise RuntimeError(f"expected {want_km} kmeans_assign launches in "
                           f"the clustering step, counted "
                           f"{counts['kmeans_assign']}")
    vals = h["acc"] + h["loss"] + h["teacher_loss"] + h["student_loss"]
    if not all(math.isfinite(v) for v in vals):
        raise RuntimeError(f"non-finite loop-path metrics: {vals}")
    return counts, h


def expected_kmeans_launches(cfg, n_clients: int) -> int:
    """Assignment launches of the clustering step: every Lloyd E-step plus
    the final assignment (``iters + 1``) for each candidate K of
    ``select_k`` and for the final ``kmeans``."""
    iters = 50                          # the default of select_k and kmeans
    if cfg.num_clusters is not None:
        return iters + 1
    lo, hi = cfg.k_range
    n_k = len(range(lo, min(hi, n_clients - 1) + 1))
    return (n_k + 1) * (iters + 1)


# ----------------------------------------------------------- phase 4b
def phase_packed_path(ds, loop_h):
    """The packed engine at the same configuration: every round's 40
    clients are lanes of one stacked program, so each student step is ONE
    KD forward and ONE KD backward launch for all lanes."""
    from repro_torch.data.pipeline import make_client_shards
    from repro_torch.fed.rounds import FedConfig, run_federated
    from repro_torch.fed.sharded import client_step_counts
    from repro_torch.kernels import kd_softmax_kl as kd
    from repro_torch.kernels import launch_counts, reset_launches

    cfg = FedConfig(algorithm="fedsikd", engine="sharded", pack=PACKED_LANES,
                    rounds=ROUNDS)
    shards = make_client_shards(ds, cfg.num_clients, cfg.alpha, seed=cfg.seed)
    budgets = client_step_counts(shards, cfg.batch_size, cfg.local_epochs)
    reset_launches()
    t0 = time.perf_counter()
    h = run_federated(ds, cfg, device=DEV)
    total = time.perf_counter() - t0
    counts = launch_counts()
    kd_variants = {"fwd": dict(kd.kd_loss_fwd.variant_launches),
                   "bwd": dict(kd.kd_loss_bwd.variant_launches)}
    want_kd = ROUNDS * int(budgets.max())      # full participation
    want_km = expected_kmeans_launches(cfg, cfg.num_clients)
    gaps = [abs(a - b) for a, b in zip(h["acc"], loop_h["acc"])]
    loss_gaps = {k: [abs(a - b) / abs(b) for a, b in zip(h[k], loop_h[k])]
                 for k in ("loss", "teacher_loss", "student_loss")}
    emit({"phase": "packed_path", "config": "fedsikd sharded pack=40 mnist "
          f"40 clients alpha=0.5 batch=64 warmup=3 rounds={ROUNDS}",
          "acc": h["acc"], "loss": h["loss"],
          "teacher_loss": h["teacher_loss"],
          "student_loss": h["student_loss"],
          "round_seconds": h["round_seconds"],
          "loop_round_seconds": loop_h["round_seconds"],
          "num_clusters": h["num_clusters"], "participants":
          h["participants"], "seconds_total": total,
          "student_steps_per_round": int(budgets.max()),
          "launches": counts, "expected_kd_launches": want_kd,
          "kd_variants": kd_variants,
          "expected_kmeans_launches": want_km,
          "acc_gap_to_loop": gaps, "loss_rel_gap_to_loop": loss_gaps})
    for name in ("kd_softmax_kl_fwd", "kd_softmax_kl_bwd"):
        if counts[name] != want_kd:
            raise RuntimeError(f"expected {want_kd} {name} launches (the "
                               f"longest student budget x {ROUNDS} rounds), "
                               f"counted {counts[name]}")
    all_rows = {"rows": want_kd, "stream": 0}
    if kd_variants != {"fwd": all_rows, "bwd": all_rows}:
        raise RuntimeError(f"expected all {want_kd} KD forward and backward "
                           f"launches on the rows kernels, counted "
                           f"{kd_variants}")
    if counts["kmeans_assign"] != want_km:
        raise RuntimeError(f"expected {want_km} kmeans_assign launches in "
                           f"the clustering step, counted "
                           f"{counts['kmeans_assign']}")
    vals = h["acc"] + h["loss"] + h["teacher_loss"] + h["student_loss"]
    if not all(math.isfinite(v) for v in vals):
        raise RuntimeError(f"non-finite packed-path metrics: {vals}")
    if max(gaps) > 0.03:
        raise RuntimeError(f"packed accuracy {h['acc']} is more than 3 "
                           f"points from the loop engine's {loop_h['acc']}")
    for k, g in loss_gaps.items():
        if max(g) > LOSS_RTOL_TO_LOOP:
            raise RuntimeError(f"packed {k} {h[k]} is more than "
                               f"{LOSS_RTOL_TO_LOOP} relative from the loop "
                               f"engine's {loop_h[k]}")
    return counts, h


# ----------------------------------------------------------- phase 4b2
BASELINE_MU = 0.01                     # FedProx's mu (FedConfig's default)
FLHC_K = 4                             # FL+HC's clusters (its default)


def _baseline_run(ds, name, cfg):
    """One baseline run on the card, its launch counts read just after; the
    counts are zeroed just before."""
    from repro_torch.fed.rounds import run_federated
    from repro_torch.kernels import fused_merge as fm
    from repro_torch.kernels import launch_counts, reset_launches
    reset_launches()
    t0 = time.perf_counter()
    h = run_federated(ds, cfg, device=DEV)
    total = time.perf_counter() - t0
    counts = launch_counts()
    merge_variants = dict(fm.fused_merge.variant_launches)
    vals = h["acc"] + h["loss"] + h.get("train_loss", [])
    if not all(math.isfinite(v) for v in vals):
        raise RuntimeError(f"non-finite {name} metrics: {vals}")
    return h, total, counts, merge_variants


def phase_baselines_path(ds, fedsikd_loop_h, fedsikd_packed_h):
    """The paper's baselines on the main path's configuration (full MNIST
    twin, 40 clients, alpha 0.5, batch 64, ROUNDS rounds; the teacher CNN
    of 95,242 parameters is the federated model): loop FedAvg, loop FedProx
    and loop FL+HC (its round 1 is the clustering pre-round), whose merges
    are fused-merge launches (one a round, and one a cluster for FL+HC),
    then packed FedAvg and packed FedProx with all 40 clients as lanes,
    whose merge is an (S,) product a leaf and launches no fused merge; each
    packed run is held to its loop run.  FedSiKD's round times from this
    same call stand beside theirs.  Returns each run's fused-merge
    launches."""
    from repro_torch.fed.rounds import FedConfig

    runs = [("fedavg loop", FedConfig(algorithm="fedavg", rounds=ROUNDS)),
            ("fedprox loop", FedConfig(algorithm="fedprox", rounds=ROUNDS,
                                       prox_mu=BASELINE_MU)),
            ("flhc loop", FedConfig(algorithm="flhc", rounds=ROUNDS,
                                    num_clusters=FLHC_K)),
            ("fedavg packed", FedConfig(algorithm="fedavg", engine="sharded",
                                        pack=PACKED_LANES, rounds=ROUNDS)),
            ("fedprox packed", FedConfig(algorithm="fedprox",
                                         engine="sharded", pack=PACKED_LANES,
                                         rounds=ROUNDS, prox_mu=BASELINE_MU))]
    hist, merges = {}, {}
    for name, cfg in runs:
        h, total, counts, merge_variants = _baseline_run(ds, name, cfg)
        hist[name], merges[name] = h, counts["fused_merge"]
        if name == "flhc loop":
            want = ROUNDS * h["num_clusters"]
        elif cfg.engine == "loop":
            want = ROUNDS
        else:
            want = 0
        emit({"phase": "baselines_path", "run": name, "config":
              f"{cfg.algorithm} {cfg.engine}"
              + (f" pack={cfg.pack}" if cfg.engine == "sharded" else "")
              + f" mnist {cfg.num_clients} clients alpha={cfg.alpha} "
              f"batch={cfg.batch_size} rounds={ROUNDS}"
              + (f" mu={cfg.prox_mu}" if cfg.algorithm == "fedprox" else "")
              + (f" K={h['num_clusters']}" if "num_clusters" in h else ""),
              "acc": h["acc"], "loss": h["loss"],
              "train_loss": h.get("train_loss"),
              "round_seconds": h["round_seconds"], "seconds_total": total,
              "participants": h["participants"],
              "fedsikd_loop_round_seconds": fedsikd_loop_h["round_seconds"],
              "fedsikd_packed_round_seconds":
              fedsikd_packed_h["round_seconds"],
              "launches": counts, "fused_merge_variants": merge_variants,
              "expected_fused_merge_launches": want})
        if merge_variants != {"leaf": 0, "leaves": want} \
                or counts["fused_merge"] != want:
            raise RuntimeError(f"{name}: expected {want} fused-merge "
                               f"launches, all 'leaves', counted "
                               f"{counts['fused_merge']} ({merge_variants})")
    for alg in ("fedavg", "fedprox"):
        loop, packed = hist[f"{alg} loop"], hist[f"{alg} packed"]
        gaps = [abs(a - b) for a, b in zip(packed["acc"], loop["acc"])]
        loss_gaps = [abs(a - b) / abs(b)
                     for a, b in zip(packed["loss"], loop["loss"])]
        emit({"check": f"baselines_path: packed {alg} against loop {alg}",
              "acc_gap": gaps, "loss_rel_gap": loss_gaps,
              "ok": max(gaps) <= 0.03
              and max(loss_gaps) <= LOSS_RTOL_TO_LOOP})
        if max(gaps) > 0.03:
            raise RuntimeError(f"packed {alg} accuracy {packed['acc']} is "
                               f"more than 3 points from the loop engine's "
                               f"{loop['acc']}")
        if max(loss_gaps) > LOSS_RTOL_TO_LOOP:
            raise RuntimeError(f"packed {alg} loss {packed['loss']} is more "
                               f"than {LOSS_RTOL_TO_LOOP} relative from the "
                               f"loop engine's {loop['loss']}")
    return merges, hist


# ----------------------------------------------------------- phase 4b2b
# The packed engine on a mesh of ranks: one process a rank over
# torch.distributed, each holding a contiguous block of the 40 slots.
MESH_RUNS = (("fedsikd", dict(algorithm="fedsikd", engine="sharded",
                              pack=PACKED_LANES, rounds=ROUNDS)),
             ("fedavg", dict(algorithm="fedavg", engine="sharded",
                             pack=PACKED_LANES, rounds=ROUNDS)))
MESH_LOSS_RTOL = 1e-6
MESH_TIMEOUT_S = 300


def _gloo_takes_cuda(dev) -> None:
    """Every collective the mesh uses, on CUDA tensors (raises if the
    backend refuses one)."""
    import torch
    import torch.distributed as dist
    x = torch.ones(3, device=dev)
    parts = [torch.empty_like(x) for _ in range(dist.get_world_size())]
    dist.all_gather(parts, x)
    dist.all_reduce(x)
    dist.all_reduce(torch.ones(1, dtype=torch.int32, device=dev))
    dist.all_reduce(torch.ones(1, dtype=torch.float64, device=dev),
                    op=dist.ReduceOp.MAX)
    dist.broadcast(x, src=0)
    dist.broadcast_object_list([1], src=0)
    torch.cuda.synchronize(dev)


def _mesh_timing(mesh, n_local: int, dev) -> dict:
    """ms of one teacher sync (the teacher CNN and its two Adam moments)
    and one student mean on this rank's block of the 40 slots, through
    the mesh and with every slot in one process."""
    import numpy as np
    import torch
    from repro_torch import rng
    from repro_torch.core import cluster_collectives as cc
    from repro_torch.launch.shardings import rank_slots
    from repro_torch.models.cnn import make_model
    S = PACKED_LANES
    mine = rank_slots(S, mesh)
    out = {}
    for name, student in (("teacher_sync", False), ("student_mean", True)):
        init = make_model("mnist", student=student)[0]
        p = [init(rng.fold_seed(0, i), dev) for i in range(S)]
        full = {k: torch.stack([q[k] for q in p]) for k in p[0]}
        if not student:              # params and two moments, as synced
            full = {f"{m}{k}": v for m in ("p.", "mu.", "nu.")
                    for k, v in full.items()}
        block = {k: v[mine] for k, v in full.items()}
        if student:
            table = torch.full((S,), 1.0 / S, device=dev)
            op = cc.packed_weighted_mean
        else:
            t = np.eye(S, dtype=np.float32)
            for c in range(4):               # 4 clusters of 10 slots
                t[c * 10:(c + 1) * 10, c * 10:(c + 1) * 10] = 0.1
            table = torch.from_numpy(t).to(dev)
            op = cc.packed_teacher_sync
        out[f"{name}_ms"] = time_ms(lambda: op(block, table, mesh=mesh),
                                    iters=10)
        out[f"{name}_one_process_ms"] = time_ms(lambda: op(full, table),
                                                iters=10)
        out[f"{name}_floats_a_slot"] = sum(v[0].numel()
                                           for v in full.values())
    out["slots_held"] = n_local
    return out


def _mesh_rank(rank, world, backend, device_type, small, runs, store, out):
    """One rank of a mesh world: joins the world over a ``FileStore``, runs
    ``runs`` (``MESH_RUNS`` on the card) through ``run_federated`` on the
    MNIST twin (``small``: the CPU's) with the launch counts zeroed just before
    each, and saves each run's history, counts and a digest of its global
    model after every round, and on the card the mesh operators' times.
    ``device_type`` "cpu" rehearses the phase on the CPU."""
    import datetime
    import hashlib
    import torch
    import torch.distributed as dist
    if device_type == "cuda":
        dev = torch.device("cuda", rank % torch.cuda.device_count())
        torch.cuda.set_device(dev)
    else:
        dev = torch.device("cpu")
        torch.set_num_threads(1)
    torch.backends.cuda.matmul.allow_tf32 = False   # as phase_setup sets
    torch.backends.cudnn.allow_tf32 = False
    dist.init_process_group(backend, store=dist.FileStore(store, world),
                            rank=rank, world_size=world,
                            timeout=datetime.timedelta(
                                seconds=MESH_TIMEOUT_S))
    try:
        if backend == "gloo" and device_type == "cuda":
            _gloo_takes_cuda(dev)
        from repro_torch.data.synthetic import load_dataset
        from repro_torch.fed import driver
        from repro_torch.fed.rounds import FedConfig, run_federated
        from repro_torch.kernels import kd_softmax_kl as kd
        from repro_torch.kernels import kmeans_assign as km
        from repro_torch.kernels import launch_counts, reset_launches
        ds = load_dataset("mnist", small=small)
        record = driver.RoundDriver._record
        res, algs = {}, []
        for name, kw in runs:
            digests = []

            def snapshot(self, history, rnd, digests=digests):
                g = getattr(self.alg, "sp_global", None) \
                    or self.alg.global_params
                digests.append(hashlib.sha256(b"".join(
                    g[k].detach().cpu().numpy().tobytes()
                    for k in sorted(g))).hexdigest())
                algs.append(self.alg)
                return record(self, history, rnd)

            driver.RoundDriver._record = snapshot
            try:
                reset_launches()
                t0 = time.perf_counter()
                h = run_federated(ds, FedConfig(**kw), device=dev)
                total = time.perf_counter() - t0
                counts = launch_counts()
            finally:
                driver.RoundDriver._record = record
            res[name] = {"history": h, "seconds_total": total,
                         "launches": counts, "digests": digests,
                         "kd_variants": {
                             "fwd": dict(kd.kd_loss_fwd.variant_launches),
                             "bwd": dict(kd.kd_loss_bwd.variant_launches)},
                         "kmeans_variants": dict(
                             km.kmeans_assign.variant_launches)}
        alg = algs[-1]
        res["timing"] = (_mesh_timing(alg.mesh, alg.n_local, dev)
                         if device_type == "cuda" else None)
        torch.save(res, f"{out}/rank{rank}.pt")
    finally:
        dist.destroy_process_group()


def _mesh_world(world, backend, device_type="cuda", small=False,
                runs=MESH_RUNS) -> list:
    """Spawn a world of ``world`` ranks of ``_mesh_rank``; returns each
    rank's results.  A rank that fails raises here."""
    import tempfile
    import torch
    import torch.multiprocessing as mp
    with tempfile.TemporaryDirectory() as tmp:
        mp.start_processes(_mesh_rank, args=(world, backend, device_type,
                                             small, runs, f"{tmp}/store",
                                             tmp),
                           nprocs=world, start_method="spawn")
        return [torch.load(f"{tmp}/rank{r}.pt", weights_only=False)
                for r in range(world)]


def _hold_mesh(label, ranks, refs, want_kd, want_km, runs=MESH_RUNS) -> dict:
    """Hold a mesh world's runs to the one-process packed runs ``refs``:
    equal accuracy, losses within ``MESH_LOSS_RTOL``, the same history and
    global model on every rank, exact KD and k-means launches a rank."""
    world = len(ranks)
    summary = {}
    for name, _ in runs:
        h, ref = ranks[0][name]["history"], refs[name]
        keys = [k for k in ("loss", "teacher_loss", "student_loss",
                            "train_loss") if k in ref]
        gaps = {k: max(abs(a - b) / abs(b) for a, b in zip(h[k], ref[k]))
                for k in keys}
        bit_equal = h["acc"] == ref["acc"] and all(h[k] == ref[k]
                                                    for k in keys)
        per_rank = [{"kd_fwd": r[name]["launches"]["kd_softmax_kl_fwd"],
                     "kd_bwd": r[name]["launches"]["kd_softmax_kl_bwd"],
                     "kd_variants": r[name]["kd_variants"],
                     "kmeans_assign": r[name]["launches"]["kmeans_assign"],
                     "kmeans_variants": r[name]["kmeans_variants"],
                     "fused_merge": r[name]["launches"]["fused_merge"]}
                    for r in ranks]
        summary[name] = {"acc": h["acc"], "loss": h["loss"],
                         **{k: h[k] for k in keys},
                         "reference_acc": ref["acc"],
                         "round_seconds": h["round_seconds"],
                         "reference_round_seconds": ref["round_seconds"],
                         "seconds_total": [r[name]["seconds_total"]
                                           for r in ranks],
                         "loss_rel_gap": gaps, "bit_equal": bit_equal,
                         "launches_per_rank": per_rank}
        if h["acc"] != ref["acc"]:
            raise RuntimeError(f"{label} {name}: accuracy {h['acc']} is not "
                               f"the one-process run's {ref['acc']}")
        for k, g in gaps.items():
            if g > MESH_LOSS_RTOL:
                raise RuntimeError(f"{label} {name}: {k} {h[k]} is more "
                                   f"than {MESH_LOSS_RTOL} relative from "
                                   f"the one-process run's {ref[k]}")
        for rank in range(1, world):
            other = ranks[rank][name]
            if other["history"] != h or \
                    other["digests"] != ranks[0][name]["digests"]:
                raise RuntimeError(f"{label} {name}: rank {rank}'s history "
                                   "or global model differs from rank 0's")
        kd_want = want_kd if name == "fedsikd" else 0
        rows = {"rows": kd_want, "stream": 0}
        for rank, c in enumerate(per_rank):
            km_want = want_km if name == "fedsikd" and rank == 0 else 0
            if (c["kd_fwd"], c["kd_bwd"]) != (kd_want, kd_want) or \
                    c["kd_variants"] != {"fwd": rows, "bwd": rows}:
                raise RuntimeError(f"{label} {name} rank {rank}: expected "
                                   f"{kd_want} KD launches each way, all "
                                   f"'rows', counted {c}")
            if c["kmeans_assign"] != km_want:
                raise RuntimeError(f"{label} {name} rank {rank}: expected "
                                   f"{km_want} kmeans_assign launches, "
                                   f"counted {c['kmeans_assign']}")
            if c["fused_merge"]:
                raise RuntimeError(f"{label} {name} rank {rank}: a "
                                   "synchronous packed round launched a "
                                   "fused merge")
    return summary


def phase_mesh_path(ds, packed_h, fedavg_packed_h, smi):
    """The packed engine on a mesh of ranks: one NCCL rank a card runs the
    packed path's FedSiKD configuration and packed FedAvg through the
    mesh code, held to the one-process runs (``packed_path`` and
    ``baselines_path``); then, on a one-card machine, a world of 2 gloo
    ranks sharing the card, held the same way.  Returns rank 0's launch
    counts of the NCCL world's FedSiKD run."""
    import torch
    from repro_torch.data.pipeline import make_client_shards
    from repro_torch.fed.rounds import FedConfig
    from repro_torch.fed.sharded import client_step_counts
    cfg = FedConfig(**dict(MESH_RUNS)["fedsikd"])
    shards = make_client_shards(ds, cfg.num_clients, cfg.alpha, seed=cfg.seed)
    budgets = client_step_counts(shards, cfg.batch_size, cfg.local_epochs)
    want_kd = ROUNDS * int(budgets.max())
    want_km = expected_kmeans_launches(cfg, cfg.num_clients)
    refs = {"fedsikd": packed_h, "fedavg": fedavg_packed_h}
    worlds = [(torch.cuda.device_count(), "nccl")]
    if torch.cuda.device_count() == 1:
        worlds.append((2, "gloo"))
    first = None
    for world, backend in worlds:
        label = f"{backend} world of {world}"
        t0 = time.perf_counter()
        try:
            ranks = _mesh_world(world, backend)
        except Exception as e:
            if backend == "gloo" and "_gloo_takes_cuda" in str(e):
                emit({"phase": "mesh_path", "world": world,
                      "backend": backend, "card": smi,
                      "left_out": "gloo refused CUDA tensors: "
                      + str(e)[-500:]})
                continue
            raise
        emit({"phase": "mesh_path", "world": world, "backend": backend,
              "card": smi, "config": "fedsikd and fedavg sharded pack=40 "
              f"mnist 40 clients alpha=0.5 batch=64 rounds={ROUNDS}, "
              f"{PACKED_LANES // world} slots a rank",
              "seconds": time.perf_counter() - t0,
              "runs": _hold_mesh(label, ranks, refs, want_kd, want_km),
              "timing_per_rank": [r["timing"] for r in ranks]})
        if first is None:
            first = ranks[0]["fedsikd"]["launches"]
    return first


# ----------------------------------------------------------- phase 4b3
# The paper's join-and-share path: clients join with DP-noised statistics,
# leave, are re-clustered warm, and straggle (semi-async rounds), with
# checkpoints every round.  32 clients are on the roster at round 1.
RUNTIME_KNOBS = dict(dp_noise=0.05, join_schedule=((2, 4), (3, 4)),
                     leave_rate=0.05, recluster_every=2, async_mode=True,
                     straggler_frac=0.4, max_staleness=2,
                     staleness_decay=0.5)
RUNTIME_ROUNDS = 4
RUNTIME_CUT = 2                         # the interrupted run stops here
PACKED_RUNTIME_ROUNDS = 3
PACKED_RUNTIME_CUT = 2
# keys the round plans decide: a resumed run repeats them exactly
PLAN_KEYS = ("participants", "labels_history", "stragglers", "stale_merged",
             "stale_dropped", "buffered")


def _determinism_probe(ds) -> dict:
    """Which op of the path repeats bit for bit on the card: each is run
    twice on the same inputs (the full roster's DP-noised statistics, one
    teacher CE step, one student distill step, warm k-means, one merge of
    40 students) and compared with ``torch.equal``."""
    import torch
    from repro_torch import rng
    from repro_torch.core import aggregation, kmeans, stats
    from repro_torch.data.pipeline import make_client_shards
    from repro_torch.fed.algorithms.clustered_kd import stat_features
    from repro_torch.fed.client import make_steps
    from repro_torch.fed.rounds import FedConfig
    from repro_torch.models.cnn import make_model
    from repro_torch.optim import adamw

    cfg = FedConfig(dp_noise=RUNTIME_KNOBS["dp_noise"])
    shards = make_client_shards(ds, cfg.num_clients, cfg.alpha, seed=cfg.seed)
    out = {}
    f1, f2 = (stat_features(shards, cfg, device=DEV) for _ in range(2))
    out["stat_features (batched_moments: index_add_)"] = torch.equal(f1, f2)
    feats = stats.standardize(f1)
    (c1, a1, _), (c2, a2, _) = (kmeans.kmeans_warm(feats, feats[:5].clone())
                                for _ in range(2))
    out["kmeans_warm"] = torch.equal(c1, c2) and torch.equal(a1, a2)
    x, y = next(shards[0].batches(cfg.batch_size, seed=cfg.seed))
    batch = {"x": x, "y": y}
    t_init, t_fwd = make_model(ds.name, student=False)
    s_init, s_fwd = make_model(ds.name, student=True)
    tp = t_init(rng.fold_seed(0), DEV)
    sp = s_init(rng.fold_seed(1), DEV)
    opt = adamw(cfg.lr)
    ce = make_steps(t_fwd, opt)["ce"]
    distill = make_steps(s_fwd, opt)["make_distill"](t_fwd)
    for name, run in (
            ("teacher CE step (cuDNN)",
             lambda: ce(tp, opt.init(tp), batch, 0)),
            ("student distill step (cuDNN)",
             lambda: distill(sp, opt.init(sp), batch, 0, tp))):
        (p1, _, l1), (p2, _, l2) = run(), run()
        out[name + ": loss"] = torch.equal(l1, l2)
        out[name + ": params"] = all(torch.equal(p1[k], p2[k]) for k in p1)
    students = [s_init(rng.fold_seed(2, i), DEV) for i in range(40)]
    m1, m2 = (aggregation.weighted_average(students, list(range(1, 41)))
              for _ in range(2))
    out["fused merge"] = all(torch.equal(m1[k], m2[k]) for k in m1)
    return out


def _merging_rounds(h) -> int:
    """Rounds that merged anything: an on-time participant or an arrival."""
    stragglers = h.get("stragglers") or [0] * len(h["participants"])
    arrived = h.get("stale_merged") or [0] * len(h["participants"])
    return sum(1 for p, st, a in zip(h["participants"], stragglers, arrived)
               if p - st > 0 or a > 0)


def _timed(fn, into: list):
    """``fn`` with its seconds (device work included) appended to ``into``."""
    def timed(*args, **kw):
        import torch
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        out = fn(*args, **kw)
        torch.cuda.synchronize()
        into.append(time.perf_counter() - t0)
        return out
    return timed


def _runtime_run(ds, cfg, saves=None, events=None):
    """One run on the card with its launch counts (zeroed just before, read
    just after); ``saves`` and ``events`` collect the seconds of each
    checkpoint save and each re-clustering event."""
    from repro_torch.fed import fedstate
    from repro_torch.fed.algorithms import clustered_kd
    from repro_torch.fed.rounds import run_federated
    from repro_torch.kernels import fused_merge as fm
    from repro_torch.kernels import kmeans_assign as km
    from repro_torch.kernels import launch_counts, reset_launches
    save_round = fedstate.save_round
    base = clustered_kd._ClusteredKDBase
    apply_lifecycle = base.apply_lifecycle
    if saves is not None:
        fedstate.save_round = _timed(save_round, saves)
    if events is not None:
        base.apply_lifecycle = _timed(apply_lifecycle, events)
    try:
        reset_launches()
        t0 = time.perf_counter()
        h = run_federated(ds, cfg, device=DEV)
        total = time.perf_counter() - t0
        counts = {**launch_counts(),
                  "fused_merge_variants":
                  dict(fm.fused_merge.variant_launches),
                  "fused_merge_stale": fm.fused_merge.stale_launches,
                  "kmeans_assign_variants":
                  dict(km.kmeans_assign.variant_launches)}
    finally:
        fedstate.save_round = save_round
        base.apply_lifecycle = apply_lifecycle
    vals = [v for k in ("acc", "loss", "teacher_loss", "student_loss")
            for v in h.get(k, []) if v is not None]
    if not all(math.isfinite(v) for v in vals):
        raise RuntimeError(f"non-finite metrics: {vals}")
    return h, total, counts


def _restore_checker(ckpt_dir, found):
    """A wrapper of ``RoundDriver._resume`` that holds the state the run
    restored (read back from the strategy and the buffer, on the card) to
    the checkpoint's arrays, bit for bit, and notes the result in
    ``found``."""
    import numpy as np
    from repro_torch import convert
    from repro_torch.checkpoint import ckpt
    from repro_torch.fed import driver, fedstate
    resume = driver.RoundDriver._resume

    def checked(self, history, fp):
        rnd = resume(self, history, fp)
        arrays = self.alg.checkpoint_arrays()
        if self.buffer is not None:
            arrays["_async_buffer"] = [convert.params_to_jax(p)
                                       for p in self.buffer.params_list()]
        got = ckpt._flatten(arrays)
        with np.load(fedstate.round_path(ckpt_dir, rnd)) as z:
            saved = {k: z[k] for k in z.files}
        bad = sorted(k for k in saved.keys() | got.keys()
                     if k not in got or k not in saved
                     or got[k].dtype != saved[k].dtype
                     or not np.array_equal(got[k], saved[k]))
        found.update(arrays=len(saved), bad=bad,
                     buffer=sum(k.startswith("_async_buffer/")
                                for k in saved))
        return rnd

    return resume, checked


def _resumed_against(ds, cfg, h_full, cut, ckpt_dir):
    """``cfg`` run to ``cut`` rounds into ``ckpt_dir`` through the
    background writer (``async_ckpt``: card tensors copied on its thread),
    then resumed to its end; the restore held to the checkpoint bit for bit
    and the resumed history's plan keys to ``h_full``'s.  Returns the
    resumed history and the restore check."""
    import dataclasses
    from repro_torch.fed import driver
    _runtime_run(ds, dataclasses.replace(cfg, rounds=cut, ckpt_dir=ckpt_dir,
                                         async_ckpt=True))
    found = {}
    resume, checked = _restore_checker(ckpt_dir, found)
    driver.RoundDriver._resume = checked
    try:
        h_res, _, _ = _runtime_run(ds, dataclasses.replace(
            cfg, ckpt_dir=ckpt_dir, resume=True))
    finally:
        driver.RoundDriver._resume = resume
    if not found or found["bad"]:
        raise RuntimeError(f"restore is not bit-exact: {found}")
    for key in PLAN_KEYS:
        if h_res.get(key) != h_full.get(key):
            raise RuntimeError(f"resumed {key} {h_res.get(key)} differs from "
                               f"the uninterrupted run's {h_full.get(key)}")
    return h_res, found


def _hold_resumed(name, h_res, h_full, bitwise: bool):
    """The resumed run's accuracy and eval loss against the uninterrupted
    run's: equal where two uninterrupted runs agree bit for bit, else
    within 3 points and LOSS_RTOL_TO_LOOP."""
    gaps = [abs(a - b) for a, b in zip(h_res["acc"], h_full["acc"])]
    loss_gaps = [abs(a - b) / abs(b)
                 for a, b in zip(h_res["loss"], h_full["loss"])]
    if bitwise:
        ok = h_res["acc"] == h_full["acc"] and h_res["loss"] == h_full["loss"]
    else:
        ok = max(gaps) <= 0.03 and max(loss_gaps) <= LOSS_RTOL_TO_LOOP
    emit({"check": f"runtime_path: {name} resumed against uninterrupted",
          "required": "bit-identical" if bitwise else
          f"3 points, {LOSS_RTOL_TO_LOOP} relative", "acc_gap": gaps,
          "loss_rel_gap": loss_gaps, "ok": ok})
    if not ok:
        raise RuntimeError(f"{name}: resumed acc {h_res['acc']} / loss "
                           f"{h_res['loss']} against {h_full['acc']} / "
                           f"{h_full['loss']}")


def _check_merges(name, h, counts):
    """One ``leaves`` merge launch for every round that merged anything,
    at least one of them merging a late update (s >= 1)."""
    want = _merging_rounds(h)
    if counts["fused_merge"] != want or counts["fused_merge_variants"] != {
            "leaf": 0, "leaves": want}:
        raise RuntimeError(f"{name}: expected {want} fused-merge launches, "
                           f"all 'leaves', counted {counts['fused_merge']} "
                           f"({counts['fused_merge_variants']})")
    if sum(h["stale_merged"]) < 1 or counts["fused_merge_stale"] < 1:
        raise RuntimeError(f"{name}: no late update merged (stale_merged "
                           f"{h['stale_merged']}, stale launches "
                           f"{counts['fused_merge_stale']})")


def phase_runtime_path(ds, loop_h, packed_h):
    """The join-and-share path on the main path's twin (full MNIST, 40
    clients, alpha 0.5, batch 64).  Run 1: loop FedSiKD with DP-noised
    statistics, joins and leaves, warm re-clustering every 2 rounds,
    stragglers (semi-async) and a checkpoint every round; again as 2 rounds
    (checkpointed by the background writer) plus a resume to round 4, its
    restore bit-exact; and a second
    uninterrupted run, which says whether runs on the card repeat bit for
    bit.  Run 2: loop FedAvg with the same knobs and no checkpoint.  Run
    3: packed FedSiKD (pack 40) with DP noise and checkpoints, 2 rounds and
    a resume to 3 against 3 uninterrupted rounds.  Returns the launches and
    the loop runs' histories."""
    import dataclasses
    import tempfile
    from repro_torch.fed.rounds import FedConfig

    out = {}
    with tempfile.TemporaryDirectory() as tmp:
        cfg = FedConfig(algorithm="fedsikd", rounds=RUNTIME_ROUNDS,
                        ckpt_every=1, ckpt_dir=f"{tmp}/full",
                        **RUNTIME_KNOBS)
        saves, event_s = [], []
        h, total, counts = _runtime_run(ds, cfg, saves, event_s)
        h_again, _, _ = _runtime_run(ds, dataclasses.replace(
            cfg, ckpt_dir=f"{tmp}/again"))
        bitwise = all(h_again[k] == h[k] for k in
                      ("acc", "loss", "teacher_loss", "student_loss"))
        h_res, found = _resumed_against(ds, cfg, h, RUNTIME_CUT,
                                        f"{tmp}/cut")
        events = sum(1 for r in h["recluster"] if r)
        n0 = cfg.num_clients - sum(c for _, c in cfg.join_schedule)
        want_km = expected_kmeans_launches(cfg, n0) + 51 * events
        emit({"phase": "runtime_path", "run": "fedsikd loop", "config":
              f"fedsikd loop mnist {cfg.num_clients} clients ({n0} at round "
              f"1) alpha={cfg.alpha} batch={cfg.batch_size} "
              f"rounds={cfg.rounds} " + " ".join(
                  f"{k}={v}" for k, v in RUNTIME_KNOBS.items()),
              "acc": h["acc"], "loss": h["loss"],
              "round_seconds": h["round_seconds"],
              "sync_loop_round_seconds": loop_h["round_seconds"],
              "checkpoint_save_seconds": saves,
              "reclustering_seconds": event_s,
              "seconds_total": total,
              **{k: h.get(k) for k in PLAN_KEYS},
              "recluster": h["recluster"],
              "migrated_teachers": h["migrated_teachers"],
              "launches": counts, "expected_kmeans_launches": want_km,
              "reclustering_events": events,
              "two_runs_bit_identical": bitwise,
              "again_acc": h_again["acc"], "again_loss": h_again["loss"],
              "restore": found, "resumed_acc": h_res["acc"],
              "resumed_loss": h_res["loss"],
              "resumed_round_seconds": h_res["round_seconds"]})
        if counts["kmeans_assign"] != want_km:
            raise RuntimeError(f"fedsikd loop: expected {want_km} "
                               f"kmeans_assign launches (setup + 51 x "
                               f"{events} re-clusterings), counted "
                               f"{counts['kmeans_assign']}")
        _check_merges("fedsikd loop", h, counts)
        if not bitwise:
            emit({"phase": "runtime_path", "run": "determinism probe",
                  "bit_identical_twice": _determinism_probe(ds)})
        _hold_resumed("fedsikd loop", h_res, h, bitwise)
        out["fedsikd loop runtime"] = counts

        cfg2 = FedConfig(algorithm="fedavg", rounds=RUNTIME_ROUNDS,
                         **RUNTIME_KNOBS)
        h2, total2, counts2 = _runtime_run(ds, cfg2)
        emit({"phase": "runtime_path", "run": "fedavg loop", "config":
              "fedavg loop, the same knobs, no checkpoint",
              "acc": h2["acc"], "loss": h2["loss"],
              "round_seconds": h2["round_seconds"], "seconds_total": total2,
              **{k: h2.get(k) for k in PLAN_KEYS if k in h2},
              "launches": counts2})
        _check_merges("fedavg loop", h2, counts2)
        if counts2["kmeans_assign"]:
            raise RuntimeError("fedavg loop launched kmeans_assign")
        out["fedavg loop runtime"] = counts2

        cfg3 = FedConfig(algorithm="fedsikd", engine="sharded",
                         pack=PACKED_LANES, rounds=PACKED_RUNTIME_ROUNDS,
                         dp_noise=RUNTIME_KNOBS["dp_noise"],
                         ckpt_dir=f"{tmp}/packed")
        h3, total3, counts3 = _runtime_run(ds, cfg3)
        h3_again, _, _ = _runtime_run(ds, dataclasses.replace(
            cfg3, ckpt_dir=None))
        bitwise3 = all(h3_again[k] == h3[k] for k in
                       ("acc", "loss", "teacher_loss", "student_loss"))
        h3_res, found3 = _resumed_against(ds, cfg3, h3, PACKED_RUNTIME_CUT,
                                          f"{tmp}/packed_cut")
        want_km3 = expected_kmeans_launches(cfg3, cfg3.num_clients)
        emit({"phase": "runtime_path", "run": "fedsikd packed", "config":
              f"fedsikd sharded pack={PACKED_LANES} dp_noise="
              f"{cfg3.dp_noise} rounds={cfg3.rounds}, checkpoints",
              "acc": h3["acc"], "loss": h3["loss"],
              "round_seconds": h3["round_seconds"],
              "sync_packed_round_seconds": packed_h["round_seconds"],
              "seconds_total": total3, "launches": counts3,
              "two_runs_bit_identical": bitwise3, "restore": found3,
              "resumed_acc": h3_res["acc"], "resumed_loss": h3_res["loss"]})
        if counts3["kmeans_assign"] != want_km3 or counts3["fused_merge"]:
            raise RuntimeError(f"fedsikd packed: expected {want_km3} "
                               f"kmeans_assign and 0 fused-merge launches, "
                               f"counted {counts3}")
        _hold_resumed("fedsikd packed", h3_res, h3, bitwise3)
        out["fedsikd packed runtime"] = counts3
    return out, {"fedsikd loop": h, "fedavg loop": h2}


# ----------------------------------------------------------- phase 4b3
SCALE_ROUNDS = 4
SCALE_UNIVERSE = 100_000
SCALE_COHORT = 120
SCALE = dict(algorithm="fedsikd", engine="sharded", rounds=SCALE_ROUNDS,
             participation="stratified", clients_per_round=SCALE_COHORT,
             pack=PACKED_LANES, n_devices=1, teacher_data="leader")
SCALE_FEDAVG = dict(algorithm="fedavg", rounds=SCALE_ROUNDS,
                    participation="stratified", clients_per_round=32,
                    dropout_rate=0.2, async_mode=True, straggler_frac=0.4,
                    max_staleness=2)
ASYNC_KEYS = ("participants", "stragglers", "stale_merged", "stale_dropped")


def _arrivals_only_rounds(h) -> int:
    """Rounds with arrivals and no on-time lane: the packed engine merges
    those (and only those) in one fused-merge launch."""
    stragglers = h.get("stragglers") or [0] * len(h["participants"])
    arrived = h.get("stale_merged") or [0] * len(h["participants"])
    return sum(1 for p, st, a in zip(h["participants"], stragglers, arrived)
               if p - st == 0 and a > 0)


def _scale_run(ds, cfg):
    """``_runtime_run`` with the ``perf`` spans on and the KD launches the
    run's plans call for: each wave's longest student budget, summed over
    rounds and waves (read from the plans the strategy is handed)."""
    import numpy as np
    from repro_torch import perf
    from repro_torch.fed.algorithms import clustered_kd
    from repro_torch.kernels import kd_softmax_kl as kd
    cls = clustered_kd.ShardedClusteredKD
    run_round = cls.run_round
    want = {"kd": 0, "waves": 0}

    def counted(self, plan, rnd):
        for w in range(plan.n_waves):
            wp = plan.wave(w)
            if wp.active.any():
                want["kd"] += int(np.max(wp.steps_for(self.s_steps_all)))
                want["waves"] += 1
        return run_round(self, plan, rnd)

    cls.run_round = counted
    perf.enable()
    try:
        h, total, counts = _runtime_run(ds, cfg)
        buckets = perf.snapshot()
    finally:
        cls.run_round = run_round
        perf.disable()
    counts["kd_variants"] = {"fwd": dict(kd.kd_loss_fwd.variant_launches),
                             "bwd": dict(kd.kd_loss_bwd.variant_launches)}
    keys = ("stage", "compute", "aggregate", "stage_hidden", "stage_wait",
            "round_total", "eval", "checkpoint")
    breakdown = {k: [b.get(k, 0.0) for b in buckets] for k in keys}
    return h, total, counts, want, breakdown


def _steady(h) -> float:
    """Mean seconds a round over rounds 2 to the end."""
    return statistics.fmean(h["round_seconds"][1:])


def _gaps(h, ref):
    return ([abs(a - b) for a, b in zip(h["acc"], ref["acc"])],
            [abs(a - b) / abs(b) for a, b in zip(h["loss"], ref["loss"])])


def _hold(name, h, ref, acc_tol, loss_tol, keys=()):
    """``h``'s accuracy and eval loss within ``acc_tol`` / ``loss_tol``
    relative of ``ref``'s each round, and the plan keys equal."""
    gaps, loss_gaps = _gaps(h, ref)
    if max(gaps) > acc_tol or max(loss_gaps) > loss_tol:
        raise RuntimeError(f"{name}: acc {h['acc']} / loss {h['loss']} "
                           f"against {ref['acc']} / {ref['loss']} (bounds "
                           f"{acc_tol}, {loss_tol} relative)")
    for key in keys:
        if h.get(key) != ref.get(key):
            raise RuntimeError(f"{name}: {key} {h.get(key)} differs from "
                               f"{ref.get(key)}")
    return gaps, loss_gaps


def _check_scale_launches(name, cfg, counts, want, n_clients, events=0,
                          merges=0):
    """Exact launches: every KD launch on the rows kernels, as many as the
    waves' longest student budgets; 255 + 51 x re-clusterings
    ``kmeans_assign``; ``merges`` fused merges, all ``leaves``."""
    want_km = expected_kmeans_launches(cfg, n_clients) + 51 * events
    rows = {"rows": want["kd"], "stream": 0}
    if counts["kd_variants"] != {"fwd": rows, "bwd": rows}:
        raise RuntimeError(f"{name}: expected {want['kd']} KD forward and "
                           f"backward launches, all rows, counted "
                           f"{counts['kd_variants']}")
    if counts["kmeans_assign"] != want_km:
        raise RuntimeError(f"{name}: expected {want_km} kmeans_assign "
                           f"launches, counted {counts['kmeans_assign']}")
    if counts["fused_merge"] != merges or counts["fused_merge_variants"] != {
            "leaf": 0, "leaves": merges}:
        raise RuntimeError(f"{name}: expected {merges} fused-merge launches, "
                           f"all 'leaves', counted "
                           f"{counts['fused_merge_variants']}")
    return want_km


def phase_scale_path(ds, runtime_h):
    """The packed engine at cross-device scale on the main path's twin
    (full MNIST, 40 base clients, alpha 0.5, batch 64, 3 warm-up epochs).
    Run 1: packed FedSiKD over a virtual universe of 100,000 clients,
    stratified cohorts of 120 streamed through 40 slots in 3 waves, under
    the guards; run 2 the same over a universe of 1,000; run 3 the cohort
    in one wave of 120 slots, to which run 1 is held.  Run 4: packed
    FedSiKD with the join-and-share knobs of ``runtime_path``, held to its
    loop run, interrupted and resumed.  Run 5: packed FedAvg in 2 waves of
    16 with sampling, dropout and stragglers under the guards, held to loop
    FedAvg with the same knobs.  Each run's launches are counted exactly.
    Returns the launches by run."""
    import dataclasses
    import tempfile
    from repro_torch.fed.rounds import FedConfig

    out = {}
    base = FedConfig()
    n_base = base.num_clients
    runs = {}
    for name, kw in (
            ("universe 100000", dict(universe=SCALE_UNIVERSE, guards=True)),
            ("universe 1000", dict(universe=1_000, guards=True)),
            ("one wave", dict(universe=SCALE_UNIVERSE, pack=SCALE_COHORT,
                              n_devices=None))):
        cfg = FedConfig(**{**SCALE, **kw})
        h, total, counts, want, breakdown = _scale_run(ds, cfg)
        want_km = _check_scale_launches(name, cfg, counts, want, n_base)
        runs[name] = h
        out[f"fedsikd packed {name}"] = counts
        emit({"phase": "scale_path", "run": f"fedsikd packed {name}",
              "config": f"fedsikd sharded mnist {n_base} base clients "
              f"alpha={cfg.alpha} universe={cfg.universe} stratified "
              f"cohort={cfg.clients_per_round} pack={cfg.pack} "
              f"n_devices={cfg.n_devices} guards={cfg.guards} "
              f"rounds={cfg.rounds}",
              "waves_per_round": want["waves"] // cfg.rounds,
              "acc": h["acc"], "loss": h["loss"],
              "teacher_loss": h["teacher_loss"],
              "student_loss": h["student_loss"],
              "participants": h["participants"],
              "round_seconds": h["round_seconds"],
              "steady_s_per_round": _steady(h), "seconds_total": total,
              "launches": counts, "expected_kd_launches": want["kd"],
              "expected_kmeans_launches": want_km, "perf": breakdown})
    ratio = (_steady(runs["universe 100000"])
             / _steady(runs["universe 1000"]))
    gaps, loss_gaps = _hold("3 waves against one wave",
                            runs["universe 100000"], runs["one wave"],
                            0.01, 1e-2, ("participants",))
    emit({"phase": "scale_path", "check": "3 waves against one wave of "
          "the same cohort", "required": "1 point, 1e-2 relative loss",
          "acc_gap": gaps, "loss_rel_gap": loss_gaps,
          "steady_s_per_round": {k: _steady(h) for k, h in runs.items()},
          "universe_ratio_100000_over_1000": ratio})

    with tempfile.TemporaryDirectory() as tmp:
        loop_h = runtime_h["fedsikd loop"]
        cfg = FedConfig(algorithm="fedsikd", engine="sharded",
                        pack=PACKED_LANES, rounds=RUNTIME_ROUNDS,
                        ckpt_every=1, ckpt_dir=f"{tmp}/full",
                        **RUNTIME_KNOBS)
        h, total, counts, want, breakdown = _scale_run(ds, cfg)
        h_again, _, _ = _runtime_run(ds, dataclasses.replace(
            cfg, ckpt_dir=f"{tmp}/again"))
        bitwise = all(h_again[k] == h[k] for k in
                      ("acc", "loss", "teacher_loss", "student_loss"))
        h_res, found = _resumed_against(ds, cfg, h, RUNTIME_CUT,
                                        f"{tmp}/cut")
        events = sum(1 for r in h["recluster"] if r)
        n0 = cfg.num_clients - sum(c for _, c in cfg.join_schedule)
        merges = _arrivals_only_rounds(h)
        want_km = _check_scale_launches("fedsikd packed join-and-share", cfg,
                                        counts, want, n0, events, merges)
        labels_equal = h["labels_history"] == loop_h["labels_history"]
        gaps, loss_gaps = _hold("fedsikd packed join-and-share against loop", h,
                                loop_h, 0.03, LOSS_RTOL_TO_LOOP, ASYNC_KEYS)
        emit({"phase": "scale_path", "run": "fedsikd packed join-and-share",
              "config": f"fedsikd sharded pack={PACKED_LANES} mnist "
              f"{cfg.num_clients} clients ({n0} at round 1) "
              f"rounds={cfg.rounds} " + " ".join(
                  f"{k}={v}" for k, v in RUNTIME_KNOBS.items()),
              "acc": h["acc"], "loss": h["loss"],
              "loop_acc": loop_h["acc"], "loop_loss": loop_h["loss"],
              "acc_gap_to_loop": gaps, "loss_rel_gap_to_loop": loss_gaps,
              **{k: h.get(k) for k in PLAN_KEYS},
              "labels_history_equal_to_loop": labels_equal,
              "round_seconds": h["round_seconds"],
              "loop_round_seconds": loop_h["round_seconds"],
              "steady_s_per_round": _steady(h), "seconds_total": total,
              "launches": counts, "expected_kd_launches": want["kd"],
              "expected_kmeans_launches": want_km,
              "expected_fused_merges": merges, "reclustering_events": events,
              "two_runs_bit_identical": bitwise, "restore": found,
              "resumed_acc": h_res["acc"], "resumed_loss": h_res["loss"],
              "perf": breakdown})
        _hold_resumed("fedsikd packed", h_res, h, bitwise)
        out["fedsikd packed join-and-share"] = counts

    packed_kw = dict(engine="sharded", pack=16, n_devices=1)
    h_loop, total_loop, counts_loop = _runtime_run(
        ds, FedConfig(**SCALE_FEDAVG))
    # under the guards, so the driver warms the arrival fold (one N = 1
    # merge) in round 1 and the guarded rounds 3-4 merge with no new plan
    cfg = FedConfig(**SCALE_FEDAVG, **packed_kw, guards=True)
    h, total, counts, _, breakdown = _scale_run(ds, cfg)
    merges = _arrivals_only_rounds(h) + 1
    if counts["fused_merge"] != merges or counts["fused_merge_variants"] != {
            "leaf": 0, "leaves": merges} or counts["kd_softmax_kl_fwd"] \
            or counts["kmeans_assign"]:
        raise RuntimeError(f"fedavg packed 2 waves: expected {merges} "
                           f"fused merges (arrivals-only rounds + the "
                           f"warm-in's), all 'leaves', and no KD or k-means "
                           f"launches, counted {counts}")
    loop_merges = _merging_rounds(h_loop)
    if counts_loop["fused_merge"] != loop_merges:
        raise RuntimeError(f"fedavg loop: expected {loop_merges} merges, "
                           f"counted {counts_loop['fused_merge']}")
    gaps, loss_gaps = _hold("fedavg packed 2 waves against loop", h, h_loop,
                            0.03, LOSS_RTOL_TO_LOOP, ASYNC_KEYS[:3])
    emit({"phase": "scale_path", "run": "fedavg packed 2 waves",
          "config": "fedavg sharded pack=16 n_devices=1 mnist 40 clients "
          "stratified cohort=32 (2 waves) dropout=0.2 async straggler_frac="
          "0.4 max_staleness=2 guards=True rounds=4, against loop fedavg",
          "acc": h["acc"], "loss": h["loss"], "loop_acc": h_loop["acc"],
          "loop_loss": h_loop["loss"], "acc_gap_to_loop": gaps,
          "loss_rel_gap_to_loop": loss_gaps,
          **{k: h.get(k) for k in ASYNC_KEYS},
          "round_seconds": h["round_seconds"],
          "loop_round_seconds": h_loop["round_seconds"],
          "steady_s_per_round": _steady(h),
          "loop_steady_s_per_round": _steady(h_loop),
          "seconds_total": total, "loop_seconds_total": total_loop,
          "launches": counts, "loop_launches": counts_loop,
          "expected_fused_merges": merges, "perf": breakdown})
    out["fedavg packed 2 waves"] = counts
    out["fedavg loop scale"] = counts_loop
    return out


# ----------------------------------------------------------- phase 4c
def _grow(cache, extra: int):
    """The prefill's (L, B, T, KVH, hd) caches (MLA's (L, B, T, r)) with
    ``extra`` empty slots for the decode steps (the caller's job, as in the
    JAX tests).  RWKV's carries and a hybrid's Mamba2 states and
    window-sized attention buffers keep their size."""
    import torch
    if "state" in cache or "mamba" in cache:
        return cache
    return {k: torch.cat([c, torch.zeros_like(c[:, :, :extra])], dim=2)
            for k, c in cache.items()}


def _serve(cfg, params, prompt, n_decode: int, prefix=None):
    """Prefill ``prompt`` (B, T) (after a VLM's ``prefix`` (B, P, d)), then
    ``n_decode`` greedy steps, through the serving entry points.  Returns
    the logits of every step (the prefill's last-token logits first), the
    generated tokens and the prefill and decode seconds (host clock, each
    ending in a synchronize; the decode loop itself never waits for the
    device)."""
    import torch
    from repro_torch.launch.steps import make_decode_step, make_prefill_step
    prefill, decode = make_prefill_step(cfg), make_decode_step(cfg)
    batch = {"tokens": prompt}
    if prefix is not None:
        batch["prefix"] = prefix
    T = prompt.shape[1] + (0 if prefix is None else prefix.shape[1])
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    last, cache = prefill(params, batch)
    torch.cuda.synchronize()
    t1 = time.perf_counter()
    cache = _grow(cache, n_decode)
    logits, toks = [last], []
    for i in range(n_decode):
        tok = logits[-1].argmax(dim=-1, keepdim=True)
        toks.append(tok)
        out, cache = decode(params, cache, tok, T + i)
        logits.append(out)
    torch.cuda.synchronize()
    t2 = time.perf_counter()
    return logits, torch.cat(toks, dim=1), t1 - t0, t2 - t1


def _serve_audio(cfg, params, frames, prompt, n_decode: int):
    """The encoder-decoder's serve through its entry points: the prefill
    step encodes ``frames`` (B, F, d) and runs the decoder over ``prompt``
    (B, P) (the last token's logits and the encoder memory; no
    self-attention cache, as in JAX), the memory goes into a decode cache
    of P + ``n_decode`` slots (``encdec.init_cache``), the prompt is
    replayed through the decode step at positions 0..P-1, and
    ``n_decode`` greedy steps follow.  Returns (the prefill's logits and
    each greedy step's, the replay's logits, the generated tokens, the
    prefill, replay and decode seconds)."""
    import torch
    from repro_torch.launch.steps import make_decode_step, make_prefill_step
    from repro_torch.models import encdec as ed
    prefill, decode = make_prefill_step(cfg), make_decode_step(cfg)
    B, P = prompt.shape
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    last, memory = prefill(params, {"frames": frames, "tokens": prompt})
    torch.cuda.synchronize()
    t1 = time.perf_counter()
    cache = ed.init_cache(cfg, B, P + n_decode, frames.shape[1],
                          device=memory.device)
    cache["memory"] = memory
    replay = []
    for t in range(P):
        out, cache = decode(params, cache, prompt[:, t:t + 1], t)
        replay.append(out)
    torch.cuda.synchronize()
    t2 = time.perf_counter()
    logits, toks = [last], []
    for i in range(n_decode):
        tok = logits[-1].argmax(dim=-1, keepdim=True)
        toks.append(tok)
        out, cache = decode(params, cache, tok, P + i)
        logits.append(out)
    torch.cuda.synchronize()
    t3 = time.perf_counter()
    return (logits, replay, torch.cat(toks, dim=1), t1 - t0, t2 - t1,
            t3 - t2)


def _count_requiring_grad(tree) -> int:
    """Tensors in a nest of dicts, lists and tuples that require grad."""
    if isinstance(tree, dict):
        return sum(_count_requiring_grad(v) for v in tree.values())
    if isinstance(tree, (list, tuple)):
        return sum(_count_requiring_grad(v) for v in tree)
    return int(bool(getattr(tree, "requires_grad", False)))


def _lm_prompt(cfg):
    import numpy as np
    import torch
    r = np.random.default_rng(LM_SEED + 1)
    return torch.from_numpy(r.integers(0, cfg.vocab_size, (LM_B, LM_PROMPT))
                            ).to(DEV)


def _note(timed, group, arch, cfg, kind, spec, ms, peak_gb, **kw):
    """One timed LM step for the dry-run phase: its config (with its
    cuts), kind, batch (``INPUT_SHAPES``'s keys), measured ms, the measured
    peak of its run (``group``: the steps one peak covers) and the dry
    run's keywords (accum, the distill path and replicas)."""
    timed.append({"group": group, "arch": arch, "cfg": cfg, "kind": kind,
                  "spec": {**spec, "kind": "train" if kind == "fedsikd"
                           else kind},
                  "ms": ms, "peak_gb": peak_gb, "kw": kw})


def phase_lm_serve(smi, timed):
    """The served model's main path: full qwen2.5-3b (36 layers, d_model
    2048, 16/2 heads, head_dim 128, vocab 151936, bf16), a prefill of
    LM_B x LM_PROMPT tokens and LM_DECODE greedy decode steps, after one
    untimed warm-up serve.  Every attention is one flash-attention launch,
    so the path makes L x (1 + LM_DECODE) of them.  Then a float32 copy
    with 2 layers at the same widths serves the same traffic, and each
    step's logits are held to a full forward of the same tokens.  Each
    served model's prefill and decode step go into ``timed``."""
    import dataclasses

    import torch
    from repro_torch.configs import get_config
    from repro_torch.kernels import flash_attention as fa
    from repro_torch.kernels import launch_counts, reset_launches
    from repro_torch.models import transformer as tf

    allocated_before = torch.cuda.memory_allocated() / 1e9
    cfg = get_config(LM_ARCH)
    params = tf.init_lm(LM_SEED, cfg, device=DEV)
    # the flash kernels refuse inputs that need a gradient: serving's
    # weights must not require one
    needs_grad = _count_requiring_grad(params)
    if needs_grad:
        raise RuntimeError(f"init_lm made {needs_grad} tensors that require "
                           "grad; serving would reach the flash kernels' "
                           "no-backward guard")
    prompt = _lm_prompt(cfg)
    _serve(cfg, params, prompt, 2)                       # warm-up
    torch.cuda.reset_peak_memory_stats()
    reset_launches()
    logits, toks, pre_s, dec_s = _serve(cfg, params, prompt, LM_DECODE)
    counts = launch_counts()
    variants = dict(fa.flash_attention.variant_launches)
    finite = bool(torch.isfinite(torch.stack(logits).float()).all())
    want_fa = cfg.num_layers * (1 + LM_DECODE)
    want_variants = {"v1": 0, "tensor_core": cfg.num_layers,
                     "decode": cfg.num_layers * LM_DECODE}
    peak = torch.cuda.max_memory_allocated() / 1e9
    group = f"lm_serve {LM_ARCH}"
    _note(timed, group, LM_ARCH, cfg, "prefill",
          {"seq_len": LM_PROMPT, "global_batch": LM_B}, pre_s * 1e3, peak)
    _note(timed, group, LM_ARCH, cfg, "decode",
          {"seq_len": LM_PROMPT + LM_DECODE, "global_batch": LM_B},
          dec_s * 1e3 / LM_DECODE, peak)
    emit({"phase": "lm_serve", "card": smi,
          "config": f"{LM_ARCH} full width and depth ({cfg.num_layers} "
          f"layers, d_model {cfg.d_model}, {cfg.num_heads}/"
          f"{cfg.num_kv_heads} heads, head_dim {cfg.hd}, vocab "
          f"{cfg.vocab_size}), {cfg.dtype}, random weights seed {LM_SEED}",
          "params": cfg.param_count(), "params_requiring_grad": needs_grad,
          "batch": LM_B, "prompt": LM_PROMPT,
          "decode_steps": LM_DECODE, "prefill_ms": pre_s * 1e3,
          "prefill_tokens_per_s": LM_B * LM_PROMPT / pre_s,
          "decode_ms_per_token": dec_s * 1e3 / LM_DECODE,
          "decode_tokens_per_s": LM_B * LM_DECODE / dec_s,
          "peak_memory_gb": peak,
          "allocated_before_gb": allocated_before,
          "generated_tokens_row0": toks[0].tolist(),
          "logits_finite": finite, "launches": counts,
          "expected_flash_attention_launches": want_fa,
          "flash_attention_variants": variants,
          "expected_flash_attention_variants": want_variants})
    if counts["flash_attention"] != want_fa:
        raise RuntimeError(f"expected {want_fa} flash_attention launches "
                           f"({cfg.num_layers} layers x (1 + {LM_DECODE})), "
                           f"counted {counts['flash_attention']}")
    if variants != want_variants:
        raise RuntimeError(f"expected the flash_attention kernels "
                           f"{want_variants} (bf16 prefill on the tensor "
                           f"cores, T = 1 on the decode kernel), counted "
                           f"{variants}")
    if not finite:
        raise RuntimeError("the served model produced non-finite logits")
    del params, logits
    torch.cuda.empty_cache()

    cfg32 = dataclasses.replace(cfg, num_layers=2, dtype="float32")
    params = tf.init_lm(LM_SEED, cfg32, device=DEV)
    logits, toks, _, _ = _serve(cfg32, params, prompt, LM_DECODE)
    full, _ = tf.forward(params, cfg32,
                         {"tokens": torch.cat([prompt, toks], dim=1)})
    want = full[:, LM_PROMPT - 1:LM_PROMPT + LM_DECODE].transpose(0, 1)
    got = torch.stack(logits)
    gap = (got - want).abs()
    share = float((gap / (LM_CONSISTENCY_TOL
                          + LM_CONSISTENCY_TOL * want.abs())).max())
    ok = share <= 1.0
    emit({"check": f"lm_serve float32 2-layer: prefill + {LM_DECODE} decode "
          "steps vs a full forward of the same tokens",
          "max_abs_err": float(gap.max()), "max_share_of_bound": share,
          "max_abs_logit": float(want.abs().max()),
          "rtol": LM_CONSISTENCY_TOL, "atol": LM_CONSISTENCY_TOL, "ok": ok})
    if not ok:
        raise RuntimeError(f"decode logits differ from the full forward by "
                           f"{float(gap.max())} (limit {LM_CONSISTENCY_TOL})")
    # want is a view of full's 2 x 4128 x 151936 float32 logits (5.0 GB)
    del params, logits, full, want, got, gap
    torch.cuda.empty_cache()
    more = {arch: _serve_other(arch, smi, timed) for arch in SERVE_MORE}
    return counts, variants, more


def _init_serving(cfg):
    """Random params of ``cfg`` on the card, seed LM_SEED (the
    encoder-decoder's ``init_encdec``, every other family's ``init_lm``)."""
    from repro_torch.models import encdec as ed
    from repro_torch.models import transformer as tf
    init = ed.init_encdec if cfg.arch_type == "audio" else tf.init_lm
    return init(LM_SEED, cfg, device=DEV)


def _audio_frames(cfg, r):
    """seamless's request: SERVE_B x SERVE_AUDIO // frame_ratio frame
    embeddings, standard normal from the numpy generator ``r``."""
    import numpy as np
    import torch
    from repro_torch.models.layers import DTYPES
    return torch.from_numpy(r.standard_normal(
        (SERVE_B, SERVE_AUDIO // cfg.frame_ratio, cfg.d_model),
        np.float32)).to(DEV, DTYPES[cfg.dtype])


def _expected_flash(cfg, steps: int) -> dict:
    """The flash kernels a serve of ``cfg`` launches, by kernel: one
    ``tensor_core`` per attention layer in the bf16 prefill, one ``decode``
    per attention layer and decode step.  Attention layers: none for MLA
    (plain torch) or RWKV, one a group for a hybrid (the shared block),
    the decoder's for the encoder-decoder (its encoder and
    cross-attention are plain torch), every layer otherwise."""
    if cfg.use_mla or cfg.arch_type == "ssm":
        layers = 0
    elif cfg.arch_type == "hybrid":
        layers = cfg.num_layers // cfg.attn_every
    else:
        layers = cfg.num_layers
    return {"v1": 0, "tensor_core": layers, "decode": layers * steps}


def _family(cfg) -> str:
    """The served config's attention and mixer, for the emitted line."""
    if cfg.use_mla:
        return (f"MLA (kv_lora_rank {cfg.kv_lora_rank}, q_lora_rank "
                f"{cfg.q_lora_rank}, qk {cfg.qk_nope_dim}+{cfg.qk_rope_dim}, "
                f"v {cfg.v_head_dim})")
    if cfg.arch_type == "ssm":
        return f"RWKV6 time mix, {cfg.num_heads} heads of {cfg.hd}"
    if cfg.arch_type == "hybrid":
        d_in = cfg.ssm_expand * cfg.d_model
        heads = cfg.ssm_heads or max(1, d_in // 64)
        return (f"Mamba2 (d_inner {d_in}, {heads} SSD heads of "
                f"{d_in // heads}, state {cfg.ssm_state}), shared attention "
                f"{cfg.num_heads}/{cfg.num_kv_heads} heads of {cfg.hd}, "
                f"window {cfg.sliding_window}, after every {cfg.attn_every} "
                "layers")
    if cfg.arch_type == "audio":
        return (f"{cfg.num_encoder_layers} encoder + {cfg.num_layers} "
                f"decoder layers, {cfg.num_heads}/{cfg.num_kv_heads} heads "
                f"of {cfg.hd}, frames {SERVE_AUDIO // cfg.frame_ratio}")
    return (f"{cfg.num_heads}/{cfg.num_kv_heads} heads, head_dim {cfg.hd}")


def _serve_other(arch, smi, timed):
    """One of the other served models at full width (random weights, seed
    LM_SEED; a VLM's prefix and an audio model's frames standard normal
    from a seed), at full depth or the depth SERVE_DEPTH gives:
    SERVE_B x SERVE_PROMPT tokens and SERVE_DECODE greedy steps after a
    warm-up serve (seamless: SERVE_AUDIO audio positions, a decoder prompt
    of SERVE_AUDIO_PROMPT tokens replayed through decode, then the steps).
    Raises unless the flash kernels took exactly ``_expected_flash``'s
    launches and the logits are finite; a depth-cut model's decode, and a
    CHECK_FULL_DEPTH model's, is then held to a full forward
    (``_check_decode``).  Returns the launch counts and the expected flash
    launches; the prefill and a decode step go into ``timed``."""
    import dataclasses

    import numpy as np
    import torch
    from repro_torch.configs import get_config
    from repro_torch.kernels import flash_attention as fa
    from repro_torch.kernels import launch_counts, reset_launches
    from repro_torch.models.layers import DTYPES

    full = get_config(arch)
    cfg = dataclasses.replace(full, num_layers=SERVE_DEPTH.get(
        arch, full.num_layers))
    params = _init_serving(cfg)
    r = np.random.default_rng(LM_SEED + 2)
    audio = cfg.arch_type == "audio"
    P = SERVE_AUDIO_PROMPT if audio else SERVE_PROMPT
    prompt = torch.from_numpy(r.integers(0, cfg.vocab_size,
                                         (SERVE_B, P))).to(DEV)
    prefix = frames = None
    if cfg.prefix_len:
        prefix = torch.from_numpy(r.standard_normal(
            (SERVE_B, cfg.prefix_len, cfg.d_model), np.float32)).to(
                DEV, DTYPES[cfg.dtype])
    if audio:
        frames = _audio_frames(cfg, r)
        _serve_audio(cfg, params, frames, prompt, 2)     # warm-up
    else:
        _serve(cfg, params, prompt, 2, prefix)           # warm-up
    torch.cuda.reset_peak_memory_stats()
    resident = torch.cuda.memory_allocated()
    reset_launches()
    replay_s = None
    if audio:
        logits, _, toks, pre_s, replay_s, dec_s = _serve_audio(
            cfg, params, frames, prompt, SERVE_DECODE)
    else:
        logits, toks, pre_s, dec_s = _serve(cfg, params, prompt,
                                            SERVE_DECODE, prefix)
    counts = launch_counts()
    variants = dict(fa.flash_attention.variant_launches)
    finite = bool(torch.isfinite(torch.stack(logits).float()).all())
    want = _expected_flash(cfg, SERVE_DECODE + (P if audio else 0))
    depth = (f"{cfg.num_layers} layers" if cfg.num_layers == full.num_layers
             else f"depth cut to {cfg.num_layers} of {full.num_layers} "
             "layers to fit 80 GB")
    moe = (f", {cfg.num_experts} experts top-{cfg.num_experts_per_tok}"
           f" (+{cfg.num_shared_experts} shared"
           + (", dense residual" if cfg.moe_dense_residual else "")
           + f"), capacity factor {cfg.capacity_factor}"
           if cfg.num_experts else "")
    positions = P + cfg.prefix_len
    peak = torch.cuda.max_memory_allocated() / 1e9
    spec = {"global_batch": SERVE_B}
    if audio:
        spec["frames"] = frames.shape[1]
    _note(timed, f"lm_serve {arch}", arch, cfg, "prefill",
          {**spec, "seq_len": positions}, pre_s * 1e3, peak)
    _note(timed, f"lm_serve {arch}", arch, cfg, "decode",
          {**spec, "seq_len": positions + SERVE_DECODE},
          dec_s * 1e3 / SERVE_DECODE, peak)
    line = {"phase": "lm_serve", "card": smi,
            "config": f"{arch} full width, {depth} (d_model {cfg.d_model}, "
            f"{_family(cfg)}, d_ff {cfg.d_ff} {cfg.activation}{moe}, vocab "
            f"{cfg.vocab_size}, prefix {cfg.prefix_len}), {cfg.dtype}, "
            f"random weights seed {LM_SEED}",
            "params": cfg.param_count(),
            "params_full_depth": full.param_count(),
            "layers": cfg.num_layers, "layers_full": full.num_layers,
            "batch": SERVE_B, "prompt": P, "prefix": cfg.prefix_len,
            "decode_steps": SERVE_DECODE, "prefill_ms": pre_s * 1e3,
            "prefill_tokens_per_s": SERVE_B * positions / pre_s,
            "decode_ms_per_token": dec_s * 1e3 / SERVE_DECODE,
            "decode_tokens_per_s": SERVE_B * SERVE_DECODE / dec_s,
            "peak_memory_gb": peak,
            "allocated_before_serve_gb": resident / 1e9,
            "generated_tokens_row0": toks[0].tolist(),
            "logits_finite": finite, "launches": counts,
            "flash_attention_variants": variants,
            "expected_flash_attention_variants": want}
    if audio:
        line.update({"audio_positions": SERVE_AUDIO,
                     "frames": frames.shape[1],
                     "replay_ms": replay_s * 1e3,
                     "replay_ms_per_token": replay_s * 1e3 / P})
    emit(line)
    if variants != want or counts["flash_attention"] != sum(want.values()):
        raise RuntimeError(f"{arch}: expected the flash_attention kernels "
                           f"{want}, counted {variants} "
                           f"({counts['flash_attention']} launches)")
    if not finite:
        raise RuntimeError(f"{arch}: the served model produced non-finite "
                           "logits")
    del params, logits
    torch.cuda.empty_cache()
    if cfg.num_layers != full.num_layers or arch in CHECK_FULL_DEPTH:
        _check_decode(arch, full, smi)
    return {"launches": counts, "expected_flash": sum(want.values())}


def _check_decode(arch, full, smi):
    """A float32 copy of ``full`` at full width, with one layer (a
    depth-cut model) or at full depth (CHECK_FULL_DEPTH), serves
    SERVE_CHECK_PROMPT tokens and SERVE_DECODE greedy steps; each step's
    logits are held to a full forward of the same tokens at
    LM_CONSISTENCY_TOL (the encoder-decoder's on the same frames, its
    replayed prompt's logits too).  Prefill drops tokens over capacity and
    decode never does, so the MoE capacity factor is raised to E / k + 1,
    at which the forward drops none either."""
    import dataclasses

    import numpy as np
    import torch
    from repro_torch.models import encdec as ed
    from repro_torch.models import transformer as tf

    layers = full.num_layers if arch in CHECK_FULL_DEPTH else 1
    cfg = dataclasses.replace(full, num_layers=layers, dtype="float32")
    if cfg.num_experts:
        cfg = dataclasses.replace(cfg, capacity_factor=cfg.num_experts
                                  / cfg.num_experts_per_tok + 1)
    params = _init_serving(cfg)
    r = np.random.default_rng(LM_SEED + 3)
    prompt = torch.from_numpy(r.integers(
        0, cfg.vocab_size, (SERVE_B, SERVE_CHECK_PROMPT))).to(DEV)
    P = SERVE_CHECK_PROMPT
    torch.cuda.reset_peak_memory_stats()
    if cfg.arch_type == "audio":
        frames = _audio_frames(cfg, r)
        logits, replay, toks, _, _, _ = _serve_audio(cfg, params, frames,
                                                     prompt, SERVE_DECODE)
        full_logits, _ = ed.forward(params, cfg, {
            "frames": frames, "tokens": torch.cat([prompt, toks], dim=1)})
        got = torch.stack(replay + logits)
        want = torch.cat([full_logits[:, :P],
                          full_logits[:, P - 1:P + SERVE_DECODE]],
                         dim=1).transpose(0, 1)
    else:
        logits, toks, _, _ = _serve(cfg, params, prompt, SERVE_DECODE)
        full_logits, _ = tf.forward(params, cfg, {"tokens": torch.cat(
            [prompt, toks], dim=1)})
        got = torch.stack(logits)
        want = full_logits[:, P - 1:P + SERVE_DECODE].transpose(0, 1)
    gap = (got - want).abs()
    share = float((gap / (LM_CONSISTENCY_TOL
                          + LM_CONSISTENCY_TOL * want.abs())).max())
    ok = share <= 1.0
    depth = ("1 layer" if layers == 1 else f"full depth ({layers} layers)")
    emit({"check": f"lm_serve {arch} float32 {depth} at full width: prefill "
          f"{P} + {SERVE_DECODE} decode steps vs a full forward of the same "
          "tokens" + (" (the prompt replayed through decode)"
                      if cfg.arch_type == "audio" else "")
          + (f" (capacity factor {cfg.capacity_factor})"
             if cfg.num_experts else ""),
          "card": smi, "max_abs_err": float(gap.max()),
          "max_share_of_bound": share,
          "max_abs_logit": float(want.abs().max()),
          "peak_memory_gb": torch.cuda.max_memory_allocated() / 1e9,
          "rtol": LM_CONSISTENCY_TOL, "atol": LM_CONSISTENCY_TOL, "ok": ok})
    if not ok:
        raise RuntimeError(f"{arch}: decode logits differ from the full "
                           f"forward by {float(gap.max())} (limit "
                           f"{LM_CONSISTENCY_TOL})")
    del params, logits, full_logits
    torch.cuda.empty_cache()


# ----------------------------------------------------------- phase 4d
def _lm_batch(cfg, shape, seed, device=None):
    """Tokens (shape) and their next-token labels, on ``device`` (default
    DEV), from a numpy seed (the labels are the tokens shifted by one: every
    one valid); for the audio encoder-decoder also its frames, standard
    normal, (*shape[:-1], T // frame_ratio, d_model) in its dtype."""
    import numpy as np
    import torch
    from repro_torch.models.layers import DTYPES
    device = device or DEV
    r = np.random.default_rng(seed)
    toks = r.integers(0, cfg.vocab_size, (*shape[:-1], shape[-1] + 1))
    batch = {"tokens": torch.from_numpy(toks[..., :-1].copy()).to(device),
             "labels": torch.from_numpy(toks[..., 1:].copy()).to(device)}
    if cfg.arch_type == "audio":
        batch["frames"] = torch.from_numpy(r.standard_normal(
            (*shape[:-1], shape[-1] // cfg.frame_ratio, cfg.d_model),
            np.float32)).to(device, DTYPES[cfg.dtype])
    return batch


def _to_cpu(tree):
    """A copy on the CPU (a copy even of a CPU tensor)."""
    if isinstance(tree, dict):
        return {k: _to_cpu(v) for k, v in tree.items()}
    return tree.detach().to("cpu", copy=True)


def _launches_of_ours():
    """Every port kernel's launches, and the flash and KD ones by kernel."""
    from repro_torch.kernels import flash_attention as fa
    from repro_torch.kernels import kd_softmax_kl as kd
    from repro_torch.kernels import launch_counts
    return {"launches": launch_counts(),
            "flash_attention": dict(fa.flash_attention.variant_launches),
            "kd_fwd": dict(kd.kd_loss_fwd.variant_launches),
            "kd_bwd": dict(kd.kd_loss_bwd.variant_launches)}


def _rel_by_leaf(mu_got, mu_want, p_got, p_want, zero_init):
    """Relative Frobenius gaps of every leaf's first moment and of the
    params of every leaf not in ``zero_init`` (flat dicts; ``got`` on the
    card, ``want`` on the CPU), and the largest."""
    rel = {"mu": {}, "param": {}}
    for what, got, want in (("mu", mu_got, mu_want),
                            ("param", p_got, p_want)):
        for k, w in want.items():
            if what == "param" and k in zero_init:
                continue
            rel[what][k] = float((got[k].cpu() - w).norm() / w.norm())
    return rel, max(max(v.values()) for v in rel.values())


def phase_lm_train(smi, timed):
    """Training at LLM scale: full qwen2.5-3b in bf16 (random weights, seed
    LM_SEED), TRAIN_STEPS steps of ``make_train_step`` at accum 1 then at
    accum 2 on TRAIN_B x TRAIN_T tokens, one Adam state throughout.
    Raises unless every loss is finite and the steps launch no flash and
    no KD kernel (training attention is the plain jnp port).  Then a
    float32 twin cut to 2 layers at full width takes one step on the card
    and the same step on the CPU (the path the tests hold to JAX): params
    per leaf within TRAIN_PARAM_RTOL, and its accum-2 loss within
    TRAIN_ACCUM_RTOL of its accum-1 loss.  The steady step of each accum
    goes into ``timed``."""
    import dataclasses

    import torch
    from repro_torch.configs import get_config
    from repro_torch.kernels import reset_launches
    from repro_torch.launch.steps import make_train_step
    from repro_torch.models import transformer as tf
    from repro_torch.tree import flatten

    allocated_before = torch.cuda.memory_allocated() / 1e9
    cfg = get_config(LM_ARCH)
    params = tf.init_lm(LM_SEED, cfg, device=DEV)
    steps = {a: make_train_step(cfg, lr=TRAIN_LR, accum=a) for a in (1, 2)}
    opt_state = steps[1][1].init(params)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    reset_launches()
    runs = []
    for accum in (1, 2):
        step = steps[accum][0]
        for i in range(TRAIN_STEPS):
            batch = _lm_batch(cfg, (TRAIN_B, TRAIN_T), 100 + len(runs))
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            params, opt_state, loss = step(params, opt_state, batch)
            torch.cuda.synchronize()
            runs.append({"accum": accum, "step": i + 1, "loss": float(loss),
                         "seconds": time.perf_counter() - t0})
    launches = _launches_of_ours()
    peak = torch.cuda.max_memory_allocated() / 1e9
    for r in runs:
        r["tokens_per_s"] = TRAIN_B * TRAIN_T / r["seconds"]
    steady = {a: statistics.mean(r["seconds"] for r in runs
                                 if r["accum"] == a and r["step"] > 1)
              for a in (1, 2)}
    finite = all(math.isfinite(r["loss"]) for r in runs)
    for a in (1, 2):
        _note(timed, f"lm_train {LM_ARCH}", LM_ARCH, cfg, "train",
              {"seq_len": TRAIN_T, "global_batch": TRAIN_B},
              steady[a] * 1e3, peak, accum=a)
    emit({"phase": "lm_train", "card": smi,
          "config": f"{LM_ARCH} full width and depth ({cfg.num_layers} "
          f"layers), {cfg.dtype}, remat {cfg.remat}, random weights seed "
          f"{LM_SEED}, AdamW lr {TRAIN_LR} "
          f"({'bf16' if cfg.param_count() > 8e9 else 'f32'} moments)",
          "params": cfg.param_count(), "batch": TRAIN_B, "seq": TRAIN_T,
          "attention": "sdpa_blocked" if TRAIN_T >= 2 * cfg.attn_block
          else "_sdpa", "steps": runs,
          "steady_s_per_step": steady,
          "steady_tokens_per_s": {a: TRAIN_B * TRAIN_T / t
                                  for a, t in steady.items()},
          "peak_memory_gb": peak, "allocated_before_gb": allocated_before,
          "losses_finite": finite, **launches})
    if not finite:
        raise RuntimeError(f"lm_train: non-finite losses {runs}")
    if (launches["launches"]["flash_attention"]
            or launches["launches"]["kd_softmax_kl_fwd"]
            or launches["launches"]["kd_softmax_kl_bwd"]):
        raise RuntimeError(f"lm_train: a train step launched a flash or KD "
                           f"kernel: {launches}")
    del params, opt_state, steps
    torch.cuda.empty_cache()

    cfg32 = dataclasses.replace(cfg, num_layers=2, dtype="float32")
    p_card = tf.init_lm(LM_SEED, cfg32, device=DEV)
    p_cpu = _to_cpu(p_card)
    p_card2 = {k: v.clone() for k, v in flatten(p_card).items()}
    zero_init = sorted(k for k, v in flatten(p_cpu).items() if not v.any())
    batch = _lm_batch(cfg32, (TRAIN_B, TRAIN_T), 200)
    out, mus = {}, {}
    for name, params, accum, dev in (
            ("card accum 1", p_card, 1, DEV),
            ("card accum 2", p_card2, 2, DEV),
            ("cpu accum 1", p_cpu, 1, "cpu")):
        step, opt = make_train_step(cfg32, lr=TRAIN_LR, accum=accum)
        b = {k: v.to(dev) for k, v in batch.items()}
        state = opt.init(params)
        t0 = time.perf_counter()
        _, _, loss = step(params, state, b)
        out[name] = {"loss": float(loss),
                     "seconds": time.perf_counter() - t0}
        mus[name] = state.mu
    rel, worst = _rel_by_leaf(mus["card accum 1"], mus["cpu accum 1"],
                              flatten(p_card), flatten(p_cpu), zero_init)
    l1, l2 = out["card accum 1"]["loss"], out["card accum 2"]["loss"]
    accum_rel = abs(l2 - l1) / abs(l1)
    card_cpu = abs(l1 - out["cpu accum 1"]["loss"]) / abs(l1)
    ok = worst <= TRAIN_PARAM_RTOL and accum_rel <= TRAIN_ACCUM_RTOL
    emit({"check": "lm_train float32 2-layer twin, full width: one step "
          f"on the card and on the CPU, B {TRAIN_B} x T {TRAIN_T}",
          "steps": out, "rel_err_by_leaf": rel,
          "params_not_held (zero at init: the update alone)": zero_init,
          "max_rel_err": worst, "rtol": TRAIN_PARAM_RTOL,
          "accum2_vs_accum1_loss_rel": accum_rel,
          "accum_rtol": TRAIN_ACCUM_RTOL,
          "card_vs_cpu_loss_rel": card_cpu, "ok": ok})
    if not ok:
        raise RuntimeError(f"lm_train twin: card against CPU {worst} "
                           f"(limit {TRAIN_PARAM_RTOL}), accum loss "
                           f"{accum_rel} (limit {TRAIN_ACCUM_RTOL})")
    # mus holds the card steps' float32 first moments (3.8 GB)
    del p_card, p_card2, p_cpu, mus, state, batch, b
    torch.cuda.empty_cache()
    more = {arch: _train_other(arch, smi, timed) for arch in TRAIN_MORE}
    return launches, more


def _cut(full, over) -> str:
    """The depth and expert cuts of a config, for the emitted lines."""
    cuts = [f"{over['num_layers']} of {full.num_layers} layers"
            if "num_layers" in over else f"full depth ({full.num_layers}"
            + (f" + {full.num_encoder_layers} encoder" if
               full.num_encoder_layers else "") + " layers)"]
    if "num_experts" in over:
        cuts.append(f"{over['num_experts']} of {full.num_experts} experts")
    elif full.num_experts:
        cuts.append(f"all {full.num_experts} experts")
    return ", ".join(cuts)


def _train_other(arch, smi, timed):
    """One of the other families trained like qwen2.5-3b: ``arch`` at full
    width with TRAIN_MORE's cuts in bf16 (random weights, seed LM_SEED), 2
    steps at accum 1 then 1 at accum 2 (none for NO_ACCUM2) on one Adam
    state, on TRAIN_B x
    TRAIN_T tokens (the MoE models MOE_TRAIN_BT; seamless with its frames).
    Raises unless every loss is finite and the steps launch no flash and no
    KD kernel; then its float32 twin (``_train_twin``).  Its second
    accum-1 step and its accum-2 step go into ``timed``."""
    import dataclasses

    import torch
    from repro_torch.configs import get_config
    from repro_torch.kernels import reset_launches
    from repro_torch.launch.steps import make_train_step

    wall0 = time.perf_counter()
    full = get_config(arch)
    cfg = dataclasses.replace(full, **TRAIN_MORE[arch])
    B, T = MOE_TRAIN_BT if cfg.num_experts else (TRAIN_B, TRAIN_T)
    allocated_before = torch.cuda.memory_allocated() / 1e9
    params = _init_serving(cfg)
    steps = {a: make_train_step(cfg, lr=TRAIN_LR, accum=a) for a in (1, 2)}
    opt_state = steps[1][1].init(params)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    reset_launches()
    runs = []
    for accum, i in ((1, 1), (1, 2), (2, 1))[:2 if arch in NO_ACCUM2 else 3]:
        batch = _lm_batch(cfg, (B, T), 400 + len(runs))
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        params, opt_state, loss = steps[accum][0](params, opt_state, batch)
        torch.cuda.synchronize()
        sec = time.perf_counter() - t0
        runs.append({"accum": accum, "step": i, "loss": float(loss),
                     "seconds": sec, "tokens_per_s": B * T / sec})
        del batch
    launches = _launches_of_ours()
    finite = all(math.isfinite(r["loss"]) for r in runs)
    peak = torch.cuda.max_memory_allocated() / 1e9
    for r in runs[1:]:
        _note(timed, f"lm_train {arch}", arch, cfg, "train",
              {"seq_len": T, "global_batch": B}, r["seconds"] * 1e3, peak,
              accum=r["accum"])
    line = {"phase": "lm_train", "card": smi,
            "config": f"{arch} full width, {_cut(full, TRAIN_MORE[arch])} "
            f"(d_model {cfg.d_model}, {_family(cfg)}, d_ff {cfg.d_ff}), "
            f"{cfg.dtype}, remat {cfg.remat}, random weights seed {LM_SEED},"
            f" AdamW lr {TRAIN_LR} "
            f"({'bf16' if cfg.param_count() > 8e9 else 'f32'} moments)",
            "params": cfg.param_count(),
            "params_full_config": full.param_count(),
            "static_gb_reckoned": 12 * cfg.param_count() / 1e9,
            "batch": B, "seq": T, "attention": "sdpa_blocked"
            if T >= 2 * cfg.attn_block else "_sdpa", "steps": runs,
            "s_per_step_accum1_step2": runs[1]["seconds"],
            "tokens_per_s_accum1_step2": runs[1]["tokens_per_s"],
            "s_per_step_accum2": runs[2]["seconds"] if len(runs) > 2
            else None,
            "peak_memory_gb": peak,
            "allocated_before_gb": allocated_before,
            "run_wall_s": time.perf_counter() - wall0,
            "losses_finite": finite, **launches}
    if cfg.arch_type == "audio":
        line["frames"] = T // cfg.frame_ratio
    emit(line)
    if not finite:
        raise RuntimeError(f"lm_train {arch}: non-finite losses {runs}")
    if (launches["launches"]["flash_attention"]
            or launches["launches"]["kd_softmax_kl_fwd"]
            or launches["launches"]["kd_softmax_kl_bwd"]):
        raise RuntimeError(f"lm_train {arch}: a train step launched a flash "
                           f"or KD kernel: {launches}")
    del params, opt_state, steps
    torch.cuda.empty_cache()
    twin = _train_twin(arch, full, smi)
    return {"runs": runs, "twin_max_rel_err": twin}


@contextlib.contextmanager
def _routes_recorded():
    """Yields a list to which each ``layers.moe_fwd`` call in the block
    appends its tokens' top-k expert indices, sorted, on the host (taken
    from its input and router; the wrapper is removed on exit)."""
    import torch
    from repro_torch.models import layers as ly
    moe_fwd, routes = ly.moe_fwd, []

    def recorded(p, c, x, **kw):
        with torch.no_grad():
            probs = torch.softmax(x.reshape(-1, x.shape[-1]).float()
                                  @ p["router"], dim=-1)
            routes.append(torch.topk(probs, c.num_experts_per_tok, dim=-1)
                          .indices.sort(dim=-1).values.cpu())
        return moe_fwd(p, c, x, **kw)

    ly.moe_fwd = recorded
    try:
        yield routes
    finally:
        ly.moe_fwd = moe_fwd


def _train_twin(arch, full, smi):
    """A float32 twin of ``full``: 2 layers at full width (TWIN_EXPERTS
    experts for a MoE model, one group for the hybrid: attn_every 2, 2 + 2
    layers for the encoder-decoder) takes one train step on the card and
    the same step on the CPU at B 1 x TWIN_T; raises unless every leaf's
    first moment and every param not zero at init are within
    TRAIN_PARAM_RTOL.  A MoE twin also counts, in each layer of the
    step's forward, the tokens whose top-k differs between the card and
    the CPU.  Returns the largest gap."""
    import dataclasses

    import torch
    from repro_torch.launch.steps import make_train_step
    from repro_torch.tree import flatten

    wall0 = time.perf_counter()
    over = {"num_layers": 2, "dtype": "float32"}
    if full.num_experts:
        over["num_experts"] = TWIN_EXPERTS
    if full.arch_type == "hybrid":
        over["attn_every"] = 2
    if full.arch_type == "audio":
        over["num_encoder_layers"] = 2
    cfg32 = dataclasses.replace(full, **over)
    p_card = _init_serving(cfg32)
    p_cpu = _to_cpu(p_card)
    zero_init = sorted(k for k, v in flatten(p_cpu).items() if not v.any())
    batch = _lm_batch(cfg32, (1, TWIN_T), 500, device="cpu")
    out, mus, seen = {}, {}, {}
    for name, params, dev in (("card", p_card, DEV), ("cpu", p_cpu, "cpu")):
        step, opt = make_train_step(cfg32, lr=TRAIN_LR)
        b = {k: v.to(dev) for k, v in batch.items()}
        state = opt.init(params)
        t0 = time.perf_counter()
        with _routes_recorded() as routes:
            _, _, loss = step(params, state, b)
        out[name] = {"loss": float(loss),
                     "seconds": time.perf_counter() - t0}
        mus[name] = state.mu
        # the forward's layers in order (remat records them again in the
        # backward, after these)
        seen[name] = routes[:cfg32.num_layers]
    routes = ([int((a != b).any(dim=-1).sum())
               for a, b in zip(seen["card"], seen["cpu"])]
              if cfg32.num_experts else None)
    rel, worst = _rel_by_leaf(mus["card"], mus["cpu"], flatten(p_card),
                              flatten(p_cpu), zero_init)
    l_card, l_cpu = out["card"]["loss"], out["cpu"]["loss"]
    ok = worst <= TRAIN_PARAM_RTOL
    line = {"check": f"lm_train {arch} float32 twin, full width, "
            + ", ".join(f"{k} {v}" for k, v in over.items()
                        if k != "dtype")
            + f": one step on the card and on the CPU, B 1 x T {TWIN_T}",
            "card": smi, "params": cfg32.param_count(), "steps": out,
            "rel_err_by_leaf": rel,
            "params_not_held (zero at init: the update alone)": zero_init,
            "max_rel_err": worst, "rtol": TRAIN_PARAM_RTOL,
            "card_vs_cpu_loss_rel": abs(l_card - l_cpu) / abs(l_cpu),
            "run_wall_s": time.perf_counter() - wall0, "ok": ok}
    if routes is not None:
        line["tokens_whose_top_k_differs_by_layer"] = routes
        line["tokens_a_layer"] = TWIN_T
    emit(line)
    if not ok:
        raise RuntimeError(f"lm_train {arch} twin: card against CPU {worst} "
                           f"(limit {TRAIN_PARAM_RTOL}), top-k differing "
                           f"{routes}")
    del p_card, p_cpu, mus, state, batch, b
    torch.cuda.empty_cache()
    return worst


# ----------------------------------------------------------- phase 4e
def _distill_step_checked(cfg, step, path, batch, students, opt_state,
                          teacher, want_fa: int, want_kd: int, regime):
    """One distill step, timed, with the launches it made; raises unless
    the flash kernels took exactly ``want_fa`` ``tensor_core`` launches,
    the KD kernels ``want_kd`` forward and ``want_kd`` backward launches of
    ``regime``, and the merge none."""
    import torch
    from repro_torch.kernels import reset_launches
    reset_launches()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    _, _, loss = step(students, opt_state, teacher, batch)
    torch.cuda.synchronize()
    r = {"path": path, "loss": float(loss),
         "seconds": time.perf_counter() - t0, **_launches_of_ours()}
    kd_want = {"rows": 0, "stream": 0}
    kd_want[regime] = want_kd
    ok = (r["flash_attention"] == {"v1": 0, "tensor_core": want_fa,
                                   "decode": 0}
          and r["kd_fwd"] == kd_want and r["kd_bwd"] == kd_want
          and r["launches"]["fused_merge"] == 0)
    if not ok:
        emit({"phase": "lm_distill", "config": cfg.name, "failed_step": r})
        raise RuntimeError(f"lm_distill {cfg.name} {path} step: expected "
                           f"{want_fa} tensor_core flash launches and KD "
                           f"forward and backward launches {kd_want}, "
                           f"counted {r}")
    return r


def _kd_in_step(prof, V: int) -> dict:
    """The KD stream kernels' device µs and calls in a profiled distill
    step, beside the bounds of ``_kd_timing`` at DISTILL_ROWS x V in bf16."""
    from torch.autograd import DeviceType
    kd_us = {}
    for key in ("kd_fwd_stream_kernel", "kd_bwd_chunk_kernel"):
        ev = [e for e in prof.key_averages()
              if e.device_type == DeviceType.CUDA and key in e.key]
        kd_us[key] = {"device_us": sum(e.self_device_time_total
                                       for e in ev),
                      "calls": sum(e.count for e in ev)}
    elt = 2
    T = DISTILL_ROWS
    # the bytes and operations of _kd_timing's bounds
    fwd_bound = bound_ms(2 * T * V * elt + 20 * T, KD_FWD_OPS_PER_ELEM * T * V)
    bwd_bound = bound_ms(3 * T * V * elt + 20 * T, KD_BWD_OPS_PER_ELEM * T * V)
    kd_us["kd_fwd_stream_kernel"].update(bound_ms=fwd_bound[0],
                                         bound_by=fwd_bound[1])
    kd_us["kd_bwd_chunk_kernel"].update(bound_ms=bwd_bound[0],
                                        bound_by=bwd_bound[1])
    return kd_us


def phase_lm_distill(smi, timed):
    """The paper's FedSiKD step at LLM scale: teacher full qwen2.5-3b
    (bf16, random weights), students its ``as_student()`` (18 layers) in D
    = len(DISTILL_CLUSTERS) replicas, one replica's batch 1 x DISTILL_T
    tokens.  Two default steps, then from the students they leave the
    default step (timed), the vocab-chunked step (chunk DISTILL_CHUNK) and
    the teacher-in-grad step, and once more the default step under the
    profiler (the KD kernels' device time beside their bound); then
    ``sync``.  Raises unless: each default and teacher-in-grad step makes
    one KD forward and one backward launch, all ``stream``, and the chunked
    step none; the teacher's flash launches are its layers (``tensor_core``)
    once a step, twice D times in the teacher-in-grad step (the backward
    recomputes it); the chunked and teacher-in-grad losses are within
    KD_TOL's bf16 rtol of the default one, and the profiled step's equal
    to the timed one's; every loss is finite; the replicas are equal after
    ``sync``; and the teacher's bytes are unchanged.  A step of each path
    goes into ``timed``."""
    import torch
    from torch.profiler import ProfilerActivity, profile
    from repro_torch.configs import get_config
    from repro_torch.kernels import kd_softmax_kl as kd
    from repro_torch.launch.steps import make_fedsikd_distill_step
    from repro_torch.models import transformer as tf
    from repro_torch.tree import flatten

    allocated_before = torch.cuda.memory_allocated() / 1e9
    cfg = get_config(LM_ARCH)
    D = len(DISTILL_CLUSTERS)
    teacher = tf.init_lm(LM_SEED, cfg, device=DEV)
    teacher_host = {k: v.cpu() for k, v in flatten(teacher).items()}
    makers = {path: make_fedsikd_distill_step(
        cfg, DISTILL_CLUSTERS, lr=DISTILL_LR, **kw) for path, kw in (
            ("default", {}), ("vocab_chunk", {"vocab_chunk": DISTILL_CHUNK}),
            ("teacher_in_grad", {"teacher_in_grad": True}))}
    _, sync, init_students, opt, s_cfg = makers["default"]
    students = init_students(LM_SEED + 1, device=DEV)
    opt_state = opt.init(students)
    flat = flatten(students)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    L = cfg.num_layers
    want_fa = {"default": L, "vocab_chunk": L, "teacher_in_grad": 2 * D * L}
    want_kd = {"default": 1, "vocab_chunk": 0, "teacher_in_grad": 1}
    # the plan's regime at the step's rows: stream at an LLM vocabulary
    regime = kd.plan(DISTILL_ROWS, cfg.vocab_size, torch.cuda
                     .get_device_properties(0).multi_processor_count)[
                         "regime"]
    runs = []

    def run(path, i, prof=None):
        r = _distill_step_checked(
            cfg, makers[path][0], path, _lm_batch(cfg, (D, 1, DISTILL_T),
                                                  300 + i),
            students, opt_state, teacher, want_fa[path], want_kd[path],
            regime)
        r.update(batch=i, profiled=bool(prof))
        runs.append(r)
        return r

    run("default", 0)
    run("default", 1)
    snapshot = _to_cpu(flat)                      # on the host

    def restore():
        for k, v in flat.items():
            v.copy_(snapshot[k])

    run("default", 2)
    restore()
    run("vocab_chunk", 2)
    restore()
    run("teacher_in_grad", 2)
    restore()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        run("default", 2, prof=True)
    kd_us = _kd_in_step(prof, cfg.vocab_size)
    del snapshot
    sync(students)
    torch.cuda.synchronize()
    replicas_equal = all(all(torch.equal(v[d], v[0]) for d in range(1, D))
                         for v in flat.values())
    teacher_same = all(torch.equal(v.cpu(), teacher_host[k])
                       for k, v in flatten(teacher).items())
    peak = torch.cuda.max_memory_allocated() / 1e9
    by = {(r["path"], r["batch"], r["profiled"]): r for r in runs}
    for path, i in (("default", 1), ("vocab_chunk", 2),
                    ("teacher_in_grad", 2)):
        _note(timed, f"lm_distill {LM_ARCH}", LM_ARCH, cfg, "fedsikd",
              {"seq_len": DISTILL_T, "global_batch": D},
              by[(path, i, False)]["seconds"] * 1e3, peak, replicas=D,
              **_DISTILL_PATHS[path])
    ref = by[("default", 2, False)]["loss"]
    rtol = KD_TOL["bfloat16"][0]
    gaps = {p: abs(by[(p, 2, False)]["loss"] - ref) / abs(ref)
            for p in ("vocab_chunk", "teacher_in_grad")}
    repeat = abs(by[("default", 2, True)]["loss"] - ref) / abs(ref)
    finite = all(math.isfinite(r["loss"]) for r in runs)
    emit({"phase": "lm_distill", "card": smi,
          "config": f"teacher {LM_ARCH} full ({cfg.num_layers} layers), "
          f"students {s_cfg.num_layers} layers ({s_cfg.param_count()} "
          f"params each), D {D}, clusters {list(DISTILL_CLUSTERS)}, 1 x "
          f"{DISTILL_T} tokens a replica, {cfg.dtype}, lr {DISTILL_LR}, "
          "random weights",
          "steps": [{k: r[k] for k in ("path", "batch", "loss", "seconds",
                                       "profiled", "flash_attention",
                                       "kd_fwd", "kd_bwd")} for r in runs],
          "kd_rows": DISTILL_ROWS, "kd_regime": regime, "card_sms":
          torch.cuda.get_device_properties(0).multi_processor_count,
          "kd_in_step": kd_us,
          "loss_rel_to_default": gaps, "loss_rtol": rtol,
          "profiled_repeat_rel": repeat,
          "peak_memory_gb": peak, "allocated_before_gb": allocated_before,
          "replicas_equal_after_sync": replicas_equal,
          "teacher_unchanged": teacher_same})
    if not finite:
        raise RuntimeError(f"lm_distill: non-finite losses {runs}")
    if max(gaps.values()) > rtol or repeat > rtol:
        raise RuntimeError(f"lm_distill: losses from one state differ by "
                           f"{gaps} / {repeat} (limit {rtol})")
    if not replicas_equal:
        raise RuntimeError("lm_distill: replicas differ after sync")
    if not teacher_same:
        raise RuntimeError("lm_distill: the step wrote to the teacher")
    if any(v["calls"] != 1 for v in kd_us.values()):
        raise RuntimeError(f"lm_distill: the profiler saw {kd_us}")
    counts = {"kd_softmax_kl_fwd": sum(r["launches"]["kd_softmax_kl_fwd"]
                                       for r in runs),
              "kd_softmax_kl_bwd": sum(r["launches"]["kd_softmax_kl_bwd"]
                                       for r in runs),
              "flash_attention": sum(r["launches"]["flash_attention"]
                                     for r in runs)}
    del students, opt_state, teacher, flat, makers
    torch.cuda.empty_cache()
    more = {arch: _distill_other(arch, smi, timed) for arch in DISTILL_MORE}
    return counts, kd_us, more


# each distill path's keywords of the dry run's fedsikd step
_DISTILL_PATHS = {"default": {},
                  "vocab_chunk": {"fedsikd_vocab_chunk": DISTILL_CHUNK},
                  "teacher_in_grad": {"fedsikd_teacher_in_grad": True}}


def _distill_config(arch):
    """``arch``'s teacher config in ``_distill_other``."""
    import dataclasses
    from repro_torch.configs import get_config
    return dataclasses.replace(get_config(arch), **DISTILL_MORE[arch])


def _teacher_attention_launches(cfg) -> int:
    """The flash launches of one teacher forward in a distill step: its
    attention layers (``_expected_flash``'s prefill count: none for MLA or
    RWKV, the shared block's applications for the hybrid, the decoder's
    self-attention layers for the encoder-decoder), once for the merged
    batch, or once a replica for a MoE teacher (one forward a replica, as
    JAX's vmap)."""
    layers = _expected_flash(cfg, 0)["tensor_core"]
    return layers * (len(DISTILL_CLUSTERS) if cfg.num_experts else 1)


def _distill_other(arch, smi, timed):
    """The FedSiKD step of one of the other families: the teacher ``arch``
    at full width with DISTILL_MORE's cuts (bf16, random weights, seed
    LM_SEED), students its ``as_student()`` in D = len(DISTILL_CLUSTERS)
    replicas, 1 x DISTILL_T tokens a replica (seamless with its frames).
    Two default steps, then from the students they leave the default step
    under the profiler (the KD kernels' device time beside their bound at
    the model's vocabulary), the teacher-in-grad step and, but for the
    encoder-decoder (its forward returns no hidden states), the
    vocab-chunked step; then ``sync``.  Raises as ``phase_lm_distill``
    does: exact flash and KD launches (``_teacher_attention_launches`` a
    teacher forward, twice D times the teacher's attention layers in the
    teacher-in-grad step), the other paths' losses within KD_TOL's bf16
    rtol of the default one, finite losses, equal replicas after ``sync``
    and the teacher's bytes unchanged.  A step of each path goes into
    ``timed``."""
    import torch
    from torch.profiler import ProfilerActivity, profile
    from repro_torch.configs import get_config
    from repro_torch.kernels import kd_softmax_kl as kd
    from repro_torch.launch.steps import make_fedsikd_distill_step
    from repro_torch.tree import flatten

    wall0 = time.perf_counter()
    full = get_config(arch)
    cfg = _distill_config(arch)
    D = len(DISTILL_CLUSTERS)
    allocated_before = torch.cuda.memory_allocated() / 1e9
    teacher = _init_serving(cfg)
    teacher_host = {k: v.cpu() for k, v in flatten(teacher).items()}
    paths = {"default": {}, "teacher_in_grad": {"teacher_in_grad": True}}
    if cfg.arch_type != "audio":
        paths["vocab_chunk"] = {"vocab_chunk": DISTILL_CHUNK}
    makers = {path: make_fedsikd_distill_step(
        cfg, DISTILL_CLUSTERS, lr=DISTILL_LR, **kw)
        for path, kw in paths.items()}
    _, sync, init_students, opt, s_cfg = makers["default"]
    students = init_students(LM_SEED + 1, device=DEV)
    opt_state = opt.init(students)
    flat = flatten(students)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    t_fa = _teacher_attention_launches(cfg)
    want_fa = {"default": t_fa, "vocab_chunk": t_fa,
               "teacher_in_grad": 2 * D * _expected_flash(cfg, 0)[
                   "tensor_core"]}
    want_kd = {"default": 1, "vocab_chunk": 0, "teacher_in_grad": 1}
    regime = kd.plan(DISTILL_ROWS, cfg.vocab_size, torch.cuda
                     .get_device_properties(0).multi_processor_count)[
                         "regime"]
    runs = []

    def run(path, i, prof=False):
        r = _distill_step_checked(
            cfg, makers[path][0], path, _lm_batch(cfg, (D, 1, DISTILL_T),
                                                  600 + i),
            students, opt_state, teacher, want_fa[path], want_kd[path],
            regime)
        r.update(batch=i, profiled=prof)
        runs.append(r)

    run("default", 0)
    run("default", 1)
    snapshot = _to_cpu(flat)                      # on the host
    prof_s = time.perf_counter()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        run("default", 2, prof=True)
    kd_us = _kd_in_step(prof, cfg.vocab_size)
    prof_s = time.perf_counter() - prof_s
    del prof
    for path in paths:
        if path != "default":
            for k, v in flat.items():
                v.copy_(snapshot[k])
            run(path, 2)
    del snapshot
    sync(students)
    torch.cuda.synchronize()
    replicas_equal = all(all(torch.equal(v[d], v[0]) for d in range(1, D))
                         for v in flat.values())
    teacher_same = all(torch.equal(v.cpu(), teacher_host[k])
                       for k, v in flatten(teacher).items())
    peak = torch.cuda.max_memory_allocated() / 1e9
    for r in [runs[1]] + runs[3:]:
        _note(timed, f"lm_distill {arch}", arch, cfg, "fedsikd",
              {"seq_len": DISTILL_T, "global_batch": D},
              r["seconds"] * 1e3, peak, replicas=D,
              **_DISTILL_PATHS[r["path"]])
    ref = runs[2]["loss"]
    rtol = KD_TOL["bfloat16"][0]
    gaps = {r["path"]: abs(r["loss"] - ref) / abs(ref) for r in runs[3:]}
    finite = all(math.isfinite(r["loss"]) for r in runs)
    emit({"phase": "lm_distill", "card": smi,
          "config": f"teacher {arch} full width, "
          f"{_cut(full, DISTILL_MORE[arch])} ({cfg.param_count()} params), "
          f"students {s_cfg.num_layers} layers"
          + (f" + {s_cfg.num_encoder_layers} encoder"
             if s_cfg.num_encoder_layers else "")
          + f" ({s_cfg.param_count()} params each), D {D}, clusters "
          f"{list(DISTILL_CLUSTERS)}, 1 x {DISTILL_T} tokens a replica"
          + (f" and {DISTILL_T // cfg.frame_ratio} frames"
             if cfg.arch_type == "audio" else "")
          + f", {cfg.dtype}, lr {DISTILL_LR}, random weights",
          "teacher_params": cfg.param_count(),
          "student_params": s_cfg.param_count(),
          "static_gb_reckoned": (2 * cfg.param_count()
                                 + 12 * D * s_cfg.param_count()) / 1e9,
          "steps": [{k: r[k] for k in ("path", "batch", "loss", "seconds",
                                       "profiled", "flash_attention",
                                       "kd_fwd", "kd_bwd")} for r in runs],
          "default_s_per_step": runs[1]["seconds"],
          "default_tokens_per_s": D * DISTILL_T / runs[1]["seconds"],
          "kd_rows": DISTILL_ROWS, "vocab": cfg.vocab_size,
          "kd_regime": regime, "kd_in_step": kd_us,
          "expected_teacher_flash": want_fa,
          "loss_rel_to_default": gaps, "loss_rtol": rtol,
          "peak_memory_gb": peak, "allocated_before_gb": allocated_before,
          "replicas_equal_after_sync": replicas_equal,
          "teacher_unchanged": teacher_same,
          "profiled_step_wall_s": prof_s,
          "run_wall_s": time.perf_counter() - wall0})
    if not finite:
        raise RuntimeError(f"lm_distill {arch}: non-finite losses {runs}")
    if max(gaps.values()) > rtol:
        raise RuntimeError(f"lm_distill {arch}: losses from one state "
                           f"differ by {gaps} (limit {rtol})")
    if not replicas_equal:
        raise RuntimeError(f"lm_distill {arch}: replicas differ after sync")
    if not teacher_same:
        raise RuntimeError(f"lm_distill {arch}: the step wrote to the "
                           "teacher")
    if any(v["calls"] != 1 for v in kd_us.values()):
        raise RuntimeError(f"lm_distill {arch}: the profiler saw {kd_us}")
    counts = {k: sum(r["launches"][k] for r in runs)
              for k in ("kd_softmax_kl_fwd", "kd_softmax_kl_bwd",
                        "flash_attention")}
    del students, opt_state, teacher, teacher_host, flat, makers
    torch.cuda.empty_cache()
    return {"counts": counts, "kd_in_step": kd_us,
            "steps": len(runs)}


# ----------------------------------------------------------- phase 4g
# the dry runs' worker processes (the host has 8 cores; the dry runs use the
# host alone, on fake tensors); a config deeper than DRYRUN_FULL_DEPTH runs
# by the fit of analysis.extrapolate (its probes at 2-4 layers) but where
# _by_fit says otherwise; and the bounds on what the dry run may say of the
# timed steps
DRYRUN_WORKERS = 8
DRYRUN_FULL_DEPTH = 3
MAX_SHARE = 1.05
PEAK_UNDER = 0.8


def _dry_init():
    """A dry-run worker: no card of its own (its tensors are fake and
    name the CPU; it opens no CUDA context), one thread."""
    import os
    os.environ["CUDA_VISIBLE_DEVICES"] = ""
    import torch
    torch.set_num_threads(1)


def _dry_job(job):
    """One dry run in a worker: ``dryrun.lower_one`` at full depth, or
    ``analysis.extrapolate`` from its probes when ``job["fit"]``."""
    from repro_torch.launch import analysis, dryrun
    t0 = time.perf_counter()
    if job["fit"]:
        f = analysis.extrapolate(job["arch"], job["shape"], base=job["cfg"],
                                 device="cpu", **job["kw"])
        out = {"flops": f["flops_per_device"],
               "bytes": f["hbm_bytes_per_device"], "peak": f["peak_bytes"],
               "kernels": None}
    else:
        r = dryrun.lower_one(job["arch"], job["shape"], cfg=job["cfg"],
                             device="cpu", verbose=False, **job["kw"])
        mem = r["memory_analysis"]
        out = {"flops": r["roofline"]["flops_per_device"],
               "bytes": r["roofline"]["hbm_bytes_per_device"],
               "peak": (mem["argument_size_in_bytes"]
                        + mem["temp_size_in_bytes"]),
               "kernels": r["kernels"]}
    out["seconds"] = time.perf_counter() - t0
    return out


def _by_fit(cfg, kind: str, timed: bool, accum: int = 1) -> bool:
    """Whether a dry run takes the probes' fit.  Not for a shallow config,
    nor a timed serving step (a forward at full depth is quick), nor the
    fedsikd step of a hybrid or an encoder-decoder (no fit takes two layer
    stacks), nor a timed hybrid's accum-1 train step: its remat holds a
    whole group of layers, so its peak (its run's largest, above the
    accum-2 step's) grows with the group's size, which the probes' groups
    of 2 and 3 do not show.  An untimed hybrid train step (part a) takes
    the fit, and its peak is the probes'."""
    if cfg.num_layers <= DRYRUN_FULL_DEPTH:
        return False
    if timed and kind in ("prefill", "decode"):
        return False
    if kind == "fedsikd" and cfg.arch_type in ("hybrid", "audio"):
        return False
    return not (timed and kind == "train" and cfg.arch_type == "hybrid"
                and accum == 1)


def _dry_cost(job) -> float:
    """A rough order of the jobs, longest first: the trained steps at full
    depth, the long prefills' fits, the trained steps' fits."""
    kind, spec = job["kind"], job["spec"]
    trains = kind in ("train", "fedsikd")
    if not job["fit"]:
        depth = job["cfg"].num_layers + job["cfg"].num_encoder_layers
        return depth * (3 if trains else 1)
    if kind == "prefill" and spec["seq_len"] >= 16384:
        return 120
    return 60 if trains else 10


def _dry_submit(pool, jobs):
    """``jobs`` into ``pool``, the longest first; returns [(job, future)] in
    the jobs' order."""
    futures = {}
    for i in sorted(range(len(jobs)), key=lambda i: -_dry_cost(jobs[i])):
        futures[i] = pool.submit(_dry_job, {k: jobs[i][k] for k in (
            "arch", "shape", "cfg", "fit", "kw")})
    return [(jobs[i], futures[i]) for i in range(len(jobs))]


def _untimed_jobs():
    """Part (a)'s jobs: every ``ARCH_ID`` x ``INPUT_SHAPES`` entry that JAX
    does not skip (the train_4k steps at accum 1, as JAX's analysis probes
    take them), and the fedsikd step of qwen2.5-3b at train_4k."""
    from repro_torch.configs import ARCH_IDS, INPUT_SHAPES
    from repro_torch.launch import dryrun
    jobs = []
    for arch in ARCH_IDS:
        for shape, spec in INPUT_SHAPES.items():
            if dryrun.shape_skip_reason(arch, shape):
                continue
            cfg = dryrun.arch_config(arch, shape)
            jobs.append({"part": "a", "arch": arch, "shape": shape,
                         "spec": spec, "kind": spec["kind"], "cfg": cfg,
                         "fit": _by_fit(cfg, spec["kind"], False),
                         "kw": {"accum": 1}})
    jobs.append({"part": "a", "arch": LM_ARCH, "shape": "train_4k",
                 "spec": INPUT_SHAPES["train_4k"], "kind": "fedsikd",
                 "cfg": dryrun.arch_config(LM_ARCH, "train_4k"), "fit": True,
                 "kw": {"step_kind": "fedsikd"}})
    return jobs


def phase_dryrun(smi, timed):
    """The dry run (``repro_torch.launch``) beside the card, in
    DRYRUN_WORKERS processes on the host.  (a) Every ``ARCH_ID`` x
    ``INPUT_SHAPES`` entry and the fedsikd step of qwen2.5-3b at train_4k
    (``_untimed_jobs``), at full width and full depth (by the fit of
    ``analysis.extrapolate`` where ``_by_fit`` says): FLOPs, bytes, peak GB,
    whether it fits the card, the dominant term and the bound ms.  (b) Each
    step ``lm_serve``, ``lm_train`` and ``lm_distill`` timed, in its config
    (its cuts), batch, accum and loss path: the count beside the measured
    ms and peak, the step's MFU (model FLOPs / time / the dtype's peak) and
    roofline share (the larger of compute and memory time / time).
    Raises where a share or MFU reads over MAX_SHARE, a run's predicted
    peak (the most of its steps) is under PEAK_UNDER of its measured one,
    or a run's step does not fit the card by the count."""
    import concurrent.futures as cf
    import multiprocessing as mp

    import torch
    from repro_torch.configs import ARCH_IDS, INPUT_SHAPES
    from repro_torch.launch import dryrun

    t0 = time.perf_counter()
    card = torch.cuda.get_device_properties(0).total_memory
    for arch in ARCH_IDS:
        for shape in INPUT_SHAPES:
            reason = dryrun.shape_skip_reason(arch, shape)
            if reason:
                emit({"phase": "dryrun", "part": "a", "arch": arch,
                      "shape": shape, "skipped": reason})
    timed_jobs = [{"part": "b", "arch": t["arch"], "shape": t["spec"],
                   "spec": t["spec"], "kind": t["kind"], "cfg": t["cfg"],
                   "fit": _by_fit(t["cfg"], t["kind"], True,
                                  t["kw"].get("accum", 1)), "timed": t,
                   "kw": {"step_kind": t["kind"], **t["kw"]}}
                  for t in timed]
    with cf.ProcessPoolExecutor(DRYRUN_WORKERS,
                                mp_context=mp.get_context("spawn"),
                                initializer=_dry_init) as pool:
        pairs = _dry_submit(pool, _untimed_jobs() + timed_jobs)
        results = [f.result() for _, f in pairs]

    errors, groups = [], {}
    for (job, _), r in zip(pairs, results):
        cfg = job["cfg"]
        roof = dryrun.rl.Roofline(r["flops"], r["bytes"], 0.0, {},
                                  PEAK_FLOPS[cfg.dtype])
        bound_s = max(roof.compute_s, roof.memory_s)
        line = {"phase": "dryrun", "part": job["part"], "arch": job["arch"],
                "shape": job["shape"], "step": job["kind"],
                "layers": cfg.num_layers, "flops": r["flops"],
                "bytes": r["bytes"], "peak_gb": r["peak"] / 1e9,
                "fits": r["peak"] <= card, "dominant": roof.dominant,
                "bound_ms": bound_s * 1e3,
                "model_flops": dryrun.model_flops(cfg, job["kind"],
                                                  job["spec"]),
                "method": "fit of 2-4-layer probes" if job["fit"]
                else "full depth", "dryrun_s": r["seconds"],
                "kernels": r["kernels"], "card": smi}
        if job["part"] == "b":
            t = job["timed"]
            sec = t["ms"] / 1e3
            line.update({"kw": t["kw"], "measured_ms": t["ms"],
                         "measured_peak_gb": t["peak_gb"],
                         "mfu": line["model_flops"] / sec
                         / PEAK_FLOPS[cfg.dtype],
                         "roofline_share": bound_s / sec})
            g = groups.setdefault(t["group"], {"measured": t["peak_gb"],
                                               "predicted": 0.0})
            g["predicted"] = max(g["predicted"], line["peak_gb"])
            if max(line["mfu"], line["roofline_share"]) > MAX_SHARE:
                errors.append(f"{t['group']} {job['kind']}: mfu "
                              f"{line['mfu']:.3f}, roofline share "
                              f"{line['roofline_share']:.3f}")
            if not line["fits"]:
                errors.append(f"{t['group']} {job['kind']}: the count says "
                              f"{line['peak_gb']:.1f} GB, over the card's "
                              f"{card / 1e9:.1f}")
        emit(line)
    for name, g in groups.items():
        g["ratio"] = g["predicted"] / g["measured"]
        if g["ratio"] < PEAK_UNDER:
            errors.append(f"{name}: predicted peak {g['predicted']:.2f} GB, "
                          f"measured {g['measured']:.2f} GB")
    emit({"phase": "dryrun", "card": smi, "records": len(pairs),
          "peaks_predicted_vs_measured_gb": groups,
          "workers": DRYRUN_WORKERS, "phase_s": time.perf_counter() - t0,
          "dryrun_cpu_s": sum(r["seconds"] for r in results)})
    if errors:
        raise RuntimeError(f"dryrun: {errors}")


# ----------------------------------------------------------- phase 4f
# the port's examples that chip_smoke.py runs on the card, each in its own
# process as a user runs it, and each one's time limit
EXAMPLES_ON_CARD = ("quickstart_torch.py", "llm_distill_torch.py")
EXAMPLE_TIMEOUT_S = 300


def phase_examples(smi):
    """Each of EXAMPLES_ON_CARD as a user runs it: ``python
    examples/NAME`` from the repository root with ``src`` on PYTHONPATH, on
    its default device (the card).  Prints one line a run (exit code,
    seconds, its last line of output) and raises unless each exits 0 within
    EXAMPLE_TIMEOUT_S (``subprocess.run`` kills it then)."""
    import os
    env = dict(os.environ)
    env["PYTHONPATH"] = os.pathsep.join(
        [str(ROOT / "src")] + ([env["PYTHONPATH"]]
                               if env.get("PYTHONPATH") else []))
    out = {}
    for name in EXAMPLES_ON_CARD:
        t0 = time.perf_counter()
        proc = subprocess.run([sys.executable, str(ROOT / "examples" / name)],
                              cwd=ROOT, env=env, capture_output=True,
                              text=True, timeout=EXAMPLE_TIMEOUT_S)
        lines = proc.stdout.strip().splitlines()
        out[name] = {"rc": proc.returncode,
                     "seconds": time.perf_counter() - t0,
                     "last_line": lines[-1] if lines else ""}
        emit({"phase": "examples", "card": smi,
              "example": f"examples/{name}", **out[name]})
        if proc.returncode:
            raise RuntimeError(f"examples/{name} exited {proc.returncode}: "
                               f"{proc.stderr[-3000:]}")
    return out


# ------------------------------------------------------------------ phase 5
def _kd_sets(T, V, dtype, seed):
    """Copies of one KD input set at (T, V), enough that one pass over
    them reads twice the card's L2, and a function that returns the next
    copy each call: every timed call then reads its logits from HBM, not
    from L2 where an earlier call left them."""
    import itertools
    import torch
    s, t, y = _kd_inputs(T, V, dtype, seed)
    l2 = getattr(torch.cuda.get_device_properties(0), "L2_cache_size",
                 50 << 20)
    n = max(1, -(-2 * l2 // (2 * s.numel() * s.element_size())))
    S, Tt = s.repeat(n, 1).view(n, T, V), t.repeat(n, 1).view(n, T, V)
    Y = y.repeat(n).view(n, T)
    sets = [(S[i], Tt[i], Y[i]) for i in range(n)]
    turn = itertools.count()
    return sets, lambda: sets[next(turn) % n]


def _kd_timing(T, V, dtype, seed):
    """One KD forward and one backward call at (T, V) beside their bounds:
    the port's kernels (``ms`` by CUDA events, ``device_us`` by the
    profiler, the ``regime`` of ``plan``) and the plain versions.  Each
    call takes the next of ``input_sets`` copies of the inputs
    (``_kd_sets``)."""
    import torch
    from repro_torch.kernels import kd_softmax_kl as kd
    sets, nxt = _kd_sets(T, V, dtype, seed)
    g = torch.ones(T, dtype=torch.float32, device=DEV)
    _, stats = kd.kd_loss_fwd(*sets[0])
    elt = sets[0][0].element_size()
    regime = kd.plan(T, V, torch.cuda.get_device_properties(0)
                     .multi_processor_count)["regime"]
    plain_iters = 10 if T * V >= 1 << 26 else 50
    fwd_bytes = 2 * T * V * elt + T * 4 + T * 4 + T * 12
    bwd_bytes = 3 * T * V * elt + T * 4 + T * 12 + T * 4
    out = []
    for port, keys, plain, nbytes, ops in (
            (lambda: kd.kd_loss_fwd(*nxt()),
             ("kd_fwd_rows", "kd_fwd_stream"),
             lambda: kd.kd_loss_fwd_plain(*nxt(), tau=2.0, alpha=0.5),
             fwd_bytes, KD_FWD_OPS_PER_ELEM),
            (lambda: kd.kd_loss_bwd(*nxt(), stats, g),
             ("kd_bwd_rows", "kd_bwd_chunk"),
             lambda: kd.kd_loss_bwd_plain(*nxt(), stats, g, tau=2.0,
                                          alpha=0.5),
             bwd_bytes, KD_BWD_OPS_PER_ELEM)):
        r = {"regime": regime, "input_sets": len(sets), "ms": time_ms(port),
             "device_us": device_us(port, keys),
             "plain_ms": time_ms(plain, iters=plain_iters)}
        r["bound_ms"], r["bound_by"] = bound_ms(nbytes, ops * T * V)
        out.append(r)
    return out


def _merge_round_timing(*, student: bool):
    """One merge of 40 client dicts of the MNIST student's ten leaves
    (FedSiKD's round) or of the teacher's (``student=False``: loop FedAvg's
    and FedProx's round; no staleness, as on the paths), in one call: the
    one-launch multi-leaf entry the paths take (``ms``; ``device_us`` its
    kernel, ``device_all_us`` every device event of a call, the table's
    copy included); the plain version; ``w @ x`` per leaf on ready stacks
    (the library column); and, for the student only, the earlier path
    written out (a torch.stack of the clients' copies and one single-leaf
    launch a leaf), the design the multi-leaf entry replaced."""
    import numpy as np
    import torch
    from repro_torch.kernels import fused_merge as fm
    rows, w, _ = _client_rows(40, (torch.float32,), 10, student=student)
    s = np.zeros_like(w)
    N, L = len(rows), len(rows[0])
    wd, sd = torch.from_numpy(w).to(DEV), torch.from_numpy(s).to(DEV)
    stacks = [torch.stack([r[l] for r in rows]).reshape(N, -1)
              for l in range(L)]
    wn = wd / wd.sum()
    sizes = [x.shape[1] for x in stacks]
    nbytes = sum(N * D * 4 + 2 * N * 4 + D * 4 for D in sizes)
    nops = sum(2 * N * D for D in sizes)

    def leaves():
        return fm.fused_merge_leaves(rows, w, s)

    def earlier():
        return [fm.fused_merge(torch.stack([r[l] for r in rows])
                               .reshape(N, -1), wd, sd) for l in range(L)]
    out = {"ms": time_ms(leaves),
           "device_us": device_us(leaves, ("fused_merge_leaves_kernel",)),
           "device_all_us": device_us(leaves, ("",)),
           "plain_ms": time_ms(lambda: fm.fused_merge_leaves_plain(rows, w,
                                                                   s)),
           "library_ms": time_ms(lambda: [wn @ x for x in stacks]),
           "leaf_sizes": sizes, "bytes": nbytes}
    if student:
        out["earlier_path_ms"] = time_ms(earlier)
        out["earlier_path_device_all_us"] = device_us(earlier, ("",))
    out["bound_ms"], out["bound_by"] = bound_ms(nbytes, nops)
    return out


def _kmeans_timing(N, K, seed):
    """One assignment call at (N, 2352, K) beside its bound, its device
    time (the profiler), the plain version and ``torch.cdist(x, c).min(1)``
    (the library column)."""
    import torch
    from repro_torch.kernels import kmeans_assign as km
    x, c = _kmeans_inputs(N, K, seed)
    out = {"regime": km.plan(N, KM_F, K, torch.cuda.get_device_properties(0)
                             .multi_processor_count)["regime"],
           "ms": time_ms(lambda: km.kmeans_assign(x, c)),
           "device_us": device_us(lambda: km.kmeans_assign(x, c),
                                  ("kmeans_assign_",)),
           "plain_ms": time_ms(lambda: km.kmeans_assign_plain(x, c)),
           "library_ms": time_ms(lambda: torch.cdist(x, c).min(1))}
    nbytes = (N * KM_F + K * KM_F) * 4 + N * 8
    nops = 2 * N * K * KM_F + 2 * N * KM_F + 2 * K * KM_F
    out["bound_ms"], out["bound_by"] = bound_ms(nbytes, nops)
    return out


def fa_work(shape, elt: int) -> tuple[float, float]:
    """(bytes, flops) of one flash-attention call: q, k, v read once and
    the output written once; 4 hd operations per (query, visible key) pair
    of every head (the two products), counting only the keys this mask
    shows."""
    B, H, KVH, T, S, hd, window = shape
    off = S - T
    pairs = 0
    for t in range(T):
        hi = min(S, t + off + 1)
        lo = max(0, t + off - window + 1) if window else 0
        pairs += hi - lo if hi > 0 else S
    nbytes = (2 * B * T * H * hd + 2 * B * S * KVH * hd) * elt
    return nbytes, 4.0 * hd * pairs * B * H


def device_us(fn, keys, calls: int = 20) -> float:
    """Device time per call of ``fn`` spent in the kernels whose names
    contain one of ``keys``: ``torch.profiler`` over ``calls`` calls after
    a warm-up.  Raises when three windows in a row saw no such kernel."""
    import torch
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile
    fn()
    torch.cuda.synchronize()
    for _ in range(3):      # a window now and then comes back without events
        with profile(activities=[ProfilerActivity.CPU,
                                 ProfilerActivity.CUDA]) as prof:
            for _ in range(calls):
                fn()
            torch.cuda.synchronize()
        us = sum(e.self_device_time_total for e in prof.key_averages()
                 if e.device_type == DeviceType.CUDA
                 and any(k in e.key for k in keys))
        if us > 0:
            return us / calls
    raise RuntimeError(f"the profiler saw no device time in {keys}")


def _fa_timing(shape, seed):
    """The kernel the dispatch picks (tensor-core kernel for the prefill,
    decode kernel for T = 1), its device time per call, its plain version
    and SDPA (``is_causal`` for T == S; a decode step's one query sees
    every key, so no mask) in bf16 at one of the served model's shapes."""
    import torch
    import torch.nn.functional as F
    from repro_torch.kernels import flash_attention as fa
    q, k, v = _fa_inputs(shape, torch.bfloat16, seed)
    qt, kt, vt = (x.transpose(1, 2).contiguous() for x in (q, k, v))
    causal = shape[3] > 1
    iters = 10 if causal else 50
    kind = fa.variant(torch.bfloat16, shape[3])
    kernel = {"tensor_core": "fa_tc_kernel", "decode": "fa_decode_kernel"}
    out = {"shape": f"(B,H,KVH,T,S,hd)={shape[:6]} bf16", "kernel": kind,
           "source": "src/repro_torch/kernels/csrc/" + {
               "tensor_core": "flash_attention_tc.cu",
               "decode": "flash_attention_decode.cu"}[kind],
           "ms": time_ms(lambda: fa.flash_attention(q, k, v), iters=iters),
           "device_us": device_us(lambda: fa.flash_attention(q, k, v),
                                  (kernel[kind],)),
           "plain_ms": time_ms(lambda: fa.flash_attention_plain(q, k, v),
                               iters=iters),
           "library_ms": time_ms(lambda: F.scaled_dot_product_attention(
               qt, kt, vt, is_causal=causal, enable_gqa=True), iters=iters)}
    out["bound_ms"], out["bound_by"] = bound_ms(*fa_work(shape, 2),
                                                BF16_FLOPS_PER_S)
    return out


def phase_timing(errs, path_counts, merge_paths, kmeans_paths, kd_paths,
                 variants, smi, *, fa_paths, distill_kd, distill_more):
    import torch
    rows_path = PATH_ROWS
    kd_fwd, kd_bwd = _kd_timing(rows_path, 10, torch.float32, 20)
    emit({"timing": f"kd T={rows_path} V=10 float32 (the packed path's "
          "step)", "fwd": kd_fwd, "bwd": kd_bwd, "card": smi})
    f64, b64 = _kd_timing(64, 10, torch.float32, 22)
    emit({"timing": "kd T=64 V=10 float32 (the loop engine's step)",
          "fwd": f64, "bwd": b64, "card": smi})
    km_path = _kmeans_timing(KM_N, 5, 23)
    km_big = _kmeans_timing(16384, 8, 24)
    emit({"timing": f"kmeans_assign N=16384 F={KM_F} K=8", **km_big,
          "card": smi})
    merge = _merge_round_timing(student=True)
    merge_teacher = _merge_round_timing(student=False)
    kd_large = {"fwd": [], "bwd": []}
    for T, V, dtype in ((2048, 32000, torch.float32),
                        (2048, 32000, torch.bfloat16),
                        (1024, 151936, torch.bfloat16),
                        (DISTILL_ROWS, 151936, torch.bfloat16),
                        (16, 151936, torch.bfloat16)):
        f, b = _kd_timing(T, V, dtype, 21)
        shape = f"T={T} V={V} {str(dtype)[6:]}"
        emit({"timing": f"kd {shape}", "fwd": f, "bwd": b, "card": smi})
        kd_large["fwd"].append({"shape": shape, **f})
        kd_large["bwd"].append({"shape": shape, **b})
    emit({"timing": "fused_merge, one round (10 leaves, N=40, one launch)",
          **merge, "card": smi})
    emit({"timing": "fused_merge, one FedAvg round (the teacher's 10 "
          "leaves, N=40, one launch)", **merge_teacher, "card": smi})
    fa_prefill = _fa_timing(FA_PREFILL, 30)
    fa_decode = _fa_timing(FA_DECODE[-1], 31)
    emit({"timing": "flash_attention, the served model's decode step",
          **fa_decode, "card": smi})
    fa_hd = {}
    for tag, shape, seed in (
            ("hd 192, nemotron-4-340b's prefill", FA_HD192_PREFILL, 32),
            ("hd 192, nemotron-4-340b's last decode step", FA_HD192_DECODE,
             33),
            ("hd 96 prefill", FA_HD96_PREFILL, 34),
            ("hd 96 decode step", FA_HD96_DECODE, 35)):
        t = _fa_timing(shape, seed)
        t["max_abs_err"] = errs[f"flash_attention_hd{shape[5]}"]
        emit({"timing": f"flash_attention, {tag}", **t, "card": smi})
        fa_hd[tag] = t
    src = "src/repro_torch/kernels/csrc/"
    rows = [
        {"name": "kd_softmax_kl_fwd", "route": "cuda",
         "source": src + "kd_softmax_kl.cu",
         "replaces": "src/repro/kernels/kd_softmax_kl.py:33",
         "shape": f"T={rows_path} (40 lanes x 64) V=10 float32, one call",
         **kd_fwd, "library_ms": None, "large": kd_large["fwd"],
         "launches_by_path": kd_paths, "path": "run_federated packed",
         "in_lm_distill_step": {
             "shape": f"T={DISTILL_ROWS} V=151936 bfloat16",
             **distill_kd["kd_fwd_stream_kernel"]},
         "in_lm_distill_step_of": {
             a: {"shape": f"T={DISTILL_ROWS} V="
                 f"{_distill_config(a).vocab_size} bfloat16",
                 **m["kd_in_step"]["kd_fwd_stream_kernel"]}
             for a, m in distill_more.items()}},
        {"name": "kd_softmax_kl_bwd", "route": "cuda",
         "source": src + "kd_softmax_kl.cu",
         "replaces": "src/repro/kernels/kd_softmax_kl.py:118",
         "shape": f"T={rows_path} (40 lanes x 64) V=10 float32, one call",
         **kd_bwd, "library_ms": None, "large": kd_large["bwd"],
         "launches_by_path": kd_paths, "path": "run_federated packed",
         "in_lm_distill_step": {
             "shape": f"T={DISTILL_ROWS} V=151936 bfloat16",
             **distill_kd["kd_bwd_chunk_kernel"]},
         "in_lm_distill_step_of": {
             a: {"shape": f"T={DISTILL_ROWS} V="
                 f"{_distill_config(a).vocab_size} bfloat16",
                 **m["kd_in_step"]["kd_bwd_chunk_kernel"]}
             for a, m in distill_more.items()}},
        {"name": "fused_merge", "route": "cuda",
         "source": src + "fused_merge.cu",
         "replaces": "src/repro/kernels/fused_merge.py:30",
         "shape": "N=40, the 10 student leaves of one round, one launch",
         **{k: merge[k] for k in ("ms", "device_us", "plain_ms",
                                  "library_ms", "bound_ms", "bound_by",
                                  "earlier_path_ms")},
         "baselines": {"shape": "N=40, the 10 teacher leaves of one FedAvg "
                       "round, one launch",
                       **{k: merge_teacher[k] for k in (
                           "ms", "device_us", "plain_ms", "library_ms",
                           "bound_ms", "bound_by")}},
         "launches_by_path": merge_paths,
         "path": "run_federated loop"},
        {"name": "kmeans_assign", "route": "cuda",
         "source": src + "kmeans_assign.cu",
         "replaces": "src/repro/kernels/kmeans_assign.py:16",
         "shape": f"N={KM_N} F={KM_F} K=5 float32, one call", **km_path,
         "large": {"shape": f"N=16384 F={KM_F} K=8", **km_big},
         "launches_by_path": kmeans_paths,
         "path": "run_federated packed (clustering step)"},
        {"name": "flash_attention", "route": "cuda",
         "replaces": "src/repro/kernels/flash_attention.py:22",
         **fa_prefill,
         "decode": {**fa_decode,
                    "max_abs_err": errs["flash_attention_decode"]},
         "head_dims_96_192": fa_hd,
         "sources": [src + f for f in ("flash_attention_tc.cu",
                                       "flash_attention_decode.cu",
                                       "flash_attention.cu")],
         "variant_launches": variants, "launches_by_path": fa_paths,
         "path": f"{LM_ARCH} serve: prefill {LM_B} x {LM_PROMPT} + "
         f"{LM_DECODE} decode steps"},
    ]
    for r in rows:
        r["launches"] = path_counts[r["name"]]
        r["max_abs_err"] = errs[r["name"]]
    emit({"kernels": rows})


# ---------------------------------------------------------- --profile mode
PORT_KERNELS = ("kd_fwd_rows_kernel", "kd_fwd_stream_kernel",
                "kd_bwd_rows_kernel", "kd_bwd_chunk_kernel",
                "fused_merge_leaves_kernel",
                "kmeans_assign_split_kernel", "kmeans_assign_stream_kernel",
                "fa_fwd_kernel", "fa_merge_kernel", "fa_tc_kernel",
                "fa_decode_kernel")
# substrings that sort device kernels into groups, tried in order (cuBLAS's
# "xmma_gemm" before cuDNN's "xmma" convolutions)
KERNEL_GROUPS = (("port", PORT_KERNELS),
                 ("memcpy/memset", ("Memcpy", "Memset")),
                 ("matmul (cuBLAS)", ("xmma_gemm", "nvjet", "gemv",
                                      "gemmSN", "cutlass")),
                 ("conv (cuDNN)", ("cudnn", "xmma", "conv", "wgrad", "dgrad",
                                   "implicit_gemm", "nhwcToNchw",
                                   "nchwToNhwc")),
                 ("matmul", ("gemm", "Kernel2", "splitK")),
                 ("reduce", ("reduce_kernel",)),
                 ("elementwise", ("elementwise", "Functor")))


def _union_us(spans) -> float:
    """Length of the union of (start, end) intervals."""
    total, cur = 0.0, None
    for start, end in sorted(spans):
        if cur is None or start > cur[1]:
            if cur is not None:
                total += cur[1] - cur[0]
            cur = [start, end]
        else:
            cur[1] = max(cur[1], end)
    return total + (cur[1] - cur[0] if cur is not None else 0.0)


def _device_summary(prof, wall_s):
    """Device busy time, idle share, launches, time by kernel group, the
    top kernels and the port's own kernels from one profiler window.  The
    busy time is the union of the device events' intervals (time with at
    least one kernel or copy running); the plain sum of their durations is
    kept beside it, since it counts overlapping kernels twice."""
    from torch.autograd import DeviceType
    events = prof.key_averages()
    dev = [e for e in events if e.device_type == DeviceType.CUDA]
    kernel_sum_us = sum(e.self_device_time_total for e in dev)
    busy_us = _union_us((e.time_range.start, e.time_range.end)
                        for e in prof.events()
                        if e.device_type == DeviceType.CUDA)
    groups = {}
    for e in dev:
        name = next((g for g, keys in KERNEL_GROUPS
                     if any(k in e.key for k in keys)), "other")
        groups[name] = groups.get(name, 0.0) + e.self_device_time_total / 1e3
    top = sorted(dev, key=lambda e: -e.self_device_time_total)[:10]
    return {
        "wall_ms": wall_s * 1e3, "device_busy_ms": busy_us / 1e3,
        "device_kernel_ms_sum": kernel_sum_us / 1e3,
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
    then one epoch of the fused distill step on client 0's shard, then the
    clustering step, then one steady round of the packed engine (its steps
    are the longest teacher and student budgets of the round).  Each
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

    # the clustering step of the same configuration: select_k + kmeans on
    # the standardised statistics of the 40 clients
    from repro_torch.core import kmeans, stats
    from repro_torch.fed.algorithms.clustered_kd import stat_features
    feats = stats.standardize(stat_features(shards, cfg, device=DEV))
    torch.cuda.synchronize()
    with profile(activities=acts) as prof:
        t0 = time.perf_counter()
        k, _ = kmeans.select_k(cfg.seed + 17, feats, *cfg.k_range)
        kmeans.kmeans(cfg.seed + 17, feats, k)
        torch.cuda.synchronize()
        t1 = time.perf_counter()
    emit({"phase": "profile", "window": "clustering step (select_k + kmeans)",
          "card": smi, "features": list(feats.shape), "k": k,
          **_device_summary(prof, t1 - t0)})

    # the packed engine: one steady round of the same configuration
    cfg = FedConfig(algorithm="fedsikd", engine="sharded",
                    pack=PACKED_LANES, rounds=2)
    alg = make_algorithm(cfg)
    alg.setup(ds, shards, cfg, cfg.seed, device=torch.device(DEV))
    alg.warmup()
    alg.run_round(alg.scheduler.plan(1), 1)
    alg.eval()
    torch.cuda.synchronize()
    plan = alg.scheduler.plan(2)
    steps = {"student": int(plan.steps_for(alg.s_steps_all).max()),
             "teacher": int(plan.steps_for(alg.t_steps_all).max())}
    with profile(activities=acts) as prof:
        t0 = time.perf_counter()
        alg.run_round(plan, 2)
        t1 = time.perf_counter()
        alg.eval()
        torch.cuda.synchronize()
        t2 = time.perf_counter()
    summary = _device_summary(prof, t2 - t0)
    emit({"phase": "profile", "window": "packed engine, round 2",
          "card": smi, "lanes": alg.S, "train_merge_ms": (t1 - t0) * 1e3,
          "eval_ms": (t2 - t1) * 1e3, "steps": steps,
          "host_ms_per_step": (t1 - t0) * 1e3 / sum(steps.values()),
          "launches_per_step": summary["host_kernel_launches"]
          / sum(steps.values()), **summary})

    # FedAvg on each engine: one steady round of the baselines_path runs
    for engine, pack in (("loop", 1), ("sharded", PACKED_LANES)):
        cfg = FedConfig(algorithm="fedavg", engine=engine, pack=pack,
                        rounds=2)
        alg = make_algorithm(cfg)
        alg.setup(ds, shards, cfg, cfg.seed, device=torch.device(DEV))
        alg.run_round(alg.scheduler.plan(1), 1)
        alg.eval()
        torch.cuda.synchronize()
        with profile(activities=acts) as prof:
            t0 = time.perf_counter()
            alg.run_round(alg.scheduler.plan(2), 2)
            t1 = time.perf_counter()
            alg.eval()
            torch.cuda.synchronize()
            t2 = time.perf_counter()
        emit({"phase": "profile", "window": f"fedavg {engine} engine, "
              "round 2", "card": smi, "train_merge_ms": (t1 - t0) * 1e3,
              "eval_ms": (t2 - t1) * 1e3, **_device_summary(prof, t2 - t0)})


def phase_profile_lm(smi):
    """Under ``torch.profiler``, after one untimed warm-up serve, one
    prefill and one decode step of each profiled model, each its own
    window: the served model (LM_B x LM_PROMPT tokens, the step at
    position LM_PROMPT) and PROFILE_FAMILIES at ``lm_serve``'s traffic
    (SERVE_B x SERVE_PROMPT, the step at position SERVE_PROMPT;
    seamless's prefill of its frames and SERVE_AUDIO_PROMPT tokens, the
    step at position SERVE_AUDIO_PROMPT over a cache holding the
    memory)."""
    import numpy as np
    import torch
    from torch.profiler import ProfilerActivity, profile
    from repro_torch.configs import get_config
    from repro_torch.kernels import flash_attention as fa
    from repro_torch.kernels import launch_counts, reset_launches
    from repro_torch.launch.steps import make_decode_step, make_prefill_step
    from repro_torch.models import encdec as ed

    acts = [ProfilerActivity.CPU, ProfilerActivity.CUDA]

    def window(name, fn):
        torch.cuda.synchronize()
        reset_launches()
        with profile(activities=acts) as prof:
            t0 = time.perf_counter()
            out = fn()
            torch.cuda.synchronize()
            t1 = time.perf_counter()
        emit({"phase": "profile", "window": name, "card": smi,
              "port_launches": launch_counts(), "flash_attention_variants":
              dict(fa.flash_attention.variant_launches),
              **_device_summary(prof, t1 - t0)})
        return out

    for arch in (LM_ARCH, *PROFILE_FAMILIES):
        cfg = get_config(arch)
        params = _init_serving(cfg)
        prefill, decode = make_prefill_step(cfg), make_decode_step(cfg)
        audio = cfg.arch_type == "audio"
        if arch == LM_ARCH:
            prompt = _lm_prompt(cfg)
        else:
            r = np.random.default_rng(LM_SEED + 2)
            prompt = torch.from_numpy(r.integers(0, cfg.vocab_size, (
                SERVE_B, SERVE_AUDIO_PROMPT if audio else SERVE_PROMPT))).to(
                    DEV)
        B, T = prompt.shape
        batch = {"tokens": prompt}
        if audio:
            batch["frames"] = _audio_frames(cfg, r)
            _serve_audio(cfg, params, batch["frames"], prompt, 2)
        else:
            _serve(cfg, params, prompt, 2)
        last, cache = window(f"{arch} prefill {B} x {T}",
                             lambda: prefill(params, batch))
        if audio:
            memory = cache
            cache = ed.init_cache(cfg, B, T + 1, memory.shape[1], device=DEV)
            cache["memory"] = memory
        else:
            cache = _grow(cache, 1)
        tok = last.argmax(dim=-1, keepdim=True)
        window(f"{arch} decode step at position {T}",
               lambda: decode(params, cache, tok, T))
        del params, cache, last
        torch.cuda.empty_cache()


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
        phase_profile_lm(smi)
        return 0
    if sys.argv[1:]:
        print(f"chip_smoke: unknown arguments {sys.argv[1:]} (only "
              "--profile)", file=sys.stderr)
        return 2
    errs = phase_kernel_checks()
    ds = load_dataset("mnist")
    kd_counts = phase_fused_distill(ds)
    merge_counts, loop_h = phase_main_path(ds)
    packed_counts, packed_h = phase_packed_path(ds, loop_h)
    baseline_merges, baseline_h = phase_baselines_path(ds, loop_h, packed_h)
    mesh_counts = phase_mesh_path(ds, packed_h, baseline_h["fedavg packed"],
                                  smi)
    runtime_counts, runtime_h = phase_runtime_path(ds, loop_h, packed_h)
    scale_counts = phase_scale_path(ds, runtime_h)
    timed = []
    lm_counts, lm_variants, serve_more = phase_lm_serve(smi, timed)
    phase_lm_train(smi, timed)
    distill_counts, distill_kd, distill_more = phase_lm_distill(smi, timed)
    phase_dryrun(smi, timed)
    phase_examples(smi)
    for name, c in (("kd_softmax_kl_fwd", kd_counts),
                    ("kd_softmax_kl_bwd", kd_counts),
                    ("fused_merge", merge_counts),
                    *(("fused_merge", {"fused_merge": baseline_merges[r]})
                      for r in ("fedavg loop", "fedprox loop",
                                "flhc loop")),
                    ("kd_softmax_kl_fwd", packed_counts),
                    ("kd_softmax_kl_bwd", packed_counts),
                    ("kd_softmax_kl_fwd", mesh_counts),
                    ("kd_softmax_kl_bwd", mesh_counts),
                    ("kmeans_assign", merge_counts),
                    ("kmeans_assign", packed_counts),
                    ("kmeans_assign", mesh_counts),
                    ("fused_merge", runtime_counts["fedsikd loop runtime"]),
                    ("fused_merge", runtime_counts["fedavg loop runtime"]),
                    ("kmeans_assign", runtime_counts["fedsikd loop runtime"]),
                    ("kmeans_assign",
                     runtime_counts["fedsikd packed runtime"]),
                    *((k, c) for run, c in scale_counts.items()
                      if run.startswith("fedsikd")
                      for k in ("kd_softmax_kl_fwd", "kd_softmax_kl_bwd",
                                "kmeans_assign")),
                    ("fused_merge", scale_counts["fedavg loop scale"]),
                    ("fused_merge", scale_counts["fedavg packed 2 waves"]),
                    ("flash_attention", lm_counts),
                    *(("flash_attention", m["launches"])
                      for m in serve_more.values() if m["expected_flash"]),
                    ("kd_softmax_kl_fwd", distill_counts),
                    ("kd_softmax_kl_bwd", distill_counts),
                    ("flash_attention", distill_counts),
                    *((k, m["counts"]) for m in distill_more.values()
                      for k in ("kd_softmax_kl_fwd", "kd_softmax_kl_bwd")),
                    *(("flash_attention", m["counts"])
                      for a, m in distill_more.items()
                      if _teacher_attention_launches(_distill_config(a)))):
        if c[name] < 1:
            raise RuntimeError(f"{name} was not launched on its path")
    path_counts = {"kd_softmax_kl_fwd": packed_counts["kd_softmax_kl_fwd"],
                   "kd_softmax_kl_bwd": packed_counts["kd_softmax_kl_bwd"],
                   "fused_merge": merge_counts["fused_merge"],
                   "kmeans_assign": packed_counts["kmeans_assign"],
                   "flash_attention": lm_counts["flash_attention"]}
    merge_paths = {"fedsikd loop": merge_counts["fused_merge"],
                   "fedsikd packed": packed_counts["fused_merge"],
                   **baseline_merges,
                   **{k: c["fused_merge"] for k, c in runtime_counts.items()},
                   "stale merges (s >= 1)": {
                       k: c["fused_merge_stale"]
                       for k, c in runtime_counts.items()}}
    merge_paths.update({k: c["fused_merge"]
                        for k, c in scale_counts.items()})
    kmeans_paths = {"fedsikd loop": merge_counts["kmeans_assign"],
                    "fedsikd packed": packed_counts["kmeans_assign"],
                    **{k: c["kmeans_assign"]
                       for k, c in runtime_counts.items()},
                    **{k: c["kmeans_assign"]
                       for k, c in scale_counts.items()
                       if k.startswith("fedsikd")}}
    kd_paths = {"fedsikd packed": packed_counts["kd_softmax_kl_fwd"],
                **{k: c["kd_softmax_kl_fwd"]
                   for k, c in scale_counts.items()
                   if k.startswith("fedsikd")},
                "lm_distill (6 steps, 5 on the KD kernels)":
                distill_counts["kd_softmax_kl_fwd"],
                **{f"lm_distill {a} ({m['steps']} steps, "
                   f"{m['counts']['kd_softmax_kl_fwd']} on the KD kernels)":
                   m["counts"]["kd_softmax_kl_fwd"]
                   for a, m in distill_more.items()}}
    fa_paths = {f"{LM_ARCH} serve": lm_counts["flash_attention"],
                **{f"{a} serve" + (f" ({SERVE_DEPTH[a]} layers)"
                                   if a in SERVE_DEPTH else ""):
                   m["launches"]["flash_attention"]
                   for a, m in serve_more.items()},
                "lm_distill teacher (6 steps)":
                distill_counts["flash_attention"],
                **{f"lm_distill {a} teacher ({m['steps']} steps)":
                   m["counts"]["flash_attention"]
                   for a, m in distill_more.items()},
                "lm_train (every model)": 0}
    phase_timing(errs, path_counts, merge_paths, kmeans_paths, kd_paths,
                 lm_variants, smi, fa_paths=fa_paths, distill_kd=distill_kd,
                 distill_more=distill_more)
    print(smi, flush=True)
    emit({"ok": True, "device": {"platform": "gpu",
                                 "kind": torch.cuda.get_device_name(0),
                                 "count": torch.cuda.device_count()}})
    return 0


if __name__ == "__main__":
    sys.exit(main())
