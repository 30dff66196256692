"""Dry run on one card: build every (architecture x input shape) step on
fake tensors, run it once and record its memory, FLOPs, bytes and roofline
terms, with nothing allocated: the port of ``repro.launch.dryrun``.

JAX lowers and compiles each step for a TPU mesh and reads XLA's analyses;
here each step runs once under ``FakeTensorMode`` (shapes, dtypes and
devices, no storage) and ``launch/roofline.analyze`` counts it, so a step
of a model that does not fit the card is sized all the same.  The step
kinds are the JAX ones, through the port's ``launch/steps.py``: ``train``
(grad accumulation ``TRAIN_ACCUM``), ``prefill``, ``decode`` (one token
into a full cache: the last position) and ``fedsikd`` (the paper's
distillation step, ``replicas`` student replicas of ``batch / replicas``
sequences each, clusters ``arange(D) // max(D // 4, 1)`` as in JAX).  The
steps and their constants (the averaging matrices) are built before the
fake mode; the weights, state and inputs inside it.

Usage:
  PYTHONPATH=src python -m repro_torch.launch.dryrun --arch qwen2.5-3b \\
      --shape prefill_32k --device cpu
  PYTHONPATH=src python -m repro_torch.launch.dryrun --all [--out f.json]
  PYTHONPATH=src python -m repro_torch.launch.dryrun --arch glm4-9b \\
      --shape train_4k --step fedsikd

The default device is the card (``cuda``); on a machine without one pass
``--device cpu`` (the counts do not depend on the device faked).  Results
append to ``--out`` as they come (finished combinations are skipped).
"""
from __future__ import annotations

import argparse
import dataclasses
import json
import time
import traceback
from pathlib import Path

import numpy as np
import torch
from torch._subclasses.fake_tensor import FakeTensorMode

from repro_torch.configs.base import (ARCH_IDS, INPUT_SHAPES, ModelConfig,
                                      get_config)
from repro_torch.launch import inputs as inp
from repro_torch.launch import roofline as rl
from repro_torch.launch import steps as st
from repro_torch.models import encdec as ed
from repro_torch.models import transformer as tf
from repro_torch.tree import flatten

# grad-accumulation per arch for train_4k (keeps activations in HBM budget)
TRAIN_ACCUM = {
    "nemotron-4-340b": 16,
    "arctic-480b": 8,
    "deepseek-v2-236b": 8,
    "glm4-9b": 2,
    "minitron-8b": 2,
    "seamless-m4t-large-v2": 2,
}

# long_500k policy (DESIGN.md §4): runs for sub-quadratic paths only
LONG_OK = {"rwkv6-3b": None, "zamba2-1.2b": None,
           "qwen2.5-3b": 4096, "glm4-9b": 4096}   # value = sliding window

# the fedsikd step's student replicas on one card: the count chip_smoke.py's
# lm_distill runs
REPLICAS = 2
# a decode cache's leaves written one position a step (axis 2 of (L, B, S,
# ...)); "memory" (the encoder's output) is only read; every other leaf (a
# recurrent state) is written whole
_SLOT_LEAVES = ("k", "v", "c_kv", "k_rope", "attn_k", "attn_v")


def shape_skip_reason(arch: str, shape: str) -> str | None:
    if shape == "long_500k" and arch not in LONG_OK:
        return "full-attention arch: 500k decode needs sub-quadratic attention"
    return None


def arch_config(arch: str, shape: str) -> ModelConfig:
    cfg = get_config(arch)
    if shape == "long_500k" and LONG_OK.get(arch):
        cfg = dataclasses.replace(cfg, sliding_window=LONG_OK[arch])
    return cfg


def _init(cfg: ModelConfig):
    return ed.init_encdec if cfg.arch_type == "audio" else tf.init_lm


def cache_write_bytes(cache: dict) -> int:
    """Bytes one decode step writes into ``cache``: a position of each
    key/value or latent leaf, every recurrent state whole, not the encoder
    memory."""
    out = 0
    for name, t in flatten(cache).items():
        leaf = name.rsplit(".", 1)[-1]
        if leaf == "memory":
            continue
        size = t.numel() * t.element_size()
        out += size // t.shape[2] if leaf in _SLOT_LEAVES else size
    return out


def embed_unread(cfg: ModelConfig, params: dict, rows: int) -> int:
    """Bytes of ``params``' embedding table that a forward gathering
    ``rows`` token rows leaves unread: all but those rows, when the table
    is not also the LM head (a tied table is read whole by the head)."""
    if cfg.tie_embeddings:
        return 0
    e = params["embed"]
    return (e.shape[0] - min(rows, e.shape[0])) * e.shape[1] * \
        e.element_size()


def card_bytes() -> float:
    """The card's memory, or the H100's 80 GB without a card."""
    if torch.cuda.is_available():
        return float(torch.cuda.get_device_properties(0).total_memory)
    return rl.HBM_CAPACITY_BYTES


def model_flops(cfg: ModelConfig, kind: str, shape) -> float:
    """6 (train) or 2 (prefill, decode) x ``active_param_count()`` x the
    tokens a step takes (one a sequence in decode; the fedsikd step the
    students' 6 and the teacher's 2 a token): the formula of JAX's
    ``param_count`` docstring."""
    spec = inp.shape_spec(shape)
    tokens = spec["global_batch"] * spec["seq_len"]
    if kind == "train":
        return float(6 * cfg.active_param_count() * tokens)
    if kind == "fedsikd":
        return float((6 * cfg.as_student().active_param_count()
                      + 2 * cfg.active_param_count()) * tokens)
    if kind == "prefill":
        return float(2 * cfg.active_param_count() * tokens)
    return float(2 * cfg.active_param_count() * spec["global_batch"])


def build_step(arch: str, shape, *, step_kind: str = "auto",
               cfg: ModelConfig | None = None, accum: int | None = None,
               fedsikd_teacher_in_grad: bool = False,
               fedsikd_vocab_chunk: int = 0, replicas: int = REPLICAS,
               opt_cfg: ModelConfig | None = None, device="cuda") -> dict:
    """One combination's step, its inputs and what the count needs:
    {"cfg", "kind", "step", "args", "written", "unread", "model_flops"}
    (``unread``: the embedding rows that the read-only forwards, of a
    serving step or of the fedsikd step's teacher, do not gather).  Call it
    inside a ``FakeTensorMode``: the step is built first (its constants
    are real tensors), then the weights, state and inputs, fake.

    ``shape`` is a name of ``INPUT_SHAPES`` or a dict of its keys (a
    caller's own batch).  ``cfg``/``accum`` overrides serve the analysis
    probes (``launch/analysis.py``) and a caller's cuts of depth or
    experts; ``opt_cfg`` is the config whose size picks the Adam moments'
    dtype (``steps.moment_dtype``: a probe keeps its full model's)."""
    spec = inp.shape_spec(shape)
    cfg = cfg or arch_config(arch, shape if isinstance(shape, str) else "")
    kind = spec["kind"] if step_kind == "auto" else step_kind
    written, unread = None, 0
    opt_cfg = opt_cfg or cfg
    with torch._subclasses.fake_tensor.unset_fake_temporarily():
        if kind == "train":
            accum = TRAIN_ACCUM.get(arch, 1) if accum is None else accum
            step, opt = st.make_train_step(
                cfg, accum=accum, state_dtype=st.moment_dtype(opt_cfg))
        elif kind == "fedsikd":
            cluster_of = np.arange(replicas) // max(replicas // 4, 1)
            step, _, init_students, opt, _ = st.make_fedsikd_distill_step(
                cfg, cluster_of, teacher_in_grad=fedsikd_teacher_in_grad,
                vocab_chunk=fedsikd_vocab_chunk,
                state_dtype=st.moment_dtype(opt_cfg.as_student()))
        elif kind == "prefill":
            step = st.make_prefill_step(cfg)
        else:
            step = st.make_decode_step(cfg)
    params = _init(cfg)(0, cfg, device=device)
    if kind == "train":
        args = (params, opt.init(params),
                inp.batch_specs_for(cfg, spec, device=device))
    elif kind == "fedsikd":
        students = init_students(0, device=device)
        batch = {k: v.reshape(replicas, v.shape[0] // replicas,
                              *v.shape[1:])
                 for k, v in inp.batch_specs_for(
                     cfg, {**spec, "kind": "train"}, device=device).items()}
        args = (students, opt.init(students), params, batch)
        unread = embed_unread(cfg, params, batch["tokens"].numel())
    elif kind == "prefill":
        args = (params, inp.batch_specs_for(cfg, spec, device=device))
        unread = embed_unread(cfg, params, args[1]["tokens"].numel())
    else:
        ins = inp.input_specs(cfg, spec, device=device)
        args = (params, ins["cache"], ins["tokens"], ins["pos"])
        unread = embed_unread(cfg, params, spec["global_batch"])

        def written(out):
            logits, cache = out
            return rl.nbytes(logits) + cache_write_bytes(cache)

    return {"cfg": cfg, "kind": kind, "step": step, "args": args,
            "written": written, "unread": unread,
            "model_flops": model_flops(cfg, kind, spec)}


def lower_one(arch: str, shape, *, verbose: bool = True, **kw) -> dict:
    """Count one combination (``build_step``'s arguments); returns its
    result dict."""
    with FakeTensorMode():
        b = build_step(arch, shape, **kw)
        counted = rl.analyze(b["step"], b["args"], dtype=b["cfg"].dtype,
                             written=b["written"], unread=b["unread"])
    cfg, kind, roof = b["cfg"], b["kind"], counted.roofline
    result = {
        "arch": arch,
        "shape": shape if isinstance(shape, str) else dict(shape),
        "step": kind, "mesh": "1", "chips": 1,
        "trace_s": round(counted.seconds, 1),
        "memory_analysis": counted.memory,
        "roofline": roof.as_dict(),
        "model_params": cfg.param_count(),
        "active_params": cfg.active_param_count(),
        "model_flops": b["model_flops"],
        "fits": counted.peak_bytes <= card_bytes(),
        "kernels": counted.kernels,
    }
    if verbose:
        print(f"  {arch} x {result['shape']} [{kind}] mesh=1: trace "
              f"{counted.seconds:.0f}s, dominant={roof.dominant}, "
              f"compute={roof.compute_s * 1e3:.2f}ms "
              f"mem={roof.memory_s * 1e3:.2f}ms "
              f"peak={counted.peak_bytes / 1e9:.2f}GB fits={result['fits']}",
              flush=True)
    return result


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", default=None)
    ap.add_argument("--shape", default=None)
    ap.add_argument("--step", default="auto",
                    help="auto|train|prefill|decode|fedsikd")
    ap.add_argument("--all", action="store_true")
    ap.add_argument("--device", default="cuda",
                    help="the device the fake tensors name (cuda|cpu)")
    ap.add_argument("--out", default="dryrun_results_torch.json")
    args = ap.parse_args()

    out = Path(args.out)
    results = json.loads(out.read_text()) if out.exists() else []
    done = {(r["arch"], r["shape"], r["step"]) for r in results}

    archs = [args.arch] if args.arch else ARCH_IDS
    shapes = [args.shape] if args.shape else list(INPUT_SHAPES)
    for arch in archs:
        for shape in shapes:
            reason = shape_skip_reason(arch, shape)
            kind = (INPUT_SHAPES[shape]["kind"] if args.step == "auto"
                    else args.step)
            if (arch, shape, kind) in done:
                continue
            if reason:
                print(f"  SKIP {arch} x {shape}: {reason}", flush=True)
                results.append({"arch": arch, "shape": shape, "step": kind,
                                "mesh": "1", "skipped": reason})
                out.write_text(json.dumps(results, indent=1))
                continue
            try:
                r = lower_one(arch, shape, step_kind=args.step,
                              device=args.device)
                results.append(r)
            except Exception as e:
                traceback.print_exc()
                results.append({"arch": arch, "shape": shape, "step": kind,
                                "mesh": "1", "error": str(e)[:2000]})
            out.write_text(json.dumps(results, indent=1))
    n_err = sum(1 for r in results if "error" in r)
    print(f"dry-run complete: {len(results)} records, {n_err} errors")
    return 0 if n_err == 0 else 1


if __name__ == "__main__":
    raise SystemExit(main())
