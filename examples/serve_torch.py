"""Serve a reduced model with batched requests on the PyTorch port: prefill
(returns the last logits and the decode cache), then a greedy decode
continuation, through the serving steps (``make_prefill_step`` /
``make_decode_step``).  The twin of ``examples/serve.py``; it imports only
``repro_torch``.

  PYTHONPATH=src python examples/serve_torch.py [arch] [--device cuda|cpu]

The default device is ``cuda``; without a card the example raises unless
given ``--device cpu``.
"""
import argparse
import dataclasses
import time

import torch

from repro_torch.configs import get_config
from repro_torch.fed.rounds import resolve_device
from repro_torch.launch.steps import make_decode_step, make_prefill_step
from repro_torch.models import transformer as tf
from repro_torch.models.layers import DTYPES
from repro_torch.tree import flatten

B, PROMPT, GEN = 4, 24, 16


def _grow(cache, T: int, extra: int):
    """Full-attention caches (L, B, T, ...) get ``extra`` empty slots for
    the continuation."""
    def grow(a):
        if a.dim() >= 4 and a.shape[2] == T:
            return torch.cat([a, torch.zeros_like(a[:, :, :extra])], dim=2)
        return a
    return {k: grow(v) for k, v in cache.items()}


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("arch", nargs="?", default="rwkv6-3b")
    ap.add_argument("--device", default="cuda",
                    help="torch device (raises without a card unless cpu)")
    args = ap.parse_args(argv)
    device = resolve_device(args.device)
    cfg = dataclasses.replace(get_config(args.arch, smoke=True), remat=False)
    if cfg.arch_type == "audio":
        raise SystemExit("use a decoder-only arch for this example")
    params = tf.init_lm(0, cfg, device=device)
    gen = torch.Generator(device=device).manual_seed(1)
    prompts = torch.randint(0, cfg.vocab_size, (B, PROMPT), generator=gen,
                            device=device)
    batch = {"tokens": prompts}
    if cfg.prefix_len:
        batch["prefix"] = torch.zeros((B, cfg.prefix_len, cfg.d_model),
                                      dtype=DTYPES[cfg.dtype], device=device)
    prefill, decode = make_prefill_step(cfg), make_decode_step(cfg)

    P = cfg.prefix_len
    t0 = time.time()
    last, cache = prefill(params, batch)
    # RWKV carries, Mamba2 states and sliding-window buffers keep their size
    if cfg.arch_type in ("dense", "moe", "vlm") and not cfg.sliding_window:
        cache = _grow(cache, P + PROMPT, GEN)
    print(f"{args.arch}: prefilled {B}x{PROMPT} tokens in "
          f"{time.time() - t0:.1f}s (cache leaves: {len(flatten(cache))})")

    tok = last.argmax(-1)[:, None]
    out = [tok]
    t0 = time.time()
    for t in range(PROMPT, PROMPT + GEN - 1):
        logits, cache = decode(params, cache, tok, P + t)
        tok = logits.argmax(-1)[:, None]
        out.append(tok)
    gen_toks = torch.cat(out, dim=1)
    if device.type == "cuda":
        torch.cuda.synchronize()
    ms = (time.time() - t0) / (GEN - 1) * 1e3
    print(f"generated {GEN} tokens/request greedily ({ms:.0f} ms/token on "
          f"{device.type}); sample row: {gen_toks[0][:10].tolist()}")
    return gen_toks


if __name__ == "__main__":
    main()
