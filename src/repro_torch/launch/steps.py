"""Serving step builders: the port of ``repro.launch.steps``'s
``make_prefill_step`` and ``make_decode_step`` for the decoder-only models.

The training, FedSiKD-distillation and audio (encoder-decoder) steps are
not ported yet (ROADMAP Queue 1 item 10).  PyTorch runs eagerly, so the
builders return plain functions; nothing is compiled.
"""
from __future__ import annotations

from repro_torch.configs.base import ModelConfig
from repro_torch.models import transformer as tf


def _check_decoder(cfg: ModelConfig) -> None:
    if cfg.arch_type == "audio":
        raise NotImplementedError(
            "the audio encoder-decoder's serving steps are not ported yet "
            "(ROADMAP Queue 1 item 10)")


def make_prefill_step(cfg: ModelConfig):
    """``prefill_step(params, batch) -> (last-token logits (B, V), cache)``."""
    _check_decoder(cfg)

    def prefill_step(params, batch):
        return tf.prefill(params, cfg, batch)

    return prefill_step


def make_decode_step(cfg: ModelConfig):
    """``decode_step(params, cache, tokens (B, 1), pos) -> (logits (B, V),
    cache)``; the cache is updated in place."""
    _check_decoder(cfg)

    def decode_step(params, cache, tokens, pos):
        logits, cache = tf.decode_step(params, cfg, cache, tokens, pos)
        return logits[:, -1, :], cache

    return decode_step
