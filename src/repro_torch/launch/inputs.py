"""Fake-tensor stand-ins for every model input x input shape, never
allocating (the dry run's contract): the port of ``repro.launch.inputs``.

Each function returns fake tensors (``FakeTensorMode``: shape, dtype and
device, no storage) of the shapes and dtypes of the JAX package's
``ShapeDtypeStruct``s, made in the active fake mode, or in a new one when
none is active.  A shape is a name of ``INPUT_SHAPES`` or a dict of the
same keys (``seq_len``, ``global_batch``, ``kind``), which may also give
the audio ``frames`` (else ``seq_len // frame_ratio``, as in JAX).
"""
from __future__ import annotations

import contextlib

import torch
from torch._guards import active_fake_mode
from torch._subclasses.fake_tensor import FakeTensorMode

from repro_torch.configs.base import INPUT_SHAPES, ModelConfig
from repro_torch.models import encdec as ed
from repro_torch.models import transformer as tf
from repro_torch.models.layers import DTYPES


def shape_spec(shape) -> dict:
    """``INPUT_SHAPES[shape]`` for a name, the dict itself otherwise."""
    return INPUT_SHAPES[shape] if isinstance(shape, str) else shape


def _fake():
    """The active fake mode's context (nothing to enter), or a new mode."""
    if active_fake_mode() is not None:
        return contextlib.nullcontext()
    return FakeTensorMode()


def _frames(cfg: ModelConfig, spec: dict) -> int:
    return spec.get("frames", spec["seq_len"] // cfg.frame_ratio)


def batch_specs_for(cfg: ModelConfig, shape, *, device="cuda") -> dict:
    """Token/label/prefix stand-ins for train or prefill shapes: int32
    tokens and labels, a VLM's prefix and an audio model's frames in the
    config's dtype."""
    spec = shape_spec(shape)
    B, S = spec["global_batch"], spec["seq_len"]
    dt = DTYPES[cfg.dtype]
    with _fake():
        def ints(shape):
            return torch.empty(shape, dtype=torch.int32, device=device)

        if cfg.arch_type == "audio":
            batch = {"frames": torch.empty((B, _frames(cfg, spec),
                                            cfg.d_model), dtype=dt,
                                           device=device),
                     "tokens": ints((B, S))}
        elif cfg.arch_type == "vlm":
            P_ = cfg.prefix_len
            batch = {"prefix": torch.empty((B, P_, cfg.d_model), dtype=dt,
                                           device=device),
                     "tokens": ints((B, S - P_))}
        else:
            batch = {"tokens": ints((B, S))}
        if spec["kind"] == "train":
            batch["labels"] = ints(batch["tokens"].shape)
        return batch


def cache_specs_for(cfg: ModelConfig, shape, *, device="cuda") -> dict:
    """The decode cache of ``global_batch`` sequences of ``seq_len``
    positions, through the port's ``init_cache`` in a fake mode."""
    spec = shape_spec(shape)
    B, S = spec["global_batch"], spec["seq_len"]
    with _fake():
        if cfg.arch_type == "audio":
            return ed.init_cache(cfg, B, S, _frames(cfg, spec),
                                 device=device)
        return tf.init_cache(cfg, B, S, device=device)


def input_specs(cfg: ModelConfig, shape, *, device="cuda") -> dict:
    """All inputs of the step this shape runs (see ``dryrun.py``).  A
    decode step's ``pos`` is a Python int (the port's decode takes the
    position so), the last position of the cache: the step decodes into
    a full cache."""
    spec = shape_spec(shape)
    if spec["kind"] in ("train", "prefill"):
        return {"batch": batch_specs_for(cfg, spec, device=device)}
    B = spec["global_batch"]
    with _fake():
        return {"cache": cache_specs_for(cfg, spec, device=device),
                "tokens": torch.empty((B, 1), dtype=torch.int32,
                                      device=device),
                "pos": spec["seq_len"] - 1}
