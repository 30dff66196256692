"""Roofline terms of one step on one NVIDIA H100, counted on fake tensors:
the port of ``repro.launch.roofline``.

  compute term    = FLOPs / the card's peak rate for the step's dtype
  memory term     = bytes / HBM bandwidth
  collective term = 0: one card has no link to another

JAX reads its counts from a compiled XLA module (``cost_analysis``,
``memory_analysis``, and the collectives' operand bytes parsed from the
HLO text by ``_shape_bytes`` and ``collective_bytes``, which have no
counterpart here: PyTorch runs eagerly, there is no HLO, and one card runs
no collective).  Here ``analyze`` runs the step once on fake tensors
(``FakeTensorMode``: shapes, dtypes and devices, no storage) under
``FlopCounterMode`` and ``MemTracker``, and counts by rules that do not
depend on how the port computes the step, so that a later kernel does not
move the yardstick:

- bytes: each input of the step (params, optimizer state, batch or cache)
  read once, each output (the updated state, the loss or logits, the cache
  writes) written once; activations do not count.  Where the data decide
  what is read, what this step's data need: a forward that only reads an
  untied embedding table reads the rows it gathers (``unread``);
- FLOPs: ``FlopCounterMode``'s count of matmuls and convolutions, except
  attention, which counts 2 B H (d_qk + d_v) a visible (query, key) pair
  forward (4 B H hd at equal widths) and twice that backward, each time a
  forward runs it (a rematerialised layer runs it twice), on every path:
  the flash kernels, ``_sdpa``, ``sdpa_blocked`` and MLA's expanded,
  blocked and absorbed forms.  A causal prefill counts the pairs its mask
  leaves, about half of T x S.  The call sites mark their plain-torch
  attention (``attention``, ``attention_step``); the kernels' wrappers
  add their work on fake tensors (``kernel``);
- peak memory: ``MemTracker``'s peak of live tensors, the inputs included.

Published peaks of one H100 SXM (NVIDIA's data sheet, dense rates): 989
TFLOP/s in bf16, 67 TFLOP/s in float32 outside the tensor cores, 80 GB of
HBM at 3.35 TB/s, at the full 700 W power limit.
"""
from __future__ import annotations

import contextlib
import functools
import time
from collections import Counter
from dataclasses import dataclass, field

import numpy as np
import torch
from torch.utils.flop_counter import FlopCounterMode

BF16_FLOPS_PER_S = 989e12
F32_FLOPS_PER_S = 67e12
HBM_BYTES_PER_S = 3.35e12
HBM_CAPACITY_BYTES = 80e9

PEAK_FLOPS = {"bfloat16": BF16_FLOPS_PER_S, "float32": F32_FLOPS_PER_S}


@dataclass
class Roofline:
    flops: float                # the step's, on its one card
    hbm_bytes: float
    coll_bytes: float           # 0 on one card
    coll_detail: dict
    peak_flops: float = BF16_FLOPS_PER_S   # the rate of the step's dtype

    @property
    def compute_s(self) -> float:
        return self.flops / self.peak_flops

    @property
    def memory_s(self) -> float:
        return self.hbm_bytes / HBM_BYTES_PER_S

    @property
    def collective_s(self) -> float:
        return 0.0

    @property
    def dominant(self) -> str:
        terms = {"compute": self.compute_s, "memory": self.memory_s,
                 "collective": self.collective_s}
        return max(terms, key=terms.get)

    def as_dict(self) -> dict:
        return {
            "flops_per_device": self.flops,
            "hbm_bytes_per_device": self.hbm_bytes,
            "collective_bytes_per_device": self.coll_bytes,
            "compute_s": self.compute_s,
            "memory_s": self.memory_s,
            "collective_s": self.collective_s,
            "dominant": self.dominant,
            "collectives": self.coll_detail,
        }


@functools.lru_cache(maxsize=None)
def visible_pairs(T: int, S: int, causal: bool = True,
                  window: int = 0) -> int:
    """(query, key) pairs of T queries over S keys that the mask leaves:
    all T x S without ``causal``; with it the right-aligned mask (query t
    sees key s iff s <= t + S - T, and with ``window`` > 0 s > t + S - T
    - window)."""
    if not causal:
        return T * S
    diag = np.arange(T, dtype=np.int64) + (S - T)
    hi = np.clip(diag + 1, 0, S)
    lo = np.clip(diag - window + 1, 0, S) if window else 0
    return int(np.maximum(hi - lo, 0).sum())


class _Count(FlopCounterMode):
    """``FlopCounterMode`` that leaves the ops of marked attention out of
    its count and adds the attention formula in their place.

    A marked region's ops run while ``depth`` > 0 and are not counted (the
    forward, and its re-run when a checkpointed layer recomputes in the
    backward).  Their backward runs later, outside any region, and is
    counted as usual: twice the forward FLOPs of each product (a gradient
    for each operand).  So where a region's forward runs with a gradient to
    come, it adds the formula's backward and takes off twice what it left
    uncounted."""

    def __init__(self):
        super().__init__(display=False)
        self.depth = 0
        self.skipped = 0.0
        self.extra = 0.0
        self.kernels: Counter = Counter()

    def _count_flops(self, func_packet, out, args, kwargs):
        if not self.depth:
            return super()._count_flops(func_packet, out, args, kwargs)
        if func_packet in self.flop_registry:
            self.skipped += self.flop_registry[func_packet](
                *args, **kwargs, out_val=out)
        return out

    @contextlib.contextmanager
    def region(self, flops: float, inputs):
        outer = self.depth == 0
        if outer:
            self.skipped = 0.0
        self.depth += 1
        try:
            yield
        finally:
            self.depth -= 1
        if not outer:
            return
        self.extra += flops
        if (torch.is_grad_enabled()
                and torch._C._current_autograd_node() is None
                and any(t.requires_grad for t in inputs)):
            self.extra += 2 * flops - 2 * self.skipped

    @property
    def flops(self) -> float:
        return float(self.get_total_flops() + self.extra)


_ACTIVE: _Count | None = None
_NOT_COUNTING = contextlib.nullcontext()


def attention(B: int, H: int, width: int, T: int, S: int, *,
              causal: bool = True, window: int = 0, extra: float = 0.0,
              inputs=()):
    """Context for one plain-torch attention call of B x H heads, T
    queries over S keys, the scores and values ``width`` = d_qk + d_v wide
    in all; ``extra`` adds work the formula should hold beyond the pairs
    (MLA's blocked path expands its keys and values inside).  ``inputs``
    are the tensors whose gradient the caller may take.  Without an active
    count (any real run) a shared null context."""
    if _ACTIVE is None:
        return _NOT_COUNTING
    flops = 2 * B * H * width * visible_pairs(T, S, causal, window) + extra
    return _ACTIVE.region(flops, inputs)


def attention_step():
    """Context for one checkpointed block step inside an attention call
    (``sdpa_blocked``, ``mla_sdpa_blocked``): its ops, and their recompute
    in the backward, belong to the call's formula."""
    if _ACTIVE is None:
        return _NOT_COUNTING
    return _ACTIVE.region(0.0, ())


def kernel(name: str, flops: float = 0.0) -> None:
    """A kernel wrapper's fake branch: one call of ``name`` and its FLOPs
    (by the formulas above), into the active count if there is one."""
    if _ACTIVE is not None:
        _ACTIVE.kernels[name] += 1
        _ACTIVE.extra += flops


def tensors(tree) -> list:
    """The tensor leaves of a nest of dicts, lists and tuples, each once."""
    out, seen = [], set()

    def walk(t):
        if isinstance(t, dict):
            for v in t.values():
                walk(v)
        elif isinstance(t, (list, tuple)):
            for v in t:
                walk(v)
        elif isinstance(t, torch.Tensor) and id(t) not in seen:
            seen.add(id(t))
            out.append(t)

    walk(tree)
    return out


def nbytes(tree) -> int:
    return sum(t.numel() * t.element_size() for t in tensors(tree))


@dataclass
class Counted:
    """What ``analyze`` found: the roofline, the memory summary (the keys
    of JAX's ``memory_summary`` that mean something here), the kernel
    calls the fake branches saw, and the seconds the counted run took."""
    roofline: Roofline
    memory: dict
    kernels: dict = field(default_factory=dict)
    seconds: float = 0.0

    @property
    def peak_bytes(self) -> int:
        return (self.memory["argument_size_in_bytes"]
                + self.memory["temp_size_in_bytes"])


def analyze(step, args: tuple, *, dtype: str = "bfloat16", written=None,
            unread: int = 0) -> Counted:
    """Run ``step(*args)`` once and count it.  ``args`` are fake tensors,
    or nests of them, made under the active ``FakeTensorMode``, which the
    run stays in.  Bytes: ``args`` read once but ``unread`` bytes of them,
    and ``written(out)`` bytes written (default: every tensor of the
    step's output, once).  The peak is ``MemTracker``'s, with ``args``
    resident from the start."""
    from torch.distributed._tools.mem_tracker import MemTracker
    global _ACTIVE
    inputs = tensors(args)
    read = nbytes(inputs)
    tracker = MemTracker()
    tracker.track_external(*inputs)
    count = _Count()
    t0 = time.perf_counter()
    _ACTIVE = count
    try:
        with tracker, count:
            out = step(*args)
    finally:
        _ACTIVE = None
    seconds = time.perf_counter() - t0
    peak = sum(snap["Total"] for snap in
               tracker.get_tracker_snapshot("peak").values())
    out_bytes = nbytes(out)
    wrote = out_bytes if written is None else written(out)
    roof = Roofline(flops=count.flops,
                    hbm_bytes=float(read - unread + wrote),
                    coll_bytes=0.0, coll_detail={},
                    peak_flops=PEAK_FLOPS[dtype])
    memory = {"argument_size_in_bytes": read,
              "output_size_in_bytes": out_bytes,
              "temp_size_in_bytes": max(peak - read, 0)}
    return Counted(roof, memory, dict(count.kernels), seconds)
