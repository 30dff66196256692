#!/usr/bin/env python3
"""Run ``chip_smoke.py`` as it runs with no arguments, on one NVIDIA GPU,
and after each phase print the card's allocated memory before and after
a ``gc.collect()``:

    python3 tools/memory_by_phase.py

Each phase adds one JSON line ``{"memory_after_phase": NAME,
"allocated_gb": ..., "after_gc_collect_gb": ..., "phase_seconds": ...}`` to
the script's own output: memory that a collection frees was held by objects
in reference cycles, memory that it keeps by live references.  The exit
code is the script's.  It changes no file of the repository.
"""
from __future__ import annotations

import gc
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT))
import chip_smoke  # noqa: E402

PHASES = ("phase_kernel_checks", "phase_fused_distill", "phase_main_path",
          "phase_packed_path", "phase_baselines_path", "phase_mesh_path",
          "phase_runtime_path", "phase_scale_path", "phase_lm_serve",
          "phase_lm_train", "phase_lm_distill", "phase_dryrun",
          "phase_examples")


def _reporting(name, fn):
    def run(*args, **kwargs):
        import torch
        t0 = time.perf_counter()
        out = fn(*args, **kwargs)
        torch.cuda.synchronize()
        held = torch.cuda.memory_allocated() / 1e9
        gc.collect()
        chip_smoke.emit({"memory_after_phase": name, "allocated_gb": held,
                         "after_gc_collect_gb":
                         torch.cuda.memory_allocated() / 1e9,
                         "phase_seconds": time.perf_counter() - t0})
        return out
    return run


def main() -> int:
    sys.argv = [sys.argv[0]]
    for name in PHASES:
        setattr(chip_smoke, name, _reporting(name, getattr(chip_smoke, name)))
    return chip_smoke.main()


if __name__ == "__main__":
    sys.exit(main())
