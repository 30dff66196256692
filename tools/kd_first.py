"""The KD loss kernels' first design, ``tools/kd_softmax_kl_first.cu``, built
into its own library and called through ``ctypes`` beside the port's
kernels, so that one process times both on the same inputs
(``chip_smoke.py`` phase 5 does).

    proc, path = start_build()      # one nvcc, started with the port's
    proc.wait()                     # build and waited for after it
    lib = load(path)
    loss, stats = fwd(lib, s, t, y, tau=2.0, alpha=0.5)
    ds = bwd(lib, s, t, y, stats, g, tau=2.0, alpha=0.5)

The library goes to ``build/repro_torch/`` at the repository root (a path
``.gitignore`` lists).  Inputs are contiguous CUDA tensors of one device.
"""
from __future__ import annotations

import ctypes
import subprocess
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]
SOURCE = ROOT / "tools" / "kd_softmax_kl_first.cu"
LIB = ROOT / "build" / "repro_torch" / "libkd_first.so"
RENAME = ("-Dfedsikd_kd_fwd=fedsikd_kd_first_fwd",
          "-Dfedsikd_kd_bwd=fedsikd_kd_first_bwd")
_P = ctypes.c_void_p


def start_build(nvcc: str = "/usr/local/cuda/bin/nvcc"):
    """Start compiling and linking the first design; returns the process
    (its output in ``build/repro_torch/kd_first.log``) and the library's
    path."""
    LIB.parent.mkdir(parents=True, exist_ok=True)
    log = open(LIB.parent / "kd_first.log", "w")
    proc = subprocess.Popen(
        [nvcc, "-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
         "-O3", "-Xcompiler", "-fPIC", "-shared", *RENAME, str(SOURCE), "-o",
         str(LIB)], stdout=log, stderr=subprocess.STDOUT)
    return proc, LIB


def load(path=LIB) -> ctypes.CDLL:
    lib = ctypes.CDLL(str(path))
    lib.fedsikd_kd_first_fwd.argtypes = [_P] * 5 + [
        ctypes.c_longlong, ctypes.c_int, ctypes.c_int, ctypes.c_float,
        ctypes.c_float, _P]
    lib.fedsikd_kd_first_bwd.argtypes = [_P] * 6 + [
        ctypes.c_longlong, ctypes.c_int, ctypes.c_int, ctypes.c_float,
        ctypes.c_float, _P]
    lib.fedsikd_kd_first_fwd.restype = ctypes.c_int
    lib.fedsikd_kd_first_bwd.restype = ctypes.c_int
    return lib


def _code(s) -> int:
    import torch
    return {torch.float32: 0, torch.bfloat16: 1, torch.float16: 2}[s.dtype]


def _stream(s) -> int:
    import torch
    return torch.cuda.current_stream(s.device).cuda_stream


def fwd(lib, s, t, y, *, tau: float = 2.0, alpha: float = 0.5):
    import torch
    T, V = s.shape
    loss = torch.empty(T, dtype=torch.float32, device=s.device)
    stats = torch.empty((T, 3), dtype=torch.float32, device=s.device)
    err = lib.fedsikd_kd_first_fwd(
        s.data_ptr(), t.data_ptr(), y.data_ptr(), loss.data_ptr(),
        stats.data_ptr(), T, V, _code(s), tau, alpha, _stream(s))
    if err:
        raise RuntimeError(f"first-design KD forward: cudaError {err}")
    return loss, stats


def bwd(lib, s, t, y, stats, g, *, tau: float = 2.0, alpha: float = 0.5):
    import torch
    T, V = s.shape
    ds = torch.empty_like(s)
    err = lib.fedsikd_kd_first_bwd(
        s.data_ptr(), t.data_ptr(), y.data_ptr(), stats.data_ptr(),
        g.data_ptr(), ds.data_ptr(), T, V, _code(s), tau, alpha, _stream(s))
    if err:
        raise RuntimeError(f"first-design KD backward: cudaError {err}")
    return ds
