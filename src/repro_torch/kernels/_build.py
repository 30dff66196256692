"""Build and load the port's hand-written CUDA kernels.

Every ``csrc/*.cu`` source is compiled by ``nvcc`` for ``sm_90a`` (one
``nvcc -c`` per source, all started together) and linked into one shared
library with a plain C interface, ``build/repro_torch/libfedsikd_kernels.so``
at the repository root (a path ``.gitignore`` lists).  The library is
rebuilt whenever the hash of the sources and flags changes, and is loaded
with ``ctypes``.  Nothing here runs at import: the first kernel launch
builds (or reuses) the library.  A build failure raises; no wrapper ever
falls back to its plain version for a CUDA tensor.
"""
from __future__ import annotations

import ctypes
import functools
import hashlib
import os
import shutil
import subprocess
import tempfile
import time
from pathlib import Path

import torch

CSRC = Path(__file__).resolve().parent / "csrc"
REPO_ROOT = Path(__file__).resolve().parents[3]
BUILD_DIR = REPO_ROOT / "build" / "repro_torch"
LIB_NAME = "libfedsikd_kernels.so"
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
              "-Xcompiler", "-fPIC", "-Xptxas=-v")

# dtype codes of csrc/common.cuh
DTYPE_CODES = {torch.float32: 0, torch.bfloat16: 1, torch.float16: 2}

_P = ctypes.c_void_p
# C signature of every exported function: (argtypes), restype is int
SIGNATURES = {
    # s, t, y, loss, stats; rows, V, dtype; tau, alpha, log2(e)/tau, 1/tau;
    # regime, tile rows, lanes, vec; stream
    "fedsikd_kd_fwd": (_P,) * 5 + (ctypes.c_longlong, ctypes.c_int,
                                   ctypes.c_int) + (ctypes.c_float,) * 4
    + (ctypes.c_int,) * 4 + (_P,),
    # s, t, y, stats, g, ds; rows, V, dtype; tau, alpha, log2(e)/tau;
    # regime, tile rows, vec; stream
    "fedsikd_kd_bwd": (_P,) * 6 + (ctypes.c_longlong, ctypes.c_int,
                                   ctypes.c_int) + (ctypes.c_float,) * 3
    + (ctypes.c_int,) * 3 + (_P,),
    # row-pointer table, tile table, w, s, out; N, n_tiles, dtype; decay;
    # stream
    "fedsikd_fused_merge": (_P,) * 5 + (ctypes.c_int,) * 3
    + (ctypes.c_float, _P),
    # x, cents, assign, dist; N; F, K, regime, grid, slice_len, vec; stream
    "fedsikd_kmeans_assign": (_P,) * 4 + (ctypes.c_longlong,)
    + (ctypes.c_int,) * 6 + (_P,),
    # q, k, v, out, part_acc, part_ml; (batch, seq, head) strides of q, k,
    # v, out; B, T, S, H, KVH, hd, causal, window; scale; n_split,
    # split_len, dtype; stream
    "fedsikd_flash_attention": (_P,) * 6 + (ctypes.c_longlong,) * 12
    + (ctypes.c_int,) * 8 + (ctypes.c_float,) + (ctypes.c_int,) * 3 + (_P,),
    # q, k, v, out; (batch, seq, head) strides of q, k, v, out; B, T, S, H,
    # KVH, hd, causal, window; scale; stream
    "fedsikd_flash_attention_tc": (_P,) * 4 + (ctypes.c_longlong,) * 12
    + (ctypes.c_int,) * 8 + (ctypes.c_float,) + (_P,),
    # q, k, v, out, part_acc, part_ml, tickets; q's batch and head strides,
    # k's and v's (batch, seq, head) strides, out's batch and head strides;
    # B, S, H, KVH, hd, heads a block, n_gblk, lo, n_span, span_len, dtype;
    # scale; stream
    "fedsikd_flash_attention_decode": (_P,) * 7 + (ctypes.c_longlong,) * 10
    + (ctypes.c_int,) * 11 + (ctypes.c_float,) + (_P,),
}


def _sources() -> list[Path]:
    return sorted(CSRC.glob("*.cu"))


def _source_hash() -> str:
    h = hashlib.sha256(" ".join(NVCC_FLAGS).encode())
    for p in sorted(CSRC.glob("*.cu*")):
        h.update(p.name.encode())
        h.update(p.read_bytes())
    return h.hexdigest()


def _nvcc() -> str:
    for cand in (os.environ.get("CUDA_HOME"), "/usr/local/cuda"):
        if cand and (Path(cand) / "bin" / "nvcc").exists():
            return str(Path(cand) / "bin" / "nvcc")
    found = shutil.which("nvcc")
    if found is None:
        raise RuntimeError(
            "nvcc not found (looked in $CUDA_HOME/bin, /usr/local/cuda/bin and "
            "PATH): the port's CUDA kernels cannot be built")
    return found


def _run_all(cmds: list[list[str]]) -> str:
    """Run the commands in parallel; raise with their output if any fails."""
    procs = [subprocess.Popen(c, stdout=subprocess.PIPE,
                              stderr=subprocess.STDOUT, text=True)
             for c in cmds]
    logs, failed = [], []
    for cmd, proc in zip(cmds, procs):
        out, _ = proc.communicate()
        logs.append(f"$ {' '.join(cmd)}\n{out}")
        if proc.returncode != 0:
            failed.append(f"$ {' '.join(cmd)}\n{out}")
    if failed:
        raise RuntimeError("CUDA kernel build failed:\n" + "\n".join(failed))
    return "\n".join(logs)


def build(force: bool = False) -> dict:
    """Compile the library if it is missing or stale.  Returns
    ``{"path", "built", "seconds", "log"}`` (``log`` holds nvcc's output,
    ``-Xptxas -v`` register and shared-memory counts included)."""
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    lib = BUILD_DIR / LIB_NAME
    stamp = BUILD_DIR / (LIB_NAME + ".sha256")
    log_path = BUILD_DIR / "build.log"
    digest = _source_hash()
    if (not force and lib.exists() and stamp.exists()
            and stamp.read_text().strip() == digest):
        return {"path": str(lib), "built": False, "seconds": 0.0,
                "log": log_path.read_text() if log_path.exists() else ""}
    t0 = time.perf_counter()
    nvcc = _nvcc()
    with tempfile.TemporaryDirectory(dir=BUILD_DIR) as tmp:
        objs = [Path(tmp) / (src.stem + ".o") for src in _sources()]
        log = _run_all([[nvcc, *NVCC_FLAGS, "-I", str(CSRC), "-c", str(src),
                         "-o", str(obj)]
                        for src, obj in zip(_sources(), objs)])
        tmp_lib = Path(tmp) / LIB_NAME
        log += "\n" + _run_all([[nvcc, *NVCC_FLAGS, "-shared",
                                 *map(str, objs), "-o", str(tmp_lib)]])
        os.replace(tmp_lib, lib)
    stamp.write_text(digest + "\n")
    log_path.write_text(log)
    return {"path": str(lib), "built": True,
            "seconds": time.perf_counter() - t0, "log": log}


@functools.cache
def library() -> ctypes.CDLL:
    """The built library with every exported function's C signature set."""
    lib = ctypes.CDLL(build()["path"])
    for name, argtypes in SIGNATURES.items():
        fn = getattr(lib, name)
        fn.argtypes = list(argtypes)
        fn.restype = ctypes.c_int
    return lib


def check(err: int, what: str) -> None:
    """Raise if a launch reported a CUDA error (``cudaGetLastError``)."""
    if err != 0:
        raise RuntimeError(f"{what}: CUDA launch failed with cudaError {err}")


def stream_handle(t: torch.Tensor) -> int:
    """The current CUDA stream of ``t``'s device, as an integer handle."""
    return torch.cuda.current_stream(t.device).cuda_stream


def dtype_code(t: torch.Tensor, what: str) -> int:
    code = DTYPE_CODES.get(t.dtype)
    if code is None:
        raise TypeError(f"{what}: unsupported dtype {t.dtype} "
                        f"(kernel takes {sorted(map(str, DTYPE_CODES))})")
    return code
