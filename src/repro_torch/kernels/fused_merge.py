"""Fused grouped weighted-mean merge with staleness decay: the CUDA kernel's
wrapper and its plain PyTorch version.

Replaces the Pallas TPU kernel ``src/repro/kernels/fused_merge.py::_kernel``
(via ``fused_merge``); the CUDA source is ``csrc/fused_merge.cu``.

    out[d] = sum_n w_n (1+s_n)^-decay x[n, d] / sum_m w_m (1+s_m)^-decay

Bound on the H100: bytes (x read once, one multiply-add per element).  On
the main path each round merges the ten leaves of the MNIST student over
N = 40 clients, 3.06 MB in all: about 0.9 us at 3.35 TB/s, so the ten
launches cost far more than the bytes.  The first design is one thread per
column with the normalised weights staged in shared memory (see the ``.cu``
note); one launch for all leaves is later work.

Dispatch: a tensor on the CPU goes to the plain version; a CUDA tensor goes
to the kernel, or the wrapper raises.  ``fused_merge.launches`` counts
kernel launches.
"""
from __future__ import annotations

import torch

from repro_torch.kernels import _build


def fused_merge_plain(x, w, s, *, decay: float = 0.0):
    """(N, D), (N,), (N,) -> (D,) f32: the kernel's arithmetic, step by step."""
    wn = w.float() * (1.0 + s.float()) ** (-decay)
    wn = wn / wn.sum()
    return (wn[:, None] * x.float()).sum(0)


def fused_merge(x, w, s, *, decay: float = 0.0):
    """Decayed, renormalised weighted mean of the N rows of ``x`` (N, D):
    ``w`` and ``s`` are (N,) float32 base weights and staleness.  Returns
    (D,) float32."""
    if x.dim() != 2:
        raise ValueError(f"fused_merge: x must be (N, D), got {tuple(x.shape)}")
    N, D = x.shape
    if w.shape != (N,) or s.shape != (N,):
        raise ValueError(f"fused_merge: w {tuple(w.shape)} / s "
                         f"{tuple(s.shape)} must be ({N},)")
    if not (x.device == w.device == s.device):
        raise ValueError("fused_merge: tensors on different devices")
    if x.device.type == "cpu":
        return fused_merge_plain(x, w, s, decay=decay)
    if x.device.type != "cuda":
        raise ValueError(f"fused_merge: no kernel or plain path for {x.device}")
    if w.dtype != torch.float32 or s.dtype != torch.float32:
        raise TypeError("fused_merge: w and s must be float32")
    for name, t in (("x", x), ("w", w), ("s", s)):
        if not t.is_contiguous():
            raise ValueError(f"fused_merge: {name} must be contiguous")
    if N == 0 or D == 0:
        raise ValueError(f"fused_merge: empty stack {tuple(x.shape)}")
    code = _build.dtype_code(x, "fused_merge")
    out = torch.empty(D, dtype=torch.float32, device=x.device)
    lib = _build.library()
    with torch.cuda.device(x.device):
        err = lib.fedsikd_fused_merge(
            x.data_ptr(), w.data_ptr(), s.data_ptr(), out.data_ptr(), N, D,
            code, float(decay), _build.stream_handle(x))
    _build.check(err, "fused_merge")
    fused_merge.launches += 1
    return out


fused_merge.launches = 0
