#!/usr/bin/env python3
"""Where the decode flash-attention kernel's time goes, on one NVIDIA GPU.

    python3 tools/flash_decode_timeline.py

Without ``ncu`` or ``nsys`` on the card's machine, this builds a copy of
``src/repro_torch/kernels/csrc/flash_attention_decode.cu`` with
``%globaltimer`` stamps (thread 0 of every block: start, K of chunk 0
landed, its scores, softmax, V landed and P . V done, the chunk loop done,
the first ticket drawn, the set merge published, the end) and runs it once
at the served model's last decode step (bf16, B 2, H 16, KVH 2, S 4128,
hd 128, the wrapper's plan).  It prints, as JSON lines, the quantiles over
the blocks of each stamp from the kernel's first start, in microseconds;
then the device time of the production kernel at several span lengths
(``torch.profiler``) and that of SDPA on the same inputs.  It changes no
file of the repository; the instrumented library goes to
``build/flash_decode_timeline/`` (a path ``.gitignore`` lists).
"""
from __future__ import annotations

import ctypes
import json
import statistics
import subprocess
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT / "src"))
sys.path.insert(0, str(ROOT))

# thread 0 of each block writes its stamps, in this order
STAMPS = ("start", "K landed", "scores", "softmax", "V landed", "P.V",
          "loop done", "first ticket", "set published", "end")
# (marker in the source, code inserted after it)
PATCHES = [
    ("constexpr unsigned kFull = 0xffffffffu;\n",
     "__device__ unsigned long long g_stamps[8192 * 10];\n"
     "__device__ __forceinline__ unsigned long long gtime() {\n"
     "  unsigned long long t;\n"
     '  asm volatile("mov.u64 %0, %%globaltimer;" : "=l"(t));\n'
     "  return t;\n}\n"),
    ("    __syncthreads();                         // K of chunk c landed\n",
     "    if (c == 0) st[1] = gtime();\n"),
    ("    // per head: the chunk's max, its weights and the running (m, l)\n",
     "    if (c == 0) st[2] = gtime();\n"),
    ("    cp_async_wait<2 * kStages - 2>();\n",
     "    if (c == 0) st[3] = gtime();\n"),
    ("    __syncthreads();                         // V of chunk c landed, "
     "weights\n",
     "    if (c == 0) st[4] = gtime();\n"),
    ("    __syncthreads();                         // stage and scores "
     "consumed\n",
     "    if (c == 0) st[5] = gtime();\n"),
]


def instrumented_source() -> str:
    src = (ROOT / "src/repro_torch/kernels/csrc/"
           "flash_attention_decode.cu").read_text()

    def after(marker: str, code: str) -> None:
        nonlocal src
        if src.count(marker) != 1:
            raise RuntimeError(f"marker not found once: {marker!r}")
        src = src.replace(marker, marker + code)

    def before(marker: str, code: str) -> None:
        nonlocal src
        if src.count(marker) != 1:
            raise RuntimeError(f"marker not found once: {marker!r}")
        src = src.replace(marker, code + marker)

    for marker, code in PATCHES:
        after(marker, code)
    dump = ("if (tid == 0) { unsigned long long* d = g_stamps + "
            "((blockIdx.z * gridDim.y + blockIdx.y) * gridDim.x + "
            "blockIdx.x) * 10; for (int i = 0; i < 10; ++i) d[i] = st[i]; }")
    after("  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;\n",
          "  unsigned long long st[10] = {gtime(), 0, 0, 0, 0, 0, 0, 0, 0, "
          "0};\n")
    before("  // add the key groups' sums", "  st[6] = gtime();\n")
    old = ("  if (!publish(grp * a.n_span + span, m_s[sh], l_s[sh], "
           "set_ticket,\n               set_size))\n    return;")
    new = ("  const bool first_last = publish(grp * a.n_span + span, m_s[sh], "
           "l_s[sh], set_ticket, set_size);\n  st[7] = gtime();\n"
           f"  if (!first_last) {{ {dump} return; }}")
    if src.count(old) != 1:
        raise RuntimeError("first publish not found")
    src = src.replace(old, new)
    old = ("    if (!publish(groups * a.n_span + grp * n_set + set, M, L,\n"
           "                 a.tickets + grp, n_set))\n      return;")
    new = ("    const bool set_last = publish(groups * a.n_span + grp * n_set "
           "+ set, M, L, a.tickets + grp, n_set);\n    st[8] = gtime();\n"
           f"    if (!set_last) {{ {dump} return; }}")
    if src.count(old) != 1:
        raise RuntimeError("set publish not found")
    src = src.replace(old, new)
    tail = ("    store4(op, make_float4(o.x / d, o.y / d, o.z / d, o.w / d));\n"
            "  }\n}\n")
    i = src.rindex(tail)
    src = (src[:i] + tail[:-2] + f"  st[9] = gtime();\n  {dump}\n}}\n"
           + src[i + len(tail):])
    return src + ('\nextern "C" int fedsikd_read_stamps(void* dst) {\n'
                  "  return static_cast<int>(cudaMemcpyFromSymbol(dst, "
                  "g_stamps, sizeof(g_stamps)));\n}\n")


def build(src: str) -> ctypes.CDLL:
    from repro_torch.kernels import _build
    out = ROOT / "build" / "flash_decode_timeline"
    out.mkdir(parents=True, exist_ok=True)
    (out / "decode.cu").write_text(src)
    subprocess.run([_build._nvcc(), *_build.NVCC_FLAGS, "-I",
                    str(_build.CSRC), "-shared", str(out / "decode.cu"),
                    "-o", str(out / "libdecode.so")], check=True,
                   capture_output=True)
    lib = ctypes.CDLL(str(out / "libdecode.so"))
    fn = lib.fedsikd_flash_attention_decode
    fn.argtypes = list(_build.SIGNATURES["fedsikd_flash_attention_decode"])
    fn.restype = ctypes.c_int
    return lib


def launcher(fn, q, k, v, out, span_len=None):
    """A no-argument launch of ``fn`` (the decode C entry) on these
    inputs, with the wrapper's plan or spans of ``span_len`` keys."""
    import torch
    from repro_torch.kernels import _build
    from repro_torch.kernels import flash_attention as fa
    B, _, H, hd = q.shape
    S, KVH = k.shape[1], k.shape[2]
    p = fa.decode_plan(B, S, H, KVH)
    span = span_len or p["span_len"]
    n_span = -(-S // span)
    n = p["groups"] * (n_span + -(-n_span // fa.DECODE_FAN)) * p["heads"]
    part_acc = torch.empty(n * hd, device=q.device)
    part_ml = torch.empty(n * 2, device=q.device)
    tickets = torch.zeros(8192, dtype=torch.int32, device=q.device)
    stream = _build.stream_handle(q)

    def run():
        err = fn(q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(),
                 part_acc.data_ptr(), part_ml.data_ptr(), tickets.data_ptr(),
                 q.stride(0), q.stride(2), *k.stride()[:3], *v.stride()[:3],
                 out.stride(0), out.stride(2), B, S, H, KVH, hd, p["heads"],
                 p["n_gblk"], 0, n_span, span,
                 _build.dtype_code(q, "decode"), hd ** -0.5, stream)
        if err:
            raise RuntimeError(f"decode launch failed: cudaError {err}")
    return run, p["groups"] * n_span


def main() -> int:
    import torch
    import torch.nn.functional as F
    if not torch.cuda.is_available():
        print("flash_decode_timeline: needs a CUDA device", file=sys.stderr)
        return 2
    import chip_smoke as cs
    from repro_torch.kernels import _build
    from repro_torch.kernels import flash_attention as fa
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, check=True).stdout.strip()
    shape = cs.FA_DECODE[-1]
    q, k, v = cs._fa_inputs(shape, torch.bfloat16, 31)
    want = fa.flash_attention_plain(q, k, v)

    lib = build(instrumented_source())
    out = torch.empty_like(q)
    run, blocks = launcher(lib.fedsikd_flash_attention_decode, q, k, v, out)
    for _ in range(20):
        run()
    torch.cuda.synchronize()
    run()
    torch.cuda.synchronize()
    err = float((out.float() - want.float()).abs().max())
    buf = (ctypes.c_ulonglong * (8192 * 10))()
    if lib.fedsikd_read_stamps(buf) != 0:
        raise RuntimeError("could not read the stamps")
    rows = [list(buf[i * 10:(i + 1) * 10]) for i in range(blocks)]
    t0 = min(r[0] for r in rows)
    quant = {}
    for i, name in enumerate(STAMPS):
        xs = [(r[i] - t0) / 1e3 for r in rows if r[i]]
        if len(xs) >= 2:
            qs = statistics.quantiles(xs, n=20)
            quant[name] = {"blocks": len(xs), "p5": qs[0], "p50": qs[9],
                           "p95": qs[18], "max": max(xs)}
        elif xs:
            quant[name] = {"blocks": 1, "max": xs[0]}
    print(json.dumps({"timeline": f"(B,H,KVH,T,S,hd)={shape[:6]} bf16, "
                      f"{blocks} blocks", "card": smi,
                      "max_abs_err_vs_plain": err,
                      "us_from_first_start": quant}), flush=True)

    lib = _build.library()
    for span in (32, 64, 128, 256):
        run, blocks = launcher(lib.fedsikd_flash_attention_decode, q, k, v,
                               out, span)
        run()
        torch.cuda.synchronize()
        print(json.dumps({"span_len": span, "blocks": blocks,
                          "device_us": cs.device_us(run, ("fa_decode",),
                                                    calls=100),
                          "card": smi}), flush=True)
    qt, kt, vt = (x.transpose(1, 2).contiguous() for x in (q, k, v))
    sdpa = cs.device_us(lambda: F.scaled_dot_product_attention(
        qt, kt, vt, enable_gqa=True), ("",), calls=100)
    print(json.dumps({"sdpa_device_us": sdpa, "card": smi}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
