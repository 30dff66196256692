"""Architecture config schema and registry: the port's copy of
``repro.configs.base``.

``ModelConfig`` keeps every field, ``hd``, ``as_student`` and
``param_count`` of the JAX package's, so a configuration means the same in
both.  Every architecture of ``ARCH_IDS`` is registered, each with its
full-size and reduced ``smoke`` variant: the dense decoders and the
VLM-prefix one (``qwen2.5-3b``, ``glm4-9b``, ``minitron-8b``,
``internvl2-2b``, ``nemotron-4-340b``), the mixture-of-experts ones
(``deepseek-v2-236b`` with multi-head latent attention, ``arctic-480b``),
RWKV6 (``rwkv6-3b``), the Mamba2 hybrid (``zamba2-1.2b``) and the audio
encoder-decoder (``seamless-m4t-large-v2``).  ``get_config`` on an unknown
id raises ``KeyError``.
"""
from __future__ import annotations

import dataclasses
import importlib
from typing import Callable

ARCH_IDS = [
    "glm4-9b",
    "rwkv6-3b",
    "minitron-8b",
    "qwen2.5-3b",
    "seamless-m4t-large-v2",
    "internvl2-2b",
    "deepseek-v2-236b",
    "zamba2-1.2b",
    "arctic-480b",
    "nemotron-4-340b",
]

INPUT_SHAPES = {
    "train_4k": dict(seq_len=4096, global_batch=256, kind="train"),
    "prefill_32k": dict(seq_len=32768, global_batch=32, kind="prefill"),
    "decode_32k": dict(seq_len=32768, global_batch=128, kind="decode"),
    "long_500k": dict(seq_len=524288, global_batch=1, kind="decode"),
}


@dataclasses.dataclass(frozen=True)
class ModelConfig:
    name: str
    arch_type: str                 # dense | moe | ssm | hybrid | encdec | vlm | audio
    num_layers: int
    d_model: int
    num_heads: int
    num_kv_heads: int
    d_ff: int
    vocab_size: int
    head_dim: int = 0              # 0 -> d_model // num_heads
    activation: str = "silu"       # silu(SwiGLU) | gelu | relu2 (squared ReLU)
    qkv_bias: bool = False
    rope_theta: float = 1e4
    rms_eps: float = 1e-5
    tie_embeddings: bool = False
    # --- MoE ---
    num_experts: int = 0
    num_experts_per_tok: int = 0
    num_shared_experts: int = 0    # deepseek-style always-on experts
    moe_dense_residual: bool = False   # arctic-style parallel dense FFN
    capacity_factor: float = 1.25
    router_aux_coef: float = 0.01
    moe_dispatch: str = "sort"     # sort (O(kN) ranking) | cumsum (GShard
                                   # one-hot baseline; §Perf before-state)
    # >1: group-local dispatch aligned with the dp shards (hillclimb A) —
    # scatter/gather stay shard-local, cross-shard movement becomes ONE
    # buffer all-to-all.  Set by the launcher to the dp axis size.
    moe_groups: int = 1
    # --- MLA (deepseek) ---
    use_mla: bool = False
    kv_lora_rank: int = 0
    q_lora_rank: int = 0
    qk_rope_dim: int = 64
    qk_nope_dim: int = 128
    v_head_dim: int = 128
    # --- SSM / hybrid ---
    ssm_state: int = 0
    ssm_heads: int = 0
    ssm_expand: int = 2
    conv_kernel: int = 4
    attn_every: int = 0            # hybrid: shared attn block every N ssm layers
    # --- attention variants ---
    sliding_window: int = 0        # 0 = full attention
    # blocked flash-style attention kicks in when T >= 2*attn_block
    # (0 disables; hillclimb A take-3 — avoids (T,S) score materialisation)
    attn_block: int = 1024
    # --- enc-dec / multimodal ---
    num_encoder_layers: int = 0
    prefix_len: int = 0            # precomputed patch/frame embeddings (stub frontend)
    frame_ratio: int = 0           # audio: encoder frames = seq_len // frame_ratio
    # --- numerics / training ---
    dtype: str = "bfloat16"
    remat: bool = True
    # analysis probes: unroll layer scans so compiled cost_analysis counts
    # every layer (XLA counts while-loop bodies ONCE; see launch/roofline.py)
    unroll: bool = False
    # KD student derivation: student keeps every k-th layer
    student_layer_keep: float = 0.5

    @property
    def hd(self) -> int:
        return self.head_dim or (self.d_model // self.num_heads)

    def as_student(self) -> "ModelConfig":
        """Depth-pruned student for FedSiKD KD (paper's students have fewer
        layers than teachers, same IO interface)."""
        n = max(1, int(round(self.num_layers * self.student_layer_keep)))
        enc = max(1, int(round(self.num_encoder_layers * self.student_layer_keep))) \
            if self.num_encoder_layers else 0
        return dataclasses.replace(self, num_layers=n, num_encoder_layers=enc,
                                   name=self.name + "-student")

    def param_count(self) -> int:
        """Analytic parameter count (used for 6ND model-FLOPs in roofline)."""
        d, L, V = self.d_model, self.num_layers, self.vocab_size
        hd = self.hd
        if self.use_mla:
            q = d * self.q_lora_rank + self.q_lora_rank * self.num_heads * (
                self.qk_nope_dim + self.qk_rope_dim)
            kv = d * (self.kv_lora_rank + self.qk_rope_dim) + self.kv_lora_rank * (
                self.num_heads * (self.qk_nope_dim + self.v_head_dim))
            o = self.num_heads * self.v_head_dim * d
            attn = q + kv + o
        else:
            attn = d * self.num_heads * hd + 2 * d * self.num_kv_heads * hd \
                + self.num_heads * hd * d
        ff_in = 2 if self.activation == "silu" else 1
        dense_ff = (ff_in + 1) * d * self.d_ff
        if self.num_experts:
            moe_ff = self.num_experts * (ff_in + 1) * d * self.d_ff \
                + self.num_shared_experts * (ff_in + 1) * d * self.d_ff \
                + d * self.num_experts
            if self.moe_dense_residual:
                moe_ff += dense_ff
            per_layer = attn + moe_ff
        elif self.arch_type == "ssm":
            # rwkv6: time-mix 5 d^2 (+ small loras) + channel-mix 2 d*ff + d^2
            per_layer = 6 * d * d + 2 * d * self.d_ff
        elif self.arch_type == "hybrid":
            # zamba2: mamba layers only; the SHARED attn block counts once
            din = self.ssm_expand * d
            state = self.ssm_state
            per_layer = (d * (2 * din + 2 * state + max(din // 64, 1))
                         + din * d + (din + 2 * state) * self.conv_kernel)
        else:
            per_layer = attn + dense_ff
        total = L * per_layer + V * d * (1 if self.tie_embeddings else 2)
        if self.arch_type == "hybrid":
            total += attn + dense_ff          # one shared attn+MLP block
        if self.num_encoder_layers:
            total += self.num_encoder_layers * (attn + dense_ff)
        return int(total)

    def active_param_count(self) -> int:
        """Active params per token (MoE: top-k + shared only) for 6*N_active*D."""
        if not self.num_experts:
            return self.param_count()
        d, L = self.d_model, self.num_layers
        ff_in = 2 if self.activation == "silu" else 1
        expert = (ff_in + 1) * d * self.d_ff
        inactive = (self.num_experts - self.num_experts_per_tok) * expert
        return int(self.param_count() - L * inactive)


_REGISTRY: dict[str, Callable[[], ModelConfig]] = {}
_SMOKE: dict[str, Callable[[], ModelConfig]] = {}

# the architectures whose models the port runs: every one of ARCH_IDS
# (dense GQA decoders, the VLM with a stub prefix, the MoE decoders, one of
# them with MLA, RWKV6, the Mamba2 hybrid and the audio encoder-decoder)
PORTED = ("qwen2.5-3b", "glm4-9b", "minitron-8b", "internvl2-2b",
          "nemotron-4-340b", "deepseek-v2-236b", "arctic-480b", "rwkv6-3b",
          "zamba2-1.2b", "seamless-m4t-large-v2")


def register(arch_id: str, full: Callable[[], ModelConfig],
             smoke: Callable[[], ModelConfig]) -> None:
    _REGISTRY[arch_id] = full
    _SMOKE[arch_id] = smoke


def _ensure_loaded(arch_id: str) -> None:
    if arch_id not in ARCH_IDS:
        raise KeyError(f"unknown architecture {arch_id!r} (known: {ARCH_IDS})")
    if arch_id not in _REGISTRY:
        mod = arch_id.replace("-", "_").replace(".", "_")
        importlib.import_module(f"repro_torch.configs.{mod}")


def get_config(arch_id: str, *, smoke: bool = False) -> ModelConfig:
    _ensure_loaded(arch_id)
    return (_SMOKE if smoke else _REGISTRY)[arch_id]()


def list_archs() -> list[str]:
    return list(ARCH_IDS)
