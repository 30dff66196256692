"""zamba2-1.2b — hybrid Mamba2 backbone + SHARED attention block
[arXiv:2411.15242].  38 Mamba2 layers (ssm_state 64), d_model 2048,
shared 32-head attention block applied every 19 layers (2 applications;
model-card pattern adapted to the group-scan divisibility constraint, see
DESIGN.md), d_ff 8192, vocab 32000.  Shared attention uses a 4096 sliding
window -> long_500k decode runs with O(window) cache."""
import dataclasses

from repro_torch.configs.base import ModelConfig, register


def full() -> ModelConfig:
    return ModelConfig(
        name="zamba2-1.2b", arch_type="hybrid", num_layers=38, d_model=2048,
        num_heads=32, num_kv_heads=32, d_ff=8192, vocab_size=32000,
        ssm_state=64, ssm_expand=2, attn_every=19, sliding_window=4096)


def smoke() -> ModelConfig:
    return dataclasses.replace(full(), num_layers=2, d_model=256, num_heads=4,
                               num_kv_heads=4, d_ff=512, vocab_size=512,
                               attn_every=1, sliding_window=64)


register("zamba2-1.2b", full, smoke)
