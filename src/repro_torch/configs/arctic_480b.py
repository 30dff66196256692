"""arctic-480b — dense-MoE hybrid: 128 experts top-2 routed MoE in parallel
with a dense residual MLP [hf:Snowflake/snowflake-arctic-base].
35L, d_model 7168, 56 heads (GQA kv=8, head_dim 128), expert d_ff 4864,
vocab 32000."""
import dataclasses

from repro_torch.configs.base import ModelConfig, register


def full() -> ModelConfig:
    return ModelConfig(
        name="arctic-480b", arch_type="moe", num_layers=35, d_model=7168,
        num_heads=56, num_kv_heads=8, d_ff=4864, vocab_size=32000,
        num_experts=128, num_experts_per_tok=2, moe_dense_residual=True,
        capacity_factor=1.25)


def smoke() -> ModelConfig:
    return dataclasses.replace(full(), num_layers=2, d_model=256, num_heads=4,
                               num_kv_heads=2, d_ff=128, vocab_size=512,
                               num_experts=4, num_experts_per_tok=2)


register("arctic-480b", full, smoke)
