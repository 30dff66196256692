"""glm4-9b — dense GQA decoder [hf:THUDM/glm-4-9b].
40L, d_model 4096, 32 heads (GQA kv=2), d_ff 13696, vocab 151552, RoPE."""
import dataclasses

from repro_torch.configs.base import ModelConfig, register


def full() -> ModelConfig:
    return ModelConfig(
        name="glm4-9b", arch_type="dense", num_layers=40, d_model=4096,
        num_heads=32, num_kv_heads=2, d_ff=13696, vocab_size=151552,
        activation="silu", rope_theta=1e4)


def smoke() -> ModelConfig:
    return dataclasses.replace(full(), num_layers=2, d_model=256, num_heads=4,
                               num_kv_heads=2, d_ff=512, vocab_size=512)


register("glm4-9b", full, smoke)
