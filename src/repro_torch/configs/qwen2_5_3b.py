"""qwen2.5-3b — dense GQA with QKV bias, tied embeddings
[hf:Qwen/Qwen2.5-0.5B family card].  36L, d_model 2048, 16 heads (kv=2),
d_ff 11008, vocab 151936, head_dim 128."""
import dataclasses

from repro_torch.configs.base import ModelConfig, register


def full() -> ModelConfig:
    return ModelConfig(
        name="qwen2.5-3b", arch_type="dense", num_layers=36, d_model=2048,
        num_heads=16, num_kv_heads=2, d_ff=11008, vocab_size=151936,
        head_dim=128, qkv_bias=True, tie_embeddings=True, rope_theta=1e6)


def smoke() -> ModelConfig:
    return dataclasses.replace(full(), num_layers=2, d_model=256, num_heads=4,
                               num_kv_heads=2, head_dim=64, d_ff=512,
                               vocab_size=512)


register("qwen2.5-3b", full, smoke)
