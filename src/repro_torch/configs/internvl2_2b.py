"""internvl2-2b — InternViT + InternLM2 VLM [arXiv:2404.16821].  Language
backbone: 24L, d_model 2048, 16 heads (GQA kv=8), d_ff 8192, vocab 92553.
The vision encoder is a stub: the batch supplies patch embeddings
(B, prefix_len, d), consumed as a prefix."""
import dataclasses

from repro_torch.configs.base import ModelConfig, register


def full() -> ModelConfig:
    return ModelConfig(
        name="internvl2-2b", arch_type="vlm", num_layers=24, d_model=2048,
        num_heads=16, num_kv_heads=8, d_ff=8192, vocab_size=92553,
        prefix_len=256)


def smoke() -> ModelConfig:
    return dataclasses.replace(full(), num_layers=2, d_model=256, num_heads=4,
                               num_kv_heads=2, d_ff=512, vocab_size=512,
                               prefix_len=8)


register("internvl2-2b", full, smoke)
