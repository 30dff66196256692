"""seamless-m4t-large-v2 — enc-dec multimodal (audio) backbone
[arXiv:2308.11596].  24 encoder + 24 decoder layers, d_model 1024, 16 heads
(kv=16), d_ff 8192, vocab 256206.  Audio frontend (mel + conv codec) is a
STUB: input_specs supplies frame embeddings (B, seq//frame_ratio, d)."""
import dataclasses

from repro_torch.configs.base import ModelConfig, register


def full() -> ModelConfig:
    return ModelConfig(
        name="seamless-m4t-large-v2", arch_type="audio", num_layers=24,
        num_encoder_layers=24, d_model=1024, num_heads=16, num_kv_heads=16,
        d_ff=8192, vocab_size=256206, activation="gelu", frame_ratio=4)


def smoke() -> ModelConfig:
    return dataclasses.replace(full(), num_layers=2, num_encoder_layers=2,
                               d_model=256, num_heads=4, num_kv_heads=4,
                               d_ff=512, vocab_size=512)


register("seamless-m4t-large-v2", full, smoke)
