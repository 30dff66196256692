"""rwkv6-3b "Finch" — attention-free SSM with data-dependent decay
[arXiv:2404.05892].  32L, d_model 2560, d_ff 8960, vocab 65536; head_dim 64."""
import dataclasses

from repro_torch.configs.base import ModelConfig, register


def full() -> ModelConfig:
    return ModelConfig(
        name="rwkv6-3b", arch_type="ssm", num_layers=32, d_model=2560,
        num_heads=40, num_kv_heads=40, d_ff=8960, vocab_size=65536,
        head_dim=64, activation="relu2")


def smoke() -> ModelConfig:
    return dataclasses.replace(full(), num_layers=2, d_model=256, num_heads=4,
                               num_kv_heads=4, head_dim=64, d_ff=512,
                               vocab_size=512)


register("rwkv6-3b", full, smoke)
