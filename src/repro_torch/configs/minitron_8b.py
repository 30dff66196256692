"""minitron-8b — width/depth-pruned Nemotron-4 [arXiv:2407.14679].
32L, d_model 4096, 32 heads (GQA kv=8), d_ff 16384, vocab 256000,
squared-ReLU MLP (Nemotron family)."""
import dataclasses

from repro_torch.configs.base import ModelConfig, register


def full() -> ModelConfig:
    return ModelConfig(
        name="minitron-8b", arch_type="dense", num_layers=32, d_model=4096,
        num_heads=32, num_kv_heads=8, d_ff=16384, vocab_size=256000,
        activation="relu2")


def smoke() -> ModelConfig:
    return dataclasses.replace(full(), num_layers=2, d_model=256, num_heads=4,
                               num_kv_heads=2, d_ff=512, vocab_size=512)


register("minitron-8b", full, smoke)
