"""nemotron-4-340b — giant dense GQA with squared-ReLU MLP
[arXiv:2402.16819].  96L, d_model 18432, 96 heads (GQA kv=8, head_dim 192),
d_ff 73728, vocab 256000.  The flash kernels take head dims 32, 64 and 128,
so on the card this model waits for ROADMAP Queue 2 item 5; its smoke
config (head_dim 96) runs on the CPU's plain attention."""
import dataclasses

from repro_torch.configs.base import ModelConfig, register


def full() -> ModelConfig:
    return ModelConfig(
        name="nemotron-4-340b", arch_type="dense", num_layers=96,
        d_model=18432, num_heads=96, num_kv_heads=8, d_ff=73728,
        vocab_size=256000, head_dim=192, activation="relu2")


def smoke() -> ModelConfig:
    return dataclasses.replace(full(), num_layers=2, d_model=384, num_heads=4,
                               num_kv_heads=2, head_dim=96, d_ff=512,
                               vocab_size=512)


register("nemotron-4-340b", full, smoke)
