"""deepseek-v2-236b — MoE with multi-head latent attention
[arXiv:2405.04434].  60L, d_model 5120, 128 heads, MLA kv_lora_rank=512
(q_lora 1536, qk_nope 128, qk_rope 64, v 128); MoE: 160 routed experts top-6
+ 2 shared, expert d_ff 1536, vocab 102400.  Its attention is MLA in plain
torch (q/k head dim 192, v 128), so serving it launches no flash kernel."""
import dataclasses

from repro_torch.configs.base import ModelConfig, register


def full() -> ModelConfig:
    return ModelConfig(
        name="deepseek-v2-236b", arch_type="moe", num_layers=60, d_model=5120,
        num_heads=128, num_kv_heads=128, d_ff=1536, vocab_size=102400,
        num_experts=160, num_experts_per_tok=6, num_shared_experts=2,
        use_mla=True, kv_lora_rank=512, q_lora_rank=1536,
        qk_nope_dim=128, qk_rope_dim=64, v_head_dim=128,
        capacity_factor=1.25)


def smoke() -> ModelConfig:
    return dataclasses.replace(
        full(), num_layers=2, d_model=256, num_heads=4, num_kv_heads=4,
        d_ff=128, vocab_size=512, num_experts=4, num_experts_per_tok=2,
        num_shared_experts=1, kv_lora_rank=32, q_lora_rank=48,
        qk_nope_dim=32, qk_rope_dim=16, v_head_dim=32)


register("deepseek-v2-236b", full, smoke)
