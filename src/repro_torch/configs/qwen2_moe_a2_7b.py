"""Qwen1.5-MoE-A2.7B [hf:Qwen/Qwen1.5-MoE-A2.7B]: 60 routed experts top-4
plus 4 shared experts (shared path hidden = 4x1408 = 5632), QKV bias, 16
query heads over 16 KV heads (group size 1)."""
from repro_torch.configs.base import ModelConfig, MoEConfig

CONFIG = ModelConfig(
    name="qwen2-moe-a2.7b", arch_type="moe",
    source="hf:Qwen/Qwen1.5-MoE-A2.7B",
    num_layers=24, d_model=2048, num_heads=16, num_kv_heads=16,
    d_ff=0, vocab_size=151936,
    qkv_bias=True, rope_theta=1_000_000.0, tie_embeddings=True,
    moe=MoEConfig(num_experts=60, top_k=4, d_ff=1408,
                  num_shared_experts=4, shared_d_ff=5632),
)
