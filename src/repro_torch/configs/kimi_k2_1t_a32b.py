"""Kimi K2 (1T total / 32B active) [arXiv:2501.kimi2]: 384 routed experts
top-8 + 1 shared, first layer dense, head dim 112 at group size 8 — the
paper-table trillion-param MoE and the headline case for shadow-expert
memory budgeting."""
from repro_torch.configs.base import ModelConfig, MoEConfig

CONFIG = ModelConfig(
    name="kimi-k2-1t-a32b", arch_type="moe", source="arXiv:2501.kimi2",
    num_layers=61, d_model=7168, num_heads=64, num_kv_heads=8,
    d_ff=2048, vocab_size=163840,
    rope_theta=50_000.0, tie_embeddings=False,
    moe=MoEConfig(num_experts=384, top_k=8, d_ff=2048,
                  num_shared_experts=1, shared_d_ff=2048,
                  first_k_dense=1),
)
