"""Mixtral-8x7B [arXiv:2401.04088]: the paper's own evaluation model —
32 layers, 8 experts per MoE layer, top-2 (Tarragon §7.1)."""
from repro_torch.configs.base import ModelConfig, MoEConfig

CONFIG = ModelConfig(
    name="mixtral-8x7b", arch_type="moe", source="arXiv:2401.04088",
    num_layers=32, d_model=4096, num_heads=32, num_kv_heads=8,
    d_ff=0, vocab_size=32000,
    rope_theta=1_000_000.0, tie_embeddings=False,
    moe=MoEConfig(num_experts=8, top_k=2, d_ff=14336),
)
