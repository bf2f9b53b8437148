"""Zamba2-7B [arXiv:2411.15242]: a Mamba2 backbone with one shared
attention + MLP block applied after every 6 Mamba2 blocks (81 = 13 x 6
+ 3 trailing); the shared block's weights are reused by every
occurrence, each of which keeps its own KV cache."""
from repro_torch.configs.base import ModelConfig, SSMConfig

CONFIG = ModelConfig(
    name="zamba2-7b", arch_type="hybrid", source="arXiv:2411.15242",
    num_layers=81, d_model=3584, num_heads=32, num_kv_heads=32,
    d_ff=14336, vocab_size=32000,
    hybrid_attn_every=6, tie_embeddings=True,
    ssm=SSMConfig(state_dim=64, head_dim=64, expand=2, conv_width=4,
                  chunk=64),
)
