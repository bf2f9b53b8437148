"""Granite-34B-Code [arXiv:2405.04324]: deep MQA (kv=1, 48 query heads on
one KV head) code model, GPT-BigCode-style ungated GeLU MLP."""
from repro_torch.configs.base import ModelConfig

CONFIG = ModelConfig(
    name="granite-34b", arch_type="dense", source="arXiv:2405.04324",
    num_layers=88, d_model=6144, num_heads=48, num_kv_heads=1,
    d_ff=24576, vocab_size=49152,
    act="gelu", mlp_gated=False, tie_embeddings=True,
)
