"""Qwen2-1.5B [arXiv:2407.10671]: a dense GQA decoder with QKV bias, 12
query heads over 2 KV heads (group size 6), full attention."""
from repro_torch.configs.base import ModelConfig

CONFIG = ModelConfig(
    name="qwen2-1.5b", arch_type="dense", source="arXiv:2407.10671",
    num_layers=28, d_model=1536, num_heads=12, num_kv_heads=2,
    d_ff=8960, vocab_size=151936,
    qkv_bias=True, rope_theta=1_000_000.0, tie_embeddings=True,
)
