"""Whisper-small [arXiv:2212.04356]: encoder-decoder; the mel and conv
frontend is a stub: a request carries 1500 precomputed frame embeddings."""
from repro_torch.configs.base import ModelConfig

CONFIG = ModelConfig(
    name="whisper-small", arch_type="audio", source="arXiv:2212.04356",
    num_layers=12, d_model=768, num_heads=12, num_kv_heads=12,
    d_ff=3072, vocab_size=51865,
    encoder_layers=12, encoder_seq=1500,
    act="gelu", mlp_gated=False, tie_embeddings=True,
)
