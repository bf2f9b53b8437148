"""Gemma2-2B [arXiv:2408.00118]: alternating local (4096-token sliding
window) and global attention layers, logit softcap 30, attention softcap
50, head dim 256, a tanh-approximate GeLU in a gated MLP."""
from repro_torch.configs.base import ModelConfig

CONFIG = ModelConfig(
    name="gemma2-2b", arch_type="dense", source="arXiv:2408.00118",
    num_layers=26, d_model=2304, num_heads=8, num_kv_heads=4,
    d_ff=9216, vocab_size=256000, head_dim=256,
    attn_pattern=("local", "global"), sliding_window=4096,
    logit_softcap=30.0, attn_softcap=50.0,
    act="gelu", tie_embeddings=True,
)
