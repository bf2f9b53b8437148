"""Chameleon-34B [arXiv:2405.09818]: early-fusion mixed-modal decoder.
VQ image tokens live in the shared 65536 vocab, so the (stubbed) modality
frontend reduces to token ids; qk-norm per the paper, group size 8."""
from repro_torch.configs.base import ModelConfig

CONFIG = ModelConfig(
    name="chameleon-34b", arch_type="vlm", source="arXiv:2405.09818",
    num_layers=48, d_model=8192, num_heads=64, num_kv_heads=8,
    d_ff=22016, vocab_size=65536,
    qk_norm=True, tie_embeddings=False,
)
