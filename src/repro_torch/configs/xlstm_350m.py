"""xLSTM-350m [arXiv:2405.04517]: alternating mLSTM/sLSTM blocks,
constant-size recurrent state (d_ff=0: no separate FFN blocks)."""
from repro_torch.configs.base import ModelConfig

CONFIG = ModelConfig(
    name="xlstm-350m", arch_type="ssm", source="arXiv:2405.04517",
    num_layers=24, d_model=1024, num_heads=4, num_kv_heads=4,
    d_ff=0, vocab_size=50304,
    xlstm_pattern=("mlstm", "slstm"), tie_embeddings=True,
)
