"""H2O-Danube-1.8B [arXiv:2401.16818]: a Llama/Mistral-style decoder whose
every layer attends through a 4096-token sliding window (ring KV caches),
head dim 80."""
from repro_torch.configs.base import ModelConfig

CONFIG = ModelConfig(
    name="h2o-danube-1.8b", arch_type="dense", source="arXiv:2401.16818",
    num_layers=24, d_model=2560, num_heads=32, num_kv_heads=8,
    d_ff=6912, vocab_size=32000,
    sliding_window=4096, rope_theta=10_000.0, tie_embeddings=False,
)
