"""Model families of the port: the transformer family (dense and MoE),
the Zamba2 hybrid, the xLSTM and the Whisper encoder-decoder."""
from repro_torch.models.registry import get_model  # noqa: F401
