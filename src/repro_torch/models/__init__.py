"""Model families of the port (the transformer MoE family and the Zamba2
hybrid so far)."""
from repro_torch.models.registry import get_model  # noqa: F401
