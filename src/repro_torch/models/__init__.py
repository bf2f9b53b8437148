"""Model families of the port (transformer MoE so far)."""
from repro_torch.models.registry import get_model  # noqa: F401
