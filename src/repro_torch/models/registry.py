"""Model family dispatch: config -> ModelApi (transformer family only so
far; the other families raise until they are ported)."""
from __future__ import annotations

from repro_torch.configs.base import ModelConfig
from repro_torch.models.transformer import ModelApi, build_decoder


def get_model(cfg: ModelConfig, *, num_aw: int = 1, num_ew: int = 1,
              device="cuda") -> ModelApi:
    if cfg.is_encdec or cfg.xlstm_pattern or cfg.ssm.enabled:
        raise NotImplementedError(
            f"{cfg.name}: only the transformer family is ported so far")
    return build_decoder(cfg, num_aw=num_aw, num_ew=num_ew, device=device)
