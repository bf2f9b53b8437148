"""Model family dispatch: config -> ModelApi (the whole transformer
family, dense and MoE, and the Zamba2 hybrid; the encoder-decoder, xLSTM
and pure-SSM families raise until they are ported)."""
from __future__ import annotations

from repro_torch.configs.base import ModelConfig
from repro_torch.models.transformer import ModelApi, build_decoder


def get_model(cfg: ModelConfig, *, num_aw: int = 1, num_ew: int = 1,
              tarragon: bool = True, device="cuda") -> ModelApi:
    """``tarragon`` False builds the MegaScale-Infer-style baseline: a
    static expert binding with no shadow slots."""
    kw = dict(num_aw=num_aw, num_ew=num_ew, tarragon=tarragon,
              device=device)
    if cfg.ssm.enabled and cfg.hybrid_attn_every:
        from repro_torch.models.hybrid import build_hybrid
        return build_hybrid(cfg, **kw)
    if cfg.is_encdec or cfg.xlstm_pattern or cfg.ssm.enabled:
        raise NotImplementedError(
            f"{cfg.name}: the encoder-decoder, xLSTM and pure-SSM "
            f"families are not ported yet")
    return build_decoder(cfg, **kw)
