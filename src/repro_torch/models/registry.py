"""Model family dispatch: config -> ModelApi, in the reference's order:
the encoder-decoder (Whisper), the xLSTM, the hybrid (Zamba2), then the
decoder stack (dense and MoE)."""
from __future__ import annotations

from repro_torch.configs.base import ModelConfig
from repro_torch.models.transformer import ModelApi, build_decoder


def get_model(cfg: ModelConfig, *, num_aw: int = 1, num_ew: int = 1,
              tarragon: bool = True, device="cuda") -> ModelApi:
    """``tarragon`` False builds the MegaScale-Infer-style baseline: a
    static expert binding with no shadow slots."""
    kw = dict(num_aw=num_aw, num_ew=num_ew, tarragon=tarragon,
              device=device)
    if cfg.is_encdec:
        from repro_torch.models.whisper import build_encdec
        return build_encdec(cfg, **kw)
    if cfg.xlstm_pattern:
        from repro_torch.models.xlstm_model import build_xlstm
        return build_xlstm(cfg, **kw)
    if cfg.ssm.enabled and cfg.hybrid_attn_every:
        from repro_torch.models.hybrid import build_hybrid
        return build_hybrid(cfg, **kw)
    return build_decoder(cfg, **kw)
