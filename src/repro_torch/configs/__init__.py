"""Architecture config registry: ``get_config(<id>)`` resolution.

Every architecture of the reference's registry: the paper's own model,
the hybrid, the whole transformer family (dense, sliding-window and
softcap, MoE with shared experts and a dense first layer, qk-norm, MQA),
the xLSTM and the encoder-decoder (Whisper).
"""
from __future__ import annotations

import importlib

from repro_torch.configs.base import (LONG_CONTEXT_ARCHS, SHAPES,  # noqa
                                      ModelConfig, MoEConfig, ShapeConfig,
                                      supports_shape)

ARCH_IDS = (
    "mixtral_8x7b",   # the paper's own evaluation model
    "zamba2_7b",      # Mamba2 blocks + a shared attention block
    "gemma2_2b",      # local/global layers, softcaps, head dim 256
    "h2o_danube_1_8b",  # a sliding window in every layer, head dim 80
    "qwen2_1_5b",     # QKV bias, group size 6
    "qwen2_moe_a2_7b",  # 60 experts top-4, 4 shared experts, QKV bias, G 1
    "kimi_k2_1t_a32b",  # 384 experts top-8, a shared expert, dense layer 0
    "chameleon_34b",  # qk-norm, group size 8
    "granite_34b",    # MQA (48 query heads on one KV head), ungated GeLU
    "xlstm_350m",     # mLSTM/sLSTM pairs, recurrent state only
    "whisper_small",  # encoder-decoder: 1500 frames, cross attention
)


def _module_for(name: str) -> str:
    return name.replace("-", "_").replace(".", "_")


def get_config(name: str) -> ModelConfig:
    mod_name = _module_for(name)
    if mod_name not in ARCH_IDS:
        raise KeyError(f"unknown or not yet ported architecture {name!r}; "
                       f"ported: {ARCH_IDS}")
    return importlib.import_module(f"repro_torch.configs.{mod_name}").CONFIG


#: the ten assigned architectures, in the reference registry's order (the
#: order its dry run sweeps); the paper's own model comes after them
ASSIGNED_ARCHS = ("qwen2_1_5b", "qwen2_moe_a2_7b", "h2o_danube_1_8b",
                  "zamba2_7b", "chameleon_34b", "whisper_small", "xlstm_350m",
                  "gemma2_2b", "granite_34b", "kimi_k2_1t_a32b")


def all_configs(include_paper_model: bool = True):
    """name -> config of every assigned architecture, then Mixtral-8x7B
    unless ``include_paper_model`` is False."""
    ids = ASSIGNED_ARCHS + (("mixtral_8x7b",) if include_paper_model else ())
    return {cfg.name: cfg for cfg in map(get_config, ids)}
