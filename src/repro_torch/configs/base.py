"""Config schema for models, input shapes and Tarragon resilience knobs
(PyTorch port).

Mirrors ``repro.configs.base``: a model is a ``ModelConfig``, an input
shape a ``ShapeConfig``; ``reduced()`` produces the CPU-smoke variant of
the same family (<=2 layers, d_model<=128, 4 experts). The compute dtype
is exposed as a torch dtype.
"""
from __future__ import annotations

import dataclasses
from dataclasses import dataclass, field
from typing import Tuple

import torch


@dataclass(frozen=True)
class MoEConfig:
    """Sparse-expert layer configuration (Tarragon's EW side)."""

    num_experts: int = 0            # routed (logical) experts
    top_k: int = 0
    d_ff: int = 0                   # per-expert FFN hidden dim
    num_shared_experts: int = 0     # always-on shared experts
    shared_d_ff: int = 0            # total hidden dim of the shared path
    capacity_factor: float = 1.25
    first_k_dense: int = 0          # leading layers that use a dense FFN
    router_aux_coef: float = 0.01   # load-balance loss coefficient
    # Tarragon: number of shadow slots (replica capacity beyond primaries);
    # -1 means "one EW-shard's worth" chosen at build time.
    num_shadow_slots: int = -1

    @property
    def enabled(self) -> bool:
        return self.num_experts > 0


@dataclass(frozen=True)
class SSMConfig:
    """Mamba2-style selective state-space block configuration (the hybrid
    family: Zamba2)."""

    state_dim: int = 0
    head_dim: int = 64
    expand: int = 2
    conv_width: int = 4
    chunk: int = 64

    @property
    def enabled(self) -> bool:
        return self.state_dim > 0


_DTYPES = {"float32": torch.float32, "bfloat16": torch.bfloat16,
           "float16": torch.float16}


@dataclass(frozen=True)
class ModelConfig:
    name: str
    arch_type: str                  # dense|moe|hybrid|vlm|audio|ssm
    num_layers: int
    d_model: int
    num_heads: int
    num_kv_heads: int
    d_ff: int
    vocab_size: int
    head_dim: int = 0               # 0 -> d_model // num_heads
    source: str = ""                # citation (paper / model card)

    # --- attention options -------------------------------------------------
    qkv_bias: bool = False
    rope_theta: float = 10000.0
    sliding_window: int = 0         # 0 = full attention
    attn_pattern: Tuple[str, ...] = ("layer",)
    logit_softcap: float = 0.0
    attn_softcap: float = 0.0
    qk_norm: bool = False

    # --- FFN ---------------------------------------------------------------
    act: str = "silu"               # silu | gelu
    mlp_gated: bool = True

    # --- MoE / SSM ---------------------------------------------------------
    moe: MoEConfig = field(default_factory=MoEConfig)
    ssm: SSMConfig = field(default_factory=SSMConfig)
    hybrid_attn_every: int = 0
    xlstm_pattern: Tuple[str, ...] = ()
    encoder_layers: int = 0
    encoder_seq: int = 0

    # --- embeddings / norm ---------------------------------------------------
    tie_embeddings: bool = True
    norm_eps: float = 1e-6
    dtype: str = "float32"          # compute dtype
    remat: bool = False

    # ------------------------------------------------------------------------
    @property
    def head_dim_(self) -> int:
        return self.head_dim or self.d_model // self.num_heads

    @property
    def torch_dtype(self) -> torch.dtype:
        return _DTYPES[self.dtype]

    @property
    def is_encdec(self) -> bool:
        return self.encoder_layers > 0

    @property
    def param_count(self) -> int:
        """Approximate parameter count (embeddings + blocks), as the
        reference counts it."""
        d = self.d_model
        n = self.vocab_size * d * (1 if self.tie_embeddings else 2)
        hd = self.head_dim_
        attn = d * hd * (self.num_heads + 2 * self.num_kv_heads) + \
            self.num_heads * hd * d
        if self.moe.enabled:
            ffn_moe = 3 * d * self.moe.d_ff * self.moe.num_experts
            ffn_moe += 3 * d * self.moe.shared_d_ff
            ffn_moe += d * self.moe.num_experts  # router
            dense_ffn = 3 * d * self.d_ff if self.d_ff else 3 * d * self.moe.d_ff
            n += self.moe.first_k_dense * (attn + dense_ffn)
            n += (self.num_layers - self.moe.first_k_dense) * (attn + ffn_moe)
        elif self.ssm.enabled and self.arch_type == "hybrid":
            d_in = self.ssm.expand * d
            mamba = 2 * d * d_in + d_in * d + d_in * (self.ssm.state_dim * 2)
            n += self.num_layers * mamba
            n_attn_apps = self.num_layers // max(1, self.hybrid_attn_every)
            n += attn + 3 * d * self.d_ff if n_attn_apps else 0
        elif self.xlstm_pattern:
            n += self.num_layers * (4 * d * d + 2 * d * 4 * d)
        else:
            mult = 3 if self.mlp_gated else 2
            n += self.num_layers * (attn + mult * d * self.d_ff)
        if self.encoder_layers:
            mult = 3 if self.mlp_gated else 2
            n += self.encoder_layers * (attn + mult * d * self.d_ff)
            n += self.num_layers * attn  # cross attention
        return int(n)

    @property
    def active_param_count(self) -> int:
        """Parameters touched per token (MoE: top-k + shared only), as the
        reference counts them."""
        if not self.moe.enabled:
            return self.param_count
        d = self.d_model
        hd = self.head_dim_
        attn = d * hd * (self.num_heads + 2 * self.num_kv_heads) + \
            self.num_heads * hd * d
        ffn = 3 * d * self.moe.d_ff * self.moe.top_k + \
            3 * d * self.moe.shared_d_ff
        n = self.vocab_size * d * (1 if self.tie_embeddings else 2)
        n += self.num_layers * (attn + ffn + d * self.moe.num_experts)
        return int(n)

    def reduced(self) -> "ModelConfig":
        """CPU smoke-test variant of the same family (the reference's
        ``reduced()``, field for field)."""
        d = min(self.d_model, 128)
        heads = min(self.num_heads, 4)
        kv = max(1, min(self.num_kv_heads, heads))
        moe = self.moe
        if moe.enabled:
            moe = dataclasses.replace(
                moe, num_experts=4, top_k=min(moe.top_k, 2), d_ff=64,
                num_shared_experts=min(moe.num_shared_experts, 1),
                shared_d_ff=64 if moe.num_shared_experts else 0,
                first_k_dense=min(moe.first_k_dense, 1),
                num_shadow_slots=-1)
        ssm = self.ssm
        if ssm.enabled:
            ssm = dataclasses.replace(ssm, state_dim=16, head_dim=16, chunk=8)
        nl = max(2, len(self.attn_pattern))
        if self.hybrid_attn_every:
            nl = 2 * min(self.hybrid_attn_every, 2)
        if self.xlstm_pattern:
            nl = len(self.xlstm_pattern)
        return dataclasses.replace(
            self,
            name=self.name + "-smoke",
            num_layers=nl,
            d_model=d,
            num_heads=heads,
            num_kv_heads=kv,
            head_dim=d // heads,
            d_ff=min(self.d_ff, 256) if self.d_ff else 0,
            vocab_size=min(self.vocab_size, 512),
            sliding_window=min(self.sliding_window, 16) if self.sliding_window else 0,
            hybrid_attn_every=min(self.hybrid_attn_every, 2) if self.hybrid_attn_every else 0,
            encoder_layers=min(self.encoder_layers, 2) if self.encoder_layers else 0,
            encoder_seq=min(self.encoder_seq, 16) if self.encoder_seq else 0,
            moe=moe,
            ssm=ssm,
            dtype="float32",
        )


@dataclass(frozen=True)
class ShapeConfig:
    name: str
    seq_len: int
    global_batch: int
    kind: str  # "train" | "prefill" | "decode"


SHAPES = {
    "train_4k": ShapeConfig("train_4k", 4_096, 256, "train"),
    "prefill_32k": ShapeConfig("prefill_32k", 32_768, 32, "prefill"),
    "decode_32k": ShapeConfig("decode_32k", 32_768, 128, "decode"),
    "long_500k": ShapeConfig("long_500k", 524_288, 1, "decode"),
}


# Architectures with a sub-quadratic long-context path: a sliding window,
# recurrent state, or both.
LONG_CONTEXT_ARCHS = frozenset(
    {"h2o-danube-1.8b", "zamba2-7b", "xlstm-350m", "gemma2-2b"})


def supports_shape(cfg: ModelConfig, shape: ShapeConfig) -> bool:
    if shape.name == "long_500k":
        return cfg.name in LONG_CONTEXT_ARCHS
    return True
