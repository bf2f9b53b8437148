"""Config schema for models and Tarragon resilience knobs (PyTorch port).

Mirrors ``repro.configs.base``: a model is a ``ModelConfig``; ``reduced()``
produces the CPU-smoke variant of the same family (<=2 layers, d_model<=128,
4 experts). The compute dtype is exposed as a torch dtype.
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
    """Mamba2-style block configuration (no family of the port uses it yet;
    kept so ``reduced()`` mirrors the reference field for field)."""

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
        """Approximate parameter count (embeddings + blocks), transformer
        families only."""
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
        else:
            mult = 3 if self.mlp_gated else 2
            n += self.num_layers * (attn + mult * d * self.d_ff)
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
