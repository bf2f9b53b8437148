"""Shared low-level layers: norms, RoPE, dense MLP, embeddings.

Params are plain dicts of tensors; every function takes ``cfg`` explicitly
where it needs it. Initialisers draw float32 from an explicit
``torch.Generator`` and the model casts to ``cfg.torch_dtype``.
"""
from __future__ import annotations

import math

import torch

from repro_torch.configs.base import ModelConfig
from repro_torch.kernels.ref import ACTS


# --------------------------------------------------------------------------
# init helpers (same shapes and scales as the reference)
# --------------------------------------------------------------------------

def _normal(gen: torch.Generator, shape, device):
    return torch.randn(shape, generator=gen, dtype=torch.float32,
                       device=device)


def dense_init(gen, in_dim: int, out_dim: int, scale: float = 1.0,
               device="cpu"):
    return _normal(gen, (in_dim, out_dim), device) * (scale /
                                                      math.sqrt(in_dim))


def embed_init(gen, vocab: int, d: int, device="cpu"):
    return _normal(gen, (vocab, d), device) * 0.02


def rmsnorm_init(d: int, device="cpu"):
    return {"scale": torch.ones((d,), dtype=torch.float32, device=device)}


# --------------------------------------------------------------------------
# norms
# --------------------------------------------------------------------------

def rmsnorm(params, x, eps: float = 1e-6):
    dt = x.dtype
    x32 = x.float()
    var = torch.mean(x32 * x32, dim=-1, keepdim=True)
    y = x32 * torch.rsqrt(var + eps)
    return (y * params["scale"]).to(dt)


# --------------------------------------------------------------------------
# RoPE
# --------------------------------------------------------------------------

def rope_freqs(head_dim: int, theta: float, device="cpu"):
    exponents = torch.arange(0, head_dim, 2, dtype=torch.float32,
                             device=device) / head_dim
    return 1.0 / (theta ** exponents)  # [head_dim/2]


def apply_rope(x, positions, theta: float):
    """x: [..., S, H, Dh]; positions: broadcastable to [..., S]."""
    dh = x.shape[-1]
    freqs = rope_freqs(dh, theta, x.device)
    angles = positions[..., None].float() * freqs        # [..., S, Dh/2]
    angles = angles[..., None, :]                         # [..., S, 1, Dh/2]
    cos, sin = torch.cos(angles), torch.sin(angles)
    x1, x2 = torch.chunk(x.float(), 2, dim=-1)
    out = torch.cat([x1 * cos - x2 * sin, x2 * cos + x1 * sin], dim=-1)
    return out.to(x.dtype)


# --------------------------------------------------------------------------
# dense MLP (SwiGLU or plain)
# --------------------------------------------------------------------------

def mlp_init(gen, d: int, d_ff: int, gated: bool = True, device="cpu"):
    p = {"w_up": dense_init(gen, d, d_ff, device=device),
         "w_down": dense_init(gen, d_ff, d, device=device)}
    if gated:
        p["w_gate"] = dense_init(gen, d, d_ff, device=device)
    return p


def act_fn(name: str):
    return ACTS[name]


def mlp(params, x, act: str = "silu"):
    up = x @ params["w_up"]
    if "w_gate" in params:
        up = act_fn(act)(x @ params["w_gate"]) * up
    else:
        up = act_fn(act)(up)
    return up @ params["w_down"]


# --------------------------------------------------------------------------
# unembedding with optional logit softcap
# --------------------------------------------------------------------------

def softcap(x, cap: float):
    if not cap:
        return x
    return torch.tanh(x / cap) * cap


def unembed(cfg: ModelConfig, params, h):
    w = params["embed"] if cfg.tie_embeddings else params["unembed"]
    logits = h @ w.t().to(h.dtype)
    return softcap(logits, cfg.logit_softcap)
