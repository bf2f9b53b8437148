"""Shared low-level layers: norms, RoPE, dense MLP, embeddings.

Params are plain dicts of tensors; every function takes ``cfg`` explicitly
where it needs it. Initialisers draw float32 from an explicit
``torch.Generator``, scale the draw in place and cast it to ``dtype`` (the
model passes ``cfg.torch_dtype``) before the next draw, so a tensor costs
at most one float32 temporary: Kimi-K2's 384-expert banks (11.3 GB each in
bf16) would not fit the card beside a whole float32 layer. A cast right
after the draw gives the bits of a cast after the layer.
"""
from __future__ import annotations

import math

import torch

from repro_torch.configs.base import ModelConfig
from repro_torch.kernels.ref import ACTS


# --------------------------------------------------------------------------
# init helpers (same shapes and scales as the reference)
# --------------------------------------------------------------------------

def normal(gen: torch.Generator, shape, std: float, device,
           dtype=torch.float32):
    """A float32 standard-normal draw times ``std`` (in place), in
    ``dtype``."""
    return torch.randn(shape, generator=gen, dtype=torch.float32,
                       device=device).mul_(std).to(dtype)


def dense_init(gen, in_dim: int, out_dim: int, *, device,
               scale: float = 1.0, dtype=torch.float32):
    return normal(gen, (in_dim, out_dim), scale / math.sqrt(in_dim), device,
                  dtype)


def embed_init(gen, vocab: int, d: int, device, dtype=torch.float32):
    return normal(gen, (vocab, d), 0.02, device, dtype)


def rmsnorm_init(d: int, device):
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
# row-blocked evaluation (prefill and chunk calls)
# --------------------------------------------------------------------------

#: rows of every block a prefill or chunk call's dense projection or norm
#: runs on
ROW_BLOCK = 128


def row_blocked(fn, x):
    """``fn`` applied to the rows of x [..., K] in fixed blocks of
    ROW_BLOCK rows (the last padded with zeros): every row goes through
    the same call of the same shape, whatever the number of rows. A
    library GEMM or reduction picks its algorithm (and so its summation
    order) by the row count, so without this a token's bits in a prefill
    or chunk call would depend on how many rows share the call, and
    chunked prefill would part from whole-prompt prefill. ``fn`` must act
    on each row alone. Returns [..., N]."""
    k = x.shape[-1]
    rows = x.reshape(-1, k)
    m = rows.shape[0]
    buf = rows.new_zeros((-(-m // ROW_BLOCK) * ROW_BLOCK, k))
    buf[:m] = rows
    out = torch.cat([fn(buf[i:i + ROW_BLOCK])
                     for i in range(0, buf.shape[0], ROW_BLOCK)])
    return out[:m].reshape(*x.shape[:-1], out.shape[-1])


def matmul(x, w, blocked: bool):
    """x [..., K] @ w [K, N], row-blocked for a prefill or chunk call."""
    return row_blocked(lambda r: r @ w, x) if blocked else x @ w


def norm(params, x, eps: float, blocked: bool):
    """``rmsnorm``, row-blocked for a prefill or chunk call."""
    if blocked:
        return row_blocked(lambda r: rmsnorm(params, r, eps), x)
    return rmsnorm(params, x, eps)


# --------------------------------------------------------------------------
# RoPE
# --------------------------------------------------------------------------

def rope_freqs(head_dim: int, theta: float, device):
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

def mlp_init(gen, d: int, d_ff: int, gated: bool, device,
             dtype=torch.float32):
    p = {"w_up": dense_init(gen, d, d_ff, device=device, dtype=dtype),
         "w_down": dense_init(gen, d_ff, d, device=device, dtype=dtype)}
    if gated:
        p["w_gate"] = dense_init(gen, d, d_ff, device=device, dtype=dtype)
    return p


def act_fn(name: str):
    return ACTS[name]


def mlp(params, x, act: str = "silu", blocked: bool = False):
    up = matmul(x, params["w_up"], blocked)
    if "w_gate" in params:
        up = act_fn(act)(matmul(x, params["w_gate"], blocked)) * up
    else:
        up = act_fn(act)(up)
    return matmul(up, params["w_down"], blocked)


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
