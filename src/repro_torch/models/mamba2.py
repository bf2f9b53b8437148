"""Mamba2 (SSD) block, the recurrent substrate of Zamba2 (port of
``repro.models.mamba2``).

A request's state is a fixed-size pair (h [B,H,P,N] float32, conv
[B,W-1,Di]) rather than a growing KV cache: its checkpoint segment is one
state snapshot. The full-sequence path runs the chunked SSD scan (the
hand-written kernel on the card, the plain chunked form on the CPU) from a
zero state; decode is a one-step recurrence in plain PyTorch, as the
reference computes it with einsums rather than a kernel.
"""
from __future__ import annotations

import torch
import torch.nn.functional as F

from repro_torch.configs.base import ModelConfig
from repro_torch.kernels import ops as kops
from repro_torch.models.layers import dense_init, rmsnorm, rmsnorm_init


def mamba_dims(cfg: ModelConfig):
    d_inner = cfg.ssm.expand * cfg.d_model
    return d_inner, d_inner // cfg.ssm.head_dim


def mamba_init(gen, cfg: ModelConfig, device):
    """One block's params with the reference's shapes and scales: the
    fused ``in_proj`` produces [z, x, B, C, dt]."""
    d, n = cfg.d_model, cfg.ssm.state_dim
    di, nh = mamba_dims(cfg)
    return {
        "in_proj": dense_init(gen, d, 2 * di + 2 * n + nh, device=device),
        "out_proj": dense_init(gen, di, d, device=device),
        "conv_w": torch.randn((cfg.ssm.conv_width, di), generator=gen,
                              dtype=torch.float32, device=device) * 0.2,
        "conv_b": torch.zeros((di,), dtype=torch.float32, device=device),
        "a_log": torch.log(torch.linspace(1.0, 16.0, nh, device=device)),
        "d_skip": torch.ones((nh,), dtype=torch.float32, device=device),
        "dt_bias": torch.zeros((nh,), dtype=torch.float32, device=device),
        "norm": rmsnorm_init(di, device),
    }


def init_state(cfg: ModelConfig, batch: int, *, device, dtype=None):
    di, nh = mamba_dims(cfg)
    return {
        "h": torch.zeros((batch, nh, cfg.ssm.head_dim, cfg.ssm.state_dim),
                         dtype=torch.float32, device=device),
        "conv": torch.zeros((batch, cfg.ssm.conv_width - 1, di),
                            dtype=dtype or cfg.torch_dtype, device=device),
    }


def _split_proj(cfg, proj):
    di, nh = mamba_dims(cfg)
    n = cfg.ssm.state_dim
    return torch.split(proj, [di, di, n, n, nh], dim=-1)


def _causal_conv(params, xin, conv_state=None):
    """Depthwise causal conv over time, as a plain sum over the window in
    the reference's order. xin: [B,S,Di]. Returns (silu(out), the last
    W-1 inputs: the next call's conv state)."""
    w = params["conv_w"]                        # [W, Di]
    width = w.shape[0]
    if conv_state is None:
        pad = xin.new_zeros((xin.shape[0], width - 1, xin.shape[-1]))
    else:
        pad = conv_state.to(xin.dtype)
    xp = torch.cat([pad, xin], dim=1)           # [B, S+W-1, Di]
    s = xin.shape[1]
    out = xp[:, 0:s] * w[0].to(xin.dtype)
    for i in range(1, width):
        out = out + xp[:, i:i + s] * w[i].to(xin.dtype)
    out = out + params["conv_b"].to(xin.dtype)
    return F.silu(out), xp[:, -(width - 1):]


def _softplus(x):
    # jax.nn.softplus: logaddexp(x, 0)
    return torch.logaddexp(x, torch.zeros_like(x))


def mamba_forward(cfg: ModelConfig, params, x, state=None):
    """Full-sequence SSD. x: [B,S,D] -> (y [B,S,D], new state or None).
    The scan starts from a zero state (prefill from scratch); a carried
    state is only used by decode, as in the reference."""
    bsz, s, _ = x.shape
    di, nh = mamba_dims(cfg)
    proj = x @ params["in_proj"].to(x.dtype)
    z, xin, b, c, dt_raw = _split_proj(cfg, proj)
    conv_state = state["conv"] if state is not None else None
    xin, new_conv = _causal_conv(params, xin, conv_state)

    dt = _softplus(dt_raw.float() + params["dt_bias"])         # [B,S,H]
    a = -torch.exp(params["a_log"])                            # [H]
    xh = xin.reshape(bsz, s, nh, cfg.ssm.head_dim)
    y, hf = kops.ssm_scan(xh, dt, a, b.float(), c.float(),
                          chunk=cfg.ssm.chunk)
    y = y + xh * params["d_skip"][None, None, :, None].to(y.dtype)
    y = y.reshape(bsz, s, di)
    y = rmsnorm(params["norm"], y * F.silu(z), cfg.norm_eps)
    out = y @ params["out_proj"].to(y.dtype)
    new_state = {"h": hf, "conv": new_conv} if state is not None else None
    return out, new_state


def mamba_decode_step(cfg: ModelConfig, params, x, state):
    """Single-token recurrence. x: [B,1,D] -> (y [B,1,D], new state)."""
    bsz = x.shape[0]
    di, nh = mamba_dims(cfg)
    proj = x @ params["in_proj"].to(x.dtype)
    z, xin, b, c, dt_raw = _split_proj(cfg, proj)
    xin, new_conv = _causal_conv(params, xin, state["conv"])

    dt = _softplus(dt_raw[:, 0].float() + params["dt_bias"])   # [B,H]
    a = -torch.exp(params["a_log"])
    xh = xin.reshape(bsz, nh, cfg.ssm.head_dim).float()
    decay = torch.exp(dt * a)                                  # [B,H]
    dbx = (dt[..., None] * xh)[..., None] * \
        b[:, 0].float()[:, None, None, :]                      # [B,H,P,N]
    h = state["h"] * decay[..., None, None] + dbx
    y = torch.einsum("bhpn,bn->bhp", h, c[:, 0].float())
    y = y + xh * params["d_skip"][None, :, None]
    y = y.reshape(bsz, 1, di).to(x.dtype)
    y = rmsnorm(params["norm"], y * F.silu(z), cfg.norm_eps)
    out = y @ params["out_proj"].to(y.dtype)
    return out, {"h": h, "conv": new_conv}

