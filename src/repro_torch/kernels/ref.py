"""Plain PyTorch versions of the kernel contracts (``repro.kernels.ref``).

They are the CPU execution path of the port and the yardstick each CUDA
kernel is held to on the card. Accumulation is float32 throughout, results
are cast back to the input dtype, as in the reference.
"""
from __future__ import annotations

import torch
import torch.nn.functional as F

NEG_INF = -1e30

ACTS = {"silu": F.silu,
        # jax.nn.gelu defaults to the tanh approximation
        "gelu": lambda x: F.gelu(x, approximate="tanh")}


def attn_scale(dh: int, device=None) -> torch.Tensor:
    """1/sqrt(dh) computed in float32, as the reference does."""
    return 1.0 / torch.sqrt(torch.tensor(float(dh), dtype=torch.float32,
                                         device=device))


# --------------------------------------------------------------------------
# decode attention (GQA, one query token vs cached K/V + current token)
# --------------------------------------------------------------------------

def decode_attention_partial_ref(q, ck, cv, cpos, pos, *, window: int = 0,
                                 softcap: float = 0.0):
    """Online-softmax partials of q against the cache.

    q: [B,H,Dh]; ck/cv: [B,Sc,Hkv,Dh]; cpos: [B,Sc]; pos: [B].
    Returns (m [B,Hkv,G], l [B,Hkv,G], acc [B,Hkv,G,Dh]) in float32.
    """
    b, h, dh = q.shape
    hkv = ck.shape[2]
    g = h // hkv
    qs = q.reshape(b, hkv, g, dh).float() * attn_scale(dh, q.device)
    s = torch.einsum("bhgd,bshd->bhgs", qs, ck.float())
    if softcap:
        s = torch.tanh(s / softcap) * softcap
    mask = (cpos >= 0) & (cpos <= pos[:, None])
    if window:
        mask &= cpos > (pos[:, None] - window)
    mask = mask[:, None, None, :]
    s = torch.where(mask, s, torch.full_like(s, NEG_INF))
    m = s.amax(dim=-1)
    p = torch.exp(s - m[..., None])
    p = torch.where(mask, p, torch.zeros_like(p))
    l = p.sum(dim=-1)
    acc = torch.einsum("bhgs,bshd->bhgd", p, cv.float())
    return m, l, acc


def decode_attention_ref(q, ck, cv, cpos, k1, v1, pos, *, window: int = 0,
                         softcap: float = 0.0):
    """Monolithic softmax over cache + current token. Returns [B,H,Dh] in
    q's dtype."""
    b, h, dh = q.shape
    hkv = ck.shape[2]
    g = h // hkv
    qs = q.reshape(b, hkv, g, dh).float() * attn_scale(dh, q.device)
    s = torch.einsum("bhgd,bshd->bhgs", qs, ck.float())
    s_self = torch.einsum("bhgd,bhd->bhg", qs, k1.float())
    if softcap:
        s = torch.tanh(s / softcap) * softcap
        s_self = torch.tanh(s_self / softcap) * softcap
    mask = (cpos >= 0) & (cpos <= pos[:, None])
    if window:
        mask &= cpos > (pos[:, None] - window)
    s = torch.where(mask[:, None, None, :], s, torch.full_like(s, NEG_INF))
    s_all = torch.cat([s, s_self[..., None]], dim=-1)
    p = torch.softmax(s_all, dim=-1)
    v_all = torch.cat([cv.float(), v1.float()[:, None]], dim=1)
    out = torch.einsum("bhgs,bshd->bhgd", p, v_all)
    return out.reshape(b, h, dh).to(q.dtype)


# --------------------------------------------------------------------------
# grouped MoE expert FFN
# --------------------------------------------------------------------------

def moe_gemm_ref(x, w_gate, w_up, w_down, act: str = "silu"):
    """x: [P,...,D]; w_gate/w_up: [P,D,F]; w_down: [P,F,D] -> [P,...,D].

    Gated FFN per expert slot with float32 accumulation; ``w_gate`` may be
    None for ungated FFNs."""
    fn = ACTS[act]
    x32 = x.float()
    up = torch.einsum("p...d,pdf->p...f", x32, w_up.float())
    if w_gate is not None:
        up = fn(torch.einsum("p...d,pdf->p...f", x32, w_gate.float())) * up
    else:
        up = fn(up)
    y = torch.einsum("p...f,pfd->p...d", up, w_down.float())
    return y.to(x.dtype)
