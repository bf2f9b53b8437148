"""Plain PyTorch versions of the kernel contracts (``repro.kernels.ref``).

They are the CPU execution path of the port and the yardstick each CUDA
kernel is held to on the card. Accumulation is float32 throughout, results
are cast back to the input dtype, as in the reference.
"""
from __future__ import annotations

import numpy as np
import torch
import torch.nn.functional as F

NEG_INF = -1e30

ACTS = {"silu": F.silu,
        # jax.nn.gelu defaults to the tanh approximation
        "gelu": lambda x: F.gelu(x, approximate="tanh")}


def attn_scale(dh: int) -> float:
    """1/sqrt(dh) computed in float32, as the reference does. A Python
    number, not a device tensor: a step captured in a CUDA graph may not
    copy from the host."""
    return float(np.float32(1.0) / np.sqrt(np.float32(dh)))


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
    qs = q.reshape(b, hkv, g, dh).float() * attn_scale(dh)
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
    qs = q.reshape(b, hkv, g, dh).float() * attn_scale(dh)
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


# --------------------------------------------------------------------------
# Mamba2-style selective state-space scan
# --------------------------------------------------------------------------

def scan_chunk(s: int, chunk: int) -> int:
    """The reference's chunk length for S steps: min(chunk, S), halved
    until it divides S (a 127-step sequence runs at 1)."""
    t = min(chunk, s)
    while s % t:
        t //= 2
    return max(t, 1)


def ssm_scan_chunked_ref(x, dt, a, b, c, chunk: int = 64):
    """Chunk-parallel SSD from a zero state (the TPU kernel's math in
    plain PyTorch, as ``repro.kernels.ref.ssm_scan_chunked_ref``).
    x: [B,S,H,P]; dt: [B,S,H]; a: [H] (< 0); b, c: [B,S,N]. Returns
    (y [B,S,H,P] in x's dtype, h_final [B,H,P,N] float32)."""
    bs, s, h, p = x.shape
    n = b.shape[-1]
    t = scan_chunk(s, chunk)
    nch = s // t
    xs = x.reshape(bs, nch, t, h, p).float()
    dts = dt.reshape(bs, nch, t, h).float()
    bm = b.reshape(bs, nch, t, n).float()
    cm = c.reshape(bs, nch, t, n).float()

    seg = torch.cumsum(dts, dim=2) * a.float()[None, None, None, :]
    ii = torch.arange(t, device=x.device)
    causal = ii[:, None] >= ii[None, :]
    # mask in log space: for j > i the difference is positive and exp()
    # overflows before a causal zeroing (inf * 0 = NaN)
    diff = seg[:, :, :, None, :] - seg[:, :, None, :, :]     # [B,NC,T,T,H]
    diff = torch.where(causal[None, None, :, :, None], diff,
                       torch.full_like(diff, float("-inf")))
    ldec = torch.exp(diff)
    g = torch.einsum("bgin,bgjn->bgij", cm, bm)               # [B,NC,T,T]
    w = g[..., None] * ldec * dts[:, :, None, :, :]
    y_intra = torch.einsum("bgijh,bgjhp->bgihp", w, xs)

    # inter-chunk state carry (sequential over chunks only)
    seg_tot = seg[:, :, -1, :]                                # [B,NC,H]
    carry_w = dts * torch.exp(seg_tot[:, :, None, :] - seg)   # [B,NC,T,H]
    dh = torch.einsum("bgthp,bgtn->bghpn", xs * carry_w[..., None], bm)
    hstate = torch.zeros((bs, h, p, n), dtype=torch.float32,
                         device=x.device)
    h_ins = []
    for gi in range(nch):
        h_ins.append(hstate)
        hstate = hstate * torch.exp(seg_tot[:, gi])[..., None, None] + \
            dh[:, gi]
    h_in = torch.stack(h_ins, 1)                              # [B,NC,H,P,N]
    y_state = torch.einsum("bgtn,bghpn->bgthp", cm, h_in)
    y_state = y_state * torch.exp(seg)[..., None]
    y = (y_intra + y_state).reshape(bs, s, h, p).to(x.dtype)
    return y, hstate


def ssm_scan_ref(x, dt, a, b, c, h0=None):
    """Sequential SSD recurrence (``repro.kernels.ref.ssm_scan_ref``).
    Same shapes as ``ssm_scan_chunked_ref``; ``h0`` [B,H,P,N] is the
    initial state (zeros if None)."""
    bs, s, h, p = x.shape
    n = b.shape[-1]
    hstate = torch.zeros((bs, h, p, n), dtype=torch.float32,
                         device=x.device) if h0 is None else h0.float()
    a = a.float()
    ys = []
    for i in range(s):
        dtt = dt[:, i].float()
        decay = torch.exp(dtt * a)                            # [B,H]
        dbx = torch.einsum("bh,bhp,bn->bhpn", dtt, x[:, i].float(),
                           b[:, i].float())
        hstate = hstate * decay[..., None, None] + dbx
        ys.append(torch.einsum("bhpn,bn->bhp", hstate, c[:, i].float()))
    return torch.stack(ys, 1).to(x.dtype), hstate
