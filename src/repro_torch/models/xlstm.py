"""xLSTM blocks (port of ``repro.models.xlstm``, arXiv:2405.04517): the
mLSTM (matrix memory, chunkwise parallel over a sequence) and the sLSTM
(scalar memory with a hidden-state recurrence), for xLSTM-350m.

A request's state has a constant size (no KV growth), like Mamba's: the
degenerate cheap case of Tarragon's incremental checkpointing.
Exponential gating is stabilised with the max state m (paper eq. 15-17).
No TPU kernel serves these blocks: the reference computes them in plain
jnp on every backend, and the port in plain PyTorch, in the reference's
order of operations.
"""
from __future__ import annotations

import torch
import torch.nn.functional as F

from repro_torch.configs.base import ModelConfig
from repro_torch.kernels.ref import attn_scale
from repro_torch.models.layers import dense_init, rmsnorm, rmsnorm_init


# --------------------------------------------------------------------------
# mLSTM
# --------------------------------------------------------------------------

def mlstm_init(gen, cfg: ModelConfig, device, dtype=torch.float32):
    d, h = cfg.d_model, cfg.num_heads
    kw = dict(device=device, dtype=dtype)
    return {
        "wq": dense_init(gen, d, d, **kw),
        "wk": dense_init(gen, d, d, **kw),
        "wv": dense_init(gen, d, d, **kw),
        "wi": dense_init(gen, d, h, **kw),      # input gate (exp)
        "wf": dense_init(gen, d, h, **kw),      # forget gate (log-sigmoid)
        "wo_gate": dense_init(gen, d, d, **kw),
        "wo": dense_init(gen, d, d, **kw),
        "norm": rmsnorm_init(d // h, device),
    }


def mlstm_state(cfg: ModelConfig, batch: int, device):
    d, h = cfg.d_model, cfg.num_heads
    dh = d // h
    kw = dict(dtype=torch.float32, device=device)
    return {"c": torch.zeros((batch, h, dh, dh), **kw),
            "n": torch.zeros((batch, h, dh), **kw),
            "m": torch.zeros((batch, h), **kw)}


def _mlstm_cell(state, q, k, v, ig, fg):
    """One time step. q, k, v: [B,H,Dh]; ig, fg: [B,H]."""
    c, n, m = state["c"], state["n"], state["m"]
    m_new = torch.maximum(fg + m, ig)
    i_p = torch.exp(ig - m_new)
    f_p = torch.exp(fg + m - m_new)
    c_new = f_p[..., None, None] * c + \
        i_p[..., None, None] * (v[..., :, None] * k[..., None, :])
    n_new = f_p[..., None] * n + i_p[..., None] * k
    denom = torch.clamp(torch.abs(torch.einsum("bhd,bhd->bh", n_new, q)),
                        min=1.0)
    h_t = torch.einsum("bhvd,bhd->bhv", c_new, q) / denom[..., None]
    return {"c": c_new, "n": n_new, "m": m_new}, h_t


def _mlstm_projections(cfg, params, x):
    b, s, d = x.shape
    h = cfg.num_heads
    dh = d // h
    scale = attn_scale(dh)

    def heads(w):
        return (x @ w.to(x.dtype)).reshape(b, s, h, dh).float()

    q = heads(params["wq"]) * scale
    k = heads(params["wk"]) * scale
    v = heads(params["wv"])
    ig = (x @ params["wi"].to(x.dtype)).float()             # [B,S,H]
    fg = F.logsigmoid((x @ params["wf"].to(x.dtype)).float())
    return q, k, v, ig, fg


def _mlstm_recurrent(q, k, v, ig, fg, st0):
    """The sequential form: ``_mlstm_cell`` step by step over time."""
    st, hs = st0, []
    for t in range(q.shape[1]):
        st, h_t = _mlstm_cell(st, q[:, t], k[:, t], v[:, t], ig[:, t],
                              fg[:, t])
        hs.append(h_t)
    return torch.stack(hs, 1), st                       # [B,S,H,Dh]


def _mlstm_chunked(q, k, v, ig, fg, st0, chunk: int = 64):
    """Chunkwise-parallel mLSTM: intra-chunk contributions as stabilised
    [T,T] attention-like products, the (C, n, m) state carried once per
    chunk. Exact, the max stabiliser included. The chunk is
    ``min(chunk, S)``, halved until it divides S."""
    bsz, s, h, dh = q.shape
    t = min(chunk, s)
    while s % t:
        t //= 2
    nc = s // t

    def rs(a):  # [B,S,...] -> [B,NC,T,...]
        return a.reshape(bsz, nc, t, *a.shape[2:])

    qc, kc, vc, igc, fgc = map(rs, (q, k, v, ig, fg))
    cumf = torch.cumsum(fgc, dim=2)                      # [B,NC,T,H]
    # intra-chunk log weights b[t,j] = cumf_t - cumf_j + ig_j (j <= t)
    ii = torch.arange(t, device=q.device)
    causal = ii[:, None] >= ii[None, :]
    blog = cumf[:, :, :, None, :] - cumf[:, :, None, :, :] + \
        igc[:, :, None, :, :]                            # [B,NC,Ti,Tj,H]
    blog = torch.where(causal[None, None, :, :, None], blog,
                       torch.full_like(blog, -float("inf")))
    m_intra = blog.amax(dim=3)                           # [B,NC,T,H]
    scores = torch.einsum("bgihd,bgjhd->bgijh", qc, kc)  # [B,NC,Ti,Tj,H]
    # end-of-chunk carry log weights
    b_end = cumf[:, :, -1:, :] - cumf + igc              # [B,NC,T,H]
    m_end_intra = b_end.amax(dim=2)                      # [B,NC,H]

    c_in, n_in, m_in = st0["c"], st0["n"], st0["m"]
    hs = []
    for g in range(nc):
        qg, kg, vg, cumf_g = qc[:, g], kc[:, g], vc[:, g], cumf[:, g]
        m_carry = m_in[:, None, :] + cumf_g              # [B,T,H]
        m_t = torch.maximum(m_intra[:, g], m_carry)      # [B,T,H]
        d_mat = torch.exp(blog[:, g] - m_t[:, :, None, :])   # [B,Ti,Tj,H]
        w = scores[:, g] * d_mat
        num = torch.einsum("bijh,bjhd->bihd", w, vg)
        den = w.sum(dim=2)                               # [B,Ti,H]
        # the carried state's contribution
        scale = torch.exp(m_carry - m_t)                 # [B,T,H]
        num = num + scale[..., None] * \
            torch.einsum("bhvd,bihd->bihv", c_in, qg)
        den = den + scale * torch.einsum("bhd,bihd->bih", n_in, qg)
        # the stabilised form's clamp: max(|n~.q|, 1) of _mlstm_cell
        hs.append(num / torch.clamp(torch.abs(den), min=1.0)[..., None])
        # the chunk-end state
        m_carry_end = m_in + cumf_g[:, -1]               # [B,H]
        m_out = torch.maximum(m_carry_end, m_end_intra[:, g])
        w_end = torch.exp(b_end[:, g] - m_out[:, None, :])   # [B,T,H]
        carry = torch.exp(m_carry_end - m_out)
        c_in = carry[..., None, None] * c_in + \
            torch.einsum("bjh,bjhv,bjhd->bhvd", w_end, vg, kg)
        n_in = carry[..., None] * n_in + \
            torch.einsum("bjh,bjhd->bhd", w_end, kg)
        m_in = m_out
    hseq = torch.stack(hs, 1).reshape(bsz, s, h, dh)
    return hseq, {"c": c_in, "n": n_in, "m": m_in}


def mlstm_forward(cfg: ModelConfig, params, x, state=None, chunk: int = 64):
    """x: [B,S,D] -> (y, final state). Chunkwise parallel for sequences,
    recurrent for single steps."""
    b, s, d = x.shape
    q, k, v, ig, fg = _mlstm_projections(cfg, params, x)
    st0 = state if state is not None else mlstm_state(cfg, b, x.device)
    if s > 1:
        hseq, stf = _mlstm_chunked(q, k, v, ig, fg, st0, chunk=chunk)
    else:
        hseq, stf = _mlstm_recurrent(q, k, v, ig, fg, st0)
    hseq = rmsnorm(params["norm"], hseq, cfg.norm_eps).to(x.dtype)
    hseq = hseq.reshape(b, s, d)
    gate = F.silu(x @ params["wo_gate"].to(x.dtype))
    out = (hseq * gate) @ params["wo"].to(x.dtype)
    return out, stf


# --------------------------------------------------------------------------
# sLSTM
# --------------------------------------------------------------------------

def slstm_init(gen, cfg: ModelConfig, device, dtype=torch.float32):
    """The reference's leaves. Its output projection ``wo`` replaces the
    o gate's input weight of the same name (drawn first, then
    overwritten), so the o gate reads ``wo`` too: kept as it is."""
    d = cfg.d_model
    kw = dict(device=device, dtype=dtype)
    p = {}
    for name in "ifzo":
        p[f"w{name}"] = dense_init(gen, d, d, **kw)
        p[f"r{name}"] = dense_init(gen, d, d, scale=0.5, **kw)
    p["wo"] = dense_init(gen, d, d, **kw)
    p["norm"] = rmsnorm_init(d, device)
    return p


def slstm_state(cfg: ModelConfig, batch: int, device):
    def z():
        return torch.zeros((batch, cfg.d_model), dtype=torch.float32,
                           device=device)
    return {"c": z(), "n": z(), "m": z(), "h": z()}


def _slstm_cell(params, state, xt):
    """xt: [B,D] float32."""
    hp = state["h"]

    def gate(name):
        return xt @ params[f"w{name}"] + hp @ params[f"r{name}"]

    ig, fg = gate("i"), F.logsigmoid(gate("f"))
    zt = torch.tanh(gate("z"))
    ot = torch.sigmoid(gate("o"))
    m_new = torch.maximum(fg + state["m"], ig)
    i_p = torch.exp(ig - m_new)
    f_p = torch.exp(fg + state["m"] - m_new)
    c_new = f_p * state["c"] + i_p * zt
    n_new = f_p * state["n"] + i_p
    h_new = ot * c_new / torch.clamp(n_new, min=1.0)
    return {"c": c_new, "n": n_new, "m": m_new, "h": h_new}


def slstm_forward(cfg: ModelConfig, params, x, state=None):
    """x: [B,S,D] -> (y, final state): float32 math on float32 copies of
    the weights, one step at a time (the prefill too)."""
    b, s, d = x.shape
    st = state if state is not None else slstm_state(cfg, b, x.device)
    p32 = {k: v.float() for k, v in params.items() if k != "norm"}
    x32 = x.float()
    hs = []
    for t in range(s):
        st = _slstm_cell(p32, st, x32[:, t])
        hs.append(st["h"])
    hseq = torch.stack(hs, 1)
    hseq = rmsnorm(params["norm"], hseq, cfg.norm_eps).to(x.dtype)
    out = hseq @ params["wo"].to(x.dtype)
    return out, st
