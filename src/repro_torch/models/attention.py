"""GQA attention: blockwise full attention for prefill and single-token
decode against a contiguous slotted KV cache.

Cache layout per attention layer (as in the reference):
    {"k": [B, Sc, Hkv, Dh], "v": [B, Sc, Hkv, Dh], "pos": [B, Sc] int32}
``pos`` holds the absolute position stored in each slot (-1 = empty). The
port updates cache tensors in place (the reference returns new arrays):
an engine keeps one cache for life, so in-place writes save a full copy
per step.
"""
from __future__ import annotations

from typing import Optional

import torch

from repro_torch.configs.base import ModelConfig
from repro_torch.kernels.ref import NEG_INF, attn_scale
from repro_torch.models.layers import apply_rope, dense_init, rmsnorm

# Cached (prefill/chunk) attention pins the KV block size of the online
# softmax, so its accumulation order does not depend on the padded extent
# (the reference's precondition for chunked == whole prefill).
PREFILL_BLOCK_K = 16


# --------------------------------------------------------------------------
# params
# --------------------------------------------------------------------------

def attn_init(gen, cfg: ModelConfig, device="cpu"):
    d, h, hkv, dh = cfg.d_model, cfg.num_heads, cfg.num_kv_heads, cfg.head_dim_
    return {
        "wq": dense_init(gen, d, h * dh, device=device),
        "wk": dense_init(gen, d, hkv * dh, device=device),
        "wv": dense_init(gen, d, hkv * dh, device=device),
        "wo": dense_init(gen, h * dh, d, device=device),
    }


def _project_q(cfg, params, x):
    b, s, _ = x.shape
    q = x @ params["wq"]
    if "bq" in params:
        q = q + params["bq"].to(q.dtype)
    q = q.reshape(b, s, cfg.num_heads, cfg.head_dim_)
    if "q_norm" in params:
        q = rmsnorm(params["q_norm"], q, cfg.norm_eps)
    return q


def _project_kv(cfg, params, x):
    b, s, _ = x.shape
    k = x @ params["wk"]
    v = x @ params["wv"]
    if "bk" in params:
        k = k + params["bk"].to(k.dtype)
        v = v + params["bv"].to(v.dtype)
    k = k.reshape(b, s, cfg.num_kv_heads, cfg.head_dim_)
    v = v.reshape(b, s, cfg.num_kv_heads, cfg.head_dim_)
    if "k_norm" in params:
        k = rmsnorm(params["k_norm"], k, cfg.norm_eps)
    return k, v


# --------------------------------------------------------------------------
# blockwise full attention: the plain version of the flash kernel
# --------------------------------------------------------------------------

def _pick_block(s: int, target: int = 512) -> int:
    b = min(target, s)
    while s % b:
        b //= 2
    return max(b, 1)


def blockwise_attention(q, k, v, q_pos, k_pos, *, window: int = 0,
                        softcap: float = 0.0, causal: bool = True,
                        block_q: int = 0, block_k: int = 0):
    """q: [B,Sq,H,Dh]; k,v: [B,Sk,Hkv,Dh]; *_pos: [B,Sq]/[B,Sk] (-1 =
    invalid). Online softmax over KV blocks of ``block_k``.

    Masked probabilities are zeroed, as in the TPU flash kernel, so a row
    with no valid key gives 0. On every row with a valid key this is
    bitwise the reference's ``blockwise_attention``: the masked terms it
    keeps are multiplied by an exact 0 once a valid key arrives."""
    b, sq, h, dh = q.shape
    sk, hkv = k.shape[1], k.shape[2]
    g = h // hkv
    bq = block_q or _pick_block(sq)
    bk = block_k or _pick_block(sk)
    qs = q.reshape(b, sq, hkv, g, dh).float() * attn_scale(dh, q.device)
    kf, vf = k.float(), v.float()
    out = torch.empty((b, sq, hkv, g, dh), dtype=torch.float32,
                      device=q.device)
    for q0 in range(0, sq, bq):
        qb = qs[:, q0:q0 + bq]
        qpb = q_pos[:, q0:q0 + bq]
        m = torch.full((b, bq, hkv, g), NEG_INF, dtype=torch.float32,
                       device=q.device)
        l = torch.zeros_like(m)
        acc = torch.zeros((b, bq, hkv, g, dh), dtype=torch.float32,
                          device=q.device)
        for k0 in range(0, sk, bk):
            kb, vb = kf[:, k0:k0 + bk], vf[:, k0:k0 + bk]
            kpb = k_pos[:, k0:k0 + bk]
            s = torch.einsum("bqhgd,bkhd->bqhgk", qb, kb)
            if softcap:
                s = torch.tanh(s / softcap) * softcap
            mask = (kpb[:, None, :] >= 0).expand(b, bq, kpb.shape[1])
            if causal:
                mask = mask & (kpb[:, None, :] <= qpb[:, :, None])
            if window:
                mask = mask & (kpb[:, None, :] > qpb[:, :, None] - window)
            mask = mask[:, :, None, None, :]
            s = torch.where(mask, s, torch.full_like(s, NEG_INF))
            m_new = torch.maximum(m, s.amax(dim=-1))
            p = torch.exp(s - m_new[..., None])
            p = torch.where(mask, p, torch.zeros_like(p))
            corr = torch.exp(m - m_new)
            l = l * corr + p.sum(dim=-1)
            acc = acc * corr[..., None] + torch.einsum("bqhgk,bkhd->bqhgd",
                                                       p, vb)
            m = m_new
        o = acc / torch.clamp(l[..., None], min=1e-30)
        out[:, q0:q0 + bq] = torch.where((l > 0)[..., None], o,
                                         torch.zeros_like(o))
    return out.reshape(b, sq, h, dh).to(q.dtype)


# --------------------------------------------------------------------------
# cache management
# --------------------------------------------------------------------------

def init_cache(cfg: ModelConfig, batch: int, max_seq: int, window: int = 0,
               dtype=None, device="cpu"):
    sc = min(window, max_seq) if window else max_seq
    dh, hkv = cfg.head_dim_, cfg.num_kv_heads
    dt = dtype or cfg.torch_dtype
    return {
        "k": torch.zeros((batch, sc, hkv, dh), dtype=dt, device=device),
        "v": torch.zeros((batch, sc, hkv, dh), dtype=dt, device=device),
        "pos": torch.full((batch, sc), -1, dtype=torch.int32, device=device),
    }


def cache_write_prefill(cache, k, v, positions):
    """Write prefill K/V [B,S,...] into the cache in place (keeping the
    last Sc entries, ring-placed, if S > Sc)."""
    sc = cache["k"].shape[1]
    s = k.shape[1]
    if s <= sc:
        cache["k"][:, :s] = k.to(cache["k"].dtype)
        cache["v"][:, :s] = v.to(cache["v"].dtype)
        cache["pos"][:, :s] = positions.to(torch.int32)
        return cache
    k, v, positions = k[:, -sc:], v[:, -sc:], positions[:, -sc:]
    slots = (positions % sc).long()
    bidx = torch.arange(k.shape[0], device=k.device)[:, None]
    cache["k"][bidx, slots] = k.to(cache["k"].dtype)
    cache["v"][bidx, slots] = v.to(cache["v"].dtype)
    cache["pos"][bidx, slots] = positions.to(torch.int32)
    return cache


def cache_write_token(cache, k1, v1, pos, window: int = 0):
    """Write one token's K/V [B,1,...] at absolute position pos [B], in
    place. Rows with pos < 0 keep their cache untouched (the reference
    drops their out-of-bounds scatter); done without a host sync by
    writing such a row's slot 0 back onto itself."""
    sc = cache["k"].shape[1]
    valid = pos >= 0
    slot = (pos % sc) if window else torch.clamp(pos, max=sc - 1)
    slot = torch.where(valid, slot, torch.zeros_like(slot)).long()
    bidx = torch.arange(k1.shape[0], device=k1.device)
    for name, new in (("k", k1[:, 0]), ("v", v1[:, 0])):
        t = cache[name]
        t[bidx, slot] = torch.where(valid[:, None, None], new.to(t.dtype),
                                    t[bidx, slot])
    p = cache["pos"]
    p[bidx, slot] = torch.where(valid, pos.to(torch.int32), p[bidx, slot])
    return cache


# --------------------------------------------------------------------------
# layer-level apply
# --------------------------------------------------------------------------

def attn_full(cfg: ModelConfig, params, x, positions, *, window: int = 0,
              causal: bool = True, cache: Optional[dict] = None):
    """Prefill path. Returns (out [B,S,D], cache written in place or
    None). With a cache the plain version's KV block is pinned to
    PREFILL_BLOCK_K, as in the reference."""
    from repro_torch.kernels import ops as kops
    q = _project_q(cfg, params, x)
    k, v = _project_kv(cfg, params, x)
    q = apply_rope(q, positions, cfg.rope_theta)
    k = apply_rope(k, positions, cfg.rope_theta)
    bk = _pick_block(k.shape[1], PREFILL_BLOCK_K) if cache is not None else 0
    out = kops.full_attention(q, k, v, positions, positions, window=window,
                              softcap=cfg.attn_softcap, causal=causal,
                              block_k=bk)
    out = out.reshape(*x.shape[:2], -1) @ params["wo"]
    if cache is not None:
        cache = cache_write_prefill(cache, k, v, positions)
    return out, cache


def attn_decode(cfg: ModelConfig, params, x, cache, pos, *, window: int = 0):
    """Single-token decode. x: [B,1,D]; pos: [B] absolute position of x.
    Attends over the cache plus the current token, then writes the token
    into the cache. Returns (out [B,1,D], cache)."""
    from repro_torch.kernels import ops as kops
    b = x.shape[0]
    q = _project_q(cfg, params, x)                     # [B,1,H,Dh]
    k1, v1 = _project_kv(cfg, params, x)               # [B,1,Hkv,Dh]
    q = apply_rope(q, pos[:, None], cfg.rope_theta)
    k1 = apply_rope(k1, pos[:, None], cfg.rope_theta)
    out = kops.decode_attention(q[:, 0], cache["k"], cache["v"], cache["pos"],
                                k1[:, 0], v1[:, 0], pos, window=window,
                                softcap=cfg.attn_softcap)
    out = out.reshape(b, 1, -1) @ params["wo"]
    cache = cache_write_token(cache, k1, v1, pos, window=window)
    return out, cache
