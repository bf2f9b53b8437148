"""GQA attention: blockwise full attention for prefill, chunked prefill
and single-token decode, against a contiguous slotted KV cache or a paged
one; and the Whisper decoder's cross attention over the encoder's K/V.

Cache layout per attention layer (as in the reference):
    {"k": [B, Sc, Hkv, Dh], "v": [B, Sc, Hkv, Dh], "pos": [B, Sc] int32}
``pos`` holds the absolute position stored in each slot (-1 = empty). A
paged layer holds P physical pages of pt tokens instead ([P, pt, ...]),
read through one block table ``bt`` [B, nblk] (see ``paged_view``). The
port updates cache tensors in place (the reference returns new arrays):
an engine keeps one cache for life, so in-place writes save a full copy
per step.
"""
from __future__ import annotations

from typing import Optional

import torch

from repro_torch.configs.base import ModelConfig
from repro_torch.kernels.decode_attention import gather_pages
from repro_torch.kernels.ref import NEG_INF, attn_scale
from repro_torch.models.layers import (apply_rope, dense_init, matmul, norm,
                                       rmsnorm_init)

# Cached (prefill/chunk) attention pins the KV block size of the online
# softmax, so its accumulation order does not depend on the padded extent
# (the reference's precondition for chunked == whole prefill).
PREFILL_BLOCK_K = 16


# --------------------------------------------------------------------------
# params
# --------------------------------------------------------------------------

def attn_init(gen, cfg: ModelConfig, device, dtype=torch.float32,
              cross: bool = False):
    """The reference's leaves: the four projections (in ``dtype``), the
    QKV biases (zeros) with ``cfg.qkv_bias`` unless ``cross`` (Whisper's
    cross attention has none) and the per-head q/k norms with
    ``cfg.qk_norm``."""
    d, h, hkv, dh = cfg.d_model, cfg.num_heads, cfg.num_kv_heads, cfg.head_dim_
    kw = dict(device=device, dtype=dtype)
    p = {
        "wq": dense_init(gen, d, h * dh, **kw),
        "wk": dense_init(gen, d, hkv * dh, **kw),
        "wv": dense_init(gen, d, hkv * dh, **kw),
        "wo": dense_init(gen, h * dh, d, **kw),
    }
    if cfg.qkv_bias and not cross:
        for name, n in (("bq", h * dh), ("bk", hkv * dh), ("bv", hkv * dh)):
            p[name] = torch.zeros((n,), dtype=torch.float32, device=device)
    if cfg.qk_norm:
        p["q_norm"] = rmsnorm_init(dh, device)
        p["k_norm"] = rmsnorm_init(dh, device)
    return p


# The projections take ``blocked`` on prefill and chunk calls: their rows
# then run in fixed blocks (``layers.row_blocked``), so a token's K/V and
# query bits do not depend on how many rows share its call, and chunked
# prefill gives the bits of whole-prompt prefill. Decode steps do not.

def _project_q(cfg, params, x, blocked: bool = False):
    b, s, _ = x.shape
    q = matmul(x, params["wq"], blocked)
    if "bq" in params:
        q = q + params["bq"].to(q.dtype)
    q = q.reshape(b, s, cfg.num_heads, cfg.head_dim_)
    if "q_norm" in params:
        q = norm(params["q_norm"], q, cfg.norm_eps, blocked)
    return q


def _project_kv(cfg, params, x, blocked: bool = False):
    b, s, _ = x.shape
    k = matmul(x, params["wk"], blocked)
    v = matmul(x, params["wv"], blocked)
    if "bk" in params:
        k = k + params["bk"].to(k.dtype)
        v = v + params["bv"].to(v.dtype)
    k = k.reshape(b, s, cfg.num_kv_heads, cfg.head_dim_)
    v = v.reshape(b, s, cfg.num_kv_heads, cfg.head_dim_)
    if "k_norm" in params:
        k = norm(params["k_norm"], k, cfg.norm_eps, blocked)
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
    qs = q.reshape(b, sq, hkv, g, dh).float() * attn_scale(dh)
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

def init_cache(cfg: ModelConfig, batch: int, max_seq: int, *, device,
               window: int = 0, dtype=None):
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


def cache_write_chunk(cache, k, v, positions):
    """Write a prefill chunk's K/V [B,C,...] at absolute ``positions``
    [B,C] into an existing cache, in place. Entries with position -1
    (chunk padding, rows not in this chunk call) leave the cache as it
    was, so the same call can extend some rows' prompts while other rows
    hold live decode state. The reference scatters them out of bounds,
    where they are dropped; PyTorch raises on an out-of-range index, so
    here they write a slot's own value back onto it, without a host sync.
    That slot must be one no real entry of the row writes: a chunk row
    holds one run of consecutive positions from column 0 (how the chunked
    plane builds it), so entry c of a row starting at position p0 goes to
    slot (p0 + c) % Sc, distinct for C <= Sc."""
    sc = cache["k"].shape[1]
    valid = positions >= 0
    cols = torch.arange(positions.shape[1], device=positions.device)
    slot = ((positions[:, :1].clamp(min=0) + cols) % sc).long()
    bidx = torch.arange(k.shape[0], device=k.device)[:, None]
    for name, new in (("k", k), ("v", v)):
        t = cache[name]
        t[bidx, slot] = torch.where(valid[..., None, None], new.to(t.dtype),
                                    t[bidx, slot])
    p = cache["pos"]
    p[bidx, slot] = torch.where(valid, positions.to(torch.int32),
                                p[bidx, slot])
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
# paged cache (block tables over a physical page pool)
# --------------------------------------------------------------------------
#
# Paged layer cache: {"k": [P+1, pt, Hkv, Dh], "v": [P+1, pt, Hkv, Dh],
# "pos": [P+1, pt] int32} plus one block table ``bt`` [B, nblk] int32
# shared by all layers, mapping logical block j of slot b to a physical
# page. Page 0 is the null page: never allocated, its positions -1
# forever, and every unmapped block points at it, so unmapped regions mask
# out exactly like an empty contiguous cache. The last page, P, is the
# sink: never mapped and never read, it takes the writes the reference
# drops out of bounds, so a paged write needs no host sync and never
# touches the null page. With nblk * pt == Sc the gathered view
# reproduces the contiguous layout element for element, which is what
# makes the paged engine bitwise equal to the contiguous one.


def paged_view(cache, bt):
    """The contiguous [B, nblk*pt, ...] view of a paged layer cache through
    the block table (a gather, not a view). Stale K/V under pos == -1
    entries is harmless: masked scores never read it."""
    k, v, pos = gather_pages(cache["k"], cache["v"], cache["pos"], bt)
    return {"k": k, "v": v, "pos": pos}


def paged_write_chunk(cache, bt, k, v, positions):
    """Paged twin of ``cache_write_chunk``: scatter chunk K/V [B,C,...] at
    absolute ``positions`` [B,C] through the block table, in place.
    Entries with position -1, and entries whose block maps to the null
    page, go to the sink page. A decode token's write is this at C = 1."""
    sink = cache["k"].shape[0] - 1
    pt = cache["k"].shape[1]
    spos = (positions.clamp(min=0) % (bt.shape[1] * pt)).long()
    page = torch.gather(bt, 1, spos // pt).long()
    page = torch.where((positions >= 0) & (page > 0), page, sink)
    off = spos % pt
    cache["k"][page, off] = k.to(cache["k"].dtype)
    cache["v"][page, off] = v.to(cache["v"].dtype)
    cache["pos"][page, off] = positions.to(torch.int32)
    return cache


# --------------------------------------------------------------------------
# layer-level apply
# --------------------------------------------------------------------------

def attn_full(cfg: ModelConfig, params, x, positions, *, window: int = 0,
              causal: bool = True, cache: Optional[dict] = None,
              blocked: bool = True):
    """Prefill and training path. Returns (out [B,S,D], cache written in
    place or None). With a cache the plain version's KV block is pinned
    to PREFILL_BLOCK_K, as in the reference. ``blocked`` (prefill) runs
    the projections in fixed row blocks; training runs them whole."""
    from repro_torch.kernels import ops as kops
    q = _project_q(cfg, params, x, blocked)
    k, v = _project_kv(cfg, params, x, blocked)
    q = apply_rope(q, positions, cfg.rope_theta)
    k = apply_rope(k, positions, cfg.rope_theta)
    bk = _pick_block(k.shape[1], PREFILL_BLOCK_K) if cache is not None else 0
    out = kops.full_attention(q, k, v, positions, positions, window=window,
                              softcap=cfg.attn_softcap, causal=causal,
                              block_k=bk)
    out = matmul(out.reshape(*x.shape[:2], -1), params["wo"], blocked)
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


def _chunk_qkv(cfg, params, x, positions):
    q = _project_q(cfg, params, x, blocked=True)
    k, v = _project_kv(cfg, params, x, blocked=True)
    return (apply_rope(q, positions, cfg.rope_theta),
            apply_rope(k, positions, cfg.rope_theta), v)


def _chunk_attend(cfg, params, x, q, view, positions, window: int = 0):
    from repro_torch.kernels import ops as kops
    out = kops.full_attention(
        q, view["k"], view["v"], positions, view["pos"], window=window,
        softcap=cfg.attn_softcap, causal=True,
        block_k=_pick_block(view["k"].shape[1], PREFILL_BLOCK_K))
    return matmul(out.reshape(*x.shape[:2], -1), params["wo"], True)


def attn_chunk(cfg: ModelConfig, params, x, cache, positions, *,
               window: int = 0):
    """Chunked-prefill path: x [B,C,D] extends each row's sequence at
    absolute ``positions`` [B,C] (-1 = chunk padding / row not in this
    chunk). The chunk's K/V are written into the cache first, then the chunk
    queries attend over the whole updated cache: causal masking by stored
    position covers both the committed prefix and the chunk itself.
    Returns (out [B,C,D], cache)."""
    q, k, v = _chunk_qkv(cfg, params, x, positions)
    cache = cache_write_chunk(cache, k, v, positions)
    return _chunk_attend(cfg, params, x, q, cache, positions,
                         window=window), cache


def attn_chunk_paged(cfg: ModelConfig, params, x, cache, bt, positions):
    """Chunked prefill over a paged layer cache: write the chunk's K/V
    through the block table, then attend over the gathered contiguous
    view with the same pinned KV block as ``attn_chunk``, so the result
    matches the contiguous engine exactly. Full attention only."""
    q, k, v = _chunk_qkv(cfg, params, x, positions)
    cache = paged_write_chunk(cache, bt, k, v, positions)
    return _chunk_attend(cfg, params, x, q, paged_view(cache, bt),
                         positions), cache


def attn_decode_paged(cfg: ModelConfig, params, x, cache, bt, pos):
    """Single-token decode over a paged layer cache: the attention reads
    the pages through the block table (the paged kernel on the card, a
    gather and the contiguous plain path on the CPU), then the token's
    K/V is written through the table."""
    from repro_torch.kernels import ops as kops
    b = x.shape[0]
    q = _project_q(cfg, params, x)
    k1, v1 = _project_kv(cfg, params, x)
    q = apply_rope(q, pos[:, None], cfg.rope_theta)
    k1 = apply_rope(k1, pos[:, None], cfg.rope_theta)
    out = kops.decode_attention_paged(
        q[:, 0], cache["k"], cache["v"], cache["pos"], bt, k1[:, 0],
        v1[:, 0], pos, softcap=cfg.attn_softcap)
    out = out.reshape(b, 1, -1) @ params["wo"]
    cache = paged_write_chunk(cache, bt, k1, v1, pos[:, None])
    return out, cache


def attn_cross(cfg: ModelConfig, params, x, cross_kv, blocked: bool = False,
               block_k: int = 0):
    """Cross attention (the Whisper decoder): full attention over the
    encoder's K/V, no RoPE on either side. Like the reference on every
    backend, it calls the plain ``blockwise_attention`` with
    ``causal=False`` and zero positions, on the card too. ``blocked``
    (prefill) runs the projections in fixed row blocks; ``block_k`` pins
    the plain version's KV block (0: the reference's automatic block, 4
    keys over 1,500 frames)."""
    b, s, _ = x.shape
    q = _project_q(cfg, params, x, blocked)
    k, v = cross_kv["k"], cross_kv["v"]
    q_pos = torch.zeros((b, s), dtype=torch.int32, device=x.device)
    k_pos = torch.zeros((b, k.shape[1]), dtype=torch.int32, device=x.device)
    out = blockwise_attention(q, k, v, q_pos, k_pos, causal=False,
                              softcap=cfg.attn_softcap, block_k=block_k)
    return matmul(out.reshape(b, s, -1), params["wo"], blocked)


def cross_kv_init(cfg: ModelConfig, params, enc_out, blocked: bool = True):
    """The decoder's cross-attention K/V from the encoder's output, once
    at prefill, in fixed row blocks (training: whole)."""
    k, v = _project_kv(cfg, params, enc_out, blocked)
    return {"k": k, "v": v}
