"""GQA decode attention over a contiguous cache and over page pools: the
CUDA kernels' wrappers and their plain versions.

The three kernels live in ``csrc/decode_attention.cu``, which replaces
the TPU kernels ``repro/kernels/decode_attention.py::
decode_attention_fused``, ``::decode_attention_paged`` and
``::decode_attention_partial``. In bfloat16 all three split the cache
across blocks (a fixed number of logical positions each) and the last
block of each (kv-head, row) merges the splits' partials in split order,
then finishes (fused, paged) or writes the merged partials (partial): the
wrapper hands each call one scratch buffer (``torch.empty``, sized by the
shapes alone) for the float32 partials and the int32 ticket counters that
the launch zeroes on the call's stream, so a call never syncs with the
host and can be captured in a CUDA graph.

The plain versions are the reference's CPU path: cache partials
(``ref.decode_attention_partial_ref``, the partial kernel's plain version)
then ``combine_decode_partials``; the paged one gathers the pages through
the block table first. ``merge_split_partials`` merges the partials of
consecutive ranges of a cache as the bf16 kernels merge their splits,
for the tests and ``chip_smoke.py``.
"""
from __future__ import annotations

import ctypes

import numpy as np
import torch

from repro_torch.kernels import build
from repro_torch.kernels import ref as kref

_P = ctypes.c_void_p
_I = ctypes.c_int
KERNEL = build.CudaKernel(
    "decode_attention", "decode_attention_fused",
    [_P] * 9 + [_I] * 6 + [ctypes.c_float, _I, _P],
    replaces="src/repro/kernels/decode_attention.py:317")
PAGED_KERNEL = build.CudaKernel(
    "decode_attention", "decode_attention_paged",
    [_P] * 10 + [_I] * 6 + [ctypes.c_float, _I, _P],
    replaces="src/repro/kernels/decode_attention.py:257")
PARTIAL_KERNEL = build.CudaKernel(
    "decode_attention", "decode_attention_partial",
    [_P] * 9 + [_I] * 6 + [ctypes.c_float, _I, _P],
    replaces="src/repro/kernels/decode_attention.py:78")


def valid_keys(cpos, pos, window: int = 0):
    """The [B, Sc] mask of cache entries a decode row attends to."""
    ok = (cpos >= 0) & (cpos <= pos[:, None])
    if window:
        ok &= cpos > pos[:, None] - window
    return ok


def fused_work(q, k1, cpos, valid: int):
    """(flops, bytes) of one fused decode call with ``valid`` cache keys
    attended in all: q read and the output written, each valid key's K
    and V read once, the new token's k1/v1, the positions."""
    b, h, dh = q.shape
    hkv, el = k1.shape[1], q.element_size()
    nbytes = (2 * q.numel() + 2 * valid * hkv * dh + 2 * k1.numel()) * el \
        + cpos.numel() * 4 + b * 4
    return 4.0 * (valid + b) * h * dh, nbytes


def paged_reads(bt, ok, pt: int):
    """(distinct (page, offset) entries read, pages read) of a paged
    decode call: ``ok`` [B, nblk * pt] flags the valid entries of each
    row's block-table view."""
    bt_h, ok_h = bt.cpu().numpy(), ok.cpu().numpy()
    page = bt_h.repeat(pt, axis=1)
    off = np.tile(np.arange(pt), bt_h.shape[1])[None].repeat(len(bt_h), 0)
    uniq = len(set(zip(page[ok_h].tolist(), off[ok_h].tolist())))
    return uniq, len(set(bt_h[bt_h > 0].tolist()))


def paged_work(q, k1, bt, pt: int, valid: int, uniq: int, pages: int):
    """(flops, bytes) of one paged decode call: as ``fused_work``, with
    each distinct (page, offset) entry read once, and the positions of the
    ``pages`` pages read and the block table."""
    b, h, dh = q.shape
    hkv, el = k1.shape[1], q.element_size()
    nbytes = (2 * q.numel() + 2 * uniq * hkv * dh + 2 * k1.numel()) * el \
        + (pages * pt + bt.numel() + b) * 4
    return 4.0 * (valid + b) * h * dh, nbytes


def partial_work(q, cpos, hkv: int, valid: int):
    """(flops, bytes) of one partial decode call: q and the valid keys'
    K and V in bf16, the positions, and the float32 (m, l, acc) out."""
    b, h, dh = q.shape
    nbytes = (q.numel() + 2 * valid * hkv * dh) * 2 + \
        (cpos.numel() + b) * 4 + (2 * b * h + b * h * dh) * 4
    return 4.0 * valid * h * dh, nbytes


def combine_decode_partials(q, m, l, acc, k1, v1, *, softcap: float = 0.0):
    """Fold the current token's self-attention into cache partials
    (m, l, acc) and normalise. q: [B,H,Dh]; k1/v1: [B,Hkv,Dh]."""
    b, h, dh = q.shape
    hkv = k1.shape[1]
    g = h // hkv
    qs = (q.float() * kref.attn_scale(dh)).reshape(b, hkv, g, dh)
    s_self = torch.einsum("bhgd,bhd->bhg", qs, k1.float())
    if softcap:
        s_self = torch.tanh(s_self / softcap) * softcap
    m_new = torch.maximum(m, s_self)
    corr = torch.exp(m - m_new)
    p_self = torch.exp(s_self - m_new)
    l_new = l * corr + p_self
    acc_new = acc * corr[..., None] + p_self[..., None] * \
        v1.float()[:, :, None, :]
    out = acc_new / torch.clamp(l_new[..., None], min=1e-30)
    return out.reshape(b, h, dh).to(q.dtype)


def merge_split_partials(parts):
    """Partials (m, l, acc) of consecutive ranges of one cache, merged in
    range order as the bf16 kernels' last block merges its splits: the
    largest m first, then the sums from range 0 up, a range whose m is
    NEG_INF (no valid key) skipped."""
    m = parts[0][0]
    for pm, _, _ in parts[1:]:
        m = torch.maximum(m, pm)
    l = torch.zeros_like(parts[0][1])
    acc = torch.zeros_like(parts[0][2])
    for pm, pl, pa in parts:
        live = pm != kref.NEG_INF
        c = torch.where(live, torch.exp(pm - m), torch.zeros_like(pm))
        l = torch.where(live, l + pl * c, l)
        acc = torch.where(live[..., None], acc + pa * c[..., None], acc)
    return m, l, acc


def decode_attention_plain(q, ck, cv, cpos, k1, v1, pos, *, window: int = 0,
                           softcap: float = 0.0):
    """Plain PyTorch version of the kernel (any device)."""
    m, l, acc = kref.decode_attention_partial_ref(
        q, ck, cv, cpos, pos, window=window, softcap=softcap)
    return combine_decode_partials(q, m, l, acc, k1, v1, softcap=softcap)


def gather_pages(pk, pv, ppos, bt):
    """The contiguous view [B, nblk*pt, ...] of page pools through the
    block table [B, nblk]."""
    b, nblk = bt.shape
    pt = pk.shape[1]
    flat = bt.reshape(-1).long()
    return (pk[flat].reshape(b, nblk * pt, *pk.shape[2:]),
            pv[flat].reshape(b, nblk * pt, *pv.shape[2:]),
            ppos[flat].reshape(b, nblk * pt))


def decode_attention_paged_plain(q, pk, pv, ppos, bt, k1, v1, pos, *,
                                 softcap: float = 0.0):
    """Plain PyTorch version of the paged kernel (any device): gather the
    pages, then the contiguous plain path."""
    ck, cv, cpos = gather_pages(pk, pv, ppos, bt)
    return decode_attention_plain(q, ck, cv, cpos, k1, v1, pos,
                                  softcap=softcap)


def decode_attention_partial_plain(q, ck, cv, cpos, pos, *,
                                   window: int = 0, softcap: float = 0.0):
    """Plain PyTorch version of the partial kernel (any device): the
    reference's ``decode_attention_partial_ref``."""
    return kref.decode_attention_partial_ref(q, ck, cv, cpos, pos,
                                             window=window, softcap=softcap)


def _check_heads(name, h, hkv, dh, partial=False):
    """Raise unless the kernels are built for (Dh, G = H / Hkv): the
    table is the CUDA source's, read through decode_attention_supports."""
    if h % hkv or not build.supports("decode_attention",
                                     "decode_attention_supports", dh,
                                     h // hkv, int(partial)):
        raise ValueError(f"{name} kernel is not built for H={h} Hkv={hkv} "
                         f"Dh={dh} (see decode_attention_supports in "
                         f"csrc/decode_attention.cu)")


def _check_cache(name, q, ck, cv, cpos, pos, partial=False):
    b, h, dh = q.shape
    sc, hkv = ck.shape[1], ck.shape[2]
    if ck.shape != (b, sc, hkv, dh) or cv.shape != ck.shape or \
            cpos.shape != (b, sc) or pos.shape != (b,):
        raise ValueError(f"{name}: inconsistent shapes q{tuple(q.shape)} "
                         f"ck{tuple(ck.shape)} cv{tuple(cv.shape)} "
                         f"cpos{tuple(cpos.shape)} pos{tuple(pos.shape)}")
    _check_heads(name, h, hkv, dh, partial)


def _scratch(q, b, h, hkv, dh, sc, code,
             query="decode_attention_workspace"):
    """A null pointer where the call takes no scratch (float32), else the
    bf16 kernels' scratch for one call: 4-byte words, as many as the
    source's ``query`` says."""
    n = build.size("decode_attention", query, b, h, hkv, dh, sc, code)
    if not n:
        return _P(None), None
    ws = torch.empty(n, dtype=torch.float32, device=q.device)
    return build.ptr(ws), ws


def decode_attention_cuda(q, ck, cv, cpos, k1, v1, pos, *, window: int = 0,
                          softcap: float = 0.0):
    """Launch the CUDA kernel. q: [B,H,Dh]; ck/cv: [B,Sc,Hkv,Dh];
    cpos: [B,Sc] int32; k1/v1: [B,Hkv,Dh]; pos: [B] int32. Returns
    [B,H,Dh] in q's dtype."""
    b, h, dh = q.shape
    sc, hkv = ck.shape[1], ck.shape[2]
    _check_cache("decode_attention", q, ck, cv, cpos, pos)
    if k1.shape != (b, hkv, dh) or v1.shape != k1.shape:
        raise ValueError(f"decode_attention: k1{tuple(k1.shape)} and "
                         f"v1{tuple(v1.shape)} must be {(b, hkv, dh)}")
    if len({t.dtype for t in (q, ck, cv, k1, v1)}) != 1:
        raise TypeError("decode_attention: q, cache and k1/v1 must share "
                        "one dtype")
    code = build.dtype_code(q)
    q, ck, cv, k1, v1 = (t.contiguous() for t in (q, ck, cv, k1, v1))
    cpos = cpos.to(torch.int32).contiguous()
    pos = pos.to(torch.int32).contiguous()
    out = torch.empty_like(q)
    ws_ptr, _ws = _scratch(q, b, h, hkv, dh, sc, code)
    KERNEL(build.ptr(q), build.ptr(ck), build.ptr(cv), build.ptr(cpos),
           build.ptr(k1), build.ptr(v1), build.ptr(pos), build.ptr(out),
           ws_ptr, b, h, hkv, dh, sc, int(window), float(softcap), code,
           build.stream_ptr(q))
    return out


def decode_attention_paged_cuda(q, pk, pv, ppos, bt, k1, v1, pos, *,
                                softcap: float = 0.0):
    """Launch the paged CUDA kernel. q: [B,H,Dh]; pk/pv: [P,pt,Hkv,Dh];
    ppos: [P,pt] int32; bt: [B,nblk] int32, entries in [0, P) (0 = the
    null page); k1/v1: [B,Hkv,Dh]; pos: [B] int32. pt must be a multiple
    of 4. Returns [B,H,Dh] in q's dtype."""
    b, h, dh = q.shape
    npg, pt, hkv = pk.shape[0], pk.shape[1], pk.shape[2]
    nblk = bt.shape[1] if bt.dim() == 2 else -1
    if pk.shape != (npg, pt, hkv, dh) or pv.shape != pk.shape or \
            ppos.shape != (npg, pt) or bt.shape != (b, nblk) or \
            k1.shape != (b, hkv, dh) or v1.shape != k1.shape or \
            pos.shape != (b,):
        raise ValueError("decode_attention_paged: inconsistent shapes "
                         f"q{tuple(q.shape)} pk{tuple(pk.shape)} "
                         f"ppos{tuple(ppos.shape)} bt{tuple(bt.shape)} "
                         f"k1{tuple(k1.shape)}")
    _check_heads("decode_attention_paged", h, hkv, dh)
    if pt % 4:
        raise ValueError(f"decode_attention_paged kernel takes page_tokens "
                         f"a multiple of 4; got {pt}")
    if len({t.dtype for t in (q, pk, pv, k1, v1)}) != 1:
        raise TypeError("decode_attention_paged: q, pools and k1/v1 must "
                        "share one dtype")
    if bt.dtype != torch.int32 or ppos.dtype != torch.int32:
        raise TypeError("decode_attention_paged: bt and ppos must be int32")
    code = build.dtype_code(q)
    q, pk, pv, k1, v1, ppos, bt = (t.contiguous() for t in
                                   (q, pk, pv, k1, v1, ppos, bt))
    pos = pos.to(torch.int32).contiguous()
    out = torch.empty_like(q)
    ws_ptr, _ws = _scratch(q, b, h, hkv, dh, nblk * pt, code)
    PAGED_KERNEL(build.ptr(q), build.ptr(pk), build.ptr(pv), build.ptr(ppos),
                 build.ptr(bt), build.ptr(k1), build.ptr(v1), build.ptr(pos),
                 build.ptr(out), ws_ptr, b, h, hkv, dh, pt, nblk,
                 float(softcap), code, build.stream_ptr(q))
    return out


def decode_attention_partial_cuda(q, ck, cv, cpos, pos, *, window: int = 0,
                                  softcap: float = 0.0):
    """Launch the partial CUDA kernel. q: [B,H,Dh] (unscaled); ck/cv:
    [B,Sc,Hkv,Dh]; cpos: [B,Sc] int32; pos: [B] int32. Returns (m
    [B,Hkv,G], l [B,Hkv,G], acc [B,Hkv,G,Dh]) in float32; a row with no
    valid key gives m = -1e30, l = 0, acc = 0. In bf16 they are the
    merged split partials that the fused kernel folds (k1, v1) into."""
    b, h, dh = q.shape
    sc, hkv = ck.shape[1], ck.shape[2]
    _check_cache("decode_attention_partial", q, ck, cv, cpos, pos,
                 partial=True)
    if len({t.dtype for t in (q, ck, cv)}) != 1:
        raise TypeError("decode_attention_partial: q and the cache must "
                        "share one dtype")
    code = build.dtype_code(q)
    q, ck, cv = (t.contiguous() for t in (q, ck, cv))
    cpos = cpos.to(torch.int32).contiguous()
    pos = pos.to(torch.int32).contiguous()
    g = h // hkv
    m = torch.empty((b, hkv, g), dtype=torch.float32, device=q.device)
    l = torch.empty_like(m)
    acc = torch.empty((b, hkv, g, dh), dtype=torch.float32, device=q.device)
    ws_ptr, _ws = _scratch(q, b, h, hkv, dh, sc, code,
                           "decode_attention_partial_workspace")
    PARTIAL_KERNEL(build.ptr(q), build.ptr(ck), build.ptr(cv),
                   build.ptr(cpos), build.ptr(pos), build.ptr(m),
                   build.ptr(l), build.ptr(acc), ws_ptr, b, h, hkv, dh, sc,
                   int(window), float(softcap), code, build.stream_ptr(q))
    return m, l, acc
