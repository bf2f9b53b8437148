"""Fused GQA decode attention: the CUDA kernel's wrapper and its plain
version.

The kernel (``csrc/decode_attention.cu``) replaces the TPU kernel
``repro/kernels/decode_attention.py::decode_attention_fused``. The plain
version is the reference's CPU path: cache partials
(``ref.decode_attention_partial_ref``) then ``combine_decode_partials``.
"""
from __future__ import annotations

import ctypes

import torch

from repro_torch.kernels import build
from repro_torch.kernels import ref as kref

_P = ctypes.c_void_p
_I = ctypes.c_int
KERNEL = build.CudaKernel(
    "decode_attention", "decode_attention_fused",
    [_P] * 8 + [_I] * 6 + [ctypes.c_float, _I, _P],
    replaces="src/repro/kernels/decode_attention.py:317")


def combine_decode_partials(q, m, l, acc, k1, v1, *, softcap: float = 0.0):
    """Fold the current token's self-attention into cache partials
    (m, l, acc) and normalise. q: [B,H,Dh]; k1/v1: [B,Hkv,Dh]."""
    b, h, dh = q.shape
    hkv = k1.shape[1]
    g = h // hkv
    qs = (q.float() * kref.attn_scale(dh, q.device)).reshape(b, hkv, g, dh)
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


def decode_attention_plain(q, ck, cv, cpos, k1, v1, pos, *, window: int = 0,
                           softcap: float = 0.0):
    """Plain PyTorch version of the kernel (any device)."""
    m, l, acc = kref.decode_attention_partial_ref(
        q, ck, cv, cpos, pos, window=window, softcap=softcap)
    return combine_decode_partials(q, m, l, acc, k1, v1, softcap=softcap)


def decode_attention_cuda(q, ck, cv, cpos, k1, v1, pos, *, window: int = 0,
                          softcap: float = 0.0):
    """Launch the CUDA kernel. q: [B,H,Dh]; ck/cv: [B,Sc,Hkv,Dh];
    cpos: [B,Sc] int32; k1/v1: [B,Hkv,Dh]; pos: [B] int32. Returns
    [B,H,Dh] in q's dtype."""
    b, h, dh = q.shape
    sc, hkv = ck.shape[1], ck.shape[2]
    if ck.shape != (b, sc, hkv, dh) or cv.shape != ck.shape or \
            k1.shape != (b, hkv, dh) or v1.shape != k1.shape or \
            cpos.shape != (b, sc) or pos.shape != (b,):
        raise ValueError("decode_attention: inconsistent shapes "
                         f"q{tuple(q.shape)} ck{tuple(ck.shape)} "
                         f"cpos{tuple(cpos.shape)} k1{tuple(k1.shape)}")
    if h % hkv or h // hkv not in (1, 2, 4, 8) or dh not in (32, 64, 128):
        raise ValueError(f"decode_attention kernel takes G = H / Hkv in "
                         f"(1, 2, 4, 8) and Dh in (32, 64, 128); got H={h} "
                         f"Hkv={hkv} Dh={dh}")
    if len({t.dtype for t in (q, ck, cv, k1, v1)}) != 1:
        raise TypeError("decode_attention: q, cache and k1/v1 must share "
                        "one dtype")
    code = build.dtype_code(q)
    q, ck, cv, k1, v1 = (t.contiguous() for t in (q, ck, cv, k1, v1))
    cpos = cpos.to(torch.int32).contiguous()
    pos = pos.to(torch.int32).contiguous()
    out = torch.empty_like(q)
    KERNEL(build.ptr(q), build.ptr(ck), build.ptr(cv), build.ptr(cpos),
           build.ptr(k1), build.ptr(v1), build.ptr(pos), build.ptr(out),
           b, h, hkv, dh, sc, int(window), float(softcap), code,
           build.stream_ptr(q))
    return out
