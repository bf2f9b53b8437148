"""Full-sequence (prefill) GQA attention: the CUDA kernel's wrapper.

The kernel (``csrc/flash_attention.cu``) replaces the TPU kernel
``repro/kernels/flash_attention.py::flash_attention``. Its plain version is
``models.attention.blockwise_attention``, the reference's CPU path.
"""
from __future__ import annotations

import ctypes

import torch

from repro_torch.kernels import build

_P = ctypes.c_void_p
_I = ctypes.c_int
KERNEL = build.CudaKernel(
    "flash_attention", "flash_attention",
    [_P] * 6 + [_I] * 8 + [ctypes.c_float, _I, _P],
    replaces="src/repro/kernels/flash_attention.py:82")


def flash_attention_cuda(q, k, v, q_pos, k_pos, *, causal: bool = True,
                         window: int = 0, softcap: float = 0.0):
    """q: [B,Sq,H,Dh]; k,v: [B,Sk,Hkv,Dh]; *_pos: [B,Sq]/[B,Sk] int32
    (-1 = invalid). Returns [B,Sq,H,Dh] in q's dtype; rows with no valid
    key are 0."""
    b, sq, h, dh = q.shape
    sk, hkv = k.shape[1], k.shape[2]
    if k.shape != (b, sk, hkv, dh) or v.shape != k.shape or \
            q_pos.shape != (b, sq) or k_pos.shape != (b, sk):
        raise ValueError("flash_attention: inconsistent shapes "
                         f"q{tuple(q.shape)} k{tuple(k.shape)} "
                         f"q_pos{tuple(q_pos.shape)} "
                         f"k_pos{tuple(k_pos.shape)}")
    if h % hkv or dh not in (32, 64, 128):
        raise ValueError(f"flash_attention kernel takes H % Hkv == 0 and "
                         f"Dh in (32, 64, 128); got H={h} Hkv={hkv} Dh={dh}")
    if len({t.dtype for t in (q, k, v)}) != 1:
        raise TypeError("flash_attention: q, k and v must share one dtype")
    code = build.dtype_code(q)
    q, k, v = q.contiguous(), k.contiguous(), v.contiguous()
    q_pos = q_pos.to(torch.int32).contiguous()
    k_pos = k_pos.to(torch.int32).contiguous()
    out = torch.empty_like(q)
    KERNEL(build.ptr(q), build.ptr(k), build.ptr(v), build.ptr(q_pos),
           build.ptr(k_pos), build.ptr(out), b, sq, sk, h, hkv, dh,
           int(bool(causal)), int(window), float(softcap), code,
           build.stream_ptr(q))
    return out
