"""Mamba2 / SSD chunked scan: the CUDA kernel's wrapper.

The kernel (``csrc/ssm_scan.cu``) replaces the TPU kernel
``repro/kernels/ssm_scan.py::ssm_scan``. Its plain versions are
``ref.ssm_scan_chunked_ref`` and ``ref.ssm_scan_ref``.
"""
from __future__ import annotations

import ctypes

import torch

from repro_torch.kernels import build
from repro_torch.kernels.ref import scan_chunk

_P = ctypes.c_void_p
_I = ctypes.c_int
KERNEL = build.CudaKernel(
    "ssm_scan", "ssm_scan", [_P] * 7 + [_I] * 7 + [_P],
    replaces="src/repro/kernels/ssm_scan.py:75")
MAX_DIM = 64          # the kernel's largest chunk length, P and N


def work(bs: int, s: int, h: int, p: int, n: int, chunk: int):
    """(flops, bytes) of one SSD scan: x read and y written (bf16), the
    float32 final state, dt, B, C and A; per (b, h, chunk of t) the causal
    (i >= j) half of C B^T and of W x, then C h^T and the state update."""
    t = scan_chunk(s, chunk)
    nbytes = 2 * bs * s * h * p * 2 + bs * h * p * n * 4 + \
        (bs * s * h + 2 * bs * s * n + h) * 4
    flops = 2.0 * bs * h * (s // t) * (t * (t + 1) // 2 * (n + p) +
                                       2 * t * n * p)
    return flops, nbytes


def ssm_scan_cuda(x, dt, a, b, c, *, chunk: int = 64):
    """Launch the CUDA kernel. x: [B,S,H,P] float32 or bfloat16; dt:
    [B,S,H]; a: [H]; b, c: [B,S,N] (cast to float32). Zero initial state.
    Returns (y [B,S,H,P] in x's dtype, h_final [B,H,P,N] float32)."""
    bs, s, h, p = x.shape
    n = b.shape[-1]
    if dt.shape != (bs, s, h) or a.shape != (h,) or \
            b.shape != (bs, s, n) or c.shape != b.shape:
        raise ValueError("ssm_scan: inconsistent shapes "
                         f"x{tuple(x.shape)} dt{tuple(dt.shape)} "
                         f"a{tuple(a.shape)} b{tuple(b.shape)} "
                         f"c{tuple(c.shape)}")
    t = scan_chunk(s, chunk)
    if max(t, p, n) > MAX_DIM:
        raise ValueError(f"ssm_scan kernel takes chunk, P and N <= "
                         f"{MAX_DIM}; got chunk={t} P={p} N={n}")
    code = build.dtype_code(x)
    x = x.contiguous()
    dt, a, b, c = (v.float().contiguous() for v in (dt, a, b, c))
    y = torch.empty_like(x)
    hf = torch.empty((bs, h, p, n), dtype=torch.float32, device=x.device)
    KERNEL(build.ptr(x), build.ptr(dt), build.ptr(a), build.ptr(b),
           build.ptr(c), build.ptr(y), build.ptr(hf), bs, s, h, p, n, t,
           code, build.stream_ptr(x))
    return y, hf
