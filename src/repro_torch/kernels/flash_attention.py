"""Full-sequence (prefill) GQA attention: the CUDA kernel's wrapper.

The kernel (``csrc/flash_attention.cu``) replaces the TPU kernel
``repro/kernels/flash_attention.py::flash_attention``. Its plain version is
``models.attention.blockwise_attention``, the reference's CPU path. bfloat16
runs on the tensor cores (wgmma), float32 on the CUDA cores; the launches
of each are counted in ``path_launches``.
"""
from __future__ import annotations

import ctypes
import functools

import torch

from repro_torch.kernels import build

_P = ctypes.c_void_p
_I = ctypes.c_int
KERNEL = build.CudaKernel(
    "flash_attention", "flash_attention",
    [_P] * 6 + [_I] * 8 + [ctypes.c_float, _I, _P],
    replaces="src/repro/kernels/flash_attention.py:82")
#: the kernel's paths, in the order of the C source's codes
PATHS = ("tensor_core", "cuda_core")
#: launches per path, counted with ``KERNEL.launches``
path_launches = dict.fromkeys(PATHS, 0)


@functools.lru_cache(maxsize=None)
def _path(code: int) -> str:
    """The path the kernel takes for a dtype code, as it chooses it."""
    fn = build.library("flash_attention").flash_attention_path
    fn.argtypes = [_I]
    fn.restype = _I
    return PATHS[fn(code)]


def pair_mask(q_pos, k_pos, *, causal: bool = True, window: int = 0):
    """[B, Sq, Sk]: the (query, key) pairs a flash call attends to."""
    m = (k_pos[:, None, :] >= 0) & (q_pos[:, :, None] >= 0)
    if causal:
        m &= k_pos[:, None, :] <= q_pos[:, :, None]
    if window:
        m &= k_pos[:, None, :] > q_pos[:, :, None] - window
    return m


def work(q_pos, k_pos, h: int, hkv: int, dh: int, *, causal: bool = True,
         window: int = 0, el: int = 2):
    """(flops, bytes) of one flash call: the query rows with a position
    read and written, the keys of rows with a query read once (K and V),
    the positions; flops over the valid (query, key) pairs."""
    live = (q_pos >= 0).any(1)
    keys = int(((k_pos >= 0) & live[:, None]).sum().item())
    rows = int((q_pos >= 0).sum().item())
    pairs = int(pair_mask(q_pos, k_pos, causal=causal, window=window)
                .sum().item())
    nbytes = (2 * rows * h * dh + 2 * keys * hkv * dh) * el + \
        (q_pos.numel() + k_pos.numel()) * 4
    return 4.0 * pairs * h * dh, nbytes


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
    if h % hkv or not build.supports("flash_attention",
                                     "flash_attention_supports", dh):
        raise ValueError(f"flash_attention kernel takes H % Hkv == 0 and a "
                         f"head dim flash_attention_supports accepts; got "
                         f"H={h} Hkv={hkv} Dh={dh}")
    if k.dtype != q.dtype or v.dtype != q.dtype:
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
    build.count(functools.partial(_count_path, _path(code)))
    return out


def _count_path(path: str):
    path_launches[path] += 1
