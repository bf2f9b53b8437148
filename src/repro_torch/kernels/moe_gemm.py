"""Grouped MoE expert FFN: the CUDA kernel's wrapper and its plain version.

The kernel (``csrc/moe_gemm.cu``) replaces the TPU kernel
``repro/kernels/moe_gemm.py::moe_gemm``. Unlike the reference, whose model
path first gathers the physical slot bank (``shadow.resident_slot_bank``,
one copy of every slot's weights per layer per step), both versions here
take the stored per-expert bank plus ``slot_expert``: the kernel reads each
slot's rows in place, the plain version gathers. ``counts`` (routed tokens
per slot) makes empty slots produce 0 and, in the kernel, cost nothing.
"""
from __future__ import annotations

import ctypes

import torch

from repro_torch.core.shadow import resident_slot_bank
from repro_torch.kernels import build
from repro_torch.kernels import ref as kref

_P = ctypes.c_void_p
_I = ctypes.c_int
KERNEL = build.CudaKernel(
    "moe_gemm", "moe_ffn", [_P] * 8 + [_I] * 8 + [_P],
    replaces="src/repro/kernels/moe_gemm.py:72")
ACT_CODES = {"silu": 0, "gelu": 1}
#: the kernel's paths, in the order of the C source's codes
PATHS = ("skinny", "tensor_core", "cuda_core")
#: launches per path, counted with ``KERNEL.launches``
path_launches = dict.fromkeys(PATHS, 0)


def _workspace_floats(p: int, c: int, d: int, f: int, code: int,
                      decode: int) -> int:
    """Float32 scratch the launch needs (hidden activation and, on the
    decode path, split partials), as the CUDA source computes it."""
    fn = build.library("moe_gemm").moe_ffn_workspace
    fn.argtypes = [_I] * 6
    fn.restype = ctypes.c_longlong
    return int(fn(p, c, d, f, code, decode))


def _path(x, w_gate, w_up, w_down, p, c, d, f, gated, code, decode) -> str:
    """The path the kernel takes for these arguments, as it chooses it."""
    fn = build.library("moe_gemm").moe_ffn_path
    fn.argtypes = [_P] * 4 + [_I] * 7
    fn.restype = _I
    return PATHS[fn(build.ptr(x), build.ptr(w_gate), build.ptr(w_up),
                    build.ptr(w_down), p, c, d, f, gated, code, decode)]


def expert_ffn_plain(x, w_gate, w_up, w_down, slot_expert, counts, *,
                     act: str = "silu"):
    """x: [P,C,D]; w_gate/w_up: [E,D,F] stored bank (w_gate may be None);
    w_down: [E,F,D]; slot_expert/counts: [P] int. Returns [P,C,D]: slot p
    runs expert max(slot_expert[p], 0); slots with counts == 0 give 0."""
    bank = resident_slot_bank(
        {"wu": w_up, "wd": w_down} if w_gate is None else
        {"wg": w_gate, "wu": w_up, "wd": w_down}, slot_expert)
    y = kref.moe_gemm_ref(x, bank.get("wg"), bank["wu"], bank["wd"],
                          act=act)
    live = (counts > 0).reshape(-1, *([1] * (x.dim() - 1)))
    return torch.where(live, y, torch.zeros_like(y))


def expert_ffn_cuda(x, w_gate, w_up, w_down, slot_expert, counts, *,
                    decode: bool, act: str = "silu"):
    """Launch the CUDA kernel; same contract as ``expert_ffn_plain``.
    ``decode`` False (a prefill or chunk call) keeps the kernel off its
    skinny path, which rounds unlike the tile paths: a token's bits then
    do not depend on the capacity C of its call."""
    p, c, d = x.shape
    e, _, f = w_up.shape
    if w_up.shape != (e, d, f) or w_down.shape != (e, f, d) or \
            (w_gate is not None and w_gate.shape != w_up.shape) or \
            slot_expert.shape != (p,) or counts.shape != (p,):
        raise ValueError("expert_ffn: inconsistent shapes "
                         f"x{tuple(x.shape)} w_up{tuple(w_up.shape)} "
                         f"w_down{tuple(w_down.shape)} "
                         f"slot_expert{tuple(slot_expert.shape)}")
    ws = [w for w in (w_gate, w_up, w_down) if w is not None]
    if any(w.dtype != x.dtype for w in ws):
        raise TypeError("expert_ffn: x and the expert bank must share one "
                        "dtype")
    code = build.dtype_code(x)
    x = x.contiguous()
    w_up, w_down = w_up.contiguous(), w_down.contiguous()
    w_gate = w_up if w_gate is None else w_gate.contiguous()
    slot_expert = slot_expert.to(torch.int32).contiguous()
    counts = counts.to(torch.int32).contiguous()
    dec = int(bool(decode))
    workspace = torch.empty((_workspace_floats(p, c, d, f, code, dec),),
                            dtype=torch.float32, device=x.device)
    y = torch.empty_like(x)
    gated = int(len(ws) == 3)
    path = _path(x, w_gate, w_up, w_down, p, c, d, f, gated, code, dec)
    KERNEL(build.ptr(x), build.ptr(w_gate), build.ptr(w_up),
           build.ptr(w_down), build.ptr(slot_expert), build.ptr(counts),
           build.ptr(workspace), build.ptr(y), p, c, d, f, gated,
           ACT_CODES[act], code, dec, build.stream_ptr(x))
    path_launches[path] += 1
    return y
