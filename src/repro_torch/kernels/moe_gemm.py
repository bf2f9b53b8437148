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
import functools

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
#: the kernel's paths, in the order of the C source's codes ("skinny" is
#: the decode path: bf16 decode steps at C <= 8, float32 at C <= 4)
PATHS = ("skinny", "tensor_core", "cuda_core")
#: launches per path, counted with ``KERNEL.launches``
path_launches = dict.fromkeys(PATHS, 0)
#: the path of the last call (a CUDA graph capture counts its launch only
#: on replay, so an observer of the call cannot read it off the counts)
last_path = None
#: (P, C, D, F, dtype code, decode, gated, x aligned, weights aligned) ->
#: (float32 workspace elements, path), as the C source computes them
_plans: dict = {}


@functools.lru_cache(maxsize=None)
def _path_fn():
    fn = build.library("moe_gemm").moe_ffn_path
    fn.argtypes = [_P] * 4 + [_I] * 7
    fn.restype = _I
    return fn


def tensor_maps_encoded() -> int:
    """Tensor maps of expert banks the decode path has made in this
    process (the C source keeps 256, three a MoE layer): a count that
    stops growing once every bank of a served model was met shows the
    cache holds them all."""
    fn = build.library("moe_gemm").moe_ffn_tensor_maps
    fn.argtypes = []
    fn.restype = ctypes.c_longlong
    return int(fn())


def _plan(ptrs, p, c, d, f, gated, code, dec):
    """The workspace size and path of a launch, asked of the C source once
    per shape, kind and alignment (16-byte alignment of x and of the
    weights is all the path reads of the pointers)."""
    key = (p, c, d, f, code, dec, gated, ptrs[0] % 16 == 0,
           (ptrs[1] | ptrs[2] | ptrs[3]) % 16 == 0)
    plan = _plans.get(key)
    if plan is None:
        plan = _plans[key] = (
            build.size("moe_gemm", "moe_ffn_workspace", p, c, d, f, code,
                       dec),
            PATHS[_path_fn()(*ptrs, p, c, d, f, gated, code, dec)])
    return plan


def work(p: int, c: int, d: int, f: int, live: int, experts: int,
         el: int = 2):
    """(flops, bytes) of one expert FFN call over P slots of capacity C:
    each of the ``live`` slots with a token runs its C rows through three
    D x F matrices (the kernel skips the others); each of the ``experts``
    distinct experts those slots read has its three matrices read once,
    the live slots' rows are read, the whole output written, and the slot
    table read."""
    nbytes = (experts * 3 * d * f + live * c * d + p * c * d) * el + 2 * p * 4
    return live * 2.0 * c * d * f * 3, nbytes


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
    decode path ("skinny"), which rounds unlike the tile paths: a token's
    bits then do not depend on the capacity C of its call."""
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
    if slot_expert.dtype != torch.int32:
        slot_expert = slot_expert.to(torch.int32)
    if counts.dtype != torch.int32:
        counts = counts.to(torch.int32)
    slot_expert, counts = slot_expert.contiguous(), counts.contiguous()
    dec = int(bool(decode))
    gated = int(len(ws) == 3)
    ptrs = (x.data_ptr(), w_gate.data_ptr(), w_up.data_ptr(),
            w_down.data_ptr())
    floats, path = _plan(ptrs, p, c, d, f, gated, code, dec)
    workspace = torch.empty((floats,), dtype=torch.float32, device=x.device)
    y = torch.empty_like(x)
    KERNEL(*ptrs, slot_expert.data_ptr(), counts.data_ptr(),
           workspace.data_ptr(), y.data_ptr(), p, c, d, f, gated,
           ACT_CODES[act], code, dec, build.stream_ptr(x))
    global last_path
    last_path = path
    build.count(functools.partial(_count_path, path))
    return y


def _count_path(path: str):
    path_launches[path] += 1
