"""Public kernel entry points, dispatched by the device of their input.

A CPU tensor takes the plain PyTorch version; a CUDA tensor launches the
hand-written kernel, and anything the kernel refuses raises. There is no
switch and no fallback: a CUDA tensor never takes the plain path.
"""
from __future__ import annotations

import torch

from repro_torch.kernels.decode_attention import (decode_attention_cuda,
                                                  decode_attention_plain)
from repro_torch.kernels.flash_attention import flash_attention_cuda
from repro_torch.kernels.moe_gemm import expert_ffn_cuda, expert_ffn_plain


def _on_cuda(t: torch.Tensor) -> bool:
    if t.is_cuda:
        return True
    if t.device.type == "cpu":
        return False
    raise RuntimeError(f"no kernel for device {t.device}")


def decode_attention(q, ck, cv, cpos, k1, v1, pos, *, window: int = 0,
                     softcap: float = 0.0):
    """Single-token GQA decode attention over cache + current token.
    q: [B,H,Dh]; ck/cv: [B,Sc,Hkv,Dh]; cpos: [B,Sc]; k1/v1: [B,Hkv,Dh];
    pos: [B]. Returns [B,H,Dh]."""
    fn = decode_attention_cuda if _on_cuda(q) else decode_attention_plain
    return fn(q, ck, cv, cpos, k1, v1, pos, window=window, softcap=softcap)


def full_attention(q, k, v, q_pos, k_pos, *, causal: bool = True,
                   window: int = 0, softcap: float = 0.0, block_k: int = 0):
    """Full-sequence (prefill) attention. ``block_k`` pins the KV block of
    the plain version's online softmax; the kernel's KV tile is fixed and
    independent of the padded extent."""
    if _on_cuda(q):
        return flash_attention_cuda(q, k, v, q_pos, k_pos, causal=causal,
                                    window=window, softcap=softcap)
    from repro_torch.models.attention import blockwise_attention
    return blockwise_attention(q, k, v, q_pos, k_pos, window=window,
                               softcap=softcap, causal=causal,
                               block_k=block_k)


def expert_ffn(x, w_gate, w_up, w_down, slot_expert, counts, *,
               act: str = "silu"):
    """x: [P,...,D] per-slot token batches -> [P,...,D]. Slot p runs the
    stored expert ``slot_expert[p]``; slots with ``counts == 0`` give 0."""
    shape = x.shape
    x3 = x.reshape(shape[0], -1, shape[-1])
    fn = expert_ffn_cuda if _on_cuda(x) else expert_ffn_plain
    return fn(x3, w_gate, w_up, w_down, slot_expert, counts,
              act=act).reshape(shape)
