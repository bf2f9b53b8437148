"""Public kernel entry points, dispatched by the device of their input.

A CPU tensor takes the plain PyTorch version; a CUDA tensor launches the
hand-written kernel, and anything the kernel refuses raises. There is no
switch and no fallback: a CUDA tensor never takes the plain path.
"""
from __future__ import annotations

import torch

from repro_torch.kernels.decode_attention import (
    decode_attention_cuda, decode_attention_paged_cuda,
    decode_attention_paged_plain, decode_attention_partial_cuda,
    decode_attention_partial_plain, decode_attention_plain)
from repro_torch.kernels.flash_attention import flash_attention_cuda
from repro_torch.kernels.moe_gemm import expert_ffn_cuda, expert_ffn_plain
from repro_torch.kernels.ref import ssm_scan_chunked_ref, ssm_scan_ref
from repro_torch.kernels.ssm_scan import ssm_scan_cuda


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


def decode_attention_partial(q, ck, cv, cpos, pos, *, window: int = 0,
                             softcap: float = 0.0):
    """Online-softmax partials of one query token per row against the
    cache, with no self term and no normalising (for a caller that
    combines them: ``decode_attention.combine_decode_partials``). q:
    [B,H,Dh] (unscaled); ck/cv: [B,Sc,Hkv,Dh]; cpos: [B,Sc]; pos: [B].
    Returns (m, l [B,Hkv,G], acc [B,Hkv,G,Dh]) in float32."""
    fn = decode_attention_partial_cuda if _on_cuda(q) \
        else decode_attention_partial_plain
    return fn(q, ck, cv, cpos, pos, window=window, softcap=softcap)


def decode_attention_paged(q, pk, pv, ppos, bt, k1, v1, pos, *,
                           softcap: float = 0.0):
    """Single-token GQA decode attention over a paged cache + current token.
    q: [B,H,Dh]; pk/pv: [P,pt,Hkv,Dh] page pools; ppos: [P,pt]; bt:
    [B,nblk] block table (page 0 = the null page, positions all -1);
    k1/v1: [B,Hkv,Dh]; pos: [B]. Full attention only. Returns [B,H,Dh]."""
    fn = decode_attention_paged_cuda if _on_cuda(q) \
        else decode_attention_paged_plain
    return fn(q, pk, pv, ppos, bt, k1, v1, pos, softcap=softcap)


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
               decode: bool, act: str = "silu"):
    """x: [P,...,D] per-slot token batches -> [P,...,D]. Slot p runs the
    stored expert ``slot_expert[p]``; slots with ``counts == 0`` give 0.
    ``decode`` says which kind of call this is: only a decode step may
    take the kernel's skinny path, so every prefill and chunk call rounds
    its tokens one way whatever its capacity."""
    shape = x.shape
    x3 = x.reshape(shape[0], -1, shape[-1])
    if _on_cuda(x):
        y = expert_ffn_cuda(x3, w_gate, w_up, w_down, slot_expert, counts,
                            act=act, decode=decode)
    else:
        y = expert_ffn_plain(x3, w_gate, w_up, w_down, slot_expert, counts,
                             act=act)
    return y.reshape(shape)


def ssm_scan(x, dt, a, b, c, *, chunk: int = 64):
    """Full-sequence SSD scan from a zero state. x: [B,S,H,P]; dt:
    [B,S,H]; a: [H]; b, c: [B,S,N]. Returns (y [B,S,H,P], h_final
    [B,H,P,N] float32). The kernel runs at every S on the card; the CPU
    takes the chunked plain form for S > 1 and the sequential one for a
    single step, as the reference does."""
    if _on_cuda(x):
        return ssm_scan_cuda(x, dt, a, b, c, chunk=chunk)
    if x.shape[1] > 1:
        return ssm_scan_chunked_ref(x, dt, a, b, c, chunk=chunk)
    return ssm_scan_ref(x, dt, a, b, c)
