"""Public kernel entry points, dispatched by the device of their input.

A CPU tensor takes the plain PyTorch version; a CUDA tensor launches the
hand-written kernel, and anything the kernel refuses raises. There is no
switch and no fallback: a CUDA tensor never takes the plain path.

Gradients. The kernels compute forward passes only, as the reference's
Pallas kernels do (its ``kernels/ops.py`` has no ``custom_vjp``). Where a
CUDA call of flash, the expert FFN or the SSD scan needs a gradient (grad
mode on and an input that requires one), it goes through
``KernelWithPlainGrad``: the forward pass launches the kernel, and the
backward pass recomputes the kernel's plain version on the saved inputs
and differentiates that. A call that needs no gradient (every serving
path) calls the kernel directly, as before.

Op counts. A launch on the card reports its flops and bytes to an active
``roofline.op_count.OpCounter`` (the kernel modules' ``work`` formulas);
with none active the report does nothing.
"""
from __future__ import annotations

import functools

import torch
from torch.distributed.tensor import DTensor

from repro_torch.kernels import decode_attention as da
from repro_torch.kernels import flash_attention as fa
from repro_torch.kernels import moe_gemm as mg
from repro_torch.kernels import ssm_scan as ss
from repro_torch.kernels.decode_attention import (
    decode_attention_cuda, decode_attention_paged_cuda,
    decode_attention_paged_plain, decode_attention_partial_cuda,
    decode_attention_partial_plain, decode_attention_plain)
from repro_torch.kernels.flash_attention import flash_attention_cuda
from repro_torch.kernels.moe_gemm import expert_ffn_cuda, expert_ffn_plain
from repro_torch.kernels.ref import ssm_scan_chunked_ref, ssm_scan_ref
from repro_torch.kernels.ssm_scan import ssm_scan_cuda
from repro_torch.roofline.op_count import kernel as count_work


class KernelWithPlainGrad(torch.autograd.Function):
    """``kernel(*inputs)`` forward; backward: ``grads(inputs, grad_outputs,
    needs)``, the gradient of each input (None where ``needs`` is False
    or the input is an integer tensor). ``kernel`` and ``grads`` are
    plain callables; ``inputs`` are tensors or None."""

    @staticmethod
    def forward(ctx, kernel, grads, *inputs):
        ctx.grads = grads
        ctx.set_materialize_grads(False)
        ctx.save_for_backward(*inputs)
        return kernel(*inputs)

    @staticmethod
    def backward(ctx, *grad_outputs):
        return (None, None) + tuple(ctx.grads(
            ctx.saved_tensors, grad_outputs, ctx.needs_input_grad[2:]))


def plain_grads(plain, inputs, grad_outputs, needs):
    """The gradients of ``plain(*inputs)`` (a tensor or a tuple of them)
    against ``grad_outputs`` (None for an output that got none), for the
    inputs flagged in ``needs``; None for the others."""
    with torch.enable_grad():
        leaves = [t.detach().requires_grad_() if want else t
                  for t, want in zip(inputs, needs)]
        out = plain(*leaves)
        outs = out if isinstance(out, tuple) else (out,)
        used = [(o, g) for o, g in zip(outs, grad_outputs) if g is not None]
        wanted = [t for t, want in zip(leaves, needs) if want]
        got = iter(torch.autograd.grad([o for o, _ in used], wanted,
                                       [g for _, g in used],
                                       allow_unused=True))
    return [next(got) if want else None for want in needs]


def _with_plain_grad(kernel, grads, *inputs):
    """``kernel(*inputs)``, through ``KernelWithPlainGrad`` when autograd
    needs the call's gradient."""
    if torch.is_grad_enabled() and any(
            t is not None and t.requires_grad for t in inputs):
        return KernelWithPlainGrad.apply(kernel, grads, *inputs)
    return kernel(*inputs)


def _on_cuda(t: torch.Tensor) -> bool:
    if isinstance(t, DTensor):
        raise TypeError("a DTensor reaches no kernel: serve its "
                        "to_local() shard")
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
    if not _on_cuda(q):
        return decode_attention_plain(q, ck, cv, cpos, k1, v1, pos,
                                      window=window, softcap=softcap)
    count_work("decode_attention_fused", lambda: da.fused_work(
        q, k1, cpos, int(da.valid_keys(cpos, pos, window).sum())))
    return decode_attention_cuda(q, ck, cv, cpos, k1, v1, pos,
                                 window=window, softcap=softcap)


def decode_attention_partial(q, ck, cv, cpos, pos, *, window: int = 0,
                             softcap: float = 0.0):
    """Online-softmax partials of one query token per row against the
    cache, with no self term and no normalising (for a caller that
    combines them: ``decode_attention.combine_decode_partials``). q:
    [B,H,Dh] (unscaled); ck/cv: [B,Sc,Hkv,Dh]; cpos: [B,Sc]; pos: [B].
    Returns (m, l [B,Hkv,G], acc [B,Hkv,G,Dh]) in float32."""
    if not _on_cuda(q):
        return decode_attention_partial_plain(q, ck, cv, cpos, pos,
                                              window=window, softcap=softcap)
    count_work("decode_attention_partial", lambda: da.partial_work(
        q, cpos, ck.shape[2], int(da.valid_keys(cpos, pos, window).sum())))
    return decode_attention_partial_cuda(q, ck, cv, cpos, pos, window=window,
                                         softcap=softcap)


def decode_attention_paged(q, pk, pv, ppos, bt, k1, v1, pos, *,
                           softcap: float = 0.0):
    """Single-token GQA decode attention over a paged cache + current token.
    q: [B,H,Dh]; pk/pv: [P,pt,Hkv,Dh] page pools; ppos: [P,pt]; bt:
    [B,nblk] block table (page 0 = the null page, positions all -1);
    k1/v1: [B,Hkv,Dh]; pos: [B]. Full attention only. Returns [B,H,Dh]."""
    if not _on_cuda(q):
        return decode_attention_paged_plain(q, pk, pv, ppos, bt, k1, v1, pos,
                                            softcap=softcap)
    count_work("decode_attention_paged", lambda: _paged_work(
        q, ppos, bt, k1, pos))
    return decode_attention_paged_cuda(q, pk, pv, ppos, bt, k1, v1, pos,
                                       softcap=softcap)


def _paged_work(q, ppos, bt, k1, pos):
    pt = ppos.shape[1]
    ok = da.valid_keys(ppos[bt.long()].reshape(bt.shape[0], -1), pos)
    return da.paged_work(q, k1, bt, pt, int(ok.sum()),
                         *da.paged_reads(bt, ok, pt))


def full_attention(q, k, v, q_pos, k_pos, *, causal: bool = True,
                   window: int = 0, softcap: float = 0.0, block_k: int = 0):
    """Full-sequence (prefill) attention. ``block_k`` pins the KV block of
    the plain version's online softmax; the kernel's KV tile is fixed and
    independent of the padded extent."""
    from repro_torch.models.attention import blockwise_attention
    if not _on_cuda(q):
        return blockwise_attention(q, k, v, q_pos, k_pos, window=window,
                                   softcap=softcap, causal=causal,
                                   block_k=block_k)
    opts = dict(causal=causal, window=window, softcap=softcap)
    count_work("flash_attention", lambda: fa.work(
        q_pos, k_pos, q.shape[2], k.shape[2], q.shape[3], causal=causal,
        window=window, el=q.element_size()))

    def kernel(q, k, v, q_pos, k_pos):
        return flash_attention_cuda(q, k, v, q_pos, k_pos, **opts)

    def plain(q, k, v, q_pos, k_pos):
        # the backward recomputes one block: a plain float32 softmax
        return blockwise_attention(q, k, v, q_pos, k_pos, block_q=q.shape[1],
                                   block_k=k.shape[1], **opts)

    return _with_plain_grad(
        kernel, functools.partial(plain_grads, plain), q, k, v, q_pos, k_pos)


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
        count_work("moe_ffn", lambda: _ffn_work(x3, w_gate, slot_expert,
                                                counts))
        y = _with_plain_grad(
            functools.partial(expert_ffn_cuda, act=act, decode=decode),
            functools.partial(_expert_ffn_grads, act=act),
            x3, w_gate, w_up, w_down, slot_expert, counts)
    else:
        y = expert_ffn_plain(x3, w_gate, w_up, w_down, slot_expert, counts,
                             act=act)
    return y.reshape(shape)


def _ffn_work(x3, w_gate, slot_expert, counts):
    live = counts > 0
    return mg.work(x3.shape[0], x3.shape[1], x3.shape[2], w_gate.shape[2],
                   int(live.sum()), int(slot_expert[live].unique().numel()),
                   x3.element_size())


def _expert_ffn_grads(inputs, grad_outputs, needs, *, act: str):
    """The expert FFN's backward: ``expert_ffn_plain`` recomputed one live
    slot at a time in float32 on its expert's rows of the stored bank
    upcast (one slot's float32 weights at a time, not the whole slot
    bank). The bank gradients are summed in float32 for the experts that
    live slots read, so an expert read by several slots (a shadow, a split
    replica) gets the sum, rounded once to the bank's dtype; the other
    experts' rows and the slots without a token get 0."""
    x, w_gate, w_up, w_down, slot_expert, counts = inputs
    (dy,) = grad_outputs
    if dy is None:
        return [None] * len(inputs)
    banks = (w_gate, w_up, w_down)
    live = torch.nonzero(counts > 0).flatten()
    touched, which = torch.unique(
        torch.clamp(slot_expert.long(), min=0)[live], return_inverse=True)
    acc = [torch.zeros((len(touched),) + w.shape[1:], dtype=torch.float32,
                       device=w.device) if want else None
           for w, want in zip(banks, needs[1:4])]
    dx = torch.zeros_like(x) if needs[0] else None
    one = torch.ones((1,), dtype=counts.dtype, device=counts.device)
    first = torch.zeros_like(one)

    def plain(x1, wg, wu, wd):
        return expert_ffn_plain(x1, wg, wu, wd, first, one, act=act)

    live_l, which_l, touched_l = (t.tolist() for t in (live, which, touched))
    for p, j in zip(live_l, which_l):
        e = touched_l[j]
        rows = [None if w is None else w[e:e + 1].float() for w in banks]
        got = plain_grads(plain, [x[p:p + 1]] + rows, (dy[p:p + 1],),
                          needs[:4])
        if dx is not None:
            dx[p] = got[0][0]
        for a, g in zip(acc, got[1:]):
            if a is not None:
                a[j] += g[0]
    dbanks = []
    for w, a in zip(banks, acc):
        if a is not None:
            a = torch.zeros_like(w).index_copy_(0, touched, a.to(w.dtype))
        dbanks.append(a)
    return [dx, *dbanks, None, None]


def ssm_scan(x, dt, a, b, c, *, chunk: int = 64):
    """Full-sequence SSD scan from a zero state. x: [B,S,H,P]; dt:
    [B,S,H]; a: [H]; b, c: [B,S,N]. Returns (y [B,S,H,P], h_final
    [B,H,P,N] float32). The kernel runs at every S on the card; the CPU
    takes the chunked plain form for S > 1 and the sequential one for a
    single step, as the reference does."""
    if _on_cuda(x):
        count_work("ssm_scan", lambda: ss.work(
            x.shape[0], x.shape[1], x.shape[2], x.shape[3], b.shape[-1],
            chunk))
        return _with_plain_grad(
            functools.partial(ssm_scan_cuda, chunk=chunk),
            functools.partial(plain_grads, functools.partial(
                ssm_scan_chunked_ref, chunk=chunk)),
            x, dt, a, b, c)
    if x.shape[1] > 1:
        return ssm_scan_chunked_ref(x, dt, a, b, c, chunk=chunk)
    return ssm_scan_ref(x, dt, a, b, c)
