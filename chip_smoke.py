#!/usr/bin/env python3
"""Drive the PyTorch port (``src/repro_torch``) on one NVIDIA GPU.

    python3 chip_smoke.py                  # every phase
    python3 chip_smoke.py --profile DIR    # and torch.profiler passes
                                           # (Mixtral in DIR, Zamba2 in
                                           # DIR/hybrid)

Phases, each of which raises on failure (exit code != 0):
  1. card     — ``nvidia-smi`` name and power limit, then the kernel build
                (one nvcc per CUDA source, all started together).
  2. kernels  — each hand-written kernel at the shapes the serving paths
                give it (bfloat16) and in float32, held to its plain
                PyTorch version on the card (bf16 2e-2, fp32 2e-5, atol
                and rtol; the SSD scan 2e-4 in float32, as the Pallas
                kernel is held; at the serving shapes bf16 results are also
                held to the float32 plain version on the same inputs
                within half a bf16 ulp plus 1e-4); the paged decode
                attention also bitwise to the fused kernel on the gathered
                pages; decode and flash attention also at Zamba2's head dim
                112; the expert FFN at every (C, path) a later phase gives
                it (MOE_SHAPES) and the SSD scan at every (B, S)
                (SCAN_SHAPES), both checked after the runs; kernel,
                plain-version and library-call times by CUDA events
                (median of 20 after warm-up, L2 flushed before each run).
  3. reference — a reduced float32 Mixtral, and a reduced float32 Zamba2
                with a trailing block, on the card against the same
                model's plain path on the CPU (logits to 1e-3).
  4. serve    — Mixtral-8x7B widths at 8 layers in bfloat16 with seeded
                random weights, contiguous KV, whole-prompt prefill: 8
                requests of 128 prompt tokens and 32 greedy new tokens
                through ``engine.client.submit`` and ``engine.step()``;
                every kernel of the path must be launched. Launches are
                read per phase (the prefills run inside ``client.submit``,
                the decode steps inside ``step()``) and the expert FFN's
                also per kernel path. Every step checkpoints its KV.
  5. failover — the same requests with ``engine.fail_ew(0)`` after 8
                decode steps; every stream must equal the failure-free one
                bit for bit.
  6. kv plane — the same model at capacity factor 4.0 (no token dropped,
                so slots and chunking cannot change a stream) in three
                engines sharing the weights: whole-prompt contiguous,
                chunked contiguous and chunked paged (16-token pages),
                chunk budget CHUNK_BUDGET tokens. Paged streams must equal
                contiguous ones, and chunked streams whole-prompt ones, bit
                for bit; the row-count probe holds every row count and
                capacity the prefill and chunk calls used to the largest
                call's rows, bit for bit. The paged run must launch the
                paged decode attention and never the fused one.
  7. AW failover — the paged engine again with ``fail_aw(0)`` once every
                request has 8 tokens, then ``recover_aw_requests()`` (AW1
                is full: nothing is admitted), ``provision_aw(0)``, and
                steps to the end: every stream must equal the paged
                failure-free run bit for bit; restored requests and bytes,
                the recovery time and the largest token gap are printed.
  8. hybrid   — Zamba2-7B widths at 13 layers in bfloat16 (2 units of 6
                Mamba2 blocks + the shared attention block, 1 trailing
                block), 8 requests of 128 prompt tokens and 16 greedy new
                tokens, each prefilled alone: every Mamba2 block of every
                prefill launches the SSD scan, the shared block the flash
                and decode kernels at head dim 112; the per-step checkpoint
                copy (every row's K/V and whole recurrent state) is timed.
                Then ``fail_aw(0)`` once every request has 8 tokens,
                recover, provision: every stream must equal the
                failure-free one bit for bit.
The line before the last is the kernels' JSON record; the last line is
``{"ok": true, "device": {...}}``.
"""
import argparse
import gc
import json
import statistics
from collections import Counter
import subprocess
import sys
import time
from pathlib import Path

HBM_BYTES_PER_S = 3.35e12          # H100 SXM HBM3
BF16_FLOPS_PER_S = 989e12          # H100 SXM dense bf16 tensor cores
FP32_FLOPS_PER_S = 67e12           # H100 SXM float32 on the CUDA cores
TOL = {"bfloat16": 2e-2, "float32": 2e-5}
# a bfloat16 result against the float32 plain version on the same inputs:
# rounding once at the output costs at most half an ulp (2^-8 relative);
# 1e-4 absolute covers float32 summation order
ROUND_ATOL, ROUND_RTOL = 1e-4, 2.0 ** -8
CHUNK_BUDGET = 256                 # prefill tokens per step, KV-plane phase
PAGE_TOKENS = 16
# the expert FFN's capacities C on the serving paths, each with the kind
# of call (decode step or not) and the kernel path it must take: serve
# decode and whole-prompt prefill at capacity factor 1.25; the KV-plane
# decode (and chunk calls at C 8), whole-prompt prefill, chunk calls and
# chunk tails at 4.0 (C 128 and 256 span two and four 64-row M tiles).
# Only decode steps take the skinny path: prefill and chunk calls take the
# tensor-core path at every C, chunk tails at C 2 and 4 included, so a
# token rounds one way whatever its call's C. main() fails if a run gives
# the kernel a (C, path) that is not here.
MOE_SHAPES = [("decode", 2, True, "skinny"),
              ("prefill", 64, False, "tensor_core"),
              ("decode-kv", 8, True, "tensor_core"),
              ("prefill-kv", 128, False, "tensor_core"),
              ("chunk-tail", 4, False, "tensor_core"),
              ("chunk-tail-2", 2, False, "tensor_core"),
              ("chunk", 256, False, "tensor_core")]
# Zamba2-7B as the hybrid phases serve it: 13 of 81 layers (two units of 6
# Mamba2 blocks + the shared block, then one trailing block)
HYBRID_LAYERS = 13
HYBRID_MAX_SEQ = 256
# the SSD scan's (B, S) on the hybrid serving path (one 128-token prompt
# per prefill call); main() fails if a run gives the kernel another
SCAN_SHAPES = [(1, 128)]


def card_line() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True, timeout=60)
    return out.stdout.strip().splitlines()[0]


def time_ms(torch, fn, reps: int = 20, warmup: int = 3) -> float:
    """Median CUDA-event time of ``fn`` with a 64 MiB L2 flush before each
    run (outside the timed span)."""
    flush = torch.empty(64 << 20, dtype=torch.uint8, device="cuda")
    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    times = []
    for _ in range(reps):
        flush.zero_()
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        fn()
        end.record()
        end.synchronize()
        times.append(start.elapsed_time(end))
    return statistics.median(times)


def bound(nbytes: float, flops: float, peak: float = BF16_FLOPS_PER_S):
    """The least time for the work: bytes at the HBM rate or flops at
    ``peak`` (bf16 tensor cores unless the kernel computes in float32 on
    the CUDA cores), the larger."""
    t_bytes = nbytes / HBM_BYTES_PER_S * 1e3
    t_ops = flops / peak * 1e3
    return (t_bytes, "bytes") if t_bytes >= t_ops else (t_ops, "operations")


def check(name, got, want, dtype_name=None, *, atol=None, rtol=None):
    """Hold ``got`` to ``want`` within atol + rtol * |want| (both the
    dtype's tolerance unless given); raise if not. Returns the max abs
    error."""
    atol = TOL[dtype_name] if atol is None else atol
    rtol = TOL[dtype_name] if rtol is None else rtol
    diff = (got.float() - want.float()).abs()
    err = diff.max().item()
    ok = bool((diff <= atol + rtol * want.float().abs()).all().item())
    print(f"  {name}: max_abs_err {err:.3e} (tol {atol:g} abs + {rtol:g} "
          f"rel) {'ok' if ok else 'FAIL'}")
    if not ok or not bool(got.float().isfinite().all().item()):
        raise AssertionError(f"{name}: kernel disagrees with its plain "
                             f"version (max abs err {err:.3e})")
    return err


# --------------------------------------------------------------------------
# kernel phase
# --------------------------------------------------------------------------

def decode_inputs(torch, g, b, h, hkv, dh, sc, dtype, min_len):
    q = torch.randn((b, h, dh), generator=g, device="cuda").to(dtype)
    ck = torch.randn((b, sc, hkv, dh), generator=g, device="cuda").to(dtype)
    cv = torch.randn((b, sc, hkv, dh), generator=g, device="cuda").to(dtype)
    k1 = torch.randn((b, hkv, dh), generator=g, device="cuda").to(dtype)
    v1 = torch.randn((b, hkv, dh), generator=g, device="cuda").to(dtype)
    pos = torch.randint(min_len, sc - 1, (b,), generator=g, device="cuda",
                        dtype=torch.int32)
    ar = torch.arange(sc, device="cuda", dtype=torch.int32)[None]
    cpos = torch.where(ar < pos[:, None], ar, torch.full_like(ar, -1))
    return q, ck, cv, cpos, k1, v1, pos


def kernel_decode_attention(torch, g, records):
    from repro_torch.kernels import decode_attention as da
    print("decode_attention (fused GQA decode, csrc/decode_attention.cu)")
    # fp32 at a small shape, with a window and a softcap
    q, ck, cv, cpos, k1, v1, pos = decode_inputs(
        torch, g, 3, 8, 2, 64, 96, torch.float32, 10)
    for window, cap in ((0, 0.0), (16, 0.0), (0, 30.0)):
        check(f"fp32 B3 H8 Hkv2 Dh64 Sc96 window={window} softcap={cap}",
              da.decode_attention_cuda(q, ck, cv, cpos, k1, v1, pos,
                                       window=window, softcap=cap),
              da.decode_attention_plain(q, ck, cv, cpos, k1, v1, pos,
                                        window=window, softcap=cap),
              "float32")
    # the serving shape: 8 rows, Mixtral heads, a 512-token cache
    decode_attention_at(torch, g, records, "decode_attention_fused",
                        8, 32, 8, 128, 512)


def decode_attention_at(torch, g, records, name, b, h, hkv, dh, sc):
    """The fused decode kernel at a serving shape: in float32 first, so
    the instantiation the main path uses is held to the float32 bar, then
    in bf16 against the bf16 and the float32 plain versions; times."""
    from repro_torch.kernels import decode_attention as da
    import torch.nn.functional as F
    args32 = decode_inputs(torch, g, b, h, hkv, dh, sc, torch.float32, 128)
    check(f"fp32 B{b} H{h} Hkv{hkv} Dh{dh} Sc{sc}",
          da.decode_attention_cuda(*args32),
          da.decode_attention_plain(*args32), "float32")
    del args32
    args = decode_inputs(torch, g, b, h, hkv, dh, sc, torch.bfloat16, 128)
    q, ck, cv, cpos, k1, v1, pos = args
    got = da.decode_attention_cuda(*args)
    err = check(f"bf16 B{b} H{h} Hkv{hkv} Dh{dh} Sc{sc}", got,
                da.decode_attention_plain(*args), "bfloat16")
    check(f"bf16 B{b} H{h} Hkv{hkv} Dh{dh} Sc{sc} vs float32 plain", got,
          da.decode_attention_plain(*(t.float() if t.is_floating_point()
                                      else t for t in args)),
          atol=ROUND_ATOL, rtol=ROUND_RTOL)
    ms = time_ms(torch, lambda: da.decode_attention_cuda(*args))
    plain_ms = time_ms(torch, lambda: da.decode_attention_plain(*args))
    # library yardstick: SDPA over cache + current token, heads expanded
    grp = h // hkv
    kk = torch.cat([ck, k1[:, None]], 1).transpose(1, 2)
    vv = torch.cat([cv, v1[:, None]], 1).transpose(1, 2)
    kk = kk.repeat_interleave(grp, 1).contiguous()
    vv = vv.repeat_interleave(grp, 1).contiguous()
    mask = torch.cat([cpos >= 0, torch.ones((b, 1), dtype=torch.bool,
                                             device="cuda")], 1)
    mask = mask[:, None, None, :]
    qq = q[:, :, None, :]
    lib_ms = time_ms(torch, lambda: F.scaled_dot_product_attention(
        qq, kk, vv, attn_mask=mask))
    valid = int((cpos >= 0).sum().item())
    el = 2
    nbytes = (q.numel() + 2 * valid * hkv * dh + k1.numel() + v1.numel()
              + q.numel()) * el + cpos.numel() * 4 + pos.numel() * 4
    flops = 4.0 * (valid + b) * grp * hkv * dh
    b_ms, b_by = bound(nbytes, flops)
    records.append(dict(
        name=name, route="cuda",
        source="src/repro_torch/csrc/decode_attention.cu",
        replaces=da.KERNEL.replaces, max_abs_err=err, ms=ms,
        plain_ms=plain_ms, bound_ms=b_ms, bound_by=b_by,
        library_ms=lib_ms, shape=f"B{b} H{h} Hkv{hkv} Dh{dh} Sc{sc} bf16"))
    print(f"  time {ms:.4f} ms, plain {plain_ms:.4f} ms, SDPA {lib_ms:.4f} "
          f"ms, bound {b_ms:.4f} ms ({b_by})")


def paged_inputs(torch, g, b, h, hkv, dh, nblk, pt, dtype, min_len):
    """Page pools with a null page 0, a page that rows 0 and 1 share, and
    unmapped (null) tail blocks; every row's gathered positions causal.
    Returns the kernel's arguments and the host block table and
    positions."""
    import numpy as np
    npages = 1 + b * nblk
    pk = torch.randn((npages, pt, hkv, dh), generator=g,
                     device="cuda").to(dtype)
    pv = torch.randn((npages, pt, hkv, dh), generator=g,
                     device="cuda").to(dtype)
    q = torch.randn((b, h, dh), generator=g, device="cuda").to(dtype)
    k1 = torch.randn((b, hkv, dh), generator=g, device="cuda").to(dtype)
    v1 = torch.randn((b, hkv, dh), generator=g, device="cuda").to(dtype)
    pos = torch.randint(min_len, nblk * pt - 1, (b,), generator=g,
                        device="cuda", dtype=torch.int32)
    ids = (torch.randperm(npages - 1, generator=g, device="cuda") + 1)
    ids, pos_h = ids.cpu().numpy(), pos.cpu().numpy()
    bt = np.zeros((b, nblk), np.int32)
    for i in range(b):
        used = -(-int(pos_h[i]) // pt)
        bt[i, :used] = ids[i * nblk:i * nblk + used]
    bt[1, 0] = bt[0, 0]
    ppos = np.full((npages, pt), -1, np.int32)
    for i in range(b):
        for j in range(nblk):
            if bt[i, j]:
                ppos[bt[i, j]] = np.arange(j * pt, (j + 1) * pt)
    args = (q, pk, pv, torch.from_numpy(ppos).cuda(),
            torch.from_numpy(bt).cuda(), k1, v1, pos)
    return args, bt, ppos, pos_h


def kernel_decode_attention_paged(torch, g, records):
    from repro_torch.kernels import decode_attention as da
    import numpy as np
    import torch.nn.functional as F
    print("decode_attention_paged (block-table GQA decode, "
          "csrc/decode_attention.cu)")
    b, h, hkv, dh, nblk, pt = 8, 32, 8, 128, 32, PAGE_TOKENS
    sc = nblk * pt
    args32, _, _, _ = paged_inputs(torch, g, b, h, hkv, dh, nblk, pt,
                                   torch.float32, 128)
    shape = f"B{b} H{h} Hkv{hkv} Dh{dh} pt{pt} nblk{nblk} P{1 + b * nblk}"
    for cap in (0.0, 30.0):
        got = da.decode_attention_paged_cuda(*args32, softcap=cap)
        check(f"fp32 {shape} softcap={cap}", got,
              da.decode_attention_paged_plain(*args32, softcap=cap),
              "float32")
        q, pk, pv, ppos, bt, k1, v1, pos = args32
        fused = da.decode_attention_cuda(
            q, *da.gather_pages(pk, pv, ppos, bt), k1, v1, pos, softcap=cap)
        if not torch.equal(got, fused):
            raise AssertionError(f"paged kernel differs from the fused "
                                 f"kernel on the gathered pages (fp32, "
                                 f"softcap {cap})")
        print(f"  fp32 softcap={cap}: bitwise equal to the fused kernel on "
              f"the gathered pages")
    args = tuple(t.bfloat16() if t.is_floating_point() else t
                 for t in args32)
    del args32
    q, pk, pv, ppos, bt, k1, v1, pos = args
    got = da.decode_attention_paged_cuda(*args)
    err = check(f"bf16 {shape}", got, da.decode_attention_paged_plain(*args),
                "bfloat16")
    check(f"bf16 {shape} vs float32 plain", got,
          da.decode_attention_paged_plain(*(t.float() if t.is_floating_point()
                                            else t for t in args)),
          atol=ROUND_ATOL, rtol=ROUND_RTOL)
    ck, cv, cpos = da.gather_pages(pk, pv, ppos, bt)
    if not torch.equal(got, da.decode_attention_cuda(q, ck, cv, cpos, k1, v1,
                                                     pos)):
        raise AssertionError("paged kernel differs from the fused kernel "
                             "on the gathered pages (bf16)")
    print("  bf16: bitwise equal to the fused kernel on the gathered pages")
    ms = time_ms(torch, lambda: da.decode_attention_paged_cuda(*args))
    plain_ms = time_ms(torch, lambda: da.decode_attention_paged_plain(*args))
    # library yardstick: SDPA over the pre-gathered view + current token
    # (the gather itself excluded: no single PyTorch call walks a block
    # table)
    grp = h // hkv
    kk = torch.cat([ck, k1[:, None]], 1).transpose(1, 2)
    vv = torch.cat([cv, v1[:, None]], 1).transpose(1, 2)
    kk = kk.repeat_interleave(grp, 1).contiguous()
    vv = vv.repeat_interleave(grp, 1).contiguous()
    valid = (cpos >= 0) & (cpos <= pos[:, None])
    mask = torch.cat([valid, torch.ones((b, 1), dtype=torch.bool,
                                        device="cuda")], 1)[:, None, None]
    qq = q[:, :, None, :]
    lib_ms = time_ms(torch, lambda: F.scaled_dot_product_attention(
        qq, kk, vv, attn_mask=mask))
    # bytes of the valid pages: every (page, offset) some row attends to,
    # once, with the positions of the pages read and the block table
    bt_h, cpos_h = bt.cpu().numpy(), cpos.cpu().numpy()
    page = np.repeat(bt_h, pt, axis=1)
    off = np.tile(np.arange(pt), nblk)[None].repeat(b, 0)
    v_h = valid.cpu().numpy()
    uniq = len(set(zip(page[v_h].tolist(), off[v_h].tolist())))
    pages_read = len(set(bt_h[bt_h > 0].tolist()))
    el = 2
    nbytes = (2 * q.numel() + 2 * uniq * hkv * dh + k1.numel() +
              v1.numel()) * el + (pages_read * pt + bt.numel() + b) * 4
    flops = 4.0 * (int(v_h.sum()) + b) * grp * hkv * dh
    b_ms, b_by = bound(nbytes, flops)
    records.append(dict(
        name="decode_attention_paged", route="cuda",
        source="src/repro_torch/csrc/decode_attention.cu",
        replaces=da.PAGED_KERNEL.replaces, max_abs_err=err, ms=ms,
        plain_ms=plain_ms, bound_ms=b_ms, bound_by=b_by, library_ms=lib_ms,
        library="SDPA on the pre-gathered view, gather excluded",
        shape=f"{shape} bf16, {int(cpos_h.shape[1])}-token view"))
    print(f"  time {ms:.4f} ms, plain {plain_ms:.4f} ms, SDPA on the "
          f"pre-gathered view {lib_ms:.4f} ms, bound {b_ms:.4f} ms ({b_by})")


def kernel_flash_chunk(torch, g, records):
    """The flash kernel at the chunked-prefill shape: max_batch rows of C
    queries against the gathered 512-key view; rows outside the chunk
    carry q_pos -1 (their keys are live decode state), pads -1."""
    from repro_torch.kernels import flash_attention as fa
    from repro_torch.models.attention import blockwise_attention
    import torch.nn.functional as F
    print("flash_attention at the chunk shape (csrc/flash_attention.cu)")
    b, sk, h, hkv, dh = 8, 512, 32, 8, 128
    recs = {}
    for c, dtype in ((8, torch.float32), (128, torch.bfloat16)):
        name = "float32" if dtype == torch.float32 else "bfloat16"
        q = torch.randn((b, c, h, dh), generator=g, device="cuda").to(dtype)
        k = torch.randn((b, sk, hkv, dh), generator=g, device="cuda").to(dtype)
        v = torch.randn((b, sk, hkv, dh), generator=g, device="cuda").to(dtype)
        ar = torch.arange(sk, device="cuda", dtype=torch.int32)
        kp = torch.where(ar < 100, ar, torch.full_like(ar, -1)).repeat(b, 1)
        qp = torch.full((b, c), -1, device="cuda", dtype=torch.int32)
        # row 0: the chunk [0, c - 1) of a fresh prompt (one pad);
        # row 1: the chunk [200, 200 + c) after a 200-token prefix
        take = c - 1
        qp[0, :take] = torch.arange(take, device="cuda", dtype=torch.int32)
        kp[0] = torch.where(ar < take, ar, torch.full_like(ar, -1))
        qp[1] = torch.arange(200, 200 + c, device="cuda", dtype=torch.int32)
        kp[1] = torch.where(ar < 200 + c, ar, torch.full_like(ar, -1))

        def kern():
            return fa.flash_attention_cuda(q, k, v, qp, kp)

        def plain():
            return blockwise_attention(q, k, v, qp, kp, block_k=16)

        label = (f"{'fp32' if c == 8 else 'bf16'} B{b} C{c} Sk{sk} H{h} "
                 f"Hkv{hkv} Dh{dh}, rows outside the chunk")
        got = kern()
        recs[c] = (check(label, got, plain(), name), kern, plain, q, k, v,
                   qp, kp)
        if dtype == torch.bfloat16:
            check(f"{label}, vs float32 plain", got, blockwise_attention(
                q.float(), k.float(), v.float(), qp, kp, block_k=16),
                atol=ROUND_ATOL, rtol=ROUND_RTOL)
    err, kern, plain, q, k, v, qp, kp = recs[128]
    ms, plain_ms = time_ms(torch, kern), time_ms(torch, plain)
    grp = h // hkv
    qq = q.transpose(1, 2).contiguous()
    kk = k.transpose(1, 2).repeat_interleave(grp, 1).contiguous()
    vv = v.transpose(1, 2).repeat_interleave(grp, 1).contiguous()
    m = (kp[:, None, :] >= 0) & (kp[:, None, :] <= qp[:, :, None])
    lib_ms = time_ms(torch, lambda: F.scaled_dot_product_attention(
        qq, kk, vv, attn_mask=m[:, None]))
    live = (qp >= 0).any(1)
    keys = int(((kp >= 0) & live[:, None]).sum().item())
    pairs = int(m.sum().item())
    nbytes = (2 * int((qp >= 0).sum().item()) * h * dh +
              2 * keys * hkv * dh) * 2 + (qp.numel() + kp.numel()) * 4
    flops = 4.0 * pairs * h * dh
    b_ms, b_by = bound(nbytes, flops)
    records.append(dict(
        name="flash_attention[chunk]", route="cuda",
        source="src/repro_torch/csrc/flash_attention.cu",
        replaces=fa.KERNEL.replaces, max_abs_err=err, ms=ms,
        plain_ms=plain_ms, bound_ms=b_ms, bound_by=b_by, library_ms=lib_ms,
        shape=f"B{b} C128 Sk{sk} H{h} Hkv{hkv} Dh{dh} bf16, 2 rows in "
              f"the chunk"))
    print(f"  time {ms:.4f} ms, plain {plain_ms:.4f} ms, SDPA {lib_ms:.4f} "
          f"ms, bound {b_ms:.4f} ms ({b_by})")


def kernel_flash_attention(torch, g, records):
    from repro_torch.kernels import flash_attention as fa
    from repro_torch.models.attention import blockwise_attention
    print("flash_attention (prefill GQA, csrc/flash_attention.cu)")
    # fp32 small: GQA, -1 positions (a fully masked row), window, softcap
    bs, s, h, hkv, dh = 2, 40, 6, 2, 32
    q = torch.randn((bs, s, h, dh), generator=g, device="cuda")
    k = torch.randn((bs, s, hkv, dh), generator=g, device="cuda")
    v = torch.randn((bs, s, hkv, dh), generator=g, device="cuda")
    p = torch.arange(s, device="cuda", dtype=torch.int32).repeat(bs, 1)
    p[1, 30:] = -1
    for window, cap in ((0, 0.0), (8, 0.0), (0, 30.0)):
        check(f"fp32 B{bs} S{s} H{h} Hkv{hkv} Dh{dh} window={window} "
              f"softcap={cap}",
              fa.flash_attention_cuda(q, k, v, p, p, window=window,
                                      softcap=cap),
              blockwise_attention(q, k, v, p, p, window=window, softcap=cap,
                                  block_k=16), "float32")
    # the serving shape: one 128-token prompt per prefill call
    flash_attention_at(torch, g, records, "flash_attention", 1, 128, 32, 8,
                       128)


def flash_attention_at(torch, g, records, name, b, s, h, hkv, dh):
    """The flash kernel at a whole-prompt serving shape, in float32 and
    bf16 (the latter also against the float32 plain version); times."""
    from repro_torch.kernels import flash_attention as fa
    from repro_torch.models.attention import blockwise_attention
    import torch.nn.functional as F
    p = torch.arange(s, device="cuda", dtype=torch.int32).repeat(b, 1)
    qkv = [torch.randn((b, s, n, dh), generator=g, device="cuda")
           for n in (h, hkv, hkv)]
    check(f"fp32 B{b} S{s} H{h} Hkv{hkv} Dh{dh} causal",
          fa.flash_attention_cuda(*qkv, p, p),
          blockwise_attention(*qkv, p, p, block_k=16), "float32")
    q, k, v = (t.bfloat16() for t in qkv)
    del qkv

    def kern():
        return fa.flash_attention_cuda(q, k, v, p, p)

    def plain():
        return blockwise_attention(q, k, v, p, p, block_k=16)

    got = kern()
    err = check(f"bf16 B{b} S{s} H{h} Hkv{hkv} Dh{dh} causal", got,
                plain(), "bfloat16")
    check(f"bf16 B{b} S{s} H{h} Hkv{hkv} Dh{dh} causal vs float32 plain",
          got, blockwise_attention(q.float(), k.float(), v.float(), p, p,
                                   block_k=16),
          atol=ROUND_ATOL, rtol=ROUND_RTOL)
    ms, plain_ms = time_ms(torch, kern), time_ms(torch, plain)
    grp = h // hkv
    qq = q.transpose(1, 2).contiguous()
    kk = k.transpose(1, 2).repeat_interleave(grp, 1).contiguous()
    vv = v.transpose(1, 2).repeat_interleave(grp, 1).contiguous()
    lib_ms = time_ms(torch, lambda: F.scaled_dot_product_attention(
        qq, kk, vv, is_causal=True))
    nbytes = (2 * q.numel() + k.numel() + v.numel()) * 2 + 2 * p.numel() * 4
    flops = 4.0 * b * h * dh * s * (s + 1) / 2
    b_ms, b_by = bound(nbytes, flops)
    records.append(dict(
        name=name, route="cuda",
        source="src/repro_torch/csrc/flash_attention.cu",
        replaces=fa.KERNEL.replaces, max_abs_err=err, ms=ms,
        plain_ms=plain_ms, bound_ms=b_ms, bound_by=b_by, library_ms=lib_ms,
        shape=f"B{b} S{s} H{h} Hkv{hkv} Dh{dh} causal bf16"))
    print(f"  time {ms:.4f} ms, plain {plain_ms:.4f} ms, SDPA {lib_ms:.4f} "
          f"ms, bound {b_ms:.4f} ms ({b_by})")


def scan_inputs(torch, g, bs, s, h, p, n, dtype):
    x = torch.randn((bs, s, h, p), generator=g, device="cuda").to(dtype)
    dt = torch.nn.functional.softplus(
        torch.randn((bs, s, h), generator=g, device="cuda"))
    a = -torch.exp(torch.randn((h,), generator=g, device="cuda") * 0.5)
    b = torch.randn((bs, s, n), generator=g, device="cuda") * 0.3
    c = torch.randn((bs, s, n), generator=g, device="cuda") * 0.3
    return x, dt, a, b, c


def kernel_ssm_scan(torch, g, records, shapes):
    """The SSD scan at Zamba2-7B's widths (112 heads, P = N = 64, chunk
    64) for every (B, S) in ``shapes`` (checked against what the runs
    give it, after them), plus one step and an odd length that halves the
    chunk to 1: float32 within 2e-4 of the plain chunked scan (the Pallas
    kernel's bar), bf16 within half an ulp + 1e-4 of the float32 plain
    version."""
    from repro_torch.kernels import ref as kref
    from repro_torch.kernels import ssm_scan as ss
    print("ssm_scan (Mamba2/SSD chunked scan, csrc/ssm_scan.cu)")
    h, p, n, chunk = 112, 64, 64, 64
    for bs, s_ in ((1, 1), (1, 127), (2, 96)):
        args = scan_inputs(torch, g, bs, s_, 8, p, n, torch.float32)
        y, hf = ss.ssm_scan_cuda(*args, chunk=chunk)
        wy, wh = kref.ssm_scan_chunked_ref(*args, chunk=chunk)
        tag = f"fp32 B{bs} S{s_} H8 P{p} N{n} (chunk " \
              f"{kref.scan_chunk(s_, chunk)})"
        check(f"{tag} y", y, wy, atol=2e-4, rtol=2e-4)
        check(f"{tag} h_final", hf, wh, atol=2e-4, rtol=2e-4)
    for bs, s_ in shapes:
        args32 = scan_inputs(torch, g, bs, s_, h, p, n, torch.float32)
        y, hf = ss.ssm_scan_cuda(*args32, chunk=chunk)
        wy, wh = kref.ssm_scan_chunked_ref(*args32, chunk=chunk)
        tag = f"B{bs} S{s_} H{h} P{p} N{n}"
        check(f"fp32 {tag} y", y, wy, atol=2e-4, rtol=2e-4)
        check(f"fp32 {tag} h_final", hf, wh, atol=2e-4, rtol=2e-4)
        args = (args32[0].bfloat16(),) + args32[1:]
        y, hf = ss.ssm_scan_cuda(*args, chunk=chunk)
        wy, wh = kref.ssm_scan_chunked_ref(args[0].float(), *args[1:],
                                           chunk=chunk)
        err = check(f"bf16 {tag} y vs float32 plain", y, wy,
                    atol=ROUND_ATOL, rtol=ROUND_RTOL)
        check(f"bf16 {tag} h_final vs float32 plain", hf, wh, atol=2e-4,
              rtol=2e-4)
        ms = time_ms(torch, lambda: ss.ssm_scan_cuda(*args, chunk=chunk))
        plain_ms = time_ms(torch, lambda: kref.ssm_scan_chunked_ref(
            *args, chunk=chunk))
        t = kref.scan_chunk(s_, chunk)
        nbytes = (2 * args[0].numel() * 2 + bs * h * p * n * 4 +
                  (bs * s_ * h + 2 * bs * s_ * n + h) * 4)
        # per (b, h, chunk): the causal (i >= j) half of C B^T and of
        # W x, then C h^T and the state update
        flops = 2.0 * bs * h * (s_ // t) * (t * (t + 1) // 2 * (n + p) +
                                            2 * t * n * p)
        b_ms, b_by = bound(nbytes, flops, FP32_FLOPS_PER_S)
        records.append(dict(
            name="ssm_scan", route="cuda",
            source="src/repro_torch/csrc/ssm_scan.cu",
            replaces=ss.KERNEL.replaces, max_abs_err=err, ms=ms,
            plain_ms=plain_ms, bound_ms=b_ms, bound_by=b_by,
            library_ms=None,
            library="none: no single PyTorch call computes the SSD scan",
            shape=f"{tag} chunk {t} bf16 x, float32 math (bound at the "
                  f"67 TFLOP/s float32 peak)"))
        print(f"  time {ms:.4f} ms, plain {plain_ms:.4f} ms, no library "
              f"call, bound {b_ms:.4f} ms ({b_by}, float32 peak)")
        del args, args32


def kernel_moe_gemm(torch, g, records, shapes):
    """``shapes``: (label, C, whether the call is a decode step, the
    kernel path it must take)."""
    from repro_torch.kernels import moe_gemm as mg
    print("moe_gemm (grouped expert FFN, csrc/moe_gemm.cu)")
    # fp32 small, both paths (C <= 4 streams split-K; larger C tiles):
    # gated silu and ungated gelu, empty slots, a -1 slot
    p_, d_, f_, e_ = 6, 96, 160, 4
    w = [torch.randn((e_, d_, f_), generator=g, device="cuda") * 0.1
         for _ in range(2)]
    wd = torch.randn((e_, f_, d_), generator=g, device="cuda") * 0.1
    se = torch.tensor([0, 1, 2, 3, 1, -1], dtype=torch.int32, device="cuda")
    for c_ in (3, 24):
        x = torch.randn((p_, c_, d_), generator=g, device="cuda")
        cnt = torch.tensor([c_, 0, 1, c_, 2, 0], dtype=torch.int32,
                           device="cuda")
        for act, wg in (("silu", w[0]), ("gelu", None)):
            check(f"fp32 P{p_} C{c_} D{d_} F{f_} {act} "
                  f"{'gated' if wg is not None else 'ungated'}",
                  mg.expert_ffn_cuda(x, wg, w[1], wd, se, cnt, decode=True,
                                     act=act),
                  mg.expert_ffn_plain(x, wg, w[1], wd, se, cnt, act=act),
                  "float32")
    # the serving shapes: Mixtral's 8-expert bank, 16 slots on 2 EWs
    d, f, n_exp, n_slot = 4096, 14336, 8, 16
    std = 1.0 / d ** 0.5
    bank = [(torch.randn((n_exp, d, f), generator=g, device="cuda") *
             std).bfloat16() for _ in range(2)]
    wdn = (torch.randn((n_exp, f, d), generator=g, device="cuda") *
           f ** -0.5).bfloat16()
    # primaries 0..7, shadows replicate EW 0's experts (the initial plan)
    se = torch.tensor(list(range(8)) + [0, 1, 2, 3, 0, 1, 2, 3],
                      dtype=torch.int32, device="cuda")
    for label, c, decode, path in shapes:
        cnt = torch.tensor([c] * 8 + [0] * 8, dtype=torch.int32,
                           device="cuda")
        x = torch.randn((n_slot, c, d), generator=g,
                        device="cuda").bfloat16()
        x[8:] = 0

        def kern():
            return mg.expert_ffn_cuda(x, bank[0], bank[1], wdn, se, cnt,
                                      decode=decode)

        def plain():
            return mg.expert_ffn_plain(x, bank[0], bank[1], wdn, se, cnt)

        before = dict(mg.path_launches)
        got = kern()
        taken = [k for k, v in mg.path_launches.items() if v != before[k]]
        if taken != [path]:
            raise AssertionError(f"moe_gemm at C {c} took path {taken}, "
                                 f"expected {path}")
        err = check(f"bf16 P{n_slot} C{c} D{d} F{f} ({label}, {path} "
                    f"path)", got, plain(), "bfloat16")
        # the 8 active slots (slot p < 8 runs expert p), upcast: the
        # float32 bank is 11 GiB, its 16-slot gather would be 22 more
        check(f"bf16 P{n_slot} C{c} D{d} F{f} ({label}) active slots vs "
              f"float32 plain", got[:8],
              mg.expert_ffn_plain(x[:8].float(), bank[0].float(),
                                  bank[1].float(), wdn.float(), se[:8],
                                  cnt[:8]),
              atol=ROUND_ATOL, rtol=ROUND_RTOL)
        del got
        torch.cuda.empty_cache()
        ms = time_ms(torch, kern)
        plain_ms = time_ms(torch, plain)
        # library yardstick: the per-slot matmul chain over active slots
        xa = x[:8]
        wg8, wu8, wd8 = bank[0][:8], bank[1][:8], wdn[:8]
        lib_ms = time_ms(torch, lambda: torch.bmm(
            torch.nn.functional.silu(torch.bmm(xa, wg8)) *
            torch.bmm(xa, wu8), wd8))
        active = int((cnt > 0).sum().item())  # the kernel skips the rest
        nbytes = active * (3 * d * f + 2 * c * d) * 2 + 2 * n_slot * 4
        flops = active * 2.0 * c * d * f * 3
        b_ms, b_by = bound(nbytes, flops)
        records.append(dict(
            name=f"moe_gemm[{label}]", route="cuda",
            source="src/repro_torch/csrc/moe_gemm.cu",
            replaces=mg.KERNEL.replaces, max_abs_err=err, ms=ms,
            plain_ms=plain_ms, bound_ms=b_ms, bound_by=b_by,
            library_ms=lib_ms,
            shape=f"P{n_slot} (8 active) C{c} D{d} F{f} bf16, "
                  f"{'decode step' if decode else 'prefill/chunk call'}, "
                  f"{path} path"))
        print(f"  time {ms:.4f} ms, plain {plain_ms:.4f} ms, bmm chain "
              f"{lib_ms:.4f} ms, bound {b_ms:.4f} ms ({b_by})")
        del x, cnt
    del bank, wdn
    torch.cuda.empty_cache()


# --------------------------------------------------------------------------
# reference and serve phases
# --------------------------------------------------------------------------

def reference_phase(torch, cfg):
    """A reduced float32 model through the kernels on the card against
    the same model's plain path on the CPU (logits to 1e-3)."""
    from repro_torch.models import get_model
    gpu = get_model(cfg, num_aw=2, num_ew=2, device="cuda")
    cpu = get_model(cfg, num_aw=2, num_ew=2, device="cpu")
    params = gpu.init_params(torch.Generator(device="cuda").manual_seed(1))

    def to_cpu(t):
        if isinstance(t, dict):
            return {k: to_cpu(v) for k, v in t.items()}
        if isinstance(t, list):
            return [to_cpu(v) for v in t]
        return t.cpu()

    cparams = to_cpu(params)
    gen = torch.Generator().manual_seed(2)
    toks = torch.randint(0, cfg.vocab_size, (4, 24), generator=gen,
                         dtype=torch.int32)
    mask = torch.ones((4, 24), dtype=torch.bool)
    mask[3, 17:] = False
    lg, cg, _ = gpu.prefill(params, toks.cuda(), gpu.init_route_state(), 48,
                            capacity=32, mask=mask.cuda())
    lc, cc, _ = cpu.prefill(cparams, toks, cpu.init_route_state(), 48,
                            capacity=32, mask=mask)
    pos = torch.tensor([24, 24, -1, 24], dtype=torch.int32)
    nt = torch.randint(0, cfg.vocab_size, (4,), generator=gen,
                       dtype=torch.int32)
    dg, _, _ = gpu.decode(params, nt.cuda(), pos.cuda(), cg,
                          gpu.init_route_state())
    dc, _, _ = cpu.decode(cparams, nt, pos, cc, cpu.init_route_state())
    for name, a, b in (("prefill", lg, lc), ("decode", dg, dc)):
        err = (a.cpu() - b).abs().max().item()
        print(f"  {cfg.name} ({cfg.num_layers} layers) fp32 {name} logits, "
              f"card vs CPU: "
              f"max_abs_err {err:.3e} (tol 1e-3)")
        if not err <= 1e-3:
            raise AssertionError(f"{name} logits disagree with the CPU "
                                 f"plain path: {err:.3e}")


def all_kernels():
    from repro_torch.kernels import decode_attention, flash_attention, \
        moe_gemm, ssm_scan
    return (decode_attention.KERNEL, decode_attention.PAGED_KERNEL,
            flash_attention.KERNEL, moe_gemm.KERNEL, ssm_scan.KERNEL)


def launch_counts():
    """Every kernel's launch count, and the expert FFN's per path."""
    from repro_torch.kernels import moe_gemm
    counts = {k.symbol: k.launches for k in all_kernels()}
    counts.update({f"moe_ffn/{k}": v
                   for k, v in moe_gemm.path_launches.items()})
    return counts


# what each Run gives the kernels, observed around the wrappers (the launch
# counts stay the wrappers' own): per phase of the current Run, a Counter of
# the expert FFN's (C, path); over all runs, the (C, path) pairs, the C of
# prefill and chunk calls, the SSD scan's (B, S) and the row counts of the
# row-blocked projections and norms (prefill and chunk calls only)
SEEN = {"phase": None, "run": None, "ffn": Counter(), "ffn_prefill_c": set(),
        "scan": set(), "rows": set()}


def observe_kernel_shapes():
    from repro_torch.kernels import moe_gemm as mg
    from repro_torch.kernels import ops
    from repro_torch.models import layers
    ffn, scan, blocked = ops.expert_ffn_cuda, ops.ssm_scan_cuda, \
        layers.row_blocked

    def ffn_observed(x, *args, **kw):
        before = dict(mg.path_launches)
        y = ffn(x, *args, **kw)
        if SEEN["run"] is not None:
            path = next(k for k, v in mg.path_launches.items()
                        if v != before[k])
            key = (x.shape[1], path)
            SEEN["run"].setdefault(SEEN["phase"], Counter())[key] += 1
            SEEN["ffn"][key] += 1
            if SEEN["phase"] in ("prefill", "chunks"):
                SEEN["ffn_prefill_c"].add(x.shape[1])
        return y

    def scan_observed(x, *args, **kw):
        if SEEN["run"] is not None:
            SEEN["scan"].add(tuple(x.shape[:2]))
        return scan(x, *args, **kw)

    def rows_observed(fn, x):
        if SEEN["run"] is not None:
            SEEN["rows"].add(x.numel() // x.shape[-1])
        return blocked(fn, x)
    ops.expert_ffn_cuda = ffn_observed
    ops.ssm_scan_cuda = scan_observed
    layers.row_blocked = rows_observed


def reset_counts():
    from repro_torch.kernels import moe_gemm
    for k in all_kernels():
        k.launches = 0
    for k in moe_gemm.path_launches:
        moe_gemm.path_launches[k] = 0


def delta(a, b):
    return {k: b[k] - a[k] for k in a}


class Run:
    """One pass of requests through an engine: streams, per-request token
    times, and launch counts per phase: "prefill" (inside
    ``client.submit``, which admits and, without the chunked plane,
    prefills), "chunks" (the chunked plane's ticks inside ``step()``) and
    "decode" (the rest of ``step()``)."""

    def __init__(self, torch, engine, prompts, max_new, fail=None):
        from repro_torch.serving.api import RequestSpec
        torch.cuda.synchronize()
        chunk_counts = {k: 0 for k in launch_counts()}
        self.tick_s = []       # host time of each chunk tick that ran work
        if engine.chunked is not None:
            tick = engine.chunked.tick

            def counted_tick():
                c0 = launch_counts()
                t0 = time.perf_counter()
                SEEN["phase"] = "chunks"
                out = tick()   # ends in the chunk checkpoint's host copy
                SEEN["phase"] = "decode"
                if out:
                    self.tick_s.append(time.perf_counter() - t0)
                for k, v in delta(c0, launch_counts()).items():
                    chunk_counts[k] += v
                return out
            engine.chunked.tick = counted_tick
        c0 = launch_counts()
        self.ffn_c = SEEN["run"] = {}
        SEEN["phase"] = "prefill"
        t_submit, handles = {}, []
        self.first, last, self.tbt = {}, {}, []
        for i, p in enumerate(prompts):
            rid = f"r{i}"
            t_submit[rid] = time.perf_counter()
            handles.append(engine.client.submit(RequestSpec(
                rid=rid, prompt=p, max_new=max_new)))
            if handles[-1].tokens():
                # the exact whole-prompt scheme samples the first token
                # from the prefill's logits (a host sync) inside submit
                last[rid] = time.perf_counter()
                self.first[rid] = last[rid] - t_submit[rid]
        c1 = launch_counts()
        SEEN["phase"] = "decode"
        self.steps = 0
        self.t_fail, self.victims, self.recovery_s = None, [], None
        t_dec0 = None
        while not all(h.done() for h in handles):
            if fail is not None and self.t_fail is None:
                t = time.perf_counter()
                victims = fail(engine, handles, self.steps)
                if victims is not None:
                    self.t_fail, self.victims = t, victims
            out = engine.step()
            now = time.perf_counter()  # step() ends in a device->host sync
            self.steps += 1
            if t_dec0 is None:
                t_dec0 = now
            for rid in out:
                if rid not in self.first:
                    self.first[rid] = now - t_submit[rid]
                else:
                    self.tbt.append(now - last[rid])
                last[rid] = now
            if self.t_fail is not None and self.recovery_s is None and \
                    all(last.get(r, 0) > self.t_fail for r in self.victims):
                self.recovery_s = now - self.t_fail
        t_end = time.perf_counter()
        c2 = launch_counts()
        SEEN["run"] = None
        n_ffn = delta(c0, c2)["moe_ffn"]
        if n_ffn != sum(sum(c.values()) for c in self.ffn_c.values()):
            raise AssertionError(f"{n_ffn} expert FFN launches, not all "
                                 f"seen through ops.expert_ffn_cuda: "
                                 f"{self.ffn_c}")
        if engine.chunked is not None:
            engine.chunked.tick = tick
        self.launches = {"prefill": delta(c0, c1), "chunks": chunk_counts,
                         "decode": {k: v - chunk_counts[k] for k, v in
                                    delta(c1, c2).items()}}
        self.streams = [h.tokens() for h in handles]
        # release in reverse, so the slot free lists are back in their
        # initial order and a rerun lands every request in the same slot
        # (expert capacity ranks tokens by slot, so placement is part of
        # the input at the model's capacity factor)
        for h in reversed(handles):
            engine.release_request(h.rid)
        self.n_dec = sum(len(s) - 1 for s in self.streams)
        self.dec_s = t_end - t_dec0

    def report(self, label):
        ttfts = sorted(self.first.values())
        tbt = self.tbt
        print(f"  {label}: TTFT p50 {pct(ttfts, .5) * 1e3:.2f} ms p99 "
              f"{pct(ttfts, .99) * 1e3:.2f} ms; TBT p50 "
              f"{pct(tbt, .5) * 1e3:.2f} ms p99 {pct(tbt, .99) * 1e3:.2f} "
              f"ms max {max(tbt) * 1e3:.2f} ms; decode "
              f"{self.n_dec / self.dec_s:.1f} tok/s ({self.n_dec} tokens "
              f"in {self.dec_s:.3f} s, {self.steps} steps)")
        if self.tick_s:
            print(f"    {len(self.tick_s)} chunk ticks: "
                  f"{', '.join(f'{t * 1e3:.1f}' for t in self.tick_s)} ms")
        for phase, counts in self.launches.items():
            print(f"    {phase}: { {k: v for k, v in counts.items() if v} }"
                  + (f", expert FFN (C, path): "
                     f"{dict(sorted(self.ffn_c[phase].items()))}"
                     if phase in self.ffn_c else ""))


def pct(xs, q):
    xs = sorted(xs)
    return xs[min(len(xs) - 1, max(0, int(round(q * (len(xs) - 1)))))]


def mixtral_8_layers(capacity_factor=None):
    import dataclasses
    from repro_torch.configs import get_config
    cfg = dataclasses.replace(get_config("mixtral_8x7b"), num_layers=8,
                              dtype="bfloat16")
    if capacity_factor is not None:
        cfg = dataclasses.replace(cfg, moe=dataclasses.replace(
            cfg.moe, capacity_factor=capacity_factor))
    return cfg


def serve_phase(torch, profile_dir=None):
    import numpy as np
    from repro_torch.serving.engine import EngineConfig, InferenceEngine
    cfg = mixtral_8_layers()
    ecfg = EngineConfig(max_batch=8, max_seq=512, num_aw=2, num_ew=2)
    t0 = time.perf_counter()
    engine = InferenceEngine(cfg, ecfg, seed=0, device="cuda")
    torch.cuda.synchronize()
    print(f"  engine: {cfg.name} at {cfg.num_layers} layers bf16, "
          f"{cfg.param_count / 1e9:.2f}B params, seeded init "
          f"{time.perf_counter() - t0:.1f} s, "
          f"{torch.cuda.memory_allocated() / 2**30:.1f} GiB on the card")
    rng = np.random.default_rng(0)
    prompts = [rng.integers(0, cfg.vocab_size, size=(128,)).astype(np.int32)
               for _ in range(8)]
    max_new = 32

    # warm-up: the first pass at new shapes pays allocator growth and
    # library setup that a serving process pays once
    Run(torch, engine, prompts, 2)
    reset_counts()
    steps0, calls0 = engine.steps, engine.scheduler.stats.calls
    run = Run(torch, engine, prompts, max_new)
    launches = launch_counts()
    print(f"  main path launches: {launches} "
          f"({engine.scheduler.stats.calls - calls0} prefill calls, "
          f"{engine.steps - steps0} decode steps)")
    for k in ("decode_attention_fused", "flash_attention", "moe_ffn"):
        if launches[k] <= 0:
            raise AssertionError(f"{k} was not launched on the main path")
    if launches["decode_attention_paged"]:
        raise AssertionError("the contiguous engine launched the paged "
                             "kernel")
    for phase, path in (("prefill", "tensor_core"), ("decode", "skinny")):
        n = run.launches[phase]["moe_ffn"]
        if n <= 0 or run.launches[phase][f"moe_ffn/{path}"] != n:
            raise AssertionError(f"the expert FFN's {phase} launches did "
                                 f"not all take the {path} path: "
                                 f"{run.launches[phase]}")
    for st in run.streams:
        if len(st) != max_new or not all(0 <= t < cfg.vocab_size
                                         for t in st):
            raise AssertionError(f"bad stream {st}")
    run.report("serve")
    print(f"  stream r0: {run.streams[0][:12]}...")
    # what the per-step checkpoint adds: one batched gather of every row's
    # new KV and one device-to-host copy
    slots = list(range(8))
    toks = [150] * 8
    ck_ms = host_ms(torch, lambda: engine.layout.extract_tokens(
        engine.cache, slots, toks))
    print(f"  per-step checkpoint gather + device-to-host copy (8 rows, "
          f"{cfg.num_layers} layers): {ck_ms:.3f} ms")

    print("failover: fail_ew(0) after 8 decode steps")
    steps0 = engine.steps

    def fail_ew(eng, handles, steps):
        if steps == 8:
            eng.fail_ew(0)
            return []
        return None
    failed = Run(torch, engine, prompts, max_new, fail=fail_ew).streams
    if failed != run.streams:
        bad = [i for i, (a, b) in enumerate(zip(failed, run.streams))
               if a != b]
        raise AssertionError(f"streams under fail_ew(0) differ from the "
                             f"failure-free run for requests {bad}")
    print(f"  {len(run.streams)} streams bitwise equal to the failure-free "
          f"run ({engine.steps - steps0} decode steps, EW0 failed: "
          f"{sorted(engine.failed_ews)})")
    engine.provision_ew(0)
    if profile_dir is not None:
        profile_decode(torch, engine, prompts, profile_dir)
    return engine, prompts, run


def host_ms(torch, fn, reps: int = 20) -> float:
    """Median host time of ``fn`` through a device sync (for work that
    ends on the host, such as a device-to-host copy)."""
    fn()
    times = []
    for _ in range(reps):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        times.append((time.perf_counter() - t0) * 1e3)
    return statistics.median(times)


def row_count_probe(torch, params):
    """Whether a token's bits depend on how many rows share its call, at
    every row count the runs' prefill and chunk calls gave the row-blocked
    projections and norms (``SEEN["rows"]``) and every capacity C they
    gave the expert FFN (``SEEN["ffn_prefill_c"]``): each result is
    compared bit for bit with the same rows of the largest call, the rows
    taken at two offsets (a token need not sit at the same row, or the
    same position in its row block, in both calls). Raises on any
    mismatch. Also times the blocked projections against one plain
    matmul: the repair's cost per call."""
    from repro_torch.kernels import ops
    from repro_torch.models import layers
    g = torch.Generator(device="cuda").manual_seed(3)
    lp = params["layers"][0]
    weights = {n: lp["attn"][n] for n in ("wq", "wk", "wv", "wo")}
    weights["router"] = lp["moe"]["router"]
    rows = sorted(SEEN["rows"])
    if not rows or not SEEN["ffn_prefill_c"]:
        raise AssertionError("no prefill or chunk call shapes were seen")
    big = max(rows + [1024]) + 64
    d = weights["wq"].shape[0]
    bad = []

    def same(name, fn, x, ref, m):
        for off in (0, 37):
            if not torch.equal(fn(x[off:off + m]), ref[off:off + m]):
                bad.append((name, m, off))
    for name, w in weights.items():
        x = torch.randn((big, w.shape[0]), generator=g, device="cuda").to(
            w.dtype)

        def proj(v, w=w):
            return layers.matmul(v, w, True)
        ref = proj(x)
        for m in rows:
            same(f"x @ {name}", proj, x, ref, m)
    x = torch.randn((big, d), generator=g, device="cuda").to(
        weights["wq"].dtype)

    def ln(v):
        return layers.norm(lp["ln1"], v, 1e-6, True)
    ref = ln(x)
    for m in rows:
        same("rmsnorm", ln, x, ref, m)
    print(f"  row-count probe: projections (wq, wk, wv, wo, router) and "
          f"rmsnorm at M {rows}, each at 2 offsets, against the M={big} "
          f"call")
    # why the norm is row-blocked too: plain rmsnorm (one call) at these
    # row counts and at a one-token and a smallest-chunk call's
    from repro_torch.serving.chunked import CHUNK_MIN
    small = sorted({1, CHUNK_MIN} | set(rows))
    for dt in (torch.bfloat16, torch.float32):
        xd = x.to(dt)
        want = layers.rmsnorm(lp["ln1"], xd, 1e-6)
        differ = [m for m in small if not all(
            torch.equal(layers.rmsnorm(lp["ln1"], xd[o:o + m], 1e-6),
                        want[o:o + m]) for o in (0, 37))]
        print(f"  row-count probe, plain rmsnorm (one call, {dt} input) at "
              f"M {small}: rows differ from the M={big} call's at M "
              f"{differ}")
    ex = lp["moe"]["experts"]
    se = torch.zeros((1,), dtype=torch.int32, device="cuda")
    cs = sorted(SEEN["ffn_prefill_c"])
    xs = torch.randn((1, max(cs) + 64, d), generator=g, device="cuda").to(
        weights["wq"].dtype)

    def ffn(v):
        cnt = torch.full((1,), v.shape[1], dtype=torch.int32, device="cuda")
        return ops.expert_ffn(v.contiguous(), ex["wg"], ex["wu"], ex["wd"],
                              se, cnt, decode=False)
    ref = ffn(xs)
    for c in cs:
        for off in (0, 37):
            if not torch.equal(ffn(xs[:, off:off + c]), ref[:, off:off + c]):
                bad.append(("expert FFN", c, off))
    print(f"  row-count probe: expert FFN prefill/chunk path at C {cs}, "
          f"each at 2 offsets, against the C={xs.shape[1]} call")
    if bad:
        raise AssertionError(f"rows whose bits depend on the call's row "
                             f"count: {bad}")
    print("  row-count probe: every row bitwise equal to the largest "
          "call's")
    for name in ("wq", "wk"):
        w = weights[name]
        for m in (64, 128, 1024):
            xm = torch.randn((m, d), generator=g, device="cuda").to(w.dtype)
            tb = time_ms(torch, lambda: layers.matmul(xm, w, True))
            tp = time_ms(torch, lambda: xm @ w)
            print(f"  repair cost, x @ {name} {tuple(w.shape)} at M={m}: "
                  f"row-blocked {tb:.4f} ms, one matmul {tp:.4f} ms")
    xm = torch.randn((1024, d), generator=g, device="cuda").to(
        weights["wq"].dtype)
    tb = time_ms(torch, lambda: layers.norm(lp["ln1"], xm, 1e-6, True))
    tp = time_ms(torch, lambda: layers.rmsnorm(lp["ln1"], xm, 1e-6))
    print(f"  repair cost, rmsnorm at M=1024: row-blocked {tb:.4f} ms, "
          f"one call {tp:.4f} ms")


def kv_plane_phase(torch, engine, prompts):
    """Whole-prompt contiguous, chunked contiguous and chunked paged
    engines on the serve phase's weights at capacity factor 4.0; then the
    AW failover on the paged engine. Returns the launches per phase of
    the whole-prompt and the paged runs."""
    from repro_torch.serving.engine import EngineConfig, InferenceEngine
    # capacity >= tokens in every call: no token is ever dropped, so a
    # stream does not depend on its slot or on how its prompt is chunked
    cfg = mixtral_8_layers(capacity_factor=4.0)
    base = dict(max_batch=8, max_seq=512, num_aw=2, num_ew=2)
    engines = {
        "whole": InferenceEngine(cfg, EngineConfig(**base),
                                 params=engine.params, device="cuda"),
        "contiguous": InferenceEngine(
            cfg, EngineConfig(**base, chunk_token_budget=CHUNK_BUDGET),
            params=engine.params, device="cuda"),
        "paged": InferenceEngine(
            cfg, EngineConfig(**base, chunk_token_budget=CHUNK_BUDGET,
                              kv_page_tokens=PAGE_TOKENS),
            params=engine.params, device="cuda"),
    }
    max_new = 32
    runs = {}
    for name, eng in engines.items():
        Run(torch, eng, prompts, 2)                   # warm-up
        reset_counts()
        runs[name] = Run(torch, eng, prompts, max_new)
        runs[name].report(name)
    paged = engines["paged"]
    if runs["paged"].streams != runs["contiguous"].streams:
        bad = [i for i, (a, b) in enumerate(zip(
            runs["paged"].streams, runs["contiguous"].streams)) if a != b]
        raise AssertionError(f"paged streams differ from contiguous ones "
                             f"for requests {bad}")
    print(f"  paged (page {PAGE_TOKENS} tokens) streams bitwise equal to "
          f"contiguous ones, both chunked at {CHUNK_BUDGET} tokens/step")
    row_count_probe(torch, engine.params)
    if runs["contiguous"].streams != runs["whole"].streams:
        bad = [i for i, (a, b) in enumerate(zip(runs["contiguous"].streams,
                                                runs["whole"].streams))
               if a != b]
        raise AssertionError(f"chunked streams differ from whole-prompt "
                             f"streams for requests {bad}")
    print("  chunked streams bitwise equal to whole-prompt streams")
    lp = {k: sum(ph[k] for ph in runs["paged"].launches.values())
          for k in runs["paged"].launches["decode"]}
    if lp["decode_attention_paged"] <= 0 or lp["decode_attention_fused"]:
        raise AssertionError(f"the paged engine's decode steps did not all "
                             f"launch the paged kernel: {lp}")
    if lp["flash_attention"] <= 0 or lp["moe_ffn"] <= 0:
        raise AssertionError(f"a kernel of the paged path was not "
                             f"launched: {lp}")
    dec = runs["paged"].launches["decode"]
    if dec["moe_ffn/tensor_core"] != dec["moe_ffn"]:
        raise AssertionError(f"the paged decode steps' expert FFN did not "
                             f"all take the tensor-core path: {dec}")
    print(f"  paged path launches: {lp}")
    print(f"  chunk calls: paged {paged.chunked.stats.calls}, shapes "
          f"{sorted(paged.chunked.stats.shapes)}")
    paged.pages.check()
    print(f"  PagePool.check() passed: {paged.pages.stats()}")

    print("AW failover: fail_aw(0) once every request has 8 tokens")
    restores0 = paged.store.stats.restores
    bytes0 = paged.store.stats.bytes_restored
    recovered_now = []

    def fail_aw(eng, handles, steps):
        if min(len(h.tokens()) for h in handles) < 8:
            return None
        victims = [r.rid for r in eng.requests.values()
                   if r.aw == 0 and not r.done]
        eng.fail_aw(0)
        recovered_now.extend(eng.recover_aw_requests())
        eng.provision_aw(0)
        return victims
    fo = Run(torch, paged, prompts, max_new, fail=fail_aw)
    if fo.t_fail is None:
        raise AssertionError("the AW failure was never injected")
    if fo.streams != runs["paged"].streams:
        bad = [i for i, (a, b) in enumerate(zip(fo.streams,
                                                runs["paged"].streams))
               if a != b]
        raise AssertionError(f"streams under fail_aw(0) differ from the "
                             f"failure-free run for requests {bad}")
    restored = paged.store.stats.restores - restores0
    print(f"  {len(fo.streams)} streams bitwise equal to the failure-free "
          f"paged run; {len(fo.victims)} requests on AW0, "
          f"{len(recovered_now)} restored by recover_aw_requests (AW1 "
          f"full), {restored} restored at the next step")
    print(f"  restored {restored} requests, "
          f"{paged.store.stats.bytes_restored - bytes0} bytes; fail_aw to "
          f"the restored requests' next token {fo.recovery_s * 1e3:.2f} ms "
          f"(host clock); largest gap between tokens "
          f"{max(fo.tbt) * 1e3:.2f} ms; on {card_line()}")
    fo.report("AW failover")
    paged.pages.check()
    if restored != len(fo.victims) or recovered_now:
        raise AssertionError(f"expected the {len(fo.victims)} requests of "
                             f"AW0 restored at the step after "
                             f"provision_aw(0); {restored} restored, "
                             f"{recovered_now} at recover_aw_requests")
    return runs["whole"], runs["paged"]


def zamba2_13_layers():
    import dataclasses
    from repro_torch.configs import get_config
    return dataclasses.replace(get_config("zamba2_7b"),
                               num_layers=HYBRID_LAYERS, dtype="bfloat16")


def hybrid_phase(torch, profile_dir=None):
    """Zamba2-7B at full width, 13 layers, bf16 (2 units of 6 Mamba2
    blocks + the shared attention block, then 1 trailing block): 8
    requests of 128 prompt tokens and 16 greedy new tokens, each
    prefilled alone through ``client.submit`` (the exact whole-prompt
    scheme: a recurrent state never sees a pad); then the same requests
    with ``fail_aw(0)`` once every request has 8 tokens, recover,
    provision: every stream must equal the failure-free one bit for bit.
    Returns the failure-free Run."""
    import numpy as np
    from repro_torch.models.hybrid import _geometry
    from repro_torch.serving.engine import EngineConfig, InferenceEngine
    cfg = zamba2_13_layers()
    every, units, trailing = _geometry(cfg)
    ecfg = EngineConfig(max_batch=8, max_seq=HYBRID_MAX_SEQ, num_aw=2,
                        num_ew=1)
    t0 = time.perf_counter()
    engine = InferenceEngine(cfg, ecfg, seed=0, device="cuda")
    torch.cuda.synchronize()
    print(f"  engine: {cfg.name} at {cfg.num_layers} layers ({units} units "
          f"of {every} Mamba2 blocks + the shared block, {trailing} "
          f"trailing) bf16, {cfg.param_count / 1e9:.2f}B params, seeded "
          f"init {time.perf_counter() - t0:.1f} s, "
          f"{torch.cuda.memory_allocated() / 2**30:.1f} GiB on the card")
    rng = np.random.default_rng(1)
    prompts = [rng.integers(0, cfg.vocab_size, size=(128,)).astype(np.int32)
               for _ in range(8)]
    max_new = 16
    Run(torch, engine, prompts, 2)                    # warm-up
    reset_counts()
    calls0, steps0 = engine.scheduler.stats.calls, engine.steps
    run = Run(torch, engine, prompts, max_new)
    calls = engine.scheduler.stats.calls - calls0
    steps = engine.steps - steps0
    pre, dec = run.launches["prefill"], run.launches["decode"]
    want = {"prefill": {"ssm_scan": cfg.num_layers * calls,
                        "flash_attention": units * calls},
            "decode": {"ssm_scan": 0, "decode_attention_fused":
                       units * steps}}
    for phase, kernels in want.items():
        for k, n in kernels.items():
            if run.launches[phase][k] != n:
                raise AssertionError(
                    f"hybrid {phase}: {k} launched "
                    f"{run.launches[phase][k]} times, expected {n} "
                    f"({calls} prefill calls, {steps} decode steps)")
    if calls != len(prompts) or pre["moe_ffn"] or dec["moe_ffn"] or \
            dec["decode_attention_paged"]:
        raise AssertionError(f"hybrid launches off the path: {run.launches}")
    for st in run.streams:
        if len(st) != max_new or not all(0 <= t < cfg.vocab_size
                                         for t in st):
            raise AssertionError(f"bad stream {st}")
    print(f"  main path: {calls} prefill calls (each one 128-token prompt: "
          f"{cfg.num_layers} ssm_scan + {units} flash launches), {steps} "
          f"decode steps ({units} decode attention launches each)")
    run.report("hybrid serve")
    print(f"  stream r0: {run.streams[0][:12]}...")
    # what the per-step checkpoint copies: every row's new K/V plus its
    # whole recurrent state (h and conv of every Mamba2 block)
    slots, toks = list(range(8)), [150] * 8
    leaves = engine.layout.extract_tokens(engine.cache, slots, toks)
    # a state leaf is a list of per-row views, one host copy per slot
    nbytes = sum(sum(v.nbytes for v in t) if isinstance(t, list)
                 else t.nbytes for t in leaves)
    ck_ms = host_ms(torch, lambda: engine.layout.extract_tokens(
        engine.cache, slots, toks), reps=10)
    print(f"  per-step checkpoint gather + device-to-host copy (8 rows): "
          f"{ck_ms:.3f} ms, {nbytes} bytes ({nbytes // 8} per token)")

    print("hybrid AW failover: fail_aw(0) once every request has 8 tokens")
    restores0 = engine.store.stats.restores
    bytes0 = engine.store.stats.bytes_restored
    recovered_now = []

    def fail_aw(eng, handles, steps):
        if min(len(h.tokens()) for h in handles) < 8:
            return None
        victims = [r.rid for r in eng.requests.values()
                   if r.aw == 0 and not r.done]
        eng.fail_aw(0)
        recovered_now.extend(eng.recover_aw_requests())
        eng.provision_aw(0)
        return victims
    fo = Run(torch, engine, prompts, max_new, fail=fail_aw)
    if fo.t_fail is None:
        raise AssertionError("the AW failure was never injected")
    if fo.streams != run.streams:
        bad = [i for i, (a, b) in enumerate(zip(fo.streams, run.streams))
               if a != b]
        raise AssertionError(f"hybrid streams under fail_aw(0) differ from "
                             f"the failure-free run for requests {bad}")
    restored = engine.store.stats.restores - restores0
    if restored != len(fo.victims) or recovered_now or not fo.victims:
        raise AssertionError(f"expected the {len(fo.victims)} requests of "
                             f"AW0 restored at the step after "
                             f"provision_aw(0); {restored} restored, "
                             f"{recovered_now} at recover_aw_requests")
    print(f"  {len(fo.streams)} streams bitwise equal to the failure-free "
          f"run; restored {restored} requests, "
          f"{engine.store.stats.bytes_restored - bytes0} bytes; fail_aw to "
          f"the restored requests' next token {fo.recovery_s * 1e3:.2f} ms "
          f"(host clock); largest gap between tokens "
          f"{max(fo.tbt) * 1e3:.2f} ms; on {card_line()}")
    fo.report("hybrid AW failover")
    if profile_dir is not None:
        profile_decode(torch, engine, prompts, profile_dir / "hybrid")
    return run


def profile_decode(torch, engine, prompts, out_dir):
    """Trace 4 steady decode steps of the 8-request batch and one prefill
    with torch.profiler: wall time per step, device-busy time, and the
    kernels that take it. Writes the Chrome trace and the full table to
    ``out_dir``."""
    from torch.profiler import ProfilerActivity, profile
    from repro_torch.serving.api import RequestSpec
    out_dir.mkdir(parents=True, exist_ok=True)
    handles = [engine.client.submit(RequestSpec(
        rid=f"p{i}", prompt=p, max_new=16)) for i, p in enumerate(prompts)]
    for _ in range(2):
        engine.step()
    torch.cuda.synchronize()
    acts = [ProfilerActivity.CPU, ProfilerActivity.CUDA]
    steps = 4
    with profile(activities=acts) as prof:
        t0 = time.perf_counter()
        for _ in range(steps):
            engine.step()
        torch.cuda.synchronize()
        wall = (time.perf_counter() - t0) / steps
    for h in reversed(handles):
        while not h.done():
            engine.step()
        engine.release_request(h.rid)
    with profile(activities=acts) as prof_pre:
        t0 = time.perf_counter()
        h = engine.client.submit(RequestSpec(rid="pp", prompt=prompts[0],
                                             max_new=1))
        torch.cuda.synchronize()
        wall_pre = time.perf_counter() - t0
    while not h.done():
        engine.step()
    engine.release_request("pp")
    from torch.autograd import DeviceType
    for name, pr, w, n in (("decode step", prof, wall, steps),
                           ("prefill (1 x 128 tokens)", prof_pre, wall_pre,
                            1)):
        ka = pr.key_averages()

        def dev_us(e):
            return getattr(e, "self_device_time_total", 0) or \
                getattr(e, "self_cuda_time_total", 0)
        # device-side events only (kernels, copies): an operator's own row
        # repeats the time of the kernels it launched
        kern = [e for e in ka if e.device_type == DeviceType.CUDA]
        busy = sum(dev_us(e) for e in kern) / 1e3 / n
        n_kern = sum(e.count for e in kern) / n
        print(f"  profile {name}: wall {w * 1e3:.2f} ms, device busy "
              f"{busy:.2f} ms ({100 * busy / (w * 1e3):.1f}%), "
              f"{n_kern:.0f} device ops per call")
        top = sorted(kern, key=dev_us, reverse=True)[:8]
        for e in top:
            print(f"    {dev_us(e) / 1e3 / n:8.3f} ms  x{e.count / n:5.0f}  "
                  f"{e.key[:70]}")
        tag = "decode" if n > 1 else "prefill"
        (out_dir / f"profile_{tag}.txt").write_text(ka.table(
            sort_by="self_cpu_time_total", row_limit=60))
        pr.export_chrome_trace(str(out_dir / f"trace_{tag}.json"))


def main():
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--profile", metavar="DIR", type=Path, default=None,
                    help="also trace decode steps and a prefill with "
                    "torch.profiler and write the traces to DIR")
    args = ap.parse_args()

    import torch
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device visible", file=sys.stderr)
        return 2
    src = Path(__file__).resolve().parent / "src"
    if not (src / "repro_torch").is_dir():
        print(f"chip_smoke: {src / 'repro_torch'} not found; run from a "
              f"checkout of the repository", file=sys.stderr)
        return 2
    sys.path.insert(0, str(src))
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False

    from repro_torch.kernels import build

    print(card_line())
    print(f"torch {torch.__version__} cuda {torch.version.cuda} on "
          f"{torch.cuda.get_device_name(0)}")
    t0 = time.perf_counter()
    build.build_all()
    print(f"kernel build: {time.perf_counter() - t0:.1f} s "
          f"(nvcc wall {build.build_seconds:.1f} s)")
    for name, log in sorted(build.build_log.items()):
        for line in log.splitlines():
            if "registers" in line or "spill" in line:
                print(f"  {name}: {line.strip()}")

    observe_kernel_shapes()
    records = []
    g = torch.Generator(device="cuda").manual_seed(0)
    kernel_decode_attention(torch, g, records)
    print("decode_attention at Zamba2's shared block (Dh 112, G 1)")
    decode_attention_at(torch, g, records, "decode_attention_fused[Dh112]",
                        8, 32, 32, 112, HYBRID_MAX_SEQ)
    kernel_decode_attention_paged(torch, g, records)
    kernel_flash_attention(torch, g, records)
    print("flash_attention at Zamba2's shared block (Dh 112, G 1)")
    flash_attention_at(torch, g, records, "flash_attention[Dh112]", 1, 128,
                       32, 32, 112)
    kernel_flash_chunk(torch, g, records)
    kernel_moe_gemm(torch, g, records, MOE_SHAPES)
    kernel_ssm_scan(torch, g, records, SCAN_SHAPES)

    import dataclasses
    from repro_torch.configs import get_config
    print("reference: reduced Mixtral, card kernels vs CPU plain path")
    reference_phase(torch, get_config("mixtral_8x7b").reduced())
    print("reference: reduced Zamba2 with a trailing block, card kernels vs "
          "CPU plain path")
    reference_phase(torch, dataclasses.replace(
        get_config("zamba2_7b").reduced(), num_layers=5))
    print("serve: Mixtral-8x7B widths, 8 layers, bf16, contiguous KV")
    engine, prompts, serve = serve_phase(torch, profile_dir=args.profile)
    print(f"kv plane: the same weights at capacity factor 4.0, chunked "
          f"prefill ({CHUNK_BUDGET} tokens/step), paged KV "
          f"({PAGE_TOKENS}-token pages)")
    whole, paged = kv_plane_phase(torch, engine, prompts)
    del engine
    gc.collect()                 # the engines hold reference cycles
    torch.cuda.empty_cache()
    print(f"hybrid: Zamba2-7B widths, {HYBRID_LAYERS} layers, bf16, "
          f"contiguous KV + recurrent state, 2 AWs")
    hybrid = hybrid_phase(torch, profile_dir=args.profile)

    checked = {(c, path) for _, c, _, path in MOE_SHAPES}
    if not set(SEEN["ffn"]) <= checked:
        raise AssertionError(f"the expert FFN ran at (C, path) "
                             f"{sorted(set(SEEN['ffn']) - checked)}, which "
                             f"the kernel phase did not hold to its plain "
                             f"version")
    print(f"expert FFN (C, path) on every run: {sorted(SEEN['ffn'])}, each "
          f"held to its plain version in the kernel phase")
    if not SEEN["scan"] <= set(SCAN_SHAPES):
        raise AssertionError(f"the SSD scan ran at (B, S) "
                             f"{sorted(SEEN['scan'] - set(SCAN_SHAPES))}, "
                             f"which the kernel phase did not check")
    print(f"ssm_scan (B, S) on every run: {sorted(SEEN['scan'])}, each held "
          f"to its plain version in the kernel phase")

    def total(run, k):
        return sum(ph[k] for ph in run.launches.values())

    def ffn_launches(run, c, path):
        return sum(cnt[(c, path)] for cnt in run.ffn_c.values())
    runs = {"serve": serve, "whole": whole, "paged": paged}
    moe_run = {"decode": "serve", "prefill": "serve", "prefill-kv": "whole"}
    launches = {
        "decode_attention_fused": total(serve, "decode_attention_fused"),
        "decode_attention_fused[Dh112]":
            total(hybrid, "decode_attention_fused"),
        "decode_attention_paged": total(paged, "decode_attention_paged"),
        "flash_attention": total(serve, "flash_attention"),
        "flash_attention[Dh112]": total(hybrid, "flash_attention"),
        "flash_attention[chunk]": paged.launches["chunks"]["flash_attention"],
        "ssm_scan": total(hybrid, "ssm_scan"),
    }
    for label, c, _, path in MOE_SHAPES:
        launches[f"moe_gemm[{label}]"] = ffn_launches(
            runs[moe_run.get(label, "paged")], c, path)
    for r in records:
        r["launches"] = launches[r["name"]]
        if r["launches"] <= 0:
            raise AssertionError(f"{r['name']} was not launched on its "
                                 f"path")
    print(card_line())
    print(json.dumps({"kernels": records}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
