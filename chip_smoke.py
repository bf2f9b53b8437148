#!/usr/bin/env python3
"""Drive the PyTorch port (``src/repro_torch``) on one NVIDIA GPU.

    python3 chip_smoke.py                  # every phase
    python3 chip_smoke.py --profile DIR    # and a torch.profiler pass

Phases, each of which raises on failure (exit code != 0):
  1. card     — ``nvidia-smi`` name and power limit, then the kernel build
                (one nvcc per CUDA source, all started together).
  2. kernels  — each hand-written kernel at the shapes the serving path
                gives it (bfloat16) and once in float32 at a small shape,
                held to its plain PyTorch version on the card (bf16 2e-2,
                fp32 2e-5, atol and rtol; at the serving shapes the bf16
                decode-attention and expert-FFN results are also held to
                the float32 plain version on the same inputs within half
                a bf16 ulp plus 1e-4); kernel, plain-version and
                library-call times by CUDA events (median of 20 after
                warm-up, L2 flushed before each run).
  3. reference — a reduced float32 Mixtral on the card against the same
                model's plain path on the CPU (logits to 1e-3).
  4. serve    — Mixtral-8x7B widths at 8 layers in bfloat16 with seeded
                random weights: 8 requests of 128 prompt tokens and 32
                greedy new tokens through ``engine.client.submit`` and
                ``engine.step()``; every kernel's launch count must grow.
                Launches are read per phase (the prefills run inside
                ``client.submit``, the decode steps inside ``step()``) and
                the expert FFN's also per kernel path.
  5. failover — the same requests with ``engine.fail_ew(0)`` after 8
                decode steps; every stream must equal the failure-free one
                bit for bit.
The line before the last is the kernels' JSON record; the last line is
``{"ok": true, "device": {...}}``.
"""
import argparse
import json
import statistics
import subprocess
import sys
import time
from pathlib import Path

HBM_BYTES_PER_S = 3.35e12          # H100 SXM HBM3
BF16_FLOPS_PER_S = 989e12          # H100 SXM dense bf16 tensor cores
TOL = {"bfloat16": 2e-2, "float32": 2e-5}
# a bfloat16 result against the float32 plain version on the same inputs:
# rounding once at the output costs at most half an ulp (2^-8 relative);
# 1e-4 absolute covers float32 summation order
ROUND_ATOL, ROUND_RTOL = 1e-4, 2.0 ** -8


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


def bound(nbytes: float, flops: float):
    t_bytes = nbytes / HBM_BYTES_PER_S * 1e3
    t_ops = flops / BF16_FLOPS_PER_S * 1e3
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
    import torch.nn.functional as F
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
    # the serving shape: 8 rows, Mixtral heads, a 512-token cache; in
    # float32 first, so the instantiation the main path uses is held to
    # the float32 bar
    b, h, hkv, dh, sc = 8, 32, 8, 128, 512
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
        name="decode_attention_fused", route="cuda",
        source="src/repro_torch/csrc/decode_attention.cu",
        replaces=da.KERNEL.replaces, max_abs_err=err, ms=ms,
        plain_ms=plain_ms, bound_ms=b_ms, bound_by=b_by,
        library_ms=lib_ms, shape=f"B{b} H{h} Hkv{hkv} Dh{dh} Sc{sc} bf16"))
    print(f"  time {ms:.4f} ms, plain {plain_ms:.4f} ms, SDPA {lib_ms:.4f} "
          f"ms, bound {b_ms:.4f} ms ({b_by})")


def kernel_flash_attention(torch, g, records, b):
    from repro_torch.kernels import flash_attention as fa
    from repro_torch.models.attention import blockwise_attention
    import torch.nn.functional as F
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
    s, h, hkv, dh = 128, 32, 8, 128
    q = torch.randn((b, s, h, dh), generator=g, device="cuda").bfloat16()
    k = torch.randn((b, s, hkv, dh), generator=g, device="cuda").bfloat16()
    v = torch.randn((b, s, hkv, dh), generator=g, device="cuda").bfloat16()
    p = torch.arange(s, device="cuda", dtype=torch.int32).repeat(b, 1)

    def kern():
        return fa.flash_attention_cuda(q, k, v, p, p)

    def plain():
        return blockwise_attention(q, k, v, p, p, block_k=16)

    err = check(f"bf16 B{b} S{s} H{h} Hkv{hkv} Dh{dh} causal", kern(),
                plain(), "bfloat16")
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
        name="flash_attention", route="cuda",
        source="src/repro_torch/csrc/flash_attention.cu",
        replaces=fa.KERNEL.replaces, max_abs_err=err, ms=ms,
        plain_ms=plain_ms, bound_ms=b_ms, bound_by=b_by, library_ms=lib_ms,
        shape=f"B{b} S{s} H{h} Hkv{hkv} Dh{dh} causal bf16"))
    print(f"  time {ms:.4f} ms, plain {plain_ms:.4f} ms, SDPA {lib_ms:.4f} "
          f"ms, bound {b_ms:.4f} ms ({b_by})")


def kernel_moe_gemm(torch, g, records, shapes):
    """``shapes``: (label, C, the kernel path that C must take)."""
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
                  mg.expert_ffn_cuda(x, wg, w[1], wd, se, cnt, act=act),
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
    for label, c, path in shapes:
        cnt = torch.tensor([c] * 8 + [0] * 8, dtype=torch.int32,
                           device="cuda")
        x = torch.randn((n_slot, c, d), generator=g,
                        device="cuda").bfloat16()
        x[8:] = 0

        def kern():
            return mg.expert_ffn_cuda(x, bank[0], bank[1], wdn, se, cnt)

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
            shape=f"P{n_slot} (8 active) C{c} D{d} F{f} bf16"))
        print(f"  time {ms:.4f} ms, plain {plain_ms:.4f} ms, bmm chain "
              f"{lib_ms:.4f} ms, bound {b_ms:.4f} ms ({b_by})")
        del x, cnt
    del bank, wdn
    torch.cuda.empty_cache()


# --------------------------------------------------------------------------
# reference and serve phases
# --------------------------------------------------------------------------

def reference_phase(torch):
    """A reduced float32 Mixtral through the kernels on the card against
    the same model's plain path on the CPU."""
    from repro_torch.configs import get_config
    from repro_torch.models import get_model
    cfg = get_config("mixtral_8x7b").reduced()
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
        print(f"  reduced fp32 Mixtral {name} logits, card vs CPU: "
              f"max_abs_err {err:.3e} (tol 1e-3)")
        if not err <= 1e-3:
            raise AssertionError(f"{name} logits disagree with the CPU "
                                 f"plain path: {err:.3e}")


def launch_counts():
    """Every kernel's launch count, and the expert FFN's per path."""
    from repro_torch.kernels import decode_attention, flash_attention, \
        moe_gemm
    counts = {k.symbol: k.launches for k in (
        decode_attention.KERNEL, flash_attention.KERNEL, moe_gemm.KERNEL)}
    counts.update({f"moe_ffn/{k}": v
                   for k, v in moe_gemm.path_launches.items()})
    return counts


def serve(torch, engine, prompts, max_new, fail_after=None):
    """Submit every prompt through the client, step until all are done.
    Returns (streams, ttft_s, tbt_s list, decode_tokens, decode_s,
    launches): ``launches`` holds each phase's launch counts, "prefill"
    (the submits, which admit and prefill) and "decode" (the steps)."""
    from repro_torch.serving.api import RequestSpec
    if engine.device.type == "cuda":
        torch.cuda.synchronize()
    c0 = launch_counts()
    t_submit, handles = {}, []
    for i, p in enumerate(prompts):
        t_submit[f"r{i}"] = time.perf_counter()
        handles.append(engine.client.submit(RequestSpec(
            rid=f"r{i}", prompt=p, max_new=max_new)))
    c1 = launch_counts()
    first, last, tbt = {}, {}, []
    steps = 0
    t_dec0 = None
    while not all(h.done() for h in handles):
        if fail_after is not None and steps == fail_after:
            engine.fail_ew(0)
        out = engine.step()
        now = time.perf_counter()      # step() ends in a device->host sync
        steps += 1
        if t_dec0 is None:
            t_dec0 = now
        for rid in out:
            if rid not in first:
                first[rid] = now - t_submit[rid]
            else:
                tbt.append(now - last[rid])
            last[rid] = now
    t_end = time.perf_counter()
    c2 = launch_counts()
    launches = {"prefill": {k: c1[k] - c0[k] for k in c0},
                "decode": {k: c2[k] - c1[k] for k in c0}}
    streams = [h.tokens() for h in handles]
    # release in reverse, so the slot free lists are back in their initial
    # order and a rerun lands every request in the same slot (expert
    # capacity ranks tokens by slot, so placement is part of the input)
    for h in reversed(handles):
        engine.release_request(h.rid)
    n_dec = sum(len(s) - 1 for s in streams)
    return streams, first, tbt, n_dec, t_end - t_dec0, launches


def pct(xs, q):
    xs = sorted(xs)
    return xs[min(len(xs) - 1, max(0, int(round(q * (len(xs) - 1)))))]


def serve_phase(torch, counters, path_counts, profile_dir=None):
    import dataclasses
    import numpy as np
    from repro_torch.configs import get_config
    from repro_torch.serving.engine import EngineConfig, InferenceEngine
    cfg = dataclasses.replace(get_config("mixtral_8x7b"), num_layers=8,
                              dtype="bfloat16")
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
    serve(torch, engine, prompts, 2)
    for k in counters:
        k.launches = 0
    for k in path_counts:
        path_counts[k] = 0
    steps0, calls0 = engine.steps, engine.scheduler.stats.calls
    streams, first, tbt, n_dec, dec_s, phases = serve(torch, engine,
                                                      prompts, max_new)
    launches = {k.symbol: k.launches for k in counters}
    prefill_calls = engine.scheduler.stats.calls - calls0
    print(f"  main path launches: {launches} "
          f"({prefill_calls} prefill calls, {engine.steps - steps0} decode "
          f"steps)")
    for phase, counts in phases.items():
        print(f"    {phase}: {counts}")
    for k in counters:
        if k.launches <= 0:
            raise AssertionError(f"{k.symbol} was not launched on the "
                                 f"main path")
    for phase, path in (("prefill", "tensor_core"), ("decode", "skinny")):
        n = phases[phase]["moe_ffn"]
        if n <= 0 or phases[phase][f"moe_ffn/{path}"] != n:
            raise AssertionError(f"the expert FFN's {phase} launches did "
                                 f"not all take the {path} path: "
                                 f"{phases[phase]}")
    for s in streams:
        if len(s) != max_new or not all(0 <= t < cfg.vocab_size for t in s):
            raise AssertionError(f"bad stream {s}")
    ttfts = sorted(first.values())
    print(f"  TTFT p50 {pct(ttfts, .5) * 1e3:.2f} ms p99 "
          f"{pct(ttfts, .99) * 1e3:.2f} ms; TBT p50 "
          f"{pct(tbt, .5) * 1e3:.2f} ms p99 {pct(tbt, .99) * 1e3:.2f} ms; "
          f"decode {n_dec / dec_s:.1f} tok/s "
          f"({n_dec} tokens in {dec_s:.3f} s)")
    print(f"  stream r0: {streams[0][:12]}...")

    print("failover: fail_ew(0) after 8 decode steps")
    steps0 = engine.steps
    failed = serve(torch, engine, prompts, max_new, fail_after=8)[0]
    if failed != streams:
        bad = [i for i, (a, b) in enumerate(zip(failed, streams)) if a != b]
        raise AssertionError(f"streams under fail_ew(0) differ from the "
                             f"failure-free run for requests {bad}")
    print(f"  {len(streams)} streams bitwise equal to the failure-free run "
          f"({engine.steps - steps0} decode steps, EW0 failed: "
          f"{sorted(engine.failed_ews)})")
    if profile_dir is not None:
        profile_decode(torch, engine, prompts, profile_dir)
    return launches, phases


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
    from repro_torch.kernels import decode_attention, flash_attention, \
        moe_gemm

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

    records = []
    g = torch.Generator(device="cuda").manual_seed(0)
    kernel_decode_attention(torch, g, records)
    kernel_flash_attention(torch, g, records, b=1)
    kernel_moe_gemm(torch, g, records, [("decode", 2, "skinny"),
                                        ("prefill", 64, "tensor_core")])
    counters = [decode_attention.KERNEL, flash_attention.KERNEL,
                moe_gemm.KERNEL]

    print("reference: reduced Mixtral, card kernels vs CPU plain path")
    reference_phase(torch)
    print("serve: Mixtral-8x7B widths, 8 layers, bf16")
    launches, phases = serve_phase(torch, counters, moe_gemm.path_launches,
                                   profile_dir=args.profile)
    for r in records:
        r["launches"] = {
            "decode_attention_fused": launches["decode_attention_fused"],
            "flash_attention": launches["flash_attention"],
            "moe_gemm[prefill]": phases["prefill"]["moe_ffn"],
            "moe_gemm[decode]": phases["decode"]["moe_ffn"],
        }[r["name"]]
    print(json.dumps({"kernels": records}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
