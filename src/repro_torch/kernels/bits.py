"""Digests of the attention kernels', the expert FFN's and the SSD scan's
outputs on seeded inputs, to show that a change to a kernel's source kept
the bits of the shapes it had before; and, against another copy of the
sources, both trees' times at the serving shapes.

The attention cases are the (Dh, G) pairs the decode kernels (fused and
paged) were built for before head dims 80 and 256 and group size 6 came in
(Dh 32, 64, 112, 128 at G 1, 2, 4, 8), the flash kernel's head dims of
that time and every pair the partial kernel is built for, each in float32
and bfloat16, with a window, a softcap and masked positions (the partial
cases over three 128-position splits, with a row that has no valid key).
The expert FFN's cases run its decode ("skinny"),
tensor-core and CUDA-core paths; the scan's cases take 2, 3 and 127
chunks (y and the final state in one digest). Inputs come from numpy,
seeded per case, so every machine gives the kernels the same bits.

    PYTHONPATH=src python -m repro_torch.kernels.bits               # digests
    PYTHONPATH=src python -m repro_torch.kernels.bits --csrc DIR    # and DIR's
    PYTHONPATH=src python -m repro_torch.kernels.bits --csrc DIR --time

With ``--csrc DIR`` it also builds ``DIR/decode_attention.cu``,
``DIR/flash_attention.cu``, ``DIR/moe_gemm.cu`` and ``DIR/ssm_scan.cu``
(another copy of the sources, e.g. an earlier commit's, with the same C
entry points; a fused or paged entry of a source without
``decode_attention_workspace``, and a partial entry of one without
``decode_attention_partial_workspace``, is called without the split
body's scratch) and compares every digest with this checkout's; a
partial case at a (Dh, G) that DIR's kernel is not built for is reported
and left out. It fails unless the cases in ``KEPT`` are equal: the
float32 attention cases (decode, flash and partial), whose bodies no
later change touched, and the 6 scan cases (its chunk-parallel form keeps
every element's order of sums). The others are reported: bf16 flash (its
tensor-core body rounds per key tile), bf16 decode and partial (the split
body sums per tile and per split) and the expert FFN (its tensor-core and
decode paths were redesigned). ``--time`` then times both trees' decode,
paged, partial, flash, expert-FFN and scan entry points at the serving
shapes (``TIMED``), in turns on one card: DIR's, this checkout's, this
checkout's, DIR's. Needs an NVIDIA GPU and nvcc.
"""
from __future__ import annotations

import argparse
import ctypes
import hashlib
import statistics
import subprocess
import sys
import time
from pathlib import Path

import numpy as np
import torch

from repro_torch.kernels import build

DECODE_DH = (32, 64, 112, 128)
DECODE_G = (1, 2, 4, 8)
FLASH_DH = (32, 64, 112, 128)
#: the (Dh, G) pairs the partial kernel is built for
PARTIAL_PAIRS = ((80, 4), (128, 4), (128, 6), (256, 2))
DTYPES = ("float32", "bfloat16")
#: (kernel, Dh, G, dtype) of every case
CASES = ([(k, dh, g, dt) for k in ("fused", "paged") for dh in DECODE_DH
          for g in DECODE_G for dt in DTYPES]
         + [("flash", dh, g, dt) for dh in FLASH_DH for g in (1, 4)
            for dt in DTYPES]
         + [("partial", dh, g, dt) for dh, g in PARTIAL_PAIRS
            for dt in DTYPES])
#: (kernel, C, decode, dtype): the expert FFN's decode path (decode steps
#: at C 2 and 8; float32 at C 8 takes the CUDA-core path), its
#: tensor-core path (bf16 otherwise) and its CUDA-core path (fp32)
MOE_CASES = [("moe", c, dec, dt) for c, dec in ((2, True), (8, True),
                                                (2, False), (40, False),
                                                (130, False))
             for dt in DTYPES]
#: (kernel, S, B, dtype): the SSD scan at chunk 64 (S 127 runs 127 chunks
#: of 1 step), H 4, P = N = 64
SCAN_CASES = [("scan", s, 2, dt) for s in (128, 192, 127) for dt in DTYPES]
SCAN_H, SCAN_PN, SCAN_CHUNK = 4, 64, 64
#: the cases whose bits a change to the sources must keep
KEPT = [c for c in CASES if c[3] == "float32"] + SCAN_CASES
B, HKV, SC, PT, NBLK, S = 3, 2, 70, 16, 5, 45
WINDOW, SOFTCAP = 24, 30.0
PARTIAL_SC, PARTIAL_WINDOW = 300, 160
MOE_P, MOE_D, MOE_F, MOE_E = 4, 96, 160, 3


def inputs(case):
    """The case's arguments as numpy arrays (floats in float32)."""
    kernel, dh, g, _ = case
    r = np.random.default_rng(
        int.from_bytes(hashlib.sha256(repr(case).encode()).digest()[:4],
                       "little"))
    h = g * HKV

    def randn(*shape):
        return r.normal(size=shape).astype(np.float32)
    if kernel == "scan":
        s, bs = dh, g
        return (randn(bs, s, SCAN_H, SCAN_PN),
                np.log1p(np.exp(randn(bs, s, SCAN_H))),
                -np.exp(randn(SCAN_H) * 0.5),
                randn(bs, s, SCAN_PN) * 0.3, randn(bs, s, SCAN_PN) * 0.3)
    if kernel == "moe":
        c = dh
        x = randn(MOE_P, c, MOE_D)
        w = [randn(MOE_E, MOE_D, MOE_F) * 0.1 for _ in range(2)]
        return (x, w[0], w[1], randn(MOE_E, MOE_F, MOE_D) * 0.1,
                np.array([0, 2, 1, 2], np.int32),
                np.array([c, 1, c, 0], np.int32))
    if kernel == "flash":
        p = np.tile(np.arange(S, dtype=np.int32), (B, 1))
        p[-1, S - 7:] = -1
        return (randn(B, S, h, dh), randn(B, S, HKV, dh),
                randn(B, S, HKV, dh), p, p)
    q, k1, v1 = randn(B, h, dh), randn(B, HKV, dh), randn(B, HKV, dh)
    if kernel == "partial":
        pos = r.integers(1, PARTIAL_SC, size=(B,)).astype(np.int32)
        pos[-1] = -1                        # a row with no valid key
        ar = np.arange(PARTIAL_SC)[None]
        cpos = np.where(ar < pos[:, None], ar, -1).astype(np.int32)
        return q, randn(B, PARTIAL_SC, HKV, dh), \
            randn(B, PARTIAL_SC, HKV, dh), cpos, pos
    if kernel == "fused":
        pos = r.integers(1, SC, size=(B,)).astype(np.int32)
        cpos = np.where(np.arange(SC)[None] < pos[:, None],
                        np.arange(SC)[None], -1).astype(np.int32)
        return q, randn(B, SC, HKV, dh), randn(B, SC, HKV, dh), cpos, k1, \
            v1, pos
    npages = 1 + B * NBLK
    bt = np.zeros((B, NBLK), np.int32)
    ids = r.permutation(np.arange(1, npages)).astype(np.int32)
    pos = r.integers(PT, NBLK * PT, size=(B,)).astype(np.int32)
    for i in range(B):
        used = -(-int(pos[i]) // PT)
        bt[i, :used] = ids[i * NBLK:i * NBLK + used]
    bt[1, 0] = bt[0, 0]
    ppos = np.full((npages, PT), -1, np.int32)
    for i in range(B):
        for j in range(NBLK):
            if bt[i, j]:
                ppos[bt[i, j]] = np.arange(j * PT, (j + 1) * PT)
    return (q, randn(npages, PT, HKV, dh), randn(npages, PT, HKV, dh), ppos,
            bt, k1, v1, pos)


def _tensors(case):
    """The case's arguments on the card, floats in the case's dtype (the
    scan's dt, a, b and c stay float32)."""
    dtype = getattr(torch, case[3])
    args = [torch.from_numpy(a).cuda() for a in inputs(case)]
    n = 1 if case[0] == "scan" else len(args)
    return [a.to(dtype) if i < n and a.dtype == torch.float32 else a
            for i, a in enumerate(args)]


def run_port(case):
    """The case through the port's wrappers."""
    from repro_torch.kernels import decode_attention as da
    from repro_torch.kernels import flash_attention as fa
    from repro_torch.kernels import moe_gemm as mg
    from repro_torch.kernels import ssm_scan as ss
    args = _tensors(case)
    if case[0] == "scan":
        return ss.ssm_scan_cuda(*args, chunk=SCAN_CHUNK)
    if case[0] == "moe":
        return mg.expert_ffn_cuda(*args, decode=case[2])
    if case[0] == "fused":
        return da.decode_attention_cuda(*args, window=WINDOW,
                                        softcap=SOFTCAP)
    if case[0] == "paged":
        return da.decode_attention_paged_cuda(*args, softcap=SOFTCAP)
    if case[0] == "partial":
        return da.decode_attention_partial_cuda(
            *args, window=PARTIAL_WINDOW, softcap=SOFTCAP)
    return fa.flash_attention_cuda(*args, window=WINDOW, softcap=SOFTCAP)


def run_library(case, libs):
    """The case through the C entry points of ``libs`` (``decode``,
    ``flash``, ``moe`` and ``scan`` CDLLs built from another copy of the
    sources)."""
    args = _tensors(case)
    if case[0] == "scan":
        return scan_call(libs["scan"], *args)()
    if case[0] == "moe":
        return moe_call(libs["moe"], *args, decode=case[2])()
    if case[0] == "flash":
        return flash_call(libs["flash"], *args, window=WINDOW,
                          softcap=SOFTCAP)()
    if case[0] == "partial":
        return partial_call(libs["decode"], *args, window=PARTIAL_WINDOW,
                            softcap=SOFTCAP)()
    return decode_call(libs["decode"], *args, window=WINDOW,
                       softcap=SOFTCAP)()


def decode_call(lib, q, kv, *rest, window=0, softcap=0.0):
    """A closure that runs ``lib``'s fused (args q, ck, cv, cpos, k1, v1,
    pos) or paged (q, pk, pv, ppos, bt, k1, v1, pos) decode entry on
    these arguments, with the split body's scratch where that copy of the
    source takes it (``decode_attention_workspace``)."""
    from repro_torch.kernels import decode_attention as da
    paged = len(rest) == 6
    b, h, dh = q.shape
    hkv = kv.shape[2]
    sc = rest[2].shape[1] * kv.shape[1] if paged else kv.shape[1]
    code = build.DTYPE_CODES[str(q.dtype)]
    out = torch.empty_like(q)
    scratch = []
    if hasattr(lib, "decode_attention_workspace"):
        ws_fn = lib.decode_attention_workspace
        ws_fn.argtypes, ws_fn.restype = [ctypes.c_int] * 6, ctypes.c_longlong
        n = int(ws_fn(b, h, hkv, dh, sc, code))
        scratch = [torch.empty(max(n, 1), dtype=torch.float32,
                               device=q.device)]
    fn = lib.decode_attention_paged if paged else lib.decode_attention_fused
    fn.argtypes = [ctypes.c_void_p] * (3 + len(rest) + len(scratch)) + \
        da.KERNEL.argtypes[-9:]
    fn.restype = ctypes.c_int
    tail = [b, h, hkv, dh] + ([kv.shape[1], rest[2].shape[1], softcap]
                              if paged else [sc, window, softcap])
    call = [build.ptr(t) for t in (q, kv, *rest, out, *scratch)] + tail + [
        code, build.stream_ptr(q)]

    def run():
        err = fn(*call)
        if err:
            raise RuntimeError(f"decode attention: CUDA error {err}")
        return out
    run.scratch = scratch      # the kernel writes it: keep it allocated
    return run


def partial_call(lib, q, ck, cv, cpos, pos, *, window=0, softcap=0.0):
    """A closure that runs ``lib``'s partial decode entry on these
    arguments, returning (m, l, acc), with the split body's scratch where
    that copy of the source takes it (one that exports
    ``decode_attention_partial_workspace``)."""
    from repro_torch.kernels import decode_attention as da
    b, h, dh = q.shape
    sc, hkv = ck.shape[1], ck.shape[2]
    code = build.DTYPE_CODES[str(q.dtype)]
    m = torch.empty((b, hkv, h // hkv), dtype=torch.float32, device=q.device)
    l = torch.empty_like(m)
    acc = torch.empty((b, hkv, h // hkv, dh), dtype=torch.float32,
                      device=q.device)
    scratch = []
    if hasattr(lib, "decode_attention_partial_workspace"):
        ws_fn = lib.decode_attention_partial_workspace
        ws_fn.argtypes, ws_fn.restype = [ctypes.c_int] * 6, ctypes.c_longlong
        n = int(ws_fn(b, h, hkv, dh, sc, code))
        scratch = [torch.empty(max(n, 1), dtype=torch.float32,
                               device=q.device)]
    fn = lib.decode_attention_partial
    fn.argtypes = [ctypes.c_void_p] * (8 + len(scratch)) + \
        da.PARTIAL_KERNEL.argtypes[-9:]
    fn.restype = ctypes.c_int
    call = [build.ptr(t) for t in (q, ck, cv, cpos, pos, m, l, acc,
                                   *scratch)] + [
        b, h, hkv, dh, sc, window, softcap, code, build.stream_ptr(q)]

    def run():
        call[-1] = build.stream_ptr(q)      # the current stream: graphs
        err = fn(*call)
        if err:
            raise RuntimeError(f"decode attention partial: CUDA error {err}")
        return m, l, acc
    run.scratch = scratch      # the kernel writes it: keep it allocated
    return run


def built_in(lib, case) -> bool:
    """Whether ``lib``'s decode source is built for a partial case's (Dh,
    G) (every other case's kernel takes all of its pairs)."""
    if case[0] != "partial":
        return True
    fn = lib.decode_attention_supports
    fn.argtypes, fn.restype = [ctypes.c_int] * 3, ctypes.c_int
    return bool(fn(case[1], case[2], 1))


def digest(t) -> str:
    """The first 16 hex digits of the sha256 of the tensor's bytes (of
    each tensor's in turn, for a tuple)."""
    h = hashlib.sha256()
    for a in (t if isinstance(t, tuple) else (t,)):
        a = a.contiguous().cpu()
        if a.dtype == torch.bfloat16:
            a = a.view(torch.int16)
        h.update(a.numpy().tobytes())
    return h.hexdigest()[:16]


def scan_call(lib, x, dt, a, b, c, *, chunk=SCAN_CHUNK):
    """A closure that runs ``lib``'s ``ssm_scan`` on these arguments."""
    from repro_torch.kernels import ssm_scan as ss
    from repro_torch.kernels.ref import scan_chunk
    bs, s, h, p = x.shape
    n = b.shape[-1]
    y = torch.empty_like(x)
    hf = torch.empty((bs, h, p, n), dtype=torch.float32, device=x.device)
    fn = lib.ssm_scan
    fn.argtypes, fn.restype = ss.KERNEL.argtypes, ctypes.c_int
    call = [build.ptr(t) for t in (x, dt, a, b, c, y, hf)] + [
        bs, s, h, p, n, scan_chunk(s, chunk),
        build.DTYPE_CODES[str(x.dtype)], build.stream_ptr(x)]

    def run():
        call[-1] = build.stream_ptr(x)      # the current stream: graphs
        err = fn(*call)
        if err:
            raise RuntimeError(f"ssm_scan: CUDA error {err}")
        return y, hf
    return run


def moe_call(lib, x, wg, wu, wd, se, cnt, *, decode):
    """A closure that runs ``lib``'s ``moe_ffn`` (any copy of the
    source) on these arguments, with the workspace that copy asks for."""
    from repro_torch.kernels import moe_gemm as mg
    p, c, d = x.shape
    f = wu.shape[2]
    code = build.DTYPE_CODES[str(x.dtype)]
    ws_fn = lib.moe_ffn_workspace
    ws_fn.argtypes, ws_fn.restype = [ctypes.c_int] * 6, ctypes.c_longlong
    ws = torch.empty((int(ws_fn(p, c, d, f, code, int(decode))),),
                     dtype=torch.float32, device=x.device)
    y = torch.empty_like(x)
    fn = lib.moe_ffn
    fn.argtypes, fn.restype = mg.KERNEL.argtypes, ctypes.c_int
    call = [build.ptr(t) for t in (x, wg, wu, wd, se, cnt, ws, y)] + [
        p, c, d, f, 1, 0, code, int(decode), build.stream_ptr(x)]

    def run():
        call[-1] = build.stream_ptr(x)      # the current stream: graphs
        err = fn(*call)
        if err:
            raise RuntimeError(f"moe_ffn: CUDA error {err}")
        return y
    run.workspace = ws         # the kernel writes it: keep it allocated
    return run


def build_other(csrc: Path, out_dir: Path):
    """Build DIR's decode, flash, expert-FFN and scan sources (the port's
    nvcc flags, one nvcc each, all started together, as ``build.build_all``
    does); prints each source's nvcc seconds."""
    out_dir.mkdir(parents=True, exist_ok=True)
    libs, procs, secs = {}, [], {}
    t0 = time.perf_counter()
    for key, name in (("decode", "decode_attention"),
                      ("flash", "flash_attention"), ("moe", "moe_gemm"),
                      ("scan", "ssm_scan")):
        so, log = out_dir / f"lib{name}.so", out_dir / f"{name}.log"
        with open(log, "w") as fh:
            procs.append((key, so, log, subprocess.Popen(
                [build._nvcc(), *build.NVCC_FLAGS, "-o", str(so),
                 str(csrc / f"{name}.cu")], stdout=fh,
                stderr=subprocess.STDOUT)))
    while len(secs) < len(procs):       # each source's own end time
        for key, _, _, proc in procs:
            if key not in secs and proc.poll() is not None:
                secs[key] = time.perf_counter() - t0
        time.sleep(0.05)
    for key, so, log, proc in procs:
        if proc.returncode:
            raise RuntimeError(f"nvcc failed on {key}:\n{log.read_text()}")
        libs[key] = ctypes.CDLL(str(so))
    print(f"{csrc}: nvcc seconds, each source, all started together: "
          + ", ".join(f"{k} {v:.1f}" for k, v in secs.items()))
    return libs


#: (name, kind, shape) of every shape ``--time`` runs both trees at: the
#: decode rows (fused and paged; rows' next positions drawn in [lo, Sc -
#: 1), or in [ring] over a wrapped ring), the flash rows, the expert-FFN
#: rows of the serving paths (Mixtral-8x7B's expert bank, 8 of 16 slots
#: active) and the SSD scan at Zamba2-7B's prefill of one prompt
TIMED = ([
    ("decode mixtral B8 Sc512", "decode",
     dict(b=8, h=32, hkv=8, dh=128, sc=512, lo=128)),
    ("decode zamba2 B8 Sc256 Dh112", "decode",
     dict(b=8, h=32, hkv=32, dh=112, sc=256, lo=128)),
    ("decode gemma2 local B8 Sc4096 ring", "decode",
     dict(b=8, h=8, hkv=4, dh=256, sc=4096, window=4096, softcap=50.0,
          ring=(4100, 4200))),
    ("decode gemma2 global B8 Sc4608", "decode",
     dict(b=8, h=8, hkv=4, dh=256, sc=4608, softcap=50.0, lo=128)),
    ("decode danube B4 Sc4096 ring", "decode",
     dict(b=4, h=32, hkv=8, dh=80, sc=4096, window=4096, ring=(4100, 4200))),
    ("decode qwen2 B8 Sc1024", "decode",
     dict(b=8, h=12, hkv=2, dh=128, sc=1024, lo=128)),
    ("paged mixtral B8 nblk32", "paged",
     dict(b=8, h=32, hkv=8, dh=128, nblk=32, lo=128)),
    ("paged qwen2 B8 nblk64", "paged",
     dict(b=8, h=12, hkv=2, dh=128, nblk=64, lo=128)),
    ("partial gemma2 local B8 Sc4096 ring", "partial",
     dict(b=8, h=8, hkv=4, dh=256, sc=4096, window=4096, softcap=50.0,
          ring=(4100, 4200))),
    ("partial gemma2 global B8 Sc4608", "partial",
     dict(b=8, h=8, hkv=4, dh=256, sc=4608, softcap=50.0, lo=128)),
] + [
    ("flash gemma2 local S4160", "flash",
     dict(s=4160, h=8, hkv=4, dh=256, window=4096, softcap=50.0)),
    ("flash gemma2 global S4160", "flash",
     dict(s=4160, h=8, hkv=4, dh=256, softcap=50.0)),
    ("flash danube S4160", "flash", dict(s=4160, h=32, hkv=8, dh=80,
                                         window=4096)),
    ("flash qwen2 S624 (621 tokens)", "flash", dict(s=624, valid=621, h=12,
                                                    hkv=2, dh=128)),
    ("flash mixtral S128", "flash", dict(s=128, h=32, hkv=8, dh=128)),
    ("flash zamba2 S128", "flash", dict(s=128, h=32, hkv=32, dh=112)),
    ("flash mixtral chunk B8 C128 Sk512", "chunk",
     dict(b=8, c=128, sk=512, h=32, hkv=8, dh=128, starts=(0, 200))),
    ("flash qwen2 chunk B8 C256 Sk1024", "chunk",
     dict(b=8, c=256, sk=1024, h=12, hkv=2, dh=128, starts=(512,))),
] + [(f"moe C{c}" + (" decode" if dec else ""), "moe", dict(c=c, decode=dec))
     for c, dec in ((2, True), (8, True), (2, False), (4, False),
                    (8, False), (64, False), (128, False), (256, False))
] + [("scan zamba2 B1 S128 H112", "scan", dict(b=1, s=128, h=112))])


def time_ms(fn, reps: int = 20) -> float:
    """Median CUDA-event time of one call of ``fn`` after 3 warm-up
    calls, with a 64 MiB L2 flush before each (outside the timed span);
    ``chip_smoke.py`` times every kernel with it too."""
    flush = torch.empty(64 << 20, dtype=torch.uint8, device="cuda")
    for _ in range(3):
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


def flash_call(lib, q, k, v, qp, kp, *, window=0, softcap=0.0):
    """A closure that runs ``lib``'s ``flash_attention`` (causal)."""
    from repro_torch.kernels import flash_attention as fa
    b, sq, h, dh = q.shape
    out = torch.empty_like(q)
    fn = lib.flash_attention
    fn.argtypes, fn.restype = fa.KERNEL.argtypes, ctypes.c_int
    call = [build.ptr(t) for t in (q, k, v, qp, kp, out)] + [
        b, sq, k.shape[1], h, k.shape[2], dh, 1, window, softcap,
        build.DTYPE_CODES[str(q.dtype)], build.stream_ptr(q)]

    def run():
        err = fn(*call)
        if err:
            raise RuntimeError(f"flash_attention: CUDA error {err}")
        return out
    return run


def timed_inputs(kind, shape, g):
    """bf16 inputs of a TIMED shape (seeded on the card) as the keyword
    arguments of flash_call or moe_call after the library."""
    def randn(*sh, scale=1.0):
        return (torch.randn(sh, generator=g, device="cuda") *
                scale).bfloat16()
    if kind == "scan":
        bs, s, h = shape["b"], shape["s"], shape["h"]
        f32 = dict(generator=g, device="cuda")
        return dict(x=randn(bs, s, h, 64),
                    dt=torch.nn.functional.softplus(torch.randn(bs, s, h,
                                                                **f32)),
                    a=-torch.exp(torch.randn(h, **f32) * 0.5),
                    b=torch.randn(bs, s, 64, **f32) * 0.3,
                    c=torch.randn(bs, s, 64, **f32) * 0.3)
    if kind == "moe":
        c, d, f = shape["c"], 4096, 14336
        x = randn(16, c, d)
        x[8:] = 0
        return dict(x=x, wg=randn(8, d, f, scale=d ** -0.5),
                    wu=randn(8, d, f, scale=d ** -0.5),
                    wd=randn(8, f, d, scale=f ** -0.5),
                    se=torch.tensor(list(range(8)) + [0, 1, 2, 3] * 2,
                                    dtype=torch.int32, device="cuda"),
                    cnt=torch.tensor([c] * 8 + [0] * 8, dtype=torch.int32,
                                     device="cuda"),
                    decode=shape["decode"])
    h, hkv, dh = shape["h"], shape["hkv"], shape["dh"]
    kw = dict(window=shape.get("window", 0),
              softcap=shape.get("softcap", 0.0))
    if kind in ("decode", "paged"):
        return dict(args=decode_inputs(kind, shape, randn, g), **kw)
    if kind == "partial":                   # the fused inputs but k1, v1
        q, ck, cv, cpos, _, _, pos = decode_inputs("decode", shape, randn, g)
        return dict(args=(q, ck, cv, cpos, pos), **kw)
    if kind == "flash":
        s = shape["s"]
        p = torch.arange(s, device="cuda", dtype=torch.int32)[None]
        p = torch.where(p < shape.get("valid", s), p, torch.full_like(p, -1))
        return dict(q=randn(1, s, h, dh), k=randn(1, s, hkv, dh),
                    v=randn(1, s, hkv, dh), qp=p, kp=p, **kw)
    # a chunk call: row i (i < len(starts)) extends a sequence by the chunk
    # [start, start + C) over its cache view; the other rows are idle
    b, c, sk = shape["b"], shape["c"], shape["sk"]
    ar = torch.arange(sk, device="cuda", dtype=torch.int32)
    qp = torch.full((b, c), -1, device="cuda", dtype=torch.int32)
    kp = torch.where(ar < 100, ar, torch.full_like(ar, -1)).repeat(b, 1)
    for i, start in enumerate(shape["starts"]):
        qp[i] = torch.arange(start, start + c, device="cuda",
                             dtype=torch.int32)
        kp[i] = torch.where(ar < start + c, ar, torch.full_like(ar, -1))
    return dict(q=randn(b, c, h, dh), k=randn(b, sk, hkv, dh),
                v=randn(b, sk, hkv, dh), qp=qp, kp=kp, **kw)


def decode_inputs(kind, shape, randn, g):
    """The fused (q, ck, cv, cpos, k1, v1, pos) or paged (q, pk, pv, ppos,
    bt, k1, v1, pos) arguments of a TIMED decode shape. Paged: 16-token
    pages, each row's blocks up to its position mapped to distinct pages
    in a random order, the rest to the null page 0."""
    b, h, hkv, dh = shape["b"], shape["h"], shape["hkv"], shape["dh"]
    q, k1, v1 = randn(b, h, dh), randn(b, hkv, dh), randn(b, hkv, dh)
    i32 = dict(dtype=torch.int32, device="cuda")
    if kind == "paged":
        pt, nblk = 16, shape["nblk"]
        npages = 1 + b * nblk
        pos = torch.randint(shape["lo"], nblk * pt - 1, (b,), generator=g,
                            **i32)
        ids = (torch.randperm(npages - 1, generator=g, device="cuda") + 1)
        blk = torch.arange(nblk, **i32)
        used = (pos + pt - 1) // pt
        bt = torch.where(blk[None] < used[:, None], ids.view(b, nblk).int(),
                         torch.zeros_like(blk)[None])
        ppos = torch.full((npages, pt), -1, **i32)
        pages, first = bt.reshape(-1), (blk * pt).repeat(b)
        live = pages > 0
        ppos[pages[live].long()] = first[live][:, None] + \
            torch.arange(pt, **i32)[None]
        return (q, randn(npages, pt, hkv, dh), randn(npages, pt, hkv, dh),
                ppos, bt.contiguous(), k1, v1, pos)
    sc = shape["sc"]
    ar = torch.arange(sc, **i32)[None]
    if "ring" in shape:
        # slot j holds the latest earlier position congruent to j mod Sc
        pos = torch.randint(*shape["ring"], (b,), generator=g, **i32)
        last = (pos - 1)[:, None]
        cpos = (last - torch.remainder(last - ar, sc)).to(torch.int32)
    else:
        pos = torch.randint(shape["lo"], sc - 1, (b,), generator=g, **i32)
        cpos = torch.where(ar < pos[:, None], ar, torch.full_like(ar, -1))
    return (q, randn(b, sc, hkv, dh), randn(b, sc, hkv, dh), cpos, k1, v1,
            pos)


def plain(kind, kw):
    """The plain version's output (float32) on a TIMED shape's inputs;
    the expert FFN's on all slots, its active ones computed on their own
    (the 16-slot gather of the bank would take 22 GiB)."""
    from repro_torch.kernels import decode_attention as da
    from repro_torch.kernels import moe_gemm as mg
    from repro_torch.kernels import ref as kref
    from repro_torch.models.attention import blockwise_attention
    if kind == "scan":
        kw = dict(kw, x=kw["x"].float())
        return kref.ssm_scan_chunked_ref(**kw, chunk=SCAN_CHUNK)[0]
    if kind == "decode":
        return da.decode_attention_plain(*kw["args"], window=kw["window"],
                                         softcap=kw["softcap"]).float()
    if kind == "paged":
        return da.decode_attention_paged_plain(
            *kw["args"], softcap=kw["softcap"]).float()
    if kind == "partial":
        return da.decode_attention_partial_plain(
            *kw["args"], window=kw["window"], softcap=kw["softcap"])
    if kind == "moe":
        live = kw["cnt"] > 0
        y = torch.zeros_like(kw["x"], dtype=torch.float32)
        y[live] = mg.expert_ffn_plain(
            kw["x"][live], kw["wg"], kw["wu"], kw["wd"], kw["se"][live],
            kw["cnt"][live]).float()
        return y
    return blockwise_attention(kw["q"], kw["k"], kw["v"], kw["qp"], kw["kp"],
                               window=kw["window"], softcap=kw["softcap"],
                               block_q=kw["q"].shape[1],
                               block_k=16).float()


def graph_ms(fns, calls: int = 20, reps: int = 5) -> float:
    """The device time of one call, without host time: ``calls`` calls,
    taking the closures ``fns`` in turn, captured in one CUDA graph and
    replayed back to back (median of ``reps`` CUDA-event timings, divided
    by ``calls``); closures over copies of the inputs keep each call's
    reads out of L2."""
    seq = [fns[i % len(fns)] for i in range(calls)]
    for fn in seq:
        fn()
    torch.cuda.synchronize()
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        for fn in seq:
            fn()
    graph.replay()
    torch.cuda.synchronize()
    times = []
    for _ in range(reps):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        graph.replay()
        end.record()
        end.synchronize()
        times.append(start.elapsed_time(end) / calls)
    return statistics.median(times)


def out(result):
    """A call's output: y of the scan's (y, h_final); acc / l of the
    partial kernel's (m, l, acc) (0 in a row with no valid key)."""
    if isinstance(result, tuple) and len(result) == 3:
        m, l, acc = result
        return torch.where(l[..., None] > 0, acc / l[..., None], 0.0)
    return result[0] if isinstance(result, tuple) else result


def time_trees(libs_other, libs_mine):
    """Both trees at every TIMED shape, in turns (other, mine, mine,
    other); prints each time and each tree's largest error against the
    plain version."""
    g = torch.Generator(device="cuda").manual_seed(0)
    for name, kind, shape in TIMED:
        kw = timed_inputs(kind, shape, g)
        if kind == "moe":
            mk = lambda libs: moe_call(libs["moe"], **kw)  # noqa: E731
        elif kind == "scan":
            mk = lambda libs: scan_call(libs["scan"], **kw)  # noqa: E731
        elif kind in ("decode", "paged"):
            mk = lambda libs: decode_call(  # noqa: E731
                libs["decode"], *kw["args"], window=kw["window"],
                softcap=kw["softcap"])
        elif kind == "partial":
            mk = lambda libs: partial_call(  # noqa: E731
                libs["decode"], *kw["args"], window=kw["window"],
                softcap=kw["softcap"])
        else:
            mk = lambda libs: flash_call(libs["flash"], **kw)  # noqa: E731
        other, mine = mk(libs_other), mk(libs_mine)
        want = out(plain(kind, kw)).float()
        errs = [(out(fn()).float() - want).abs().max().item()
                for fn in (other, mine)]
        del want
        t = [time_ms(fn) for fn in (other, mine, mine, other)]
        print(f"  {name}: other {t[0]:.4f} / {t[3]:.4f} ms, this checkout "
              f"{t[1]:.4f} / {t[2]:.4f} ms (x{(t[0] + t[3]) / (t[1] + t[2]):.2f}"
              f"); max abs err against the bf16 plain version: other "
              f"{errs[0]:.3e}, this checkout {errs[1]:.3e}")
        if kind in ("moe", "scan", "partial"):
            # the scan's inputs fit in L2: 20 copies, one a call; the
            # partial kernel's 4 (each over 64 MB)
            n = {"moe": 0, "scan": 19, "partial": 3}[kind]
            copies = [kw] + [
                {k: v.clone() if torch.is_tensor(v) else
                 tuple(t.clone() for t in v) if k == "args" else v
                 for k, v in kw.items()} for _ in range(n)]
            trees = {"other": libs_other, "mine": libs_mine}

            def call_of(lib, c):
                if kind == "partial":
                    return partial_call(lib["decode"], *c["args"],
                                        window=c["window"],
                                        softcap=c["softcap"])
                if kind == "scan":
                    return scan_call(lib["scan"], **c)
                return moe_call(lib["moe"], **c)
            fns = {k: [call_of(lib, c) for c in copies]
                   for k, lib in trees.items()}
            gt = [graph_ms(fns[k]) for k in ("other", "mine", "mine",
                                               "other")]
            print(f"    in a CUDA graph (no host time): other {gt[0]:.4f} / "
                  f"{gt[3]:.4f} ms, this checkout {gt[1]:.4f} / "
                  f"{gt[2]:.4f} ms")
            del copies, fns
        del kw, other, mine
        torch.cuda.empty_cache()


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--csrc", type=Path, default=None,
                    help="another copy of the CUDA sources to compare with")
    ap.add_argument("--time", action="store_true",
                    help="with --csrc: time both trees at the serving "
                    "shapes, in turns")
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        print("bits: no CUDA device visible", file=sys.stderr)
        return 2
    build.build_all()
    if build.build_source_seconds:
        print("this checkout: nvcc seconds, each source, all started "
              "together: " + ", ".join(
                  f"{k} {v:.1f}" for k, v in
                  build.build_source_seconds.items()))
    cases = CASES + MOE_CASES + SCAN_CASES
    mine = {case: digest(run_port(case)) for case in cases}
    for case, d in mine.items():
        print(f"{case}: {d}")
    if args.csrc is None:
        return 0
    libs = build_other(args.csrc, build.BUILD_DIR / "bits_other")
    absent = [case for case in cases if not built_in(libs["decode"], case)]
    if absent:
        print(f"not built in {args.csrc}'s kernels, left out: {absent}")
    cases = [case for case in cases if case not in absent]
    kept = [case for case in KEPT if case in cases]
    other = {case: digest(run_library(case, libs)) for case in cases}
    differ = [case for case in cases if other[case] != mine[case]]
    lost = [case for case in kept if case in differ]
    print(f"{len(cases) - len(differ)} of {len(cases)} cases bitwise equal "
          f"to {args.csrc}'s kernels" + (f"; differ: {differ}" if differ
                                         else ""))
    print(f"{len(kept) - len(lost)} of the {len(kept)} cases to keep "
          f"(float32 decode, flash and partial, the scan) equal"
          + (f"; LOST: {lost}" if lost else ""))
    if args.time:
        print(f"times at the serving shapes, {torch.cuda.get_device_name(0)}"
              f" (median of 20 CUDA-event runs, L2 flushed), "
              f"{args.csrc}'s tree against this checkout's, in turns:")
        time_trees(libs, {"decode": build.library("decode_attention"),
                          "flash": build.library("flash_attention"),
                          "moe": build.library("moe_gemm"),
                          "scan": build.library("ssm_scan")})
    return 1 if lost else 0


if __name__ == "__main__":
    sys.exit(main())
