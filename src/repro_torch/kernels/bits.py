"""Digests of the attention kernels' outputs on seeded inputs, to show that
a change to a kernel's source kept the bits of the shapes it had before.

The cases are the (Dh, G) pairs the decode kernels (fused and paged) were
built for before head dims 80 and 256 and group size 6 came in (Dh 32,
64, 112, 128 at G 1, 2, 4, 8) and the flash kernel's head dims of that
time, each in float32 and bfloat16, with a window, a softcap and masked
positions. Inputs come from numpy, seeded per case, so every machine
gives the kernels the same bits.

    PYTHONPATH=src python -m repro_torch.kernels.bits               # digests
    PYTHONPATH=src python -m repro_torch.kernels.bits --csrc DIR    # and DIR's

With ``--csrc DIR`` it also builds ``DIR/decode_attention.cu`` and
``DIR/flash_attention.cu`` (another copy of the sources, e.g. an earlier
commit's, with the same C entry points) and fails unless every digest
equals this checkout's. Needs an NVIDIA GPU and nvcc.
"""
from __future__ import annotations

import argparse
import ctypes
import hashlib
import subprocess
import sys
from pathlib import Path

import numpy as np
import torch

from repro_torch.kernels import build

DECODE_DH = (32, 64, 112, 128)
DECODE_G = (1, 2, 4, 8)
FLASH_DH = (32, 64, 112, 128)
DTYPES = ("float32", "bfloat16")
#: (kernel, Dh, G, dtype) of every case
CASES = ([(k, dh, g, dt) for k in ("fused", "paged") for dh in DECODE_DH
          for g in DECODE_G for dt in DTYPES]
         + [("flash", dh, g, dt) for dh in FLASH_DH for g in (1, 4)
            for dt in DTYPES])
B, HKV, SC, PT, NBLK, S = 3, 2, 70, 16, 5, 45
WINDOW, SOFTCAP = 24, 30.0


def inputs(case):
    """The case's arguments as numpy arrays (floats in float32)."""
    kernel, dh, g, _ = case
    r = np.random.default_rng(
        int.from_bytes(hashlib.sha256(repr(case).encode()).digest()[:4],
                       "little"))
    h = g * HKV

    def randn(*shape):
        return r.normal(size=shape).astype(np.float32)
    if kernel == "flash":
        p = np.tile(np.arange(S, dtype=np.int32), (B, 1))
        p[-1, S - 7:] = -1
        return (randn(B, S, h, dh), randn(B, S, HKV, dh),
                randn(B, S, HKV, dh), p, p)
    q, k1, v1 = randn(B, h, dh), randn(B, HKV, dh), randn(B, HKV, dh)
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
    dtype = getattr(torch, case[3])
    return [torch.from_numpy(a).cuda().to(dtype)
            if a.dtype == np.float32 else torch.from_numpy(a).cuda()
            for a in inputs(case)]


def run_port(case):
    """The case through the port's wrappers."""
    from repro_torch.kernels import decode_attention as da
    from repro_torch.kernels import flash_attention as fa
    args = _tensors(case)
    if case[0] == "fused":
        return da.decode_attention_cuda(*args, window=WINDOW,
                                        softcap=SOFTCAP)
    if case[0] == "paged":
        return da.decode_attention_paged_cuda(*args, softcap=SOFTCAP)
    return fa.flash_attention_cuda(*args, window=WINDOW, softcap=SOFTCAP)


def run_library(case, libs):
    """The case through the C entry points of ``libs`` (``decode`` and
    ``flash`` CDLLs built from another copy of the sources)."""
    from repro_torch.kernels import decode_attention as da
    from repro_torch.kernels import flash_attention as fa
    args = _tensors(case)
    code = build.DTYPE_CODES[f"torch.{case[3]}"]
    ptrs = [build.ptr(t) for t in args]
    stream = build.stream_ptr(args[0])
    kernel, dh, g, _ = case
    h = g * HKV
    if kernel == "flash":
        fn, argtypes = libs["flash"].flash_attention, fa.KERNEL.argtypes
        out = torch.empty_like(args[0])
        tail = (B, S, S, h, HKV, dh, 1, WINDOW, SOFTCAP, code, stream)
        call = ptrs + [build.ptr(out)] + list(tail)
    elif kernel == "fused":
        fn, argtypes = libs["decode"].decode_attention_fused, \
            da.KERNEL.argtypes
        out = torch.empty_like(args[0])
        call = ptrs + [build.ptr(out), B, h, HKV, dh, SC, WINDOW, SOFTCAP,
                       code, stream]
    else:
        fn, argtypes = libs["decode"].decode_attention_paged, \
            da.PAGED_KERNEL.argtypes
        out = torch.empty_like(args[0])
        call = ptrs + [build.ptr(out), B, h, HKV, dh, PT, NBLK, SOFTCAP,
                       code, stream]
    fn.argtypes, fn.restype = argtypes, ctypes.c_int
    err = fn(*call)
    if err:
        raise RuntimeError(f"{case}: CUDA error {err}")
    return out


def digest(t) -> str:
    """The first 16 hex digits of the sha256 of the tensor's bytes."""
    a = t.contiguous().cpu()
    if a.dtype == torch.bfloat16:
        a = a.view(torch.int16)
    return hashlib.sha256(a.numpy().tobytes()).hexdigest()[:16]


def build_other(csrc: Path, out_dir: Path):
    """Build DIR's decode and flash sources (the port's nvcc flags)."""
    out_dir.mkdir(parents=True, exist_ok=True)
    libs, procs = {}, []
    for key, name in (("decode", "decode_attention"),
                      ("flash", "flash_attention")):
        so = out_dir / f"lib{name}.so"
        procs.append((key, so, subprocess.Popen(
            [build._nvcc(), *build.NVCC_FLAGS, "-o", str(so),
             str(csrc / f"{name}.cu")], stdout=subprocess.PIPE,
            stderr=subprocess.STDOUT, text=True)))
    for key, so, proc in procs:
        text, _ = proc.communicate()
        if proc.returncode:
            raise RuntimeError(f"nvcc failed on {key}:\n{text}")
        libs[key] = ctypes.CDLL(str(so))
    return libs


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--csrc", type=Path, default=None,
                    help="another copy of the CUDA sources to compare with")
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        print("bits: no CUDA device visible", file=sys.stderr)
        return 2
    build.build_all()
    mine = {case: digest(run_port(case)) for case in CASES}
    for case, d in mine.items():
        print(f"{case}: {d}")
    if args.csrc is None:
        return 0
    libs = build_other(args.csrc, build.BUILD_DIR / "bits_other")
    other = {case: digest(run_library(case, libs)) for case in CASES}
    differ = [case for case in CASES if other[case] != mine[case]]
    print(f"{len(CASES) - len(differ)} of {len(CASES)} cases bitwise equal "
          f"to {args.csrc}'s kernels" + (f"; differ: {differ}" if differ
                                         else ""))
    return 1 if differ else 0


if __name__ == "__main__":
    sys.exit(main())
