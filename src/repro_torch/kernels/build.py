"""Build and bind the port's hand-written CUDA kernels.

Each source under ``repro_torch/csrc/`` is compiled by ``nvcc`` for
``sm_90a`` into a shared library with a plain C interface and loaded with
``ctypes``. Nothing is built at import: the first launch of any kernel
builds every source at once (one ``nvcc`` per source, all started
together) into ``build/kernels/`` at the root of the checkout, which git
ignores. Libraries are keyed by a hash of their source and flags, so an
unchanged source is not rebuilt on the same machine.

Every C entry point launches on the caller's stream and returns
``cudaGetLastError()``; ``CudaKernel`` raises when that is not 0 and
otherwise adds one to its launch count.
"""
from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import threading
import time
from pathlib import Path
from typing import Dict, List

CSRC = Path(__file__).resolve().parents[1] / "csrc"
BUILD_DIR = Path(__file__).resolve().parents[3] / "build" / "kernels"
SOURCES = ("decode_attention", "flash_attention", "moe_gemm")
NVCC_FLAGS = ["-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
              "-O3", "-shared", "-Xcompiler", "-fPIC", "-Xptxas=-v"]

DTYPE_CODES = {"torch.float32": 0, "torch.bfloat16": 1}

_lock = threading.Lock()
_libs: Dict[str, ctypes.CDLL] = {}
#: what nvcc printed for each source (registers, shared memory, spills)
build_log: Dict[str, str] = {}
#: wall seconds of the last build_all() that compiled anything
build_seconds: float = 0.0


def _nvcc() -> str:
    home = os.environ.get("CUDA_HOME", "/usr/local/cuda")
    cand = Path(home) / "bin" / "nvcc"
    if cand.exists():
        return str(cand)
    found = shutil.which("nvcc")
    if found is None:
        raise RuntimeError("nvcc not found: the port's CUDA kernels are "
                           "built on a machine with the CUDA toolkit")
    return found


def _target(name: str) -> Path:
    src = (CSRC / f"{name}.cu").read_bytes()
    digest = hashlib.sha256(src + " ".join(NVCC_FLAGS).encode()).hexdigest()
    return BUILD_DIR / f"lib{name}-{digest[:16]}.so"


def build_all() -> Dict[str, ctypes.CDLL]:
    """Compile every source that has no library yet (all in parallel),
    then load them all. Raises with nvcc's output when a build fails."""
    global build_seconds
    with _lock:
        missing = [n for n in SOURCES if n not in _libs]
        if not missing:
            return _libs
        BUILD_DIR.mkdir(parents=True, exist_ok=True)
        t0 = time.perf_counter()
        procs = []
        for name in missing:
            out = _target(name)
            if out.exists():
                continue
            tmp = out.with_suffix(f".{os.getpid()}.tmp")
            cmd = [_nvcc(), *NVCC_FLAGS, "-o", str(tmp),
                   str(CSRC / f"{name}.cu")]
            procs.append((name, out, tmp, subprocess.Popen(
                cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
                text=True)))
        failed: List[str] = []
        for name, out, tmp, proc in procs:
            text, _ = proc.communicate()
            build_log[name] = text
            if proc.returncode != 0:
                failed.append(f"--- {name}.cu (exit {proc.returncode})\n"
                              f"{text}")
            else:
                os.replace(tmp, out)
        if procs:
            build_seconds = time.perf_counter() - t0
        if failed:
            raise RuntimeError("nvcc failed:\n" + "\n".join(failed))
        for name in missing:
            _libs[name] = ctypes.CDLL(str(_target(name)))
        return _libs


def library(name: str) -> ctypes.CDLL:
    return build_all()[name]


class CudaKernel:
    """One C entry point of a built source, with its launch count.

    ``argtypes`` are ctypes types in call order; pointers and the stream
    are ``ctypes.c_void_p``. Calling the object runs the entry point and
    raises if it reports a CUDA error."""

    def __init__(self, source: str, symbol: str, argtypes: list,
                 replaces: str):
        self.source = source
        self.symbol = symbol
        self.argtypes = argtypes
        self.replaces = replaces        # file:line of the TPU kernel
        self.launches = 0
        self._fn = None

    def _bind(self):
        lib = library(self.source)
        fn = getattr(lib, self.symbol)
        fn.argtypes = self.argtypes
        fn.restype = ctypes.c_int
        err = getattr(lib, "kernel_error_string")
        err.argtypes = [ctypes.c_int]
        err.restype = ctypes.c_char_p
        self._fn, self._err = fn, err

    def __call__(self, *args):
        if self._fn is None:
            self._bind()
        code = self._fn(*args)
        if code != 0:
            raise RuntimeError(f"{self.symbol}: CUDA error {code} "
                               f"({self._err(code).decode()})")
        self.launches += 1


def stream_ptr(t) -> ctypes.c_void_p:
    """The current CUDA stream of tensor ``t``'s device, as a pointer."""
    import torch
    return ctypes.c_void_p(torch.cuda.current_stream(t.device).cuda_stream)


def ptr(t) -> ctypes.c_void_p:
    return ctypes.c_void_p(t.data_ptr())


def dtype_code(t) -> int:
    code = DTYPE_CODES.get(str(t.dtype))
    if code is None:
        raise TypeError(f"CUDA kernels take float32 or bfloat16, "
                        f"got {t.dtype}")
    return code
