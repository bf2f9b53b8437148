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
otherwise adds one to its launch count (through ``count``: a launch
captured in a CUDA graph is counted on each replay of the graph, where
the kernel runs, and not at the capture, where it does not).
"""
from __future__ import annotations

import contextlib
import ctypes
import functools
import hashlib
import os
import shutil
import subprocess
import threading
import time
from pathlib import Path
from typing import Callable, Dict, List, Optional

CSRC = Path(__file__).resolve().parents[1] / "csrc"
BUILD_DIR = Path(__file__).resolve().parents[3] / "build" / "kernels"
SOURCES = ("decode_attention", "flash_attention", "moe_gemm", "ssm_scan")
NVCC_FLAGS = ["-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
              "-O3", "-shared", "-Xcompiler", "-fPIC", "-Xptxas=-v"]

DTYPE_CODES = {"torch.float32": 0, "torch.bfloat16": 1}

_lock = threading.Lock()
_libs: Dict[str, ctypes.CDLL] = {}
#: what nvcc printed for each source (registers, shared memory, spills)
build_log: Dict[str, str] = {}
#: wall seconds of the last build_all() that compiled anything
build_seconds: float = 0.0
#: seconds from that build's start to the end of each source's nvcc
build_source_seconds: Dict[str, float] = {}
#: while a CUDA graph is captured under ``deferred_counts``: the counts its
#: launches add, each a call that a replay of the graph makes
_deferred: Optional[List[Callable[[], None]]] = None


def count(add: Callable[[], None]):
    """Add a launch to a count: ``add()`` now, or, inside
    ``deferred_counts``, on every replay of the graph being captured."""
    if _deferred is not None:
        _deferred.append(add)
    else:
        add()


@contextlib.contextmanager
def deferred_counts():
    """Collect the counts of the launches made in the block (a CUDA graph
    capture, which launches nothing); yields the list of calls that each
    replay of the graph makes."""
    global _deferred
    outer, _deferred = _deferred, []
    try:
        yield _deferred
    finally:
        _deferred = outer


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
            log = tmp.with_suffix(".log")
            cmd = [_nvcc(), *NVCC_FLAGS, "-o", str(tmp),
                   str(CSRC / f"{name}.cu")]
            with open(log, "w") as fh:
                procs.append((name, out, tmp, log, subprocess.Popen(
                    cmd, stdout=fh, stderr=subprocess.STDOUT)))
        failed: List[str] = []
        running = list(procs)
        while running:
            for item in list(running):
                name, out, tmp, log, proc = item
                if proc.poll() is None:
                    continue
                running.remove(item)
                build_source_seconds[name] = time.perf_counter() - t0
                text = log.read_text()
                log.unlink()
                build_log[name] = text
                if proc.returncode != 0:
                    failed.append(f"--- {name}.cu (exit {proc.returncode})"
                                  f"\n{text}")
                else:
                    os.replace(tmp, out)
            time.sleep(0.05)
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
        count(self._counted)

    def _counted(self):
        self.launches += 1


@functools.lru_cache(maxsize=None)
def _query(source: str, symbol: str, restype, *args: int) -> int:
    fn = getattr(library(source), symbol)
    fn.argtypes = [ctypes.c_int] * len(args)
    fn.restype = restype
    return int(fn(*args))


def supports(source: str, symbol: str, *args: int) -> bool:
    """What a built source's query entry ``int symbol(int, ...)`` says
    about the shapes it was built for (it launches nothing; the answer is
    fixed for the process, so it is asked once per arguments)."""
    return bool(_query(source, symbol, ctypes.c_int, *args))


def size(source: str, symbol: str, *args: int) -> int:
    """What a built source's query entry ``long long symbol(int, ...)``
    answers: a scratch size (launches nothing; asked once per
    arguments)."""
    return _query(source, symbol, ctypes.c_longlong, *args)


def stream_ptr(t) -> ctypes.c_void_p:
    """The current CUDA stream of tensor ``t``'s device, as a pointer
    (read without building a Stream object: a launch's host time counts
    at the small shapes)."""
    import torch
    return ctypes.c_void_p(torch._C._cuda_getCurrentRawStream(t.get_device()))


def ptr(t) -> ctypes.c_void_p:
    return ctypes.c_void_p(t.data_ptr())


def dtype_code(t) -> int:
    code = DTYPE_CODES.get(str(t.dtype))
    if code is None:
        raise TypeError(f"CUDA kernels take float32 or bfloat16, "
                        f"got {t.dtype}")
    return code
