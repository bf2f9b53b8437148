"""Count what a torch function actually runs: flops and bytes of every
aten op, and of every hand-written kernel launch (the port's counterpart
of ``repro.roofline.hlo_parse``).

``OpCounter`` is a ``TorchDispatchMode``. Each aten op adds its flops,
from ``torch.utils.flop_counter``'s formulas (matmuls, convolutions,
attention; 0 for the rest), and its bytes: the tensors it reads and the
tensors it writes, once each. A view moves nothing and a factory op
(``empty``) writes nothing; a gather (indexing, ``embedding``) reads the
rows it returns, not its whole source; a scatter (``index_put_``,
``index_copy_``) writes the rows it is given. The loop multiplicity
``hlo_parse`` works out from trip counts comes free: Python runs the
loop, and each pass dispatches its ops again.

A kernel launch is invisible to a dispatch mode. So each entry point of
``kernels/ops.py`` hands ``kernel(name, work)`` its launch's flops and
bytes (the formulas of the kernel modules, which ``chip_smoke.py``'s
bounds use too); with no counter active it does nothing, so no launch
pays for it, and a CUDA graph replay (which runs no Python) is never
counted: count eager calls.
"""
from __future__ import annotations

from typing import Callable, List, Tuple

import torch
from torch.utils._python_dispatch import TorchDispatchMode
from torch.utils._pytree import tree_flatten
from torch.utils.flop_counter import flop_registry

aten = torch.ops.aten
_FACTORY = {aten.empty, aten.empty_like, aten.empty_strided}
_GATHER = {aten.index, aten.index_select, aten.embedding, aten.gather}
_SCATTER = {aten.index_put, aten.index_put_, aten.index_copy,
            aten.index_copy_, aten.scatter, aten.scatter_}

#: the counters in effect, innermost last
_ACTIVE: List["OpCounter"] = []


def _tensors(tree) -> list:
    return [t for t in tree_flatten(tree)[0] if isinstance(t, torch.Tensor)]


def _nbytes(ts) -> int:
    return sum(t.numel() * t.element_size() for t in ts)


class OpCounter(TorchDispatchMode):
    """``with OpCounter() as c: fn()`` -> ``c.flops``, ``c.bytes`` and
    per kernel ``c.kernels``: name -> [launches, flops, bytes]."""

    def __init__(self):
        super().__init__()
        self.flops = 0.0
        self.bytes = 0.0
        self.kernels = {}
        self._paused = 0

    def __enter__(self):
        _ACTIVE.append(self)
        return super().__enter__()

    def __exit__(self, *exc):
        _ACTIVE.remove(self)
        return super().__exit__(*exc)

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        kwargs = kwargs or {}
        out = func(*args, **kwargs)
        if self._paused or func.is_view:
            return out
        packet = func.overloadpacket
        if packet in _FACTORY:
            return out
        ins, outs = _tensors((args, kwargs)), _tensors(out)
        if packet in _GATHER:
            idx = [t for t in ins[1:] if not t.is_floating_point()]
            nbytes = 2 * _nbytes(outs) + _nbytes(idx)
        elif packet in _SCATTER:
            nbytes = 2 * _nbytes(ins[1:])
        elif packet in (aten.copy_, aten.fill_, aten.zero_):
            nbytes = _nbytes(ins[1:]) + _nbytes(ins[:1])
        else:
            nbytes = _nbytes(ins) + _nbytes(outs)
        flops = 0
        if packet in flop_registry:
            flops = flop_registry[packet](*args, **kwargs, out_val=out)
        self.flops += flops
        self.bytes += nbytes
        return out

    def add_kernel(self, name: str, flops: float, nbytes: float):
        k = self.kernels.setdefault(name, [0, 0.0, 0.0])
        k[0] += 1
        k[1] += flops
        k[2] += nbytes
        self.flops += flops
        self.bytes += nbytes


def kernel(name: str, work: Callable[[], Tuple[float, float]]):
    """Report one kernel launch to the active counters: ``work()`` gives
    its (flops, bytes), computed with the counters paused (it may read
    positions off the device). Does nothing when no counter is active."""
    if not _ACTIVE:
        return
    for c in _ACTIVE:
        c._paused += 1
    try:
        flops, nbytes = work()
    finally:
        for c in _ACTIVE:
            c._paused -= 1
    for c in _ACTIVE:
        c.add_kernel(name, flops, nbytes)
