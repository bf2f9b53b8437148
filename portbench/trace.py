"""What the profiler saw over the traced stretch of a ``--trace 1`` run:
device busy time, device time by kernel name, and the idle gaps labelled
with what the host was doing.

The stretch is a run of whole loop iterations under ``torch.profiler``
(CPU and CUDA activity). The harness marks each part of an iteration on
the host with ``record_function("bench/<part>")``; an idle gap on the
device is labelled with the innermost such mark and the deepest host
operator that hold its middle.
"""
from __future__ import annotations

import bisect
import re
from collections import defaultdict
from dataclasses import dataclass, field
from typing import Dict, List, Tuple

#: kernels of a layer, by name: the expert FFN (every path of
#: ``csrc/moe_gemm.cu``) and decode attention (``csrc/decode_attention.cu``)
KERNEL_GROUPS = {
    "ffn": re.compile(r"moe_|skinny_partial|finalize_hidden|finalize_out"),
    "decode_attn": re.compile(r"decode_split_kernel|decode_attn_kernel"),
}
GAP_LABELS = 200        # longest idle gaps labelled


@dataclass
class TraceSummary:
    window_s: float
    busy_s: float
    device_ops: int
    by_name: Dict[str, float] = field(default_factory=dict)   # seconds
    by_group: Dict[str, float] = field(default_factory=dict)  # seconds
    idle_by_label: Dict[str, float] = field(default_factory=dict)

    def top_ops(self, n: int = 10) -> List[list]:
        return [[k, v] for k, v in sorted(self.by_name.items(),
                                          key=lambda kv: -kv[1])[:n]]

    def top_idle(self, n: int = 10) -> List[list]:
        return [[k, v] for k, v in sorted(self.idle_by_label.items(),
                                          key=lambda kv: -kv[1])[:n]]


def _union(spans: List[Tuple[float, float]]):
    """Busy intervals (merged) of sorted spans."""
    merged: List[List[float]] = []
    for a, b in spans:
        if merged and a <= merged[-1][1]:
            merged[-1][1] = max(merged[-1][1], b)
        else:
            merged.append([a, b])
    return merged


def short_name(name: str) -> str:
    """A kernel's name without its return type, anonymous namespaces and
    parameter list."""
    name = name.replace("(anonymous namespace)::", "")
    if name.startswith("void "):
        name = name[5:]
    depth = 0
    for i, ch in enumerate(name):
        if ch == "<":
            depth += 1
        elif ch == ">":
            depth -= 1
        elif ch == "(" and depth == 0 and i:
            return name[:i]
    return name


def summarize(prof, window_s: float) -> TraceSummary:
    """Read the profiler's events: device spans (the harness's own marks,
    which the profiler mirrors on the device timeline, left out), device
    time by kernel name, and host spans for labelling idle gaps."""
    from torch.autograd import DeviceType
    dev, host = [], []
    by_name: Dict[str, float] = defaultdict(float)
    for e in prof.events():
        a, b = e.time_range.start, e.time_range.end
        if e.name.startswith("bench/") and e.device_type != DeviceType.CPU:
            continue
        if e.device_type == DeviceType.CUDA:
            dev.append((a, b))
            by_name[short_name(e.name)] += (b - a) / 1e6
        elif e.device_type == DeviceType.CPU:
            host.append((a, b, e.name))
    dev.sort()
    busy = _union(dev)
    by_group = {g: sum(t for n, t in by_name.items() if pat.search(n))
                for g, pat in KERNEL_GROUPS.items()}
    out = TraceSummary(window_s=window_s,
                       busy_s=sum(b - a for a, b in busy) / 1e6,
                       device_ops=len(dev), by_name=dict(by_name),
                       by_group=by_group)
    gaps = sorted(((b0[1], b1[0]) for b0, b1 in zip(busy, busy[1:])),
                  key=lambda g: g[0] - g[1])[:GAP_LABELS]
    host.sort()
    starts = [h[0] for h in host]
    longest = max((b - a for a, b, _ in host), default=0.0)
    idle: Dict[str, float] = defaultdict(float)
    for a, b in gaps:
        mid = 0.5 * (a + b)
        lo = bisect.bisect_left(starts, mid - longest)
        hi = bisect.bisect_right(starts, mid)
        mark, op = ("outside the loop", float("inf")), ("python", float("inf"))
        for s, e, name in host[lo:hi]:
            if s <= mid <= e:
                span = e - s
                if name.startswith("bench/"):
                    if span < mark[1]:
                        mark = (name[6:], span)
                elif span < op[1]:
                    op = (name, span)
        idle[f"{mark[0]}: {op[0]}"] += (b - a) / 1e6
    out.idle_by_label = dict(idle)
    return out
