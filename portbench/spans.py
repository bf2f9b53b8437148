"""The program's host spans (``serving/telemetry.py``: the newest
``TelemetryPlane``'s ring of ``(name, tick, t0_ns, t1_ns, args)``) joined
to a run's steps and failures by tick: the ``now`` the harness gave
``InferenceEngine.step`` (``Step.t0``) or ``Orchestrator.tick``
(``Failure.t_detect``). The profiled stretch of a ``--trace 1`` run is
left out, so the profiler's own cost stays out of the readings. A program
without host spans, a ring that dropped spans of the window, or a run
whose ring holds none of the ticks asked for, gives None."""
from __future__ import annotations

from typing import Dict, Iterable, List, Optional, Tuple

#: {tick: {name: [count, ns]}}
Index = Dict[float, Dict[str, List[int]]]


def index(run) -> Optional[Index]:
    """The newest plane's host spans by tick and name, or None, also when
    the ring dropped a span whose tick is past ``run.t_open`` (the ring
    drops the oldest first, so it dropped none of the window's when its
    oldest span's tick comes before the window)."""
    try:
        from repro_torch.serving.telemetry import newest_plane
    except ImportError:
        return None
    tracer = getattr(newest_plane(), "tracer", None)
    ring = getattr(tracer, "host_spans", None)
    if ring is None:
        return None
    if tracer.host_dropped and (not ring or ring[0][1] >= run.t_open):
        return None
    out: Index = {}
    for name, tick, t0, t1, _ in ring:
        tot = out.setdefault(tick, {}).setdefault(name, [0, 0])
        tot[0] += 1
        tot[1] += t1 - t0
    return out


def _profiled(run) -> Tuple[float, float]:
    """The harness-clock stretch the profiler held, (lo, hi]: from the end
    of the last step before the first traced one to the last traced
    step's end; empty without traced steps."""
    traced = [s for s in run.steps if s.traced]
    if not traced:
        return (0.0, 0.0)
    first = min(s.t0 for s in traced)
    before = [s.t1 for s in run.steps if not s.traced and s.t1 < first]
    return (max(before) if before else run.t_open,
            max(s.t1 for s in traced))


def profiled(run, t0: float, t1: Optional[float] = None) -> bool:
    """Whether [t0, t1] (harness clock) meets the profiled stretch."""
    lo, hi = _profiled(run)
    return lo < hi and t0 <= hi and (t0 if t1 is None else t1) > lo


def ns_of(spans: Dict[str, List[int]], names: Iterable[str]) -> int:
    return sum(spans[n][1] for n in names if n in spans)


def decode_steps(run, idx: Index) -> List[Dict[str, List[int]]]:
    """The spans of each decode step in the window (one that prefilled
    nothing and emitted tokens) outside the profiled stretch, whose
    ``step`` span the ring holds."""
    return [idx[s.t0] for s in run.decode_steps()
            if run.in_window(s.t1) and not s.traced and
            "step" in idx.get(s.t0, {})]


def per_decode_step_ms(run, names: Iterable[str],
                       less: Iterable[str] = ()) -> Optional[float]:
    """The mean over the window's decode steps of the spans ``names``,
    less the spans ``less``, in ms."""
    idx = index(run)
    if idx is None:
        return None
    steps = decode_steps(run, idx)
    if not steps:
        return None
    ns = sum(ns_of(s, names) - ns_of(s, less) for s in steps)
    return ns / len(steps) / 1e6


def restoring_failures(run, idx: Index) -> List[Dict[str, List[int]]]:
    """The spans of each detecting tick in the window that restored
    requests, outside the profiled stretch, whose ``orch.tick`` span the
    ring holds."""
    return [idx[f.t_detect] for f in run.failures
            if f.restored_bytes > 0 and run.in_window(f.t_detect) and
            not profiled(run, f.t_detect) and
            "orch.tick" in idx.get(f.t_detect, {})]


def per_restoring_failure_ms(run, names: Iterable[str]) -> Optional[float]:
    """The mean over the window's restoring failures of the spans
    ``names`` in the detecting tick, in ms."""
    idx = index(run)
    if idx is None:
        return None
    ticks = restoring_failures(run, idx)
    if not ticks:
        return None
    return sum(ns_of(t, names) for t in ticks) / len(ticks) / 1e6
