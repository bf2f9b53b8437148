"""Serving telemetry plane (port of ``repro.serving.telemetry``):
streaming metrics, span tracing, stall attribution and exporters.

  * **StreamingHistogram / MetricsRegistry**: fixed log-bucket histograms
    (O(1) memory, mergeable) plus counters and gauges. p50/p95/p99 come
    from cumulative bucket counts with in-bucket interpolation, exact to
    within one bucket (``buckets_per_decade`` sets the bucket ratio).
  * **EventBus**: a publish-at-emission stream of ``WorkerEvent``s with
    per-consumer cursors. Every worker, placement and request-plane event
    is published once, stamped with the virtual clock, and any number of
    consumers (``core/events.py`` timelines, the exporters here) read it
    through their own cursor without stealing from each other.
  * **SpanTracer / TelemetryPlane**: per-request root spans over the
    lifecycle (queued -> placed -> prefill chunks -> decode -> done) with
    queued/prefill/decode phase spans (a queued spell tagged with its
    cause: fresh, preempt, failover), restore, preempt, prefix-adopt and
    cancel instants, failure-detection spans on the workers track and one
    engine-track span per serving-loop step, all on the virtual clock.
  * **Stall attribution**: every TTFT/TBT gap above
    ``EngineConfig.stall_threshold`` is split into {detection, restore,
    preemption, queue_wait, prefill, rebalance} plus an ``execution``
    residual, by clipping the per-cause intervals to the gap in priority
    order; the components sum to the gap by construction.

Exporters: ``snapshot()`` (JSON, schema ``repro.telemetry.v1``, as the
reference writes it), ``prometheus_text()`` (text exposition format) and
``export_chrome()`` (Perfetto/Chrome ``trace_event`` JSON).

The plane is host bookkeeping on values the host already holds: no hook
reads a device tensor, so telemetry on and off give the same streams, the
same step-graph keys and no new capture, and a decode step keeps its one
host sync (the token drain).
"""
from __future__ import annotations

import json
import math
from dataclasses import dataclass, field
from typing import Dict, List, Optional, Tuple

import numpy as np

from repro_torch.core.orchestrator import WorkerEvent

SCHEMA = "repro.telemetry.v1"

# ---------------------------------------------------------------------------
# percentile helpers (np.percentile with the empty-array guard)
# ---------------------------------------------------------------------------


def pct(values, q: float) -> float:
    """``np.percentile`` with the empty-array guard every caller needs."""
    a = np.asarray(values, dtype=float)
    return float(np.percentile(a, q)) if a.size else 0.0


def summarize_latency(values) -> dict:
    """p50/p95/p99/mean/max summary of a latency list (seconds), with the
    empty guard. The exact-list twin of ``StreamingHistogram.snapshot`` —
    benches use both and cross-check them."""
    a = np.asarray(values, dtype=float)
    if a.size == 0:
        return {"n": 0, "p50": 0.0, "p95": 0.0, "p99": 0.0,
                "mean": 0.0, "max": 0.0}
    return {"n": int(a.size),
            "p50": float(np.percentile(a, 50)),
            "p95": float(np.percentile(a, 95)),
            "p99": float(np.percentile(a, 99)),
            "mean": float(a.mean()),
            "max": float(a.max())}


# ---------------------------------------------------------------------------
# streaming histogram
# ---------------------------------------------------------------------------


class StreamingHistogram:
    """Fixed log-bucket histogram: O(1) memory, mergeable, quantiles from
    cumulative counts.

    Buckets are geometric between ``lo`` and ``hi`` with
    ``buckets_per_decade`` per factor of 10, plus an underflow bucket
    [0, lo] and an overflow bucket (hi, inf). A streamed quantile lands in
    the same bucket as the exact value, so its error is bounded by one
    bucket ratio (10^(1/buckets_per_decade), ~7.5% at the default 32)."""

    __slots__ = ("lo", "hi", "bpd", "n", "counts", "count", "total",
                 "vmin", "vmax", "_log_lo")

    def __init__(self, lo: float = 1e-6, hi: float = 1e4,
                 buckets_per_decade: int = 32):
        assert lo > 0 and hi > lo and buckets_per_decade >= 1
        self.lo, self.hi, self.bpd = float(lo), float(hi), buckets_per_decade
        self._log_lo = math.log10(lo)
        decades = math.log10(hi) - self._log_lo
        self.n = int(round(decades * buckets_per_decade)) + 2
        self.counts = np.zeros((self.n,), np.int64)
        self.count = 0
        self.total = 0.0
        self.vmin = math.inf
        self.vmax = -math.inf

    # -- bucket geometry ----------------------------------------------------
    def bucket_index(self, v: float) -> int:
        v = max(float(v), 0.0)
        if v <= self.lo:
            return 0
        if v > self.hi:
            return self.n - 1
        i = int(math.floor((math.log10(v) - self._log_lo) * self.bpd)) + 1
        return min(max(i, 1), self.n - 2)

    def bucket_bounds(self, i: int) -> Tuple[float, float]:
        """(low, high] value bounds of bucket ``i``."""
        if i <= 0:
            return (0.0, self.lo)
        if i >= self.n - 1:
            return (self.hi, math.inf)
        return (self.lo * 10.0 ** ((i - 1) / self.bpd),
                self.lo * 10.0 ** (i / self.bpd))

    # -- ingest -------------------------------------------------------------
    def observe(self, v: float):
        v = max(float(v), 0.0)
        self.counts[self.bucket_index(v)] += 1
        self.count += 1
        self.total += v
        if v < self.vmin:
            self.vmin = v
        if v > self.vmax:
            self.vmax = v

    def observe_n(self, v: float, n: int):
        """Observe the same value ``n`` times in O(1) (a decode segment's
        n-1 zero gaps land in one bucket update)."""
        if n <= 0:
            return
        v = max(float(v), 0.0)
        self.counts[self.bucket_index(v)] += n
        self.count += n
        self.total += v * n
        if v < self.vmin:
            self.vmin = v
        if v > self.vmax:
            self.vmax = v

    def merge(self, other: "StreamingHistogram"):
        assert (self.lo, self.hi, self.bpd) == \
            (other.lo, other.hi, other.bpd), "incompatible bucket configs"
        self.counts += other.counts
        self.count += other.count
        self.total += other.total
        self.vmin = min(self.vmin, other.vmin)
        self.vmax = max(self.vmax, other.vmax)

    # -- summary ------------------------------------------------------------
    def quantile(self, q: float) -> float:
        """Streamed quantile (q in [0, 1]): find the bucket holding the
        target rank, interpolate linearly inside it, clamp to the observed
        [min, max]."""
        if self.count == 0:
            return 0.0
        target = q * self.count
        cum = 0
        for i in range(self.n):
            c = int(self.counts[i])
            if c == 0:
                continue
            if cum + c >= target:
                blo, bhi = self.bucket_bounds(i)
                if not math.isfinite(bhi):          # overflow bucket
                    return self.vmax
                frac = (target - cum) / c
                v = blo + frac * (bhi - blo)
                return min(max(v, self.vmin), self.vmax)
            cum += c
        return self.vmax

    @property
    def mean(self) -> float:
        return self.total / self.count if self.count else 0.0

    def snapshot(self) -> dict:
        return {"count": self.count, "sum": self.total,
                "min": self.vmin if self.count else 0.0,
                "max": self.vmax if self.count else 0.0,
                "mean": self.mean,
                "p50": self.quantile(0.50),
                "p95": self.quantile(0.95),
                "p99": self.quantile(0.99),
                "lo": self.lo, "hi": self.hi,
                "buckets_per_decade": self.bpd,
                "buckets": {str(i): int(c)
                            for i, c in enumerate(self.counts) if c}}


# ---------------------------------------------------------------------------
# metrics registry
# ---------------------------------------------------------------------------


def _prom_name(name: str) -> str:
    out = "".join(c if c.isalnum() or c == "_" else "_" for c in name)
    return "tarragon_" + out


class MetricsRegistry:
    """Counters, gauges, and streaming histograms under dotted names.
    ``snapshot()`` is the JSON export; ``prometheus_text()`` the text
    exposition format. Registries merge (multi-shard aggregation)."""

    def __init__(self, lo: float = 1e-6, hi: float = 1e4,
                 buckets_per_decade: int = 32):
        self._hist_cfg = (lo, hi, buckets_per_decade)
        self.counters: Dict[str, int] = {}
        self.gauges: Dict[str, float] = {}
        self.hists: Dict[str, StreamingHistogram] = {}

    def inc(self, name: str, n: int = 1):
        self.counters[name] = self.counters.get(name, 0) + n

    def set_counter(self, name: str, v: int):
        """Pin a counter to an externally-accumulated value (mirrors of
        legacy stat structs like GatewayStats sync through this)."""
        self.counters[name] = int(v)

    def gauge(self, name: str, v: float):
        self.gauges[name] = float(v)

    def hist(self, name: str) -> StreamingHistogram:
        h = self.hists.get(name)
        if h is None:
            lo, hi, bpd = self._hist_cfg
            h = self.hists[name] = StreamingHistogram(lo, hi, bpd)
        return h

    def observe(self, name: str, v: float):
        self.hist(name).observe(v)

    def merge(self, other: "MetricsRegistry"):
        for k, v in other.counters.items():
            self.inc(k, v)
        for k, v in other.gauges.items():
            self.gauges[k] = v
        for k, h in other.hists.items():
            self.hist(k).merge(h)

    def snapshot(self) -> dict:
        return {"schema": SCHEMA,
                "counters": dict(sorted(self.counters.items())),
                "gauges": dict(sorted(self.gauges.items())),
                "histograms": {k: h.snapshot()
                               for k, h in sorted(self.hists.items())}}

    def prometheus_text(self) -> str:
        lines: List[str] = []
        for k in sorted(self.counters):
            n = _prom_name(k) + "_total"
            lines.append(f"# TYPE {n} counter")
            lines.append(f"{n} {self.counters[k]}")
        for k in sorted(self.gauges):
            n = _prom_name(k)
            lines.append(f"# TYPE {n} gauge")
            lines.append(f"{n} {self.gauges[k]:g}")
        for k in sorted(self.hists):
            h = self.hists[k]
            n = _prom_name(k)
            lines.append(f"# TYPE {n} histogram")
            cum = 0
            for i in range(h.n):
                c = int(h.counts[i])
                if c == 0:
                    continue
                cum += c
                le = h.bucket_bounds(i)[1]
                le_s = "+Inf" if not math.isfinite(le) else f"{le:.9g}"
                lines.append(f'{n}_bucket{{le="{le_s}"}} {cum}')
            if cum != h.count or not h.counts[-1]:
                lines.append(f'{n}_bucket{{le="+Inf"}} {h.count}')
            lines.append(f"{n}_sum {h.total:.9g}")
            lines.append(f"{n}_count {h.count}")
        return "\n".join(lines) + "\n"


# ---------------------------------------------------------------------------
# event bus: publish-at-emission, per-consumer cursors
# ---------------------------------------------------------------------------


class EventBus:
    """Multi-consumer event stream over ``WorkerEvent``s.

    Producers publish exactly once, at emission time, with the event
    already stamped with the virtual clock. Consumers call
    ``drain(consumer)`` with a name of their choosing and receive only the
    events past their own cursor — no consumer can steal another's view,
    which is what the old destructive ``drain_request_events`` /
    ``drain_plan_events`` lists could not guarantee. ``events`` is the
    full read-only history (bounded by ``max_events``; beyond that new
    events are counted in ``dropped`` instead of stored)."""

    def __init__(self, max_events: int = 1_000_000):
        self.max_events = max_events
        self._events: List[WorkerEvent] = []
        self._cursors: Dict[str, int] = {}
        self.dropped = 0

    def publish(self, ev: WorkerEvent):
        if len(self._events) >= self.max_events:
            self.dropped += 1
            return
        self._events.append(ev)

    def drain(self, consumer: str) -> List[WorkerEvent]:
        i = self._cursors.get(consumer, 0)
        evs = self._events[i:]
        self._cursors[consumer] = len(self._events)
        return list(evs)

    def cursor(self, consumer: str) -> int:
        return self._cursors.get(consumer, 0)

    @property
    def events(self) -> Tuple[WorkerEvent, ...]:
        return tuple(self._events)

    def __len__(self) -> int:
        return len(self._events)


# ---------------------------------------------------------------------------
# span tracing
# ---------------------------------------------------------------------------


@dataclass
class Span:
    track: str                 # "req:<rid>" | "engine" | "workers"
    name: str
    t0: float
    t1: Optional[float] = None
    cat: str = "phase"
    args: Dict[str, object] = field(default_factory=dict)

    @property
    def duration(self) -> float:
        return (self.t1 - self.t0) if self.t1 is not None else 0.0


class SpanTracer:
    """Virtual-clock span recorder with a Perfetto/Chrome ``trace_event``
    exporter. Memory is bounded: past ``max_spans`` closed spans, new ones
    are dropped and counted (``dropped``) rather than growing without
    limit — a soak run keeps its histograms exact and its trace a prefix."""

    def __init__(self, max_spans: int = 200_000):
        self.max_spans = max_spans
        self.spans: List[Span] = []
        self.instants: List[Span] = []
        self.dropped = 0

    def _room(self) -> bool:
        if len(self.spans) + len(self.instants) >= self.max_spans:
            self.dropped += 1
            return False
        return True

    def begin(self, track: str, name: str, t: float, cat: str = "phase",
              **args) -> Span:
        sp = Span(track, name, t, None, cat, dict(args))
        if self._room():
            self.spans.append(sp)
        return sp

    @staticmethod
    def end(span: Span, t: float, **args):
        span.t1 = t
        span.args.update(args)

    def complete(self, track: str, name: str, t0: float, t1: float,
                 cat: str = "phase", **args) -> Span:
        sp = Span(track, name, t0, t1, cat, dict(args))
        if self._room():
            self.spans.append(sp)
        return sp

    def instant(self, track: str, name: str, t: float, **args) -> Span:
        sp = Span(track, name, t, t, "instant", dict(args))
        if self._room():
            self.instants.append(sp)
        return sp

    # -- Perfetto / Chrome trace_event JSON ---------------------------------
    def chrome_trace(self, clock_end: Optional[float] = None) -> dict:
        """``{"traceEvents": [...]}``: one pid, one tid per track, complete
        ("X") events for spans, instants ("i"), thread-name metadata. Times
        are virtual seconds scaled to microseconds."""
        tids: Dict[str, int] = {}

        def tid_of(track: str) -> int:
            if track not in tids:
                tids[track] = len(tids)
            return tids[track]

        # stable track order: engine/workers first, then request tracks
        for sp in self.spans + self.instants:
            if not sp.track.startswith("req:"):
                tid_of(sp.track)
        for sp in self.spans + self.instants:
            tid_of(sp.track)

        events: List[dict] = [
            {"ph": "M", "pid": 1, "name": "process_name",
             "args": {"name": "tarragon-serving"}}]
        for track, tid in tids.items():
            events.append({"ph": "M", "pid": 1, "tid": tid,
                           "name": "thread_name", "args": {"name": track}})
        for sp in self.spans:
            t1 = sp.t1 if sp.t1 is not None else \
                (clock_end if clock_end is not None else sp.t0)
            events.append({
                "ph": "X", "pid": 1, "tid": tid_of(sp.track),
                "name": sp.name, "cat": sp.cat,
                "ts": sp.t0 * 1e6, "dur": max(t1 - sp.t0, 0.0) * 1e6,
                "args": sp.args})
        for sp in self.instants:
            events.append({
                "ph": "i", "pid": 1, "tid": tid_of(sp.track),
                "name": sp.name, "cat": sp.cat, "ts": sp.t0 * 1e6,
                "s": "t", "args": sp.args})
        return {"traceEvents": events, "displayTimeUnit": "ms"}


# ---------------------------------------------------------------------------
# stall attribution
# ---------------------------------------------------------------------------

#: attribution priority: an instant of wall time inside the gap window is
#: charged to the FIRST cause below whose interval covers it; whatever no
#: cause claims is ``execution`` (ordinary compute).
STALL_CAUSES = ("detection", "restore", "preemption", "queue_wait",
                "prefill", "rebalance")


@dataclass
class StallRecord:
    rid: str
    kind: str                  # "ttft" | "tbt"
    t0: float
    t1: float
    gap: float
    components: Dict[str, float] = field(default_factory=dict)

    def to_dict(self) -> dict:
        return {"rid": self.rid, "kind": self.kind, "t0": self.t0,
                "t1": self.t1, "gap": self.gap,
                "components": dict(self.components)}


def _subtract(piece: Tuple[float, float],
              claimed: List[Tuple[float, float]]) -> List[Tuple[float, float]]:
    """Remove every claimed interval from ``piece``; return the remaining
    disjoint fragments."""
    frags = [piece]
    for (c0, c1) in claimed:
        nxt = []
        for (a, b) in frags:
            if c1 <= a or c0 >= b:
                nxt.append((a, b))
                continue
            if a < c0:
                nxt.append((a, c0))
            if c1 < b:
                nxt.append((c1, b))
        frags = nxt
        if not frags:
            break
    return frags


def attribute_gap(t0: float, t1: float,
                  cause_intervals: Dict[str, List[Tuple[float, float]]]
                  ) -> Dict[str, float]:
    """Decompose the gap [t0, t1] over ``STALL_CAUSES`` (in priority
    order) plus an ``execution`` residual. Every component is the length
    of the cause's intervals clipped to the window and not already claimed
    by a higher-priority cause — so the components sum to the gap exactly,
    by construction."""
    comps = {c: 0.0 for c in STALL_CAUSES}
    claimed: List[Tuple[float, float]] = []
    for cause in STALL_CAUSES:
        for (a, b) in cause_intervals.get(cause, ()):
            a, b = max(a, t0), min(b, t1)
            if b <= a:
                continue
            for (fa, fb) in _subtract((a, b), claimed):
                comps[cause] += fb - fa
                claimed.append((fa, fb))
    comps["execution"] = (t1 - t0) - sum(comps.values())
    return comps


# ---------------------------------------------------------------------------
# the plane
# ---------------------------------------------------------------------------

#: phase name + queued-cause -> attribution cause
_PHASE_CAUSE = {("queued", "fresh"): "queue_wait",
                ("queued", "preempt"): "preemption",
                ("queued", "failover"): "restore",
                ("prefill", None): "prefill"}


class TelemetryPlane:
    """Per-engine observability plane: registry, tracer and stall
    attribution, fed by host hooks at every lifecycle transition. The
    engine creates it when ``EngineConfig.telemetry`` is True; every hook
    site checks ``engine.telemetry is not None``, and nothing here touches
    device state."""

    def __init__(self, engine):
        self.engine = engine
        ecfg = engine.ecfg
        self.registry = MetricsRegistry(
            buckets_per_decade=ecfg.hist_buckets_per_decade)
        self.tracer = SpanTracer()
        self.stall_threshold = float(ecfg.stall_threshold)
        self.now = 0.0
        # per-request state
        self._root: Dict[str, Span] = {}
        self._phase: Dict[str, Span] = {}
        self._causes: Dict[str, List[Tuple[str, float, float]]] = {}
        self._last_token: Dict[str, float] = {}
        self._ttft_seen: set = set()
        self.closed_roots: Dict[str, int] = {}
        # global cause windows
        self._detect_windows: List[Tuple[float, float]] = []
        self._prefill_windows: List[Tuple[float, float]] = []
        self._stalls: List[StallRecord] = []
        self._attributed = False

    # -- internals ----------------------------------------------------------
    def _touch(self, t: float) -> float:
        if t > self.now:
            self.now = t
        return t

    def _open_phase(self, rid: str, name: str, t: float,
                    cause: Optional[str] = None, **args):
        self._close_phase(rid, t)
        label = f"{name}({cause})" if cause else name
        sp = self.tracer.begin(f"req:{rid}", label, t, cat="phase", **args)
        sp.args["_cause"] = cause
        self._phase[rid] = sp

    def _close_phase(self, rid: str, t: float, **args):
        sp = self._phase.pop(rid, None)
        if sp is None:
            return
        self.tracer.end(sp, t, **args)
        base = sp.name.split("(", 1)[0]
        cause = _PHASE_CAUSE.get((base, sp.args.get("_cause"))) or \
            _PHASE_CAUSE.get((base, None))
        if cause is not None and t > sp.t0:
            self._causes.setdefault(rid, []).append((cause, sp.t0, t))

    # -- request lifecycle hooks --------------------------------------------
    def on_enqueue(self, rid: str, t: float, slo_class: str):
        self._touch(t)
        if rid in self._root:
            # rid reuse after release: fall through and re-open below
            pass
        self._root[rid] = self.tracer.begin(
            f"req:{rid}", rid, t, cat="request", slo_class=slo_class)
        self._open_phase(rid, "queued", t, cause="fresh")

    def on_requeued(self, rid: str, t: float, cause: str):
        """Preempted/failover request re-entered its class queue."""
        self._touch(t)
        self._close_phase(rid, t)
        self._open_phase(rid, "queued", t, cause=cause)

    def on_admit(self, rid: str, t: float, aw: int, slot: int,
                 slo_class: str, recovery: bool, prefix_hit: int,
                 wait: float):
        self._touch(t)
        self._close_phase(rid, t, aw=aw, slot=slot)
        self.registry.observe("queue_delay", wait)
        self.registry.observe(f"queue_delay.{slo_class}", wait)
        if prefix_hit > 0:
            self.tracer.instant(f"req:{rid}", "prefix_adopt", t,
                                tokens=prefix_hit)
            self.registry.observe("prefix.hit_len", prefix_hit)

    def on_prefill_start(self, rid: str, t: float, cursor: int, n: int):
        self._touch(t)
        self._open_phase(rid, "prefill", t, cursor=cursor, prompt_len=n)

    def on_prefill_chunk(self, rid: str, t: float, take: int, shape: int):
        self._touch(t)
        self.registry.inc("prefill.chunk_tokens", take)
        self.registry.observe("prefill.chunk_take", take)

    def on_prefill_done(self, rid: str, t: float):
        self._touch(t)
        self._close_phase(rid, t)
        self._open_phase(rid, "decode", t)

    def on_whole_prefill(self, rid: str, t: float, n: int, scheme: str):
        """Whole-prompt (padded/exact) prefill: admission and prefill land
        in the same tick — a zero-length prefill span keeps the phase
        sequence uniform, then decode opens."""
        self._touch(t)
        self.tracer.complete(f"req:{rid}", "prefill", t, t, scheme=scheme,
                             prompt_len=n)
        self._open_phase(rid, "decode", t)

    def on_restore(self, rid: str, t: float, segments: int,
                   resumed_prefill: bool):
        self._touch(t)
        self.tracer.instant(f"req:{rid}", "restore", t, segments=segments,
                            resumed_prefill=resumed_prefill)
        self.registry.inc("recovery.restores")
        self.registry.observe("recovery.restored_segments", segments)
        if resumed_prefill:
            self._open_phase(rid, "prefill", t, cause=None, resumed=True)
        else:
            self._open_phase(rid, "decode", t, resumed=True)

    def on_preempt(self, rid: str, t: float):
        self._touch(t)
        self._close_phase(rid, t, outcome="preempted")
        self._open_phase(rid, "queued", t, cause="preempt")

    def on_failover(self, rid: str, t: float):
        """AW crash victim requeued for §6.2 restoration: the requeue
        sub-span (queued(failover)) starts here and its wait is attributed
        to ``restore`` except where the detection window overlaps."""
        self.on_requeued(rid, t, cause="failover")

    def on_cancel(self, rid: str, t: float, where: str):
        self._touch(t)
        self._close_phase(rid, t, outcome="cancelled")

    def on_drop(self, rid: str, t: Optional[float], outcome: str):
        """Request left the system straight from the queue (queued-cancel
        or synchronous-admission refusal): close its root span here, since
        no RequestState exists for ``on_release`` to see."""
        t = self._touch(t if t is not None else self.now)
        self._close_phase(rid, t, outcome=outcome)
        root = self._root.pop(rid, None)
        if root is not None:
            self.tracer.end(root, t, outcome=outcome)
            self.closed_roots[rid] = self.closed_roots.get(rid, 0) + 1
            self.registry.inc(f"requests.outcome.{outcome}")

    def on_release(self, r):
        """Close the request's root span exactly once (done, cancelled,
        preempted-and-released, and failover paths all funnel through
        ``engine.release_request``)."""
        t = self._touch(r.t_done if r.t_done >= 0 else self.now)
        rid = r.rid
        self._close_phase(rid, t, outcome=r.state)
        root = self._root.pop(rid, None)
        if root is not None:
            self.tracer.end(root, t, outcome=r.state,
                            tokens=len(r.tokens),
                            preemptions=r.preemptions,
                            prefix_hit=r.prefix_hit)
            self.closed_roots[rid] = self.closed_roots.get(rid, 0) + 1
        self.registry.inc("requests.released")
        self.registry.inc(f"requests.outcome.{r.state}")

    # -- failure / control-plane hooks --------------------------------------
    def on_failure_detected(self, kind: str, worker_id: int,
                            t_fail: float, t_detect: float):
        self._touch(t_detect)
        self.tracer.complete("workers", f"detect_{kind}{worker_id}",
                             t_fail, t_detect, cat="failure")
        self._detect_windows.append((t_fail, t_detect))
        self.registry.inc(f"failures.{kind}")
        self.registry.observe("failures.detection_latency",
                              t_detect - t_fail)

    def on_request_event(self, ev: WorkerEvent):
        """Generic request-plane event (``engine._note_request_event``):
        every kind becomes an instant on the rid track + a counter, so the
        trace carries preempted/cancelled/deadline_missed/prefix_restored
        markers without each site needing a dedicated hook."""
        self._touch(ev.t)
        self.registry.inc(f"events.{ev.kind}")
        self.tracer.instant(f"req:{ev.worker}", ev.kind, ev.t,
                            detail=ev.detail)

    # -- serving-loop hooks --------------------------------------------------
    def on_step(self, t0: float, t1: float, prefill_tokens: int,
                prefill_time: float, tokens_out: int):
        """One serving-loop tick [t0, t1]: an engine-track span, plus a
        global prefill window covering the slice of the tick charged to
        chunked prefill (the 'prefill budget' stall cause for co-resident
        decodes)."""
        self._touch(t1)
        self.registry.inc("engine.steps")
        self.tracer.complete("engine", "step", t0, t1, cat="step",
                             prefill_tokens=prefill_tokens,
                             tokens=tokens_out)
        if prefill_time > 0:
            w0 = max(t0, t1 - prefill_time)
            self._prefill_windows.append((w0, t1))

    def observe_tokens(self, rid: str, t: float, n: int,
                       slo_class: str = "standard"):
        """``n`` tokens for ``rid`` stamped at virtual time ``t`` (a
        decode segment lands several per step). Streams the same gap
        sequence ``ServeMetrics.tbt_values`` computes exactly: the gap
        from the previous stamp, then n-1 zeros."""
        self._touch(t)
        if n <= 0:
            return
        self.registry.inc("tokens.emitted", n)
        h = self.registry.hist("tbt")
        hc = self.registry.hist(f"tbt.{slo_class}")
        last = self._last_token.get(rid)
        zeros = n - 1
        if last is not None:
            gap = t - last
            h.observe(gap)
            hc.observe(gap)
            if gap > self.stall_threshold:
                self._stalls.append(StallRecord(rid, "tbt", last, t, gap))
        else:
            zeros = n - 1
        h.observe_n(0.0, zeros)
        hc.observe_n(0.0, zeros)
        self._last_token[rid] = t

    def observe_ttft(self, rid: str, v: float, slo_class: str,
                     t_enqueue: float):
        if rid in self._ttft_seen or v < 0:
            return
        self._ttft_seen.add(rid)
        self.registry.observe("ttft", v)
        self.registry.observe(f"ttft.{slo_class}", v)
        if v > self.stall_threshold:
            self._stalls.append(
                StallRecord(rid, "ttft", t_enqueue, t_enqueue + v, v))

    # -- stall attribution ---------------------------------------------------
    def _rebalance_windows(self) -> List[Tuple[float, float]]:
        """Pair rebalance_started -> rebalanced events off the bus (a
        second, non-stealing consumer of the same stream the orchestrator
        audit log reads)."""
        wins, open_t = [], None
        for ev in self.engine.bus.events:
            if ev.kind == "rebalance_started":
                open_t = ev.t
            elif ev.kind == "rebalanced" and open_t is not None:
                wins.append((open_t, ev.t))
                open_t = None
        return wins

    def stall_report(self) -> List[dict]:
        """Attribute every recorded stall: per-request cause intervals
        (queued spells by cause, prefill phases) + global windows
        (failure detection, chunked-prefill charges, rebalances), clipped
        to the gap window in priority order; the residual is
        ``execution``. Components sum to the gap by construction."""
        if not self._attributed:
            rebal = self._rebalance_windows()
            for s in self._stalls:
                per_cause: Dict[str, List[Tuple[float, float]]] = {}
                for cause, a, b in self._causes.get(s.rid, ()):
                    per_cause.setdefault(cause, []).append((a, b))
                per_cause["detection"] = list(self._detect_windows)
                per_cause.setdefault("prefill", []).extend(
                    self._prefill_windows)
                per_cause["rebalance"] = rebal
                s.components = attribute_gap(s.t0, s.t1, per_cause)
                for c, v in s.components.items():
                    if v > 0:
                        self.registry.hist(f"stall.{c}").observe(v)
                self.tracer.complete(
                    f"req:{s.rid}", f"stall({s.kind})", s.t0, s.t1,
                    cat="stall", **{k: round(v, 6)
                                    for k, v in s.components.items()})
            self._attributed = True
        return [s.to_dict() for s in self._stalls]

    # -- lifecycle -----------------------------------------------------------
    def finalize(self, t: Optional[float] = None):
        """End of a serving run: close still-open phases/roots (a request
        live at the duration cutoff still closes exactly one root span,
        with outcome ``unfinished``) and compute stall attribution."""
        t = self._touch(t if t is not None else self.now)
        for rid in list(self._phase):
            self._close_phase(rid, t, outcome="unfinished")
        for rid, root in list(self._root.items()):
            self.tracer.end(root, t, outcome="unfinished")
            self.closed_roots[rid] = self.closed_roots.get(rid, 0) + 1
            del self._root[rid]
        self.stall_report()
        path = self.engine.ecfg.trace_export_path
        if path:
            self.export_chrome(path)

    # -- export --------------------------------------------------------------
    def sync(self):
        """Mirror the stat structs (GatewayStats, the prefill planes, the
        placement EMAs, the step-graph count) into the registry, so one
        snapshot carries the whole stack's counters."""
        eng = self.engine
        gs = eng.gateway.stats
        for k in ("enqueued", "admitted", "requeued", "blocked_ticks",
                  "preemptions", "host_syncs", "prefix_hits",
                  "prefix_misses", "prefix_hit_tokens", "prefix_evictions",
                  "prefix_restored", "prefix_global_hits",
                  "prefix_migrated", "session_repins"):
            self.registry.set_counter(f"gateway.{k}", getattr(gs, k))
        for cls, counts in gs.by_class.items():
            for k, v in counts.items():
                self.registry.set_counter(f"gateway.{cls}.{k}", v)
        self.registry.gauge("gateway.queue_depth", eng.gateway.depth())
        self.registry.gauge("requests.active", len(eng.active_requests()))
        self.registry.gauge("requests.prefilling",
                            len(eng.prefilling_requests()))
        for w in eng.aws:
            used, total = w.slot_occupancy()
            self.registry.gauge(f"aw{w.aw_id}.slots_used", used)
            self.registry.gauge(f"aw{w.aw_id}.slots_total", total)
            self.registry.gauge(f"aw{w.aw_id}.alive", int(w.alive))
            ps = w.kv_page_stats()
            if ps is not None:
                self.registry.gauge(f"aw{w.aw_id}.pages_used", ps[0])
                self.registry.gauge(f"aw{w.aw_id}.pages_total", ps[1])
        if eng.pages is not None:
            # the paged KV plane: physical occupancy and cross-request
            # page sharing, cluster-wide
            for k, v in eng.pages.stats().items():
                self.registry.gauge(f"kv.{k}", v)
        self.registry.gauge("ew.live", len(eng.live_ews))
        if eng.placement_mgr is not None:
            self.registry.gauge("placement.generation",
                                eng.placement_generation)
            self.registry.gauge("placement.imbalance",
                                float(eng.placement_mgr.imbalance()))
            for ew, load in eng.placement_mgr.per_ew_load().items():
                self.registry.gauge(f"placement.ew{ew}.load_ema",
                                    float(load))
        sched = eng.scheduler.stats
        self.registry.set_counter("prefill.calls", sched.calls)
        self.registry.set_counter("prefill.real_tokens", sched.real_tokens)
        if eng.chunked is not None:
            cs = eng.chunked.stats
            self.registry.set_counter("prefill.chunked.calls", cs.calls)
            self.registry.set_counter("prefill.chunked.chunks", cs.chunks)
            self.registry.set_counter("prefill.chunked.real_tokens",
                                      cs.real_tokens)
            self.registry.set_counter("prefill.chunked.resumed", cs.resumed)
        ctl = eng.controller
        if ctl is not None:
            # the control plane: decision counters and live signals, beside
            # the events.controller_* counters and req:controller instants
            # its decisions emit
            for k, v in ctl.stats().items():
                if isinstance(v, float):
                    self.registry.gauge(f"controller.{k}", v)
                else:
                    self.registry.set_counter(f"controller.{k}", int(v))
        # the no-new-capture invariant, as a gauge anyone can scrape (the
        # reference's jit.decode_traces: step graphs are the port's traces)
        self.registry.gauge("graph.decode_captures",
                            eng.decode_plane.captures())
        self.registry.gauge("bus.events", len(eng.bus))
        self.registry.gauge("bus.dropped", eng.bus.dropped)
        # events lost to the bus cap, as a counter Prometheus scrapes
        self.registry.set_counter("events.dropped", eng.bus.dropped)
        fr = eng.flightrec
        if fr is not None:
            # the forensics plane: recorder occupancy and watchdog trips
            self.registry.gauge("flightrec.records", len(fr.records))
            self.registry.set_counter("flightrec.records_total",
                                      fr.records_total)
            self.registry.set_counter("flightrec.records_dropped",
                                      fr.records_dropped)
            self.registry.gauge("flightrec.fingerprints", fr.fingerprints)
            wd = fr.watchdogs
            if wd is not None:
                self.registry.gauge("health.intervals", wd.intervals)
                self.registry.set_counter("health.trips", len(wd.trips))
                for k, v in wd.trip_counts.items():
                    self.registry.set_counter(f"health.trips.{k}", v)

    def snapshot(self) -> dict:
        self.sync()
        snap = self.registry.snapshot()
        snap["clock"] = self.now
        snap["stalls"] = self.stall_report()
        snap["spans"] = {"closed": len(self.tracer.spans),
                         "instants": len(self.tracer.instants),
                         "open_roots": len(self._root),
                         "dropped": self.tracer.dropped}
        return snap

    def prometheus_text(self) -> str:
        self.sync()
        return self.registry.prometheus_text()

    def export_chrome(self, path: Optional[str] = None) -> dict:
        self.stall_report()
        trace = self.tracer.chrome_trace(clock_end=self.now)
        if path:
            with open(path, "w") as f:
                json.dump(trace, f)
        return trace
