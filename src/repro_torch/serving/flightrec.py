"""Flight recorder, health watchdogs and postmortem forensics (port of
``repro.serving.flightrec``).

The telemetry plane aggregates a run; this module keeps what it takes to
reconstruct one, in three pieces:

  * **FlightRecorder**: a bounded black box riding the EventBus as its own
    cursor-based consumer. It keeps a ring of records (worker events,
    controller decisions, placement generations, chunk commits,
    preemption and restore markers, submissions) plus periodic engine
    *fingerprints* (config hash, plan generation, per-AW slot and page
    occupancy, page-pool watermarks, checkpoint-store cursors). Each ring
    holds ``EngineConfig.flight_capacity`` entries; older ones drop and a
    counter rises.
  * **Postmortem bundles**: ``dump()`` exports a versioned JSON bundle
    (schema ``repro_torch.postmortem.v1``): the record ring, every
    submission with its prompt tokens (the replay workload), the recorded
    outputs, the scripted fault and scale injections, the controller's
    decisions, open spans, the incident window's stall records and
    per-worker snapshots. The bundle names how the engine's weights were
    made (``{"seed": s}`` for the engine's own seeded draw, null for
    weights the caller passed in) in place of the reference's JAX init
    key. A dump fires on the first failure detection or watchdog trip when
    ``flight_autodump`` names a path, or on demand. ``launch/replay.py``
    re-runs the incident from a bundle and checks the outputs bit for bit.
  * **HealthWatchdogs**: detectors of slow degradation: a leak detector
    (monotone trend of the PagePool and slot free-list watermarks over a
    sliding window of intervals), a stall-regression detector (windowed
    TTFT/TBT p99 from streamed histogram deltas against a baseline
    window, suppressed around injected faults) and invariant probes
    (``PagePool.check()``; every open root span belongs to a live
    request). Trips emit ``health_*`` events and registry counters and
    trigger the recorder's autodump.

Host bookkeeping only: every value read here (``committed_token``,
``slot_occupancy``, ``kv_page_stats``, ``PagePool`` arrays, the request's
token list after the drain) already lives on the host, so recorder and
watchdogs on equal off bit for bit, with no sync and no step-graph capture
added (tests/test_torch_flightrec.py; the card case in
tests/test_torch_cuda.py checks the sync count).
"""
from __future__ import annotations

import dataclasses
import hashlib
import json
import math
import os
import weakref
from collections import deque
from typing import Dict, List, Optional

import numpy as np

SCHEMA = "repro_torch.postmortem.v1"

#: knobs that must not perturb the config hash: they name output paths,
#: and replay neutralizes them
_HASH_EXCLUDE = ("flight_autodump", "trace_export_path")

#: bus event kinds that mark the system as disturbed for the watchdogs: a
#: window overlapping one of these is not judged for leaks or stall
#: regressions (failover churn moves every watermark legitimately)
_DISTURB_KINDS = frozenset((
    "fail_aw", "fail_ew", "detected", "provisioned", "reprotected",
    "scale_out_started", "drain_started", "rebalance_started",
    "scaled_out", "scaled_in", "rebalanced", "scale_failed",
    "placement_changed", "preempted"))

#: live recorders, held weakly, for a postmortem on demand
#: (``dump_live_recorders``)
_LIVE: "weakref.WeakSet" = weakref.WeakSet()


def _jsonable(x):
    """Recursively coerce numpy scalars and arrays so the bundle dumps."""
    if isinstance(x, dict):
        return {str(k): _jsonable(v) for k, v in x.items()}
    if isinstance(x, (list, tuple)):
        return [_jsonable(v) for v in x]
    if isinstance(x, np.ndarray):
        return x.tolist()
    if isinstance(x, np.integer):
        return int(x)
    if isinstance(x, np.floating):
        return float(x)
    return x


def hash_config_dicts(model_d: dict, engine_d: dict) -> str:
    """Digest of (ModelConfig, EngineConfig) as plain dicts, minus the
    output-path knobs. JSON-canonical, so a bundle round trip (tuples to
    lists) hashes the same."""
    e = {k: v for k, v in engine_d.items() if k not in _HASH_EXCLUDE}
    blob = json.dumps({"model": model_d, "engine": e},
                      sort_keys=True, default=str)
    return hashlib.sha1(blob.encode()).hexdigest()[:16]


def config_hash(cfg, ecfg) -> str:
    """Digest of the live (ModelConfig, EngineConfig): the replay's
    handshake, a bundle replays only against the same config."""
    return hash_config_dicts(dataclasses.asdict(cfg),
                             dataclasses.asdict(ecfg))


def dump_live_recorders(directory: str, tag: str, limit: int = 3
                        ) -> List[str]:
    """Dump the most recently created live recorders into ``directory``
    (best effort: a broken engine must not mask the failure that asked
    for the dump). Returns the bundle paths written."""
    recs = sorted(_LIVE, key=lambda fr: fr.serial)[-limit:]
    paths = []
    safe = "".join(c if c.isalnum() or c in "-_." else "_" for c in tag)
    for fr in recs:
        try:
            os.makedirs(directory, exist_ok=True)
            path = os.path.join(directory,
                                f"{safe}.r{fr.serial}.postmortem.json")
            fr.dump(path, reason=f"test failure: {tag}")
            paths.append(path)
        except Exception:
            pass
    return paths


# ---------------------------------------------------------------------------
# the recorder
# ---------------------------------------------------------------------------


class FlightRecorder:
    """Bounded black box for one engine. Host-side only; every hook site
    guards on ``engine.flightrec is not None``, as the telemetry plane's
    do, so switching it off cannot change a token."""

    CONSUMER = "flightrec"
    _serial = 0

    def __init__(self, engine):
        self.engine = engine
        ecfg = engine.ecfg
        FlightRecorder._serial += 1
        self.serial = FlightRecorder._serial
        cap = max(int(ecfg.flight_capacity), 16)
        self.records: deque = deque(maxlen=cap)
        self.records_total = 0
        self.submissions: deque = deque(maxlen=cap)
        self.sub_total = 0
        self.outputs: deque = deque(maxlen=cap)
        self.out_total = 0
        self.injections = {"failures": [], "scales": []}
        self.loops: List[dict] = []      # one entry per run_serving call
        self.orch: Optional[dict] = None
        self.fingerprint_every = float(ecfg.flight_fingerprint_every)
        self._next_fp = 0.0
        self.fingerprints = 0
        self.autodump_path = str(ecfg.flight_autodump or "")
        self._autodumped = False
        self.last_dump_path: Optional[str] = None
        self.now = 0.0
        self.config_hash = config_hash(engine.cfg, ecfg)
        self.watchdogs: Optional[HealthWatchdogs] = \
            HealthWatchdogs(engine, self) if ecfg.watchdogs else None
        _LIVE.add(self)

    # -- record ring ---------------------------------------------------------
    @property
    def records_dropped(self) -> int:
        return self.records_total - len(self.records)

    def _rec(self, t: float, kind: str, who: str, detail: str = "",
             **extra):
        d = {"t": float(t), "kind": str(kind), "who": str(who),
             "detail": str(detail)}
        if extra:
            d.update(extra)
        self.records.append(d)
        self.records_total += 1
        if t > self.now:
            self.now = float(t)

    # -- capture hooks -------------------------------------------------------
    def on_submit(self, q, now: float):
        """Gateway.enqueue: the replay workload, prompt tokens included.
        Recovery requeues never pass through enqueue, so the ring holds
        exactly the external arrivals."""
        self.sub_total += 1
        self.submissions.append({
            "rid": q.rid, "t": float(now),
            "prompt": [int(x) for x in np.asarray(q.prompt).ravel()],
            "max_new": int(q.max_new),
            "slo_class": q.slo_class,
            "deadline": None if q.deadline is None else float(q.deadline),
            "completion_deadline": None if q.completion_deadline is None
            else float(q.completion_deadline),
            "session": q.session,
            "sampling": None if q.sampling is None
            else dataclasses.asdict(q.sampling)})
        self._rec(now, "submit", q.rid,
                  f"{len(q.prompt)} prompt tokens, max_new={q.max_new}, "
                  f"{q.slo_class}")

    def on_release(self, r):
        """engine.release_request: pin the final token stream (a host list
        after the token drain), the oracle the replay checks against."""
        self.out_total += 1
        self.outputs.append({
            "rid": r.rid, "state": r.state,
            "tokens": [int(t) for t in r.tokens],
            "t_done": float(r.t_done), "preemptions": int(r.preemptions)})

    def on_chunk(self, rid: str, t: float, take: int, shape: int,
                 cursor: int):
        self._rec(t, "chunk_commit", rid,
                  f"take={take} shape={shape} cursor={cursor}")

    def on_restore(self, rid: str, t: float, segments: int,
                   resumed_prefill: bool):
        self._rec(t, "restore", rid,
                  f"{segments} segments, "
                  f"{'mid-prefill resume' if resumed_prefill else 'decode'}")

    def note_loop(self, *, duration: float, step_time, prefill_token_time,
                  max_steps: int):
        self.loops.append({
            "duration": float(duration),
            "step_time": None if step_time is None else float(step_time),
            "prefill_token_time": None if prefill_token_time is None
            else float(prefill_token_time),
            "max_steps": int(max_steps)})
        self._rec(0.0, "serving_loop", "loop",
                  f"duration={duration} step_time={step_time}")

    def note_injection(self, kind: str, plan):
        """Scripted fault and scale injections, recorded where run_serving
        injects them (the controller's own scale requests are not: a
        replayed controller decides them again)."""
        entry = {"t": float(plan.t), "kind": plan.kind,
                 "worker_id": int(getattr(plan, "worker_id", -1))}
        self.injections["failures" if kind == "failure"
                        else "scales"].append(entry)

    def note_orchestrator(self, orch):
        self.orch = {
            "worker_init_time": float(orch.T_w),
            "weight_push_time": float(orch.T_push),
            "ew_policy": orch.ew_policy,
            "auto_rebalance": bool(orch.auto_rebalance),
            "rebalance_cooldown": float(orch.rebalance_cooldown),
            "profile_detect": float(orch.profile.detect),
            "profile_detect_retries": int(orch.profile.detect_retries)}

    # -- per-tick work -------------------------------------------------------
    def _drain(self, now: float):
        """Pull the bus forward through this recorder's own cursor: worker
        events, controller decisions, placement generations, preemptions
        and health events all ride the same stream."""
        for ev in self.engine.bus.drain(self.CONSUMER):
            self._rec(ev.t, ev.kind, ev.worker, ev.detail)
            if ev.kind in _DISTURB_KINDS and self.watchdogs is not None:
                self.watchdogs.note_disturbance(ev.t)
            if ev.kind == "detected":
                self._maybe_autodump(
                    now, f"failure detected: {ev.worker} at t={ev.t:g}")
        if now > self.now:
            self.now = float(now)

    def tick(self, now: float):
        """Once per scheduler step: drain the bus, fingerprint when due,
        advance the watchdogs. O(new events), no device work."""
        self._drain(now)
        if self.fingerprint_every > 0 and now >= self._next_fp:
            self.fingerprint(now)
            self._next_fp = now + self.fingerprint_every
        if self.watchdogs is not None:
            self.watchdogs.tick(now)

    def fingerprint(self, now: float):
        """Engine-state fingerprint, enough to cross-check a replay's
        trajectory: config hash, plan generation, per-AW slot and page
        occupancy, page-pool watermarks, checkpoint-store cursors."""
        eng = self.engine
        per_aw = []
        for w in eng.aws:
            used, total = w.slot_occupancy()
            d = {"aw": w.aw_id, "alive": bool(w.alive),
                 "slots_used": int(used), "slots_total": int(total)}
            ps = w.kv_page_stats()
            if ps is not None:
                d["pages_used"], d["pages_total"] = int(ps[0]), int(ps[1])
            per_aw.append(d)
        store = eng.store
        rids = sorted(store._logs)
        cursors = {rid: int(store.committed_token(rid))
                   for rid in rids[:64]}
        fp = {"gen": int(eng.placement_generation),
              "config_hash": self.config_hash,
              "workers": per_aw,
              "ew_live": sorted(eng.live_ews),
              "queue_depth": int(eng.gateway.depth()),
              "active": len(eng.active_requests()),
              "prefilling": len(eng.prefilling_requests()),
              "store": {"logs": len(rids), "cursors": cursors}}
        if eng.pages is not None:
            fp["free_pages"] = [eng.pages.free_pages(a)
                                for a in range(eng.pages.num_aw)]
            fp["pages"] = eng.pages.stats()
        self.fingerprints += 1
        self._rec(now, "fingerprint", "engine", "", **fp)

    # -- dump ----------------------------------------------------------------
    def _maybe_autodump(self, now: float, reason: str):
        if not self.autodump_path or self._autodumped:
            return
        self._autodumped = True
        self.dump(self.autodump_path, reason=reason, now=now)

    def dump(self, path: Optional[str] = None, reason: str = "manual",
             now: Optional[float] = None) -> dict:
        """Export the postmortem bundle (schema ``SCHEMA``). The rings
        keep recording afterwards."""
        eng = self.engine
        t = self.now if now is None else max(float(now), self.now)
        self._drain(t)
        self.fingerprint(t)
        tel = eng.telemetry
        t0 = self.records[0]["t"] if self.records else 0.0
        open_spans = []
        if tel is not None:
            for rid, sp in tel._root.items():
                open_spans.append({"rid": rid, "kind": "root",
                                   "since": sp.t0})
            for rid, sp in tel._phase.items():
                open_spans.append({"rid": rid, "kind": "phase",
                                   "name": sp.name, "since": sp.t0})
        stalls = [] if tel is None else \
            [s.to_dict() for s in tel._stalls if s.t1 >= t0]
        outputs: Dict[str, List[int]] = {}
        for o in self.outputs:
            if o["state"] == "done":
                outputs[o["rid"]] = o["tokens"]
        bundle = {
            "schema": SCHEMA,
            "reason": reason,
            "clock": t,
            "config": {
                "hash": self.config_hash,
                "model": dataclasses.asdict(eng.cfg),
                "engine": dataclasses.asdict(eng.ecfg),
                "weights": eng.weights_source},
            "loops": list(self.loops),
            "orchestrator": self.orch,
            "injections": {k: list(v) for k, v in self.injections.items()},
            "controller": None if eng.controller is None else {
                "decisions": [dict(d) for d in eng.controller.decisions],
                "counts": dict(eng.controller.counts)},
            "truncated": {"records": self.records_dropped,
                          "submissions": self.sub_total
                          - len(self.submissions),
                          "outputs": self.out_total - len(self.outputs)},
            "records": list(self.records),
            "submissions": list(self.submissions),
            "outputs": outputs,
            "request_states": {
                rid: {"state": r.state, "aw": r.aw, "slot": r.slot,
                      "tokens_emitted": len(r.tokens), "pos": r.pos,
                      "prefill_cursor": r.prefill_cursor,
                      "preemptions": r.preemptions}
                for rid, r in sorted(eng.requests.items())},
            "workers": {
                "aw": [{"aw": w.aw_id, "alive": bool(w.alive),
                        "slots": list(w.slot_occupancy())}
                       for w in eng.aws],
                "ew": [{"ew": w.ew_id, "member": bool(w.member),
                        "alive": bool(w.alive)} for w in eng.ews]},
            "open_spans": open_spans,
            "stalls": stalls,
            "health": None if self.watchdogs is None
            else self.watchdogs.summary(),
        }
        bundle = _jsonable(bundle)
        if path:
            d = os.path.dirname(path)
            if d:
                os.makedirs(d, exist_ok=True)
            with open(path, "w") as f:
                json.dump(bundle, f)
            self.last_dump_path = path
        return bundle


# ---------------------------------------------------------------------------
# health watchdogs
# ---------------------------------------------------------------------------


def _window_quantile(h, counts: np.ndarray, q: float) -> float:
    """Quantile over a delta of a StreamingHistogram's counts (one
    interval window's observations) on the histogram's bucket geometry."""
    total = int(counts.sum())
    if total == 0:
        return 0.0
    target = q * total
    cum = 0
    for i in range(h.n):
        c = int(counts[i])
        if c == 0:
            continue
        if cum + c >= target:
            blo, bhi = h.bucket_bounds(i)
            if not math.isfinite(bhi):
                return float(h.vmax)
            return blo + (target - cum) / c * (bhi - blo)
        cum += c
    return float(h.vmax)


class HealthWatchdogs:
    """Degradation detectors over a sliding window of ``wd_interval``
    intervals. Every judgment is suppressed around disturbances
    (failures, scale events, preemptions), which move every watermark for
    legitimate reasons: the watchdogs hunt unexplained trends."""

    def __init__(self, engine, recorder: FlightRecorder):
        ecfg = engine.ecfg
        self.engine = engine
        self.recorder = recorder
        self.interval = float(ecfg.wd_interval)
        self.window = max(int(ecfg.wd_window), 2)
        self.min_drop = int(ecfg.wd_leak_min_drop)
        self.stall_factor = float(ecfg.wd_stall_factor)
        self.stall_floor = float(ecfg.stall_threshold)
        self.settle = float(ecfg.wd_settle)
        self.trips: List[dict] = []
        self.trip_counts: Dict[str, int] = {}
        self.intervals = 0
        self._t_edge: Optional[float] = None
        self._last_disturb = -math.inf
        # per-interval free-list watermarks (the most free seen in the
        # interval: a leak lowers the upper envelope, transient occupancy
        # only the instantaneous value)
        self._marks: Dict[str, deque] = {
            "pages": deque(maxlen=self.window),
            "slots": deque(maxlen=self.window)}
        self._active_marks: deque = deque(maxlen=self.window)
        self._cur: Dict[str, int] = {}
        # stall regression: histogram counts at the last interval edge
        self._hist_prev: Dict[str, np.ndarray] = {}
        self.baseline_p99: Dict[str, float] = {}
        self._invariant_seen: set = set()

    # -- signals -------------------------------------------------------------
    def note_disturbance(self, t: float):
        if t > self._last_disturb:
            self._last_disturb = float(t)

    def _disturbed(self, now: float, span: float) -> bool:
        return now - self._last_disturb < span + self.settle

    def _free_counts(self) -> Dict[str, int]:
        eng = self.engine
        out = {"slots": sum(w.slots.free_count() for w in eng.aws
                            if w.alive)}
        if eng.pages is not None:
            out["pages"] = sum(eng.pages.free_pages(a)
                               for a in range(eng.pages.num_aw))
        return out

    def tick(self, now: float):
        if self._t_edge is None:
            self._t_edge = float(now)
        for res, v in self._free_counts().items():
            if v > self._cur.get(res, -1):
                self._cur[res] = v
        if now - self._t_edge >= self.interval:
            self._close_interval(now)
            self._t_edge = float(now)

    # -- interval close: push marks, run every detector ----------------------
    def _close_interval(self, now: float):
        self.intervals += 1
        eng = self.engine
        for res, mk in self._marks.items():
            if res in self._cur:
                mk.append(self._cur[res])
        self._active_marks.append(
            len(eng.requests) + eng.gateway.depth())
        self._cur = {}
        self._probe_invariants(now)
        span = self.window * self.interval
        if not self._disturbed(now, span):
            self._check_leaks(now)
            self._check_stall_regression(now)
        else:
            # a disturbed window still advances the histogram cursors, so
            # the next quiet window's delta is one window wide
            self._advance_hist_cursors()

    def _probe_invariants(self, now: float):
        eng = self.engine
        if eng.pages is not None and "pages" not in self._invariant_seen:
            try:
                eng.pages.check()
            except AssertionError as e:
                self._invariant_seen.add("pages")
                self._trip(now, "invariant", "pages",
                           f"PagePool.check failed: {e}")
        tel = eng.telemetry
        if tel is not None:
            gw = eng.gateway
            for rid in list(tel._root):
                if rid in self._invariant_seen or rid in eng.requests:
                    continue
                if any(e.rid == rid for q in gw.queues.values()
                       for e in q):
                    continue
                self._invariant_seen.add(rid)
                self._trip(now, "invariant", "spans",
                           f"root span for {rid!r} open but the request "
                           f"is neither resident nor queued")

    def _check_leaks(self, now: float):
        for res, mk in self._marks.items():
            if len(mk) < self.window:
                continue
            vals = list(mk)
            drop = vals[0] - vals[-1]
            monotone = all(b <= a for a, b in zip(vals, vals[1:]))
            if not monotone or drop < self.min_drop:
                continue
            if self._active_marks[-1] > self._active_marks[0]:
                continue   # load ramp, not a leak
            self._trip(now, "leak", res,
                       f"free-{res} watermark {vals[0]} -> {vals[-1]} "
                       f"over {len(vals)} intervals with no load growth",
                       watermarks=vals)
            mk.clear()     # re-arm instead of re-tripping every interval

    def _hist_sources(self):
        tel = self.engine.telemetry
        if tel is None:
            return
        for name in ("tbt", "ttft"):
            h = tel.registry.hists.get(name)
            if h is not None:
                yield name, h

    def _advance_hist_cursors(self):
        for name, h in self._hist_sources():
            self._hist_prev[name] = h.counts.copy()

    def _check_stall_regression(self, now: float):
        for name, h in self._hist_sources():
            counts = h.counts.copy()
            prev = self._hist_prev.get(name)
            self._hist_prev[name] = counts
            if prev is None:
                continue
            win = counts - prev
            if int(win.sum()) < 8:
                continue   # too few observations to judge
            p99 = _window_quantile(h, win, 0.99)
            base = self.baseline_p99.get(name)
            if base is None:
                # the first quiet window with enough mass is the baseline
                self.baseline_p99[name] = p99
                continue
            if p99 > self.stall_factor * max(base, 1e-9) and \
                    p99 > self.stall_floor:
                self._trip(now, "stall_regression", name,
                           f"windowed {name} p99 {p99:.4f}s vs baseline "
                           f"{base:.4f}s (x{p99 / max(base, 1e-9):.1f}) "
                           f"with no fault in the window",
                           p99=p99, baseline=base)
                # re-arm at the regressed level: a plateau trips once, a
                # further regression trips again
                self.baseline_p99[name] = p99

    def _trip(self, now: float, kind: str, what: str, detail: str,
              **extra):
        trip = {"t": float(now), "kind": kind, "what": what,
                "detail": detail}
        trip.update(_jsonable(extra))
        self.trips.append(trip)
        self.trip_counts[kind] = self.trip_counts.get(kind, 0) + 1
        # health_* rides the request-event path: bus, telemetry counter
        # and audit log
        self.engine._note_request_event(f"health_{kind}", what, now,
                                        detail)
        self.recorder._maybe_autodump(now, f"watchdog {kind}: {what}")

    def summary(self) -> dict:
        return {"trips": len(self.trips),
                "by_kind": dict(self.trip_counts),
                "intervals": self.intervals,
                "watermarks": {res: list(mk)
                               for res, mk in self._marks.items()},
                "baseline_p99": dict(self.baseline_p99),
                "last_trips": [dict(t) for t in self.trips[-5:]]}
