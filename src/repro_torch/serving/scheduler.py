"""Serving loop over the layered stack (port of
``repro.serving.scheduler``).

Drives the Gateway (class queues and placement), the
ContinuousBatchScheduler (bucketed prefill and decode) and the
Orchestrator (failure detection and provisioning) with a workload trace
on a virtual clock, collecting the §7.2/§7.3 measurement set: TTFT, TBT,
queueing delay, output tokens/s and prefill-batch occupancy.

Every request timestamp lives on the virtual clock: TTFT is (first token
time - arrival), queueing delay is (admission - arrival). Each step
advances the clock by ``step_time`` when given, else by the step's
measured wall time (on the card: its host time through the step's
device-to-host token copy), plus ``prefill_token_time`` per prompt token
prefilled in the step.

``scale_events`` (``ScalePlan``) ask the orchestrator to grow, shrink or
re-pack the EW pool at their virtual times; the orchestrator completes
them T_w or T_push later on the same clock. With the engine's telemetry
plane on (the default), the loop feeds it each step's span, every
token's stamp and each TTFT, and finalizes it at the end
(``ServeMetrics.telemetry``); the gateway's ``prefix`` block counts the
prefix cache's hits, adopted tokens, evictions, restores, global-index
hits, migrations and session re-pins. With the flight recorder on (the
default), the loop pins its clock parameters (``note_loop``) and every
scripted failure and scale event (``note_injection``), so a postmortem
bundle can re-run it (``launch/replay.py``); with the control plane on,
``ServeMetrics.controller`` carries its decision history and counters.
"""
from __future__ import annotations

import time
from dataclasses import dataclass, field
from typing import Dict, List, Optional

import numpy as np

from repro_torch.core.orchestrator import Orchestrator
from repro_torch.data.workloads import Request


@dataclass
class TokenRecord:
    t: float
    rid: str


@dataclass
class ServeMetrics:
    token_log: List[TokenRecord] = field(default_factory=list)
    ttft: Dict[str, float] = field(default_factory=dict)
    queue_delay: Dict[str, float] = field(default_factory=dict)
    outputs: Dict[str, List[int]] = field(default_factory=dict)
    finished: List[str] = field(default_factory=list)
    duration: float = 0.0
    prefill: dict = field(default_factory=dict)  # scheduler PrefillStats
    slo_class: Dict[str, str] = field(default_factory=dict)  # rid -> class
    gateway: dict = field(default_factory=dict)  # GatewayStats snapshot
    telemetry: object = None   # the engine's TelemetryPlane (None = off):
    #                            streamed twins of the lists above, spans
    #                            and per-cause stall attribution
    controller: dict = field(default_factory=dict)  # control-plane audit
    #                            (decision history and counters; {} = off)

    def throughput(self) -> float:
        return len(self.token_log) / self.duration if self.duration else 0.0

    def tbt_values(self, slo_class: str = None) -> np.ndarray:
        by_req: Dict[str, List[float]] = {}
        for rec in self.token_log:
            if slo_class is not None and \
                    self.slo_class.get(rec.rid) != slo_class:
                continue
            by_req.setdefault(rec.rid, []).append(rec.t)
        gaps = []
        for ts in by_req.values():
            ts = sorted(ts)
            gaps.extend(np.diff(ts))
        return np.asarray(gaps) if gaps else np.zeros((0,))

    def ttft_values(self, slo_class: str = None) -> np.ndarray:
        vals = [v for rid, v in self.ttft.items()
                if slo_class is None or
                self.slo_class.get(rid) == slo_class]
        return np.asarray(vals) if vals else np.zeros((0,))

    def max_stall(self, slo_class: str = None) -> float:
        v = self.tbt_values(slo_class)
        return float(v.max()) if v.size else 0.0

    def queue_delay_values(self) -> np.ndarray:
        return np.asarray(list(self.queue_delay.values())) \
            if self.queue_delay else np.zeros((0,))

    def throughput_timeline(self, dt: float = 0.5):
        if not self.token_log:
            return np.zeros((0,)), np.zeros((0,))
        ts = np.asarray([r.t for r in self.token_log])
        edges = np.arange(0.0, self.duration + dt, dt)
        hist, _ = np.histogram(ts, bins=edges)
        return edges[:-1], hist / dt


@dataclass
class FailurePlan:
    t: float
    kind: str      # "aw" | "ew"
    worker_id: int


@dataclass
class ScalePlan:
    """Elasticity event on the serving timeline: at virtual time ``t`` ask
    the orchestrator to grow, shrink or re-pack the EW pool (completion
    lands T_w or T_push later on the same clock)."""
    t: float
    kind: str           # "add_ew" | "drain_ew" | "rebalance"
    worker_id: int = -1  # only for drain_ew


def run_serving(engine, workload: List[Request], duration: float, *,
                orchestrator: Optional[Orchestrator] = None,
                failures: List[FailurePlan] = (),
                scale_events: List[ScalePlan] = (),
                step_time: Optional[float] = None,
                prefill_token_time: Optional[float] = None,
                max_steps: int = 100000) -> ServeMetrics:
    """``prefill_token_time`` charges prefill work to the virtual clock
    (seconds per real prompt token prefilled in the tick, on top of the
    step time), so a long whole-prompt prefill shows up as the TBT stall
    it is for co-resident decodes."""
    m = ServeMetrics()
    gw = engine.gateway
    tel = engine.telemetry
    m.telemetry = tel
    fr = engine.flightrec
    if fr is not None:
        # a bundle replays the incident only if it can re-run this loop
        fr.note_loop(duration=duration, step_time=step_time,
                     prefill_token_time=prefill_token_time,
                     max_steps=max_steps)
    clock = 0.0
    pending = sorted(workload, key=lambda r: r.arrival)
    qi = 0
    injected = [False] * len(failures)
    scaled = [False] * len(scale_events)
    steps = 0
    seen_first = set()
    while clock < duration and steps < max_steps:
        # failure injection
        for i, f in enumerate(failures):
            if not injected[i] and clock >= f.t:
                if orchestrator is None:
                    raise ValueError("failures need an orchestrator")
                orchestrator.inject_failure(f.kind, f.worker_id, clock)
                if fr is not None:
                    fr.note_injection("failure", f)
                injected[i] = True
        # elasticity requests (the orchestrator clocks their completion)
        for i, s in enumerate(scale_events):
            if not scaled[i] and clock >= s.t:
                if orchestrator is None:
                    raise ValueError("scale events need an orchestrator")
                if s.kind == "add_ew":
                    orchestrator.request_scale_out(clock)
                elif s.kind == "drain_ew":
                    orchestrator.request_scale_in(s.worker_id, clock)
                elif s.kind == "rebalance":
                    orchestrator.request_rebalance(clock)
                else:
                    raise ValueError(f"unknown scale event kind {s.kind!r}"
                                     " (add_ew | drain_ew | rebalance)")
                if fr is not None:
                    fr.note_injection("scale", s)
                scaled[i] = True
        if orchestrator is not None:
            orchestrator.tick(clock)
        # arrivals enter their SLO class's Gateway queue (never dropped);
        # admission and bucketed prefill happen in the step's scheduler pass
        while qi < len(pending) and pending[qi].arrival <= clock:
            r = pending[qi]
            # stamped with the true arrival: queueing delay and TTFT are
            # measured from arrival, not from the tick that noticed it
            gw.enqueue(r.request_id, r.prompt_tokens(engine.cfg.vocab_size),
                       r.max_new_tokens, now=r.arrival,
                       slo_class=getattr(r, "slo_class", "standard"),
                       deadline=r.deadline if getattr(r, "deadline", -1.0)
                       >= 0 else None,
                       session=getattr(r, "session", "") or None)
            m.slo_class[r.request_id] = getattr(r, "slo_class", "standard")
            qi += 1
        pf0 = engine.prefill_tokens_done()
        t0 = time.monotonic()
        out = engine.step(now=clock)
        dt = step_time if step_time is not None else time.monotonic() - t0
        if prefill_token_time is not None:
            dt += (engine.prefill_tokens_done() - pf0) * prefill_token_time
        if not out:
            # idle tick: quit once nothing can make progress again, a
            # failure or scale event still to inject and queued (fresh or
            # preempted) requests included
            if qi >= len(pending) and not engine.active_requests() and \
                    not engine.prefilling_requests() and \
                    gw.depth() == 0 and all(injected) and all(scaled) and \
                    (orchestrator is None or orchestrator.outstanding == 0):
                break
            dt = max(dt, 1e-3)
        clock += dt
        if tel is not None:
            pf_done = engine.prefill_tokens_done() - pf0
            tel.on_step(clock - dt, clock, pf_done,
                        pf_done * (prefill_token_time or 0.0),
                        sum(len(t) for t in out.values()))
        for rid, toks in out.items():
            for _ in toks:
                m.token_log.append(TokenRecord(clock, rid))
            if tel is not None and toks:
                # the streamed twin of token_log: the same stamps and gaps
                tel.observe_tokens(rid, clock, len(toks),
                                   m.slo_class.get(rid, "standard"))
            if rid not in seen_first and toks:
                seen_first.add(rid)
                r = engine.requests.get(rid)
                if r is not None:
                    # padded-prefill requests emit their first token through
                    # the decode step: stamp TTFT at the step's end time
                    # (exact-scheme requests got theirs at admission)
                    if len(r.tokens) == len(toks):
                        r.t_first_token = clock
                    m.ttft[rid] = r.ttft
                    if tel is not None:
                        tel.observe_ttft(rid, r.ttft,
                                         m.slo_class.get(rid, "standard"),
                                         r.t_enqueue)
        for r in list(engine.requests.values()):
            if r.done and r.rid not in m.finished:
                m.finished.append(r.rid)
                m.ttft[r.rid] = r.ttft
                if tel is not None:
                    tel.observe_ttft(r.rid, r.ttft,
                                     m.slo_class.get(r.rid, "standard"),
                                     r.t_enqueue)
                m.outputs[r.rid] = list(r.tokens)
                engine.release_request(r.rid)
        steps += 1
    m.duration = clock
    if tel is not None:
        tel.finalize(clock)
    m.queue_delay = dict(gw.stats.queue_delay)
    m.prefill = engine.prefill_snapshot()
    m.gateway = {"preemptions": gw.stats.preemptions,
                 "blocked_ticks": gw.stats.blocked_ticks,
                 "host_syncs": gw.stats.host_syncs,
                 "requeued": gw.stats.requeued,
                 "by_class": {c: dict(v)
                              for c, v in gw.stats.by_class.items()},
                 "prefix": {"hits": gw.stats.prefix_hits,
                            "misses": gw.stats.prefix_misses,
                            "hit_tokens": gw.stats.prefix_hit_tokens,
                            "evictions": gw.stats.prefix_evictions,
                            "restored": gw.stats.prefix_restored,
                            "global_hits": gw.stats.prefix_global_hits,
                            "migrated": gw.stats.prefix_migrated,
                            "repins": gw.stats.session_repins}}
    if engine.pages is not None:
        m.gateway["pages"] = engine.pages.stats()
    if engine.controller is not None:
        m.controller = engine.controller.snapshot()
    return m
