"""Centralized orchestrator (paper Fig. 5), port of
``repro.core.orchestrator``: liveness monitoring, ERT and health updates
on failures, per-request restoration, background worker provisioning
and, on top of the versioned placement plane (core/placement.py), EW pool
elasticity: scale-out and scale-in with the weight-push time ``T_push``
on the virtual clock, permanent shadow promotion as an alternative to
revival, and load-aware rebalancing from the placement manager's
dispatch-load EMAs.

Failure detection model (§5 + App. E): implicit heartbeats are the
per-step data-plane activity; a silent worker gets explicit probes every
``detect`` seconds; after ``detect_retries`` consecutive timeouts the
worker is declared fail-stop and self-healing fires.

EW failure policies:
  * ``revive`` (default, §5.4): shadows absorb the failed EW's traffic at
    detection, a replacement worker is provisioned in the background
    (``T_w``), and the shadow slots are then re-pointed to protect the
    placement manager's pick of the most load-critical EW (the failed
    EW's neighbour when the engine has no manager);
  * ``promote``: the dead EW's shadows become primaries permanently (an
    ERT flip, no weight movement) and the pool shrinks; a re-protection
    plan for the now most critical EW lands after ``T_push``.
"""
from __future__ import annotations

from dataclasses import dataclass
from typing import List, Optional

from repro_torch.core.costmodel import TarragonProfile

@dataclass
class WorkerEvent:
    t: float
    kind: str       # fail_aw|fail_ew|detected|provisioned|reprotected|
    #                 placement_changed|scale_out_started|scaled_out|
    #                 drain_started|scaled_in|rebalance_started|rebalanced|
    #                 scale_failed|session_repinned|preempted|cancelled|
    #                 deadline_missed
    worker: str
    detail: str = ""


@dataclass
class _PendingFailure:
    kind: str
    worker_id: int
    t_fail: float
    detected: bool = False


@dataclass
class _PendingProvision:
    kind: str       # "aw" | "ew" | "reprotect"
    worker_id: int
    t_ready: float


@dataclass
class _PendingScale:
    kind: str       # "add_ew" | "drain_ew" | "rebalance"
    worker_id: int  # -1 for add_ew and rebalance
    t_ready: float


class Orchestrator:
    def __init__(self, engine, profile: Optional[TarragonProfile] = None,
                 worker_init_time: float = 18.5,
                 weight_push_time: float = 1.0,
                 ew_policy: str = "revive",
                 auto_rebalance: bool = False,
                 rebalance_cooldown: float = 2.0):
        if ew_policy not in ("revive", "promote"):
            raise ValueError(f"unknown ew_policy {ew_policy!r} "
                             f"(revive | promote)")
        self.engine = engine
        self.profile = profile or TarragonProfile()
        self.T_w = worker_init_time
        self.T_push = weight_push_time
        self.ew_policy = ew_policy
        self.auto_rebalance = auto_rebalance
        self.rebalance_cooldown = rebalance_cooldown
        self._last_rebalance = -1e30
        self.events: List[WorkerEvent] = []
        self._failures: List[_PendingFailure] = []
        self._provisions: List[_PendingProvision] = []
        self._scales: List[_PendingScale] = []
        # control-plane events also go to the engine's event bus at
        # emission (serving/telemetry.py)
        self.bus = engine.bus
        # the control plane decides and this orchestrator actuates, so its
        # scale and rebalance requests land on the same virtual clock as
        # scripted ones (serving/controller.py)
        if engine.controller is not None:
            engine.controller.attach_orchestrator(self)
        # the forensics plane pins the timing and policy parameters, so a
        # bundle can rebuild an identically clocked orchestrator
        if engine.flightrec is not None:
            engine.flightrec.note_orchestrator(self)

    def _emit(self, ev: WorkerEvent):
        self.events.append(ev)
        self.bus.publish(ev)
        return ev

    # -- failure injection (the SIGINT of §7.2) -----------------------------
    def inject_failure(self, kind: str, worker_id: int, now: float):
        if kind not in ("aw", "ew"):
            raise ValueError(f"unknown worker kind {kind!r} (aw | ew)")
        self._failures.append(_PendingFailure(kind, worker_id, now))
        self._emit(WorkerEvent(now, f"fail_{kind}", f"{kind}{worker_id}"))

    def detection_latency(self) -> float:
        return self.profile.detect * self.profile.detect_retries

    # -- elasticity requests (complete after T_w / T_push on the clock) ----
    def request_scale_out(self, now: float):
        """Grow the EW pool by one: worker init (T_w) and the expert
        weight push (T_push) run in the background, and the new plan is
        installed between steps once both are done. A bad request fails
        here, not in the control loop T_w later."""
        mgr = self.engine.placement_mgr
        if mgr is None:
            raise ValueError("scale_out requires an elastic expert plane "
                             "(MoE + tarragon)")
        if not mgr.can_scale_out():
            raise ValueError(f"EW pool already at max_ew={mgr.max_ew}; "
                             "raise EngineConfig.max_ew to add spares")
        self._scales.append(_PendingScale("add_ew", -1,
                                          now + self.T_w + self.T_push))
        self._emit(WorkerEvent(
            now, "scale_out_started", "ew?",
            f"join in T_w+T_push={self.T_w + self.T_push:.2f}s"))

    def request_scale_in(self, ew: int, now: float):
        """Drain an EW: its experts migrate to the survivors (weight push
        T_push, during which it keeps serving the old plan), then it
        retires to spare."""
        mgr = self.engine.placement_mgr
        if mgr is None or ew not in mgr.members:
            raise ValueError(f"EW{ew} is not an elastic pool member")
        if len(mgr.members) <= 1:
            raise ValueError("cannot drain the last EW")
        self._scales.append(_PendingScale("drain_ew", ew, now + self.T_push))
        self._emit(WorkerEvent(
            now, "drain_started", f"ew{ew}",
            f"migrating experts, T_push={self.T_push:.2f}s"))

    def request_rebalance(self, now: float):
        if self.engine.placement_mgr is None:
            raise ValueError("rebalance requires an elastic expert plane "
                             "(MoE + tarragon)")
        self._scales.append(_PendingScale("rebalance", -1,
                                          now + self.T_push))
        self._emit(WorkerEvent(now, "rebalance_started", "pool",
                               f"T_push={self.T_push:.2f}s"))

    def _maybe_auto_rebalance(self, now: float):
        mgr = getattr(self.engine, "placement_mgr", None)
        if mgr is None or not self.auto_rebalance:
            return
        if now - self._last_rebalance < self.rebalance_cooldown:
            return
        if any(s.kind == "rebalance" for s in self._scales):
            return
        if self.engine.failed_ews:
            # wait for revival or promotion to settle, then judge the
            # real imbalance
            return
        if mgr.should_rebalance():
            self._last_rebalance = now
            self.request_rebalance(now)

    # -- control loop --------------------------------------------------------
    def tick(self, now: float) -> List[WorkerEvent]:
        """Advance the control plane to virtual time ``now``. Returns the
        events that fired during this tick."""
        fired: List[WorkerEvent] = []
        for f in self._failures:
            if f.detected or now < f.t_fail + self.detection_latency():
                continue
            f.detected = True
            ev = WorkerEvent(now, "detected", f"{f.kind}{f.worker_id}")
            tel = self.engine.telemetry
            if tel is not None:
                # the detection window [t_fail, now] is the detection part
                # of every stall this failure causes
                tel.on_failure_detected(f.kind, f.worker_id, f.t_fail, now)
            if f.kind == "ew":
                # AW-side self-healing: ERT remap to shadows (instant once
                # detected)
                self.engine.fail_ew(f.worker_id)
                if self.ew_policy == "promote" and \
                        self.engine.placement_mgr is not None:
                    # the pool shrinks, the shadows are primaries now; new
                    # replicas for the most critical survivor land after
                    # the background weight push
                    self.engine.promote_shadows(f.worker_id, now=now)
                    ev.detail = "shadows promoted to primaries (pool -1)"
                    self._provisions.append(_PendingProvision(
                        "reprotect", f.worker_id, now + self.T_push))
                else:
                    ev.detail = "ERT remap -> shadow experts"
                    self._provisions.append(_PendingProvision(
                        f.kind, f.worker_id, now + self.T_w))
            else:
                # EW-side self-healing: the health mask drops the AW's
                # slots; per-request restoration re-admits its requests
                # through the Gateway (unplaceable ones stay queued and
                # retry)
                self.engine.fail_aw(f.worker_id)
                n = len(self.engine.recover_aw_requests(now=now))
                ev.detail = f"restored {n} requests"
                waiting = self.engine.gateway.depth()
                if waiting:
                    ev.detail += f" ({waiting} queued for retry)"
                self._provisions.append(
                    _PendingProvision(f.kind, f.worker_id, now + self.T_w))
            self._emit(ev)
            fired.append(ev)

        remaining = []
        for p in self._provisions:
            if now < p.t_ready:
                remaining.append(p)
                continue
            if p.kind == "ew":
                # layer-aligned join (§5.4) and shadow re-pointing to
                # protect the most load-critical EW; still-failed EWs are
                # never the protect target
                dead = self.engine.failed_ews - {p.worker_id}
                protect = self.engine.choose_protect_ew(exclude=dead)
                if protect is None:
                    protect = (p.worker_id + 1) % max(
                        1, len(self.engine.ews))
                self.engine.provision_ew(p.worker_id,
                                         repoint_protect=protect, now=now)
                ev = WorkerEvent(now, "provisioned", f"ew{p.worker_id}",
                                 f"shadows protect ew{protect}")
            elif p.kind == "reprotect":
                protect = self.engine.choose_protect_ew(
                    exclude=self.engine.failed_ews)
                if protect is not None:
                    self.engine.repoint_shadows(protect, now=now)
                ev = WorkerEvent(now, "reprotected", f"ew{p.worker_id}",
                                 f"new replicas protect ew{protect}")
            else:
                self.engine.provision_aw(p.worker_id)
                # freshly provisioned capacity drains the waiting queue
                # (recovery entries sit at the front)
                self.engine.scheduler.admit(now)
                ev = WorkerEvent(now, "provisioned", f"aw{p.worker_id}")
            self._emit(ev)
            fired.append(ev)
        self._provisions = remaining

        remaining_s = []
        for s in self._scales:
            if now < s.t_ready:
                remaining_s.append(s)
                continue
            try:
                if s.kind == "add_ew":
                    new_ew = self.engine.add_ew(now=now)
                    # the joiner starts empty: a scale-out resets the
                    # rebalance cooldown so the next pass may ship it load
                    self._last_rebalance = -1e30
                    ev = WorkerEvent(now, "scaled_out", f"ew{new_ew}",
                                     f"pool={sorted(self.engine.live_ews)}")
                elif s.kind == "drain_ew":
                    self.engine.drain_ew(s.worker_id, now=now)
                    ev = WorkerEvent(now, "scaled_in", f"ew{s.worker_id}",
                                     f"pool={sorted(self.engine.live_ews)}")
                else:
                    plan = self.engine.rebalance(now=now)
                    detail = f"gen{plan.generation}" if plan is not None \
                        else ""
                    ev = WorkerEvent(now, "rebalanced", "pool", detail)
            except ValueError as e:
                # the pool changed between request and completion (e.g. the
                # drain target died and was promoted away): an event, not
                # the end of the control loop
                ev = WorkerEvent(now, "scale_failed", s.kind, str(e))
            self._emit(ev)
            fired.append(ev)
        self._scales = remaining_s

        self._maybe_auto_rebalance(now)

        # events of planes the engine may carry: placement generations and
        # the request plane's (preempted, cancelled, deadline_missed,
        # session_repinned) ride the same audit log
        for ev in self.engine.drain_plan_events() \
                if hasattr(self.engine, "drain_plan_events") else []:
            self.events.append(ev)
            fired.append(ev)
        for ev in self.engine.drain_request_events() \
                if hasattr(self.engine, "drain_request_events") else []:
            self.events.append(ev)
            fired.append(ev)
        return fired

    @property
    def outstanding(self) -> int:
        return len(self._provisions) + len(self._scales) + \
            sum(1 for f in self._failures if not f.detected)
