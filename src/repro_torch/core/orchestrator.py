"""Centralized orchestrator (paper Fig. 5), port of
``repro.core.orchestrator``: liveness monitoring, ERT and health updates
on failures, per-request restoration, and background worker provisioning,
all on the serving loop's virtual clock.

Failure detection model (§5 + App. E): implicit heartbeats are the
per-step data-plane activity; a silent worker gets explicit probes every
``detect`` seconds; after ``detect_retries`` consecutive timeouts the
worker is declared fail-stop and self-healing fires.

EW failure policy ``revive`` (§5.4): shadows absorb the failed EW's
traffic at detection, a replacement worker is provisioned in the
background (``T_w``), and the shadow slots are then re-pointed to protect
the next EW to guard: the placement manager's pick once that plane is
ported, the failed EW's neighbour until then.

Not ported yet, because each needs the versioned placement plane
(``core/placement.py``): EW pool elasticity (``request_scale_out``,
``request_scale_in``, ``request_rebalance``, each of which raises and
names that plane), and the reference's constructor options that only
those paths read, which come with it: the weight-push time
(``weight_push_time``), permanent shadow promotion (``ew_policy``) and
load-aware rebalancing (``auto_rebalance``, ``rebalance_cooldown``).
"""
from __future__ import annotations

from dataclasses import dataclass
from typing import List, Optional

from repro_torch.core.costmodel import TarragonProfile

_NEEDS_PLACEMENT = ("needs the versioned placement plane "
                    "(core/placement.py), which the port does not have yet")


@dataclass
class WorkerEvent:
    t: float
    kind: str       # fail_aw|fail_ew|detected|provisioned|session_repinned
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
    kind: str       # "aw" | "ew"
    worker_id: int
    t_ready: float


class Orchestrator:
    def __init__(self, engine, profile: Optional[TarragonProfile] = None,
                 worker_init_time: float = 18.5):
        self.engine = engine
        self.profile = profile or TarragonProfile()
        self.T_w = worker_init_time
        self.events: List[WorkerEvent] = []
        self._failures: List[_PendingFailure] = []
        self._provisions: List[_PendingProvision] = []

    def _emit(self, ev: WorkerEvent):
        self.events.append(ev)
        return ev

    # -- failure injection (the SIGINT of §7.2) -----------------------------
    def inject_failure(self, kind: str, worker_id: int, now: float):
        if kind not in ("aw", "ew"):
            raise ValueError(f"unknown worker kind {kind!r} (aw | ew)")
        self._failures.append(_PendingFailure(kind, worker_id, now))
        self._emit(WorkerEvent(now, f"fail_{kind}", f"{kind}{worker_id}"))

    def detection_latency(self) -> float:
        return self.profile.detect * self.profile.detect_retries

    # -- elasticity requests -------------------------------------------------
    def request_scale_out(self, now: float):
        raise NotImplementedError(f"EW scale-out {_NEEDS_PLACEMENT}")

    def request_scale_in(self, ew: int, now: float):
        raise NotImplementedError(f"EW scale-in {_NEEDS_PLACEMENT}")

    def request_rebalance(self, now: float):
        raise NotImplementedError(f"expert rebalancing {_NEEDS_PLACEMENT}")

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
            if f.kind == "ew":
                # AW-side self-healing: ERT remap to shadows (instant once
                # detected); a replacement is provisioned after T_w
                self.engine.fail_ew(f.worker_id)
                ev.detail = "ERT remap -> shadow experts"
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
            else:
                self.engine.provision_aw(p.worker_id)
                # freshly provisioned capacity drains the waiting queue
                # (recovery entries sit at the front)
                self.engine.scheduler.admit(now)
                ev = WorkerEvent(now, "provisioned", f"aw{p.worker_id}")
            self._emit(ev)
            fired.append(ev)
        self._provisions = remaining

        # events of planes the engine may carry: placement generations and
        # the request plane's (session_repinned, and the lifecycle events
        # once that plane is ported) ride the same audit log
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
        return len(self._provisions) + \
            sum(1 for f in self._failures if not f.detected)
