"""SLO-driven closed-loop control plane (port of
``repro.serving.controller``).

One ``ServingController`` runs one decision pass per engine tick, reading
only signals the stack already keeps on the host and acting only through
mechanisms that already exist:

  signals                      decisions                  actuators
  -------                      ---------                  ---------
  gateway queue depths   --->  EW autoscaling       --->  Orchestrator
  per-EW load EMAs             (debounced watermarks)     request_scale_out/in
  imbalance trajectory   --->  rebalance trigger    --->  Orchestrator
  (EMA slope + predicted       (fires on the predicted    request_rebalance +
   threshold crossing)          crossing, not after it)   weighted split plans
  deadline headroom +    --->  adaptive chunk       --->  ChunkedPrefillPlane
  interactive TBT p99          budget (Sarathi-style      set_budget
                               prefill:decode ratio)
  head deadline risk +   --->  preemption gate +    --->  victim_policy=
  victim KV value              victim pricing             "controller"

Host bookkeeping only: no tensor is read and none is written here. The
signals are the Gateway's queues, the placement manager's load EMAs (fed
from the token drain's host copy), the telemetry registry's streamed
``tbt.interactive`` histogram and ``PagePool.ref`` (numpy). The actions
are the ones an operator could script: a placement plan installs as an
in-place RouteState update of fixed shapes, the chunk budget is a host int
the planner reads each tick (every dense call runs on fixed 128-row
blocks, so a budget changes no stream's bits), and preemption rides the
checkpoint path. So controller on equals its decisions replayed as a
script on a controller-off engine, bit for bit, with no new step-graph
capture (tests/test_torch_controller.py).

Every decision emits a ``WorkerEvent`` (kind ``controller_<decision>``,
detail = the triggering signal values) through
``engine._note_request_event``: it reaches the orchestrator's timeline,
the EventBus, the telemetry counters (``events.controller_*``) and the
Chrome trace.

The dwell between scale decisions defaults to ``T_w + 2*T_push`` of the
attached orchestrator, so one load transient never pays the provisioning
cost twice. Watermarks read a queue-depth EMA, and the scale-out and
scale-in watermarks are apart, so an oscillating queue cannot flap the
pool.
"""
from __future__ import annotations

import math
from typing import List

from repro_torch.serving.api import INTERACTIVE


class ServingController:
    """One decision pass per engine tick over four coordinated policies,
    behind one fitness signal (per-class TTFT/TBT percentiles)."""

    def __init__(self, engine):
        self.engine = engine
        ecfg = engine.ecfg
        self.autoscale_on = ecfg.ctl_autoscale
        self.rebalance_on = ecfg.ctl_rebalance
        self.budget_on = ecfg.ctl_chunk_budget
        self.orch = None               # attached by Orchestrator.__init__
        # -- policy 1: queue-depth EMA and scale debounce
        self._q_ema = 0.0
        self._q_decay = 0.7
        self._last_scale = -1e30
        # -- policy 2: imbalance trajectory, (t, imbalance), newest last
        self._imb_hist: List[tuple] = []
        self._imb_window = 8
        self._last_rebalance = -1e30
        # -- policy 3
        self._budget_base = ecfg.chunk_token_budget
        # -- audit
        self.decisions: List[dict] = []
        self.counts = {"scale_out": 0, "scale_in": 0, "rebalance": 0,
                       "budget": 0, "preempt": 0, "preempt_denied": 0}
        if self.rebalance_on and engine.placement_mgr is not None:
            # weighted split replicas: the packer sizes each split against
            # the measured per-EW deficit instead of hottest-first parity
            engine.placement_mgr.split_mode = "weighted"

    def attach_orchestrator(self, orch):
        """Bind the elasticity actuator (the Orchestrator builds itself
        around an engine, so attachment flows that way too)."""
        self.orch = orch

    # ------------------------------------------------------------------
    # decision audit: one structured event and counter per decision
    # ------------------------------------------------------------------
    def _decide(self, kind: str, now: float, detail: str, **fields):
        self.counts[kind] = self.counts.get(kind, 0) + 1
        # the fields carry the decision's arguments (drain target, new
        # budget), so a recorded history replays as a script
        self.decisions.append({"t": now, "kind": kind, "detail": detail,
                               **fields})
        self.engine._note_request_event(f"controller_{kind}", "controller",
                                        now, detail)

    # ------------------------------------------------------------------
    # the per-tick decision pass (called at the top of scheduler.step)
    # ------------------------------------------------------------------
    def tick(self, now: float):
        eng = self.engine
        if self.autoscale_on and self.orch is not None and \
                eng.placement_mgr is not None:
            self._autoscale(now)
        if self.rebalance_on and self.orch is not None and \
                eng.placement_mgr is not None:
            self._rebalance(now)
        if self.budget_on and eng.chunked is not None:
            self._chunk_budget(now)

    # ------------------------------------------------------------------
    # policy 1: EW autoscaling (queue depth and per-EW load EMAs,
    # T_push-aware debounce, watermark hysteresis)
    # ------------------------------------------------------------------
    def _scale_dwell(self) -> float:
        d = self.engine.ecfg.ctl_scale_dwell
        if d > 0:
            return d
        # the previous decision's worker has joined (T_w), pushed its
        # weights (T_push) and settled (one more T_push) before the signal
        # is trusted again
        return self.orch.T_w + 2.0 * self.orch.T_push

    def _autoscale(self, now: float):
        eng, orch, ecfg = self.engine, self.orch, self.engine.ecfg
        mgr = eng.placement_mgr
        depth = eng.gateway.depth()
        self._q_ema = self._q_decay * self._q_ema + \
            (1.0 - self._q_decay) * depth
        if any(s.kind in ("add_ew", "drain_ew") for s in orch._scales):
            return                      # provisioning in flight
        if now - self._last_scale < self._scale_dwell():
            return                      # debounce window
        if eng.failed_ews:
            return                      # let recovery settle first
        loads = mgr.per_ew_load()
        if self._q_ema >= ecfg.ctl_queue_high and mgr.can_scale_out():
            self._last_scale = now
            orch.request_scale_out(now)
            self._decide(
                "scale_out", now,
                f"q_ema={self._q_ema:.2f}>={ecfg.ctl_queue_high:g} "
                f"depth={depth} "
                f"interactive={eng.gateway.class_depth(INTERACTIVE)} "
                f"pool={sorted(mgr.members)}")
        elif self._q_ema <= ecfg.ctl_queue_low and \
                len(mgr.members) > ecfg.num_ew and \
                not eng.active_requests() and \
                not eng.prefilling_requests():
            # idle pool above its boot size: drain the lightest member
            target = min(mgr.members, key=lambda m: (loads.get(m, 0.0), m))
            if len(mgr.members) > 1:
                self._last_scale = now
                orch.request_scale_in(target, now)
                self._decide(
                    "scale_in", now,
                    f"q_ema={self._q_ema:.2f}<={ecfg.ctl_queue_low:g} "
                    f"idle, drain ew{target} "
                    f"(load_ema={loads.get(target, 0.0):.1f})",
                    ew=target)

    # ------------------------------------------------------------------
    # policy 2: rebalance on the imbalance trajectory (slope and predicted
    # threshold crossing, not a fixed instantaneous threshold)
    # ------------------------------------------------------------------
    def _imb_slope(self) -> float:
        """Least-squares slope of the recent imbalance samples (per
        virtual second); 0 when the window is too short."""
        h = self._imb_hist[-self._imb_window:]
        if len(h) < 4:
            return 0.0
        n = len(h)
        t0 = h[0][0]
        ts = [t - t0 for t, _ in h]
        ys = [y for _, y in h]
        tm = sum(ts) / n
        ym = sum(ys) / n
        den = sum((t - tm) ** 2 for t in ts)
        if den <= 1e-12:
            return 0.0
        return sum((t - tm) * (y - ym) for t, y in zip(ts, ys)) / den

    def _rebalance(self, now: float):
        eng, orch = self.engine, self.orch
        mgr = eng.placement_mgr
        imb = mgr.imbalance()
        if not self._imb_hist or self._imb_hist[-1][0] < now:
            self._imb_hist.append((now, imb))
            del self._imb_hist[:-self._imb_window]
        if any(s.kind == "rebalance" for s in orch._scales):
            return
        if eng.failed_ews:
            return
        if len(mgr.members) <= 1 or \
                mgr._owned_slots() < mgr.geom.num_experts or \
                mgr.load.total_recorded < mgr.min_load_signal:
            return
        # a re-fire needs a genuine re-crossing and the trigger refuses
        # while a plan is in flight, so the dwell only covers plan landing
        # plus one EMA refresh
        dwell = max(2.0 * orch.T_push, 1e-3)
        if now - self._last_rebalance < dwell:
            return
        thr = mgr.rebalance_threshold
        slope = self._imb_slope()
        # the imbalance when a plan requested now would land (T_push later)
        horizon = orch.T_push + dwell
        predicted = imb + slope * horizon
        if imb > thr or (slope > 1e-6 and predicted > thr):
            self._last_rebalance = now
            orch.request_rebalance(now)
            self._decide(
                "rebalance", now,
                f"imb={imb:.3f} slope={slope:+.4f}/s "
                f"pred@+{horizon:.2f}s={predicted:.3f} thr={thr:g}")

    # ------------------------------------------------------------------
    # policy 3: adaptive chunk budget (Sarathi-style prefill:decode ratio
    # from the decode batch's SLO headroom)
    # ------------------------------------------------------------------
    def _interactive_headroom(self, now: float) -> float:
        """Smallest first-token deadline headroom over interactive work
        without a first token yet (queued entries and resident prefilling
        or placed requests); +inf when none carries a deadline."""
        eng = self.engine
        head = math.inf
        qdl = eng.gateway.min_queued_deadline(INTERACTIVE)
        if qdl is not None:
            head = qdl - now
        for r in eng.requests.values():
            if r.slo_class == INTERACTIVE and not r.done and \
                    not r.cancelled and r.deadline is not None and \
                    r.t_first_token < 0:
                head = min(head, r.deadline - now)
        return head

    def _interactive_tbt_thin(self) -> bool:
        """Streamed interactive TBT p99 above the headroom target (the
        telemetry registry's histogram; absent or nearly empty = not
        thin)."""
        tel = self.engine.telemetry
        if tel is None:
            return False
        h = tel.registry.hists.get(f"tbt.{INTERACTIVE}")
        if h is None or h.count < 8:
            return False
        return h.quantile(0.99) > self.engine.ecfg.ctl_headroom

    def _chunk_budget(self, now: float):
        eng, ecfg = self.engine, self.engine.ecfg
        plane = eng.chunked
        base = self._budget_base
        lo = ecfg.ctl_budget_min or max(plane.min_chunk,
                                        max(1, base // 4))
        hi = ecfg.ctl_budget_max or base * 4
        headroom = self._interactive_headroom(now)
        interactive_decoding = any(
            r.slo_class == INTERACTIVE for r in eng.active_requests())
        interactive_waiting = \
            eng.gateway.class_depth(INTERACTIVE) > 0 or any(
                r.slo_class == INTERACTIVE and not r.done and
                not r.cancelled and r.t_first_token < 0
                for r in eng.requests.values())
        # TBT: while an interactive request decodes, every extra prefill
        # token in a tick stalls each streamed token, so the budget stays
        # at most the base (and drops to lo once the streamed p99 thins).
        # TTFT: while interactive work waits and nothing interactive
        # streams, a larger budget drains the FIFO backlog ahead of it in
        # fewer ticks
        if interactive_decoding:
            if self._interactive_tbt_thin():
                target, why = lo, "interactive TBT p99 thin"
            else:
                target, why = base, "interactive decoding, nominal"
        elif interactive_waiting and headroom <= ecfg.ctl_headroom:
            target, why = hi, f"race to first token, " \
                f"headroom={headroom:.3f}s<={ecfg.ctl_headroom:g}"
        elif interactive_waiting:
            target, why = base, "interactive waiting, nominal"
        elif plane.jobs:
            # decode idle as far as the SLO signal goes: drain the backlog
            target, why = hi, f"decode idle, {len(plane.jobs)} streams"
        else:
            target, why = base, "idle"
        target = max(lo, min(hi, target))
        if target != plane.budget:
            old = plane.budget
            plane.set_budget(target)
            self._decide("budget", now, f"{old}->{target} ({why})",
                         budget=target)

    # ------------------------------------------------------------------
    # policy 4: deadline- and prefix-aware preemption
    # (engine._choose_victim delegates here under victim_policy=
    #  "controller")
    # ------------------------------------------------------------------
    def _victim_kv_value(self, r) -> int:
        """Tokens of committed or cached state the eviction would tear
        down and the restore rebuild: exclusive pages on a paged engine
        (shared pages survive by refcount), else the resident extent, plus
        the adopted prefix hit. ``PagePool.ref`` is a host array."""
        eng = self.engine
        resident = r.prefill_cursor if r.prefilling else max(0, r.pos)
        if eng.pages is not None:
            pool = eng.pages
            excl = sum(1 for pid in pool.slot_pages(r.slot)
                       if pool.ref[pid] == 1)
            resident = excl * pool.page_tokens
        return resident + r.prefix_hit

    def deadline_at_risk(self, head, now: float) -> bool:
        """The preemption gate: batch work is evicted only when the
        blocked interactive head's first-token deadline is breached or
        within ``ctl_deadline_risk`` of it; a head without a deadline is
        at risk once it has waited longer than that margin."""
        margin = self.engine.ecfg.ctl_deadline_risk
        if head.deadline is not None:
            return head.deadline - now <= margin
        return now - head.t_enqueue >= margin

    def choose_victim(self, cands, head, now: float):
        """Among preemptible candidates, evict the one wasting the least:
        the most remaining work less ``ctl_kv_weight`` times the value of
        its resident KV."""
        if head is not None and not self.deadline_at_risk(head, now):
            self.counts["preempt_denied"] += 1
            if self.engine.telemetry is not None:
                self.engine.telemetry.registry.inc(
                    "controller.preempt_denied")
            return None
        w = self.engine.ecfg.ctl_kv_weight
        victim = max(cands, key=lambda r: (
            self.engine._remaining_work(r) - w * self._victim_kv_value(r),
            -r.preemptions, r.rid))
        self._decide(
            "preempt", now,
            f"victim={victim.rid} remaining="
            f"{self.engine._remaining_work(victim)} "
            f"kv_value={self._victim_kv_value(victim)} "
            f"head={getattr(head, 'rid', '?')}")
        return victim

    # ------------------------------------------------------------------
    # audit and telemetry surface
    # ------------------------------------------------------------------
    def stats(self) -> dict:
        """Flat counters and gauges for ``MetricsRegistry.sync`` (the
        ``controller.*`` section of the snapshot)."""
        out = {f"decisions.{k}": v for k, v in self.counts.items()}
        out["decisions.total"] = sum(
            v for k, v in self.counts.items() if k != "preempt_denied")
        out["q_ema"] = round(self._q_ema, 4)
        if self.engine.chunked is not None:
            out["chunk_budget"] = self.engine.chunked.budget
        if self._imb_hist:
            out["imbalance_slope"] = round(self._imb_slope(), 6)
        return out

    def snapshot(self) -> dict:
        """Full decision history and counters (ServeMetrics.controller)."""
        return {"counts": dict(self.counts),
                "decisions": [dict(d) for d in self.decisions]}
