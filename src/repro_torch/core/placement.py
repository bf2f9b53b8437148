"""Versioned expert placement (port of ``repro.core.placement``): the
elastic EW plane's control brain. Pure host-side numpy, as in the
reference.

  * ``PlacementPlan``: an immutable, generation-numbered snapshot of the
    expert plane: the logical expert resident in each physical slot
    (``slot_expert``), the EW owning each slot (``slot_owner``), each
    expert's designated primary slot, and the load-bearing replicas
    (``split_slot``). Installing a plan is a RouteState update: the ERT
    candidates and slot tables are rebuilt on the host and copied into
    tensors of fixed shapes, so a step graph is never captured anew.
  * ``ExpertPlacementManager``: owns the current plan and per-expert
    dispatch-load EMAs (drained from the per-slot counts ``refe.route``
    returns) and computes the plans of the orchestrator's elasticity
    events: load-aware **rebalance**, **scale-out**, **scale-in**,
    **shadow promotion** and **re-protection**.

A plan that changes residency implies a host-side weight push, which the
orchestrator charges to the virtual clock as ``T_push`` before it
activates the plan (§5.4's layer-aligned background join).
"""
from __future__ import annotations

from dataclasses import dataclass
from typing import Dict, List, Tuple

import numpy as np

from repro_torch.core import ert as ert_lib


# number of ERT candidate columns: designated primary + one replica. The
# column count is a tensor shape the step graphs hold, so it is fixed; plans express richer
# layouts by choosing WHICH replica fills column 1.
NUM_CANDIDATES = 2


@dataclass(frozen=True)
class PlacementPlan:
    """One generation of the expert plane. All arrays are host-side numpy;
    the engine converts them to device arrays on install."""

    generation: int
    slot_expert: np.ndarray      # [P] resident logical expert (-1 empty)
    slot_owner: np.ndarray       # [P] owning EW (-1 parked / EW gone)
    primary: np.ndarray          # [E] designated primary slot per expert
    split_slot: np.ndarray       # [E] load-bearing replica (-1 none)
    members: Tuple[int, ...]     # live EW pool at plan time (sorted)
    reason: str = ""

    @property
    def num_slots(self) -> int:
        return int(self.slot_expert.shape[0])

    @property
    def num_experts(self) -> int:
        return int(self.primary.shape[0])

    def candidates(self) -> np.ndarray:
        """ERT candidate table [E, NUM_CANDIDATES]: primary first, then the
        first replica on a *different, live* EW (a same-EW replica would die
        with the primary, exactly the legacy shadow rule)."""
        e = self.num_experts
        cand = np.full((e, NUM_CANDIDATES), -1, np.int32)
        cand[:, 0] = self.primary
        for s in range(self.num_slots):
            ex = self.slot_expert[s]
            if ex < 0 or s == self.primary[ex] or cand[ex, 1] >= 0:
                continue
            if self.slot_owner[s] < 0 or self.primary[ex] < 0:
                continue
            if self.slot_owner[s] != self.slot_owner[self.primary[ex]]:
                cand[ex, 1] = s
        return cand

    def replica_of(self, expert: int) -> int:
        return int(self.candidates()[expert, 1])

    def slots_of_ew(self, ew: int) -> np.ndarray:
        return np.nonzero(self.slot_owner == ew)[0]

    def resident_experts(self, ew: int) -> List[int]:
        return [int(self.slot_expert[s]) for s in self.slots_of_ew(ew)
                if self.slot_expert[s] >= 0]

    def moved_slots(self, prev: "PlacementPlan") -> int:
        """Slots whose (resident expert, owner) changed: the host-side
        weight-push volume a plan transition implies."""
        return int(np.sum((self.slot_expert != prev.slot_expert) |
                          (self.slot_owner != prev.slot_owner)))


@dataclass
class LoadStats:
    """Per-expert / per-EW dispatch-load EMAs, drained from device counters."""

    ema_expert: np.ndarray       # [E] EMA of per-step dispatched tokens
    ema_ew: np.ndarray           # [max_ew] EMA over slot owners
    total_recorded: float = 0.0  # raw tokens ever recorded (signal gate)
    decay: float = 0.9

    def record(self, slot_load: np.ndarray, slot_expert: np.ndarray,
               slot_owner: np.ndarray):
        per_e = np.zeros_like(self.ema_expert)
        per_w = np.zeros_like(self.ema_ew)
        live = (slot_expert >= 0) & (slot_load > 0)
        np.add.at(per_e, slot_expert[live], slot_load[live])
        owned = live & (slot_owner >= 0)
        np.add.at(per_w, slot_owner[owned], slot_load[owned])
        self.ema_expert = self.decay * self.ema_expert + \
            (1 - self.decay) * per_e
        self.ema_ew = self.decay * self.ema_ew + (1 - self.decay) * per_w
        self.total_recorded += float(slot_load.sum())


class ExpertPlacementManager:
    """Computes and versions PlacementPlans from load telemetry + pool
    membership. Pure host-side; the engine installs the arrays."""

    def __init__(self, placement: ert_lib.ExpertPlacement, num_ew: int,
                 max_ew: int = 0, ema_decay: float = 0.9,
                 rebalance_threshold: float = 1.25,
                 min_load_signal: float = 32.0):
        self.geom = placement
        self.max_ew = max(max_ew or num_ew, num_ew)
        self.members: List[int] = list(range(num_ew))
        self.load = LoadStats(
            ema_expert=np.zeros((placement.num_experts,), np.float64),
            ema_ew=np.zeros((self.max_ew,), np.float64), decay=ema_decay)
        self.rebalance_threshold = rebalance_threshold
        self.min_load_signal = min_load_signal
        # replica packing of leftover slots: "parity" (hottest-first onto
        # the lightest EW) or "weighted" (best-fit-decreasing against the
        # measured per-EW deficit; the control plane sets it). Either way
        # a replica takes half its expert's traffic on the device, so the
        # mode changes which experts replicate and where, not routing.
        self.split_mode = "parity"
        self.plan = self._initial_plan()
        self.history: List[PlacementPlan] = [self.plan]

    # ------------------------------------------------------------------
    # telemetry
    # ------------------------------------------------------------------
    def record_slot_load(self, slot_load: np.ndarray):
        self.load.record(np.asarray(slot_load, np.float64),
                         self.plan.slot_expert, self.plan.slot_owner)

    def per_ew_load(self) -> Dict[int, float]:
        return {m: float(self.load.ema_ew[m]) for m in self.members}

    def imbalance(self) -> float:
        """max/mean dispatch load over pool members (1.0 = perfectly even)."""
        loads = np.asarray([self.load.ema_ew[m] for m in self.members])
        if loads.size == 0 or loads.sum() <= 0:
            return 1.0
        return float(loads.max() / loads.mean())

    def choose_protect_ew(self, exclude: Tuple[int, ...] = ()) -> int:
        """The EW whose failure would hurt most = highest dispatch load
        (ties -> lowest id). Replaces the orchestrator's hardcoded
        (worker_id + 1) % num_ew neighbor rule."""
        best, best_load = -1, -1.0
        for m in self.members:
            if m in exclude:
                continue
            load = float(self.load.ema_ew[m])
            if load > best_load + 1e-12:
                best, best_load = m, load
        if best < 0:
            best = min(self.members) if self.members else 0
        return best

    # ------------------------------------------------------------------
    # plan construction
    # ------------------------------------------------------------------
    def _initial_plan(self) -> PlacementPlan:
        """Generation 0 mirrors the legacy static layout exactly (identity
        primaries, striped shadows protecting EW0), so a manager-driven
        engine boots bit-identical to the pre-elastic one."""
        p = self.geom
        assign = ert_lib.initial_shadow_assignment(p)
        return PlacementPlan(
            generation=0,
            slot_expert=ert_lib.initial_slot_expert(p, assign),
            slot_owner=np.asarray(p.slot_owner(), np.int32),
            primary=np.arange(p.num_experts, dtype=np.int32),
            split_slot=np.full((p.num_experts,), -1, np.int32),
            members=tuple(self.members), reason="initial")

    def _commit(self, slot_expert, slot_owner, primary, split_slot,
                reason: str) -> PlacementPlan:
        plan = PlacementPlan(
            generation=self.plan.generation + 1,
            slot_expert=np.asarray(slot_expert, np.int32),
            slot_owner=np.asarray(slot_owner, np.int32),
            primary=np.asarray(primary, np.int32),
            split_slot=np.asarray(split_slot, np.int32),
            members=tuple(sorted(self.members)), reason=reason)
        self.plan = plan
        self.history.append(plan)
        return plan

    def _owned_slots(self, slot_owner: np.ndarray = None,
                     members: List[int] = None) -> int:
        so = self.plan.slot_owner if slot_owner is None else slot_owner
        mm = self.members if members is None else members
        return int(np.sum(np.isin(so, list(mm))))

    def _balanced_assignment(self, slot_owner: np.ndarray, reason: str,
                             pack_members: List[int] = None
                             ) -> PlacementPlan:
        """Greedy longest-processing-time packing of experts onto the member
        EWs' slots, by load EMA: hot experts spread first, cold ones pack
        into the gaps; leftover slots become load-bearing replicas of the
        hottest experts (placed off the primary's EW, halving its load under
        parity splitting).

        ``pack_members`` restricts *placement targets* (e.g. to currently
        healthy members during a revival window) without changing pool
        membership."""
        p = self.geom
        e = p.num_experts
        members = sorted(self.members if pack_members is None
                         else pack_members)
        owned = self._owned_slots(slot_owner, members)
        if owned < e:
            # refusing loudly beats silently orphaning reachable experts
            # (their tokens would reroute with no error)
            raise ValueError(
                f"cannot place {e} experts into {owned} owned slots "
                f"(targets={members}, reason={reason})")
        # uniform prior so zero-load experts still spread evenly
        load = self.load.ema_expert + max(1e-6, self.load.ema_expert.sum()
                                          / max(1, e)) * 0.01
        free: Dict[int, List[int]] = {
            m: list(np.nonzero(slot_owner == m)[0]) for m in members}
        ew_load = {m: 0.0 for m in members}
        slot_expert = np.full((p.num_slots,), -1, np.int32)
        primary = np.full((e,), -1, np.int32)
        order = np.argsort(-load, kind="stable")
        for ex in order:
            cands = [m for m in members if free[m]]
            if not cands:
                break
            m = min(cands, key=lambda w: (ew_load[w], w))
            s = free[m].pop(0)
            slot_expert[s] = ex
            primary[ex] = s
            ew_load[m] += float(load[ex])
        # replicas into leftover slots; a replica on a different EW than
        # the primary takes half the expert's traffic
        split_slot = np.full((e,), -1, np.int32)
        if self.split_mode == "weighted":
            self._weighted_splits(load, slot_owner, members, free, ew_load,
                                  slot_expert, primary, split_slot)
        else:
            # hottest experts first, each onto the globally lightest EW
            # with a free slot
            for ex in order:
                if primary[ex] < 0 or split_slot[ex] >= 0:
                    continue
                home = int(slot_owner[primary[ex]])
                cands = [m for m in members if free[m] and m != home]
                if not cands:
                    continue
                half = float(load[ex]) / 2.0
                m = min(cands, key=lambda w: (ew_load[w], w))
                # only replicate if it actually helps the imbalance
                if ew_load[m] + half >= ew_load[home]:
                    continue
                s = free[m].pop(0)
                slot_expert[s] = ex
                split_slot[ex] = s
                ew_load[m] += half
                ew_load[home] -= half
        return self._commit(slot_expert, slot_owner, primary, split_slot,
                            reason)

    @staticmethod
    def _weighted_splits(load, slot_owner, members, free, ew_load,
                         slot_expert, primary, split_slot):
        """Best-fit-decreasing replica packing (``split_mode="weighted"``):
        each round takes the most deficient member EW and gives it the
        un-split expert whose half load best fills its gap to the pool
        mean. Mutates ``free``, ``ew_load``, ``slot_expert`` and
        ``split_slot`` in place."""
        while True:
            mean = sum(ew_load.values()) / max(1, len(ew_load))
            targets = [m for m in members if free[m] and ew_load[m] < mean]
            if not targets:
                return
            m = min(targets, key=lambda w: (ew_load[w], w))
            deficit = mean - ew_load[m]
            best_ex, best_fit = -1, None
            for ex in range(len(primary)):
                if primary[ex] < 0 or split_slot[ex] >= 0:
                    continue
                home = int(slot_owner[primary[ex]])
                if home == m:
                    continue
                half = float(load[ex]) / 2.0
                # the parity mode's guard: a split that overshoots past its
                # donor makes the imbalance worse
                if ew_load[m] + half >= ew_load[home]:
                    continue
                fit = abs(deficit - half)
                if best_fit is None or fit < best_fit - 1e-12:
                    best_ex, best_fit = ex, fit
            if best_ex < 0:
                return
            home = int(slot_owner[primary[best_ex]])
            half = float(load[best_ex]) / 2.0
            s = free[m].pop(0)
            slot_expert[s] = best_ex
            split_slot[best_ex] = s
            ew_load[m] += half
            ew_load[home] -= half

    def adopt(self, slot_expert, slot_owner=None, primary=None,
              split_slot=None, reason: str = "custom") -> PlacementPlan:
        """Version an externally computed assignment as the next generation
        (operator override; also the hook tests use to pin exotic layouts).
        Unspecified arrays carry over from the current plan."""
        plan = self.plan
        return self._commit(
            slot_expert,
            plan.slot_owner if slot_owner is None else slot_owner,
            plan.primary if primary is None else primary,
            np.full_like(plan.primary, -1) if split_slot is None
            else split_slot,
            reason)

    # ------------------------------------------------------------------
    # elasticity events
    # ------------------------------------------------------------------
    def should_rebalance(self) -> bool:
        return (len(self.members) > 1 and
                self._owned_slots() >= self.geom.num_experts and
                self.load.total_recorded >= self.min_load_signal and
                self.imbalance() > self.rebalance_threshold)

    def can_scale_out(self) -> bool:
        return any(w not in self.members for w in range(self.max_ew))

    def plan_rebalance(self, live: Tuple[int, ...] = None) -> PlacementPlan:
        """Load-aware re-packing over the current slot ownership. ``live``
        (when given) restricts placement to currently healthy members — a
        failed-but-member EW (revival in flight) must not be handed
        primaries it cannot serve."""
        pack = None if live is None else \
            [m for m in self.members if m in live]
        return self._balanced_assignment(self.plan.slot_owner.copy(),
                                         reason="rebalance",
                                         pack_members=pack)

    def plan_scale_out(self) -> Tuple[int, PlacementPlan]:
        """Admit a new EW: it takes parked slots first, then an even share
        stolen from the largest current owners; experts are then re-packed
        load-aware over the grown pool (§5.4 background join — the weight
        push happens off the critical path, charged as T_push)."""
        spare = [w for w in range(self.max_ew) if w not in self.members]
        if not spare:
            raise ValueError("EW pool already at max_ew "
                             f"({self.max_ew}); cannot scale out")
        new_ew = spare[0]
        slot_owner = self.plan.slot_owner.copy()
        self.members = sorted(self.members + [new_ew])
        share = self.geom.num_slots // len(self.members)
        granted = list(np.nonzero(slot_owner < 0)[0])[:share]
        for s in granted:
            slot_owner[s] = new_ew
        while len(granted) < share:
            counts = {m: int(np.sum(slot_owner == m))
                      for m in self.members if m != new_ew}
            donor = max(counts, key=lambda m: (counts[m], -m))
            donor_slots = np.nonzero(slot_owner == donor)[0]
            # prefer donating empty / replica slots over primaries
            s = min(donor_slots,
                    key=lambda x: (self.plan.slot_expert[x] >= 0 and
                                   self.plan.primary[
                                       self.plan.slot_expert[x]] == x, x))
            slot_owner[s] = new_ew
            granted.append(int(s))
        plan = self._balanced_assignment(slot_owner,
                                         reason=f"scale_out ew{new_ew}")
        return new_ew, plan

    def plan_scale_in(self, ew: int) -> PlacementPlan:
        """Graceful drain: the EW's slots park, its resident experts migrate
        into the remaining members' slots (weight push = T_push; the EW keeps
        serving the old plan until the new one activates)."""
        if ew not in self.members:
            raise ValueError(f"EW{ew} is not a pool member")
        if len(self.members) <= 1:
            raise ValueError("cannot drain the last EW")
        slot_owner = self.plan.slot_owner.copy()
        slot_owner[slot_owner == ew] = -1
        remaining = int(np.sum(slot_owner >= 0))
        if remaining < self.geom.num_experts:
            raise ValueError(
                f"draining EW{ew} leaves {remaining} slots for "
                f"{self.geom.num_experts} experts")
        self.members = [m for m in self.members if m != ew]
        return self._balanced_assignment(slot_owner,
                                         reason=f"scale_in ew{ew}")

    def promote_shadows(self, dead_ew: int) -> PlacementPlan:
        """Permanent shadow promotion (pool shrinks instead of reviving):
        every expert whose primary died re-points to its live replica as the
        new primary — an instant, zero-push array flip. Experts with no live
        replica stay parked (masked) until a re-protection plan lands."""
        if dead_ew not in self.members:
            raise ValueError(f"EW{dead_ew} is not a pool member")
        plan = self.plan
        cand = plan.candidates()
        slot_expert = plan.slot_expert.copy()
        slot_owner = plan.slot_owner.copy()
        primary = plan.primary.copy()
        split_slot = plan.split_slot.copy()
        self.members = [m for m in self.members if m != dead_ew]
        for ex in range(plan.num_experts):
            pr = primary[ex]
            if pr >= 0 and slot_owner[pr] == dead_ew:
                rep = cand[ex, 1]
                if rep >= 0 and slot_owner[rep] >= 0 and \
                        slot_owner[rep] != dead_ew:
                    primary[ex] = rep
            if split_slot[ex] >= 0 and slot_owner[split_slot[ex]] == dead_ew:
                split_slot[ex] = -1
        # the dead EW's slots (and the weights in them) are gone: park them
        dead_slots = slot_owner == dead_ew
        slot_expert[dead_slots] = -1
        slot_owner[dead_slots] = -1
        return self._commit(slot_expert, slot_owner, primary, split_slot,
                            reason=f"promote ew{dead_ew}")

    def plan_reprotect(self, protect_ew: int,
                       dead_ews: Tuple[int, ...] = ()) -> PlacementPlan:
        """Re-point the non-primary (replica) slots to protect
        ``protect_ew``'s resident experts — the background weight push after
        a failure or promotion (§5.3's pre-loading, now plan-versioned).
        Every protected expert gets a replica on a *different* EW.

        ``dead_ews``: members currently failed (not yet revived). Replicas
        that are the only reachable copy of a dead EW's experts are load-
        bearing failover paths and are NOT recycled."""
        plan = self.plan
        slot_expert = plan.slot_expert.copy()
        slot_owner = plan.slot_owner.copy()
        primary = plan.primary.copy()
        split_slot = np.full_like(plan.split_slot, -1)
        is_primary = np.zeros((plan.num_slots,), bool)
        for ex in range(plan.num_experts):
            if primary[ex] >= 0:
                is_primary[primary[ex]] = True
        # clear replica slots (keep primaries, and keep the active failover
        # replicas of experts whose primary EW is down)
        for s in range(plan.num_slots):
            if slot_owner[s] < 0 or is_primary[s]:
                continue
            ex = slot_expert[s]
            if ex >= 0 and primary[ex] >= 0 and \
                    slot_owner[primary[ex]] in dead_ews and \
                    slot_owner[s] not in dead_ews:
                continue
            slot_expert[s] = -1
        protected = [ex for ex in plan.resident_experts(protect_ew)
                     if primary[ex] >= 0 and
                     slot_owner[primary[ex]] == protect_ew]
        # orphans first: experts with a parked/dead primary get re-homed
        # into free slots (they are unreachable until this lands). Free
        # slots on still-dead EWs are useless as targets — a replica there
        # would be born unreachable.
        orphans = [ex for ex in range(plan.num_experts)
                   if primary[ex] < 0 or slot_owner[primary[ex]] < 0]
        free = [s for s in range(plan.num_slots)
                if slot_owner[s] >= 0 and slot_owner[s] not in dead_ews and
                slot_expert[s] < 0]
        for ex in orphans:
            if not free:
                break
            s = free.pop(0)
            slot_expert[s] = ex
            primary[ex] = s
        for ex in protected:
            home = slot_owner[primary[ex]]
            pick = next((s for s in free if slot_owner[s] != home), None)
            if pick is None:
                continue
            free.remove(pick)
            slot_expert[pick] = ex
        return self._commit(slot_expert, slot_owner, primary, split_slot,
                            reason=f"reprotect ew{protect_ew}")

    # ------------------------------------------------------------------
    def ew_member_mask(self) -> np.ndarray:
        mask = np.zeros((self.max_ew,), bool)
        mask[list(self.members)] = True
        return mask


def push_seconds(moved_slots: int, d_model: int, d_ff: int,
                 link_gbps: float = 400.0, bytes_per_el: int = 2,
                 gated: bool = True) -> float:
    """Host-side weight-push time for a plan transition: bytes of expert
    weights whose residency changed, over the provisioning link."""
    per_expert = (3 if gated else 2) * d_model * d_ff * bytes_per_el
    return moved_slots * per_expert / (link_gbps / 8 * 1e9)

