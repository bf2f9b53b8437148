"""Expert Routing Table (ERT): decouple expert identity from location.

Port of ``repro.core.ert``. Expert compute happens in a physical slot space
of size P = primaries + shadows; slots 0..E-1 are primaries, the rest are
shadow slots re-pointable at runtime. The ERT is a pair of device tensors
(``candidates`` [E, R], ``ew_health`` [num_ew]) threaded through every
step, so a failover is a tensor update, never a rebuild. Host-side
geometry is numpy, as in the reference.
"""
from __future__ import annotations

from dataclasses import dataclass

import numpy as np
import torch


@dataclass(frozen=True)
class ExpertPlacement:
    """Static geometry of the expert slot space."""

    num_experts: int              # E logical experts
    num_ew: int                   # EW shards
    num_shadow_slots: int         # extra slots for shadow replicas

    @property
    def primary_slots(self) -> int:
        return -(-self.num_experts // self.num_ew) * self.num_ew

    @property
    def num_slots(self) -> int:
        return self.primary_slots + self.num_shadow_slots

    @property
    def experts_per_ew(self) -> int:
        return self.primary_slots // self.num_ew

    def slot_owner(self) -> np.ndarray:
        """EW owning each slot: primaries blocked contiguously, shadows
        striped round-robin."""
        owner = np.empty((self.num_slots,), np.int32)
        owner[: self.primary_slots] = (
            np.arange(self.primary_slots) // self.experts_per_ew)
        owner[self.primary_slots:] = (
            np.arange(self.num_shadow_slots) % self.num_ew)
        return owner


def default_placement(num_experts: int, num_ew: int,
                      num_shadow_slots: int = -1) -> ExpertPlacement:
    if num_shadow_slots < 0:
        # one EW's worth of residual memory, oversized by num_ew/(num_ew-1)
        # so every protected expert gets a slot on a different EW, rounded
        # up to a multiple of num_ew
        e_per = -(-num_experts // max(1, num_ew))
        if num_ew > 1:
            base = -(-e_per * num_ew // (num_ew - 1))
            num_shadow_slots = -(-base // num_ew) * num_ew
        else:
            num_shadow_slots = e_per
    return ExpertPlacement(num_experts, num_ew, num_shadow_slots)


def initial_shadow_assignment(placement: ExpertPlacement,
                              protected_ew: int = 0) -> np.ndarray:
    """Which logical expert each shadow slot replicates: EW
    ``protected_ew``'s experts first get slots on other EWs; leftover
    slots take duplicate replicas."""
    e_per = placement.experts_per_ew
    protected = [e for e in range(protected_ew * e_per,
                                  (protected_ew + 1) * e_per)
                 if e < placement.num_experts]
    if not protected:
        protected = list(range(min(e_per, placement.num_experts)))
    owner = placement.slot_owner()
    s = placement.num_shadow_slots
    assign = np.full((s,), -1, np.int32)
    usable = [j for j in range(s)
              if owner[placement.primary_slots + j] != protected_ew]
    for i, e in enumerate(protected):
        if i < len(usable):
            assign[usable[i]] = e
    for j in range(s):
        if assign[j] < 0:
            assign[j] = protected[j % len(protected)]
    return assign


def build_candidates(placement: ExpertPlacement,
                     shadow_assignment: np.ndarray) -> np.ndarray:
    """ERT candidate table [E, 2]: (primary slot, shadow slot or -1); a
    shadow counts only if it lives on another EW than the primary."""
    e = placement.num_experts
    owner = placement.slot_owner()
    cand = np.full((e, 2), -1, np.int32)
    cand[:, 0] = np.arange(e)
    for j, expert in enumerate(shadow_assignment):
        slot = placement.primary_slots + j
        if owner[slot] != owner[expert] and cand[expert, 1] < 0:
            cand[expert, 1] = slot
    return cand


def resolve_active_slots(candidates, ew_health, slot_owner):
    """Resolve each logical expert to its highest-priority healthy slot.

    candidates: [E, R] int; ew_health: [num_ew] bool; slot_owner: [P] int
    (-1 = parked slot). Returns (active_slot [E] int32, expert_alive [E]
    bool), all on the device of ``candidates``."""
    valid = candidates >= 0
    safe = torch.clamp(candidates, min=0).long()
    owner = slot_owner[safe]
    healthy = valid & (owner >= 0) & \
        ew_health[torch.clamp(owner, min=0).long()]
    # first healthy candidate in priority order (argmax returns the first)
    first = torch.argmax(healthy.to(torch.int32), dim=1)
    any_healthy = healthy.any(dim=1)
    active = torch.gather(safe, 1, first[:, None])[:, 0]
    # nothing healthy: fall back to the primary (tokens are masked out)
    active = torch.where(any_healthy, active, candidates[:, 0].long())
    return active.to(torch.int32), any_healthy


def initial_slot_expert(placement: ExpertPlacement,
                        shadow_assignment: np.ndarray) -> np.ndarray:
    """Resident logical expert per physical slot (-1 = empty pad slot)."""
    se = np.full((placement.num_slots,), -1, np.int32)
    se[: placement.num_experts] = np.arange(placement.num_experts)
    se[placement.primary_slots:] = np.asarray(shadow_assignment, np.int32)
    return se


def ew_health_to_slot_health(ew_health, slot_owner):
    """Health of each slot's owning EW: ``ew_health`` [num_ew] indexed by
    ``slot_owner`` [P] (a tensor or an array), on ``ew_health``'s
    device."""
    return ew_health[torch.as_tensor(slot_owner, dtype=torch.long,
                                     device=ew_health.device)]
