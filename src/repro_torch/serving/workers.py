"""Worker objects of the serving stack (port of ``repro.serving.workers``).

Attention Workers and Expert Workers are distinct failure domains: each
worker object owns exactly the state that dies with it.

  * ``AttentionWorker`` owns its slice of the slot space (a
    ``SlotPartition`` over the shared cache) and its liveness bit. Its
    checkpoint stream and fail/provision arrive with the AW-failure slice.
  * ``ExpertWorker`` owns its liveness bit; its experts' reachability is
    carried by the RouteState health mask, so ``fail``/``provision`` are
    pure RouteState transitions.
"""
from __future__ import annotations

from collections import deque
from typing import Deque, Set

from repro_torch.core import selfheal
from repro_torch.core.refe import RouteState


class SlotPartition:
    """Free list over one AW's contiguous slot range [lo, hi): alloc pops
    the front, release pushes the front (recently cleared slots reused
    first)."""

    def __init__(self, lo: int, hi: int):
        self.lo, self.hi = lo, hi
        self._free: Deque[int] = deque(range(lo, hi))

    @property
    def capacity(self) -> int:
        return self.hi - self.lo

    def free_count(self) -> int:
        return len(self._free)

    def owns(self, slot: int) -> bool:
        return self.lo <= slot < self.hi

    def alloc(self) -> int:
        return self._free.popleft()

    def release(self, slot: int):
        if not self.owns(slot):
            raise ValueError(f"slot {slot} is not in [{self.lo}, {self.hi})")
        self._free.appendleft(slot)

    def restore(self, in_use: Set[int]):
        self._free = deque(s for s in range(self.lo, self.hi)
                           if s not in in_use)


class AttentionWorker:
    """One AW: its cache partition and its liveness."""

    def __init__(self, aw_id: int, lo: int, hi: int):
        self.aw_id = aw_id
        self.slots = SlotPartition(lo, hi)
        self.alive = True

    def free_slots(self) -> int:
        return self.slots.free_count() if self.alive else 0

    def has_capacity(self) -> bool:
        return self.alive and self.free_slots() > 0

    def take_slot(self, prompt=None, now: float = 0.0):
        """Allocate a slot for an admission. Returns (slot, matched prefix
        length), the latter 0 until the prefix cache is ported."""
        return self.slots.alloc(), 0

    def __repr__(self):
        return (f"AW{self.aw_id}(alive={self.alive}, "
                f"free={self.slots.free_count()}/{self.slots.capacity})")


class ExpertWorker:
    """One EW: liveness plus pool membership."""

    def __init__(self, ew_id: int, member: bool = True):
        self.ew_id = ew_id
        self.member = member
        self.alive = member

    def fail(self, route_state: RouteState) -> RouteState:
        self.alive = False
        return selfheal.fail_ew(route_state, self.ew_id)

    def provision(self, route_state: RouteState) -> RouteState:
        self.alive = True
        self.member = True
        return selfheal.recover_ew(route_state, self.ew_id)

    def __repr__(self):
        return f"EW{self.ew_id}(alive={self.alive}, member={self.member})"
