"""Worker objects of the serving stack (port of ``repro.serving.workers``).

Attention Workers and Expert Workers are distinct failure domains: each
worker object owns exactly the state that dies with it.

  * ``AttentionWorker`` owns its slice of the slot space (a
    ``SlotPartition`` over the shared cache), its checkpoint stream (a
    ``KVCheckpointer``), its prefix cache (serving/prefixcache.py, when
    the plane is on) and its liveness bit; ``fail`` loses the slots, the
    cached prefixes and every checkpoint write not yet delivered.
  * ``ExpertWorker`` owns its liveness bit and its pool membership; its
    experts' reachability is carried by the RouteState health mask, so
    ``fail``/``provision``/``retire`` are pure RouteState transitions.
  * ``ClusterSlotView``: the engine's view of every AW's slot partition
    (``engine.slots``).
"""
from __future__ import annotations

from collections import deque
from typing import Deque, List, Set

from repro_torch.core import selfheal
from repro_torch.core.checkpoint import CheckpointStore, KVCheckpointer
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

    def drop(self):
        """The partition's slots become unusable (worker crash)."""
        self._free = deque()

    def restore(self, in_use: Set[int]):
        self._free = deque(s for s in range(self.lo, self.hi)
                           if s not in in_use)


class AttentionWorker:
    """One AW: cache partition, checkpoint stream, prefix cache and
    liveness."""

    def __init__(self, aw_id: int, lo: int, hi: int, store: CheckpointStore,
                 reorder_window: int = 0):
        self.aw_id = aw_id
        self.slots = SlotPartition(lo, hi)
        self.checkpointer = KVCheckpointer(store, aw_id,
                                           reorder_window=reorder_window,
                                           seed=aw_id)
        # the AW's prefix cache, attached by the engine's PrefixCachePlane:
        # cached slots are this worker's retained KV (evictable capacity,
        # lost with the worker); a paged cache pins pages, not slots
        self.prefix_cache = None
        # a paged engine's PagePool: this AW's pages are its second
        # capacity axis (``kv_page_stats``)
        self.page_pool = None
        self.alive = True

    def free_slots(self) -> int:
        if not self.alive:
            return 0
        free = self.slots.free_count()
        if self.prefix_cache is not None:
            free += self.prefix_cache.evictable_count()
        return free

    def has_capacity(self) -> bool:
        return self.alive and self.free_slots() > 0

    def slot_occupancy(self) -> tuple:
        """(slots in use, partition capacity); cached-prefix slots count
        as in use until evicted, and a dead worker reports all of them."""
        cap = self.slots.capacity
        if not self.alive:
            return (cap, cap)
        return (cap - self.slots.free_count(), cap)

    def kv_page_stats(self):
        """(pages in use, partition pages) of this AW's slice of the page
        pool, or None on a contiguous engine; a dead worker reports all of
        them."""
        if self.page_pool is None:
            return None
        total = self.page_pool.pages_per_aw
        if not self.alive:
            return (total, total)
        return (total - self.page_pool.free_pages(self.aw_id), total)

    def take_slot(self, prompt=None, now: float = 0.0):
        """Allocate a slot for an admission: through the prefix cache when
        there is one (a matching cached prefix is adopted, else a free
        slot, else the cache's LRU entry is evicted), else a free slot.
        Returns (slot, adopted prefix length)."""
        if self.prefix_cache is not None:
            return self.prefix_cache.take_slot(prompt, now)
        return self.slots.alloc(), 0

    def drop_request(self, rid: str) -> int:
        """Planned teardown of one request's residency on this AW (cancel,
        release): discard its pending checkpoint WRs. The slot partition is untouched; the caller
        releases the slot. Returns the number of WRs discarded."""
        return self.checkpointer.drop_request(rid)

    def fail(self, route_state: RouteState) -> RouteState:
        """Crash: slots (and any KV not checkpointed) are gone; WRs still
        pending on the AW side never reach the store, so the commit
        watermark freezes at the last delivered contiguous prefix."""
        self.alive = False
        self.slots.drop()
        if self.prefix_cache is not None:
            # the plane took its orphan snapshot before this
            self.prefix_cache.clear()
        self.checkpointer.drop_pending()
        return selfheal.fail_aw(route_state, self.aw_id)

    def provision(self, route_state: RouteState,
                  in_use: Set[int]) -> RouteState:
        """Background re-provisioning (§5.4): fresh slots join the pool."""
        self.alive = True
        self.slots.restore(in_use)
        return selfheal.recover_aw(route_state, self.aw_id)

    def __repr__(self):
        return (f"AW{self.aw_id}(alive={self.alive}, "
                f"free={self.slots.free_count()}/{self.slots.capacity})")


class ExpertWorker:
    """One EW: liveness plus pool membership. A spare EW (member False,
    alive False) is reserved health-mask capacity until a scale-out
    admits it; a drained or promoted-away EW returns to spare."""

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

    def retire(self, route_state: RouteState) -> RouteState:
        """Leave the pool (graceful drain or permanent shadow promotion):
        the worker becomes a spare, and its slots drop out of routing
        through the health mask."""
        self.alive = False
        self.member = False
        return selfheal.fail_ew(route_state, self.ew_id)

    def __repr__(self):
        return f"EW{self.ew_id}(alive={self.alive}, member={self.member})"


class ClusterSlotView:
    """Every AW's slot partition seen as one slot space: the partition
    width (``per_aw``), and the reference's slot-manager view (the AW of a
    slot, an AW's free count, alloc and release)."""

    def __init__(self, workers: List[AttentionWorker], max_batch: int):
        self._workers = workers
        self.max_batch = max_batch
        self.num_aw = len(workers)
        self.per_aw = max_batch // len(workers)

    def aw_of(self, slot: int) -> int:
        return slot // self.per_aw

    def free_count(self, aw_id: int) -> int:
        return self._workers[aw_id].slots.free_count()

    def alloc(self, aw_id: int) -> int:
        return self._workers[aw_id].slots.alloc()

    def release(self, slot: int):
        self._workers[self.aw_of(slot)].slots.release(slot)
