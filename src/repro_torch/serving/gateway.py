"""Cluster Gateway: per-class waiting queues, weighted dequeue, and AW
placement (port of ``repro.serving.gateway``).

Every request enters the queue of its SLO class; admission serves the
class heads by weighted dequeue (interactive 4 : standard 2 : batch 1 per
round). Within a class, entries with an earlier first-token deadline sort
ahead (stable), and recovery entries (requests of a failed AW waiting to
be restored, ``recovery=True``) stay at the front. A head that cannot be
placed blocks only its own class for this tick.

Placement policies (a healthy AW with free capacity, or None):
``least_loaded`` (most free slots; ties -> lowest id) and ``round_robin``.
Session affinity, the token cap and preemption arrive with the planes
they serve.
"""
from __future__ import annotations

from collections import deque
from dataclasses import dataclass, field
from typing import Deque, Dict, List, Optional, Tuple

import numpy as np

from repro_torch.serving.api import (CLASS_WEIGHTS, SLO_CLASSES, STANDARD,
                                     SamplingParams)
from repro_torch.serving.workers import AttentionWorker


@dataclass
class QueuedRequest:
    rid: str
    prompt: np.ndarray
    max_new: int
    t_enqueue: float = 0.0
    retries: int = 0                # ticks spent blocked at the queue head
    slo_class: str = STANDARD
    deadline: Optional[float] = None
    sampling: Optional[SamplingParams] = None
    recovery: bool = False          # re-admission of a failed AW's request

    @property
    def deadline_key(self) -> float:
        return self.deadline if self.deadline is not None else float("inf")


class LeastLoadedPolicy:
    """Most free slots wins; ties break toward the lowest AW id."""

    def __call__(self, workers: List[AttentionWorker], key: str,
                 prompt=None, now: float = 0.0) -> Optional[int]:
        best, best_free = None, 0
        for w in workers:
            f = w.free_slots()
            if f > best_free:
                best, best_free = w.aw_id, f
        return best


class RoundRobinPolicy:
    """Cycle over AWs regardless of load, skipping dead/full ones."""

    def __init__(self):
        self._next = 0

    def __call__(self, workers: List[AttentionWorker], key: str,
                 prompt=None, now: float = 0.0) -> Optional[int]:
        n = len(workers)
        for i in range(n):
            w = workers[(self._next + i) % n]
            if w.has_capacity():
                self._next = (w.aw_id + 1) % n
                return w.aw_id
        return None


PLACEMENT_POLICIES = {
    "least_loaded": LeastLoadedPolicy,
    "round_robin": RoundRobinPolicy,
}


@dataclass
class GatewayStats:
    enqueued: int = 0
    admitted: int = 0
    blocked_ticks: int = 0          # head-of-queue retries
    requeued: int = 0               # recovery re-admissions queued
    host_syncs: int = 0             # decode-path device->host token drains
    queue_delay: Dict[str, float] = field(default_factory=dict)
    by_class: Dict[str, Dict[str, int]] = field(default_factory=dict)

    def bump(self, slo_class: str, key: str, n: int = 1):
        c = self.by_class.setdefault(slo_class, {})
        c[key] = c.get(key, 0) + n


class Gateway:
    """Per-class waiting queues plus placement over the AW pool."""

    def __init__(self, workers: List[AttentionWorker],
                 policy="least_loaded"):
        self.workers = workers
        if isinstance(policy, str):
            policy = PLACEMENT_POLICIES[policy]()
        self.policy = policy
        self.queues: Dict[str, Deque[QueuedRequest]] = {
            cls: deque() for cls in SLO_CLASSES}
        self.stats = GatewayStats()

    def enqueue(self, rid: str, prompt: np.ndarray, max_new: int, *,
                now: float = 0.0, slo_class: str = STANDARD,
                deadline: Optional[float] = None,
                sampling: Optional[SamplingParams] = None):
        if slo_class not in SLO_CLASSES:
            raise ValueError(f"unknown slo_class {slo_class!r}: expected "
                             f"one of {SLO_CLASSES}")
        self._insert(QueuedRequest(rid, np.asarray(prompt, np.int32),
                                   max_new, now, slo_class=slo_class,
                                   deadline=deadline, sampling=sampling))
        self.stats.enqueued += 1
        self.stats.bump(slo_class, "enqueued")

    def _insert(self, entry: QueuedRequest):
        """Deadline-aware stable insertion: after every recovery entry,
        after any head already blocked and after every entry with an
        equal-or-earlier deadline."""
        q = self.queues[entry.slo_class]
        i = len(q)
        for j, e in enumerate(q):
            if e.recovery or e.retries > 0:
                continue
            if e.deadline_key > entry.deadline_key:
                i = j
                break
        q.insert(i, entry)

    def requeue_recovery(self, entries: List[QueuedRequest]):
        """A failed AW's requests re-enter at the FRONT of their class
        queue (they are older than everything waiting behind them)."""
        for e in reversed(entries):
            e.recovery = True
            self.queues[e.slo_class].appendleft(e)
            self.stats.requeued += 1

    @property
    def queue(self) -> Tuple[QueuedRequest, ...]:
        """Every waiting entry, in class-priority then queue order."""
        return tuple(q for cls in SLO_CLASSES for q in self.queues[cls])

    def depth(self) -> int:
        return sum(len(q) for q in self.queues.values())

    def find(self, rid: str) -> Optional[QueuedRequest]:
        for q in self.queues.values():
            for e in q:
                if e.rid == rid:
                    return e
        return None

    def drop(self, rid: str) -> Optional[QueuedRequest]:
        e = self.find(rid)
        if e is not None:
            self.queues[e.slo_class].remove(e)
        return e

    def choose_aw(self, key: str = "", prompt=None,
                  now: float = 0.0) -> Optional[int]:
        return self.policy(self.workers, key, prompt=prompt, now=now)

    def admit(self, now: float = 0.0
              ) -> List[Tuple[QueuedRequest, int, int]]:
        """Weighted dequeue over the class queues; reserves a slot on the
        chosen AW per admission. Returns (entry, aw_id, slot) triples."""
        admitted = []
        blocked = set()
        while True:
            progressed = False
            for cls in SLO_CLASSES:
                if cls in blocked:
                    continue
                q = self.queues[cls]
                for _ in range(CLASS_WEIGHTS[cls]):
                    if not q:
                        break
                    head = q[0]
                    aw = self.choose_aw(head.rid, prompt=head.prompt,
                                        now=now)
                    if aw is None:
                        head.retries += 1
                        self.stats.blocked_ticks += 1
                        blocked.add(cls)
                        break
                    q.popleft()
                    slot, _ = self.workers[aw].take_slot(head.prompt, now)
                    self.stats.admitted += 1
                    self.stats.bump(cls, "admitted")
                    self.stats.queue_delay[head.rid] = \
                        self.stats.queue_delay.get(head.rid, 0.0) + \
                        (now - head.t_enqueue)
                    admitted.append((head, aw, slot))
                    progressed = True
            if not progressed:
                break
        return admitted
