"""Cluster Gateway: per-class waiting queues, weighted dequeue, and AW
placement (port of ``repro.serving.gateway``).

Every request enters the queue of its SLO class; admission serves the
class heads by weighted dequeue (interactive 4 : standard 2 : batch 1 per
round). Within a class, entries with an earlier first-token deadline sort
ahead (stable), and recovery entries (requests of a failed AW waiting to
be restored, ``recovery=True``) stay at the front. A head that cannot be
placed blocks only its own class for this tick.

Placement policies (a healthy AW with free capacity, or None):
``least_loaded`` (most free slots; ties -> lowest id), ``round_robin``
and ``session_affinity`` (a session's home is the AW holding the longest
cached prefix of the prompt when the prefix cache is on, else the stable
hash of its key, the explicit ``session`` when given, else the rid's
session prefix ``rid.rsplit('-', 1)[0]``; the session is pinned there, a
full home spills to least-loaded for one request, a dead home re-pins the
session with a ``session_repinned`` event). Free capacity counts the
prefix cache's evictable slots, and admission adopts a matching cached
prefix (``QueuedRequest.prefix_hit``).

Admission is token-aware when ``prefill_token_cap`` is set: a head waits
while the prompt tokens admitted but not yet prefilled would pass the cap
(recovery entries bypass it; the first admission of a tick always
passes; a prompt is charged less its best cached prefix). Preempt-and-requeue: when a head of a class in
``PREEMPTING_CLASSES`` cannot be placed, the engine-installed
``preemptor`` may checkpoint a batch victim out of its slot and requeue
it as a recovery entry, and placement is tried once more.
"""
from __future__ import annotations

import zlib
from collections import deque
from dataclasses import dataclass, field
from typing import Deque, Dict, List, Optional, Tuple

import numpy as np

from repro_torch.core.orchestrator import WorkerEvent
from repro_torch.serving.api import (CLASS_WEIGHTS, PREEMPTING_CLASSES,
                                     SLO_CLASSES, STANDARD, SamplingParams)
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
    recovery: bool = False          # re-admission of a preempted request
    session: Optional[str] = None   # affinity key for placement
    completion_deadline: Optional[float] = None   # last-token deadline
    deadline_flagged: bool = False     # deadline_missed already emitted
    completion_flagged: bool = False   # completion overrun already emitted
    prefix_hit: int = 0             # tokens adopted from the prefix cache
    #                                 at placement (0 = cold admission)
    frames: Optional[np.ndarray] = None   # an encoder-decoder request's
    #                                 frame embeddings (None = zeros)

    @property
    def deadline_key(self) -> float:
        return self.deadline if self.deadline is not None else float("inf")

    @property
    def placement_key(self) -> str:
        """Affinity key for placement: the explicit session verbatim, else
        the session prefix of the rid (``sess-0`` and ``sess-1`` share
        ``sess``), derived here so an explicit key holding '-' is never
        truncated."""
        if self.session is not None:
            return self.session
        return SessionAffinityPolicy.session_key(self.rid)


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


class SessionAffinityPolicy:
    """Session-sticky placement. A session's first placement chooses its
    home, the stable hash of the key onto the AW ring, and pins the
    session there, so every later turn lands where its KV lives. A pinned
    but full home spills to least-loaded for that request only (the pin
    survives). A pinned but dead home re-pins the session to the AW the
    same rule chooses and emits a ``session_repinned`` event."""

    def __init__(self):
        self._fallback = LeastLoadedPolicy()
        self.pins: Dict[str, int] = {}
        self.events: List[WorkerEvent] = []
        self.stats = None            # bound by the owning Gateway
        self.bus = None              # bound by Gateway.attach_bus
        # installed by the prefix-cache plane with the cluster-wide index:
        # (workers, prompt) -> aw_id or None, one global lookup (which may
        # migrate the matched prefix to a free AW first)
        self.global_router = None

    @staticmethod
    def session_key(rid: str) -> str:
        """Session prefix of a request id (``sess-3`` -> ``sess``)."""
        return rid.rsplit("-", 1)[0]

    def _prefix_best(self, workers, prompt) -> Optional[int]:
        """The healthy AW with capacity holding the longest cached prefix
        of ``prompt`` (None without a match or without prefix caches)."""
        if prompt is None:
            return None
        if self.global_router is not None:
            # one cluster-wide lookup answers for every AW
            return self.global_router(workers, prompt)
        best, best_len = None, 0
        for w in workers:
            if w.prefix_cache is None or not w.has_capacity():
                continue
            lcp = w.prefix_cache.match_len(prompt)
            if lcp > best_len:
                best, best_len = w.aw_id, lcp
        return best

    def _choose_home(self, workers, key: str, prompt) -> Optional[int]:
        best = self._prefix_best(workers, prompt)
        if best is not None:
            return best
        home = zlib.crc32(key.encode()) % len(workers)
        if workers[home].has_capacity():
            return home
        return self._fallback(workers, key)

    def __call__(self, workers: List[AttentionWorker], key: str,
                 prompt=None, now: float = 0.0) -> Optional[int]:
        if not key:
            return self._fallback(workers, key)
        pin = self.pins.get(key)
        if pin is not None:
            w = workers[pin]
            if w.alive and w.has_capacity():
                return pin
            if w.alive:
                # home is full but healthy: spill without re-pinning
                return self._fallback(workers, key)
            new = self._choose_home(workers, key, prompt)
            if new is None:
                return None        # nothing placeable now; keep the pin
            self.pins[key] = new
            ev = WorkerEvent(now, "session_repinned", key,
                             f"aw{pin}->aw{new}")
            self.events.append(ev)
            if self.bus is not None:
                self.bus.publish(ev)
            if self.stats is not None:
                self.stats.session_repins += 1
            return new
        choice = self._choose_home(workers, key, prompt)
        if choice is not None:
            self.pins[key] = choice
        return choice


PLACEMENT_POLICIES = {
    "least_loaded": LeastLoadedPolicy,
    "round_robin": RoundRobinPolicy,
    "session_affinity": SessionAffinityPolicy,
}


@dataclass
class GatewayStats:
    enqueued: int = 0
    admitted: int = 0
    blocked_ticks: int = 0          # head-of-queue retries
    requeued: int = 0               # recovery re-admissions queued
    preemptions: int = 0            # victims evicted to place a higher class
    host_syncs: int = 0             # decode-path device->host token drains
    # the prefix-cache plane (serving/prefixcache.py)
    prefix_hits: int = 0            # admissions that adopted a cached prefix
    prefix_misses: int = 0          # cache-eligible admissions without a hit
    prefix_hit_tokens: int = 0      # prompt tokens adopted (prefill skipped)
    prefix_evictions: int = 0       # cached prefixes evicted or trimmed
    prefix_restored: int = 0        # dead-AW prefixes restored on failover
    prefix_global_hits: int = 0     # placements by the cluster-wide index
    prefix_migrated: int = 0        # prefixes moved by checkpoint replay
    session_repins: int = 0         # sessions re-pinned off a dead AW
    queue_delay: Dict[str, float] = field(default_factory=dict)
    by_class: Dict[str, Dict[str, int]] = field(default_factory=dict)

    def bump(self, slo_class: str, key: str, n: int = 1):
        c = self.by_class.setdefault(slo_class, {})
        c[key] = c.get(key, 0) + n

    def class_count(self, slo_class: str, key: str) -> int:
        return self.by_class.get(slo_class, {}).get(key, 0)


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
        if isinstance(policy, SessionAffinityPolicy):
            policy.stats = self.stats
        # token-aware admission: a cap on prompt tokens admitted but not
        # yet prefilled (0 = slot-bound admission only); ``prefill_load``
        # is the engine's probe of the chunked plane's outstanding tokens
        self.prefill_token_cap: int = 0
        self.prefill_load = None
        # the prefix-cache plane's probe, prompt -> best cluster-wide
        # match length (the global index); replaces the per-AW scan
        self.match_probe = None
        # engine-installed hook: (blocked head, now) -> True when a
        # victim's slot was freed and placement should be tried again
        self.preemptor = None
        # the telemetry plane: the engine installs the event bus and,
        # when telemetry is on, the TelemetryPlane
        self.bus = None
        self.telemetry = None
        # the forensics plane: records every external submission (the
        # replay workload) at the enqueue boundary
        self.flightrec = None

    def attach_bus(self, bus):
        """Install the event bus; the placement policy shares it, so
        ``session_repinned`` publishes at emission."""
        self.bus = bus
        self.policy.bus = bus

    def enqueue(self, rid: str, prompt: np.ndarray, max_new: int, *,
                now: float = 0.0, slo_class: str = STANDARD,
                deadline: Optional[float] = None,
                completion_deadline: Optional[float] = None,
                sampling: Optional[SamplingParams] = None,
                session: Optional[str] = None,
                frames: Optional[np.ndarray] = None):
        if slo_class not in SLO_CLASSES:
            raise ValueError(f"unknown slo_class {slo_class!r}: expected "
                             f"one of {SLO_CLASSES}")
        entry = QueuedRequest(rid, np.asarray(prompt, np.int32), max_new,
                              now, slo_class=slo_class, deadline=deadline,
                              sampling=sampling, session=session,
                              completion_deadline=completion_deadline,
                              frames=frames)
        self._insert(entry)
        self.stats.enqueued += 1
        self.stats.bump(slo_class, "enqueued")
        if self.telemetry is not None:
            self.telemetry.on_enqueue(rid, now, slo_class)
        if self.flightrec is not None:
            self.flightrec.on_submit(entry, now)

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

    # -- control-plane signals (serving/controller.py) ----------------------
    def class_depth(self, slo_class: str) -> int:
        return len(self.queues[slo_class])

    def min_queued_deadline(self, slo_class: str) -> Optional[float]:
        """Earliest first-token deadline waiting in one class queue (None
        when the queue is empty or nothing in it carries a deadline)."""
        dls = [e.deadline for e in self.queues[slo_class]
               if e.deadline is not None]
        return min(dls) if dls else None

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

    def _cached_match_len(self, prompt) -> int:
        """The token cap's estimate of how much of ``prompt`` a cached
        prefix would cover: the best match over live AWs (the exact tail
        is charged after placement)."""
        if self.match_probe is not None:
            return self.match_probe(prompt)
        best = 0
        for w in self.workers:
            if w.alive and w.prefix_cache is not None:
                best = max(best, w.prefix_cache.match_len(prompt))
        return best

    def drain_events(self) -> List[WorkerEvent]:
        """Placement events (``session_repinned``) the policy emitted since
        the last drain."""
        evs = getattr(self.policy, "events", None)
        if not evs:
            return []
        self.policy.events = []
        return evs

    def admit(self, now: float = 0.0
              ) -> List[Tuple[QueuedRequest, int, int]]:
        """Weighted dequeue over the class queues; reserves a slot on the
        chosen AW per admission. A blocked head stalls only its own class
        for this tick; a blocked interactive head may first evict a batch
        victim through ``preemptor``. Returns (entry, aw_id, slot)
        triples."""
        admitted = []
        new_tokens = 0                 # fresh prompt tokens admitted now
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
                    # the token cap: recovery entries bypass it (their
                    # committed prefix restores from the store), and the
                    # first admission always passes, so a prompt longer
                    # than the cap cannot deadlock the queue
                    if self.prefill_token_cap and not head.recovery:
                        load = new_tokens + \
                            (self.prefill_load() if self.prefill_load else 0)
                        need = len(head.prompt) - \
                            self._cached_match_len(head.prompt)
                        if load > 0 and \
                                load + need > self.prefill_token_cap:
                            head.retries += 1
                            self.stats.blocked_ticks += 1
                            blocked.add(cls)
                            break
                    # recovery entries restore their own KV: no prompt to
                    # match
                    match_prompt = None if head.recovery else head.prompt
                    aw = self.choose_aw(head.placement_key,
                                        prompt=match_prompt, now=now)
                    if aw is None and cls in PREEMPTING_CLASSES and \
                            self.preemptor is not None:
                        # preempt-and-requeue (the engine's preempt_request
                        # counts the preemption)
                        if self.preemptor(head, now):
                            aw = self.choose_aw(head.placement_key,
                                                prompt=match_prompt, now=now)
                    if aw is None:
                        head.retries += 1
                        self.stats.blocked_ticks += 1
                        blocked.add(cls)
                        break
                    q.popleft()
                    slot, head.prefix_hit = self.workers[aw].take_slot(
                        match_prompt, now)
                    if not head.recovery:
                        # adopted tokens never reach the prefill plane
                        new_tokens += len(head.prompt) - head.prefix_hit
                    if self.workers[aw].prefix_cache is not None and \
                            match_prompt is not None:
                        if head.prefix_hit:
                            self.stats.prefix_hits += 1
                            self.stats.prefix_hit_tokens += head.prefix_hit
                        else:
                            self.stats.prefix_misses += 1
                    self.stats.admitted += 1
                    self.stats.bump(cls, "admitted")
                    self.stats.queue_delay[head.rid] = \
                        self.stats.queue_delay.get(head.rid, 0.0) + \
                        (now - head.t_enqueue)
                    if self.telemetry is not None:
                        self.telemetry.on_admit(
                            head.rid, now, aw, slot, cls, head.recovery,
                            head.prefix_hit, now - head.t_enqueue)
                    admitted.append((head, aw, slot))
                    progressed = True
            if not progressed:
                break
        return admitted
