"""Asynchronous, incremental KV-cache checkpointing and per-request
restoration (paper §6; port of ``repro.core.checkpoint``).

The store mirrors the paper's RDMA design at the semantic level:

  * ``register_request`` — an AW announces a request; the store keeps its
    log (a dict keyed by request id).
  * ``async_update`` — one-sided write of one token's KV segment, tagged
    with a monotonically increasing *sequence number*. Writes may arrive
    out of order; the store only advances the **commit watermark** over a
    contiguous seq prefix (the "async log + commit record" design, §6.1).
  * ``restore_request`` — the committed token index and the KV segments of
    one request, which the engine writes into a healthy AW's cache slot
    (per-request restoration, §6.2). Uncommitted (gap) suffixes are never
    restored.

A segment is a list of host (CPU) tensors, one per cache leaf, holding
exactly the bits the cache held (bfloat16 included), so a restore writes
back what was checkpointed. The store never looks inside a segment.
"""
from __future__ import annotations

from dataclasses import dataclass, field
from typing import Dict, List, Tuple

import numpy as np


def _seg_nbytes(segment) -> int:
    if isinstance(segment, (list, tuple)):
        return sum(_seg_nbytes(s) for s in segment)
    nbytes = getattr(segment, "nbytes", None)      # numpy, torch >= 2.1
    return int(nbytes) if nbytes is not None else \
        segment.numel() * segment.element_size()


@dataclass
class _RequestLog:
    segments: Dict[int, list] = field(default_factory=dict)
    token_values: Dict[int, int] = field(default_factory=dict)
    # seq_no -> token_idx, for watermark accounting
    seq_to_token: Dict[int, int] = field(default_factory=dict)
    next_seq: int = 0              # AW-side monotonically increasing WR id
    committed_seq: int = -1        # highest contiguous seq received
    prompt_len: int = 0
    aw_id: int = -1

    @property
    def committed_token(self) -> int:
        """Highest token index restorable (contiguous-prefix rule)."""
        if self.committed_seq < 0:
            return -1
        return max((self.seq_to_token[s]
                    for s in range(self.committed_seq + 1)), default=-1)


@dataclass
class StoreStats:
    bytes_written: int = 0
    bytes_restored: int = 0
    updates: int = 0
    out_of_order: int = 0
    restores: int = 0


class CheckpointStore:
    """Host-side checkpoint store service."""

    def __init__(self):
        self._logs: Dict[str, _RequestLog] = {}
        self._aw_requests: Dict[int, set] = {}
        self.stats = StoreStats()

    # -- registration ------------------------------------------------------
    def register_request(self, request_id: str, aw_id: int,
                         prompt_len: int = 0):
        log = self._logs.setdefault(request_id, _RequestLog())
        log.aw_id = aw_id
        log.prompt_len = prompt_len
        self._aw_requests.setdefault(aw_id, set()).add(request_id)

    def reassign(self, request_id: str, new_aw: int):
        log = self._logs[request_id]
        self._aw_requests.get(log.aw_id, set()).discard(request_id)
        log.aw_id = new_aw
        self._aw_requests.setdefault(new_aw, set()).add(request_id)

    def release(self, request_id: str):
        log = self._logs.pop(request_id, None)
        if log is not None:
            self._aw_requests.get(log.aw_id, set()).discard(request_id)

    def rename(self, old: str, new: str):
        """Re-key a log: a finished request's log becomes its prefix-cache
        entry's restoration backing under a reserved key, so the rid can
        be reused by a fresh request without inheriting the cached
        segments. The segments move with the log (their host blocks stay
        held until the last log that views them is released)."""
        if new in self._logs:
            raise KeyError(f"checkpoint log {new!r} exists")
        log = self._logs.pop(old)
        self._logs[new] = log
        s = self._aw_requests.get(log.aw_id)
        if s is not None:
            s.discard(old)
            s.add(new)

    # -- write path ----------------------------------------------------------
    def next_seq(self, request_id: str) -> int:
        log = self._logs[request_id]
        s = log.next_seq
        log.next_seq += 1
        return s

    def async_update(self, request_id: str, token_idx: int, segment,
                     seq_no: int, token_value: int = -1):
        """One-sided write; tolerates out-of-order arrival. ``segment`` is
        a list of host tensors (one per cache leaf); ``token_value`` is the
        next decode input after ``token_idx`` (the store hands it back at
        restoration so decode can resume, §6.2)."""
        log = self._logs[request_id]
        log.segments[token_idx] = segment
        log.token_values[token_idx] = token_value
        log.seq_to_token[seq_no] = token_idx
        self.stats.updates += 1
        self.stats.bytes_written += _seg_nbytes(segment)
        if seq_no != log.committed_seq + 1:
            self.stats.out_of_order += 1
        # advance the commit watermark over the contiguous prefix
        while (log.committed_seq + 1) in log.seq_to_token:
            log.committed_seq += 1

    # -- read / recovery path -----------------------------------------------
    def committed_token(self, request_id: str) -> int:
        return self._logs[request_id].committed_token

    def active_requests_on(self, aw_id: int) -> List[str]:
        return sorted(self._aw_requests.get(aw_id, set()))

    def restore_request(self, request_id: str
                        ) -> Tuple[int, int, Dict[int, list]]:
        """Per-request restoration: (committed token idx, token value at
        that idx, {token_idx: segment}), only segments within the committed
        prefix (§6.1).

        Restoration also truncates the log to the commit record: WRs past
        the watermark either died with the failed AW or describe state the
        restored request is about to recompute, so the new owner's stream
        restarts at ``committed_seq + 1``. Without this a dropped WR's
        sequence number would leave a permanent gap and no later write
        could ever commit."""
        log = self._logs[request_id]
        c = log.committed_token
        committed_tokens = {log.seq_to_token[s]
                            for s in range(log.committed_seq + 1)}
        segs = {t: log.segments[t] for t in sorted(committed_tokens)
                if t in log.segments}
        log.seq_to_token = {s: t for s, t in log.seq_to_token.items()
                            if s <= log.committed_seq}
        log.segments = dict(segs)
        log.token_values = {t: v for t, v in log.token_values.items()
                            if t in committed_tokens}
        log.next_seq = log.committed_seq + 1
        self.stats.restores += 1
        self.stats.bytes_restored += sum(_seg_nbytes(s)
                                         for s in segs.values())
        return c, log.token_values.get(c, -1), segs


# --------------------------------------------------------------------------
# AW-side checkpointer
# --------------------------------------------------------------------------

class KVCheckpointer:
    """AW-side incremental checkpointing of KV segments.

    After each decode step (or prefill chunk) the engine hands over the
    segments the step just wrote. Each gets its sequence number at once
    and is delivered at the next ``flush`` (or as soon as more than
    ``reorder_window`` are pending); ``reorder_window`` > 0 shuffles each
    delivery, to exercise the store's out-of-order tolerance (tests)."""

    def __init__(self, store: CheckpointStore, aw_id: int,
                 reorder_window: int = 0, seed: int = 0):
        self.store = store
        self.aw_id = aw_id
        self.reorder_window = reorder_window
        self._rng = np.random.default_rng(seed)
        self._pending: List[Tuple[str, int, list, int, int]] = []

    def register(self, request_id: str, prompt_len: int = 0):
        self.store.register_request(request_id, self.aw_id, prompt_len)

    def checkpoint_token(self, request_id: str, token_idx: int, segment,
                         token_value: int = -1):
        seq = self.store.next_seq(request_id)
        self._pending.append((request_id, token_idx, segment, seq,
                              token_value))
        if len(self._pending) > self.reorder_window:
            self.flush()

    def checkpoint_range(self, request_id: str, start: int, seg_stack,
                         token_values: List[int]):
        """Stream the ``len(token_values)`` contiguous token segments a
        prefill chunk (or a bulk copy) produced, starting at token index
        ``start``. ``seg_stack`` holds one tensor per cache leaf with a
        leading per-token axis. Each token gets its own sequence number,
        so the store's contiguous-prefix watermark applies unchanged."""
        for i, tv in enumerate(token_values):
            self.checkpoint_token(request_id, start + i,
                                  [leaf[i] for leaf in seg_stack],
                                  token_value=int(tv))

    def checkpoint_blocks(self, request_id: str, start: int, seg_stack,
                          token_values: List[int], page_tokens: int):
        """Block-granular variant for paged AWs: split the token run at
        page boundaries, so each ``checkpoint_range`` batch covers at most
        one KV page. The store's segments stay token-granular and
        layout-independent: paged checkpoints restore onto contiguous
        engines and vice versa."""
        n = len(token_values)
        t = 0
        while t < n:
            take = min(n - t, page_tokens - ((start + t) % page_tokens))
            self.checkpoint_range(request_id, start + t,
                                  [leaf[t:t + take] for leaf in seg_stack],
                                  token_values[t:t + take])
            t += take

    def drop_pending(self) -> int:
        """Crash path: WRs not yet handed to the store die with the AW.
        Returns the number of segments lost (they stay uncommitted, so
        recovery resumes from the last committed token)."""
        n = len(self._pending)
        self._pending = []
        return n

    def drop_request(self, request_id: str) -> int:
        """Teardown path (cancel / release): discard this request's pending
        WRs without touching other requests' streams. Only valid right
        before the store log itself is released (the dropped WRs' sequence
        numbers are already allocated). Returns the number discarded."""
        kept = [p for p in self._pending if p[0] != request_id]
        n = len(self._pending) - len(kept)
        self._pending = kept
        return n

    def pending_for(self, request_id: str) -> int:
        return sum(1 for p in self._pending if p[0] == request_id)

    def flush(self):
        pending = self._pending
        if self.reorder_window and len(pending) > 1:
            idx = self._rng.permutation(len(pending))
            pending = [pending[i] for i in idx]
        for rid, tok, seg, seq, tv in pending:
            self.store.async_update(rid, tok, seg, seq, token_value=tv)
        self._pending = []
