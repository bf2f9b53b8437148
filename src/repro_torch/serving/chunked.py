"""Chunked-prefill plane: token-budget scheduling and resumable prefill
(port of ``repro.serving.chunked``).

  * **Token-budget planner**: each tick packs at most
    ``chunk_token_budget`` real prompt tokens of prefill work next to the
    decode step, so a long-prompt burst cannot freeze every co-resident
    decode for a whole-prompt prefill.
  * **Chunk shapes**: prompt slices are padded to ``CHUNK_MIN`` * 2^i
    tokens (capped at the largest power of two <= max_seq), and one call
    runs over the full slot-partitioned cache: rows not in the chunk
    (live decode slots, other requests) carry position -1 and are
    untouched.
  * **Resumable streams**: per-request progress lives in
    ``RequestState.prefill_cursor``. Each chunk's KV segments stream to
    the CheckpointStore (§6.1 extended to prefill), so when an AW dies
    mid-prefill, or a preemption evicts the request, recovery restores the
    committed chunk prefix and resumes the stream from the cursor instead
    of from token 0.

Only full-attention cache families run chunks (cache slot == absolute
position); the engine checks.
"""
from __future__ import annotations

from dataclasses import dataclass, field
from typing import Dict, List, Tuple

import numpy as np
import torch

CHUNK_MIN = 8          # the smallest chunk shape, as in the reference

def _pow2_at_least(n: int) -> int:
    p = 1
    while p < n:
        p *= 2
    return p


@dataclass
class ChunkedPrefillStats:
    calls: int = 0                 # chunk calls
    chunks: int = 0                # (request, chunk) pairs processed
    requests: int = 0              # prefill streams started
    resumed: int = 0               # streams resumed after an AW failure
    real_tokens: int = 0           # true prompt tokens prefilled (incl.
    #                                recompute after recovery)
    launched_tokens: int = 0       # rows * shape launched per call
    shapes: List[int] = field(default_factory=list)   # distinct shapes used
    prefilled_tokens: Dict[str, int] = field(default_factory=dict)
    restored_tokens: Dict[str, int] = field(default_factory=dict)

    def occupancy(self) -> float:
        return self.real_tokens / self.launched_tokens \
            if self.launched_tokens else 0.0

    def snapshot(self) -> dict:
        return {"calls": self.calls, "chunks": self.chunks,
                "requests": self.requests, "resumed": self.resumed,
                "real_tokens": self.real_tokens,
                "occupancy": self.occupancy(),
                "shapes": sorted(self.shapes)}


@dataclass
class _PrefillJob:
    rid: str
    prompt: np.ndarray
    aw: int
    slot: int
    n_pre: int                     # tokens to prefill (= len(prompt) - 1;
    #                                the last token rides the decode step)


class ChunkedPrefillPlane:
    """Budgeted, resumable prefill over the engine's shared cache."""

    def __init__(self, engine, budget: int):
        self.engine = engine
        self.budget = max(1, budget)
        # the biggest chunk shape is the largest power of two <= max_seq,
        # and per-tick takes are capped so _shape_for never rounds past it
        self.max_shape = 1
        while self.max_shape * 2 <= engine.ecfg.max_seq:
            self.max_shape *= 2
        self.min_chunk = min(CHUNK_MIN, self.max_shape)
        self.jobs: Dict[str, _PrefillJob] = {}   # rid -> job, FIFO order
        self.stats = ChunkedPrefillStats()

    def set_budget(self, budget: int) -> int:
        """The control plane's actuator: retarget the per-tick token
        budget, a host int ``plan()`` reads each tick. The chunk shapes
        (powers of two capped at ``max_shape``) do not depend on it, and
        every dense call runs on fixed 128-row blocks, so a new budget
        changes neither a stream's bits nor any graph. Returns the clamped
        value now in effect."""
        self.budget = max(1, int(budget))
        return self.budget

    # ------------------------------------------------------------------
    # admission-side API
    # ------------------------------------------------------------------
    def outstanding_tokens(self) -> int:
        """Prefill tokens admitted but not yet processed."""
        eng = self.engine
        return sum(j.n_pre - eng.requests[j.rid].prefill_cursor
                   for j in self.jobs.values() if j.rid in eng.requests)

    def start(self, q, aw: int, slot: int, now: float):
        """Open a fresh prefill stream for an admitted request.

        A prefix-cache hit (``q.prefix_hit`` > 0) means the slot already
        holds the prefix's KV (the donor's slot, or shared pages): the
        stale tail is scrubbed instead of clearing the slot, the stream
        starts at ``prefill_cursor = hit``, and the adopted prefix is
        re-checkpointed into this request's own log through the bulk range
        path, so its recovery never depends on the donor. A fully cached
        prompt goes straight to decode."""
        eng = self.engine
        n = len(q.prompt)
        hit = min(q.prefix_hit, n - 1)
        if hit > 0:
            eng._kv_scrub_slot(slot, hit)
        else:
            eng._kv_clear_slot(slot)
        r = eng.make_request_state(q, slot)
        r._aw = aw
        r.t_admit = now
        r.prefilling = True
        r.prefill_cursor = hit
        eng.requests[q.rid] = r
        if eng.ecfg.checkpoint:
            eng.aws[aw].checkpointer.register(q.rid, prompt_len=n)
            if hit > 0:
                # gathered on the current stream after the scrub (and, paged,
                # the boundary page's copy), so the log gets the adopter's KV
                eng._bulk_checkpoint_group([(r, 0, hit)])
                eng.aws[aw].checkpointer.flush()
        self.stats.requests += 1
        self.stats.prefilled_tokens.setdefault(q.rid, 0)
        if eng.telemetry is not None:
            eng.telemetry.on_prefill_start(q.rid, now, hit, n)
        if hit >= n - 1:
            # the whole prompt prefix is cached: the next decode step emits
            # the first token
            self._finalize(r)
            return
        self.jobs[q.rid] = _PrefillJob(q.rid, np.asarray(q.prompt), aw, slot,
                                       n_pre=n - 1)

    def resume(self, r, aw: int, slot: int, cursor: int):
        """Re-open a stream after mid-prefill failure recovery: the
        committed prefix [0, cursor) is already restored in the slot; only
        [cursor, n_pre) remains to compute."""
        n_pre = len(r.prompt) - 1
        r.prefill_cursor = cursor
        self.stats.resumed += 1
        if cursor >= n_pre:        # the whole prompt prefix was committed
            self._finalize(r)
            return
        r.prefilling = True
        self.jobs[r.rid] = _PrefillJob(r.rid, np.asarray(r.prompt), aw, slot,
                                       n_pre=n_pre)

    def drop(self, rid: str):
        self.jobs.pop(rid, None)

    def drop_aw(self, aw_id: int):
        """AW crash: its in-flight prefill streams die with it (recovery
        entries re-open them through the Gateway)."""
        for rid in [r for r, j in self.jobs.items() if j.aw == aw_id]:
            del self.jobs[rid]

    # ------------------------------------------------------------------
    # the iteration planner
    # ------------------------------------------------------------------
    def _shape_for(self, take: int) -> int:
        return min(max(self.min_chunk, _pow2_at_least(take)),
                   self.max_shape)

    def plan(self) -> List[Tuple[_PrefillJob, int]]:
        """Pack (job, take) pairs under the token budget, FIFO over the
        in-flight streams. Every planned job advances by at least one
        token, so a budget smaller than one chunk still makes progress."""
        eng = self.engine
        out: List[Tuple[_PrefillJob, int]] = []
        left = self.budget
        for job in list(self.jobs.values()):
            if left <= 0:
                break
            r = eng.requests.get(job.rid)
            if r is None or r.paused:
                continue
            rem = job.n_pre - r.prefill_cursor
            if rem <= 0:
                continue
            take = min(rem, left, self.max_shape)
            out.append((job, take))
            left -= take
        return out

    def tick(self, now: float) -> int:
        """Run one iteration of budgeted prefill: one chunk call per
        distinct shape. Returns the real prompt tokens processed."""
        planned = self.plan()
        if not planned:
            return 0
        by_shape: Dict[int, List[Tuple[_PrefillJob, int]]] = {}
        for job, take in planned:
            by_shape.setdefault(self._shape_for(take), []).append((job, take))
        done = 0
        for shape in sorted(by_shape):
            done += self._run_chunk_call(shape, by_shape[shape], now)
        return done

    # ------------------------------------------------------------------
    # one chunk call (one shape, >= 1 requests)
    # ------------------------------------------------------------------
    def _run_chunk_call(self, shape: int,
                        entries: List[Tuple[_PrefillJob, int]],
                        now: float) -> int:
        eng = self.engine
        rows = eng.ecfg.max_batch
        toks = np.zeros((rows, shape), np.int32)
        pos = np.full((rows, shape), -1, np.int32)
        real = 0
        for job, take in entries:
            c = eng.requests[job.rid].prefill_cursor
            toks[job.slot, :take] = job.prompt[c:c + take]
            pos[job.slot, :take] = np.arange(c, c + take, dtype=np.int32)
            real += take
            # paged: map the pages the chunk writes before the call
            eng._kv_ensure(job.slot, c + take)

        # prefill runs on the request's own (healthy) AW: other AWs'
        # health must not mask its tokens; EW health still applies
        rs = eng.route_state._replace(
            aw_health=torch.ones_like(eng.route_state.aw_health))
        dev = eng.device
        eng.cache, load = eng.api.prefill_chunk(
            eng.params, torch.as_tensor(toks, device=dev),
            torch.as_tensor(pos, device=dev), eng.cache, rs,
            capacity=eng.prefill_capacity(real))
        if eng.collect_load:
            eng.note_dispatch_load(load.cpu().numpy())

        self.stats.calls += 1
        self.stats.chunks += len(entries)
        self.stats.real_tokens += real
        self.stats.launched_tokens += rows * shape
        if shape not in self.stats.shapes:
            self.stats.shapes.append(shape)

        for job, take in entries:
            r = eng.requests[job.rid]
            c = r.prefill_cursor
            self._checkpoint_chunk(job, c, take)
            r.prefill_cursor = c + take
            self.stats.prefilled_tokens[job.rid] = \
                self.stats.prefilled_tokens.get(job.rid, 0) + take
            if eng.telemetry is not None:
                eng.telemetry.on_prefill_chunk(job.rid, now, take, shape)
            if eng.flightrec is not None:
                eng.flightrec.on_chunk(job.rid, now, take, shape, c)
            if r.prefill_cursor >= job.n_pre:
                del self.jobs[job.rid]
                self._finalize(r)
        return real

    def _checkpoint_chunk(self, job: _PrefillJob, start: int, take: int):
        """Stream the chunk's ``take`` KV segments through the bulk path:
        the token value of position t is the next prompt token."""
        eng = self.engine
        if not eng.ecfg.checkpoint:
            return
        seg_stack = eng.layout.extract_range(eng.cache, job.slot, start,
                                             take)
        eng._ck_range(eng.aws[job.aw].checkpointer, job.rid, start,
                      seg_stack, list(job.prompt[start + 1:start + take + 1]))

    def _finalize(self, r):
        """Prefill complete: hand the request to the decode plane. The
        prompt's last token rides the next decode step, which emits the
        first generated token."""
        r.prefilling = False
        r.pos = len(r.prompt) - 1
        r.next_input = int(r.prompt[-1])
        tel = self.engine.telemetry
        if tel is not None:
            tel.on_prefill_done(r.rid, tel.now)
