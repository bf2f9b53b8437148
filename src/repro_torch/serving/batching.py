"""Continuous-batching scheduler: batched prefill + interleaved decode
(port of ``repro.serving.batching``).

Each tick it pulls admitted requests from the Gateway, prefills them in
length-bucketed padded batches, and runs one decode step over all active
slots. Two prefill schemes, chosen from the cache layout:

  * padded (full-attention caches): ``prompt[:-1]`` padded to the bucket
    length; pad entries are scrubbed from the slot (``pos`` = -1) and the
    prompt's last token rides the next decode step;
  * exact (1-token prompts): requests of one prompt length share one
    unpadded call and the first token comes from its last-position logits.

Pad tokens (length and repeated-row padding) are masked out of expert
capacity, and the prefill capacity comes from the real token count, so a
request's routing does not depend on its batch's padding.
"""
from __future__ import annotations

from dataclasses import dataclass, field
from typing import Dict, List, Optional, Tuple

import numpy as np
import torch

from repro_torch.serving.gateway import Gateway, QueuedRequest

PREFILL_BUCKET = 16               # padded-prefill length bucket


def _next_pow2(n: int) -> int:
    p = 1
    while p < n:
        p *= 2
    return p


@dataclass
class PrefillStats:
    calls: int = 0                 # prefill invocations
    requests: int = 0              # real requests prefilled
    rows: int = 0                  # batch rows launched (incl. row padding)
    real_tokens: int = 0           # true prompt tokens processed
    padded_tokens: int = 0         # rows * bucket_len launched
    batch_sizes: List[int] = field(default_factory=list)

    def occupancy(self) -> float:
        return self.real_tokens / self.padded_tokens if self.padded_tokens \
            else 0.0


class ContinuousBatchScheduler:
    """Drives admission, bucketed prefill and decode over the engine's
    shared device state."""

    def __init__(self, engine, gateway: Gateway):
        self.engine = engine
        self.gateway = gateway
        self.stats = PrefillStats()

    # -- admission ----------------------------------------------------------
    def admit(self, now: float = 0.0) -> List[str]:
        """Admit as many queued requests as placement allows; returns the
        rids installed this tick."""
        fresh = self.gateway.admit(now)
        for group in self._bucket_groups(fresh):
            self._prefill_group(group, now)
        return [q.rid for q, _, _ in fresh]

    def _bucket_groups(self, fresh):
        """(padded, bucket_len) groups for the padded scheme, (exact,
        prompt_len) otherwise; each capped at max_batch rows."""
        eng = self.engine
        groups: Dict[Tuple[bool, int], list] = {}
        for q, aw, slot in fresh:
            n = len(q.prompt)
            if eng.prefill_paddable and n >= 2:
                key = (True, -((n - 1) // -PREFILL_BUCKET) * PREFILL_BUCKET)
            else:
                key = (False, n)
            groups.setdefault(key, []).append((q, aw, slot))
        out = []
        cap = eng.ecfg.max_batch
        for key, entries in sorted(groups.items(), key=lambda kv: kv[0]):
            for i in range(0, len(entries), cap):
                out.append((key, entries[i:i + cap]))
        return out

    def _prefill_group(self, group, now: float):
        (padded, length), entries = group
        eng = self.engine
        n_real = len(entries)
        rows = _next_pow2(n_real)
        toks = np.zeros((rows, length), np.int32)
        mask = np.zeros((rows, length), bool)
        pre_lens = []
        for i, (q, _, _) in enumerate(entries):
            pre = q.prompt[:-1] if padded else q.prompt
            toks[i, :len(pre)] = pre
            mask[i, :len(pre)] = True
            pre_lens.append(len(pre))
        for i in range(n_real, rows):           # row padding: repeat row 0
            toks[i] = toks[0]

        # prefill runs on the request's own (healthy) AW: other AWs'
        # health must not mask its tokens; EW health still applies
        rs = eng.route_state._replace(
            aw_health=torch.ones_like(eng.route_state.aw_health))
        dev = eng.device
        last_logits, req_cache, _ = eng.api.prefill(
            eng.params, torch.as_tensor(toks, device=dev), rs,
            eng.ecfg.max_seq, capacity=eng.prefill_capacity(sum(pre_lens)),
            mask=torch.as_tensor(mask, device=dev))
        firsts = None
        if not padded:
            firsts = eng.decode_plane.sample_rows(
                last_logits, [q for q, _, _ in entries],
                [len(q.prompt) - 1 for q, _, _ in entries])

        self.stats.calls += 1
        self.stats.requests += n_real
        self.stats.rows += rows
        self.stats.real_tokens += sum(pre_lens)
        self.stats.padded_tokens += rows * length
        self.stats.batch_sizes.append(n_real)

        for i, (q, aw, slot) in enumerate(entries):
            state = eng.layout.request_state(req_cache, i)
            if padded and pre_lens[i] < length:
                state = eng.layout.scrub_request_state(state, pre_lens[i])
            eng.layout.write_request_state(eng.cache, slot, state)
            first = int(firsts[i]) if not padded else None
            self._install_fresh(q, aw, slot, now, padded=padded, first=first)

    def _install_fresh(self, q: QueuedRequest, aw: int, slot: int,
                       now: float, *, padded: bool, first: Optional[int]):
        eng = self.engine
        n = len(q.prompt)
        st = eng.make_request_state(q, slot)
        st._aw = aw
        st.t_admit = now
        if padded:
            # the prompt's last token rides the next decode step
            st.pos = n - 1
            st.next_input = int(q.prompt[-1])
        else:
            st.tokens = [int(first)]
            st.pos = n
            st.next_input = int(first)
            st.t_first_token = now
            if len(st.tokens) >= st.max_new:
                st.done = True
                st.t_done = now
        eng.requests[q.rid] = st

    # -- decode -------------------------------------------------------------
    def step(self, now: Optional[float] = None) -> Dict[str, List[int]]:
        """One iteration: an admission pass when anything waits, then one
        decode step over all active slots. Returns {rid: new_tokens}."""
        eng = self.engine
        t_now = now if now is not None else float(eng.steps)
        if self.gateway.depth():
            self.admit(t_now)
        act = eng.active_requests()
        if not act:
            return {}
        return self._step_single(act, t_now)

    def _step_single(self, act, t_now: float) -> Dict[str, List[int]]:
        """One decode dispatch + device sampling; only the [B] token
        vector crosses to the host."""
        eng = self.engine
        b = eng.ecfg.max_batch
        tokens = np.zeros((b,), np.int32)
        # inactive rows carry pos -1: no cache write, no capacity claim
        pos = np.full((b,), -1, np.int32)
        for r in act:
            tokens[r.slot] = r.next_input
            pos[r.slot] = r.pos
        dev = eng.device
        pos_dev = torch.as_tensor(pos, device=dev)
        logits, eng.cache, _ = eng.api.decode(
            eng.params, torch.as_tensor(tokens, device=dev), pos_dev,
            eng.cache, eng.route_state)
        toks = eng.decode_plane.sample(logits, pos_dev).cpu().numpy()
        self.gateway.stats.host_syncs += 1

        out: Dict[str, List[int]] = {}
        for r in act:
            nxt = int(toks[r.slot])
            r.pos += 1
            r.tokens.append(nxt)
            r.next_input = nxt
            if r.t_first_token < 0:
                r.t_first_token = t_now
            out[r.rid] = [nxt]
            if len(r.tokens) >= r.max_new or r.pos >= eng.ecfg.max_seq - 1:
                r.done = True
                r.t_done = t_now
        eng.steps += 1
        return out
