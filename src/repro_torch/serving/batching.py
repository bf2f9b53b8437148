"""Continuous-batching scheduler: batched prefill, per-request
restoration and interleaved decode (port of ``repro.serving.batching``).

Each tick it pulls admitted requests from the Gateway, restores recovery
entries from the checkpoint store, hands prompts of 2 or more tokens to
the chunked-prefill plane when it is on (or else prefills them in
length-bucketed padded batches), runs the plane's budgeted slice, and
then one decode dispatch over all active slots: one step, or a segment
of ``decode_segment_len`` steps (serving/decode_loop.py). Whole-prompt schemes, chosen
from the cache layout:

  * padded (full-attention caches): ``prompt[:-1]`` padded to the bucket
    length; pad entries are scrubbed from the slot (``pos`` = -1) and the
    prompt's last token rides the next decode step;
  * exact (1-token prompts): requests of one prompt length share one
    unpadded call and the first token comes from its last-position logits.

Every KV write is checkpointed (unless ``checkpoint`` is False): the
whole-prompt prefix at install, each chunk as it lands
(serving/chunked.py), each decode step's or segment's tokens in one
batched gather and one device-to-host copy.

Pad tokens (length and repeated-row padding) are masked out of expert
capacity, and the prefill capacity comes from the real token count, so a
request's routing does not depend on its batch's padding. An
encoder-decoder's prefill also takes each request's frames (zeros when it
has none; padding rows repeat the first request's).
"""
from __future__ import annotations

from dataclasses import dataclass, field
from typing import Dict, List, Optional, Tuple

import numpy as np
import torch

from repro_torch.serving.gateway import Gateway, QueuedRequest
from repro_torch.serving.kvcache import CacheLayout


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

    def mean_batch(self) -> float:
        return float(np.mean(self.batch_sizes)) if self.batch_sizes else 0.0

    def snapshot(self) -> dict:
        return {"calls": self.calls, "requests": self.requests,
                "occupancy": self.occupancy(),
                "mean_batch": self.mean_batch()}


class ContinuousBatchScheduler:
    """Drives admission, bucketed prefill and decode over the engine's
    shared device state."""

    def __init__(self, engine, gateway: Gateway, bucket: int = 16):
        self.engine = engine
        self.gateway = gateway
        self.bucket = max(1, bucket)     # padded-prefill length bucket
        self.stats = PrefillStats()

    # -- admission ----------------------------------------------------------
    def admit(self, now: float = 0.0) -> List[str]:
        """Admit as many queued requests as placement allows; returns the
        rids installed this tick (fresh and recovered)."""
        eng = self.engine
        fresh: List[Tuple[QueuedRequest, int, int]] = []
        installed: List[str] = []
        for q, aw, slot in self.gateway.admit(now):
            if q.recovery:
                self._install_recovery(q, aw, slot, now)
            elif eng.chunked is not None and len(q.prompt) >= 2:
                # the prompt streams through budgeted chunks on later ticks
                eng.chunked.start(q, aw, slot, now)
            else:
                fresh.append((q, aw, slot))
            installed.append(q.rid)
        for group in self._bucket_groups(fresh):
            self._prefill_group(group, now)
        return installed

    def _bucket_groups(self, fresh):
        """(padded, bucket_len) groups for the padded scheme, (exact,
        prompt_len) otherwise; each capped at max_batch rows."""
        eng = self.engine
        groups: Dict[Tuple[bool, int], list] = {}
        for q, aw, slot in fresh:
            n = len(q.prompt)
            if eng.prefill_paddable and n >= 2:
                key = (True, -((n - 1) // -self.bucket) * self.bucket)
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
        kw = {}
        if eng.cfg.is_encdec:
            # each request's frames (zeros when it has none); padding rows
            # repeat the first request's
            zeros = np.zeros((eng.cfg.encoder_seq, eng.cfg.d_model),
                             np.float32)
            frames = [q.frames if q.frames is not None else zeros
                      for q, _, _ in entries]
            frames += [frames[0]] * (rows - n_real)
            kw["frames"] = torch.as_tensor(np.stack(frames), device=dev)
        last_logits, req_cache, load = eng.api.prefill(
            eng.params, torch.as_tensor(toks, device=dev), rs,
            eng.ecfg.max_seq, capacity=eng.prefill_capacity(sum(pre_lens)),
            mask=torch.as_tensor(mask, device=dev), **kw)
        if eng.collect_load:
            eng.note_dispatch_load(load.cpu().numpy())
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
            # the prefill cache is contiguous whatever the engine's layout;
            # the engine's layout writes it into the slot (a paged engine
            # maps the prefilled prefix's pages first)
            state = CacheLayout.request_state(req_cache, i)
            if padded and pre_lens[i] < length:
                state = CacheLayout.scrub_request_state(state, pre_lens[i])
            eng._kv_ensure(slot, pre_lens[i])
            eng.layout.write_request_state(eng.cache, slot, state)
            first = int(firsts[i]) if not padded else None
            self._install_fresh(q, aw, slot, now, padded=padded, first=first,
                                n_prefilled=pre_lens[i])

    def _install_fresh(self, q: QueuedRequest, aw: int, slot: int,
                       now: float, *, padded: bool, first: Optional[int],
                       n_prefilled: int):
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
        if eng.telemetry is not None:
            eng.telemetry.on_whole_prefill(
                q.rid, now, n, "padded" if padded else "exact")

        if eng.ecfg.checkpoint:
            eng.aws[aw].checkpointer.register(q.rid, prompt_len=n)
            if n_prefilled > 0:
                eng._bulk_checkpoint_group([(st, 0, n_prefilled)])
            eng.aws[aw].checkpointer.flush()

    # -- per-request restoration (recovery admissions) ----------------------
    def _install_recovery(self, q: QueuedRequest, aw: int, slot: int,
                          now: float):
        """§6.2: write the committed KV prefix into the new slot and rewind
        the request to the committed token. A request caught mid-prefill
        re-enters the chunked plane with its cursor at the commit
        watermark: only the uncommitted tail of the prompt is recomputed."""
        eng = self.engine
        r = eng.requests.get(q.rid)
        if r is None:              # released while waiting for recovery
            eng.aws[aw].slots.release(slot)
            return
        committed, tok_val, segs = eng.store.restore_request(q.rid)
        eng._kv_clear_slot(slot)
        if segs:
            # paged: map pages covering the restored prefix first
            eng._kv_ensure(slot, max(segs) + 1)
            eng.layout.write_token_segments(eng.cache, slot, list(segs),
                                            list(segs.values()))
        r.slot = slot
        r._aw = aw
        r.paused = False
        r.queued_for_recovery = False
        r.t_admit = now
        eng.store.reassign(q.rid, aw)
        # re-bind sampling to the (possibly different) recovery slot; the
        # counter-based draw is slot-independent, so the replayed stream is
        # the same wherever the request lands
        eng.decode_plane.bind(r)
        if eng.telemetry is not None:
            eng.telemetry.on_restore(q.rid, now, len(segs), r.prefilling)
        if eng.flightrec is not None:
            eng.flightrec.on_restore(q.rid, now, len(segs), r.prefilling)

        if r.prefilling:
            # resume the chunk stream after the restored prefix (committed
            # is -1 when the failure hit before any chunk was committed)
            eng.chunked.stats.restored_tokens[q.rid] = \
                eng.chunked.stats.restored_tokens.get(q.rid, 0) + len(segs)
            eng.chunked.resume(r, aw, slot, committed + 1)
            return

        n_prompt = len(r.prompt)
        n_gen = max(0, committed + 2 - n_prompt)
        r.tokens = r.tokens[:n_gen]
        r.pos = committed + 1
        if committed + 1 < n_prompt:
            r.next_input = int(r.prompt[committed + 1])
        elif tok_val >= 0:
            r.next_input = int(tok_val)
        elif r.tokens:
            r.next_input = int(r.tokens[-1])

    # -- decode -------------------------------------------------------------
    def step(self, now: Optional[float] = None) -> Dict[str, List[int]]:
        """One iteration: the control plane's decision pass (when it is
        on), an admission pass when anything waits, deadline accounting,
        the flight recorder's tick, a budgeted slice of chunked prefill
        (when the plane is on), then one decode
        dispatch over all active slots: a step, or a segment of
        ``decode_segment_len`` steps. Returns {rid: new_tokens}."""
        eng = self.engine
        t_now = now if now is not None else float(eng.steps)
        if eng.controller is not None:
            # the control plane's decision pass comes before admission:
            # scale and rebalance requests land on the orchestrator's
            # clock, and the chunk budget is set before this tick's plan
            eng.controller.tick(t_now)
        if self.gateway.depth():
            self.admit(t_now)
        eng.check_deadlines(t_now)
        if eng.flightrec is not None:
            # the forensics plane: drain the bus through the recorder's
            # cursor, fingerprint when due, advance the watchdogs (host
            # bookkeeping only)
            eng.flightrec.tick(t_now)
        if eng.chunked is not None:
            eng.chunked.tick(t_now)
        act = eng.active_requests()
        if not act:
            return {}
        if eng.decode_plane.seg_len > 1:
            return self._step_segment(act, t_now)
        return self._step_single(act, t_now)

    def _step_single(self, act, t_now: float) -> Dict[str, List[int]]:
        """One decode step + device sampling (a graph replay on the card);
        the [B] token vector and the step's checkpoint segments cross to
        the host."""
        eng = self.engine
        # inactive rows carry pos -1: no cache write, no capacity claim, so
        # a decode step never touches a slot that is mid-chunked-prefill
        toks = eng.decode_plane.run(act, 1)[0]
        self.gateway.stats.host_syncs += 1
        if eng.collect_load:
            eng.note_dispatch_load(eng.decode_plane.host_loads[0])

        # the KV the step wrote for every checkpointed request: one batched
        # gather, one device-to-host copy. A request on a dead AW is
        # paused, unless the store never knew it (checkpoint=False), and
        # then it has nothing to stream
        ck_reqs = [r for r in act
                   if eng.ecfg.checkpoint and eng.aws[r.aw].alive]
        stacked = eng.layout.extract_tokens(
            eng.cache, [r.slot for r in ck_reqs],
            [r.pos for r in ck_reqs]) if ck_reqs else None
        ck = {r.rid: i for i, r in enumerate(ck_reqs)}

        out: Dict[str, List[int]] = {}
        for r in act:
            nxt = int(toks[r.slot])
            if r.rid in ck:
                i = ck[r.rid]
                eng.aws[r.aw].checkpointer.checkpoint_token(
                    r.rid, r.pos, [leaf[i] for leaf in stacked],
                    token_value=nxt)
            r.pos += 1
            r.tokens.append(nxt)
            r.next_input = nxt
            if r.t_first_token < 0:
                r.t_first_token = t_now
            out[r.rid] = [nxt]
            if len(r.tokens) >= r.max_new or r.pos >= eng.ecfg.max_seq - 1:
                r.done = True
                r.t_done = t_now
        for w in eng.aws:
            w.checkpointer.flush()
        eng.steps += 1
        return out

    def _step_segment(self, act, t_now: float) -> Dict[str, List[int]]:
        """One dispatch of ``decode_segment_len`` decode + sample steps
        (one graph replay on the card); the token ring drains to the host
        once, and each request's new KV range streams to the store through
        the bulk range path (§6.1), so segment boundaries are checkpoint
        boundaries: a crash mid-segment rewinds at most seg_len tokens
        through the §6.2 restore."""
        eng = self.engine
        seg_len = eng.decode_plane.seg_len
        ring = eng.decode_plane.run(act, seg_len)
        self.gateway.stats.host_syncs += 1     # the per-segment drain
        if eng.collect_load:
            # one record per step of the segment, as the reference's
            # segment drain does
            for step_load in eng.decode_plane.host_loads:
                eng.note_dispatch_load(step_load)

        out: Dict[str, List[int]] = {}
        max_seq = eng.ecfg.max_seq
        ck_items = []
        for r in act:
            # the device stop mask and this count are the same formula:
            # steps until max_new or the cache ceiling, capped by seg_len
            n_take = max(0, min(seg_len, r.max_new - len(r.tokens),
                                (max_seq - 1) - r.pos))
            toks = [int(c) for c in ring[:n_take, r.slot]]
            if any(c < 0 for c in toks):
                raise AssertionError(f"{r.rid}: the ring drained an "
                                     f"inactive step")
            start = r.pos
            for nxt in toks:
                r.pos += 1
                r.tokens.append(nxt)
                r.next_input = nxt
            if toks and r.t_first_token < 0:
                r.t_first_token = t_now
            out[r.rid] = toks
            if toks and eng.ecfg.checkpoint and eng.aws[r.aw].alive:
                ck_items.append((r, start, len(toks)))
            if len(r.tokens) >= r.max_new or r.pos >= max_seq - 1:
                r.done = True
                r.t_done = t_now
        # every request's range from one gather and one copy
        eng._bulk_checkpoint_group(ck_items)
        for w in eng.aws:
            w.checkpointer.flush()
        eng.steps += 1
        return out
