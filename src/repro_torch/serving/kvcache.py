"""Per-request KV operations over the contiguous slotted cache and over a
paged one (port of ``repro.serving.kvcache``).

The port's contiguous cache is ``{"layers": [{"k", "v", "pos"}, ...]}``
with the request slot as axis 0 of every tensor; state leaves, each with
a layer axis after the slot, sit beside it: a hybrid (Zamba2) cache's
``"h"`` [B, L, H, P, N] and ``"conv"`` [B, L, W-1, Di]
(models/hybrid.py), an xLSTM cache's mLSTM and sLSTM cells (``"mlstm_c"``
... ``"slstm_h"``, models/xlstm_model.py; its ``"layers"`` is empty) and
Whisper's cross-attention ``"cross_k"`` / ``"cross_v"`` [B, L, T_enc,
Hkv, Dh] (models/whisper.py). The reference's leaf discovery (batch
axis, attention vs state leaves) is therefore not needed. A paged cache
holds per-layer page pools ``[P, pt, ...]`` instead, plus one block table
``"bt"`` [B, nblk] (models/attention.py); it is attention-only. Writes
are in place.

Checkpoint segments (the unit of §6.1) are layout-independent: one
token's segment is ``[kv [L, 2, Hkv, Dh], pos [L]]`` on the host, in the
cache's own dtype, so a segment a paged AW wrote restores onto a
contiguous engine and vice versa; a cache with state leaves adds each of
them, the slot's whole state at that token (the reference's state-leaf
segment; an xLSTM's ``kv`` and ``pos`` are empty). A
gather for many tokens returns the same leaves with a leading token axis,
from one device-to-host copy.
"""
from __future__ import annotations

from collections import deque
from typing import Dict, List

import numpy as np
import torch

from repro_torch.serving.telemetry import host_span


#: every state leaf a cache may hold, in segment order: the hybrid's
#: Mamba2 state, the xLSTM's cells, Whisper's cross-attention K/V
STATE_LEAVES = ("h", "conv",
                "mlstm_c", "mlstm_n", "mlstm_m",
                "slstm_c", "slstm_n", "slstm_m", "slstm_h",
                "cross_k", "cross_v")


def _to_host(packed: torch.Tensor) -> torch.Tensor:
    """``packed`` on the host, in one copy. From the card the buffer is
    pinned memory, which the store then owns (a request's release drops
    the last views and hands the block back to PyTorch's pinned-memory
    cache); the copy runs with ``non_blocking`` on a copy stream that
    starts after the gather and that is waited for before this returns,
    so a checkpoint never commits across a step's end."""
    if not packed.is_cuda:
        return packed
    src = packed
    with host_span("ckpt.pin_alloc", bytes=src.numel()):
        packed = torch.empty(src.numel(), dtype=torch.uint8,
                             pin_memory=True)
    with host_span("ckpt.copy"):
        stream = _copy_stream(src.device)
        stream.wait_stream(torch.cuda.current_stream(src.device))
        with torch.cuda.stream(stream):
            packed.copy_(src, non_blocking=True)
        stream.synchronize()
    return packed


_copy_streams: Dict[torch.device, "torch.cuda.Stream"] = {}


def _copy_stream(device) -> "torch.cuda.Stream":
    """The device's stream for checkpoint copies to the host."""
    if device not in _copy_streams:
        _copy_streams[device] = torch.cuda.Stream(device)
    return _copy_streams[device]


def state_leaves(cache) -> List[str]:
    """The state leaves ``cache`` holds, in segment order."""
    return [name for name in STATE_LEAVES if name in cache]


def cache_device(cache) -> torch.device:
    """The device of the cache (an xLSTM cache has no attention layer)."""
    if cache["layers"]:
        return cache["layers"][0]["k"].device
    return cache[state_leaves(cache)[0]].device


class _SegmentOps:
    """Token-segment gather and restore, shared by both layouts through
    ``_index`` (where each (slot, token) lives in every layer) and
    ``_mapped`` (which tokens of a slot have storage)."""

    def _index(self, cache, slots, tokens):
        raise NotImplementedError

    def _mapped(self, slot: int, tokens: np.ndarray) -> np.ndarray:
        return np.ones(len(tokens), bool)

    def _ring_winners(self, layer, tokens: np.ndarray):
        """Indices of the ``tokens`` a restore writes into ``layer``, or
        None for all: only a ring layer maps two tokens to one slot."""
        return None

    def extract_tokens(self, cache, slots, tokens) -> List[torch.Tensor]:
        """Checkpoint segments of the (slot, token) pairs in one batched
        gather and one device-to-host copy: host leaves
        [kv [n, L, 2, Hkv, Dh], pos [n, L]] and each state leaf, a list
        of n host tensors (kv and pos are [n, 0] without an attention
        layer); pair i's segment is [leaf[i] for each leaf].

        A state leaf's segment is the slot's whole current state, the same
        for every token of the slot: each distinct slot's state is
        gathered and copied once, and each pair's segment is a view of its
        slot's one host copy (a prompt's tokens at install share one)."""
        with host_span("ckpt.gather"):
            dev = cache_device(cache)
            slots = np.asarray(slots)
            s = torch.as_tensor(slots, dtype=torch.long, device=dev)
            t = torch.as_tensor(np.asarray(tokens), dtype=torch.long,
                                device=dev)
            kv, pos = [], []
            for layer, (i0, i1) in zip(cache["layers"],
                                       self._index(cache, s, t)):
                kv.append(torch.stack([layer["k"][i0, i1],
                                       layer["v"][i0, i1]], 1))
                pos.append(layer["pos"][i0, i1])
            if kv:
                kv, pos = torch.stack(kv, 1), torch.stack(pos, 1)
            else:
                kv = torch.zeros((len(slots), 0), device=dev)
                pos = torch.zeros((len(slots), 0), dtype=torch.int32,
                                  device=dev)
            uniq, inv = np.unique(slots, return_inverse=True)
            rows = torch.as_tensor(uniq, dtype=torch.long, device=dev)
            leaves = [kv, pos] + [cache[name][rows]
                                  for name in state_leaves(cache)]
            flat = [x.reshape(-1).view(torch.uint8) for x in leaves]
            packed = torch.cat(flat)
        # one host buffer holding exactly the device bits; each leaf a view
        packed = _to_host(packed)
        out, at = [], 0
        for x, f in zip(leaves, flat):
            out.append(packed[at:at + f.numel()].view(x.dtype)
                       .reshape(x.shape))
            at += f.numel()
        out[2:] = [[h[j] for j in inv.tolist()] for h in out[2:]]
        return out

    def extract_ranges(self, cache, slots, starts,
                       counts) -> List[torch.Tensor]:
        """The contiguous token segments [start, start + count) of many
        slots (a decode segment's checkpoint drain, the counterpart of
        the reference's multi-slot range extractor): ``extract_tokens``
        over the pairs of every range in turn, so range i's segments are
        rows [sum(counts[:i]), sum(counts[:i + 1])) of each leaf. Each
        token is read at its own ring slot (``t % Sc``), so a range that
        crosses a ring's wrap gives every token's own KV."""
        counts = np.asarray(counts, dtype=np.int64)
        tokens = np.concatenate([np.arange(s, s + n)
                                 for s, n in zip(starts, counts)])
        return self.extract_tokens(cache, np.repeat(slots, counts), tokens)

    def extract_range(self, cache, slot: int, start: int,
                      count: int) -> List[torch.Tensor]:
        """The ``count`` contiguous token segments [start, start + count)
        of one slot (a prefill chunk's, or a bulk checkpoint's)."""
        return self.extract_ranges(cache, [slot], [start], [count])

    def write_token_segments(self, cache, slot: int, tokens: List[int],
                             segs: List[list]):
        """Per-request restoration (§6.2): write the segments of
        ``tokens`` into ``slot``, in place. Tokens without storage (an
        unmapped page) are dropped, as the reference's scatter drops
        them."""
        keep = self._mapped(slot, np.asarray(tokens))
        if not keep.any():
            return cache
        tokens = np.asarray(tokens)[keep]
        segs = [sg for sg, k in zip(segs, keep) if k]
        dev = cache_device(cache)
        names = state_leaves(cache)
        # a state leaf's segment is the whole state: the reference writes
        # the segments in token order, so the highest token's snapshot is
        # what stays. Written once, from that token: a batched scatter
        # with repeated indices picks no defined winner on CUDA.
        last = segs[int(np.argmax(tokens))]
        with host_span("restore.stack"):
            kv = torch.stack([sg[0] for sg in segs])    # [n,L,2,Hkv,Dh]
            pos = torch.stack([sg[1] for sg in segs])   # [n,L]
        with host_span("restore.upload"):
            kv, pos = kv.to(dev), pos.to(dev)
            states = [last[2 + j].to(dev) for j in range(len(names))]
        with host_span("restore.scatter"):
            s = torch.full((len(tokens),), slot, dtype=torch.long,
                           device=dev)
            t = torch.as_tensor(tokens, dtype=torch.long, device=dev)
            for li, (layer, (i0, i1)) in enumerate(zip(
                    cache["layers"], self._index(cache, s, t))):
                lkv, lpos = kv[:, li], pos[:, li]
                win = self._ring_winners(layer, tokens)
                if win is not None:
                    sel = torch.as_tensor(win, dtype=torch.long, device=dev)
                    i0, i1, lkv, lpos = i0[sel], i1[sel], lkv[sel], \
                        lpos[sel]
                layer["k"][i0, i1] = lkv[:, 0]
                layer["v"][i0, i1] = lkv[:, 1]
                layer["pos"][i0, i1] = lpos
            for name, state in zip(names, states):
                cache[name][slot] = state
        return cache


class CacheLayout(_SegmentOps):
    """Slot-level operations on a contiguous cache: attention layers and
    state leaves."""

    def _index(self, cache, slots, tokens):
        return [(slots, tokens % layer["k"].shape[1])
                for layer in cache["layers"]]

    def _ring_winners(self, layer, tokens: np.ndarray):
        """Where tokens share a ring slot (t and t + Sc once a request has
        passed its window), the highest of them keeps it, as the
        reference's writes in token order leave it: a batched scatter
        with repeated indices picks no defined winner on CUDA. Host
        arithmetic on the token list, so no device sync."""
        ring = tokens % layer["k"].shape[1]
        if len(np.unique(ring)) == len(ring):
            return None
        desc = np.argsort(tokens, kind="stable")[::-1]
        _, first = np.unique(ring[desc], return_index=True)
        return np.sort(desc[first])

    @staticmethod
    def request_state(cache, row: int) -> Dict[str, object]:
        """One row of the cache (views, not copies): {"layers": [one dict
        per attention layer], and each state leaf}."""
        out = {"layers": [{k: t[row] for k, t in layer.items()}
                          for layer in cache["layers"]]}
        out.update({name: cache[name][row] for name in state_leaves(cache)})
        return out

    @staticmethod
    def scrub_request_state(state, valid_len: int):
        """Invalidate pad entries of a batched-prefill row: positions
        >= ``valid_len`` become -1, which the decode kernels mask. K/V
        payloads stay; they are unreachable once the position is -1.
        Attention caches only: a state leaf must never see a pad."""
        layers = []
        for layer in state["layers"]:
            pos = layer["pos"]
            layers.append(dict(layer, pos=torch.where(
                pos >= valid_len, torch.full_like(pos, -1), pos)))
        return dict(state, layers=layers)

    def write_request_state(self, cache, slot: int, state):
        for layer, st in zip(cache["layers"], state["layers"]):
            for k, t in layer.items():
                t[slot].copy_(st[k])
        for name in state_leaves(cache):
            cache[name][slot].copy_(state[name])
        return cache

    def scrub_slot(self, cache, slot: int, valid_len: int):
        """Invalidate positions >= ``valid_len`` of one slot, in place:
        prefix-cache adoption keeps the adopted prefix [0, valid_len) and
        masks the donor's stale tail (K/V stay, unreachable at -1).
        Attention caches with slot == position only (the chunked plane's
        precondition)."""
        for layer in cache["layers"]:
            pos = layer["pos"][slot]
            pos.masked_fill_(pos >= valid_len, -1)
        return cache

    def clear_slot(self, cache, slot: int):
        """Reset one slot (a finished or released request): K/V zeroed,
        positions -1, recurrent state zeroed."""
        for layer in cache["layers"]:
            layer["k"][slot].zero_()
            layer["v"][slot].zero_()
            layer["pos"][slot].fill_(-1)
        for name in state_leaves(cache):
            cache[name][slot].zero_()
        return cache

    def prefill_paddable(self, cache, max_seq: int) -> bool:
        """True when slot index == absolute position in every layer (full
        attention, no ring wrap) and there is no state leaf (recurrent
        state, which a pad token must never reach, or Whisper's cross
        K/V, which the reference's layout counts as state too): the
        precondition for padded and chunked prefill."""
        if state_leaves(cache):
            return False
        return all(layer["k"].shape[1] >= max_seq
                   for layer in cache["layers"])


# --------------------------------------------------------------------------
# paged layout: block tables over physical page pools
# --------------------------------------------------------------------------

class PagedCacheLayout(_SegmentOps):
    """Operations on a PAGED cache (vLLM-style block tables).

    The paged cache is the contiguous one with every layer's per-slot
    rows replaced by a pool of physical pages (slot axis B -> page axis P,
    position axis Sc -> page extent ``page_tokens``), plus one block table
    ``bt`` [B, nblk] int32 shared by all layers (nblk * page_tokens ==
    max_seq, so a slot's gathered pages reproduce its contiguous layout
    element for element). Page 0 is reserved: never allocated, positions
    -1 forever; unmapped blocks point at it. The pools hold one page past
    the allocator's, the sink that takes dropped writes and is never read
    (``models.attention.paged_write_chunk``).

    The host mirror of the block table lives in the ``PagePool``; the
    engine uploads it before every device call that reads it. Paged mode
    is full-attention only (the engine checks)."""

    def __init__(self, pool: "PagePool", max_seq: int):
        if max_seq != pool.nblk * pool.page_tokens:
            raise ValueError(f"page_tokens={pool.page_tokens} x "
                             f"{pool.nblk} blocks != max_seq={max_seq}")
        self.pool = pool
        self.page_tokens = pool.page_tokens
        self.nblk = pool.nblk
        self.max_seq = max_seq

    def make_cache(self, init_cache, batch: int):
        """Per-layer page pools (the contiguous init with batch =
        num_pages + 1, the last being the sink page that takes dropped
        writes; max_seq = page_tokens) and the block table, every entry at
        the null page."""
        cache = init_cache(self.pool.num_pages + 1, self.page_tokens)
        dev = cache_device(cache)
        cache["bt"] = torch.zeros((batch, self.nblk), dtype=torch.int32,
                                  device=dev)
        return cache

    def set_block_table(self, cache, bt_host: np.ndarray):
        """Upload the host block-table mirror (a [B, nblk] int32 copy)."""
        cache["bt"].copy_(torch.from_numpy(np.ascontiguousarray(bt_host)))
        return cache

    def _index(self, cache, slots, tokens):
        spos = tokens % self.max_seq
        page = cache["bt"][slots, spos // self.page_tokens].long()
        return [(page, spos % self.page_tokens)] * len(cache["layers"])

    def _mapped(self, slot: int, tokens: np.ndarray) -> np.ndarray:
        blk = (tokens % self.max_seq) // self.page_tokens
        return self.pool.bt[slot, blk] > 0

    def write_request_state(self, cache, slot: int, state):
        """Scatter a contiguous per-slot state (``CacheLayout.request_state``
        of a prefill cache) into the slot's mapped pages. Unmapped blocks
        are left out: callers map pages covering the valid prefix first,
        and the rest is scrubbed (-1) padding."""
        row = self.pool.bt[slot]
        blk = np.nonzero(row > 0)[0]
        if not len(blk):
            return cache
        dev = cache_device(cache)
        pages = torch.as_tensor(row[blk], dtype=torch.long, device=dev)
        blk = torch.as_tensor(blk, dtype=torch.long, device=dev)
        pt = self.page_tokens
        for layer, st in zip(cache["layers"], state["layers"]):
            for k, t in layer.items():
                src = st[k].reshape(self.nblk, pt, *st[k].shape[1:])
                t[pages] = src[blk].to(t.dtype)
        return cache

    def scrub_slot(self, cache, slot: int, valid_len: int):
        """Mask positions >= ``valid_len`` in the slot's mapped pages, in
        place (page ids from the host mirror: no device read). A page
        shared with another holder lies wholly below ``valid_len`` (only
        the boundary page is copied private), so its values are
        unchanged."""
        pids = self.pool.slot_pages(slot)
        if pids:
            dev = cache_device(cache)
            idx = torch.as_tensor(pids, dtype=torch.long, device=dev)
            for layer in cache["layers"]:
                sub = layer["pos"][idx]
                layer["pos"][idx] = sub.masked_fill(sub >= valid_len, -1)
        return cache

    def copy_page(self, cache, src: int, dst: int):
        """Copy-on-extend: duplicate physical page ``src`` into ``dst`` in
        every layer (K, V and positions), in place on the current stream,
        so a gather queued after it reads the copy."""
        for layer in cache["layers"]:
            for t in layer.values():
                t[dst].copy_(t[src])
        return cache

    def scrub_pages(self, cache, pages: List[int]):
        """Invalidate freed pages' positions, so a recycled page can never
        leak stale entries into its next owner's attention."""
        if pages:
            dev = cache_device(cache)
            idx = torch.as_tensor(pages, dtype=torch.long, device=dev)
            for layer in cache["layers"]:
                layer["pos"][idx] = -1
        return cache

    def prefill_paddable(self, cache, max_seq: int) -> bool:
        return max_seq <= self.max_seq


# --------------------------------------------------------------------------
# host-side page allocator
# --------------------------------------------------------------------------

class PagePool:
    """Host bookkeeping for the physical page pools: per-AW free lists
    (pages partition across AWs like slots do: a failure domain owns its
    pages), refcounts, and the host mirror of the device block table.

    Page ids are global; page 0 is reserved (never allocated). An
    allocated page starts at refcount 1; prefix-cache entries and adopting
    slots each hold one reference, and a page returns to its AW's free
    list only when the count hits 0 (a page with refcount > 1 is never
    freed)."""

    def __init__(self, num_slots: int, num_aw: int, blocks_per_slot: int,
                 page_tokens: int, pages_per_aw: int = 0):
        self.page_tokens = page_tokens
        self.nblk = blocks_per_slot
        self.num_aw = num_aw
        self.slots_per_aw = num_slots // num_aw
        # 0 = parity with the contiguous footprint; a smaller budget trades
        # capacity against prefix sharing (cached entries pin pages)
        self.pages_per_aw = pages_per_aw or \
            self.slots_per_aw * blocks_per_slot
        self.num_pages = 1 + self.pages_per_aw * num_aw
        self._free = [deque(range(1 + a * self.pages_per_aw,
                                  1 + (a + 1) * self.pages_per_aw))
                      for a in range(num_aw)]
        self.ref = np.zeros(self.num_pages, np.int32)
        self.bt = np.zeros((num_slots, self.nblk), np.int32)
        self.dirty = False   # host bt differs from the device copy

    # ------------------------------------------------------------------
    def aw_of_page(self, pid: int) -> int:
        assert pid > 0
        return (pid - 1) // self.pages_per_aw

    def aw_of_slot(self, slot: int) -> int:
        return slot // self.slots_per_aw

    def free_pages(self, aw: int) -> int:
        return len(self._free[aw])

    def alloc(self, aw: int) -> int:
        """Allocate one page on AW ``aw`` (refcount 1), or -1 if its pool
        is exhausted."""
        if not self._free[aw]:
            return -1
        pid = self._free[aw].popleft()
        assert self.ref[pid] == 0, pid
        self.ref[pid] = 1
        return pid

    def incref(self, pid: int):
        assert pid > 0 and self.ref[pid] > 0, pid
        self.ref[pid] += 1

    def decref(self, pid: int) -> bool:
        """Drop one reference; True when the page was freed (the caller
        must scrub it on the device before it can be allocated again)."""
        assert pid > 0 and self.ref[pid] > 0, pid
        self.ref[pid] -= 1
        if self.ref[pid] == 0:
            self._free[self.aw_of_page(pid)].append(pid)
            return True
        return False

    # ------------------------------------------------------------------
    def map_block(self, slot: int, blk: int, pid: int):
        self.bt[slot, blk] = pid
        self.dirty = True

    def mapped_blocks(self, slot: int) -> int:
        return int((self.bt[slot] > 0).sum())

    def slot_pages(self, slot: int, upto_blocks: int = -1) -> List[int]:
        """The slot's mapped pages, in block order (the first
        ``upto_blocks`` blocks only, when given)."""
        row = self.bt[slot]
        if upto_blocks >= 0:
            row = row[:upto_blocks]
        return [int(p) for p in row if p > 0]

    def release_slot(self, slot: int) -> List[int]:
        """Unmap the whole slot and decref its pages; returns the pages
        whose refcount hit 0 (to scrub and recycle)."""
        freed = [pid for pid in self.slot_pages(slot) if self.decref(pid)]
        if self.bt[slot].any():
            self.bt[slot] = 0
            self.dirty = True
        return freed

    # ------------------------------------------------------------------
    def stats(self) -> Dict[str, int]:
        return {"pages_total": self.num_pages - 1,
                "pages_used": int((self.ref[1:] > 0).sum()),
                "pages_shared": int((self.ref[1:] > 1).sum())}

    def check(self) -> None:
        """Allocator invariants: every page is either free exactly once
        with refcount 0, or allocated with refcount > 0 and on no free
        list; block tables only reference allocated pages."""
        seen: Dict[int, int] = {}
        for aw, fl in enumerate(self._free):
            for pid in fl:
                if self.aw_of_page(pid) != aw:
                    raise AssertionError(f"page {pid} on AW{aw}'s free list")
                seen[pid] = seen.get(pid, 0) + 1
        for pid in range(1, self.num_pages):
            if self.ref[pid] == 0:
                if seen.get(pid, 0) != 1:
                    raise AssertionError(
                        f"page {pid} free-count {seen.get(pid, 0)} != 1")
            elif pid in seen:
                raise AssertionError(f"page {pid} allocated AND free")
        mapped = self.bt[self.bt > 0]
        if not (self.ref[mapped] > 0).all():
            raise AssertionError("bt references a free page")
