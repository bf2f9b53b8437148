"""Prefix-cache plane (port of ``repro.serving.prefixcache``): per-AW
radix KV reuse with checkpoint-backed restoration.

When a request finishes, its slot is not cleared: the AW's cache adopts
it, keyed by the token sequence whose KV the slot holds. A later request
whose prompt shares a prefix (multi-turn chat: every turn replays the
conversation) adopts the cached slot by reference, scrubs the stale tail
and starts its chunk stream at ``prefill_cursor = matched_len``. Only the
uncached tail is prefilled, and the stream is bitwise the cold run's.

Sharing is slot-level: an entry holds its slot, and a live request that
adopted it marks it live (never evicted). Eviction is LRU with a
recompute-cost tie-break (older first; among equals the shortest prefix)
under a per-AW slot budget and an optional token budget. An AW's free
capacity counts evictable cached slots, and allocation evicts.

Cached prefixes are checkpoint-backed: on adoption the prefix is
re-checkpointed into the adopter's own store log through the bulk range
path, so its recovery never depends on the donor; when an AW dies, its
non-live entries become orphans whose KV still lives in the store, and
recovery restores each onto a healthy AW (§6.2 applied to cache state),
so the session's next turn still hits. Every transition is host
bookkeeping or an in-place cache write: no new step graph.

On a paged engine (``kv_page_tokens > 0``) sharing moves to physical
pages: entries pin refcounted pages instead of a slot, adoption maps the
same pages into any number of decoding slots (copy-on-extend at the
boundary page keeps shared pages read-only), and eviction is
page-granular: under allocation pressure the LRU entry loses tail pages
one at a time, priced by the pages only it keeps alive. With
``prefix_global_index`` one cluster-wide index routes arrivals to the AW
holding their best cached prefix, and ``prefix_migrate`` moves a hot
prefix to a free AW through the checkpoint-replay path restoration uses.
"""
from __future__ import annotations

from dataclasses import dataclass
from typing import Dict, List, Optional, Set, Tuple

import numpy as np

from repro_torch.serving.gateway import SessionAffinityPolicy


def _common_len(a, b) -> int:
    n = min(len(a), len(b))
    for i in range(n):
        if a[i] != b[i]:
            return i
    return n


class _RadixNode:
    __slots__ = ("edge", "children", "slot")

    def __init__(self, edge=()):
        self.edge: Tuple[int, ...] = tuple(edge)  # tokens on the edge in
        self.children: Dict[int, "_RadixNode"] = {}
        self.slot: int = -1      # slot whose cached prefix ends exactly here


class RadixIndex:
    """Compressed radix trie over token sequences. Each inserted sequence
    ends at a node carrying the slot id whose cache holds that prefix's
    KV. ``match`` returns the usable entry with the longest common prefix
    against a query — the LCP may end mid-edge (the divergence point):
    any entry below it still shares exactly that many leading tokens."""

    def __init__(self):
        self.root = _RadixNode()

    # -- mutation -----------------------------------------------------------
    def insert(self, tokens, slot: int):
        toks = tuple(int(t) for t in tokens)
        node, i = self.root, 0
        while i < len(toks):
            child = node.children.get(toks[i])
            if child is None:
                leaf = _RadixNode(toks[i:])
                leaf.slot = slot
                node.children[toks[i]] = leaf
                return
            k = _common_len(child.edge, toks[i:])
            if k == len(child.edge):
                node = child
                i += k
                continue
            # split the child's edge at the divergence point
            mid = _RadixNode(child.edge[:k])
            child.edge = child.edge[k:]
            mid.children[child.edge[0]] = child
            node.children[toks[i]] = mid
            if i + k == len(toks):
                mid.slot = slot
            else:
                leaf = _RadixNode(toks[i + k:])
                leaf.slot = slot
                mid.children[toks[i + k]] = leaf
            return
        node.slot = slot

    def remove(self, tokens, slot: int):
        """Clear the entry at the exact path ``tokens`` if it holds
        ``slot`` (collision-safe: a different slot at that path is left
        alone). Stale slot-less nodes are kept — they are harmless to
        matching and trivial at slot-count scale."""
        toks = tuple(int(t) for t in tokens)
        node, i = self.root, 0
        while i < len(toks):
            child = node.children.get(toks[i])
            if child is None:
                return
            if child.edge != toks[i:i + len(child.edge)]:
                return
            node = child
            i += len(child.edge)
        if node.slot == slot:
            node.slot = -1

    def exact_slot(self, tokens) -> int:
        toks = tuple(int(t) for t in tokens)
        node, i = self.root, 0
        while i < len(toks):
            child = node.children.get(toks[i])
            if child is None or child.edge != toks[i:i + len(child.edge)]:
                return -1
            node = child
            i += len(child.edge)
        return node.slot

    # -- lookup -------------------------------------------------------------
    def _any_slot(self, node: _RadixNode, usable: Set[int]) -> int:
        if node.slot in usable:
            return node.slot
        for child in node.children.values():
            s = self._any_slot(child, usable)
            if s >= 0:
                return s
        return -1

    def match(self, tokens, usable: Set[int]) -> Tuple[int, int]:
        """(slot, lcp) of the usable entry sharing the longest prefix with
        ``tokens`` — (-1, 0) when nothing usable matches at least one
        token. Walk the query down the trie; the deepest reachable subtree
        gives the longest guaranteed LCP, shallower fully-matched nodes
        give progressively shorter ones."""
        toks = tuple(int(t) for t in tokens)
        path: List[Tuple[_RadixNode, int]] = []
        node, i = self.root, 0
        deep: Optional[Tuple[_RadixNode, int]] = None
        while i < len(toks):
            child = node.children.get(toks[i])
            if child is None:
                break
            k = _common_len(child.edge, toks[i:])
            if k < len(child.edge):
                # diverged (or query exhausted) inside the edge: everything
                # below shares exactly i + k leading tokens with the query
                deep = (child, i + k)
                break
            node = child
            i += len(child.edge)
            path.append((node, i))
        if deep is not None and deep[1] > 0:
            s = self._any_slot(deep[0], usable)
            if s >= 0:
                return s, deep[1]
        for n, depth in reversed(path):
            s = self._any_slot(n, usable)
            if s >= 0:
                return s, depth
        return -1, 0


@dataclass
class PrefixEntry:
    """One cached prefix: ``slot`` holds committed KV for ``tokens``
    (positions [0, len(tokens))). ``rid`` names the checkpoint-store log
    backing the entry across AW failures ('' = unbacked — a live entry's
    adopter carries the prefix in its own log). ``live`` is the slot-level
    refcount bit: a resident request shares the slot, so the entry can be
    neither evicted nor re-adopted until it completes or releases."""
    slot: int
    tokens: np.ndarray
    rid: str
    session: Optional[str]
    last_use: float
    live: bool = False

    @property
    def length(self) -> int:
        return len(self.tokens)


@dataclass
class PrefixCacheStats:
    offered: int = 0
    cached: int = 0
    refused: int = 0

    def snapshot(self) -> dict:
        return {"offered": self.offered, "cached": self.cached,
                "refused": self.refused}


class AWPrefixCache:
    """Per-AW prefix cache: the radix index plus slot bookkeeping over the
    worker's own ``SlotPartition``. Pure host-side metadata — the KV
    itself stays resident in the engine's slot cache (or in the
    checkpoint store, for failover restoration)."""

    def __init__(self, partition, max_slots: int, max_tokens: int = 0,
                 min_match: int = 4, release_log=None, stats=None):
        self.partition = partition
        self.max_slots = max(1, max_slots)
        self.max_tokens = max(0, max_tokens)
        # adoption truncates the matched entry to the LCP, so a trivial
        # (coincidental) match must not be allowed to destroy a long
        # cached prefix for a few-token prefill saving
        self.min_match = max(1, min_match)
        self.release_log = release_log or (lambda rid: None)
        self.stats = stats           # GatewayStats (shared hit accounting)
        self.entries: Dict[int, PrefixEntry] = {}
        self.index = RadixIndex()
        self.local = PrefixCacheStats()

    # -- capacity view ------------------------------------------------------
    def evictable_count(self) -> int:
        return sum(1 for e in self.entries.values() if not e.live)

    def cached_tokens(self) -> int:
        return sum(e.length for e in self.entries.values() if not e.live)

    def match_len(self, prompt) -> int:
        """Routing probe (no side effects): longest cached prefix of
        ``prompt`` on this AW, live entries included — the session's KV
        being in use right now is still a reason to route here. Matches
        below ``min_match`` report 0 (they would not be adopted)."""
        if prompt is None or len(prompt) < 2:
            return 0
        _, lcp = self.index.match(prompt, set(self.entries.keys()))
        lcp = min(lcp, len(prompt) - 1)
        return lcp if lcp >= self.min_match else 0

    # -- allocation: match-or-evict ----------------------------------------
    def take_slot(self, prompt, now: float = 0.0) -> Tuple[int, int]:
        """Hand out a slot for an admission. Prefix match first: a usable
        (non-live) entry sharing >= ``min_match`` tokens is adopted by
        reference — the entry truncates to the matched prefix, goes live,
        and the caller prefills only the tail. Otherwise a partition
        slot, else the LRU cached entry is evicted and its slot reused."""
        if prompt is not None and len(prompt) >= 2:
            usable = {s for s, e in self.entries.items() if not e.live}
            slot, lcp = self.index.match(prompt, usable)
            lcp = min(lcp, len(prompt) - 1)
            if slot >= 0 and lcp >= self.min_match:
                e = self.entries[slot]
                self.index.remove(e.tokens, slot)
                # truncate to the match: the adopter overwrites [lcp, ...)
                e.tokens = np.asarray(e.tokens[:lcp], np.int32)
                e.live = True
                e.last_use = now
                if e.rid:
                    # the adopter re-checkpoints the prefix into its own
                    # log (bulk-segment path); the donor log is done
                    self.release_log(e.rid)
                    e.rid = ""
                self.index.insert(e.tokens, slot)
                return slot, lcp
        if self.partition.free_count() > 0:
            return self.partition.alloc(), 0
        victim = self._pick_victim()
        if victim is None:
            raise RuntimeError("take_slot called with no capacity")
        self._evict(victim, free_slot=False)
        return victim.slot, 0

    # -- population ---------------------------------------------------------
    def offer(self, slot: int, tokens: np.ndarray, rid: str,
              session: Optional[str], now: float) -> bool:
        """A finished request's slot is offered for caching. Replaces the
        slot's live entry (the completed adoption), enforces the slot and
        token budgets by evicting LRU entries, and refuses (slot returns
        to the free list) when the sequence is trivial, duplicates an
        existing path, or cannot fit."""
        self.local.offered += 1
        old = self.entries.pop(slot, None)
        if old is not None:
            self.index.remove(old.tokens, slot)
            if old.rid:
                self.release_log(old.rid)
        n = len(tokens)
        if n < 2 or (self.max_tokens and n > self.max_tokens) or \
                self.index.exact_slot(tokens) >= 0:
            self.local.refused += 1
            return False
        while self.evictable_count() >= self.max_slots or \
                (self.max_tokens and
                 self.cached_tokens() + n > self.max_tokens):
            victim = self._pick_victim()
            if victim is None:
                self.local.refused += 1
                return False
            self._evict(victim, free_slot=True)
        self.entries[slot] = PrefixEntry(slot, np.asarray(tokens, np.int32),
                                         rid, session, now)
        self.index.insert(tokens, slot)
        self.local.cached += 1
        return True

    def insert_restored(self, slot: int, tokens: np.ndarray, rid: str,
                        session: Optional[str], now: float) -> bool:
        """Failover path: an orphaned prefix restored from the checkpoint
        store joins this AW's index (same budget discipline as offer)."""
        return self.offer(slot, tokens, rid, session, now)

    # -- teardown -----------------------------------------------------------
    def forget_slot(self, slot: int):
        """Drop the entry at ``slot`` without touching the slot itself
        (the caller owns it: cancellation, preemption, failed offer)."""
        e = self.entries.pop(slot, None)
        if e is not None:
            self.index.remove(e.tokens, slot)
            if e.rid:
                self.release_log(e.rid)

    def clear(self):
        """AW crash: the metadata dies with the worker (orphan snapshots
        are taken by the plane *before* the worker's fail())."""
        self.entries = {}
        self.index = RadixIndex()

    # -- eviction -----------------------------------------------------------
    def _pick_victim(self) -> Optional[PrefixEntry]:
        """LRU + cost-aware: oldest ``last_use`` first; among equals the
        shortest prefix (cheapest to recompute) goes first; slot id breaks
        the final tie for determinism. Live entries are untouchable."""
        cands = [e for e in self.entries.values() if not e.live]
        if not cands:
            return None
        return min(cands, key=lambda e: (e.last_use, e.length, e.slot))

    def _evict(self, e: PrefixEntry, free_slot: bool):
        del self.entries[e.slot]
        self.index.remove(e.tokens, e.slot)
        if e.rid:
            self.release_log(e.rid)
        if free_slot:
            self.partition.release(e.slot)
        if self.stats is not None:
            self.stats.prefix_evictions += 1

    def snapshot(self) -> dict:
        return {"entries": len(self.entries),
                "live": sum(1 for e in self.entries.values() if e.live),
                "cached_tokens": self.cached_tokens(),
                **self.local.snapshot()}


# --------------------------------------------------------------------------
# paged mode: page-level sharing, entry-id keyed caches, global routing
# --------------------------------------------------------------------------

@dataclass
class PagedPrefixEntry:
    """One cached prefix on a PAGED engine: the entry holds pinned
    references to the physical pages whose KV covers ``tokens`` — not a
    slot. Entries are keyed by a synthetic id (``eid``), never consumed by
    adoption, and serve any number of concurrent adopters: each adopter's
    slot maps the SAME pages (refcount bumped, copy-on-extend at the
    boundary), which is what lets far more shared-prefix sessions stay
    resident than there are slots. ``rid`` names the checkpoint-store log
    backing the entry across AW failures ('' = unbacked)."""
    eid: int
    tokens: np.ndarray
    pages: List[int]
    rid: str
    session: Optional[str]
    last_use: float

    @property
    def length(self) -> int:
        return len(self.tokens)


class PagedAWPrefixCache:
    """Per-AW prefix cache over the engine's refcounted page pool.

    Differences from the slot-level ``AWPrefixCache``:
      * entries pin PAGES, not slots — ``take_slot`` always hands out a
        real partition slot and maps the matched entry's pages into it
        (``engine._kv_adopt``: shared full pages + a private boundary
        copy), so ``evictable_count`` is 0 and the worker's free count is
        its true partition free count;
      * entries are multi-adopter: adoption neither truncates nor
        consumes them, and two live requests decoding off the same prefix
        reference the same physical pages;
      * eviction is page-pressure driven and PARTIAL: under pressure the
        LRU entry's tail pages are trimmed first (the entry survives,
        shortened), and the victim's cost is priced by its EXCLUSIVE
        pages — a mostly-shared entry is cheap to drop because its pages
        outlive it with their other holders. A page with refcount > 1 is
        never freed (the pool's decref invariant).
    """

    def __init__(self, aw_id: int, partition, engine, max_tokens: int = 0,
                 min_match: int = 4, release_log=None, stats=None,
                 eid_gen=None, plane=None):
        self.aw_id = aw_id
        self.partition = partition
        self.engine = engine
        self.pool = engine.pages
        self.max_tokens = max(0, max_tokens)
        self.min_match = max(1, min_match)
        self.release_log = release_log or (lambda rid: None)
        self.stats = stats
        self._eid_gen = eid_gen or iter(range(1, 1 << 60)).__next__
        self.plane = plane
        self.entries: Dict[int, PagedPrefixEntry] = {}
        self.index = RadixIndex()
        self.local = PrefixCacheStats()

    # -- index maintenance (local trie + the plane's global one) ------------
    def _index_insert(self, e: PagedPrefixEntry):
        self.index.insert(e.tokens, e.eid)
        if self.plane is not None:
            self.plane.on_index_insert(self.aw_id, e)

    def _index_remove(self, e: PagedPrefixEntry):
        self.index.remove(e.tokens, e.eid)
        if self.plane is not None:
            self.plane.on_index_remove(e)

    # -- capacity view ------------------------------------------------------
    def evictable_count(self) -> int:
        return 0                 # entries hold pages, never slots

    def cached_tokens(self) -> int:
        return sum(e.length for e in self.entries.values())

    def exclusive_pages(self, e: PagedPrefixEntry) -> int:
        return sum(1 for p in e.pages if self.pool.ref[p] == 1)

    def match_len(self, prompt) -> int:
        if prompt is None or len(prompt) < 2:
            return 0
        _, lcp = self.index.match(prompt, set(self.entries.keys()))
        lcp = min(lcp, len(prompt) - 1)
        return lcp if lcp >= self.min_match else 0

    # -- allocation: slot + page-level adoption -----------------------------
    def take_slot(self, prompt, now: float = 0.0) -> Tuple[int, int]:
        """Allocate a partition slot; when the prompt shares >= min_match
        tokens with a cached entry, map the entry's pages into the slot
        (zero KV copied for the shared full pages). The entry stays in
        the cache for the next adopter."""
        slot = self.partition.alloc()
        if prompt is None or len(prompt) < 2:
            return slot, 0
        eid, lcp = self.index.match(prompt, set(self.entries.keys()))
        lcp = min(lcp, len(prompt) - 1)
        if eid < 0 or lcp < self.min_match:
            return slot, 0
        e = self.entries[eid]
        hit = self.engine._kv_adopt(slot, e.pages, min(lcp, e.length))
        if hit < self.min_match:
            # boundary-copy degrade fell under the adoption threshold:
            # roll the shared references back and admit cold
            self.engine._kv_clear_slot(slot)
            return slot, 0
        e.last_use = now
        return slot, hit

    # -- population ---------------------------------------------------------
    def offer(self, slot: int, tokens: np.ndarray, rid: str,
              session: Optional[str], now: float) -> bool:
        """Pin the finished request's pages as a new entry. The slot
        itself is NOT retained — the caller releases it (decref'ing the
        slot's references) and the entry's own references keep the pages
        alive. Duplicates refresh the existing entry instead."""
        self.local.offered += 1
        n = len(tokens)
        if n < 2 or (self.max_tokens and n > self.max_tokens):
            self.local.refused += 1
            return False
        dup = self.index.exact_slot(tokens)
        if dup >= 0 and dup in self.entries:
            self.entries[dup].last_use = now
            self.local.refused += 1
            return False
        while self.max_tokens and self.cached_tokens() + n > self.max_tokens:
            victim = self._pick_victim()
            if victim is None:
                self.local.refused += 1
                return False
            self.engine._kv_free_pages(self.remove_entry(victim.eid))
            if self.stats is not None:
                self.stats.prefix_evictions += 1
        pages = self.engine._kv_snapshot(slot, n)
        if len(pages) < -(-n // self.pool.page_tokens):
            # the slot's mapped extent doesn't cover the claimed prefix
            # (should not happen — defensive roll-back, no leak)
            for pid in pages:
                self.pool.decref(pid)
            self.local.refused += 1
            return False
        e = PagedPrefixEntry(self._eid_gen(), np.asarray(tokens, np.int32),
                             pages, rid, session, now)
        self.entries[e.eid] = e
        self._index_insert(e)
        self.local.cached += 1
        return True

    def insert_restored(self, slot: int, tokens: np.ndarray, rid: str,
                        session: Optional[str], now: float) -> bool:
        return self.offer(slot, tokens, rid, session, now)

    # -- teardown -----------------------------------------------------------
    def forget_slot(self, slot: int):
        """No-op: paged entries are not slot-keyed — an adopter's teardown
        just decrefs its slot's page references (engine._kv_clear_slot)."""

    def remove_entry(self, eid: int, release_log: bool = True) -> List[int]:
        """Drop one entry, decref its pages; returns the page ids whose
        refcount hit 0 (the CALLER scrubs them on device — pages shared
        with live slots or other entries survive untouched)."""
        e = self.entries.pop(eid, None)
        if e is None:
            return []
        self._index_remove(e)
        freed = [p for p in e.pages if self.pool.decref(p)]
        e.pages = []
        if release_log and e.rid:
            self.release_log(e.rid)
        return freed

    def release_all_pages(self) -> List[int]:
        """AW failure path: drop every entry's page references (orphan
        metadata was snapshotted by the plane already). Returns freed
        page ids for the engine to scrub."""
        freed = []
        for e in list(self.entries.values()):
            self._index_remove(e)
            freed += [p for p in e.pages if self.pool.decref(p)]
            e.pages = []
            self._index_insert(e)   # keep metadata addressable until clear()
        return freed

    def clear(self):
        for e in list(self.entries.values()):
            self._index_remove(e)
        self.entries = {}
        self.index = RadixIndex()

    # -- eviction: page-pressure, partial, exclusive-priced -----------------
    def _pick_victim(self) -> Optional[PagedPrefixEntry]:
        """LRU first; among equals the entry with the FEWEST exclusive
        pages (eviction cost is the KV only this entry keeps alive —
        shared pages survive their holder, so a mostly-shared entry is
        nearly free to drop); eid breaks the final tie."""
        if not self.entries:
            return None
        return min(self.entries.values(),
                   key=lambda e: (e.last_use, self.exclusive_pages(e),
                                  e.eid))

    def evict_pages(self) -> List[int]:
        """Free at least one physical page under allocation pressure by
        trimming victims TAIL-FIRST: the LRU entry loses its last page
        (partial-prefix eviction — the shortened entry still serves
        shorter matches) until a page actually frees. Entries trimmed
        below usefulness (< min_match tokens) drop entirely. Returns
        freed page ids for the engine to scrub; [] when nothing more can
        free a page."""
        freed: List[int] = []
        while not freed:
            victim = self._pick_victim()
            if victim is None:
                break
            freed += self._trim_tail(victim)
        return freed

    def _trim_tail(self, e: PagedPrefixEntry) -> List[int]:
        freed: List[int] = []
        self._index_remove(e)
        if e.pages:
            pid = e.pages.pop()
            if self.pool.decref(pid):
                freed.append(pid)
        new_len = min(e.length, len(e.pages) * self.pool.page_tokens)
        e.tokens = np.asarray(e.tokens[:new_len], np.int32)
        if not e.pages or e.length < max(2, self.min_match):
            del self.entries[e.eid]
            freed += [p for p in e.pages if self.pool.decref(p)]
            e.pages = []
            if e.rid:
                self.release_log(e.rid)
        else:
            self._index_insert(e)
        if self.stats is not None:
            self.stats.prefix_evictions += 1
        return freed

    # -- metrics ------------------------------------------------------------
    def snapshot(self) -> dict:
        return {"entries": len(self.entries),
                "shared": sum(1 for e in self.entries.values()
                              if any(self.pool.ref[p] > 1
                                     for p in e.pages)),
                "cached_tokens": self.cached_tokens(),
                **self.local.snapshot()}


class GlobalPrefixIndex:
    """Gateway-level radix index over EVERY AW's cached prefixes: one trie
    whose entries are global eids mapped to their home AW. The per-AW
    indexes stay authoritative for adoption; this one answers the routing
    question — \"which AW, cluster-wide, holds the longest cached prefix
    of this prompt?\" — in one lookup instead of a per-AW scan, and is
    what prefix migration consults for the source entry."""

    def __init__(self):
        self.index = RadixIndex()
        self.home: Dict[int, int] = {}        # eid -> aw_id

    def insert(self, tokens, eid: int, aw_id: int):
        self.index.insert(tokens, eid)
        self.home[eid] = aw_id

    def remove(self, tokens, eid: int):
        self.index.remove(tokens, eid)
        self.home.pop(eid, None)

    def match(self, prompt) -> Tuple[int, int, int]:
        """(eid, home aw_id, lcp) of the best cluster-wide match, or
        (-1, -1, 0)."""
        eid, lcp = self.index.match(prompt, set(self.home.keys()))
        return eid, self.home.get(eid, -1), lcp


class PrefixCachePlane:
    """Engine-level coordinator: attaches an ``AWPrefixCache`` (or, on
    paged engines, a ``PagedAWPrefixCache``) to every AttentionWorker,
    owns the offer/forget lifecycle hooks the engine calls, and carries
    dead AWs' cached prefixes across failover via the checkpoint store.

    On paged engines with ``prefix_global_index`` the plane additionally
    maintains one cluster-wide radix index mirroring every per-AW trie
    and installs itself into the gateway's placement path: arrivals route
    to the AW holding their best cached prefix anywhere in the cluster,
    and (with ``prefix_migrate``) hot prefixes whose home AW is full
    migrate to a free AW by replaying their committed checkpoint
    segments — the same bulk-segment path failover restoration uses."""

    def __init__(self, engine, max_slots: int, max_tokens: int = 0,
                 min_match: int = 4):
        self.engine = engine
        self.orphans: List[PrefixEntry] = []
        self._log_seq = 0        # unique suffix for adopted-log keys
        self.min_match = max(1, min_match)
        self.paged = engine.pages is not None
        self._eid = 0            # plane-owned: eids unique cluster-wide
        self.global_index: Optional[GlobalPrefixIndex] = None
        if self.paged and engine.ecfg.prefix_global_index:
            self.global_index = GlobalPrefixIndex()
        for w in engine.aws:
            if self.paged:
                w.prefix_cache = PagedAWPrefixCache(
                    w.aw_id, w.slots, engine, max_tokens=max_tokens,
                    min_match=min_match, release_log=engine.store.release,
                    stats=engine.gateway.stats, eid_gen=self._next_eid,
                    plane=self)
            else:
                w.prefix_cache = AWPrefixCache(
                    w.slots, max_slots, max_tokens, min_match=min_match,
                    release_log=engine.store.release,
                    stats=engine.gateway.stats)
        if self.global_index is not None:
            pol = engine.gateway.policy
            if isinstance(pol, SessionAffinityPolicy):
                pol.global_router = self.route
            engine.gateway.match_probe = self.global_match_len

    # -- global-index maintenance (called by the per-AW caches) -------------
    def _next_eid(self) -> int:
        self._eid += 1
        return self._eid

    def on_index_insert(self, aw_id: int, e: PagedPrefixEntry):
        if self.global_index is not None:
            self.global_index.insert(e.tokens, e.eid, aw_id)

    def on_index_remove(self, e: PagedPrefixEntry):
        if self.global_index is not None:
            self.global_index.remove(e.tokens, e.eid)

    # -- cluster-wide routing ------------------------------------------------
    def global_match_len(self, prompt) -> int:
        """Gateway admission probe: longest cached prefix of ``prompt``
        anywhere in the cluster (one trie walk instead of a per-AW scan).
        Used only for token accounting — adoption still happens against
        the chosen AW's own cache."""
        if self.global_index is None or prompt is None or len(prompt) < 2:
            return 0
        _, _, lcp = self.global_index.match(prompt)
        lcp = min(lcp, len(prompt) - 1)
        return lcp if lcp >= self.min_match else 0

    def route(self, workers, prompt) -> Optional[int]:
        """SessionAffinityPolicy's ``global_router``: the AW holding the
        best cluster-wide prefix match for this prompt, when it can take
        the request. If the home AW has no slot headroom and
        ``prefix_migrate`` is on, the entry is migrated to a free AW via
        checkpoint replay and the request routes there instead."""
        eng = self.engine
        if self.global_index is None or prompt is None or len(prompt) < 2:
            return None
        eid, aw_id, lcp = self.global_index.match(prompt)
        lcp = min(lcp, len(prompt) - 1)
        if eid < 0 or aw_id < 0 or lcp < self.min_match:
            return None
        w = eng.aws[aw_id]
        if w.alive and w.has_capacity():
            eng.gateway.stats.prefix_global_hits += 1
            return aw_id
        if eng.ecfg.prefix_migrate:
            dst = self._migrate(eid, aw_id, now=float(eng.steps))
            if dst is not None:
                eng.gateway.stats.prefix_global_hits += 1
                return dst
        return None

    def _migrate(self, eid: int, src_aw: int, now: float) -> Optional[int]:
        """Move one cached prefix to an AW with headroom by replaying its
        committed store segments into fresh pages there (pages never move
        between AW partitions — the checkpoint path is the only
        cross-failure-domain channel). On success the destination entry
        adopts the store log and the source entry is dropped WITHOUT
        releasing it."""
        eng = self.engine
        src = eng.aws[src_aw].prefix_cache
        e = src.entries.get(eid) if src is not None else None
        if e is None or not e.rid or not eng.ecfg.checkpoint:
            return None
        best, best_free = None, -1
        for w in eng.aws:
            if not w.alive or w.aw_id == src_aw or not w.has_capacity():
                continue
            if w.slots.free_count() == 0:
                continue
            fp = eng.pages.free_pages(w.aw_id)
            if fp > best_free:
                best, best_free = w, fp
        if best is None:
            return None
        if not self._materialize(best, e.tokens, e.rid, e.session, now):
            return None
        # the destination entry now backs the rid log; drop the source
        # entry but keep the log alive
        eng._kv_free_pages(src.remove_entry(eid, release_log=False))
        eng.gateway.stats.prefix_migrated += 1
        eng._note_request_event(
            "prefix_migrated", e.rid, now,
            f"aw{src_aw}->aw{best.aw_id}, {e.length} tokens"
            + (f", session={e.session}" if e.session else ""))
        return best.aw_id

    def _materialize(self, target, tokens, rid: str, session, now: float
                     ) -> bool:
        """Rebuild a checkpointed prefix on ``target`` through a scratch
        slot: allocate a free partition slot, replay the committed token
        segments into freshly allocated pages, offer the result to the
        target's cache (which pins its own page references), then release
        the scratch slot either way. Shared by prefix migration and paged
        orphan restoration."""
        eng = self.engine
        committed, _tv, segs = eng.store.restore_request(rid)
        n = min(len(tokens), committed + 1)
        if n < 2 or any(t not in segs for t in range(n)):
            return False
        slot = target.slots.alloc()
        ok = False
        try:
            eng._kv_clear_slot(slot)
            try:
                eng._kv_ensure(slot, n)
            except RuntimeError:
                return False      # page pool exhausted on target
            eng.layout.write_token_segments(
                eng.cache, slot, list(range(n)), [segs[t] for t in range(n)])
            ok = bool(target.prefix_cache.offer(
                slot, np.asarray(tokens[:n], np.int32), rid, session, now))
            if ok:
                eng.store.reassign(rid, target.aw_id)
        finally:
            eng._kv_clear_slot(slot)
            target.slots.release(slot)
        return ok

    # -- completion: adopt the slot ----------------------------------------
    def offer(self, r) -> bool:
        """Cache a finished request's resident prefix. The cached length
        is clamped to the positions its prefill computed, ``len(prompt) -
        1`` (the last prompt token and the generated ones went through
        decode steps, whose kernels round otherwise than the prefill and
        chunk kernels on the card: adopting their KV would give other bits
        than a cold prefill), and to the store's commit watermark (what
        restoration can rebuild); on checkpoint=False engines the resident
        extent is trusted but the entry is not failure-restorable."""
        eng = self.engine
        aw = eng.aws[r._aw]
        if aw.prefix_cache is None:
            return False
        # positions [0, pos) hold KV; [0, len(prompt) - 1) came from prefill
        n = min(r.pos, len(r.prompt) - 1)
        rid = ""
        if eng.ecfg.checkpoint:
            n = min(n, eng.store.committed_token(r.rid) + 1)
        if n < 2:
            return False
        if eng.ecfg.checkpoint:
            # the log outlives the request under a reserved key, so the
            # original rid stays reusable for a fresh submission
            rid = f"~prefix{self._log_seq}:{r.rid}"
            self._log_seq += 1
            eng.store.rename(r.rid, rid)
        seq = np.asarray(r.prompt, np.int32)[:n]
        now = r.t_done if r.t_done >= 0 else float(eng.steps)
        ok = aw.prefix_cache.offer(r.slot, seq, rid, r.session, now)
        if not ok and rid:
            # refused: hand the log back so the caller's release path
            # (store.release(r.rid)) finds it under the original key
            eng.store.rename(rid, r.rid)
        return ok

    def forget_slot(self, aw_id: int, slot: int):
        cache = self.engine.aws[aw_id].prefix_cache
        if cache is not None:
            cache.forget_slot(slot)

    # -- failover: orphan + restore ----------------------------------------
    def note_aw_failed(self, aw_id: int):
        """Snapshot the dying AW's cache *before* worker.fail() clears it:
        checkpoint-backed non-live entries become restorable orphans; the
        rest release their store logs (a live entry's adopter already
        carries the prefix in its own log)."""
        eng = self.engine
        cache = eng.aws[aw_id].prefix_cache
        if cache is None:
            return
        restorable = eng.ecfg.checkpoint and eng.ecfg.prefix_restore
        for e in list(cache.entries.values()):
            # paged entries have no live flag — adoption never consumes
            # them, so every rid-backed entry is a restoration candidate
            if restorable and e.rid and not getattr(e, "live", False):
                self.orphans.append(e)
            elif e.rid:
                eng.store.release(e.rid)

    def restore_orphans(self, now: float = 0.0) -> int:
        """§6.2 applied to cache state: inject each orphaned prefix's
        committed segments into a fresh slot on a healthy AW (the
        session's re-pinned home when affinity placement is active) and
        re-index it there: host bookkeeping and in-place cache writes, no
        new step graph.
        Orphans that cannot land (no free partition slot anywhere, or a
        refused offer) release their store log instead of leaking."""
        eng = self.engine
        restored = 0
        orphans, self.orphans = self.orphans, []
        for e in orphans:
            target = self._pick_target(e, now)
            if target is None:
                eng.store.release(e.rid)
                continue
            if self.paged:
                # replay through a scratch slot into fresh pages on the
                # target's partition; the offered entry pins the pages
                if self._materialize(target, e.tokens, e.rid, e.session,
                                     now):
                    restored += 1
                    eng.gateway.stats.prefix_restored += 1
                    eng._note_request_event(
                        "prefix_restored", e.rid, now,
                        f"aw{target.aw_id}, {e.length} tokens"
                        + (f", session={e.session}" if e.session else ""))
                    if eng.telemetry is not None:
                        eng.telemetry.registry.observe(
                            "prefix.restored_len", e.length)
                else:
                    eng.store.release(e.rid)
                continue
            committed, _tv, segs = eng.store.restore_request(e.rid)
            n = min(e.length, committed + 1)
            if n < 2 or any(t not in segs for t in range(n)):
                target = None
            if target is None:
                eng.store.release(e.rid)
                continue
            slot = target.slots.alloc()
            eng._kv_clear_slot(slot)
            eng.layout.write_token_segments(
                eng.cache, slot, list(range(n)), [segs[t] for t in range(n)])
            eng.store.reassign(e.rid, target.aw_id)
            if target.prefix_cache.insert_restored(
                    slot, e.tokens[:n], e.rid, e.session, now):
                restored += 1
                eng.gateway.stats.prefix_restored += 1
                eng._note_request_event(
                    "prefix_restored", e.rid, now,
                    f"aw{target.aw_id}, {n} tokens"
                    + (f", session={e.session}" if e.session else ""))
                if eng.telemetry is not None:
                    eng.telemetry.registry.observe(
                        "prefix.restored_len", n)
            else:
                eng._kv_clear_slot(slot)
                target.slots.release(slot)
                eng.store.release(e.rid)
        return restored

    def _pick_target(self, e: PrefixEntry, now: float):
        """Failover home for an orphaned prefix: the affinity policy's
        (re-pinned) choice for the entry's session when available, else
        the AW with the most free partition slots. Restoration never
        evicts the target's own entries — it only takes genuinely free
        slots."""
        eng = self.engine
        pol = eng.gateway.policy
        if e.session and isinstance(pol, SessionAffinityPolicy):
            aw_id = pol(eng.gateway.workers, e.session, now=now)
            if aw_id is not None:
                w = eng.aws[aw_id]
                if w.alive and w.slots.free_count() > 0:
                    return w
        best, best_free = None, 0
        for w in eng.aws:
            if w.alive and w.slots.free_count() > best_free:
                best, best_free = w, w.slots.free_count()
        return best

    # -- metrics ------------------------------------------------------------
    def snapshot(self) -> dict:
        per_aw = {}
        for w in self.engine.aws:
            if w.prefix_cache is not None:
                per_aw[w.aw_id] = w.prefix_cache.snapshot()
        return per_aw
