"""The device decode loop (port of ``repro.serving.decode_loop``): the
sampling head, per-slot sampling state, decode segments and the step
graphs.

Sampling stays on the device; only the tokens cross to the host. Greedy
rows take the plain argmax (first maximum, as ``np.argmax``). Stochastic
rows take a Gumbel-max draw over the temperature-scaled, top-k-masked
logits, with noise from a counter-based hash of (engine seed, request
seed, position, vocabulary index): the draw for a token depends on
nothing else, so it is the same whatever the batch, slot or failover. The
hash is the port's own and does not reproduce the reference's threefry
bits; greedy rows are what the two share.

A decode *segment* runs ``seg_len`` steps of decode, sampling and the stop
mask on the device (``decode_segment_len``; 1 is the per-step cadence):
a row that reaches ``max_new`` or the cache ceiling mid-segment turns to
pos -1 for the rest of it, so it writes no KV and claims no expert
capacity, exactly as between host-driven steps. Tokens collect in a
[seg_len, B] ring (-1 = row inactive at that step) that drains to the
host once per segment.

The step reads only buffers the plane owns (inputs, sampling arrays, a
copy of the RouteState, filled before every step) besides the weights and
the cache, which is written in place. On the card each (seg_len, deep
top-k, paged) key's first step runs eagerly, which does every lazy set-up
(kernel builds, function attributes, tensor maps, plans), and is then
captured as a CUDA graph that every later step of that key replays: the
counterpart of the reference's ``jax.jit`` of the step and ``lax.scan`` of
the segment. A CPU engine runs the same function eagerly at every step
and keeps the same key set (``captures``). Kernel launch counts captured
in a graph are added on each replay (``kernels.build.count``).

When the engine collects dispatch loads (the placement plane), each
step's per-slot loads [seg_len, P] go to a pinned host buffer by a copy
queued before the token ring's copy, so the ring's one device-to-host
drain brings both: no second sync a step, and nothing in the graphs.
"""
from __future__ import annotations

import gc
import zlib
from typing import Dict, List, Optional

import numpy as np
import torch

from repro_torch.core.refe import RouteState
from repro_torch.kernels import build
from repro_torch.serving.telemetry import host_span

_M32 = 0xFFFFFFFF
# odd multipliers below 2**31, so every product fits in a signed int64
_C1, _C2, _C3 = 0x7FEB352D, 0x2C1B3C6D, 0x297A2D39


def _mix32(x):
    """A 32-bit integer finaliser on int64 tensors holding uint32 values."""
    x = x & _M32
    x = x ^ (x >> 16)
    x = (x * _C1) & _M32
    x = x ^ (x >> 15)
    x = (x * _C2) & _M32
    x = x ^ (x >> 16)
    return x


def gumbel_noise(engine_seed: int, seed, pos, vocab: int):
    """[B, V] float32 Gumbel noise keyed on (engine seed, request seed,
    position, vocabulary index)."""
    dev = seed.device
    row = _mix32(_mix32(torch.full_like(seed.long(), engine_seed & _M32)
                        ^ (seed.long() & _M32)) ^ (pos.long() & _M32))
    col = torch.arange(vocab, dtype=torch.int64, device=dev)
    h = _mix32(row[:, None] ^ ((col * _C3) & _M32))
    u = (h.double() + 0.5) / 4294967296.0
    return (-torch.log(-torch.log(u))).float()


def _sample_tokens(engine_seed: int, logits, pos, greedy, temperature,
                   top_k, seed, *, deep_k: bool):
    """logits [B,V]; pos/greedy/temperature/top_k/seed [B] tensors on the
    logits' device. ``deep_k`` (a host bool) says some row asks for a top-k
    deeper than the static 64-wide slice."""
    lg = logits.float()
    v = lg.shape[-1]
    gre = torch.argmax(lg, dim=-1).to(torch.int32)
    t = torch.clamp(temperature, min=1e-6)[:, None]
    scaled = lg / t
    # per-row top-k: the kth-largest value is the threshold; ties at it
    # are kept. A static 64-wide slice serves the usual small k.
    k = torch.clamp(top_k.long(), 0, v)
    kc = min(v, 64)
    if deep_k:
        srt = torch.sort(scaled, dim=-1, descending=True).values
        kidx = torch.where(k > 0, k - 1, torch.full_like(k, v - 1))
        kth = torch.gather(srt, 1, kidx[:, None])
    else:
        vals = torch.topk(scaled, kc, dim=-1).values
        kth = torch.gather(vals, 1, torch.clamp(k - 1, 0, kc - 1)[:, None])
    keep = torch.where((k > 0)[:, None], scaled >= kth,
                       torch.ones_like(scaled, dtype=torch.bool))
    masked = torch.where(keep, scaled, torch.full_like(scaled, -float("inf")))
    noise = gumbel_noise(engine_seed, seed, torch.clamp(pos, min=0), v)
    samp = torch.argmax(masked + noise, dim=-1).to(torch.int32)
    return torch.where(greedy, gre, samp)


class StepGraph:
    """One captured decode step or segment: the CUDA graph, its outputs
    (the token ring and the per-step slot loads, in the graph's memory
    pool, rewritten by each replay) and the launch counts it adds on
    each replay."""

    def __init__(self, fn):
        self.graph = torch.cuda.CUDAGraph()
        # a dead engine's graphs must not be destroyed while this one
        # captures (a graph's reset is not permitted then, and it voids the
        # capture): collect the cycles an engine leaves first, and hold the
        # collector off until the capture ends
        gc.collect()
        enabled = gc.isenabled()
        gc.disable()
        try:
            with build.deferred_counts() as counts, \
                    torch.cuda.graph(self.graph):
                self.out = fn()
        finally:
            if enabled:
                gc.enable()
        self.counts = counts

    def replay(self):
        self.graph.replay()
        for add in self.counts:
            add()
        return self.out


class DecodeLoopPlane:
    """Per-slot sampling state, the step's device buffers, the decode
    segment and its graphs."""

    def __init__(self, engine):
        self.engine = engine
        ecfg = engine.ecfg
        b = ecfg.max_batch
        dev = engine.device
        self.seg_len = max(1, int(ecfg.decode_segment_len))
        self.greedy = np.full((b,), bool(ecfg.greedy))
        self.temperature = np.full((b,), float(ecfg.temperature), np.float32)
        self.top_k = np.full((b,), int(ecfg.top_k), np.int32)
        self.seed = np.zeros((b,), np.int64)
        # the step's device buffers: rows tokens, pos, emitted, max_new of
        # ``inputs`` (filled from a pinned host twin before every step),
        # the sampling arrays (rewritten after a bind) and the RouteState
        # copy (made at the first step)
        self._host_in = torch.zeros((4, b), dtype=torch.int32,
                                    pin_memory=dev.type == "cuda")
        self.inputs = torch.zeros((4, b), dtype=torch.int32, device=dev)
        self.sampling = (torch.ones((b,), dtype=torch.bool, device=dev),
                         torch.ones((b,), dtype=torch.float32, device=dev),
                         torch.zeros((b,), dtype=torch.int32, device=dev),
                         torch.zeros((b,), dtype=torch.int64, device=dev))
        self._sampling_stale = True
        self.route_state: Optional[RouteState] = None
        #: (seg_len, deep top-k, paged, decode capacity) -> its StepGraph
        #: (None on the CPU)
        self.graphs: Dict[tuple, Optional[StepGraph]] = {}
        self.loads = None      # [seg_len, P] slot loads of the last step
        self.host_loads: Optional[np.ndarray] = None   # their host copy
        self._pinned_loads: Dict[int, torch.Tensor] = {}

    def resolve(self, sampling, rid: str):
        """(greedy, temperature, top_k, seed) for one request; a request
        without sampling params takes the engine's (``EngineConfig``'s
        greedy, temperature, top_k). The seed defaults to a stable hash of
        the rid, so a replay in any slot draws the same stream."""
        if sampling is None:
            ecfg = self.engine.ecfg
            greedy, temp, top_k, seed = (ecfg.greedy, ecfg.temperature,
                                         ecfg.top_k, None)
        else:
            greedy, temp, top_k = (sampling.greedy, sampling.temperature,
                                   sampling.top_k)
            seed = sampling.seed
        if seed is None:
            seed = zlib.crc32(rid.encode()) & 0x7FFFFFFF
        return bool(greedy), float(temp), int(top_k), int(seed)

    def bind(self, r):
        """Install request r's sampling config on its slot (an array
        write: never a new capture)."""
        g, t, k, s = self.resolve(r.sampling, r.rid)
        self.greedy[r.slot] = g
        self.temperature[r.slot] = t
        self.top_k[r.slot] = k
        self.seed[r.slot] = s
        self._sampling_stale = True

    # -- the step ------------------------------------------------------------
    def segment(self, seg_len: int, deep_k: bool, route_state: RouteState):
        """``seg_len`` decode + sample + stop-mask steps from the plane's
        input and sampling buffers, writing the cache in place. Returns
        (ring [seg_len, B] int32, -1 = row inactive at that step; slot
        loads [seg_len, P] float32). What a step graph captures."""
        eng = self.engine
        max_seq = eng.ecfg.max_seq
        tokens, pos, emitted, max_new = self.inputs
        g, t, k, s = self.sampling
        ring, loads = [], []
        with torch.no_grad():
            for _ in range(seg_len):
                active = pos >= 0
                logits, _, load = eng.api.decode(
                    eng.params, tokens, pos, eng.cache, route_state,
                    capacity=eng.decode_capacity)
                nxt = _sample_tokens(eng.ecfg.sample_seed, logits, pos, g, t,
                                     k, s, deep_k=deep_k)
                emitted = emitted + active.to(torch.int32)
                # stop mask: a row that reached max_new or the cache
                # ceiling leaves the active set for the rest of the segment
                alive = active & (emitted < max_new) & (pos + 1 < max_seq - 1)
                ring.append(torch.where(active, nxt, -1))
                loads.append(load)
                tokens = torch.where(active, nxt, tokens)
                pos = torch.where(alive, pos + 1, -1)
            return torch.stack(ring), torch.stack(loads)

    def load(self, act, seg_len: int) -> tuple:
        """Fill the step's buffers for the active set and map every page a
        segment can write; returns the step's graph key."""
        eng = self.engine
        hi = self._host_in.numpy()
        hi[0], hi[1], hi[2] = 0, -1, 0
        hi[3] = np.iinfo(np.int32).max
        for r in act:
            hi[:, r.slot] = (r.next_input, r.pos, len(r.tokens), r.max_new)
            # paged: KV writes happen on the device up to pos + seg_len - 1
            eng._kv_ensure(r.slot, min(r.pos + seg_len,
                                       eng.ecfg.max_seq - 1))
        self.inputs.copy_(self._host_in, non_blocking=True)
        if self._sampling_stale:
            for dst, src in zip(self.sampling, (self.greedy, self.temperature,
                                                self.top_k, self.seed)):
                dst.copy_(torch.from_numpy(src))
            self._sampling_stale = False
        if self.route_state is None:
            self.route_state = RouteState(*(t.clone()
                                            for t in eng.route_state))
        else:
            # selfheal and re-pointing return new tensors: a graph reads
            # this copy, never the engine's current ones
            for dst, src in zip(self.route_state, eng.route_state):
                dst.copy_(src)
        return (seg_len, bool((self.top_k > 64).any()), eng.pages is not None,
                eng.decode_capacity)

    def run(self, act, seg_len: int) -> np.ndarray:
        """One decode dispatch of ``seg_len`` steps over the active set:
        a graph replay on the card (after the key's first, eager, step),
        the eager segment on the CPU. Returns the token ring on the host,
        the dispatch's one device-to-host drain. Host spans:
        ``decode.load``, ``decode.replay`` (``captured``: the key's eager
        step and capture) and ``decode.drain``."""
        with host_span("decode.load"):
            key = self.load(act, seg_len)
        graph = self.graphs.get(key)
        with host_span("decode.replay", captured=key not in self.graphs):
            if graph is not None:
                ring, self.loads = graph.replay()
            else:
                ring, self.loads = self.segment(key[0], key[1],
                                                self.route_state)
                self.graphs[key] = self.capture(key) \
                    if self.engine.device.type == "cuda" else None
        tel = self.engine.telemetry
        if tel is not None and seg_len > 1:
            # host counters only: the dispatch above is untouched
            tel.registry.inc("decode.segments")
            tel.registry.inc("decode.segment_steps", seg_len)
            tel.registry.observe("decode.segment_rows", len(act))
        if self.engine.collect_load:
            # queued on the step's stream ahead of the ring's copy, so the
            # ring's synchronising copy below completes it too
            buf = self._pinned_loads.get(seg_len)
            if buf is None:
                buf = self._pinned_loads[seg_len] = torch.empty(
                    tuple(self.loads.shape), dtype=torch.float32,
                    pin_memory=self.loads.is_cuda)
            buf.copy_(self.loads, non_blocking=True)
            self.host_loads = buf.numpy()
        with host_span("decode.drain"):
            return ring.cpu().numpy()

    def capture(self, key) -> StepGraph:
        """The step graph of ``key`` (seg_len, deep top-k, paged, decode
        capacity), captured after a step of that key ran eagerly."""
        return StepGraph(lambda: self.segment(key[0], key[1],
                                              self.route_state))

    def captures(self) -> int:
        """Step graphs captured (on the CPU, keys seen): segment tails,
        finished rows, recoveries and sampling changes add none."""
        return len(self.graphs)

    def sample_rows(self, logits, entries, pos_list: List[int]):
        """First tokens of an exact-scheme prefill group: row i belongs to
        ``entries[i]``, whose last prompt position is ``pos_list[i]``."""
        rows = logits.shape[0]
        g = np.ones((rows,), bool)
        t = np.ones((rows,), np.float32)
        k = np.zeros((rows,), np.int32)
        s = np.zeros((rows,), np.int64)
        p = np.zeros((rows,), np.int32)
        for i, q in enumerate(entries):
            g[i], t[i], k[i], s[i] = self.resolve(q.sampling, q.rid)
            p[i] = pos_list[i]
        dev = logits.device
        out = _sample_tokens(self.engine.ecfg.sample_seed, logits,
                             torch.as_tensor(p, device=dev),
                             torch.as_tensor(g, device=dev),
                             torch.as_tensor(t, device=dev),
                             torch.as_tensor(k, device=dev),
                             torch.as_tensor(s, device=dev),
                             deep_k=bool((k > 64).any()))
        return out.cpu().numpy()
