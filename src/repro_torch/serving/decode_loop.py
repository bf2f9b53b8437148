"""Device-side sampling head and per-slot sampling state (port of
``repro.serving.decode_loop`` at ``decode_segment_len = 1``).

Sampling stays on the device; only the [B] token vector crosses to the
host each step. Greedy rows take the plain argmax (first maximum, as
``np.argmax``). Stochastic rows take a Gumbel-max draw over the
temperature-scaled, top-k-masked logits, with noise from a counter-based
hash of (engine seed, request seed, position, vocabulary index): the draw
for a token depends on nothing else, so it is the same whatever the batch,
slot or failover. The hash is the port's own and does not reproduce the
reference's threefry bits; greedy rows are what the two share.
"""
from __future__ import annotations

import zlib
from typing import List, Optional, Tuple

import numpy as np
import torch

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


class DecodeLoopPlane:
    """Per-slot sampling arrays plus the device sampling head."""

    def __init__(self, engine):
        self.engine = engine
        b = engine.ecfg.max_batch
        self.greedy = np.ones((b,), bool)
        self.temperature = np.ones((b,), np.float32)
        self.top_k = np.zeros((b,), np.int32)
        self.seed = np.zeros((b,), np.int64)
        self._dev: Optional[Tuple] = None

    def resolve(self, sampling, rid: str):
        """(greedy, temperature, top_k, seed) for one request; a request
        without sampling params is greedy. The seed defaults to a stable
        hash of the rid, so a replay in any slot draws the same stream."""
        if sampling is None:
            greedy, temp, top_k, seed = True, 1.0, 0, None
        else:
            greedy, temp, top_k = (sampling.greedy, sampling.temperature,
                                   sampling.top_k)
            seed = sampling.seed
        if seed is None:
            seed = zlib.crc32(rid.encode()) & 0x7FFFFFFF
        return bool(greedy), float(temp), int(top_k), int(seed)

    def bind(self, r):
        """Install request r's sampling config on its slot."""
        g, t, k, s = self.resolve(r.sampling, r.rid)
        self.greedy[r.slot] = g
        self.temperature[r.slot] = t
        self.top_k[r.slot] = k
        self.seed[r.slot] = s
        self._dev = None

    def _device_arrays(self):
        if self._dev is None:
            dev = self.engine.device
            self._dev = (torch.as_tensor(self.greedy, device=dev),
                         torch.as_tensor(self.temperature, device=dev),
                         torch.as_tensor(self.top_k, device=dev),
                         torch.as_tensor(self.seed, device=dev),
                         bool((self.top_k > 64).any()))
        return self._dev

    def sample(self, logits, pos_dev):
        """[B] next tokens, sampled on the device from the step's logits."""
        g, t, k, s, deep = self._device_arrays()
        return _sample_tokens(self.engine.ecfg.sample_seed, logits, pos_dev,
                              g, t, k, s, deep_k=deep)

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
