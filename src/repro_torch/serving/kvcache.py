"""Per-request slot operations over the contiguous KV cache (port of the
``CacheLayout`` half of ``repro.serving.kvcache``).

The port's cache is ``{"layers": [{"k", "v", "pos"}, ...]}`` with the
request slot as axis 0 of every tensor, so the reference's leaf discovery
(batch axis, attention vs state leaves) is not needed. Writes are in place.
The paged layout and the checkpoint extractors arrive with their slices.
"""
from __future__ import annotations

from typing import Dict, List

import torch


class CacheLayout:
    """Slot-level operations on a contiguous attention cache."""

    def request_state(self, cache, row: int) -> List[Dict[str, torch.Tensor]]:
        """One row of every layer's cache (views, not copies)."""
        return [{k: t[row] for k, t in layer.items()}
                for layer in cache["layers"]]

    def scrub_request_state(self, state, valid_len: int):
        """Invalidate pad entries of a batched-prefill row: positions
        >= ``valid_len`` become -1, which the decode kernels mask. K/V
        payloads stay; they are unreachable once the position is -1."""
        out = []
        for layer in state:
            pos = layer["pos"]
            out.append(dict(layer, pos=torch.where(
                pos >= valid_len, torch.full_like(pos, -1), pos)))
        return out

    def write_request_state(self, cache, slot: int, state):
        for layer, st in zip(cache["layers"], state):
            for k, t in layer.items():
                t[slot].copy_(st[k])
        return cache

    def clear_slot(self, cache, slot: int):
        """Reset one slot (a finished or released request)."""
        for layer in cache["layers"]:
            layer["k"][slot].zero_()
            layer["v"][slot].zero_()
            layer["pos"][slot].fill_(-1)
        return cache

    def prefill_paddable(self, cache, max_seq: int) -> bool:
        """True when slot index == absolute position in every layer (full
        attention, no ring wrap): the precondition for padded prefill."""
        return all(layer["k"].shape[1] >= max_seq
                   for layer in cache["layers"])
