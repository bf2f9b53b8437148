"""Shadow experts (paper §5.3): pre-loaded, normally inactive replicas.

Port of ``repro.core.shadow``. A shadow slot serves the weights of its
resident expert through ``RouteState.slot_expert``. The expert-FFN kernel
reads those rows from the stored bank in place; the gather below is what
its plain version does instead.
"""
from __future__ import annotations

import torch

from repro_torch.core.ert import ExpertPlacement


def resident_slot_bank(expert_params: dict, slot_expert) -> dict:
    """Gather the [..., P, ...] slot bank through ``slot_expert``; empty
    slots (-1) gather row 0 but are never routed to."""
    idx = torch.clamp(slot_expert.long(), min=0)
    return {k: torch.index_select(v, v.dim() - 3, idx)
            for k, v in expert_params.items()}



def shadow_memory_bytes(placement: ExpertPlacement, d_model: int, d_ff: int,
                        bytes_per_el: int = 2, gated: bool = True) -> int:
    """Residual-memory cost of the shadow bank (paper §5.3's budget
    check)."""
    per_expert = (3 if gated else 2) * d_model * d_ff * bytes_per_el
    return placement.num_shadow_slots * per_expert
