"""Shadow experts (paper §5.3): pre-loaded, normally inactive replicas.

Port of ``repro.core.shadow``. A shadow slot serves the weights of its
resident expert through ``RouteState.slot_expert``. The expert-FFN kernel
reads those rows from the stored bank in place; the gather below is what
its plain version does instead.
"""
from __future__ import annotations

import torch


def resident_slot_bank(expert_params: dict, slot_expert) -> dict:
    """Gather the [..., P, ...] slot bank through ``slot_expert``; empty
    slots (-1) gather row 0 but are never routed to."""
    idx = torch.clamp(slot_expert.long(), min=0)
    return {k: torch.index_select(v, v.dim() - 3, idx)
            for k, v in expert_params.items()}

