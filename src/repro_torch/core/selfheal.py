"""Self-healing state transitions (paper §5), ported from
``repro.core.selfheal``.

Each transition returns a new RouteState whose health tensor has one
entry flipped; the next step routes by it, with nothing rebuilt. Shadow
re-pointing is a placement generation (``core/placement.py``,
``plan_reprotect``). The module also carries the
EW-side "sufficient subset" batching rule (§5.2).
"""
from __future__ import annotations

import numpy as np

from repro_torch.core import ert as ert_lib
from repro_torch.core.refe import RouteState


def _set(mask, idx: int, value: bool):
    out = mask.clone()
    out[idx] = value
    return out


def fail_ew(rs: RouteState, ew_id: int) -> RouteState:
    return rs._replace(ew_health=_set(rs.ew_health, ew_id, False))


def recover_ew(rs: RouteState, ew_id: int) -> RouteState:
    return rs._replace(ew_health=_set(rs.ew_health, ew_id, True))


def fail_aw(rs: RouteState, aw_id: int) -> RouteState:
    return rs._replace(aw_health=_set(rs.aw_health, aw_id, False))


def recover_aw(rs: RouteState, aw_id: int) -> RouteState:
    return rs._replace(aw_health=_set(rs.aw_health, aw_id, True))


def experts_without_healthy_replica(rs: RouteState,
                                    placement: ert_lib.ExpertPlacement
                                    ) -> np.ndarray:
    """Logical experts currently unreachable (every candidate slot parked
    or on a dead EW): their tokens are dropped until provisioning or
    re-protection completes."""
    _, alive = ert_lib.resolve_active_slots(
        rs.candidates, rs.ew_health, rs.slot_owner)
    return (~alive).cpu().numpy().nonzero()[0]


# --------------------------------------------------------------------------
# EW-side sufficient-subset batching (§5.2)
# --------------------------------------------------------------------------

def ew_should_start(received_from: np.ndarray, aw_healthy: np.ndarray,
                    batch_tokens: int, min_batch: int,
                    probe_expired: bool) -> bool:
    """Whether an EW starts expert compute for a layer batch: when (i)
    every currently healthy AW has delivered, or (ii) the buffered batch
    reached the GPU-efficiency knee ``min_batch``, or (iii) the probing
    window for missing AWs expired (they are then treated as failed for
    this layer and their slots omitted)."""
    healthy_delivered = bool(np.all(received_from[aw_healthy]))
    return healthy_delivered or batch_tokens >= min_batch or probe_expired
