"""Self-healing state transitions (paper §5), ported from
``repro.core.selfheal``.

Each transition returns a new RouteState whose health tensor has one
entry flipped; the next step routes by it, with nothing rebuilt.
"""
from __future__ import annotations

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
