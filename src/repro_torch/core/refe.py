"""Reconfigurable Forwarding Engine (REFE): the AW<->EW datapath.

Port of ``repro.core.refe``. Each AW dispatches token embeddings to expert
slots resolved through the ERT; the dispatch/combine is a capacity-based
one-hot contraction over the physical slot space. Routing tables and health
masks are runtime tensors, so a failover changes where tokens flow without
changing the program.

Self-healing semantics carried in-band (paper §5):
  * EW failure: ``resolve_active_slots`` never routes to a slot on a dead
    EW, so tokens flow to the shadow slot in the same step;
  * AW failure: tokens owned by dead AWs are masked out of the dispatch.
"""
from __future__ import annotations

from typing import NamedTuple, Optional

import numpy as np
import torch
import torch.nn.functional as F

from repro_torch.core import ert as ert_lib


class RouteState(NamedTuple):
    """Runtime routing state passed to every step (tensors, never
    constants of the program)."""

    candidates: torch.Tensor      # [E, R] int32 — ERT, priority order
    ew_health: torch.Tensor       # [max_ew] bool
    aw_health: torch.Tensor       # [num_aw] bool
    slot_expert: torch.Tensor     # [P] int32 — resident expert per slot
    slot_owner: torch.Tensor      # [P] int32 — EW owning each slot
    split_slot: torch.Tensor      # [E] int32 — load-bearing replica (-1)

    @staticmethod
    def healthy(placement: ert_lib.ExpertPlacement, num_aw: int,
                shadow_assignment=None, num_ew: int = 0,
                device="cpu") -> "RouteState":
        """The identity layout (primary slot e = expert e, shadows per
        ``shadow_assignment``); ``num_ew`` oversizes the EW-health axis."""
        if shadow_assignment is None:
            shadow_assignment = ert_lib.initial_shadow_assignment(placement)
        shadow_assignment = np.asarray(shadow_assignment)
        cand = ert_lib.build_candidates(placement, shadow_assignment)
        max_ew = max(num_ew, placement.num_ew)
        health = np.zeros((max_ew,), bool)
        health[: placement.num_ew] = True

        def dev(a, dtype):
            return torch.as_tensor(np.asarray(a), dtype=dtype, device=device)

        return RouteState(
            candidates=dev(cand, torch.int32),
            ew_health=dev(health, torch.bool),
            aw_health=torch.ones((num_aw,), dtype=torch.bool, device=device),
            slot_expert=dev(ert_lib.initial_slot_expert(
                placement, shadow_assignment), torch.int32),
            slot_owner=dev(placement.slot_owner(), torch.int32),
            split_slot=torch.full((placement.num_experts,), -1,
                                  dtype=torch.int32, device=device),
        )


def token_aw_owner(num_tokens: int, num_aw: int, batch: int = 0,
                   device="cpu"):
    """AW owning each token (batch rows are data-parallel over AWs, so
    ownership is contiguous row blocks)."""
    batch = batch or num_tokens
    seq = max(1, num_tokens // batch)
    row = torch.arange(num_tokens, device=device) // seq
    return torch.clamp(row * num_aw // batch, max=num_aw - 1)


# Above this token count the flat [T, P, C] one-hot dispatch switches to
# GShard-style grouped dispatch with per-group capacity.
ONEHOT_MAX_TOKENS = 2048
GROUP_SIZE = 512


def intra_slot_positions(slot_idx, valid, num_slots: int):
    """Rank of each (token, choice) within its target slot, per group, in
    flat (t, k) arrival order. slot_idx/valid: [G, S, K] -> [G, S, K]."""
    g, s, k = slot_idx.shape
    flat = slot_idx.reshape(g, s * k).long()
    oh = F.one_hot(flat, num_slots) * valid.reshape(g, s * k, 1).long()
    pos = torch.cumsum(oh, dim=1) - oh
    pos = torch.gather(pos, 2, flat[..., None])[..., 0]
    return pos.reshape(g, s, k)


def stable_top_k(x, k: int):
    """Top-k along the last axis with ties broken toward the lower index,
    as ``jax.lax.top_k`` does (``torch.topk`` promises no tie order)."""
    vals, idx = torch.sort(x, dim=-1, descending=True, stable=True)
    return vals[..., :k], idx[..., :k]


def route(x, router_logits, route_state: RouteState,
          placement: ert_lib.ExpertPlacement, *, top_k: int,
          capacity_factor: float, capacity: Optional[int] = None,
          batch: int = 0, token_mask=None):
    """Full REFE routing decision for a flat token batch.

    x: [T, D]; router_logits: [T, E]. ``token_mask`` ([T] bool) flags real
    tokens; pads never compete for capacity. Returns routing metadata for
    ``expert_io``."""
    t, e = router_logits.shape
    dev = router_logits.device
    slot_owner = route_state.slot_owner
    active_slot, expert_alive = ert_lib.resolve_active_slots(
        route_state.candidates, route_state.ew_health, slot_owner)

    probs = torch.softmax(router_logits.float(), dim=-1)
    # dead experts (no healthy replica anywhere) are masked from selection
    probs = probs * expert_alive[None, :].float()
    gate_w, topk_idx = stable_top_k(probs, top_k)              # [T, K]
    gate_w = gate_w / torch.clamp(gate_w.sum(dim=-1, keepdim=True), min=1e-9)

    slot_idx = active_slot[topk_idx]                            # [T, K]

    # load-bearing replicas: tokens of a split expert alternate between
    # its active slot and the replica by (token, choice) parity while the
    # replica's owner is healthy
    split = route_state.split_slot[topk_idx].long()
    sp_owner = slot_owner[torch.clamp(split, min=0)].long()
    sp_ok = (split >= 0) & (sp_owner >= 0) & \
        route_state.ew_health[torch.clamp(sp_owner, min=0)]
    parity = (torch.arange(t, device=dev)[:, None] +
              torch.arange(top_k, device=dev)[None, :]) % 2
    slot_idx = torch.where(sp_ok & (parity == 1),
                           torch.clamp(split, min=0).to(torch.int32),
                           slot_idx)

    # EW-side self-healing: drop tokens from failed AWs; pad-free dispatch
    owner = token_aw_owner(t, route_state.aw_health.shape[0], batch=batch,
                           device=dev)
    token_valid = route_state.aw_health[owner]
    if token_mask is not None:
        token_valid = token_valid & token_mask

    grouped = t > ONEHOT_MAX_TOKENS
    if grouped:
        s_g = GROUP_SIZE
        while t % s_g:
            s_g //= 2
        g = t // s_g
    else:
        g, s_g = 1, t
    if capacity is None:
        capacity = int(max(1, round(capacity_factor * top_k * s_g / e)))

    valid = token_valid[:, None] & (gate_w > 0)
    pos = intra_slot_positions(slot_idx.reshape(g, s_g, top_k),
                               valid.reshape(g, s_g, top_k),
                               placement.num_slots).reshape(t, top_k)
    keep = valid & (pos < capacity)

    # load-balance auxiliary loss (Switch-style), over logical experts
    me = probs.mean(dim=0)
    ce = F.one_hot(topk_idx, e).float().sum(dim=1).mean(dim=0) / top_k
    aux_loss = e * torch.sum(me * ce)

    # per-slot dispatch load: tokens actually dispatched
    slot_load = torch.zeros((placement.num_slots,), dtype=torch.float32,
                            device=dev).index_add_(
        0, slot_idx.reshape(-1).long(), keep.reshape(-1).float())

    return {
        "capacity": capacity,
        "num_slots": placement.num_slots,
        "active_slot": active_slot,    # [E]
        "expert_alive": expert_alive,  # [E]
        "token_valid": token_valid,    # [T]
        "slot_idx": slot_idx,          # [T, K]
        "pos": pos,                    # [T, K]
        "keep": keep,                  # [T, K]
        "topk_idx": topk_idx,
        "gate_w": gate_w,
        "aux_loss": aux_loss,
        "slot_load": slot_load,        # [P]
        "grouped": grouped,
        "groups": g,
        "group_size": s_g,
    }


def _pos_onehot(pos, c: int, dtype):
    """one_hot(pos, c) with all-zero rows for pos >= c (jax.nn.one_hot's
    out-of-range rule; torch's one_hot would raise)."""
    inside = (pos < c)[..., None].to(dtype)
    return F.one_hot(torch.clamp(pos.long(), max=c - 1), c).to(dtype) * inside


def routing_onehots(routing):
    """[T, P, C] dispatch/combine one-hots (the flat path)."""
    p, c = routing["num_slots"], routing["capacity"]
    slot_oh = F.one_hot(routing["slot_idx"].long(), p).float()
    slot_oh = slot_oh * routing["keep"].float()[..., None]
    pos_oh = _pos_onehot(routing["pos"], c, torch.float32)
    dispatch = torch.einsum("tkp,tkc->tpc", slot_oh, pos_oh)
    combine = torch.einsum("tkp,tkc->tpc",
                           slot_oh * routing["gate_w"][..., None], pos_oh)
    return dispatch, combine


def expert_io(x, routing, expert_fn):
    """The paper's ``expert_io``: scatter token embeddings to expert slots,
    run expert compute, gather. x: [T, D]; expert_fn: [P, C, D] (flat) or
    [P, G, C, D] (grouped) -> same shape. Returns y [T, D].

    The reference contracts [T, P, C] one-hots (``routing_onehots``); the
    port moves the same rows with an indexed scatter and gather, and sums
    each token's expert outputs in choice order (k = 0, 1, ...) in float32.
    That order does not depend on which slot served an expert, so a token
    rerouted to a shadow slot gets bitwise the same output."""
    t, d = x.shape
    p, c = routing["num_slots"], routing["capacity"]
    g, s_g = routing["groups"], routing["group_size"]
    keep = routing["keep"]
    k = keep.shape[1]
    grp = (torch.arange(t, device=x.device) // s_g)[:, None]
    cell = (routing["slot_idx"].long() * g + grp) * c + \
        torch.clamp(routing["pos"].long(), max=c - 1)
    spare = p * g * c                     # dropped choices land here
    cell = torch.where(keep, cell, torch.full_like(cell, spare)).reshape(-1)

    expert_in = torch.zeros((spare + 1, d), dtype=x.dtype, device=x.device)
    expert_in[cell] = x[:, None, :].expand(t, k, d).reshape(t * k, d)
    shape = (p, g, c, d) if routing["grouped"] else (p, c, d)
    expert_out = expert_fn(expert_in[:spare].reshape(shape))
    out = torch.cat([expert_out.reshape(spare, d),
                     torch.zeros((1, d), dtype=expert_out.dtype,
                                 device=x.device)])
    picked = out[cell].reshape(t, k, d).float()
    # combine weights take the expert output's dtype first, as the
    # reference's ``combine.astype(expert_out.dtype)`` does
    w = (routing["gate_w"] * keep).to(expert_out.dtype).float()
    y = picked[:, 0] * w[:, 0, None]
    for kk in range(1, k):
        y = y + picked[:, kk] * w[:, kk, None]
    return y.to(expert_out.dtype)
