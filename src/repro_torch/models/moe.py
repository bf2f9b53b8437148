"""Sparse MoE layer wired through the Tarragon REFE datapath (port of
``repro.models.moe``).

Routing runs in the physical slot space (primaries + shadows; with
``tarragon`` False, the MegaScale-Infer-style static binding, there are no
shadow slots and an expert on a dead EW has nowhere to go). The expert
FFN reads each slot's weights from the stored per-expert bank through
``RouteState.slot_expert``; the reference's per-layer gather of the whole
slot bank (``shadow.resident_slot_bank``) is not carried over.
"""
from __future__ import annotations

import math
from typing import Optional

import torch

from repro_torch.configs.base import ModelConfig
from repro_torch.core import ert as ert_lib
from repro_torch.core import refe
from repro_torch.kernels import ops as kops
from repro_torch.models.layers import (dense_init, matmul, mlp, mlp_init,
                                       normal)


def moe_placement(cfg: ModelConfig, num_ew: int,
                  tarragon: bool = True) -> ert_lib.ExpertPlacement:
    n_shadow = cfg.moe.num_shadow_slots if tarragon else 0
    return ert_lib.default_placement(cfg.moe.num_experts, num_ew, n_shadow)


def moe_init(gen, cfg: ModelConfig, placement: ert_lib.ExpertPlacement,
             device, dtype=torch.float32):
    """One MoE layer's params, each tensor in ``dtype`` as soon as it is
    drawn. The stored bank holds one row per logical expert, padded to
    ``placement.primary_slots``."""
    e_store, d, f = placement.primary_slots, cfg.d_model, cfg.moe.d_ff
    experts = {
        "wg": normal(gen, (e_store, d, f), 1.0 / math.sqrt(d), device, dtype),
        "wu": normal(gen, (e_store, d, f), 1.0 / math.sqrt(d), device, dtype),
        "wd": normal(gen, (e_store, f, d), 1.0 / math.sqrt(f), device, dtype),
    }
    p = {"router": dense_init(gen, d, cfg.moe.num_experts, device=device,
                              dtype=dtype),
         "experts": experts}
    if cfg.moe.num_shared_experts:
        p["shared"] = mlp_init(gen, d, cfg.moe.shared_d_ff, gated=True,
                               device=device, dtype=dtype)
    return p


def moe_apply(cfg: ModelConfig, params, x, route_state: refe.RouteState,
              placement: ert_lib.ExpertPlacement,
              capacity: Optional[int] = None, token_mask=None, *,
              decode: bool):
    """x: [B, S, D] -> (y [B, S, D], aux_loss, slot_load [P]).

    ``token_mask`` ([B, S] bool) flags real tokens; pads are excluded from
    capacity competition. ``slot_load`` (tokens dispatched per slot) also
    tells the expert kernel which slots are empty. ``decode`` marks a
    decode step; a prefill or chunk call runs the router in fixed row
    blocks and keeps the expert kernel on its tile paths, so a token's
    bits do not depend on how many tokens share the call."""
    b, s, d = x.shape
    xt = x.reshape(b * s, d)
    logits = matmul(xt, params["router"].to(xt.dtype), not decode)
    routing = refe.route(
        xt, logits, route_state, placement,
        top_k=cfg.moe.top_k, capacity_factor=cfg.moe.capacity_factor,
        capacity=capacity, batch=b,
        token_mask=None if token_mask is None else token_mask.reshape(b * s))

    ex = params["experts"]
    counts = routing["slot_load"].to(torch.int32)

    def expert_fn(expert_in):
        return kops.expert_ffn(expert_in, ex["wg"].to(x.dtype),
                               ex["wu"].to(x.dtype), ex["wd"].to(x.dtype),
                               route_state.slot_expert, counts, act=cfg.act,
                               decode=decode)

    y = refe.expert_io(xt, routing, expert_fn)
    if "shared" in params:
        y = y + mlp(params["shared"], xt, cfg.act, blocked=not decode)
    return y.reshape(b, s, d), routing["aux_loss"], routing["slot_load"]
