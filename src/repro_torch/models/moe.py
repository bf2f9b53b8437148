"""Sparse MoE layer wired through the Tarragon REFE datapath (port of
``repro.models.moe``).

Routing runs in the physical slot space (primaries + shadows). The expert
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
from repro_torch.models.layers import dense_init, mlp, mlp_init


def moe_placement(cfg: ModelConfig, num_ew: int) -> ert_lib.ExpertPlacement:
    return ert_lib.default_placement(cfg.moe.num_experts, num_ew,
                                     cfg.moe.num_shadow_slots)


def moe_init(gen, cfg: ModelConfig, placement: ert_lib.ExpertPlacement,
             device="cpu"):
    """One MoE layer's params. The stored bank holds one row per logical
    expert, padded to ``placement.primary_slots``."""
    e_store, d, f = placement.primary_slots, cfg.d_model, cfg.moe.d_ff

    def normal(shape, std):
        return torch.randn(shape, generator=gen, dtype=torch.float32,
                           device=device) * std

    experts = {
        "wg": normal((e_store, d, f), 1.0 / math.sqrt(d)),
        "wu": normal((e_store, d, f), 1.0 / math.sqrt(d)),
        "wd": normal((e_store, f, d), 1.0 / math.sqrt(f)),
    }
    p = {"router": dense_init(gen, d, cfg.moe.num_experts, device=device),
         "experts": experts}
    if cfg.moe.num_shared_experts:
        p["shared"] = mlp_init(gen, d, cfg.moe.shared_d_ff, gated=True,
                               device=device)
    return p


def moe_apply(cfg: ModelConfig, params, x, route_state: refe.RouteState,
              placement: ert_lib.ExpertPlacement,
              capacity: Optional[int] = None, token_mask=None):
    """x: [B, S, D] -> (y [B, S, D], aux_loss, slot_load [P]).

    ``token_mask`` ([B, S] bool) flags real tokens; pads are excluded from
    capacity competition. ``slot_load`` (tokens dispatched per slot) also
    tells the expert kernel which slots are empty."""
    b, s, d = x.shape
    xt = x.reshape(b * s, d)
    logits = xt @ params["router"].to(xt.dtype)
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
                               route_state.slot_expert, counts, act=cfg.act)

    y = refe.expert_io(xt, routing, expert_fn)
    if "shared" in params:
        y = y + mlp(params["shared"], xt, cfg.act)
    return y.reshape(b, s, d), routing["aux_loss"], routing["slot_load"]
