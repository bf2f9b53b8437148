"""Decoder stack for the transformer MoE family (port of
``repro.models.transformer``), Mixtral first.

The reference scans stacked layer params with ``lax.scan``; here the params
hold a plain list of per-layer dicts and the stack is a Python loop. MoE
layers route through the Tarragon REFE datapath (models/moe.py).
"""
from __future__ import annotations

from typing import Any, Callable, NamedTuple, Optional

import torch

from repro_torch.configs.base import ModelConfig
from repro_torch.core import ert as ert_lib
from repro_torch.core import refe
from repro_torch.models import attention as attn
from repro_torch.models import moe as moe_mod
from repro_torch.models.layers import (embed_init, mlp, mlp_init, rmsnorm,
                                       rmsnorm_init, unembed)


class ModelApi(NamedTuple):
    cfg: ModelConfig
    placement: Optional[ert_lib.ExpertPlacement]
    num_aw: int
    num_ew: int
    device: torch.device
    init_params: Callable[..., Any]     # (generator) -> params
    init_cache: Callable[..., Any]      # (batch, max_seq) -> caches
    prefill: Callable[..., Any]         # -> (last_logits, caches, load)
    decode: Callable[..., Any]          # -> (logits, caches, load)
    init_route_state: Callable[..., refe.RouteState]


def layer_windows(cfg: ModelConfig):
    """Sliding window of every layer in stack order (0 = full)."""
    unit = []
    for kind in cfg.attn_pattern:
        unit.append(0 if kind == "global" else cfg.sliding_window)
    n_first = cfg.moe.first_k_dense if cfg.moe.enabled else 0
    scanned = cfg.num_layers - n_first
    if scanned % len(unit):
        raise ValueError(f"{cfg.name}: {scanned} layers not divisible by "
                         f"pattern {cfg.attn_pattern}")
    return [unit[0]] * n_first + [unit[i % len(unit)]
                                  for i in range(scanned)]


def _layer_init(gen, cfg: ModelConfig, use_moe: bool, placement, device):
    p = {"ln1": rmsnorm_init(cfg.d_model, device),
         "attn": attn.attn_init(gen, cfg, device),
         "ln2": rmsnorm_init(cfg.d_model, device)}
    if use_moe:
        p["moe"] = moe_mod.moe_init(gen, cfg, placement, device)
    else:
        p["mlp"] = mlp_init(gen, cfg.d_model, cfg.d_ff or cfg.moe.d_ff,
                            cfg.mlp_gated, device)
    return p


def _layer_apply(cfg: ModelConfig, p, x, *, window: int, mode: str,
                 positions=None, pos=None, cache=None, route_state=None,
                 placement=None, capacity=None, token_mask=None):
    """mode: 'prefill' | 'decode'. Returns (x, cache, slot load)."""
    h = rmsnorm(p["ln1"], x, cfg.norm_eps)
    if mode == "decode":
        a, cache = attn.attn_decode(cfg, p["attn"], h, cache, pos,
                                    window=window)
    else:
        a, cache = attn.attn_full(cfg, p["attn"], h, positions,
                                  window=window, cache=cache)
    x = x + a
    h = rmsnorm(p["ln2"], x, cfg.norm_eps)
    if "moe" in p:
        f, _, load = moe_mod.moe_apply(cfg, p["moe"], h, route_state,
                                       placement, capacity=capacity,
                                       token_mask=token_mask)
    else:
        f = mlp(p["mlp"], h, cfg.act)
        n_slots = placement.num_slots if placement is not None else 0
        load = torch.zeros((n_slots,), dtype=torch.float32, device=x.device)
    return x + f, cache, load


def cast_floats(tree, dtype):
    """Cast every floating tensor of a nested dict/list to ``dtype``."""
    if isinstance(tree, dict):
        return {k: cast_floats(v, dtype) for k, v in tree.items()}
    if isinstance(tree, list):
        return [cast_floats(v, dtype) for v in tree]
    return tree.to(dtype) if tree.is_floating_point() else tree


def build_decoder(cfg: ModelConfig, *, num_aw: int = 1, num_ew: int = 1,
                  device="cuda") -> ModelApi:
    device = torch.device(device)
    windows = layer_windows(cfg)
    n_first = cfg.moe.first_k_dense if cfg.moe.enabled else 0
    placement = (moe_mod.moe_placement(cfg, num_ew)
                 if cfg.moe.enabled else None)
    dtype = cfg.torch_dtype
    n_slots = placement.num_slots if placement is not None else 0

    def init_params(gen: torch.Generator):
        """Seeded params with the reference's shapes and scales, drawn on
        ``gen``'s device layer by layer and cast to the config dtype."""
        params = {"embed": embed_init(gen, cfg.vocab_size, cfg.d_model,
                                      device),
                  "final_norm": rmsnorm_init(cfg.d_model, device)}
        if not cfg.tie_embeddings:
            params["unembed"] = embed_init(gen, cfg.vocab_size, cfg.d_model,
                                           device)
        params = cast_floats(params, dtype)
        params["layers"] = [
            cast_floats(_layer_init(gen, cfg, cfg.moe.enabled and
                                    i >= n_first, placement, device), dtype)
            for i in range(cfg.num_layers)]
        return params

    def init_cache(batch: int, max_seq: int):
        return {"layers": [attn.init_cache(cfg, batch, max_seq, window=w,
                                           device=device)
                           for w in windows]}

    def _run_stack(params, x, mode, positions=None, pos=None, caches=None,
                   route_state=None, capacity=None, token_mask=None):
        load_total = torch.zeros((n_slots,), dtype=torch.float32,
                                 device=x.device)
        for i, lp in enumerate(params["layers"]):
            c = caches["layers"][i] if caches is not None else None
            x, c, load = _layer_apply(
                cfg, lp, x, window=windows[i], mode=mode,
                positions=positions, pos=pos, cache=c,
                route_state=route_state, placement=placement,
                capacity=capacity, token_mask=token_mask)
            load_total = load_total + load
        return rmsnorm(params["final_norm"], x, cfg.norm_eps), load_total

    def _embed(params, tokens):
        return params["embed"].to(dtype)[tokens.long()]

    @torch.no_grad()
    def prefill(params, tokens, route_state, max_seq: int, capacity=None,
                mask=None):
        """tokens: [B, S] int; ``mask`` ([B, S] bool) flags real tokens,
        so pads never compete for expert capacity. Returns
        (last-position logits [B, V], fresh caches, slot load [P])."""
        b, s = tokens.shape
        positions = torch.arange(s, dtype=torch.int32,
                                 device=device).expand(b, s)
        caches = init_cache(b, max_seq)
        x, load = _run_stack(params, _embed(params, tokens), "prefill",
                             positions=positions, caches=caches,
                             route_state=route_state, capacity=capacity,
                             token_mask=mask)
        return unembed(cfg, params, x[:, -1]), caches, load

    @torch.no_grad()
    def decode(params, tokens, pos, caches, route_state):
        """tokens: [B] int; pos: [B] absolute positions (-1 = row not
        decoding: no cache write, no capacity claim). Expert capacity comes
        from the model's capacity factor. Updates ``caches`` in place;
        returns (logits [B, V], caches, slot load [P])."""
        x, load = _run_stack(params, _embed(params, tokens[:, None]),
                             "decode", pos=pos, caches=caches,
                             route_state=route_state,
                             token_mask=(pos >= 0)[:, None])
        return unembed(cfg, params, x[:, 0]), caches, load

    def init_route_state():
        if placement is None:
            return refe.RouteState(
                candidates=torch.zeros((0, 2), dtype=torch.int32,
                                       device=device),
                ew_health=torch.ones((num_ew,), dtype=torch.bool,
                                     device=device),
                aw_health=torch.ones((num_aw,), dtype=torch.bool,
                                     device=device),
                slot_expert=torch.zeros((0,), dtype=torch.int32,
                                        device=device),
                slot_owner=torch.zeros((0,), dtype=torch.int32,
                                       device=device),
                split_slot=torch.zeros((0,), dtype=torch.int32,
                                       device=device))
        return refe.RouteState.healthy(placement, num_aw, device=device)

    return ModelApi(cfg, placement, num_aw, num_ew, device, init_params,
                    init_cache, prefill, decode, init_route_state)
