"""Decoder stack for the transformer family (port of
``repro.models.transformer``): the MoE Mixtral and the dense Gemma2,
Danube and Qwen2 (sliding-window layers keep ring caches); the training
forward pass, whole-prompt prefill, chunked prefill and decode, over a
contiguous or a paged KV cache.

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
from repro_torch.models.layers import (embed_init, mlp, mlp_init, norm,
                                       rmsnorm_init, unembed)


class ModelApi(NamedTuple):
    cfg: ModelConfig
    placement: Optional[ert_lib.ExpertPlacement]
    num_aw: int
    num_ew: int
    device: torch.device
    init_params: Callable[..., Any]     # (generator) -> params
    init_cache: Callable[..., Any]      # (batch, max_seq) -> caches
    forward_train: Callable[..., Any]   # (params, batch, rs) -> (logits, aux)
    prefill: Callable[..., Any]         # -> (last_logits, caches, load)
    decode: Callable[..., Any]          # -> (logits, caches, load)
    init_route_state: Callable[..., refe.RouteState]
    prefill_chunk: Callable[..., Any]   # -> (caches, load)
    # True when rows may stop mid-segment: a row at pos -1 leaves its
    # cache untouched, so a decode segment runs steps past a row's end
    supports_decode_segments: bool


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


def _layer_init(gen, cfg: ModelConfig, use_moe: bool, placement, device,
                dtype=torch.float32):
    """One layer's params; every drawn tensor in ``dtype`` as soon as it
    is drawn (the norms' ones and the biases' zeros stay float32)."""
    p = {"ln1": rmsnorm_init(cfg.d_model, device),
         "attn": attn.attn_init(gen, cfg, device, dtype),
         "ln2": rmsnorm_init(cfg.d_model, device)}
    if use_moe:
        p["moe"] = moe_mod.moe_init(gen, cfg, placement, device, dtype)
    else:
        p["mlp"] = mlp_init(gen, cfg.d_model, cfg.d_ff or cfg.moe.d_ff,
                            cfg.mlp_gated, device, dtype)
    return p


def _layer_apply(cfg: ModelConfig, p, x, *, window: int, mode: str,
                 positions=None, pos=None, cache=None, route_state=None,
                 placement=None, capacity=None, token_mask=None, bt=None):
    """mode: 'train' | 'prefill' | 'chunk' | 'decode'. ``bt`` is the [B,
    nblk] block table of a paged cache (None = contiguous); 'train' has
    no cache. Returns (x, cache, router aux loss or None, slot load).
    Prefill and chunk calls run their dense projections and norms in
    fixed row blocks (``layers.row_blocked``); decode steps and training
    do not. Every mode but decode keeps the expert FFN off its decode
    path."""
    blocked = mode in ("prefill", "chunk")
    h = norm(p["ln1"], x, cfg.norm_eps, blocked)
    if mode == "decode" and bt is not None:
        a, cache = attn.attn_decode_paged(cfg, p["attn"], h, cache, bt, pos)
    elif mode == "decode":
        a, cache = attn.attn_decode(cfg, p["attn"], h, cache, pos,
                                    window=window)
    elif mode == "chunk" and bt is not None:
        a, cache = attn.attn_chunk_paged(cfg, p["attn"], h, cache, bt,
                                         positions)
    elif mode == "chunk":
        a, cache = attn.attn_chunk(cfg, p["attn"], h, cache, positions,
                                   window=window)
    else:
        a, cache = attn.attn_full(cfg, p["attn"], h, positions,
                                  window=window, cache=cache,
                                  blocked=blocked)
    x = x + a
    h = norm(p["ln2"], x, cfg.norm_eps, blocked)
    if "moe" in p:
        f, aux, load = moe_mod.moe_apply(cfg, p["moe"], h, route_state,
                                         placement, capacity=capacity,
                                         token_mask=token_mask,
                                         decode=mode == "decode")
    else:
        f = mlp(p["mlp"], h, cfg.act, blocked=blocked)
        n_slots = placement.num_slots if placement is not None else 0
        load = torch.zeros((n_slots,), dtype=torch.float32, device=x.device)
        aux = None
    return x + f, cache, aux, load


def route_state_without_experts(num_aw: int, num_ew: int,
                                device) -> refe.RouteState:
    """The RouteState of a model without MoE layers: empty slot tables,
    every worker healthy."""
    def empty(*shape):
        return torch.zeros(shape, dtype=torch.int32, device=device)
    return refe.RouteState(
        candidates=empty(0, 2),
        ew_health=torch.ones((num_ew,), dtype=torch.bool, device=device),
        aw_health=torch.ones((num_aw,), dtype=torch.bool, device=device),
        slot_expert=empty(0), slot_owner=empty(0), split_slot=empty(0))


def layer_call(cfg: ModelConfig, fn, *args):
    """``fn(*args)``; with ``cfg.remat``, under ``torch.utils.checkpoint``
    (non-reentrant): its activations are recomputed in the backward pass,
    as the reference's ``jax.checkpoint`` of the scan body does."""
    if cfg.remat and torch.is_grad_enabled():
        return torch.utils.checkpoint.checkpoint(fn, *args,
                                                 use_reentrant=False)
    return fn(*args)


def as_batch(batch, device):
    """A training batch ({"tokens", "labels", "frames"}, numpy arrays or
    tensors) as tensors on ``device``."""
    return {k: torch.as_tensor(v, device=device) for k, v in batch.items()}


def cast_floats(tree, dtype):
    """Cast every floating tensor of a nested dict/list to ``dtype``."""
    if isinstance(tree, dict):
        return {k: cast_floats(v, dtype) for k, v in tree.items()}
    if isinstance(tree, list):
        return [cast_floats(v, dtype) for v in tree]
    return tree.to(dtype) if tree.is_floating_point() else tree


def build_decoder(cfg: ModelConfig, *, num_aw: int = 1, num_ew: int = 1,
                  tarragon: bool = True, device="cuda") -> ModelApi:
    device = torch.device(device)
    windows = layer_windows(cfg)
    n_first = cfg.moe.first_k_dense if cfg.moe.enabled else 0
    placement = (moe_mod.moe_placement(cfg, num_ew, tarragon)
                 if cfg.moe.enabled else None)
    dtype = cfg.torch_dtype
    n_slots = placement.num_slots if placement is not None else 0

    def init_params(gen: torch.Generator):
        """Seeded params with the reference's shapes and scales, drawn on
        ``gen``'s device tensor by tensor, each cast to the config dtype
        as soon as it is drawn (the peak is the finished tensors plus one
        float32 draw and its cast)."""
        params = {"embed": embed_init(gen, cfg.vocab_size, cfg.d_model,
                                      device, dtype),
                  "final_norm": rmsnorm_init(cfg.d_model, device)}
        if not cfg.tie_embeddings:
            params["unembed"] = embed_init(gen, cfg.vocab_size, cfg.d_model,
                                           device, dtype)
        params = cast_floats(params, dtype)
        params["layers"] = [
            cast_floats(_layer_init(gen, cfg, cfg.moe.enabled and
                                    i >= n_first, placement, device, dtype),
                        dtype)
            for i in range(cfg.num_layers)]
        return params

    def init_cache(batch: int, max_seq: int):
        return {"layers": [attn.init_cache(cfg, batch, max_seq, window=w,
                                           device=device)
                           for w in windows]}

    def _run_stack(params, x, mode, positions=None, pos=None, caches=None,
                   route_state=None, capacity=None, token_mask=None):
        """Returns (normed x, slot load, summed router aux loss: summed
        in the training forward pass only, else None)."""
        load_total = torch.zeros((n_slots,), dtype=torch.float32,
                                 device=x.device)
        aux_total = torch.zeros((), dtype=torch.float32, device=x.device) \
            if mode == "train" else None
        # a paged engine carries one block table beside its layer pools,
        # threaded to every layer
        bt = caches.get("bt") if caches is not None else None
        for i, lp in enumerate(params["layers"]):
            c = caches["layers"][i] if caches is not None else None
            if mode == "train":
                x, aux = layer_call(cfg, _train_layer, lp, x, positions,
                                    windows[i], route_state)
                aux_total = aux_total + aux
                continue
            x, c, _, load = _layer_apply(
                cfg, lp, x, window=windows[i], mode=mode,
                positions=positions, pos=pos, cache=c,
                route_state=route_state, placement=placement,
                capacity=capacity, token_mask=token_mask, bt=bt)
            load_total = load_total + load
        return norm(params["final_norm"], x, cfg.norm_eps,
                    mode in ("prefill", "chunk")), load_total, aux_total

    def _train_layer(lp, x, positions, window, route_state):
        x, _, aux, _ = _layer_apply(cfg, lp, x, window=window, mode="train",
                                    positions=positions,
                                    route_state=route_state,
                                    placement=placement)
        return x, (aux if aux is not None else
                   torch.zeros((), dtype=torch.float32, device=x.device))

    def _embed(params, tokens):
        return params["embed"].to(dtype)[tokens.long()]

    def forward_train(params, batch, route_state):
        """The teacher-forced forward pass of training: batch["tokens"]
        [B, S] int at positions 0..S-1, no cache, every token real.
        Returns (logits [B, S, V], the router aux loss summed over the
        MoE layers: a float32 scalar, 0 for a dense model)."""
        tokens = as_batch(batch, device)["tokens"]
        b, s = tokens.shape
        positions = torch.arange(s, dtype=torch.int32,
                                 device=device).expand(b, s)
        x, _, aux = _run_stack(params, _embed(params, tokens), "train",
                               positions=positions, route_state=route_state)
        return unembed(cfg, params, x), aux

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
        x, load, _ = _run_stack(params, _embed(params, tokens), "prefill",
                                positions=positions, caches=caches,
                                route_state=route_state, capacity=capacity,
                                token_mask=mask)
        return unembed(cfg, params, x[:, -1]), caches, load

    @torch.no_grad()
    def prefill_chunk(params, tokens, positions, caches, route_state,
                      capacity=None):
        """One budgeted prefill chunk over the shared slot-partitioned
        cache. tokens: [B, C] int; positions: [B, C] absolute prompt
        positions (-1 = chunk padding or a row not in this chunk call;
        such rows, live decode slots included, are untouched). Updates
        ``caches`` in place; returns (caches, slot load). No logits: the
        first generated token rides the decode step."""
        x, load, _ = _run_stack(params, _embed(params, tokens), "chunk",
                                positions=positions, caches=caches,
                                route_state=route_state, capacity=capacity,
                                token_mask=positions >= 0)
        return caches, load

    @torch.no_grad()
    def decode(params, tokens, pos, caches, route_state, capacity=None):
        """tokens: [B] int; pos: [B] absolute positions (-1 = row not
        decoding: no cache write, no capacity claim). Expert capacity is
        ``capacity``, or from the model's capacity factor when None.
        ``caches`` may be paged (a "bt" block table beside the layer
        pools). Updates ``caches`` in place; returns (logits [B, V],
        caches, slot load [P])."""
        x, load, _ = _run_stack(params, _embed(params, tokens[:, None]),
                                "decode", pos=pos, caches=caches,
                                route_state=route_state, capacity=capacity,
                                token_mask=(pos >= 0)[:, None])
        return unembed(cfg, params, x[:, 0]), caches, load

    def init_route_state():
        if placement is None:
            return route_state_without_experts(num_aw, num_ew, device)
        return refe.RouteState.healthy(placement, num_aw, device=device)

    return ModelApi(cfg, placement, num_aw, num_ew, device, init_params,
                    init_cache, forward_train, prefill, decode,
                    init_route_state, prefill_chunk, True)
