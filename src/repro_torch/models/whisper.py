"""Whisper-small encoder-decoder (port of ``repro.models.whisper``,
arXiv:2212.04356).

The mel-spectrogram and conv frontend is a stub, as in the reference: a
request brings precomputed frame embeddings [T_enc, D] (``frames``). The
encoder is stateless and runs once, at prefill: its attention is the
flash kernel without the causal mask on the card. The decoder keeps
self-attention KV and the cross-attention K/V computed once from the
encoder's output; both are per-request state that restoration covers.

The reference scans stacked layer params; here ``enc`` and ``dec`` are
plain lists of per-layer dicts and the stacks are Python loops. Cache:
``{"layers": [one {"k", "v", "pos"} self-attention cache per decoder
layer], "cross_k", "cross_v": [B, L, T_enc, Hkv, Dh]}`` with the request
slot as axis 0; updated in place. Prefill runs its projections and norms
in fixed row blocks (``layers.row_blocked``), as every prefill call of
the port does. The training forward pass keeps no cache: it computes
each layer's cross K/V from the encoder's output and runs the causal
decoder over the whole sequence, its projections unblocked.
"""
from __future__ import annotations

import torch

from repro_torch.configs.base import ModelConfig
from repro_torch.models import attention as attn
from repro_torch.models.layers import (embed_init, mlp, mlp_init, norm,
                                       rmsnorm_init, unembed)
from repro_torch.models.transformer import (ModelApi, as_batch, cast_floats,
                                            layer_call,
                                            route_state_without_experts)


def encode(cfg: ModelConfig, params, frames, blocked: bool = True):
    """frames [B, T_enc, D] -> the encoder's output [B, T_enc, D]: full
    attention without the causal mask, projections and norms in fixed row
    blocks (``blocked``: prefill) or whole (training)."""
    b, t, _ = frames.shape
    positions = torch.arange(t, dtype=torch.int32,
                             device=frames.device).expand(b, t)
    h = frames.to(cfg.torch_dtype)
    for lp in params["enc"]:
        h = layer_call(cfg, _enc_layer, cfg, lp, h, positions, blocked)
    return norm(params["enc_final_norm"], h, cfg.norm_eps, blocked)


def _enc_layer(cfg: ModelConfig, lp, h, positions, blocked):
    a, _ = attn.attn_full(cfg, lp["attn"],
                          norm(lp["ln1"], h, cfg.norm_eps, blocked),
                          positions, causal=False, blocked=blocked)
    h = h + a
    return h + mlp(lp["mlp"], norm(lp["ln2"], h, cfg.norm_eps, blocked),
                   cfg.act, blocked=blocked)


def fill_cross(cfg: ModelConfig, params, cache, enc_out):
    """Each decoder layer's cross-attention K/V from the encoder's output,
    written into the cache in place."""
    for li, lp in enumerate(params["dec"]):
        ckv = attn.cross_kv_init(cfg, lp["cross_attn"], enc_out)
        cache["cross_k"][:, li] = ckv["k"]
        cache["cross_v"][:, li] = ckv["v"]
    return cache


def build_encdec(cfg: ModelConfig, *, num_aw: int = 1, num_ew: int = 1,
                 tarragon: bool = True, device="cuda") -> ModelApi:
    """``tarragon`` is the MoE family's (shadow slots or not): Whisper has
    no expert layer."""
    device = torch.device(device)
    dtype = cfg.torch_dtype
    r_dec = cfg.num_layers
    no_load = torch.zeros((0,), dtype=torch.float32, device=device)

    def init_params(gen: torch.Generator):
        """Seeded params with the reference's leaves and scales, every
        float leaf in the config dtype (the reference's ``cast_tree``)."""
        d, f = cfg.d_model, cfg.d_ff

        def enc_layer():
            return {"ln1": rmsnorm_init(d, device),
                    "attn": attn.attn_init(gen, cfg, device, dtype),
                    "ln2": rmsnorm_init(d, device),
                    "mlp": mlp_init(gen, d, f, cfg.mlp_gated, device, dtype)}

        def dec_layer():
            return {"ln1": rmsnorm_init(d, device),
                    "self_attn": attn.attn_init(gen, cfg, device, dtype),
                    "ln_x": rmsnorm_init(d, device),
                    "cross_attn": attn.attn_init(gen, cfg, device, dtype,
                                                 cross=True),
                    "ln2": rmsnorm_init(d, device),
                    "mlp": mlp_init(gen, d, f, cfg.mlp_gated, device, dtype)}

        params = {"embed": embed_init(gen, cfg.vocab_size, d, device, dtype),
                  "final_norm": rmsnorm_init(d, device),
                  "enc_final_norm": rmsnorm_init(d, device),
                  "enc": [enc_layer() for _ in range(cfg.encoder_layers)],
                  "dec": [dec_layer() for _ in range(r_dec)]}
        return cast_floats(params, dtype)

    def init_cache(batch: int, max_seq: int):
        cross = (batch, r_dec, cfg.encoder_seq, cfg.num_kv_heads,
                 cfg.head_dim_)
        return {"layers": [attn.init_cache(cfg, batch, max_seq,
                                           device=device)
                           for _ in range(r_dec)],
                "cross_k": torch.zeros(cross, dtype=dtype, device=device),
                "cross_v": torch.zeros(cross, dtype=dtype, device=device)}

    # ---- decoder -----------------------------------------------------------
    def _dec_layer(lp, x, mode, kv, cross_kv, positions, pos):
        blocked = mode == "prefill"
        h = norm(lp["ln1"], x, cfg.norm_eps, blocked)
        if mode == "decode":
            a, _ = attn.attn_decode(cfg, lp["self_attn"], h, kv, pos)
        else:
            a, _ = attn.attn_full(cfg, lp["self_attn"], h, positions,
                                  cache=kv, blocked=blocked)
        x = x + a
        # training takes the encoder's frames as one KV block: the
        # reference's 4-key blocks over 1,500 frames are ~375 small ops
        # a layer each way, eagerly (serving keeps them, and its bits)
        x = x + attn.attn_cross(
            cfg, lp["cross_attn"], norm(lp["ln_x"], x, cfg.norm_eps, blocked),
            cross_kv, blocked,
            block_k=cross_kv["k"].shape[1] if mode == "train" else 0)
        return x + mlp(lp["mlp"], norm(lp["ln2"], x, cfg.norm_eps, blocked),
                       cfg.act, blocked=blocked)

    def _run_decoder(params, x, mode, kvs, cross, positions=None, pos=None):
        """``kvs``: each layer's self-attention cache (None: the training
        forward pass, no cache); ``cross``: each layer's cross K/V."""
        for li, lp in enumerate(params["dec"]):
            kv = kvs[li] if kvs is not None else None
            x = layer_call(cfg, _dec_layer, lp, x, mode, kv, cross[li],
                           positions, pos)
        return norm(params["final_norm"], x, cfg.norm_eps, mode == "prefill")

    def _cached_cross(cache):
        return [{"k": cache["cross_k"][:, li], "v": cache["cross_v"][:, li]}
                for li in range(r_dec)]

    def _embed(params, tokens):
        return params["embed"].to(dtype)[tokens.long()]

    def forward_train(params, batch, route_state):
        """The teacher-forced forward pass of training: batch["tokens"]
        [B, S] int and batch["frames"] [B, T_enc, D]: the encoder, each
        decoder layer's cross K/V from its output, then the causal
        decoder over positions 0..S-1. Returns (logits [B, S, V], a zero
        aux loss)."""
        batch = as_batch(batch, device)
        tokens = batch["tokens"]
        b, s = tokens.shape
        enc_out = encode(cfg, params, batch["frames"], blocked=False)
        cross = [attn.cross_kv_init(cfg, lp["cross_attn"], enc_out, False)
                 for lp in params["dec"]]
        positions = torch.arange(s, dtype=torch.int32,
                                 device=device).expand(b, s)
        x = _run_decoder(params, _embed(params, tokens), "train", None,
                         cross, positions=positions)
        return unembed(cfg, params, x), torch.zeros(
            (), dtype=torch.float32, device=device)

    @torch.no_grad()
    def prefill(params, tokens, route_state, max_seq: int, capacity=None,
                mask=None, frames=None):
        """tokens: [B, S] int, every token real (the exact whole-prompt
        scheme); frames: [B, T_enc, D] (required). ``capacity`` and
        ``mask`` are the MoE family's and unused here. Encodes the frames,
        fills the cross K/V and runs the decoder prompt. Returns
        (last-position logits [B, V], fresh caches, an empty slot load)."""
        if frames is None:
            raise ValueError(f"{cfg.name}: prefill needs frames "
                             f"[B, {cfg.encoder_seq}, {cfg.d_model}]")
        b, s = tokens.shape
        cache = fill_cross(cfg, params, init_cache(b, max_seq),
                           encode(cfg, params, frames))
        positions = torch.arange(s, dtype=torch.int32,
                                 device=device).expand(b, s)
        x = _run_decoder(params, _embed(params, tokens), "prefill",
                         cache["layers"], _cached_cross(cache),
                         positions=positions)
        return unembed(cfg, params, x[:, -1]), cache, no_load

    @torch.no_grad()
    def decode(params, tokens, pos, cache, route_state, capacity=None):
        """tokens: [B] int; pos: [B] absolute positions (-1 = row not
        decoding: no KV write). ``capacity`` is the MoE family's and
        unused. Updates ``cache`` in place; returns (logits [B, V], cache,
        an empty slot load)."""
        x = _run_decoder(params, _embed(params, tokens[:, None]), "decode",
                         cache["layers"], _cached_cross(cache), pos=pos)
        return unembed(cfg, params, x[:, 0]), cache, no_load

    def init_route_state():
        return route_state_without_experts(num_aw, num_ew, device)

    return ModelApi(cfg, None, num_aw, num_ew, device, init_params,
                    init_cache, forward_train, prefill, decode,
                    init_route_state, None, False)
