"""Zamba2-style hybrid stack (port of ``repro.models.hybrid``): Mamba2
blocks with one *shared* attention + MLP block applied after every
``hybrid_attn_every`` of them [arXiv:2411.15242].

The shared block's weights are used by every occurrence; each occurrence
keeps its own KV cache. The stack runs in super-units of ``every`` Mamba2
blocks plus one shared-block application, then the trailing Mamba2 blocks
that fill no unit. The reference scans stacked params; here ``blocks`` is
a plain list in execution order and the stack is a Python loop.

Cache: ``{"layers": [one {"k", "v", "pos"} cache per occurrence], "h":
[B, L, H, P, N] float32, "conv": [B, L, W-1, Di]}`` with the request slot
as axis 0 of every tensor and L the Mamba2 blocks; updated in place. The
training forward pass keeps no cache.
"""
from __future__ import annotations

import torch

from repro_torch.configs.base import ModelConfig
from repro_torch.models import attention as attn
from repro_torch.models import mamba2
from repro_torch.models.layers import (embed_init, mlp, mlp_init, norm,
                                       rmsnorm, rmsnorm_init, unembed)
from repro_torch.models.transformer import (ModelApi, as_batch, cast_floats,
                                            layer_call,
                                            route_state_without_experts)


def _geometry(cfg: ModelConfig):
    every = cfg.hybrid_attn_every
    r = cfg.num_layers // every
    return every, r, cfg.num_layers - r * every


def build_hybrid(cfg: ModelConfig, *, num_aw: int = 1, num_ew: int = 1,
                 tarragon: bool = True, device="cuda") -> ModelApi:
    """``tarragon`` is the MoE family's (shadow slots or not): the hybrid
    has no expert layer."""
    device = torch.device(device)
    every, r, _ = _geometry(cfg)
    dtype = cfg.torch_dtype
    window = cfg.sliding_window
    n_blocks = cfg.num_layers
    no_load = torch.zeros((0,), dtype=torch.float32, device=device)

    def init_params(gen: torch.Generator):
        """Seeded params with the reference's shapes and scales; every
        float leaf cast to the config dtype, as the reference's
        ``cast_tree`` does (``a_log``, ``dt_bias``, ``d_skip`` and
        ``conv_w`` included)."""
        d = cfg.d_model
        params = {
            "embed": embed_init(gen, cfg.vocab_size, d, device),
            "final_norm": rmsnorm_init(d, device),
            "shared": {"ln1": rmsnorm_init(d, device),
                       "attn": attn.attn_init(gen, cfg, device),
                       "ln2": rmsnorm_init(d, device),
                       "mlp": mlp_init(gen, d, cfg.d_ff, cfg.mlp_gated,
                                       device)},
        }
        params = cast_floats(params, dtype)
        params["blocks"] = [
            cast_floats({"ln": rmsnorm_init(d, device),
                         "mamba": mamba2.mamba_init(gen, cfg, device)},
                        dtype)
            for _ in range(n_blocks)]
        return params

    def init_cache(batch: int, max_seq: int):
        st = mamba2.init_state(cfg, batch, device=device, dtype=dtype)
        return {"layers": [attn.init_cache(cfg, batch, max_seq,
                                           window=window, device=device)
                           for _ in range(r)],
                "h": torch.stack([st["h"]] * n_blocks, 1),
                "conv": torch.stack([st["conv"]] * n_blocks, 1)}

    def _mamba_apply(bp, x, cache, i, mode):
        h = rmsnorm(bp["ln"], x, cfg.norm_eps)
        if cache is None:                                   # training
            return x + mamba2.mamba_forward(cfg, bp["mamba"], h)[0]
        st = {"h": cache["h"][:, i], "conv": cache["conv"][:, i]}
        if mode == "decode":
            y, st = mamba2.mamba_decode_step(cfg, bp["mamba"], h, st)
        else:
            y, st = mamba2.mamba_forward(cfg, bp["mamba"], h, st)
        cache["h"][:, i] = st["h"]
        cache["conv"][:, i] = st["conv"]
        return x + y

    def _shared_attn(p, x, mode, positions, pos, kv):
        # the prefill path runs its projections and norms in fixed row
        # blocks, as the transformer family's does
        blocked = mode == "prefill"
        h = norm(p["ln1"], x, cfg.norm_eps, blocked)
        if mode == "decode":
            a, _ = attn.attn_decode(cfg, p["attn"], h, kv, pos,
                                    window=window)
        else:
            a, _ = attn.attn_full(cfg, p["attn"], h, positions,
                                  window=window, cache=kv, blocked=blocked)
        x = x + a
        h = norm(p["ln2"], x, cfg.norm_eps, blocked)
        return x + mlp(p["mlp"], h, cfg.act, blocked=blocked)

    def _run(params, x, mode, cache, positions=None, pos=None):
        """``cache`` None: the training forward pass (mode "train")."""
        blocks = params["blocks"]
        for u in range(r):
            for i in range(u * every, (u + 1) * every):
                x = layer_call(cfg, _mamba_apply, blocks[i], x, cache, i,
                               mode)
            kv = cache["layers"][u] if cache is not None else None
            x = layer_call(cfg, _shared_attn, params["shared"], x, mode,
                           positions, pos, kv)
        for i in range(r * every, n_blocks):            # trailing blocks
            x = layer_call(cfg, _mamba_apply, blocks[i], x, cache, i, mode)
        return rmsnorm(params["final_norm"], x, cfg.norm_eps)

    def _embed(params, tokens):
        return params["embed"].to(dtype)[tokens.long()]

    def forward_train(params, batch, route_state):
        """The teacher-forced forward pass of training: batch["tokens"]
        [B, S] int, no cache. Returns (logits [B, S, V], a zero aux
        loss: the hybrid has no router)."""
        tokens = as_batch(batch, device)["tokens"]
        b, s = tokens.shape
        positions = torch.arange(s, dtype=torch.int32,
                                 device=device).expand(b, s)
        x = _run(params, _embed(params, tokens), "train", None,
                 positions=positions)
        return unembed(cfg, params, x), torch.zeros(
            (), dtype=torch.float32, device=device)

    @torch.no_grad()
    def prefill(params, tokens, route_state, max_seq: int, capacity=None,
                mask=None):
        """tokens: [B, S] int, every token real (a recurrent state must
        never see a pad, so the hybrid takes the exact whole-prompt
        scheme; ``capacity`` and ``mask`` are the MoE family's and unused
        here). Returns (last-position logits [B, V], fresh caches, an
        empty slot load)."""
        b, s = tokens.shape
        positions = torch.arange(s, dtype=torch.int32,
                                 device=device).expand(b, s)
        cache = init_cache(b, max_seq)
        x = _run(params, _embed(params, tokens), "prefill", cache,
                 positions=positions)
        return unembed(cfg, params, x[:, -1]), cache, no_load

    @torch.no_grad()
    def decode(params, tokens, pos, cache, route_state, capacity=None):
        """tokens: [B] int; pos: [B] absolute positions (-1 = row not
        decoding: no KV write; its recurrent state advances, as in the
        reference, and is overwritten when the slot is next installed).
        ``capacity`` is the MoE family's and unused. Updates ``cache`` in
        place; returns (logits [B, V], cache, an empty slot load)."""
        x = _run(params, _embed(params, tokens[:, None]), "decode", cache,
                 pos=pos)
        return unembed(cfg, params, x[:, 0]), cache, no_load

    def init_route_state():
        return route_state_without_experts(num_aw, num_ew, device)

    # a row at pos -1 still advances its recurrent state: no segments
    return ModelApi(cfg, None, num_aw, num_ew, device, init_params,
                    init_cache, forward_train, prefill, decode,
                    init_route_state, None, False)
