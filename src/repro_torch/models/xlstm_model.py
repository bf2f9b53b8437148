"""xLSTM-350m stack (port of ``repro.models.xlstm_model``): mLSTM and
sLSTM blocks in the order of ``cfg.xlstm_pattern``, repeated
``num_layers / len(pattern)`` times [arXiv:2405.04517].

The reference scans the repeated units over stacked params; here
``blocks`` is a plain list of per-layer dicts in execution order and the
stack is a Python loop. The cache holds recurrent state only, no
attention layer: ``{"layers": [], "mlstm_c" [B, Lm, H, Dh, Dh], "mlstm_n"
[B, Lm, H, Dh], "mlstm_m" [B, Lm, H], "slstm_c" / "slstm_n" / "slstm_m" /
"slstm_h" [B, Ls, D]}``, float32, with the request slot as axis 0 and Lm
(Ls) the mLSTM (sLSTM) layers in stack order; updated in place. The
training forward pass keeps no cache: every layer starts from a zero
state.
"""
from __future__ import annotations

import torch

from repro_torch.configs.base import ModelConfig
from repro_torch.models import xlstm as xl
from repro_torch.models.layers import (embed_init, rmsnorm, rmsnorm_init,
                                       unembed)
from repro_torch.models.transformer import (ModelApi, as_batch, cast_floats,
                                            layer_call,
                                            route_state_without_experts)

_INIT = {"mlstm": xl.mlstm_init, "slstm": xl.slstm_init}
_FWD = {"mlstm": xl.mlstm_forward, "slstm": xl.slstm_forward}
_STATE = {"mlstm": xl.mlstm_state, "slstm": xl.slstm_state}


def build_xlstm(cfg: ModelConfig, *, num_aw: int = 1, num_ew: int = 1,
                tarragon: bool = True, device="cuda") -> ModelApi:
    """``tarragon`` is the MoE family's (shadow slots or not): the xLSTM
    has no expert layer."""
    device = torch.device(device)
    pattern = cfg.xlstm_pattern
    if cfg.num_layers % len(pattern):
        raise ValueError(f"{cfg.name}: {cfg.num_layers} layers not "
                         f"divisible by pattern {pattern}")
    kinds = [pattern[i % len(pattern)] for i in range(cfg.num_layers)]
    # each layer's index among the layers of its kind (its state row)
    index = [kinds[:i].count(k) for i, k in enumerate(kinds)]
    dtype = cfg.torch_dtype
    no_load = torch.zeros((0,), dtype=torch.float32, device=device)

    def init_params(gen: torch.Generator):
        """Seeded params with the reference's leaves and scales, every
        float leaf in the config dtype (the reference's ``cast_tree``)."""
        d = cfg.d_model
        params = cast_floats({"embed": embed_init(gen, cfg.vocab_size, d,
                                                  device),
                              "final_norm": rmsnorm_init(d, device)}, dtype)
        params["blocks"] = [
            cast_floats({"ln": rmsnorm_init(d, device),
                         "cell": _INIT[k](gen, cfg, device, dtype)}, dtype)
            for k in kinds]
        return params

    def init_cache(batch: int, max_seq: int = 0):
        cache = {"layers": []}
        for kind in dict.fromkeys(pattern):
            n = kinds.count(kind)
            for name, t in _STATE[kind](cfg, batch, device).items():
                cache[f"{kind}_{name}"] = torch.stack([t] * n, 1)
        return cache

    def _block(bp, x, kind, j, cache):
        if cache is None:                                   # training
            return x + _FWD[kind](cfg, bp["cell"],
                                  rmsnorm(bp["ln"], x, cfg.norm_eps))[0]
        names = [n for n in cache if n.startswith(kind + "_")]
        st = {n[len(kind) + 1:]: cache[n][:, j] for n in names}
        y, st = _FWD[kind](cfg, bp["cell"],
                           rmsnorm(bp["ln"], x, cfg.norm_eps), st)
        for n in names:
            cache[n][:, j] = st[n[len(kind) + 1:]]
        return x + y

    def _run(params, x, cache):
        """``cache`` None: the training forward pass."""
        for bp, kind, j in zip(params["blocks"], kinds, index):
            x = layer_call(cfg, _block, bp, x, kind, j, cache)
        return rmsnorm(params["final_norm"], x, cfg.norm_eps)

    def _embed(params, tokens):
        return params["embed"].to(dtype)[tokens.long()]

    def forward_train(params, batch, route_state):
        """The teacher-forced forward pass of training: batch["tokens"]
        [B, S] int, each layer from a zero state, no cache. Returns
        (logits [B, S, V], a zero aux loss)."""
        tokens = as_batch(batch, device)["tokens"]
        x = _run(params, _embed(params, tokens), None)
        return unembed(cfg, params, x), torch.zeros(
            (), dtype=torch.float32, device=device)

    @torch.no_grad()
    def prefill(params, tokens, route_state, max_seq: int = 0,
                capacity=None, mask=None):
        """tokens: [B, S] int, every token real (a recurrent state must
        never see a pad: the exact whole-prompt scheme; ``capacity`` and
        ``mask`` are the MoE family's and unused here). Returns
        (last-position logits [B, V], fresh state, an empty slot load)."""
        cache = init_cache(tokens.shape[0])
        x = _run(params, _embed(params, tokens), cache)
        return unembed(cfg, params, x[:, -1]), cache, no_load

    @torch.no_grad()
    def decode(params, tokens, pos, cache, route_state, capacity=None):
        """tokens: [B] int; ``pos`` is unused: a row not decoding advances
        its state too, as in the reference, and the slot's next install
        overwrites it. ``capacity`` is the MoE family's and unused.
        Updates ``cache`` in place; returns (logits [B, V], cache, an
        empty slot load)."""
        x = _run(params, _embed(params, tokens[:, None]), cache)
        return unembed(cfg, params, x[:, 0]), cache, no_load

    def init_route_state():
        return route_state_without_experts(num_aw, num_ew, device)

    # a row at pos -1 still advances its recurrent state: no segments
    return ModelApi(cfg, None, num_aw, num_ew, device, init_params,
                    init_cache, forward_train, prefill, decode,
                    init_route_state, None, False)
