"""A configuration file made into the port's model config, the weights
made from the seed on the device, and the engine that serves them.

The weights are the benchmark's own: a few large normal draws on the
card, in bfloat16, at the port's init scales (``1/sqrt(fan-in)``, 0.02
for embeddings and biases), laid out as the port's params dict. The
engine takes them as they are (``InferenceEngine(params=...)``), and the
reference reads the same tensors.
"""
from __future__ import annotations

import dataclasses
import json
import math
from pathlib import Path

import torch

HERE = Path(__file__).resolve().parent


def load_config(name: str) -> dict:
    path = HERE / "configs" / f"{name}.json"
    if not path.exists():
        raise KeyError(f"no configuration {name!r} (looked for {path})")
    return json.loads(path.read_text())


def port_config(conf: dict):
    """The port's ``ModelConfig`` for ``conf``: the registry's entry with
    the file's depth, norm epsilon, head tying, dtype and capacity factor;
    every width is checked against the file."""
    from repro_torch.configs import get_config
    base = get_config(conf["port_config"])
    if conf.get("port_reduced"):
        # the registry's CPU-test variant of the family (tests only)
        base = base.reduced()
    moe = dataclasses.replace(
        base.moe, capacity_factor=float(conf["assumed"]["capacity_factor"]))
    cfg = dataclasses.replace(
        base, num_layers=conf["num_hidden_layers"],
        norm_eps=conf["rms_norm_eps"],
        tie_embeddings=conf["tie_word_embeddings"],
        dtype=conf["torch_dtype"], moe=moe)
    want = {"d_model": conf["hidden_size"],
            "num_heads": conf["num_attention_heads"],
            "num_kv_heads": conf["num_key_value_heads"],
            "head_dim_": conf["head_dim"], "vocab_size": conf["vocab_size"],
            "rope_theta": conf["rope_theta"],
            "qkv_bias": conf["assumed"].get("qkv_bias", False),
            "sliding_window": 0}
    want_moe = {"num_experts": conf.get("num_local_experts",
                                        conf.get("num_experts")),
                "top_k": conf["num_experts_per_tok"],
                "d_ff": conf.get("moe_intermediate_size",
                                 conf["intermediate_size"]),
                "shared_d_ff": conf.get("shared_expert_intermediate_size",
                                        0)}
    got = {k: getattr(cfg, k) for k in want}
    got.update({k: getattr(cfg.moe, k) for k in want_moe})
    want.update(want_moe)
    if got != want:
        raise ValueError(f"{conf['name']}: the port's config {got} is not "
                         f"the file's {want}")
    return cfg


def make_params(conf: dict, bank_rows: int, seed: int, device) -> dict:
    """The weights, drawn from ``seed`` on ``device`` in bfloat16 (or the
    file's dtype), in the port's layout: per layer ``ln1``, ``attn``
    (``wq wk wv wo`` [in, out], biases), ``ln2``, ``moe`` (``router``
    [D, E], ``experts`` ``wg``/``wu`` [rows, D, F] and ``wd`` [rows, F,
    D], ``shared``); ``embed``, ``unembed``, ``final_norm``."""
    dtype = getattr(torch, conf["torch_dtype"])
    gen = torch.Generator(device=device)
    gen.manual_seed(int(seed) % (2 ** 63))
    d, h, hkv, dh = (conf["hidden_size"], conf["num_attention_heads"],
                     conf["num_key_value_heads"], conf["head_dim"])
    e = conf.get("num_local_experts", conf.get("num_experts"))
    f = conf.get("moe_intermediate_size", conf["intermediate_size"])
    fs = conf.get("shared_expert_intermediate_size", 0)
    n_layers, v = conf["num_hidden_layers"], conf["vocab_size"]
    bias = conf["assumed"].get("qkv_bias", False)

    def draw(*shape):
        return torch.empty(shape, dtype=dtype, device=device).normal_(
            generator=gen)

    # attention projections of every layer in one draw
    sizes = [("wq", d, h * dh), ("wk", d, hkv * dh), ("wv", d, hkv * dh),
             ("wo", h * dh, d)]
    attn = draw(n_layers, sum(a * b for _, a, b in sizes))
    router = draw(n_layers, d * e).mul_(1.0 / math.sqrt(d))
    norms = draw(2 * n_layers + 1, d).mul_(0.1).add_(1.0)
    biases = draw(n_layers, (h + 2 * hkv) * dh).mul_(0.02) if bias else None
    shared = draw(n_layers, 3 * d * fs) if fs else None
    layers = []
    for i in range(n_layers):
        a, off = {}, 0
        for name, fan_in, out in sizes:
            a[name] = attn[i, off:off + fan_in * out].view(fan_in, out) \
                .mul_(1.0 / math.sqrt(fan_in))
            off += fan_in * out
        if bias:
            b = biases[i]
            a["bq"], a["bk"], a["bv"] = (b[:h * dh], b[h * dh:(h + hkv) * dh],
                                         b[(h + hkv) * dh:])
        # one layer's expert bank in one draw: gate, up, down
        bank = draw(3, bank_rows, d * f)
        bank[:2].mul_(1.0 / math.sqrt(d))
        bank[2].mul_(1.0 / math.sqrt(f))
        m = {"router": router[i].view(d, e),
             "experts": {"wg": bank[0].view(bank_rows, d, f),
                         "wu": bank[1].view(bank_rows, d, f),
                         "wd": bank[2].view(bank_rows, f, d)}}
        if fs:
            s = shared[i]
            m["shared"] = {
                "w_gate": s[:d * fs].view(d, fs).mul_(1.0 / math.sqrt(d)),
                "w_up": s[d * fs:2 * d * fs].view(d, fs)
                .mul_(1.0 / math.sqrt(d)),
                "w_down": s[2 * d * fs:].view(fs, d)
                .mul_(1.0 / math.sqrt(fs))}
        layers.append({"ln1": {"scale": norms[2 * i]}, "attn": a,
                       "ln2": {"scale": norms[2 * i + 1]}, "moe": m})
    heads = draw(1 if conf["tie_word_embeddings"] else 2, v, d).mul_(0.02)
    params = {"embed": heads[0], "final_norm": {"scale": norms[-1]},
              "layers": layers}
    if not conf["tie_word_embeddings"]:
        params["unembed"] = heads[1]
    return params


def bank_rows(cfg, num_ew: int) -> int:
    """Rows of the stored expert bank the port's placement expects."""
    from repro_torch.models.moe import moe_placement
    return moe_placement(cfg, num_ew).primary_slots


def engine_config(conf: dict, cell: dict):
    from repro_torch.serving.engine import EngineConfig
    return EngineConfig(**{**conf["engine"], **cell.get("engine", {})})


def build_engine(cfg, ecfg, params, device):
    from repro_torch.serving.engine import InferenceEngine
    return InferenceEngine(cfg, ecfg, params=params, device=device)
