"""Plain PyTorch reference of the MoE decoder the benchmark serves: the
forward pass over whole sequences, in float32 (TF32 off), with no
kernel, cache or batching.

Equations, per layer: RMSNorm; attention with the query, key and value
projections (and their biases, where the configuration has them), RoPE on
the two halves of each head, causal softmax over every earlier position
and the output projection; RMSNorm; a router softmax over the experts,
the top-k kept (ties to the lower index) and renormalised, each chosen
expert's SiLU-gated FFN weighted by its gate, plus the shared experts'
FFN where the configuration has them. Then the final RMSNorm and the
head. It reads the weights the benchmark made (the dict handed to the
engine), upcast to float32 one layer at a time, so a whole model never
sits in float32 on the card.

``precision="fp8"`` is the control: every matrix product takes its
weight and its input rounded to float8 e4m3 (a scale per output column of
the weight and per row of the input), accumulating in float32.

This file imports nothing of the program.
"""
from __future__ import annotations

import math
from typing import Callable, List, Sequence

import torch

QUERY_BLOCK = 1024          # query rows per attention block
HEAD_BLOCK = 1024           # rows per block of the head's logits
FP8_MAX = 448.0             # largest finite float8 e4m3 value


def _fp8(x: torch.Tensor, dim: int) -> torch.Tensor:
    """``x`` rounded to float8 e4m3 with a scale per slice along ``dim``
    (the absolute maximum maps to the largest finite value), back in
    float32."""
    amax = x.abs().amax(dim=dim, keepdim=True).clamp(min=1e-12)
    scale = FP8_MAX / amax
    return (x * scale).to(torch.float8_e4m3fn).float() / scale


class Linear:
    """x [N, K] @ w [K, M], in float32 or through the fp8 control."""

    def __init__(self, precision: str):
        if precision not in ("fp32", "fp8"):
            raise ValueError(f"unknown precision {precision!r}")
        self.fp8 = precision == "fp8"

    def weight(self, w: torch.Tensor) -> torch.Tensor:
        w = w.float()
        return _fp8(w, 0) if self.fp8 else w

    def __call__(self, x: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
        if self.fp8:
            x = _fp8(x, -1)
        return x @ w


def rmsnorm(x, scale, eps: float):
    return x * torch.rsqrt((x * x).mean(-1, keepdim=True) + eps) * \
        scale.float()


def rope(x, positions, theta: float):
    """x [S, H, Dh]: the two halves of each head rotated by position."""
    dh = x.shape[-1]
    freqs = 1.0 / (theta ** (torch.arange(0, dh, 2, dtype=torch.float32,
                                          device=x.device) / dh))
    ang = positions[:, None].float() * freqs
    cos, sin = torch.cos(ang)[:, None], torch.sin(ang)[:, None]
    x1, x2 = x[..., :dh // 2], x[..., dh // 2:]
    return torch.cat([x1 * cos - x2 * sin, x2 * cos + x1 * sin], dim=-1)


def attention(conf, lin, p, x):
    s = x.shape[0]
    h, hkv, dh = (conf["num_attention_heads"], conf["num_key_value_heads"],
                  conf["head_dim"])
    q = lin(x, lin.weight(p["wq"]))
    k = lin(x, lin.weight(p["wk"]))
    v = lin(x, lin.weight(p["wv"]))
    if "bq" in p:
        q, k, v = q + p["bq"].float(), k + p["bk"].float(), \
            v + p["bv"].float()
    pos = torch.arange(s, device=x.device)
    q = rope(q.reshape(s, h, dh), pos, conf["rope_theta"])
    k = rope(k.reshape(s, hkv, dh), pos, conf["rope_theta"])
    v = v.reshape(s, hkv, dh)
    g = h // hkv
    k = k.repeat_interleave(g, dim=1)
    v = v.repeat_interleave(g, dim=1)
    out = torch.empty((s, h, dh), dtype=torch.float32, device=x.device)
    scale = 1.0 / math.sqrt(dh)
    for q0 in range(0, s, QUERY_BLOCK):
        q1 = min(s, q0 + QUERY_BLOCK)
        sc = torch.einsum("qhd,khd->hqk", q[q0:q1], k[:q1]) * scale
        mask = pos[None, :q1] > pos[q0:q1, None]
        sc = sc.masked_fill(mask[None], float("-inf"))
        out[q0:q1] = torch.einsum("hqk,khd->qhd", torch.softmax(sc, -1),
                                  v[:q1])
    return lin(out.reshape(s, h * dh), lin.weight(p["wo"]))


def moe(conf, lin, p, x):
    e = conf.get("num_local_experts", conf.get("num_experts"))
    k = conf["num_experts_per_tok"]
    logits = lin(x, lin.weight(p["router"]))
    probs = torch.softmax(logits, dim=-1)
    vals, idx = torch.sort(probs, dim=-1, descending=True, stable=True)
    gate = vals[:, :k] / vals[:, :k].sum(-1, keepdim=True)
    idx = idx[:, :k]
    y = torch.zeros_like(x)
    ex = p["experts"]
    for j in range(e):
        rows, slot = torch.nonzero(idx == j, as_tuple=True)
        if rows.numel() == 0:
            continue
        xe = x[rows]
        hid = torch.nn.functional.silu(lin(xe, lin.weight(ex["wg"][j]))) * \
            lin(xe, lin.weight(ex["wu"][j]))
        y.index_add_(0, rows, lin(hid, lin.weight(ex["wd"][j])) *
                     gate[rows, slot, None])
    if "shared" in p:
        sh = p["shared"]
        hid = torch.nn.functional.silu(lin(x, lin.weight(sh["w_gate"]))) * \
            lin(x, lin.weight(sh["w_up"]))
        y = y + lin(hid, lin.weight(sh["w_down"]))
    return y


@torch.no_grad()
def forward(conf: dict, params: dict, seqs: Sequence[Sequence[int]],
            on_logits: Callable[[int, int, torch.Tensor], None], *,
            device, precision: str = "fp32"):
    """Run every sequence of ``seqs`` (token ids) through the model, layer
    by layer over all of them, and hand the head's float32 logits to
    ``on_logits(seq_index, first_row, logits [rows, V])`` in blocks of
    rows."""
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    lin = Linear(precision)
    eps = conf["rms_norm_eps"]
    emb = params["embed"]
    xs: List[torch.Tensor] = [
        emb[torch.as_tensor(list(s), dtype=torch.long, device=device)]
        .float() for s in seqs]
    for lp in params["layers"]:
        for i, x in enumerate(xs):
            h = rmsnorm(x, lp["ln1"]["scale"], eps)
            x = x + attention(conf, lin, lp["attn"], h)
            h = rmsnorm(x, lp["ln2"]["scale"], eps)
            xs[i] = x + moe(conf, lin, lp["moe"], h)
    head = params["embed"] if conf["tie_word_embeddings"] \
        else params["unembed"]
    w = lin.weight(head.t())
    for i, x in enumerate(xs):
        h = rmsnorm(x, params["final_norm"]["scale"], eps)
        for r0 in range(0, h.shape[0], HEAD_BLOCK):
            on_logits(i, r0, lin(h[r0:r0 + HEAD_BLOCK], w))
